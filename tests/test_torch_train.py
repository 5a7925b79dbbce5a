"""The port's training step against the JAX package's.

The JAX tests' configuration (``tests/parallel/test_transformer.py``:
vocab 32, d_model 16, 2 layers, 4 heads over 2 kv heads of 8, d_ff 32;
batch 4, sequence 16), weights from the JAX ``init_params`` carried
across with ``params_from_jax``, tokens from ``jax.random`` handed over
as numpy.  In f32 the port's ``make_global_train_step`` (dense attention
and the flash kernels' plain versions) is held against the JAX
``make_global_train_step`` on a 1x1x1 ``("dp", "tp", "sp")`` mesh and
against the JAX ``reference_loss`` with ``jax.grad``: the loss to rtol
2e-5 and the updated parameters to rtol and atol 2e-4, the JAX test's
tolerances.  ``remat=True`` matches no remat to rtol 1e-5, and so do
the partial policies (``"dots"``, ``"names"``, tuple save-lists), which
also match the JAX step under the same policy, with the dense MLP and
with a custom hook; the backward's recompute runs the products JAX's
policy recomputes, and no policy saves the MLP's output product.  The chunked loss matches the
streaming one, and the loss falls over eight steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import transformer as jtfm

from mpi4jax_tpu_torch.examples import transformer_train
from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.parallel.longseq import (
    local_attention,
    ring_attention,
    ulysses_attention,
)

torch.set_num_threads(1)

JCFG = jtfm.TransformerConfig(
    vocab=32, d_model=16, layers=2, heads=4, kv_heads=2, head_dim=8, d_ff=32
)
B, S = 4, 16
LOSS_RTOL = 2e-5
PARAM_TOL = 2e-4
REMAT_RTOL = 1e-5
# the partial policies, by the ids the tests give them
POLICIES = {
    "dots": "dots",
    "names": "names",
    "save-residuals": ("attn_out", "mlp_out"),
    "save-all-tags": ("qkv", "v_proj", "attn_out", "mlp_out"),
}
NAMES = ["embed", "ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2", "ln_f",
         "head"]


def _cfg(**kw):
    return tfm.config_from_jax({**JCFG._asdict(), **kw})


def _comms():
    world = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    return world.sub("dp"), world.sub("tp"), world.sub("sp")


def _batch(seed=0):
    tokens = jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0,
                                JCFG.vocab)
    # next-token targets, shifted globally as the JAX tests shift them
    return np.array(tokens), np.array(jnp.roll(tokens, -1, axis=1))


def _port_params(jparams, cfg, dtype=torch.float32):
    return tfm.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               dtype=dtype, device="cpu")


def _step(cfg, lr=1e-1, **kw):
    return tfm.make_global_train_step(*_comms(), cfg, lr=lr, device="cpu",
                                      **kw)


def _numpy(params):
    return tfm._leaves(tfm.params_to_numpy(params))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX weights, batch, and the 1x1x1-mesh step's loss and new
    parameters, checked against the oracle (reference_loss + grad)."""
    jparams = jtfm.init_params(jax.random.PRNGKey(1), JCFG)
    tokens, targets = _batch()
    mesh = jax.make_mesh((1, 1, 1), ("dp", "tp", "sp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    world = mj.MeshComm.from_mesh(mesh)
    step = jtfm.make_global_train_step(
        mesh, world.sub("dp"), world.sub("tp"), world.sub("sp"), JCFG,
        lr=1e-1,
    )
    new, loss = step(jparams, (jnp.asarray(tokens), jnp.asarray(targets)))
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jtfm.reference_loss(p, tokens, targets, JCFG))(jparams)
    ref_new = jax.tree.map(lambda p, g: p - 1e-1 * g, jparams, ref_grads)
    np.testing.assert_allclose(float(loss[0]), float(ref_loss),
                               rtol=LOSS_RTOL)
    return (jparams, (tokens, targets), float(loss[0]),
            [np.asarray(t) for t in jax.tree.leaves(new)],
            float(ref_loss), [np.asarray(t) for t in jax.tree.leaves(ref_new)])


@pytest.mark.parametrize("against", ["mesh_step", "oracle"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_train_step_matches_jax(jax_run, attn_impl, against):
    jparams, batch, loss_mesh, new_mesh, loss_ref, new_ref = jax_run
    want_loss, want_new = ((loss_mesh, new_mesh) if against == "mesh_step"
                           else (loss_ref, new_ref))
    cfg = _cfg(attn_impl=attn_impl)
    params, loss = _step(cfg)(_port_params(jparams, cfg), batch)
    assert loss.shape == (1,) and loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss[0]), want_loss, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL)
    for name, got, want in zip(NAMES, _numpy(params), want_new):
        np.testing.assert_allclose(got, want, rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=name)


def test_reference_loss_matches_jax(jax_run):
    jparams, (tokens, targets), _, _, loss_ref, _ = jax_run
    cfg = _cfg()
    got = tfm.reference_loss(_port_params(jparams, cfg),
                             torch.tensor(tokens), torch.tensor(targets), cfg)
    np.testing.assert_allclose(float(got), loss_ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize("sequence", ["ring", "ulysses"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_remat_matches_plain(attn_impl, sequence):
    # each layer recomputed in the backward: the same math, so the same
    # loss and update
    cfg = _cfg(attn_impl=attn_impl)
    jparams = jtfm.init_params(jax.random.PRNGKey(7), JCFG)
    batch = _batch(seed=8)
    p1, l1 = _step(cfg, sequence=sequence)(_port_params(jparams, cfg), batch)
    p2, l2 = _step(cfg, sequence=sequence, remat=True)(
        _port_params(jparams, cfg), batch)
    np.testing.assert_allclose(float(l1[0]), float(l2[0]), rtol=REMAT_RTOL)
    for a, b in zip(_numpy(p1), _numpy(p2), strict=True):
        np.testing.assert_allclose(a, b, rtol=REMAT_RTOL, atol=1e-6)


def test_ce_chunked_matches_streaming():
    # chunk 4 over sequence 16: four chunks, each recomputed in the
    # backward; the same loss and update to f32 summation order
    jparams = jtfm.init_params(jax.random.PRNGKey(11), JCFG)
    batch = _batch(seed=12)
    plain_cfg, chunked_cfg = _cfg(), _cfg(ce_chunk=4)
    p1, l1 = _step(plain_cfg)(_port_params(jparams, plain_cfg), batch)
    p2, l2 = _step(chunked_cfg)(_port_params(jparams, chunked_cfg), batch)
    np.testing.assert_allclose(float(l1[0]), float(l2[0]), rtol=1e-6)
    for a, b in zip(_numpy(p1), _numpy(p2), strict=True):
        np.testing.assert_allclose(a, b, rtol=REMAT_RTOL, atol=1e-6)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_loss_decreases_over_steps(attn_impl):
    # the JAX test's memorisation check: lr 3e-1, eight steps
    cfg = _cfg(attn_impl=attn_impl)
    params = _port_params(jtfm.init_params(jax.random.PRNGKey(2), JCFG), cfg)
    batch = _batch(seed=3)
    step = _step(cfg, lr=3e-1)
    losses = []
    for _ in range(8):
        params, loss = step(params, batch)
        losses.append(float(loss[0]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses


def test_bf16_step_matches_jax():
    # bf16 weights: the loss is f32 from bf16 logits; the two frameworks
    # round the activations at other places, so the loss is held to 1e-2
    jparams = jax.tree.map(lambda t: t.astype(jnp.bfloat16),
                           jtfm.init_params(jax.random.PRNGKey(1), JCFG))
    tokens, targets = _batch()
    want = float(jtfm.reference_loss(jparams, tokens, targets, JCFG))
    cfg = _cfg(attn_impl="flash")
    params, loss = _step(cfg)(_port_params(jparams, cfg, torch.bfloat16),
                              (tokens, targets))
    assert params.blocks.wq.dtype == torch.bfloat16
    np.testing.assert_allclose(float(loss[0]), want, rtol=1e-2)


def test_mlp_hook_adds_its_auxiliary_loss():
    # an mlp returning (out, token, aux): the aux terms of every layer
    # are summed into the loss, as the MoE variant relies on
    cfg = _cfg()
    jparams = jtfm.init_params(jax.random.PRNGKey(1), JCFG)
    batch = _batch()

    def mlp(h2, bp, cfg, comm_tp, comm_sp, token):
        out, token = tfm._dense_mlp(h2, bp, cfg, comm_tp, comm_sp, token)
        return out, token, (bp.ln2 * 0).sum() + 0.25

    _, plain = _step(cfg)(_port_params(jparams, cfg), batch)
    _, with_aux = _step(cfg, mlp=mlp)(_port_params(jparams, cfg), batch)
    np.testing.assert_allclose(float(with_aux[0]),
                               float(plain[0]) + 0.25 * cfg.layers,
                               rtol=1e-6)


@pytest.mark.parametrize(
    "kw, error, match",
    [
        (dict(sequence="zigzag"), ValueError, "sequence"),
        (dict(remat=()), ValueError, "empty remat save-list"),
        (dict(remat=("qkv", "kv")), ValueError, "unknown checkpoint tag"),
        (dict(remat="all"), ValueError, "remat must be"),
    ],
)
def test_train_step_validation(kw, error, match):
    with pytest.raises(error, match=match):
        _step(_cfg(), **kw)


@pytest.fixture(scope="module")
def jax_policy_runs():
    """The JAX 1x1x1-mesh step under each partial policy, on the
    weights and batch of test_remat_policy_matches_plain_and_jax; made
    once per policy."""
    jparams = jtfm.init_params(jax.random.PRNGKey(9), JCFG)
    batch = _batch(seed=10)
    mesh = jax.make_mesh((1, 1, 1), ("dp", "tp", "sp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    world = mj.MeshComm.from_mesh(mesh)
    runs = {}

    def run(policy_id):
        if policy_id not in runs:
            step = jtfm.make_global_train_step(
                mesh, world.sub("dp"), world.sub("tp"), world.sub("sp"),
                JCFG, lr=1e-1, remat=POLICIES[policy_id])
            new, loss = step(jparams, tuple(map(jnp.asarray, batch)))
            runs[policy_id] = (float(loss[0]),
                               [np.asarray(t) for t in jax.tree.leaves(new)])
        return runs[policy_id]

    return jparams, batch, run


@pytest.mark.parametrize("policy_id", list(POLICIES))
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_remat_policy_matches_plain_and_jax(jax_policy_runs, attn_impl,
                                            policy_id):
    # a partial policy recomputes part of each layer: the same loss and
    # update as no remat, and as the JAX step under the same policy
    jparams, batch, jax_run = jax_policy_runs
    cfg = _cfg(attn_impl=attn_impl)
    p1, l1 = _step(cfg)(_port_params(jparams, cfg), batch)
    p2, l2 = _step(cfg, remat=POLICIES[policy_id])(
        _port_params(jparams, cfg), batch)
    np.testing.assert_allclose(float(l2[0]), float(l1[0]), rtol=REMAT_RTOL)
    for name, a, b in zip(NAMES, _numpy(p2), _numpy(p1), strict=True):
        np.testing.assert_allclose(a, b, rtol=REMAT_RTOL, atol=1e-6,
                                   err_msg=name)
    want_loss, want_new = jax_run(policy_id)
    np.testing.assert_allclose(float(l2[0]), want_loss, rtol=LOSS_RTOL,
                               atol=LOSS_RTOL)
    for name, got, want in zip(NAMES, _numpy(p2), want_new, strict=True):
        np.testing.assert_allclose(got, want, rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=name)


class _RecomputedProducts(TorchDispatchMode):
    """Names the layer weights of the ``aten.mm`` calls made with grad
    mode on inside a backward: those of the checkpoint's recompute (the
    backward's own gradient products run with grad mode off)."""

    def __init__(self, weights):
        super().__init__()
        self.weights = weights
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == torch.ops.aten.mm.default and torch.is_grad_enabled():
            ptr = args[1].data_ptr()
            self.names.append(next((name for name, w in self.weights.items()
                                    if w.data_ptr() == ptr), "other"))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat, recomputed", [
    (True, ["wq", "wk", "wv", "wo", "w1"]),
    ("dots", []),
    ("names", ["wv", "w1"]),
    (("attn_out", "mlp_out"), ["wq", "wk", "wv", "w1"]),
    (("qkv", "v_proj", "attn_out", "mlp_out"), ["w1"]),
], ids=["full", "dots", "names", "save-residuals", "save-all-tags"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_remat_recompute_runs_the_policys_products(attn_impl, remat,
                                                   recomputed):
    # the products the backward's recompute runs in one layer: JAX's
    # policies recompute v and w1 under "names" and no projection under
    # "dots"; a tagged product is saved itself, so the wo GEMM does not
    # run again.  torch's recompute stops once the last saved tensor is
    # rebuilt, which the w2 product's inputs are, so w2 runs again under
    # no policy (and none saves it: JAX keeps no residual of it).
    cfg = _cfg(attn_impl=attn_impl, layers=1)
    params = _port_params(
        jtfm.init_params(jax.random.PRNGKey(1), JCFG._replace(layers=1)),
        cfg)
    tokens, targets = (torch.as_tensor(t) for t in _batch())
    leaves = tfm._leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    dp, tp, sp = _comms()
    logits, _ = tfm._forward_sharded(params, tokens, cfg, tp, sp,
                                     remat=remat)
    loss = tfm._ce(logits, targets)
    weights = {name: getattr(params.blocks, name)[0]
               for name in ("wq", "wk", "wv", "wo", "w1", "w2")}
    with _RecomputedProducts(weights) as mode:
        torch.autograd.grad(loss, leaves)
    assert mode.names == recomputed


def _port_relu_mlp(h2, bp, cfg, comm_tp, comm_sp, token):
    # a custom MLP hook that tags nothing
    return F.relu(h2 @ bp.w1) @ bp.w2 * 0.5, token


def _jax_relu_mlp(h2, bp, cfg, comm_tp, comm_sp, token):
    return jax.nn.relu(h2 @ bp.w1) @ bp.w2 * 0.5, token


@pytest.mark.parametrize("policy_id", ["dots", "names", "save-all-tags"])
def test_remat_policy_with_a_custom_mlp(policy_id):
    # the JAX layer tags the hook's output "mlp_out", the port tags
    # nothing of an untagged hook: the same loss and update as no remat,
    # and as the JAX step with the same hook under the same policy
    cfg = _cfg()
    jparams = jtfm.init_params(jax.random.PRNGKey(13), JCFG)
    batch = _batch(seed=14)
    remat = POLICIES[policy_id]
    p1, l1 = _step(cfg, mlp=_port_relu_mlp)(_port_params(jparams, cfg), batch)
    p2, l2 = _step(cfg, mlp=_port_relu_mlp, remat=remat)(
        _port_params(jparams, cfg), batch)
    np.testing.assert_allclose(float(l2[0]), float(l1[0]), rtol=REMAT_RTOL)
    for name, a, b in zip(NAMES, _numpy(p2), _numpy(p1), strict=True):
        np.testing.assert_allclose(a, b, rtol=REMAT_RTOL, atol=1e-6,
                                   err_msg=name)
    mesh = jax.make_mesh((1, 1, 1), ("dp", "tp", "sp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    world = mj.MeshComm.from_mesh(mesh)
    jstep = jtfm.make_global_train_step(
        mesh, world.sub("dp"), world.sub("tp"), world.sub("sp"), JCFG,
        lr=1e-1, mlp=_jax_relu_mlp, remat=remat)
    new, loss = jstep(jparams, tuple(map(jnp.asarray, batch)))
    np.testing.assert_allclose(float(l2[0]), float(loss[0]), rtol=LOSS_RTOL,
                               atol=LOSS_RTOL)
    for name, got, want in zip(NAMES, _numpy(p2), jax.tree.leaves(new),
                               strict=True):
        np.testing.assert_allclose(got, np.asarray(want), rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("remat, recomputed", [
    ("names", ["wv", "w1"]),
    (("attn_out", "mlp_out"), ["wq", "wk", "wv", "w1"]),
], ids=["names", "save-residuals"])
def test_remat_recompute_with_a_custom_mlp(remat, recomputed):
    # the hook's output product is never run again, tagged or not, as
    # JAX's "mlp_out" keeps it out of the recompute
    cfg = _cfg(layers=1)
    params = _port_params(
        jtfm.init_params(jax.random.PRNGKey(1), JCFG._replace(layers=1)),
        cfg)
    tokens, targets = (torch.as_tensor(t) for t in _batch())
    leaves = tfm._leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    logits, _ = tfm._forward_sharded(params, tokens, cfg, *_comms()[1:],
                                     mlp=_port_relu_mlp, remat=remat)
    weights = {name: getattr(params.blocks, name)[0]
               for name in ("wq", "wk", "wv", "wo", "w1", "w2")}
    with _RecomputedProducts(weights) as mode:
        torch.autograd.grad(tfm._ce(logits, targets), leaves)
    assert mode.names == recomputed


@pytest.mark.parametrize("remat", ["dots", "names", tfm.CHECKPOINT_NAMES])
def test_no_policy_saves_the_mlp_output(remat):
    # the policy's decision per tag: the MLP's output product is never
    # saved (no backward reads it), the others as the policy names them
    policy = tfm._recompute_layers(remat).args[0]
    mm = torch.ops.aten.mm.default
    want = {"qkv": True, "v_proj": remat != "names", "attn_out": True,
            "mlp_out": False, None: remat == "dots"}
    for tag, saved in want.items():
        with tfm.checkpoint_tag(tag):
            got = policy(None, mm)
            other = policy(None, torch.ops.aten.gelu.default)
        assert (got == CheckpointPolicy.MUST_SAVE) == saved, tag
        assert other == CheckpointPolicy.PREFER_RECOMPUTE


def test_ce_chunk_must_divide_the_sequence():
    cfg = _cfg(ce_chunk=7)
    step = _step(cfg)
    with pytest.raises(ValueError, match="ce_chunk=7 must divide"):
        step(_port_params(jtfm.init_params(jax.random.PRNGKey(1), JCFG),
                          cfg), _batch())


def test_multi_rank_comms_name_their_roadmap_item():
    # the meshes run (tests/test_torch_multirank_*.py); what stays is the
    # validation: a grid of ranks needs a world of them, and the
    # sequence-parallel schemes a mesh communicator
    with pytest.raises(ValueError, match="needs a world of ranks"):
        MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 2))

    class TwoRanks:
        size = 2
        backend = "proc"

    q = torch.zeros((1, 4, 2, 8))
    for attention in (ring_attention, ulysses_attention):
        with pytest.raises(NotImplementedError, match=(
                f"{attention.__name__} requires a mesh communicator, got "
                "'proc'")):
            attention(q, q, q, TwoRanks(), causal=True)


def test_train_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.make_global_train_step(*_comms(), _cfg())


def test_step_refuses_params_on_another_device():
    step = tfm.make_global_train_step(*_comms(), _cfg(), device="cpu")
    params = _port_params(jtfm.init_params(jax.random.PRNGKey(1), JCFG),
                          _cfg())
    params = params._replace(embed=params.embed.to("meta"))
    with pytest.raises(ValueError, match="params are on meta"):
        step(params, _batch())


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_one_rank_ring_and_ulysses_are_local_attention(impl):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(
        rng.standard_normal((2, 12, h, 8)).astype(np.float32))
        for h in (4, 2, 2))
    _, _, sp = _comms()
    want = local_attention(q, k, v, causal=True, impl=impl)
    for attention in (ring_attention, ulysses_attention):
        out, token = attention(q, k, v, sp, causal=True, impl=impl)
        assert token is not None
        assert torch.equal(out, want)
    with pytest.raises(ValueError, match="layout"):
        ring_attention(q, k, v, sp, layout="striped")
    with pytest.raises(ValueError, match="multiple of kv heads"):
        ring_attention(q[:, :, :3], k, v, sp)


def test_tp_sharded_record_matches_the_parameters():
    # one flag per leaf, True exactly on the projections JAX's
    # param_specs shards over tp
    flags = tfm._leaves(tfm.TP_SHARDED)
    assert len(flags) == len(NAMES)
    assert [n for n, f in zip(NAMES, flags) if f] == [
        "wq", "wk", "wv", "wo", "w1", "w2"]
    specs = jax.tree.leaves(jtfm.param_specs("tp"),
                            is_leaf=lambda x: isinstance(x, jax.P))
    assert [("tp" in tuple(s)) for s in specs] == flags


def test_example_record_on_cpu():
    rec = transformer_train.run(
        batch=2, seq=16, layers=2, d_model=32, heads=4, kv_heads=2, d_ff=64,
        vocab=64, batches=1, attn_impl="flash", device="cpu",
    )
    assert rec["metric"] == "transformer_train_tokens_per_sec"
    assert rec["value"] > 0 and rec["step_ms"] > 0
    assert rec["device"] == "cpu" and "mfu_pct" not in rec
    cfg = tfm.TransformerConfig(vocab=64, d_model=32, layers=2, heads=4,
                                kv_heads=2, head_dim=8, d_ff=64)
    n_params = sum(int(np.prod(s)) for s in tfm._leaves(
        tfm._param_shapes(cfg)))
    assert rec["params_m"] == n_params / 1e6
    # run's conventions: 6·N·tokens, plus the causal attention scores
    ratio = rec["model_tflops_incl_attn"] / rec["model_tflops_per_sec"]
    attn = transformer_train.attention_flops(cfg, 2, 16)
    np.testing.assert_allclose(ratio, 1 + attn / (6.0 * n_params * 32),
                               rtol=1e-9)


@pytest.mark.parametrize("remat, ce_chunk, want", [
    ("names", 8, "names"),
    (("attn_out", "mlp_out"), 0, ["attn_out", "mlp_out"]),
])
def test_example_record_names_its_remat(remat, ce_chunk, want):
    # run's record names the policy (a save-list as a list) and the
    # loss chunk, as benchmarks/transformer.py records them
    rec = transformer_train.run(
        batch=2, seq=16, layers=2, d_model=32, heads=4, kv_heads=2, d_ff=64,
        vocab=64, batches=1, remat=remat, ce_chunk=ce_chunk,
        attn_impl="flash", device="cpu",
    )
    assert rec["remat"] == want
    assert rec.get("ce_chunk", 0) == ce_chunk
    assert np.isfinite(rec["loss"]) and "peak_memory_gb" not in rec
