"""The port's transformer across the ranks of a mesh, against the JAX
package's on the same mesh shape.

Training: eight thread ranks of a local world (gloo) on the
``("dp", "tp", "sp")`` mesh ``(2, 2, 2)``, with
``tests/parallel/test_transformer.py``'s configuration (vocab 32,
d_model 16, 2 layers, 4 heads over 2 kv heads of 8, d_ff 32) and global
batch ``B, S = 4, 16``.  Each rank gets its tp shards of the JAX
``init_params`` weights (``params_from_jax(comm_tp=...)``) and the whole
batch; the step takes its ``(dp, sp)`` block.  After one SGD step the
loss (the same on every rank) is held to the JAX step on the virtual
``(2, 2, 2)`` mesh and to ``reference_loss`` with ``jax.grad`` at rtol
2e-5, and the parameters, gathered from the shards on every rank with
``gather_params``, at 2e-4: the JAX test's tolerances, for the ring
and for Ulysses.  Every remat policy gives the no-remat step's numbers
across ranks (rtol 1e-5, the one-rank tests' limit), and its recompute
runs the tp allreduce of the attention's output a second time in every
layer's backward: counted here.  The loss falls over steps.

Decoding: eight ranks on the ``("dp", "tp")`` mesh ``(4, 2)``
(``tests/parallel/test_decode.py``): greedy and categorical, batched and
stepwise prefill, with and without ``kv_bucket``, the tokens equal to
the JAX ``make_global_decode`` on the virtual ``(4, 2)`` mesh and to the
port's one-rank decoder, the same on every rank.
"""

import collections
import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import transformer as jtfm

from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.parallel.distributed import local_world
from mpi4jax_tpu_torch.utils import prng

# the module (the package's ``ops.allreduce`` is the function)
port_allreduce = importlib.import_module("mpi4jax_tpu_torch.ops.allreduce")

torch.set_num_threads(1)

JCFG = jtfm.TransformerConfig(
    vocab=32, d_model=16, layers=2, heads=4, kv_heads=2, head_dim=8, d_ff=32
)
B, S = 4, 16
MESH = (2, 2, 2)
LOSS_RTOL = 2e-5
PARAM_TOL = 2e-4
REMAT_RTOL = 1e-5
TIMEOUT = 60.0
NAMES = ["embed", "ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2", "ln_f",
         "head"]
POLICIES = {"full": True, "dots": "dots", "names": "names",
            "save-residuals": ("attn_out", "mlp_out"),
            "save-all-tags": ("qkv", "v_proj", "attn_out", "mlp_out")}
# Ulysses needs heads / tp divisible by sp: 4 kv heads, as the JAX test
CFGS = {"ring": JCFG, "ulysses": JCFG._replace(kv_heads=4)}

DECODE_MESH = (4, 2)
DB, P, MAX = 4, 5, 14


def _jax_mesh(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape))


def _batch(seed=0):
    tokens = jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0,
                                JCFG.vocab)
    return np.array(tokens), np.array(jnp.roll(tokens, -1, axis=1))


def _arrays(jparams):
    return jax.tree.map(np.asarray, jparams)


def _train_comms(comm):
    return comm.sub("dp"), comm.sub("tp"), comm.sub("sp")


def _on_mesh(fn, shape=MESH, names=("dp", "tp", "sp")):
    return local_world(int(np.prod(shape)), fn, axes=(names, shape),
                       timeout=TIMEOUT)


def _port_steps(jcfg, jparams, batch, steps=1, lr=1e-1, **kw):
    """``steps`` steps of the port on the (2, 2, 2) mesh: every rank's
    losses and its gathered full parameters as numpy leaves."""
    cfg = tfm.config_from_jax(jcfg._asdict())
    arrays = _arrays(jparams)

    def body(comm):
        dp, tp, sp = _train_comms(comm)
        params = tfm.params_from_jax(arrays, cfg, device="cpu", comm_tp=tp)
        step = tfm.make_global_train_step(dp, tp, sp, cfg, lr=lr,
                                          device="cpu", **kw)
        losses = []
        for _ in range(steps):
            params, loss = step(params, batch)
            losses.append(float(loss[0]))
        full = tfm.gather_params(params, tp)
        return losses, tfm._leaves(tfm.params_to_numpy(full))

    return _on_mesh(body)


@pytest.fixture(scope="module")
def jax_steps():
    """Per sequence scheme: the JAX weights, batch, and the (2, 2, 2)
    step's loss and new parameters, each checked against the oracle."""
    mesh = _jax_mesh(MESH, ("dp", "tp", "sp"))
    world = mj.MeshComm.from_mesh(mesh)
    comms = world.sub("dp"), world.sub("tp"), world.sub("sp")
    runs = {}
    for seed, (sequence, jcfg) in enumerate(CFGS.items()):
        jparams = jtfm.init_params(jax.random.PRNGKey(1 + seed), jcfg)
        batch = _batch(seed)
        step = jtfm.make_global_train_step(mesh, *comms, jcfg, lr=1e-1,
                                           sequence=sequence)
        new, loss = step(jparams, tuple(jnp.asarray(t) for t in batch))
        ref_loss, ref_grads = jax.value_and_grad(
            lambda p: jtfm.reference_loss(p, *batch, jcfg))(jparams)
        ref_new = jax.tree.map(lambda p, g: p - 1e-1 * g, jparams, ref_grads)
        runs[sequence] = dict(
            jparams=jparams, batch=batch, loss=float(loss[0]),
            new=[np.asarray(t) for t in jax.tree.leaves(new)],
            ref_loss=float(ref_loss),
            ref_new=[np.asarray(t) for t in jax.tree.leaves(ref_new)])
    return runs


@pytest.fixture(scope="module")
def port_plain(jax_steps):
    """The port's no-remat step per scheme, every rank's record."""
    return {seq: _port_steps(CFGS[seq], run["jparams"], run["batch"],
                             sequence=seq)
            for seq, run in jax_steps.items()}


@pytest.mark.parametrize("against", ["mesh_step", "oracle"])
@pytest.mark.parametrize("sequence", ["ring", "ulysses"])
def test_train_step_matches_jax(jax_steps, port_plain, sequence, against):
    run = jax_steps[sequence]
    want_loss, want_new = ((run["loss"], run["new"]) if against == "mesh_step"
                           else (run["ref_loss"], run["ref_new"]))
    for rank, (losses, leaves) in enumerate(port_plain[sequence]):
        np.testing.assert_allclose(losses[0], want_loss, rtol=LOSS_RTOL,
                                   err_msg=f"rank {rank}")
        for name, got, want in zip(NAMES, leaves, want_new):
            np.testing.assert_allclose(got, want, rtol=PARAM_TOL,
                                       atol=PARAM_TOL,
                                       err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("policy_id", list(POLICIES))
@pytest.mark.parametrize("sequence", ["ring", "ulysses"])
def test_remat_policy_matches_plain_and_jax(jax_steps, port_plain, sequence,
                                            policy_id):
    run = jax_steps[sequence]
    got = _port_steps(CFGS[sequence], run["jparams"], run["batch"],
                      sequence=sequence, remat=POLICIES[policy_id])
    for rank, ((losses, leaves), (plain_losses, plain_leaves)) in enumerate(
            zip(got, port_plain[sequence])):
        np.testing.assert_allclose(losses, plain_losses, rtol=REMAT_RTOL)
        for name, a, b, want in zip(NAMES, leaves, plain_leaves, run["new"]):
            np.testing.assert_allclose(a, b, rtol=REMAT_RTOL, atol=1e-7,
                                       err_msg=f"rank {rank} {name}")
            np.testing.assert_allclose(a, want, rtol=PARAM_TOL,
                                       atol=PARAM_TOL,
                                       err_msg=f"rank {rank} {name} vs jax")


@pytest.mark.parametrize("sequence", ["ring", "ulysses"])
def test_loss_decreases_over_steps(sequence):
    jcfg = CFGS[sequence]
    jparams = jtfm.init_params(jax.random.PRNGKey(2), jcfg)
    res = _port_steps(jcfg, jparams, _batch(3), steps=8, lr=3e-1,
                      sequence=sequence)
    losses = res[0][0]
    assert all(r[0] == losses for r in res)  # the same on every rank
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses  # memorises the batch


@pytest.fixture
def tp_allreduces(monkeypatch):
    """Counts of the allreduces each rank makes over its tp comm."""
    counts = collections.Counter()
    lock = threading.Lock()
    reduce = port_allreduce._reduce

    def counting(x, op, comm):
        if comm.axes == ("tp",) and comm.size > 1:
            with lock:
                counts[threading.current_thread().name] += 1
        return reduce(x, op, comm)

    monkeypatch.setattr(port_allreduce, "_reduce", counting)
    return counts


@pytest.mark.parametrize("remat, per_layer", [
    (False, 4), (True, 5), ("dots", 5), ("names", 5),
    (("attn_out", "mlp_out"), 5), (("qkv", "v_proj", "attn_out", "mlp_out"),
                                   5),
])
def test_remat_runs_the_attention_allreduce_again(tp_allreduces, remat,
                                                  per_layer):
    # per layer and step: the forward's two g-allreduces (attention and
    # MLP outputs) and the backward's two f-allreduces; every policy's
    # recompute rebuilds the attention output's allreduce (its wo
    # product is what the tag saves) and stops before the MLP's
    run = dict(jparams=jtfm.init_params(jax.random.PRNGKey(1), JCFG),
               batch=_batch(0))
    _port_steps(JCFG, run["jparams"], run["batch"], remat=remat)
    assert len(tp_allreduces) == int(np.prod(MESH))
    assert set(tp_allreduces.values()) == {per_layer * JCFG.layers}


def test_shard_and_gather_params_round_trip():
    cfg = tfm.config_from_jax(JCFG._asdict())
    full = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    arrays = tfm.params_to_numpy(full)
    wq_heads = cfg.heads * cfg.head_dim // 2

    def body(comm):
        tp = comm.sub("tp")
        shards = tfm.shard_params(full, tp)
        carried = tfm.params_from_jax(arrays, cfg, device="cpu", comm_tp=tp)
        back = tfm.gather_params(shards, tp)
        return tp.rank(), shards, carried, back

    for rank, shards, carried, back in _on_mesh(body):
        assert all(torch.equal(a, b) for a, b in
                   zip(tfm._leaves(back), tfm._leaves(full)))
        assert all(torch.equal(a, b) for a, b in
                   zip(tfm._leaves(carried), tfm._leaves(shards)))
        # the JAX param_specs' cuts: last axis of wq, axis 1 of wo
        assert torch.equal(shards.blocks.wq, full.blocks.wq[
            ..., rank * wq_heads:(rank + 1) * wq_heads])
        assert torch.equal(shards.blocks.wo, full.blocks.wo[
            :, rank * wq_heads:(rank + 1) * wq_heads])
        assert shards.blocks.w2.shape == (cfg.layers, cfg.d_ff // 2,
                                          cfg.d_model)
        assert shards.embed.data_ptr() != full.embed.data_ptr()


def test_mesh_validation():
    # a grid of ranks needs a world of them
    with pytest.raises(ValueError, match="needs a world of ranks"):
        MeshComm(axes=("dp", "tp", "sp"), axis_sizes=MESH)
    cfg = tfm.config_from_jax(JCFG._asdict())

    def body(comm):
        dp, tp, sp = _train_comms(comm)
        errors = []
        for bad, match in ((cfg._replace(heads=3), "divisible by the tensor"),
                           (cfg._replace(kv_heads=1),
                            "divisible by the tensor"),
                           (cfg, "sequence='ulysses' needs cfg.kv_heads/tp")):
            with pytest.raises(ValueError, match=match):
                tfm.make_global_train_step(dp, tp, sp, bad, device="cpu",
                                           sequence="ulysses")
            errors.append(match)
        step = tfm.make_global_train_step(dp, tp, sp, cfg, device="cpu")
        params = tfm.shard_params(tfm.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
            tp)
        with pytest.raises(ValueError, match="global batch length 3 must be "
                           "divisible"):
            step(params, (np.zeros((3, S), np.int64),) * 2)
        with pytest.raises(ValueError, match="a function as cfg.attn_impl"):
            tfm.make_global_train_step(
                dp, tp, sp, cfg._replace(attn_impl=lambda *a, **k: None),
                device="cpu")(params, _batch())
        return errors

    assert all(len(e) == 3 for e in _on_mesh(body))


# ------------------------------ decoding ------------------------------


@pytest.fixture(scope="module")
def jax_decodes():
    """The JAX weights, prompt, key and the (4, 2) decoders' tokens, by
    (prefill, kv_bucket, sampler)."""
    mesh = _jax_mesh(DECODE_MESH, ("dp", "tp"))
    world = mj.MeshComm.from_mesh(mesh)
    jparams = jtfm.init_params(jax.random.PRNGKey(1), JCFG)
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(2), (DB, P), 0,
                                         JCFG.vocab))
    key = jax.random.PRNGKey(7)
    tokens = {}
    for prefill, bucket, sampler in DECODE_CASES:
        kw = (dict(sampler="categorical", temperature=0.7, top_k=8)
              if sampler == "categorical" else {})
        decode = jtfm.make_global_decode(mesh, world.sub("dp"),
                                         world.sub("tp"), JCFG, MAX,
                                         prefill=prefill, kv_bucket=bucket,
                                         **kw)
        args = (jnp.asarray(prompt),) + ((key,) if kw else ())
        tokens[prefill, bucket, sampler] = np.asarray(decode(jparams, *args))
    return jparams, prompt, np.array(key), tokens


DECODE_CASES = [(prefill, bucket, sampler)
                for prefill in ("batched", "stepwise")
                for bucket in (None, 4, 5)
                for sampler in ("greedy", "categorical")]


def _port_decode(comm_dp, comm_tp, params, prompt, key, prefill, bucket,
                 sampler):
    cfg = tfm.config_from_jax(JCFG._asdict())
    kw = (dict(sampler="categorical", temperature=0.7, top_k=8)
          if sampler == "categorical" else {})
    decode = tfm.make_global_decode(comm_dp, comm_tp, cfg, MAX,
                                    prefill=prefill, kv_bucket=bucket,
                                    device="cpu", **kw)
    args = (torch.from_numpy(prompt),) + ((prng.raw_key(key),) if kw else ())
    out = decode(params, *args)
    # a second call replays the same static buffers
    again = decode(params, *args)
    assert torch.equal(out, again)
    return out.numpy(), decode.replays


@pytest.mark.parametrize("prefill, bucket, sampler", DECODE_CASES)
def test_decode_matches_jax(jax_decodes, prefill, bucket, sampler):
    jparams, prompt, key, tokens = jax_decodes
    cfg = tfm.config_from_jax(JCFG._asdict())
    arrays = _arrays(jparams)
    want = tokens[prefill, bucket, sampler]
    np.testing.assert_array_equal(want[:, :P], prompt)

    def body(comm):
        tp = comm.sub("tp")
        params = tfm.params_from_jax(arrays, cfg, device="cpu", comm_tp=tp)
        return _port_decode(comm.sub("dp"), tp, params, prompt, key,
                            prefill, bucket, sampler)

    runs = local_world(int(np.prod(DECODE_MESH)), body,
                       axes=(("dp", "tp"), DECODE_MESH), timeout=TIMEOUT)
    one = MeshComm(axes=("dp", "tp"), axis_sizes=(1, 1))
    single, _ = _port_decode(one.sub("dp"), one.sub("tp"),
                             tfm.params_from_jax(arrays, cfg, device="cpu"),
                             prompt, key, prefill, bucket, sampler)
    np.testing.assert_array_equal(single, want)
    for rank, (got, replays) in enumerate(runs):
        np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
        assert replays == runs[0][1]  # every rank took the same steps
