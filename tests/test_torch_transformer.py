"""The port's greedy decoder against the JAX package's.

Weights come from the JAX ``init_params(PRNGKey(1), CFG)`` and are
carried across with ``params_from_jax``; the prompts are the JAX tests'
(``tests/parallel/test_decode.py``).  In f32 the port's
``make_global_decode`` (batched and stepwise prefill, every
``kv_bucket``, dense and flash prefill) and its
``reference_greedy_decode`` give tokens identical to the JAX
``reference_greedy_decode`` and to the JAX ``make_global_decode`` on a
1x1 ``("dp", "tp")`` mesh.  The last prompt position's prefill logits
agree with the JAX oracle's to 1e-5 in f32 (summation order only) and
to 3e-2 absolute plus 3e-2 relative in bf16: logits of up to ~3 carry
bf16 steps of 1.6e-2, and two layers of bf16 rounding at other places
than XLA's fusions (rms norm, GELU's tanh) move them by a few steps.  On CPU tensors the
flash prefill runs the CUDA kernel's plain version.

The decoder keeps static buffers across calls (on the card, the buffers
its CUDA graphs replay on; on the CPU the same code with each step a
direct call): other prompts, other parameter tensors and a NaN left in
the cache each give a fresh decoder's tokens, and an earlier result
survives a later call.  The generate step, greedy or categorical, reaches
no op that reads a device value on the host (the ops a capture refuses),
and the segments give one graph per cache view length and one replay per
position.  Categorical sampling is held to JAX in
``tests/test_torch_sampling.py``.
"""

import contextlib
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import transformer as jtfm

from mpi4jax_tpu_torch.examples import transformer_decode
from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.utils import runtime
from mpi4jax_tpu_torch.utils.runtime import graph_capture

torch.set_num_threads(1)

JCFG = jtfm.TransformerConfig(
    vocab=32, d_model=16, layers=2, heads=4, kv_heads=2, head_dim=8, d_ff=32
)
CFG = tfm.config_from_jax(JCFG._asdict())
B, P, MAX = 4, 5, 14
F32_LOGIT_TOL = 1e-5
BF16_LOGIT_TOL = 3e-2


def _comms():
    world = MeshComm(axes=("dp", "tp"), axis_sizes=(1, 1))
    return world.sub("dp"), world.sub("tp")


def _jax_params(seed):
    return jtfm.init_params(jax.random.PRNGKey(seed), JCFG)


def _jax_prompt(seed, length):
    return np.asarray(
        jax.random.randint(jax.random.PRNGKey(seed), (B, length), 0,
                           JCFG.vocab)
    )


def _leaves(p):
    """A TransformerParams' leaves in the JAX package's tree order."""
    return [p.embed, *p.blocks, p.ln_f, p.head]


def _port_params(jparams, dtype=torch.float32):
    arrays = jax.tree.map(np.asarray, jparams)
    return tfm.params_from_jax(arrays, CFG, dtype=dtype, device="cpu")


def _port_decode(params, prompt, max_len=MAX, **kw):
    decode = tfm.make_global_decode(*_comms(), CFG, max_len, device="cpu",
                                    **kw)
    return decode(params, torch.tensor(prompt)).numpy()


@pytest.fixture(scope="module")
def jax_run():
    """The JAX weights, prompt, oracle tokens and 1x1-mesh decoder
    tokens shared by the comparisons below."""
    jparams = _jax_params(1)
    prompt = _jax_prompt(2, P)
    oracle = np.asarray(
        jtfm.reference_greedy_decode(jparams, jnp.asarray(prompt), JCFG, MAX)
    )
    mesh = jax.make_mesh((1, 1), ("dp", "tp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    world = mj.MeshComm.from_mesh(mesh)
    decode = jtfm.make_global_decode(mesh, world.sub("dp"), world.sub("tp"),
                                     JCFG, MAX)
    meshed = np.asarray(decode(jparams, jnp.asarray(prompt)))
    np.testing.assert_array_equal(meshed, oracle)
    return jparams, prompt, oracle


@jax.jit
def _jax_oracle_logits(jparams, prompt):
    x = jparams.embed[prompt]
    x, _ = jax.lax.scan(lambda x, bp: (jtfm.dense_layer(x, bp, JCFG), None),
                        x, jparams.blocks)
    x = jtfm._rmsnorm(x, jparams.ln_f, JCFG.eps)
    return (x @ jparams.head)[:, -1]


def _jax_last_logits(jparams, prompt):
    """The JAX oracle's logits at the last prompt position: the layer
    math of reference_greedy_decode on the prompt alone, compiled as
    that oracle is."""
    return np.asarray(_jax_oracle_logits(jparams, jnp.asarray(prompt)),
                      np.float32)


@pytest.mark.parametrize("prefill_impl", ["xla", "flash"])
@pytest.mark.parametrize("kv_bucket", [None, 4, 5, 14])
@pytest.mark.parametrize("prefill", ["batched", "stepwise"])
def test_decode_matches_jax(jax_run, prefill, kv_bucket, prefill_impl):
    jparams, prompt, oracle = jax_run
    got = _port_decode(_port_params(jparams), prompt, prefill=prefill,
                       kv_bucket=kv_bucket, prefill_impl=prefill_impl)
    np.testing.assert_array_equal(got[:, :P], prompt)
    np.testing.assert_array_equal(got, oracle)


def test_reference_greedy_decode_matches_jax(jax_run):
    jparams, prompt, oracle = jax_run
    got = tfm.reference_greedy_decode(
        _port_params(jparams), torch.tensor(prompt), CFG, MAX
    )
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_logits_match_jax(jax_run, impl):
    jparams, prompt, _ = jax_run
    params = _port_params(jparams)
    _, tp = _comms()
    cache, logits = tfm._prefill_sharded(
        params, torch.tensor(prompt), CFG, tp, CFG.heads, CFG.kv_heads,
        MAX, impl=impl,
    )
    np.testing.assert_allclose(logits.numpy(),
                               _jax_last_logits(jparams, prompt),
                               atol=F32_LOGIT_TOL, rtol=F32_LOGIT_TOL)
    assert cache.shape == (CFG.layers, 2, B, MAX, CFG.kv_heads,
                           CFG.head_dim)
    assert not cache[:, :, :, P:].any()  # the budget past the prompt


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_logits_bf16_match_jax(jax_run, impl):
    jparams, prompt, _ = jax_run
    jbf16 = jax.tree.map(lambda t: t.astype(jnp.bfloat16), jparams)
    params = _port_params(jbf16, dtype=torch.bfloat16)
    _, tp = _comms()
    _, logits = tfm._prefill_sharded(
        params, torch.tensor(prompt), CFG, tp, CFG.heads, CFG.kv_heads,
        MAX, impl=impl,
    )
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(),
                               _jax_last_logits(jbf16, prompt),
                               atol=BF16_LOGIT_TOL, rtol=BF16_LOGIT_TOL)


@pytest.mark.parametrize("prefill", ["batched", "stepwise"])
def test_decode_prompt_only_roundtrip(prefill):
    # max_len == prompt length: nothing generated, prompt returned
    prompt = _jax_prompt(4, 6)
    got = _port_decode(_port_params(_jax_params(3)), prompt, max_len=6,
                       prefill=prefill)
    np.testing.assert_array_equal(got, prompt)


def test_decode_single_token_prompt():
    # p_len == 1: the batched path degrades to stepwise
    jparams = _jax_params(9)
    prompt = _jax_prompt(10, 1)
    want = jtfm.reference_greedy_decode(jparams, jnp.asarray(prompt), JCFG, 8)
    got = _port_decode(_port_params(jparams), prompt, max_len=8)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(sampler="beam"), "sampler"),
        (dict(sampler="categorical", temperature=0.0), "temperature"),
        (dict(sampler="categorical", top_k=CFG.vocab + 1), "top_k"),
        (dict(temperature=0.5), "temperature/top_k"),
        (dict(kv_bucket=0), "kv_bucket"),
        (dict(kv_bucket=MAX + 1), "kv_bucket"),
        (dict(prefill="chunked"), "prefill"),
        (dict(prefill_impl="pallas"), "prefill_impl"),
    ],
)
def test_decode_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        tfm.make_global_decode(*_comms(), CFG, MAX, device="cpu", **kw)


def test_decode_prompt_longer_than_budget_errors():
    decode = tfm.make_global_decode(*_comms(), CFG, 8, device="cpu")
    params = _port_params(_jax_params(7))
    with pytest.raises(ValueError, match="exceeds max_len"):
        decode(params, torch.tensor(_jax_prompt(8, 9)))


class _HostReads(TorchDispatchMode):
    """Records the ops that read a tensor's value on the host."""

    SYNCS = {"aten::_local_scalar_dense", "aten::nonzero",
             "aten::is_nonzero"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.SYNCS:
            self.seen.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def _loop(params, prompt, max_len=MAX, **kw):
    opts = dict(comm_tp=_comms()[1], batched=True, kv_bucket=None,
                prefill_impl="xla", sampler="greedy", temperature=1.0,
                top_k=None)
    opts.update(kw)
    return tfm._DecodeLoop(params, torch.tensor(prompt), CFG, max_len,
                           **opts)


def test_decode_step_makes_no_host_read():
    # the step a CUDA graph captures reads its position on the device:
    # the same code on the CPU reaches no op that reads a value back
    params = _port_params(_jax_params(1))
    prompt = _jax_prompt(2, P)
    loop = _loop(params, prompt)
    loop.prepare(params, torch.tensor(prompt), None)
    pos = torch.tensor(P, dtype=torch.int64)
    with _HostReads() as reads:
        tfm._decode_step_sharded(params, loop.cache, loop.out[:, P], pos,
                                 CFG, _comms()[1], CFG.heads, CFG.kv_heads)
    assert reads.seen == []


@pytest.mark.parametrize("sampler", ["greedy", "categorical"])
def test_generate_step_makes_no_host_read(sampler):
    # the whole captured step: token read, cache write, choice (top-k and
    # the threefry draw for "categorical"), token write, position advance
    params = _port_params(_jax_params(1))
    prompt = _jax_prompt(2, P)
    kw = dict(sampler=sampler)
    if sampler == "categorical":
        kw.update(temperature=0.7, top_k=5)
    loop = _loop(params, prompt, **kw)
    loop.prepare(params, torch.tensor(prompt), torch.tensor([0, 3]))
    loop.pos.fill_(P)
    with _HostReads() as reads:
        loop.step(params, MAX)
    assert reads.seen == []
    assert int(loop.pos) == P + 1


@pytest.mark.parametrize("start, max_len, bucket, n_views, n_steps", [
    (8192, 8448, 16, 16, 255),  # the long-prompt serving point
    (16, 512, None, 1, 495),    # the bench's decode legs
    (16, 512, 16, 31, 495),
    (0, MAX, 4, 4, MAX - 1),    # stepwise prefill
    (P, P + 1, None, 0, 0),     # nothing left to generate
])
def test_segments(start, max_len, bucket, n_views, n_steps):
    # one graph per view length, one replay per position
    segs = tfm._segments(start, max_len, bucket)
    assert len({view for view, _, _ in segs}) == len(segs) == n_views
    assert sum(stop - first for _, first, stop in segs) == n_steps
    pos = start
    for view, first, stop in segs:
        assert first == pos and stop <= min(view, max_len - 1)
        pos = stop


def _fresh(params, prompt, **kw):
    decode = tfm.make_global_decode(*_comms(), CFG, MAX, device="cpu", **kw)
    return decode(params, torch.tensor(prompt))


@pytest.mark.parametrize("kv_bucket", [None, 4])
def test_decode_state_across_calls(kv_bucket):
    # the static buffers live across calls: other prompts, then other
    # parameter tensors, each give a fresh decoder's tokens, and an
    # earlier result survives a later call
    decode = tfm.make_global_decode(*_comms(), CFG, MAX, device="cpu",
                                    kv_bucket=kv_bucket)
    params_a = _port_params(_jax_params(1))
    params_b = _port_params(_jax_params(5))
    prompt_a, prompt_b = _jax_prompt(2, P), _jax_prompt(6, P)
    first = decode(params_a, torch.tensor(prompt_a))
    kept = first.clone()
    second = decode(params_a, torch.tensor(prompt_b))
    third = decode(params_b, torch.tensor(prompt_b))
    assert torch.equal(first, kept)
    for got, (params, prompt) in zip(
            (first, second, third),
            ((params_a, prompt_a), (params_a, prompt_b),
             (params_b, prompt_b))):
        assert torch.equal(got, _fresh(params, prompt, kv_bucket=kv_bucket))
    assert not torch.equal(second, third)
    assert decode.captures == 0
    assert decode.replays == 3 * (MAX - 1 - P)


def test_decode_cache_is_zeroed_each_call():
    # a NaN left in the cache by anything earlier never reaches a later
    # call: masking alone would not stop it (0 x NaN is NaN)
    params = _port_params(_jax_params(1))
    prompt = torch.tensor(_jax_prompt(2, P))
    loop = _loop(params, prompt.numpy())
    step = lambda view: loop.step(params, view)  # noqa: E731
    want = loop.run(params, prompt, None, step).clone()
    loop.cache.fill_(float("nan"))
    loop.out.fill_(-1)
    assert torch.equal(loop.run(params, prompt, None, step), want)


def test_multi_rank_comms_name_their_roadmap_item():
    # a grid of ranks needs a world of them; the decoder's meshes run
    # (tests/test_torch_multirank_transformer.py), and its tp size must
    # still divide the heads
    with pytest.raises(ValueError, match="needs a world of ranks"):
        MeshComm(axes=("dp", "tp"), axis_sizes=(1, 2))

    class TwoRanks:
        size = 2

    with pytest.raises(ValueError, match="cfg.kv_heads=1 must be divisible "
                       "by the tensor-parallel size 2"):
        tfm.make_global_decode(_comms()[0], TwoRanks(),
                               CFG._replace(kv_heads=1), MAX, device="cpu")


def test_decode_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.make_global_decode(*_comms(), CFG, MAX)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_weights_round_trip(dtype):
    jparams = jax.tree.map(lambda t: t.astype(dtype), _jax_params(1))
    arrays = jax.tree.map(np.asarray, jparams)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    params = tfm.params_from_jax(arrays, CFG, dtype=tdtype, device="cpu")
    assert params.blocks.wq.dtype == tdtype
    back = tfm.params_to_numpy(params)
    for want, got in zip(_leaves(arrays), _leaves(back)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_params_from_jax_checks_shapes():
    arrays = jax.tree.map(np.asarray, _jax_params(1))
    wrong = tfm.config_from_jax({**JCFG._asdict(), "d_ff": 48})
    with pytest.raises(ValueError, match="blocks.w1"):
        tfm.params_from_jax(arrays, wrong, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        tfm.config_from_jax({**JCFG._asdict(), "moe": 4})


def test_init_params_layout_and_seed():
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return tfm.init_params(CFG, generator=gen, dtype=torch.bfloat16,
                               device="cpu")

    a, b, c = draw(0), draw(0), draw(1)
    for want, got in zip(_leaves(_jax_params(1)), _leaves(a)):
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert not torch.equal(a.blocks.wq, c.blocks.wq)
    assert torch.equal(a.blocks.ln1, torch.ones_like(a.blocks.ln1))


def test_example_record_on_cpu():
    rec = transformer_decode.run_decode(
        batch=2, prompt=5, max_len=12, layers=2, d_model=32, heads=4,
        kv_heads=2, d_ff=64, vocab=64, batches=1, device="cpu",
    )
    assert rec["metric"] == "transformer_decode_tokens_per_sec"
    assert rec["value"] > 0 and rec["wall_s"] > 0
    assert rec["batch"] == 2 and rec["max_len"] == 12
    # the bytes model of benchmarks/transformer.py:run_decode: weights
    # but the embedding, the average KV read, one position written
    cfg = tfm.TransformerConfig(vocab=64, d_model=32, layers=2, heads=4,
                                kv_heads=2, head_dim=8, d_ff=64)
    n_params = sum(int(np.prod(s)) for s in _leaves(tfm._param_shapes(cfg)))
    kv_per_pos = cfg.layers * 2 * cfg.kv_heads * cfg.head_dim * 2 * 4
    want = ((n_params - 64 * 32) * 4 + kv_per_pos * (5 + 12) / 2
            + kv_per_pos)
    assert rec["hbm_bytes_per_step"] == int(want)


def test_graph_capture_holds_off_the_collector(monkeypatch):
    # a collection in the middle of a capture could free a dead graph,
    # whose memory release the capturing stream refuses: the collector is
    # off for the capture and back on after it, an exception included.
    # A captured graph is kept (weakly) for distributed.finalize; one
    # whose capture failed is not
    seen = []

    class Graph:  # stands in for torch.cuda.CUDAGraph
        pass

    @contextlib.contextmanager
    def fake_graph(graph, pool=None):
        seen.append((graph, pool, gc.isenabled()))
        yield

    monkeypatch.setattr(torch.cuda, "graph", fake_graph)
    monkeypatch.setattr(runtime, "_graphs", weakref.WeakSet())
    graph, failed = Graph(), Graph()
    assert gc.isenabled()
    with graph_capture(graph, "pool"):
        assert not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(ValueError):
        with graph_capture(failed):
            raise ValueError
    assert gc.isenabled()
    assert seen == [(graph, "pool", False), (failed, None, False)]
    assert list(runtime._graphs) == [graph]
