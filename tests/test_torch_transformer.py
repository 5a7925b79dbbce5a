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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import transformer as jtfm

from mpi4jax_tpu_torch.examples import transformer_decode
from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.parallel.comm import MeshComm

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


def test_categorical_sampler_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        tfm.make_global_decode(*_comms(), CFG, MAX, device="cpu",
                               sampler="categorical", temperature=0.8)


def test_multi_rank_comms_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        MeshComm(axes=("dp", "tp"), axis_sizes=(1, 2))

    class TwoRanks:
        size = 2

    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        tfm.make_global_decode(_comms()[0], TwoRanks(), CFG, MAX,
                               device="cpu")


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
