"""The port's threefry key stream and categorical decoder against JAX's.

``mpi4jax_tpu_torch.utils.prng`` computes ``jax.random``'s bits in
PyTorch integer ops: ``random_bits``, ``fold_in``, ``split`` and
``uniform`` equal ``jax.random.bits``, ``fold_in``, ``split`` and
``uniform`` bit for bit, for several keys and shapes.  ``normal`` draws
JAX's uniform bits on (nextafter(-1, 0), 1) bit for bit; its inverse
error function is PyTorch's, within ``NORMAL_TOL`` of max(|value|, 1) of
``jax.random.normal`` (XLA's float32 ``erf_inv`` departs by up to 91
float32 steps in the tails: at most 5.8e-6 of max(|value|, 1) on
131,072 draws of 2 keys), and so is ``run_elastic``'s template, the
JAX package's ``init_stack_params`` drawn through it.  ``gumbel`` takes the logarithm twice, and
XLA's CPU ``log`` and PyTorch's round some inputs to the other float32
neighbour: the inner one by a step of a value near 1, the outer by a
step of its own value, so it is held to 2 float32 steps of
max(|value|, 1) (the most read on 800,000 draws of 8 keys).  The
decoders are held to identical tokens, which a last-bit difference
moves only where two candidates tie to within it.

The categorical decoder (``make_global_decode(sampler="categorical")``)
and ``reference_sample_decode`` give tokens identical to the JAX
package's in f32 on 3 keys, temperature 1.0 and 0.7, ``top_k`` None and
5, batched and stepwise prefill, with the weights of ``init_params``
carried across and the JAX tests' prompt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import transformer as jtfm

from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.utils import prng

torch.set_num_threads(1)

SEEDS = (0, 1, 42, 2**31 + 5, 2**32 - 1)
SHAPES = ((), (1,), (7,), (3, 5), (2, 3, 4), (1000,))
DATA = (0, 1, 9, 2**31 + 3, 2**32 - 1)
NORMAL_TOL = 1e-5

JCFG = jtfm.TransformerConfig(
    vocab=32, d_model=16, layers=2, heads=4, kv_heads=2, head_dim=8, d_ff=32
)
CFG = tfm.config_from_jax(JCFG._asdict())
B, P, MAX = 4, 5, 14


def _key(seed):
    jkey = jax.random.PRNGKey(seed)
    return jkey, prng.raw_key(np.asarray(jkey))


def _words(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_raw_key_is_prng_key(seed):
    jkey, key = _key(seed)
    assert key.dtype == torch.int64
    assert key.tolist() == [0, seed] == _words(jkey).tolist()
    typed = prng.raw_key(jax.random.key(seed))
    assert typed.tolist() == key.tolist()
    assert prng.raw_key(torch.tensor([0, seed])).tolist() == key.tolist()


@pytest.mark.parametrize("bad", [np.zeros(3, np.uint32),
                                 np.zeros((2, 2), np.uint32),
                                 np.zeros(2, np.float32)])
def test_raw_key_rejects_non_keys(bad):
    with pytest.raises(ValueError, match="integer pair"):
        prng.raw_key(bad)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed, shape):
    jkey, key = _key(seed)
    want = _words(jax.random.bits(jkey, shape, jnp.uint32))
    got = prng.random_bits(key, shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed, data):
    jkey, key = _key(seed)
    want = _words(jax.random.fold_in(jkey, np.uint32(data)))
    np.testing.assert_array_equal(prng.fold_in(key, data).numpy(), want)
    # a tensor of data folds each element in, as jax.vmap does
    rows = torch.tensor([data, 3, 0])
    want_rows = _words(jax.vmap(lambda r: jax.random.fold_in(jkey, r))(
        jnp.asarray(rows.numpy().astype(np.uint32))))
    np.testing.assert_array_equal(prng.fold_in(key, rows).numpy(),
                                  want_rows)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape):
    jkey, key = _key(seed)
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
        want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, hi))
        got = prng.uniform(key, shape, lo, hi).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("num", [1, 2, 3, 7])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed, num):
    jkey, key = _key(seed)
    got = prng.split(key, num)
    assert tuple(got.shape) == (num, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  _words(jax.random.split(jkey, num)))


def _assert_normal_close(want, got):
    want, got = np.asarray(want), np.asarray(got)
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1)
    assert err.max(initial=0.0) <= NORMAL_TOL, err.max()


@pytest.mark.parametrize("shape", SHAPES + ((64, 64),), ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed, shape):
    jkey, key = _key(seed)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    want_u = np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, 1.0))
    got_u = prng.uniform(key, shape, lo, 1.0).numpy()
    np.testing.assert_array_equal(got_u.view(np.int32),
                                  want_u.view(np.int32))
    _assert_normal_close(jax.random.normal(jkey, shape, jnp.float32),
                         prng.normal(key, shape))


@pytest.mark.parametrize("seed", [0, 7])
def test_elastic_template_matches_jax(seed):
    from mpi4jax_tpu.models import train as jtrain

    from mpi4jax_tpu_torch.models import train as ttrain

    want = jtrain.init_stack_params(jax.random.PRNGKey(seed), 2, 16)
    got = ttrain._keyed_stack_params(prng.raw_key([0, seed]), 2, 16, "cpu")
    for (jw, jb), (tw, tb) in zip(want.layers, got.layers):
        _assert_normal_close(jw, tw.numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    _assert_normal_close(want.w_out, got.w_out.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_and_categorical_match_jax(seed):
    jkey, key = _key(seed)
    want = np.asarray(jax.random.gumbel(jkey, (4096,), jnp.float32))
    got = prng.gumbel(key, (4096,)).numpy()
    step = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got - want) <= 2 * step).all()
    # one key per row, as jax.vmap(jax.random.categorical) draws
    rng = np.random.default_rng(seed % 2**32)
    logits = rng.standard_normal((6, 50)).astype(np.float32)
    jkeys = jax.vmap(lambda r: jax.random.fold_in(jkey, r))(jnp.arange(6))
    want = np.asarray(jax.vmap(jax.random.categorical)(jkeys,
                                                       jnp.asarray(logits)))
    keys = prng.fold_in(key, torch.arange(6))
    got = prng.categorical(keys, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def _comms():
    world = MeshComm(axes=("dp", "tp"), axis_sizes=(1, 1))
    return world.sub("dp"), world.sub("tp")


@pytest.fixture(scope="module")
def weights():
    jparams = jtfm.init_params(jax.random.PRNGKey(1), JCFG)
    prompt = np.asarray(
        jax.random.randint(jax.random.PRNGKey(2), (B, P), 0, JCFG.vocab)
    )
    params = tfm.params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                                 device="cpu")
    mesh = jax.make_mesh((1, 1), ("dp", "tp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return jparams, params, prompt, mesh


@pytest.mark.parametrize("prefill", ["batched", "stepwise"])
@pytest.mark.parametrize("top_k", [None, 5])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_decode_matches_jax(weights, seed, temperature, top_k,
                                        prefill):
    jparams, params, prompt, mesh = weights
    world = mj.MeshComm.from_mesh(mesh)
    kw = dict(prefill=prefill, sampler="categorical",
              temperature=temperature, top_k=top_k)
    jdecode = jtfm.make_global_decode(mesh, world.sub("dp"),
                                      world.sub("tp"), JCFG, MAX, **kw)
    jkey = jax.random.PRNGKey(seed)
    want = np.asarray(jdecode(jparams, jnp.asarray(prompt), jkey))
    decode = tfm.make_global_decode(*_comms(), CFG, MAX, device="cpu", **kw)
    got = decode(params, torch.tensor(prompt), np.asarray(jkey)).numpy()
    np.testing.assert_array_equal(got[:, :P], prompt)
    np.testing.assert_array_equal(got, want)
    # a typed key draws the same tokens
    again = decode(params, torch.tensor(prompt), jax.random.key(seed))
    np.testing.assert_array_equal(again.numpy(), want)


@pytest.mark.parametrize("top_k", [None, 5])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_sample_decode_matches_jax(weights, seed, temperature,
                                             top_k):
    jparams, params, prompt, _ = weights
    jkey = jax.random.PRNGKey(seed)
    want = np.asarray(jtfm.reference_sample_decode(
        jparams, jnp.asarray(prompt), JCFG, MAX, jkey,
        temperature=temperature, top_k=top_k))
    got = tfm.reference_sample_decode(
        params, torch.tensor(prompt), CFG, MAX, np.asarray(jkey),
        temperature=temperature, top_k=top_k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_keys_differ():
    # two keys draw different continuations; the same key the same one
    gen = torch.Generator().manual_seed(0)
    params = tfm.init_params(CFG, generator=gen, device="cpu")
    prompt = torch.randint(0, CFG.vocab, (B, P), generator=gen)
    decode = tfm.make_global_decode(*_comms(), CFG, 40, device="cpu",
                                    sampler="categorical")
    a = decode(params, prompt, jax.random.PRNGKey(0))
    b = decode(params, prompt, jax.random.PRNGKey(1))
    c = decode(params, prompt, jax.random.PRNGKey(0))
    assert torch.equal(a, c) and not torch.equal(a, b)
