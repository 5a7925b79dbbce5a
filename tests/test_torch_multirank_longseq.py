"""The port's ring and Ulysses attention across ranks, against the JAX
package's on the same mesh shape.

Eight thread ranks of a local world (gloo) run ``ring_attention``
(contiguous and zigzag layouts, causal and not) and
``ulysses_attention`` on their sequence blocks, at the shapes of
``tests/parallel/test_longseq.py`` (``B, T_LOCAL, H, D = 2, 4, 8, 16``)
and of ``tests/parallel/test_gqa.py`` (grouped-query heads); the JAX
functions run under ``shard_map`` on the conftest's 8-device virtual
mesh on the same seeded numpy inputs.  Outputs are held to 2e-5 and the
gradients of ``sum(out * w)`` (autograd's, through the ``sendrecv`` and
``alltoall`` transposes, against ``jax.grad``) to 3e-4, the JAX tests'
tolerances.  The ring under ``torch.utils.checkpoint`` (its exchanges
run again in the backward) gives the gradients of no checkpoint bit for
bit.  The validation messages are the JAX package's, and the zigzag
tables are JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from mpi4jax_tpu.parallel import longseq as jls
from tests.parallel.test_longseq import run_sharded

from mpi4jax_tpu_torch.parallel import longseq as tls
from mpi4jax_tpu_torch.parallel.distributed import local_world

torch.set_num_threads(1)

SIZE = 8
B, T_LOCAL, H, D = 2, 4, 8, 16
T = SIZE * T_LOCAL
OUT_TOL = 2e-5
GRAD_TOL = 3e-4
TIMEOUT = 30.0


def _inputs(seed, heads=(H, H, H)):
    """q, k, v and the loss weight w, global [B, T, h, D] f32 (w shaped
    like q)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, h, D)).astype(np.float32)
               for h in heads)
    w = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, w


def _shard(x, p=SIZE, layout="contiguous"):
    return np.array(jls.zigzag_shard(jnp.asarray(x), p)) if (
        layout == "zigzag") else x


def _unshard(x, p=SIZE, layout="contiguous"):
    return np.array(jls.zigzag_unshard(jnp.asarray(x), p)) if (
        layout == "zigzag") else x


def _jax_run(comm1d, attention, arrays, grads=True, **kw):
    """The JAX function's output and (optionally) the gradients of
    sum(out * w) w.r.t. q, k, v, each gathered in global order."""
    q, k, v, w = (jnp.asarray(a) for a in arrays)

    def out_fn(ql, kl, vl):
        return attention(ql, kl, vl, comm1d, **kw)[0]

    out = np.asarray(run_sharded(comm1d, out_fn, q, k, v))
    if not grads:
        return out, None
    spec = jax.P(None, comm1d.axes[0], None, None)

    def grad_fn(ql, kl, vl, wl):
        return jax.grad(lambda a, b, c: (out_fn(a, b, c) * wl).sum(),
                        argnums=(0, 1, 2))(ql, kl, vl)

    g = jax.jit(jax.shard_map(grad_fn, mesh=comm1d.mesh,
                              in_specs=(spec,) * 4,
                              out_specs=(spec,) * 3))(q, k, v, w)
    return out, [np.asarray(x) for x in g]


def _port_run(attention, arrays, grads=True, remat=False, **kw):
    """The port's function on 8 thread ranks, each on its sequence
    block: its output and the gradients of sum(out * w), gathered."""

    def body(comm):
        r = comm.rank()
        ql, kl, vl, wl = (torch.from_numpy(a[:, r * T_LOCAL:(r + 1) * T_LOCAL])
                          .requires_grad_(grads) for a in arrays)

        def attend(a, b, c):
            return attention(a, b, c, comm, **kw)[0]

        out = (checkpoint(attend, ql, kl, vl, use_reentrant=False) if remat
               else attend(ql, kl, vl))
        if not grads:
            return out.detach(), None
        g = torch.autograd.grad((out * wl.detach()).sum(), (ql, kl, vl))
        return out.detach(), g

    res = local_world(SIZE, body, axes=(("sp",), (SIZE,)), timeout=TIMEOUT)
    out = torch.cat([o for o, _ in res], dim=1).numpy()
    if not grads:
        return out, None
    return out, [torch.cat([g[j] for _, g in res], dim=1).numpy()
                 for j in range(3)]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_matches_jax(comm1d, layout, causal):
    q, k, v, w = _inputs(0)
    arrays = [_shard(a, layout=layout) for a in (q, k, v, w)]
    kw = dict(causal=causal, layout=layout)
    want, want_g = _jax_run(comm1d, jls.ring_attention, arrays, **kw)
    got, got_g = _port_run(tls.ring_attention, arrays, **kw)
    _close(got, want, OUT_TOL, "out")
    for name, g, wg in zip("qkv", got_g, want_g):
        _close(g, wg, GRAD_TOL, f"d{name}")
    # and the global attention itself, in the original order
    dense = tls.local_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal, impl="xla").numpy()
    _close(_unshard(got, layout=layout), dense, OUT_TOL, "vs dense")


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(comm1d, causal):
    arrays = _inputs(1)
    want, want_g = _jax_run(comm1d, jls.ulysses_attention, arrays,
                            causal=causal)
    got, got_g = _port_run(tls.ulysses_attention, arrays, causal=causal)
    _close(got, want, OUT_TOL, "out")
    for name, g, wg in zip("qkv", got_g, want_g):
        _close(g, wg, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_gqa_matches_jax(comm1d, layout, causal):
    # test_gqa.py's shapes: 8 query heads over 2 kv heads
    q, k, v, w = _inputs(3, heads=(8, 2, 2))
    arrays = [_shard(a, layout=layout) for a in (q, k, v, w)]
    kw = dict(causal=causal, layout=layout)
    want, want_g = _jax_run(comm1d, jls.ring_attention, arrays, **kw)
    got, got_g = _port_run(tls.ring_attention, arrays, **kw)
    _close(got, want, OUT_TOL, "out")
    for name, g, wg in zip("qkv", got_g, want_g):
        assert g.shape == wg.shape  # kv grads keep the kv head count
        _close(g, wg, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_gqa_matches_jax(comm1d, causal):
    # 16 query heads over 8 kv heads: kv heads divisible by the ring
    arrays = _inputs(5, heads=(16, 8, 8))
    want, want_g = _jax_run(comm1d, jls.ulysses_attention, arrays,
                            causal=causal)
    got, got_g = _port_run(tls.ulysses_attention, arrays, causal=causal)
    _close(got, want, OUT_TOL, "out")
    for name, g, wg in zip("qkv", got_g, want_g):
        _close(g, wg, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("scheme, kw", [
    ("ring", dict(layout="contiguous")),
    ("ring", dict(layout="zigzag")),
    ("ulysses", {}),
])
def test_recomputed_exchanges_give_the_same_gradients(scheme, kw):
    # under a checkpoint the forward's exchanges run again in the
    # backward, in the same order on every rank
    attention = (tls.ring_attention if scheme == "ring"
                 else tls.ulysses_attention)
    arrays = _inputs(6)
    plain_out, plain_g = _port_run(attention, arrays, causal=True, **kw)
    out, g = _port_run(attention, arrays, causal=True, remat=True, **kw)
    assert np.array_equal(out, plain_out)
    for a, b in zip(g, plain_g):
        assert np.array_equal(a, b)


def _raises_on_every_rank(fn, error, match, axes=(("sp",), (SIZE,))):
    n = int(np.prod(axes[1]))
    with pytest.raises(RuntimeError, match=match) as info:
        local_world(n, fn, axes=axes, timeout=TIMEOUT)
    assert isinstance(info.value.__cause__, error)


def test_ulysses_head_divisibility():
    q = torch.zeros((1, 4, 6, 8))  # 6 heads, ring of 8
    _raises_on_every_rank(
        lambda comm: tls.ulysses_attention(q, q, q, comm), ValueError,
        "query heads divisible by the ring size: H=6, comm.size=8")


def test_ulysses_gqa_kv_heads_guidance():
    q, k = torch.zeros((1, 4, 8, 8)), torch.zeros((1, 4, 2, 8))
    _raises_on_every_rank(
        lambda comm: tls.ulysses_attention(q, k, k, comm), ValueError,
        "kv heads divisible.*repeat kv heads")


def test_ring_requires_1d_comm():
    q = torch.zeros((1, 4, 4, 8))
    _raises_on_every_rank(
        lambda comm: tls.ring_attention(q, q, q, comm), ValueError,
        "1-D communicator", axes=(("y", "x"), (2, 4)))


@pytest.mark.parametrize("shapes, match", [
    (((1, 4, 4, 8), (1, 6, 4, 8)), "equal q/kv block lengths"),
    (((1, 3, 4, 8), (1, 3, 4, 8)), "even local block length"),
])
def test_zigzag_length_checks(shapes, match):
    q, k = (torch.zeros(s) for s in shapes)
    _raises_on_every_rank(
        lambda comm: tls.ring_attention(q, k, k, comm, causal=True,
                                        layout="zigzag"), ValueError, match)


def test_layout_and_gqa_checks_across_ranks():
    q, k = torch.zeros((1, 4, 3, 8)), torch.zeros((1, 4, 2, 8))
    _raises_on_every_rank(
        lambda comm: tls.ring_attention(q, q, q, comm, layout="striped"),
        ValueError, "layout must be 'contiguous' or 'zigzag'")
    _raises_on_every_rank(
        lambda comm: tls.ring_attention(q, k, k, comm), ValueError,
        "multiple of kv heads")
    _raises_on_every_rank(
        lambda comm: tls.ulysses_attention(q, k, k, comm), ValueError,
        "multiple of kv heads")


@pytest.mark.parametrize("p, t", [(4, 32), (8, 32), (2, 12), (1, 6)])
def test_zigzag_tables_match_jax(p, t):
    got = tls.zigzag_indices(p, t)
    want = np.asarray(jls.zigzag_indices(p, t))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    x = np.arange(2 * t * 3, dtype=np.float32).reshape(2, t, 3)
    z = tls.zigzag_shard(torch.from_numpy(x), p)
    assert np.array_equal(z.numpy(), np.asarray(jls.zigzag_shard(
        jnp.asarray(x), p)))
    assert torch.equal(tls.zigzag_unshard(z, p), torch.from_numpy(x))
    # another axis
    assert torch.equal(
        tls.zigzag_unshard(tls.zigzag_shard(torch.from_numpy(x.T.copy()),
                                            p, axis=1), p, axis=1),
        torch.from_numpy(x.T.copy()))


def test_zigzag_rank0_holds_first_and_last_chunk():
    idx = tls.zigzag_indices(4, 32)
    assert idx.shape == (4, 8)
    assert list(idx[0]) == list(range(0, 4)) + list(range(28, 32))


def test_zigzag_requires_divisibility():
    with pytest.raises(ValueError, match="divisible by 2\\*comm.size = 8"):
        tls.zigzag_indices(4, 30)
