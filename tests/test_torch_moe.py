"""The port's ``parallel/moe.py`` against the JAX package's, on the same
inputs.

Inputs come from the JAX tests' own ``jax.random`` keys
(``tests/parallel/test_moe.py``), or from numpy seeds, carried across as
numpy.  On one rank: ``load_balancing_loss``, ``router_z_loss`` (values
and gradients), ``dropped_fraction``, ``default_capacity`` and
``topk_route`` (indices, gates and flags, the gates' gradient), with
exact ties (duplicated score rows and duplicated probabilities) whose
indices must equal ``lax.top_k``'s, and the ``-inf``-masked logits.
Across ranks: ``expert_dispatch`` / ``expert_combine`` and ``topk_moe``
(one and two experts a rank, through ``alltoall_multi``) on a local
world of eight gloo thread ranks against the JAX functions under
``shard_map`` on the 8-device virtual mesh, outputs and the gradients
of the tokens and of every rank's router.  Moves and selections are
exact; float sums within 1e-5 of the largest value (gloo and
``index_add`` add in another order than XLA)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi4jax_tpu.parallel import moe as jmoe

from mpi4jax_tpu_torch.parallel import moe as pmoe
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.parallel.distributed import local_world

torch.set_num_threads(1)

E = 8   # ranks of the expert-parallel world
T = 16  # tokens per rank
D = 4
TOL = 1e-5
TIMEOUT = 60.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


def _mesh():
    return jax.make_mesh((E,), ("ep",),
                         axis_types=(jax.sharding.AxisType.Auto,))


def _world(fn):
    return local_world(E, fn, axes=(("ep",), (E,)), timeout=TIMEOUT)


def _scores(seed, shape, ties=False):
    rng = np.random.default_rng(seed)
    s = rng.random(shape, dtype=np.float32)
    if ties:
        # exact ties: duplicated score rows, and two experts scoring
        # every token alike
        s[1::3] = s[0::3][: len(s[1::3])]
        s[:, 2] = s[:, 1]
    return s


# -- one rank ---------------------------------------------------------------


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_equals_lax_top_k(k, ties):
    s = _scores(k, (12, 6), ties)
    want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
    got_v, got_i = pmoe.top_k(_t(s), k)
    np.testing.assert_array_equal(_np(got_i), np.asarray(want_i))
    np.testing.assert_array_equal(_np(got_v), np.asarray(want_v))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_load_balancing_loss_and_grad(k, ties):
    logits = _scores(10 + k, (T, 4), ties)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want, want_g = jax.value_and_grad(
        lambda p: jmoe.load_balancing_loss(p, k))(jnp.asarray(probs))
    p = _t(probs).requires_grad_(True)
    got = pmoe.load_balancing_loss(p, k)
    (g,) = torch.autograd.grad(got, p)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL)
    np.testing.assert_allclose(_np(g), np.asarray(want_g), rtol=TOL,
                               atol=TOL)


def test_router_z_loss_and_grad():
    logits = 4.0 * np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                                (T, 4)))
    want, want_g = jax.value_and_grad(jmoe.router_z_loss)(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = pmoe.router_z_loss(x)
    (g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL)
    np.testing.assert_allclose(_np(g), np.asarray(want_g), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("k, tokens, n_experts", [
    (1, 16, 4), (2, 16, 4), (2, 10, 4), (3, 7, 5), (1, 1, 8)])
def test_default_capacity(k, tokens, n_experts):
    assert (pmoe.default_capacity(k, tokens, n_experts)
            == jmoe.default_capacity(k, tokens, n_experts))


@pytest.mark.parametrize("k, capacity", [(1, 2), (2, 3), (2, 8)])
def test_dropped_fraction(k, capacity):
    s = _scores(20 + capacity, (12, 4))
    _, _, jvalid = jmoe.topk_route(jnp.asarray(s), k, capacity)
    _, _, valid = pmoe.topk_route(_t(s), k, capacity)
    got = pmoe.dropped_fraction(valid, 12, k)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        float(got), float(jmoe.dropped_fraction(jvalid, 12, k)), rtol=1e-6)


def _route_both(s, k, capacity):
    want = [np.asarray(a) for a in jmoe.topk_route(jnp.asarray(s), k,
                                                   capacity)]
    got = [_np(a) for a in pmoe.topk_route(_t(s), k, capacity)]
    return got, want


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k, capacity", [(1, 2), (1, 4), (2, 3), (2, 5),
                                         (3, 12)])
def test_topk_route_matches_jax(k, capacity, ties):
    s = _scores(100 * k + capacity, (12, 4), ties)
    (idx, gate, valid), (jidx, jgate, jvalid) = _route_both(s, k, capacity)
    np.testing.assert_array_equal(valid, jvalid)
    # every valid slot's source token; an invalid slot holds whichever
    # non-chooser the sort put there, which only the flag describes
    np.testing.assert_array_equal(idx[valid], jidx[jvalid])
    np.testing.assert_array_equal(gate, jgate)
    if ties:
        # with exact ties the order is lax.top_k's: every slot equal
        np.testing.assert_array_equal(idx, jidx)


def test_topk_route_inf_masked_logits():
    neg = -np.inf
    s = np.array([[1.0, neg, neg], [0.5, 2.0, neg], [0.2, 1.5, neg]],
                 np.float32)
    (idx, gate, valid), (jidx, jgate, jvalid) = _route_both(s, 2, 3)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(gate, jgate)
    # token 0's forced second pick (ties break low) fills expert 1 with
    # a zero gate
    assert valid[1].all() and sorted(idx[1].tolist()) == [0, 1, 2]
    assert np.isfinite(gate).all() and not valid[2].any()


@pytest.mark.parametrize("k, capacity", [(1, 3), (2, 6)])
def test_topk_route_gate_gradient(k, capacity):
    s = _scores(7 + k, (12, 4))
    cot = np.random.default_rng(k).standard_normal((4, capacity)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda x: jmoe.topk_route(x, k, capacity)[1],
                     jnp.asarray(s))
    (want,) = vjp(jnp.asarray(cot))
    x = _t(s).requires_grad_(True)
    _, gate, _ = pmoe.topk_route(x, k, capacity)
    (got,) = torch.autograd.grad(gate, x, _t(cot))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_scores_shape_is_checked():
    one = MeshComm(axes=("ep",), axis_sizes=(1,))
    x = torch.zeros(T, D)
    with pytest.raises(ValueError, match="scores must be"):
        pmoe.topk_moe(x, torch.zeros(T + 1, 4), lambda v: v, one)
    with pytest.raises(ValueError, match="not divisible by 8 experts"):
        pmoe.expert_dispatch(torch.zeros(E + 1, D),
                             torch.zeros(E + 1, dtype=torch.long),
                             type("Eight", (), {"size": E})())


def test_topk_moe_on_one_rank_is_the_dense_sum():
    # one rank hosts all four experts (m = 4): the layer is the
    # gate-weighted sum over each token's surviving picks
    one = MeshComm(axes=("ep",), axis_sizes=(1,))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (T, D)))
    wr = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (D, 4)))
    scores = np.asarray(jax.nn.softmax(jnp.asarray(x) @ wr, axis=-1))
    scales = 1.0 + np.arange(4, dtype=np.float32)
    y, token = pmoe.topk_moe(
        _t(x), _t(scores), lambda v: v * _t(scales)[:, None, None], one, k=2)
    assert token is not None
    idx, gate, valid = pmoe.topk_route(_t(scores), 2, 8)
    want = np.zeros_like(x)
    for e in range(4):
        for c in range(8):
            if valid[e, c]:
                i = int(idx[e, c])
                want[i] += float(gate[e, c]) * x[i] * scales[e]
    np.testing.assert_allclose(_np(y), want, rtol=TOL, atol=TOL)


# -- across ranks -----------------------------------------------------------


def _balanced(key, rank):
    base = jnp.repeat(jnp.arange(E), T // E)
    return np.asarray(jax.random.permutation(jax.random.fold_in(key, rank),
                                             base))


@pytest.fixture(scope="module")
def dispatch_inputs():
    key = jax.random.PRNGKey(0)
    xs = np.asarray(jax.random.normal(key, (E, T, D)))
    idx = np.stack([_balanced(key, r) for r in range(E)])
    return xs, idx


def test_dispatch_combine_matches_jax(dispatch_inputs):
    xs, idx = dispatch_inputs
    scales = 1.0 + np.arange(E, dtype=np.float32)
    mesh, jcomm = _mesh(), None
    import mpi4jax_tpu as mj

    jcomm = mj.MeshComm.from_mesh(mesh)

    def local(x, i, scale):
        ein, order, tok = jmoe.expert_dispatch(x[0], i[0], jcomm)
        out, _ = jmoe.expert_combine(ein * scale[0], order, jcomm, token=tok)
        return ein[None], order[None], out[None]

    f = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(jax.P("ep"),) * 3,
        out_specs=(jax.P("ep"),) * 3))
    jein, jorder, jout = (np.asarray(a) for a in f(xs, idx, scales))

    def body(comm):
        r = comm.rank()
        x = _t(xs[r]).requires_grad_(True)
        ein, order, tok = pmoe.expert_dispatch(x, _t(idx[r]), comm)
        out, _ = pmoe.expert_combine(ein * 2.0, order, comm, token=tok)
        (g,) = torch.autograd.grad((out ** 2).sum(), x)
        done, _ = pmoe.expert_combine(ein * float(scales[r]), order, comm)
        return _np(ein), _np(order), _np(done), _np(g)

    for r, (ein, order, out, g) in enumerate(_world(body)):
        np.testing.assert_array_equal(ein, jein[r])
        np.testing.assert_array_equal(order, jorder[r])
        np.testing.assert_array_equal(out, jout[r])
        # every token back in place, scaled by its expert
        np.testing.assert_allclose(out, xs[r] * (idx[r][:, None] + 1.0),
                                   rtol=1e-6)
        # out = 2x token-wise: d/dx sum(out^2) = 8x
        np.testing.assert_allclose(g, 8 * xs[r], rtol=TOL)


@functools.lru_cache(maxsize=None)
def _jax_topk_moe(n_experts, k):
    """The JAX ``topk_moe`` on the 8-device mesh, expert e scaling by
    e + 1, with the gradients of ``sum(y²)`` for every rank's tokens and
    router: ``(y, dx, dwr)`` per rank."""
    import mpi4jax_tpu as mj

    mesh = _mesh()
    comm = mj.MeshComm.from_mesh(mesh)
    m = n_experts // E
    xs, wrs = _moe_inputs(n_experts)
    scales = jnp.asarray(_expert_scales(n_experts))

    def local(x, wr):
        x, wr = x[0], wr[0]
        r = comm.rank()

        def loss(x, wr):
            scores = jax.nn.softmax(x @ wr, axis=-1)
            own = jax.lax.dynamic_slice(scales, (r * m,), (m,))
            fn = ((lambda v: v * own[0]) if m == 1
                  else (lambda v: v * own[:, None, None]))
            y, _ = jmoe.topk_moe(x, scores, fn, comm, k=k)
            return (y * y).sum(), y

        (_, y), (dx, dwr) = jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True)(x, wr)
        return y[None], dx[None], dwr[None]

    f = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(jax.P("ep"), jax.P("ep")),
        out_specs=(jax.P("ep"),) * 3))
    return tuple(np.asarray(a) for a in f(xs, wrs))


def _moe_inputs(n_experts):
    xs = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (E, T, D)))
    wr = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (D, n_experts)))
    return xs, np.broadcast_to(wr, (E, D, n_experts)).copy()


def _expert_scales(n_experts):
    return 1.0 + np.arange(n_experts, dtype=np.float32)


def _port_topk_moe(n_experts, k, device="cpu", coalesce=None):
    """The port's ``topk_moe`` on a local world of eight ranks, as
    :func:`_jax_topk_moe`: ``(y, dx, dwr)`` per rank as numpy."""
    xs, wrs = _moe_inputs(n_experts)
    m = n_experts // E
    scales = _expert_scales(n_experts)

    def body(comm):
        r = comm.rank()
        x = _t(xs[r]).to(device).requires_grad_(True)
        wr = _t(wrs[r]).to(device).requires_grad_(True)
        own = _t(scales[r * m:(r + 1) * m]).to(device)
        fn = ((lambda v: v * own[0]) if m == 1
              else (lambda v: v * own[:, None, None]))
        scores = torch.softmax(x @ wr, dim=-1)
        y, _ = pmoe.topk_moe(x, scores, fn, comm, k=k, coalesce=coalesce)
        dx, dwr = torch.autograd.grad((y * y).sum(), (x, wr))
        return tuple(t.detach().cpu().numpy() for t in (y, dx, dwr))

    return _world(body)


@pytest.mark.parametrize("n_experts, k", [(E, 1), (E, 2), (2 * E, 2)])
def test_topk_moe_matches_jax(n_experts, k):
    want = _jax_topk_moe(n_experts, k)
    got = _port_topk_moe(n_experts, k)
    for r, row in enumerate(got):
        for name, a, b in zip(("y", "dx", "dwr"), row, want):
            # float sums in another order: within TOL of the largest
            np.testing.assert_allclose(a, b[r], rtol=0,
                                       atol=TOL * np.abs(b[r]).max(),
                                       err_msg=f"rank {r} {name}")
    # the router receives gradient through the gates
    assert all(np.abs(row[2]).max() > 0 for row in got)


def test_topk_moe_routes_as_jax_before_any_value():
    # the routes the ranks take equal JAX's, exactly (so the value
    # comparisons above compare the same assignments)
    xs, wrs = _moe_inputs(2 * E)
    for r in range(E):
        scores = np.asarray(jax.nn.softmax(jnp.asarray(xs[r] @ wrs[r]),
                                           axis=-1))
        cap = jmoe.default_capacity(2, T, 2 * E)
        (idx, _, valid), (jidx, _, jvalid) = _route_both(scores, 2, cap)
        np.testing.assert_array_equal(valid, jvalid)
        np.testing.assert_array_equal(idx[valid], jidx[jvalid])
