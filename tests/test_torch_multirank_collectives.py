"""The PyTorch port's other collectives across ranks (alltoall,
alltoall_multi, bcast, gather, reduce, reduce_scatter, scatter), against
the JAX package on its 8-device virtual mesh (``comm1d``: 8 ranks,
``comm2d``: 2x4, from ``tests/conftest.py``), the port in local worlds
of the same shape (threads over gloo, no process spawned, no port
opened).

The cases follow the JAX package's own tests:
``tests/collective_ops/test_collectives.py`` (alltoall and its wrong
leading dimension, bcast at every root, bcast of bools, gather, scatter,
reduce), ``test_reduce_scatter.py`` (all of it but the AD battery, which
is in ``test_torch_autodiff.py``), ``test_custom_op.py`` (user operators
through allreduce, reduce, scan and reduce_scatter),
``test_random_chains.py`` (chains against the numpy oracle) and
``test_dtypes_and_vmap.py`` (the dtype battery).

The rooted ops keep the JAX package's multi-process contract (one rank
per process, as MPI), where its mesh backend returns the root's result
on every rank: the root's result is held to the mesh's, and every other
rank to that contract (``gather`` and ``reduce`` give back the input,
``scatter`` and ``bcast`` the mesh's result).

Tolerances: exact for moves, integers, bools, MIN and MAX; float32 SUM
and PROD within FLOAT_NATIVE_TOL (4e-6) of the largest value, since
gloo adds in another order than XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.ops import reductions as jred

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.ops import reductions as tred
from mpi4jax_tpu_torch.parallel.distributed import Transport, local_world

from tests.test_torch_multirank_ops import (
    FLOAT_NATIVE_TOL,
    GRIDS,
    TIMEOUT,
    _jax,
    _port,
    _rows,
    _same,
)

torch.set_num_threads(1)

N = 8


def _per_rank(grid, fn, *rows):
    """``fn(comm, *per_rank_tensors)`` on a local world of ``grid``;
    each rank's results as numpy, unstacked (rooted ops give each rank
    its own shape)."""

    def body(comm):
        out = fn(comm, *(torch.from_numpy(r[comm.rank()].copy())
                         for r in rows))
        return jax.tree.map(lambda t: t.detach().numpy(), out)

    return local_world(N, body, axes=GRIDS[grid], timeout=TIMEOUT)


def _tol(dtype, op):
    return FLOAT_NATIVE_TOL if dtype == "float32" and op in (
        "sum", "prod") else 0.0


# -- alltoall, alltoall_multi ----------------------------------------------


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_alltoall_matches_jax(request, grid):
    # the world comm, and on the 2x4 grid its rows and columns too
    jcomm = request.getfixturevalue(grid)
    subs = [()] + ([("x",), ("y",)] if grid == "comm2d" else [])
    data = {d: _rows(d, seed=k, shape=(N, 3)) for k, d in
            enumerate(("float32", "int32", "bool"))}

    def run(m, comm, *xs):
        out = []
        for axes in subs:
            c = comm.sub(*axes) if axes else comm
            out += [m.alltoall(x[:c.size], comm=c)[0] for x in xs]
        return tuple(out)

    expected = _jax(jcomm, lambda *a: run(mj, jcomm, *a), *data.values())
    actual = _port(grid, lambda c, *a: run(mt, c, *a), *data.values())
    for e, g in zip(expected, actual, strict=True):
        _same(e, g)


def test_alltoall_is_the_transpose(comm1d):
    # device r holds r*8 + [0..7]: the exchange transposes the 8x8 matrix
    rows = np.arange(64.0, dtype=np.float32).reshape(N, N)
    got = _port("comm1d", lambda c, a: mt.alltoall(a, comm=c)[0], rows)
    _same(rows.T, got)


def test_alltoall_wrong_leading_dim():
    def body(comm):
        for op in (lambda x: mt.alltoall(x, comm=comm),
                   lambda x: mt.alltoall_multi([x], comm=comm),
                   lambda x: mt.reduce_scatter(x, comm=comm)):
            for bad in (torch.zeros(3), torch.tensor(1.0)):
                with pytest.raises(ValueError, match=r"shape \(nproc, ...\)"):
                    op(bad)
        with pytest.raises(ValueError,
                           match=r"reduce_scatter input must have shape"):
            mt.reduce_scatter(torch.zeros(3, 2), comm=comm)

    local_world(4, body, timeout=TIMEOUT)
    with pytest.raises(ValueError, match=r"alltoall input must have shape "
                       r"\(nproc, ...\) with nproc == comm.size=1"):
        mt.alltoall(torch.zeros(2, 3), comm=mt.MeshComm())


def test_alltoall_multi_matches_alltoall(monkeypatch):
    # bit-identical to one alltoall per part, and every part is checked
    # before any moves
    calls = []
    real = Transport.alltoall
    monkeypatch.setattr(Transport, "alltoall", lambda self, x: (
        calls.append(x.shape), real(self, x))[1])
    parts = [_rows("float32", seed=30, shape=(N, 2)),
             _rows("int32", seed=31, shape=(N,)),
             _rows("bool", seed=32, shape=(N, 2, 3))]

    def tfn(comm, *xs):
        with pytest.raises(ValueError, match=r"shape \(nproc, ...\)"):
            mt.alltoall_multi([xs[0], xs[1][:3]], comm=comm)
        multi, tok = mt.alltoall_multi(list(xs), comm=comm, coalesce=True)
        assert isinstance(tok, mt.Token)
        assert mt.alltoall_multi([], comm=comm)[0] == []
        single = [mt.alltoall(x, comm=comm)[0] for x in xs]
        return tuple(multi) + tuple(single)

    got = _port("comm1d", tfn, *parts)
    assert len(calls) == 2 * N * len(parts)
    for k in range(len(parts)):
        _same(got[len(parts) + k], got[k])
        _same(np.swapaxes(parts[k], 0, 1), got[k])


# -- bcast -------------------------------------------------------------------


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_bcast_matches_jax_at_every_root(request, grid):
    jcomm = request.getfixturevalue(grid)
    f, i, b = (_rows(d, seed=40 + k) for k, d in
               enumerate(("float32", "int32", "bool")))

    def run(m, comm, x, k, q):
        out = [m.bcast(x * 10, root, comm=comm)[0] for root in range(N)]
        return tuple(out) + (m.bcast(k, 3, comm=comm)[0],
                             m.bcast(q, 5, comm=comm)[0])

    expected = _jax(jcomm, lambda *a: run(mj, jcomm, *a), f, i, b)
    actual = _port(grid, lambda c, *a: run(mt, c, *a), f, i, b)
    for e, g in zip(expected, actual, strict=True):
        _same(e, g)
    _same(np.broadcast_to(b[5], b.shape), actual[-1])


def test_bcast_bool(comm1d):
    # tests/collective_ops/test_collectives.py::test_bcast_bool
    ranks = np.arange(float(N), dtype=np.float32)[:, None]
    got = _port("comm1d", lambda c, x: mt.bcast(x[0] > 2, 5, comm=c)[0],
                ranks)
    _same(np.ones(N, bool), got)


# -- gather, reduce, scatter (rooted) ---------------------------------------


def _rooted_subcomms(comm):
    """The comms of the rooted cases: the world, the 2x4 grid's rows and
    columns, and a split with reversed keys (its comm ranks are not the
    world's order)."""
    subs = {"world": comm}
    if "x" in comm.axes:
        subs["x"] = comm.sub("x")
        subs["y"] = comm.sub("y")
    subs["split"] = comm.split(lambda r: r % 2, key=lambda r: -r)
    return subs


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_gather_matches_jax(request, grid):
    # the root's rows are the mesh's; other ranks get their input back
    jcomm = request.getfixturevalue(grid)
    f, b = _rows("float32", seed=50), _rows("bool", seed=51)
    names = sorted(_rooted_subcomms(jcomm))

    def jfn(x, q):
        out = []
        for k in names:
            c = _rooted_subcomms(jcomm)[k]
            out += [jnp.asarray(c.rank())[None]]
            out += [mj.gather(a, root, comm=c)[0] for a in (x, q)
                    for root in (0, c.size - 1)]
        return tuple(out)

    def tfn(comm, x, q):
        out = []
        for k in names:
            c = _rooted_subcomms(comm)[k]
            out += [torch.tensor([c.rank()])]
            out += [mt.gather(a, root, comm=c)[0] for a in (x, q)
                    for root in (0, c.size - 1)]
        return tuple(out)

    expected = _jax(jcomm, jfn, f, b)
    got = _per_rank(grid, tfn, f, b)
    per = 1 + 4
    for j, k in enumerate(names):
        ranks = expected[j * per][:, 0]
        assert [g[j * per][0] for g in got] == list(ranks), k
        for c, (src, root) in enumerate([(f, "0"), (f, "last"),
                                         (b, "0"), (b, "last")]):
            e = expected[j * per + 1 + c]
            size = e.shape[1]
            want_root = 0 if root == "0" else size - 1
            for r in range(N):
                g = got[r][j * per + 1 + c]
                if ranks[r] == want_root:
                    _same(e[r], g)
                else:
                    _same(src[r], g)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_reduce_matches_jax(request, grid):
    # the root's reduction is the mesh's (allreduce's); other ranks get
    # their input back.  SUM, PROD, MIN, MAX natively, LOR and a
    # non-commutative user operator folded in rank order on the root
    jcomm = request.getfixturevalue(grid)
    f, i, b = (_rows(d, seed=60 + k) for k, d in
               enumerate(("float32", "int32", "bool")))
    i = np.clip(i, -3, 3)
    jhalf = jred.Op.create(lambda a, c: 0.5 * a + c, commute=False)
    thalf = tred.Op.create(lambda a, c: 0.5 * a + c, commute=False)
    cases = [("sum", 0, 0), ("max", 0, 3), ("prod", 1, 3), ("min", 1, 5),
             ("lor", 2, 7), ("half", 0, 2)]
    names = sorted(_rooted_subcomms(jcomm))

    def run(m, half, comm, *xs):
        out = []
        for k in names:
            c = _rooted_subcomms(comm)[k]
            out.append((jnp if m is mj else torch).asarray(c.rank())[None])
            for op, a, root in cases:
                op = half if op == "half" else op
                out.append(m.reduce(xs[a], op, root % c.size, comm=c)[0])
        return tuple(out)

    expected = _jax(jcomm, lambda *a: run(mj, jhalf, jcomm, *a), f, i, b)
    got = _per_rank(grid, lambda c, *a: run(mt, thalf, c, *a), f, i, b)
    per = 1 + len(cases)
    for j, k in enumerate(names):
        ranks = expected[j * per][:, 0]
        size = int(ranks.max()) + 1
        for c, (op, a, root) in enumerate(cases):
            e = expected[j * per + 1 + c]
            src = (f, i, b)[a]
            for r in range(N):
                g = got[r][j * per + 1 + c]
                if ranks[r] == root % size:
                    tol = 1e-6 if op == "half" else _tol(src.dtype.name, op)
                    _same(e[r], g, tol)
                else:
                    _same(src[r], g)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_scatter_matches_jax(request, grid):
    # the full (nproc, ...) form on every rank, as on the mesh, and the
    # multi-process form: the root's rows, a template elsewhere
    jcomm = request.getfixturevalue(grid)
    f = _rows("float32", seed=70, shape=(N, 3))
    q = _rows("bool", seed=71, shape=(N, 2))
    names = sorted(_rooted_subcomms(jcomm))

    def jfn(x, b):
        out = []
        for k in names:
            c = _rooted_subcomms(jcomm)[k]
            for root in (0, c.size - 1):
                out += [mj.scatter(x[:c.size], root, comm=c)[0],
                        mj.scatter(b[:c.size], root, comm=c)[0]]
        return tuple(out)

    def tfn(comm, x, b):
        out = []
        for k in names:
            c = _rooted_subcomms(comm)[k]
            for root in (0, c.size - 1):
                template = c.rank() != root
                out += [mt.scatter(x[:c.size], root, comm=c)[0],
                        mt.scatter(x[0] if template else x[:c.size], root,
                                   comm=c)[0],
                        mt.scatter(b[:c.size], root, comm=c)[0]]
        return tuple(out)

    expected = _jax(jcomm, jfn, f, q)
    actual = _port(grid, tfn, f, q)
    for j in range(len(expected) // 2):
        _same(expected[2 * j], actual[3 * j])
        _same(expected[2 * j], actual[3 * j + 1])
        _same(expected[2 * j + 1], actual[3 * j + 2])


def test_scatter_checks_the_root():
    # tests/proc/test_proc_backend.py: the root's leading dimension
    # is checked there; other ranks may pass a template
    def body(comm):
        if comm.rank() == 1:
            with pytest.raises(ValueError, match=r"Scatter input must have "
                               r"shape \(nproc, ...\) .* on root"):
                mt.scatter(torch.zeros(3, 2), 1, comm=comm)
        for bad in (-1, 4):
            with pytest.raises(ValueError, match=f"root={bad} out of range "
                               "for communicator of size 4"):
                mt.bcast(torch.zeros(2), bad, comm=comm)
        with pytest.raises(TypeError, match="root must be a Python integer"):
            mt.gather(torch.zeros(2), torch.tensor(0), comm=comm)
        with pytest.raises(TypeError, match="root must be an integer"):
            mt.reduce(torch.zeros(2), mt.SUM, True, comm=comm)
        payload = (torch.arange(8.0).reshape(4, 2) if comm.rank() == 0
                   else torch.zeros(2))
        return mt.scatter(payload, 0, comm=comm)[0]

    got = local_world(4, body, timeout=TIMEOUT)
    for r, y in enumerate(got):
        assert torch.equal(y, torch.tensor([2.0 * r, 2.0 * r + 1]))


def test_rooted_ops_on_one_rank():
    # the JAX package's self backend: gather is allgather, reduce is
    # allreduce, scatter takes row 0, bcast the input
    for comm in (mt.SelfComm(), mt.MeshComm()):
        x = torch.arange(3.0)
        assert torch.equal(mt.gather(x, 0, comm=comm)[0], x[None])
        assert torch.equal(mt.reduce(x, mt.MAX, 0, comm=comm)[0], x)
        assert torch.equal(mt.bcast(x, 0, comm=comm)[0], x)
        assert torch.equal(mt.scatter(x[None], 0, comm=comm)[0], x)
        assert torch.equal(mt.alltoall(x[None], comm=comm)[0], x[None])
        assert torch.equal(mt.reduce_scatter(x[None], comm=comm)[0], x)
        with pytest.raises(ValueError, match=r"Scatter input must have shape"):
            mt.scatter(x, 0, comm=comm)
        with pytest.raises(ValueError, match="root=1 out of range"):
            mt.gather(x, 1, comm=comm)


# -- reduce_scatter (tests/collective_ops/test_reduce_scatter.py) -----------


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_reduce_scatter_matches_jax(request, grid):
    jcomm = request.getfixturevalue(grid)
    f = _rows("float32", seed=80, shape=(N, 3))
    i = np.clip(_rows("int32", seed=81, shape=(N, 3)), -3, 3)
    b = _rows("bool", seed=82, shape=(N, 3))
    cases = [("sum", 0), ("max", 0), ("min", 0), ("prod", 0), ("sum", 1),
             ("prod", 1), ("bxor", 1), ("lor", 2), ("land", 2), ("sum", 2)]

    def run(m, comm, *xs):
        return tuple(m.reduce_scatter(xs[a], op, comm=comm)[0]
                     for op, a in cases)

    expected = _jax(jcomm, lambda *a: run(mj, jcomm, *a), f, i, b)
    actual = _port(grid, lambda c, *a: run(mt, c, *a), f, i, b)
    for (op, a), e, g in zip(cases, expected, actual, strict=True):
        _same(e, g, _tol(("float32", "int32", "bool")[a], op))


def test_reduce_scatter_sum_closed_form():
    # rank r receives sum_src src * (r + 1)
    ranks = np.arange(float(N), dtype=np.float32)[:, None]

    def tfn(comm, v):
        rows = v.expand(N, 1) * torch.arange(1.0, N + 1)[:, None]
        return mt.reduce_scatter(rows, comm=comm)[0]

    got = _port("comm1d", tfn, ranks)
    _same((np.arange(1.0, N + 1) * ranks.sum())[:, None].astype(np.float32),
          got)


def test_reduce_scatter_equals_allreduce_row():
    xs = _rows("float32", seed=83, shape=(N, 3))

    def tfn(comm, v):
        rs, _ = mt.reduce_scatter(v, comm=comm)
        ar, _ = mt.allreduce(v, comm=comm)
        return rs - ar[comm.rank()]

    np.testing.assert_allclose(_port("comm1d", tfn, xs), 0.0, atol=1e-6)


def test_reduce_scatter_user_op_rank_order(comm1d):
    jop = jred.Op.create(lambda a, b: 0.5 * a + b, name="halfsum",
                         commute=False)
    top = tred.Op.create(lambda a, b: 0.5 * a + b, name="halfsum",
                         commute=False)
    xs = np.arange(float(N * N), dtype=np.float32).reshape(N, N)
    expected = _jax(comm1d, lambda v: mj.reduce_scatter(v, op=jop,
                                                        comm=comm1d)[0], xs)
    got = _port("comm1d", lambda c, v: mt.reduce_scatter(v, op=top,
                                                         comm=c)[0], xs)
    _same(expected, got, 1e-6)
    fold = [xs[0, r] for r in range(N)]
    for s in range(1, N):
        fold = [0.5 * a + xs[s, r] for r, a in enumerate(fold)]
    np.testing.assert_allclose(got, fold)


def test_reduce_scatter_bool_and_split_groups(comm1d):
    # LOR of one True (src 3 to rank 5); SUM within each 4-rank half
    xs = np.zeros((N, N), bool)
    xs[3, 5] = True
    got = _port("comm1d", lambda c, v: mt.reduce_scatter(v, "lor", comm=c)[0],
                xs)
    want = np.zeros(N, bool)
    want[5] = True
    _same(want, got)
    ones = np.ones((N, 4, 2), np.float32)
    expected = _jax(comm1d, lambda v: mj.reduce_scatter(
        v, comm=comm1d.split(lambda r: r // 4))[0], ones)
    got = _port("comm1d", lambda c, v: mt.reduce_scatter(
        v, comm=c.split(lambda r: r // 4))[0], ones)
    _same(expected, got)
    _same(np.full((N, 2), 4.0, np.float32), got)


# -- user operators (tests/collective_ops/test_custom_op.py) ----------------


def _user_ops(m, cast):
    left = m.Op.create(lambda a, b: a, name="left", commute=False)
    right = m.Op.create(lambda a, b: b, name="right", commute=False)
    my_max = m.Op.create(cast.maximum, name="my_max")
    my_sum = m.Op.create(cast.add, name="my_sum")

    def matmul2(a, b):
        a2 = a.reshape(*a.shape[:-1], 2, 2)
        b2 = b.reshape(*b.shape[:-1], 2, 2)
        return cast.matmul(a2, b2).reshape(a.shape)

    return left, right, my_max, my_sum, m.Op.create(matmul2, name="matmul2",
                                                    commute=False)


def test_user_ops_match_jax(comm1d):
    ranks = np.arange(float(N), dtype=np.float32)[:, None]

    def run(m, cast, comm, x):
        left, right, my_max, my_sum, mat = _user_ops(m, cast)
        r = x[0]
        matrix = cast.stack([r * 0 + 1, r, r * 0, r * 0 + 1])[None]
        return (m.allreduce(x, my_max, comm=comm)[0],
                m.allreduce(x, left, comm=comm)[0] * 10
                + m.allreduce(x, right, comm=comm)[0],
                m.scan(x, left, comm=comm)[0] * 10
                + m.scan(x, right, comm=comm)[0],
                m.scan(matrix, mat, comm=comm)[0],
                m.reduce(x, my_sum, 0, comm=comm)[0],
                m.reduce_scatter(x.reshape(1).expand(N) if m is mt
                                 else jnp.broadcast_to(x, (N,)),
                                 left, comm=comm)[0][None])

    expected = _jax(comm1d, lambda a: run(mj, jnp, comm1d, a), ranks)
    got = _per_rank("comm1d", lambda c, a: run(mt, torch, c, a), ranks)
    prefix = np.cumsum(np.arange(float(N)))
    assert np.allclose(expected[3][:, 0], np.stack(
        [np.ones(N), prefix, np.zeros(N), np.ones(N)], axis=1))
    for k, e in enumerate(expected):
        for r in range(N):
            if k == 4 and r != 0:  # reduce: the input off the root
                _same(ranks[r], got[r][k])
            else:
                _same(e[r], got[r][k], 1e-6)


def test_user_ops_not_differentiable():
    op = mt.Op.create(torch.add, name="sum")  # even one named "sum"

    def body(comm):
        x = torch.ones(4, 2, requires_grad=True)
        for fn in (lambda: mt.allreduce(x, op, comm=comm)[0],
                   lambda: mt.scan(x, op, comm=comm)[0],
                   lambda: mt.reduce_scatter(x, op, comm=comm)[0]):
            with pytest.raises(NotImplementedError, match="only defined for "
                               "op=SUM"):
                fn().sum().backward()

    local_world(4, body, timeout=TIMEOUT)


# -- chains of collectives (tests/collective_ops/test_random_chains.py) ----


MOD = 97.0


def _chain_ops(m):
    ring = [(r, (r + 1) % N) for r in range(N)]
    xp = jnp if m is mj else torch

    def gather_next(x, c, t):
        g, t = m.allgather(x, comm=c, token=t)
        if m is mj:
            return jax.lax.dynamic_index_in_dim(g, (c.rank() + 1) % N, 0,
                                                keepdims=False), t
        return g[(c.rank() + 1) % N], t

    def a2a(x, c, t):
        y, t = m.alltoall(x[:, None], comm=c, token=t)
        return y[:, 0], t

    def rs(x, c, t):
        s, t = m.reduce_scatter(x, comm=c, token=t)
        return xp.broadcast_to(s, x.shape), t

    def sc(x, c, t):
        s, t = m.scatter(x, 2, comm=c, token=t)
        return xp.broadcast_to(s, x.shape), t

    return [
        (lambda x, c, t: m.allreduce(x, m.SUM, comm=c, token=t),
         lambda rows: np.broadcast_to(rows.sum(0), rows.shape)),
        (lambda x, c, t: m.allreduce(x, m.MAX, comm=c, token=t),
         lambda rows: np.broadcast_to(rows.max(0), rows.shape)),
        (lambda x, c, t: m.bcast(x, 3, comm=c, token=t),
         lambda rows: np.broadcast_to(rows[3], rows.shape)),
        (gather_next, lambda rows: rows[(np.arange(N) + 1) % N]),
        (a2a, lambda rows: rows.T),
        (rs, lambda rows: np.broadcast_to(rows.sum(0)[:, None], rows.shape)),
        (lambda x, c, t: m.scan(x, m.SUM, comm=c, token=t),
         lambda rows: np.cumsum(rows, axis=0)),
        (sc, lambda rows: np.broadcast_to(rows[2][:, None], rows.shape)),
        (lambda x, c, t: m.sendrecv(x, x, source=ring, dest=ring, comm=c,
                                    token=t),
         lambda rows: rows[(np.arange(N) - 1) % N]),
    ]


# the adjoint-differentiable subset (no allreduce: its transpose is the
# identity by convention, not the adjoint)
LINEAR = [2, 3, 4, 5, 6, 7, 8]


@pytest.mark.parametrize("seed", range(4))
def test_random_chain_matches_oracle_and_jax(comm1d, seed):
    rng = np.random.RandomState(seed)
    chain = rng.randint(0, 9, size=10)
    init = rng.randint(0, 13, size=(N, N)).astype(np.float32)
    rows = init.copy()
    for k in chain:
        rows = np.mod(_chain_ops(mj)[k][1](rows), MOD)

    def run(m, comm, x):
        tok = m.create_token()
        for k in chain:
            x, tok = _chain_ops(m)[k][0](x, comm, tok)
            x = x % MOD if m is mt else jnp.mod(x, MOD)
        return x

    got = _port("comm1d", lambda c, a: run(mt, c, a), init)
    _same(rows, got)
    _same(_jax(comm1d, lambda a: run(mj, comm1d, a), init), got)


@pytest.mark.parametrize("seed", range(4))
def test_random_chain_grads_match_linear_oracle(seed):
    # the gradient of sum(chain(x)) by linearity: d/dx_ij = sum(chain(e_ij))
    rng = np.random.RandomState(100 + seed)
    chain = [LINEAR[k] for k in rng.randint(0, len(LINEAR), size=5)]
    init = rng.randint(0, 5, size=(N, N)).astype(np.float32)
    expected = np.zeros((N, N), np.float32)
    for i in range(N):
        for j in range(N):
            e = np.zeros((N, N), np.float32)
            e[i, j] = 1.0
            for k in chain:
                e = _chain_ops(mj)[k][1](e)
            expected[i, j] = e.sum()

    def tfn(comm, x):
        x.requires_grad_()
        y, tok = x, mt.create_token()
        for k in chain:
            y, tok = _chain_ops(mt)[k][0](y, comm, tok)
        y.sum().backward()
        return x.grad

    np.testing.assert_allclose(_port("comm1d", tfn, init), expected,
                               rtol=1e-5, atol=1e-5, err_msg=str(seed))


# -- dtypes (tests/collective_ops/test_dtypes_and_vmap.py) ------------------

# torch has no add for uint32 (the sums skip it); it moves bit for bit
SUM_DTYPES = ["float32", "float16", "bfloat16", "int8", "int32", "uint8",
              "complex64", "bool"]
MOVE_DTYPES = SUM_DTYPES + ["uint32"]


def _dtype_world(name):
    dtype = jnp.dtype(name)
    if name == "bool":
        return np.array([False] * (N - 1) + [True])
    if name == "complex64":
        return (np.arange(N) * (1 + 1j)).astype(np.complex64)
    return np.asarray(jnp.arange(N).astype(dtype))


def _to_torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


@pytest.mark.parametrize("name", MOVE_DTYPES)
def test_dtypes_match_jax(comm1d, name):
    x = _dtype_world(name)
    ring = [(r, (r + 1) % N) for r in range(N)]
    sums = name in SUM_DTYPES

    def run(m, comm, v):
        out = [m.bcast(v, 3, comm=comm)[0],
               m.allgather(v, comm=comm)[0].reshape(-1),
               m.sendrecv(v, v, source=ring, dest=ring, comm=comm)[0]]
        if sums:
            rows = (jnp.broadcast_to(v, (N, 1)) if m is mj
                    else v.expand(N, 1))
            out += [m.allreduce(v, m.SUM, comm=comm)[0],
                    m.reduce_scatter(rows, comm=comm)[0]]
        return tuple(out)

    spec = jax.P(comm1d.axes)
    expected = jax.jit(jax.shard_map(
        lambda v: run(mj, comm1d, v), mesh=comm1d.mesh, in_specs=spec,
        out_specs=(spec,) * (5 if sums else 3)))(jnp.asarray(x))

    def body(comm):
        r = comm.rank()
        return [_to_numpy(y) for y in run(mt, comm, _to_torch(x[r:r + 1]))]

    got = local_world(N, body, axes=GRIDS["comm1d"], timeout=TIMEOUT)
    for k, e in enumerate(expected):
        e = np.asarray(e)
        if name == "bfloat16":
            e = e.astype(np.float32)
        g = np.stack([per[k] for per in got]).reshape(e.shape)
        assert g.dtype == e.dtype, (k, g.dtype, e.dtype)
        np.testing.assert_array_equal(g, e, err_msg=f"{name} output {k}")


# -- BASELINE configs 3 and 4, at a small size --------------------------------


def test_bcast_scatter_gather_round_trip(comm1d):
    # config 3: bcast from the root, scatter the rows, gather them back
    data = _rows("float32", seed=90, shape=(N, 16, 16))

    def tfn(comm, x):
        full, _ = mt.bcast(x, 0, comm=comm)
        mine, _ = mt.scatter(full, 0, comm=comm)
        back, _ = mt.gather(mine, 0, comm=comm)
        return full, mine, back if comm.rank() == 0 else full

    full, mine, back = _port("comm1d", tfn, data)
    _same(np.broadcast_to(data[0], data.shape), full)
    _same(data[0], mine)
    _same(np.broadcast_to(data[0], data.shape), back)


def test_alltoall_over_the_2d_grid(comm2d):
    # config 4: the world comm, its rows and its columns
    data = _rows("float32", seed=91, shape=(N, 4, 4))

    def run(m, comm, x):
        return (m.alltoall(x, comm=comm)[0],
                m.alltoall(x[:4], comm=comm.sub("x"))[0],
                m.alltoall(x[:2], comm=comm.sub("y"))[0])

    expected = _jax(comm2d, lambda a: run(mj, comm2d, a), data)
    actual = _port("comm2d", lambda c, a: run(mt, c, a), data)
    for e, g in zip(expected, actual, strict=True):
        _same(e, g)
