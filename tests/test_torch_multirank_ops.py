"""The PyTorch port's communication ops across ranks, against the JAX
package on its 8-device virtual mesh (``comm1d``: 8 ranks, ``comm2d``:
2x4, from ``tests/conftest.py``).

The port's side runs in a local world of the same shape
(``parallel/distributed.py:local_world``: the ranks as threads of this
process, gloo over loopback, no process spawned and no port opened).
The same seeded numpy rows go to both: row ``r`` is rank ``r``'s input.

Tolerances: integers, bools, MIN and MAX exactly, and whatever only
moves data (gathers, sendrecv, send/recv, halos).  A float SUM or PROD
adds in another order on each side (gloo's native reduction; the port's
scan folds in rank order, JAX's scan does not), so float32 SUM and PROD
results are held to 4e-6 of the largest (about 32 float32 steps over 8
ranks).
"""

import threading
import time
from math import prod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.ops import reductions as jred

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.ops import reductions as tred
from mpi4jax_tpu_torch.parallel import distributed
from mpi4jax_tpu_torch.parallel.distributed import local_world

torch.set_num_threads(1)

# every world of this file: a peer that does not answer ends the test
# within seconds, not at gloo's default of 30 minutes
TIMEOUT = 20.0

OP_NAMES = ["sum", "prod", "min", "max", "land", "lor", "lxor", "band",
            "bor", "bxor"]
GRIDS = {"comm1d": (("i",), (8,)), "comm2d": (("y", "x"), (2, 4))}
FLOAT_NATIVE_TOL = 4e-6


def _dtypes_for(name):
    if name in ("land", "lor", "lxor"):
        return ["bool"]
    if name in ("band", "bor", "bxor"):
        return ["int32"]
    return ["int32", "float32"]


OP_CASES = [(n, d) for n in OP_NAMES for d in _dtypes_for(n)]


def _rows(dtype, seed=0, shape=(3, 5), n=8):
    rng = np.random.default_rng(seed)
    shape = (n, *shape)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype == "int32":
        return rng.integers(-50, 50, shape).astype(np.int32)
    if dtype == "int8":
        return rng.integers(-10, 10, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


def _jax(comm, fn, *rows):
    """``fn(*per_rank_arrays)`` under shard_map over ``comm``'s mesh; the
    results stacked by rank."""
    spec = jax.P(comm.axes)
    f = jax.jit(jax.shard_map(
        lambda *a: jax.tree.map(lambda o: o[None],
                                fn(*(x[0] for x in a))),
        mesh=comm.mesh, in_specs=(spec,) * len(rows), out_specs=spec,
    ))
    return jax.tree.map(np.asarray, f(*(r for r in rows)))


def _port(grid, fn, *rows):
    """``fn(comm, *per_rank_tensors)`` on a local world of ``grid``; the
    results (tensors, or tuples of them) stacked by rank as numpy."""
    axes = GRIDS[grid]

    def body(comm):
        out = fn(comm, *(torch.from_numpy(r[comm.rank()].copy())
                         for r in rows))
        return jax.tree.map(lambda t: t.detach().numpy(), out)

    outs = local_world(8, body, axes=axes, timeout=TIMEOUT)
    return jax.tree.map(lambda *o: np.stack(o), *outs)


def _same(expected, actual, tol=0.0):
    expected, actual = np.asarray(expected), np.asarray(actual)
    assert actual.shape == expected.shape
    assert actual.dtype == expected.dtype
    if tol:
        scale = max(float(np.abs(expected).max()), 1e-30)
        np.testing.assert_allclose(actual, expected, rtol=tol,
                                   atol=tol * scale)
    else:
        np.testing.assert_array_equal(actual, expected)


def _op_rows(name, dtype, seed):
    rows = _rows(dtype, seed=seed)
    if name == "prod" and dtype == "int32":
        rows = np.clip(rows, -3, 3)  # the product of 8 stays in range
    return rows


def _expected_by_case(request, cases, jop):
    """The JAX results of ``jop(comm, name, array)`` for every case and
    both grids, one compiled program per grid."""
    out = {}
    for grid in GRIDS:
        jcomm = request.getfixturevalue(grid)
        rows = [_op_rows(n, d, k) for k, (n, d) in enumerate(cases)]
        res = _jax(jcomm, lambda *a: tuple(
            jop(jcomm, n, x) for x, (n, _) in zip(a, cases)), *rows)
        out[grid] = {case: (r, e) for case, r, e in zip(cases, rows, res)}
    return out


@pytest.fixture(scope="module")
def allreduce_expected(request):
    return _expected_by_case(request, OP_CASES, lambda c, n, x: mj.allreduce(
        x, jred.named_op(n), comm=c)[0])


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name,dtype", OP_CASES)
def test_allreduce_matches_jax(allreduce_expected, grid, name, dtype):
    rows, expected = allreduce_expected[grid][(name, dtype)]
    actual = _port(grid, lambda c, a: mt.allreduce(a, name, comm=c)[0], rows)
    native = dtype == "float32" and name in ("sum", "prod")
    _same(expected, actual, FLOAT_NATIVE_TOL if native else 0.0)


def test_allreduce_user_op_folds_in_rank_order(comm1d):
    # a non-commutative combine: the rows must fold in rank order
    rows = _rows("float32", seed=3)
    jop = jred.Op.create(lambda a, b: 0.5 * a + b, commute=False)
    top = tred.Op.create(lambda a, b: 0.5 * a + b, commute=False)
    expected = _jax(comm1d, lambda a: mj.allreduce(a, jop, comm=comm1d)[0],
                    rows)
    actual = _port("comm1d", lambda c, a: mt.allreduce(a, top, comm=c)[0],
                   rows)
    _same(expected, actual, 1e-6)


def test_allreduce_keeps_sub32bit_dtypes():
    # MPI_Allreduce preserves the buffer type: int8 and bool SUM fold
    rows8 = _rows("int8", seed=4)
    got = _port("comm1d", lambda c, a: mt.allreduce(a, mt.SUM, comm=c)[0],
                rows8)
    assert got.dtype == np.int8
    _same(np.broadcast_to(rows8.sum(0, dtype=np.int8), rows8.shape), got)
    rowsb = _rows("bool", seed=5)
    got = _port("comm1d", lambda c, a: mt.allreduce(a, mt.SUM, comm=c)[0],
                rowsb)
    _same(np.broadcast_to(rowsb.any(0), rowsb.shape), got)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_allreduce_sum_gradient_matches_jax(request, grid):
    jcomm = request.getfixturevalue(grid)
    x, w = _rows("float32", seed=6), _rows("float32", seed=7)

    def jfn(a, b):
        return jax.grad(
            lambda v: (mj.allreduce(v, mj.SUM, comm=jcomm)[0] * b).sum())(a)

    def tfn(comm, a, b):
        a.requires_grad_()
        y, _ = mt.allreduce(a, mt.SUM, comm=comm)
        (y * b).sum().backward()
        return a.grad

    _same(_jax(jcomm, jfn, x, w), _port(grid, tfn, x, w))


SCAN_CASES = [("sum", "float32"), ("max", "int32"), ("lor", "bool"),
              ("prod", "int32")]
GATHER_CASES = [("gather", "float32"), ("gather", "int32"),
                ("gather", "bool")]


@pytest.fixture(scope="module")
def scan_expected(request):
    return _expected_by_case(request, SCAN_CASES, lambda c, n, x: mj.scan(
        x, jred.named_op(n), comm=c)[0])


@pytest.fixture(scope="module")
def allgather_expected(request):
    return _expected_by_case(request, GATHER_CASES, lambda c, n, x: (
        mj.allgather(x, comm=c)[0]))


@pytest.mark.parametrize("name,dtype", SCAN_CASES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_scan_matches_jax(scan_expected, grid, name, dtype):
    rows, expected = scan_expected[grid][(name, dtype)]
    actual = _port(grid, lambda c, a: mt.scan(a, name, comm=c)[0], rows)
    _same(expected, actual, FLOAT_NATIVE_TOL if dtype == "float32" else 0.0)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bool"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_allgather_matches_jax(allgather_expected, grid, dtype):
    rows, expected = allgather_expected[grid][("gather", dtype)]
    actual = _port(grid, lambda c, a: mt.allgather(a, comm=c)[0], rows)
    _same(expected, actual)


def test_subcomm_collectives_match_jax(comm2d):
    # the row, the column and the transposed ("x", "y") communicators
    rows = _rows("float32", seed=10)
    subs = [("x",), ("y",), ("x", "y")]

    def jfn(a):
        out = []
        for axes in subs:
            sub = comm2d.sub(*axes)
            out += [mj.allgather(a, comm=sub)[0].reshape(-1),
                    mj.allreduce(a, mj.MAX, comm=sub)[0].reshape(-1),
                    jnp.asarray(sub.rank(), jnp.float32)[None]]
        return jnp.concatenate(out)

    def tfn(comm, a):
        out = []
        for axes in subs:
            sub = comm.sub(*axes)
            out += [mt.allgather(a, comm=sub)[0].reshape(-1),
                    mt.allreduce(a, mt.MAX, comm=sub)[0].reshape(-1),
                    torch.tensor([float(sub.rank())])]
        return torch.cat(out)

    _same(_jax(comm2d, jfn, rows), _port("comm2d", tfn, rows))


def test_barrier_waits_for_every_rank():
    # rank 0 reaches the barrier late: no rank leaves it before then
    reached = {}
    lock = threading.Lock()

    def body(comm):
        if comm.rank() == 0:
            time.sleep(0.3)
            with lock:
                reached[0] = time.monotonic()
        tok = mt.barrier(comm=comm)
        assert isinstance(tok, mt.Token)
        return time.monotonic()

    left = local_world(4, body, timeout=TIMEOUT)
    assert min(left) >= reached[0]
    assert isinstance(mt.barrier(comm=mt.MeshComm()), mt.Token)


# -- sendrecv --------------------------------------------------------------


def _patterns(jcomm_or_comm):
    """The patterns of the sendrecv cases: a ring by callable and both
    shifts of each axis, periodic and not."""
    c = jcomm_or_comm
    n = c.size
    out = {"ring": (lambda r: (r - 1) % n, lambda r: (r + 1) % n)}
    for axis in c.axes:
        for per in (True, False):
            for disp in (1, -1):
                pairs = c.shift_perm(axis, disp, periodic=per)
                out[f"{axis}{disp:+d}{'p' if per else ''}"] = (pairs, pairs)
    return out


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_sendrecv_matches_jax(request, grid):
    jcomm = request.getfixturevalue(grid)
    send, recv = _rows("float32", seed=11), _rows("float32", seed=12)
    names = sorted(_patterns(jcomm))

    def jfn(s, r):
        pats = _patterns(jcomm)
        return jnp.stack([mj.sendrecv(s, r, source=pats[k][0],
                                      dest=pats[k][1], comm=jcomm)[0]
                          for k in names])

    def tfn(comm, s, r):
        pats = _patterns(comm)
        assert pats.keys() == _patterns(jcomm).keys()
        outs = []
        for k in names:
            st = mt.Status()
            y, _ = mt.sendrecv(s, r, source=pats[k][0], dest=pats[k][1],
                               comm=comm, status=st)
            src = [p for p, d in mt.ops.p2p._resolve_pairs(
                pats[k][1], comm.size, "dest") if d == comm.rank()]
            assert st.Get_source() == (src[0] if src else mt.ANY_SOURCE)
            outs.append(y)
        return torch.stack(outs)

    _same(_jax(jcomm, jfn, send, recv), _port(grid, tfn, send, recv))


@pytest.mark.parametrize("pattern", ["ring", "x+1", "y-1"])
def test_sendrecv_gradient_matches_jax(comm2d, pattern):
    # the cotangent travels back along the reversed pattern; a rank with
    # no inbound message passes its cotangent to its recv buffer
    s, r, w = (_rows("float32", seed=k) for k in (13, 14, 15))

    def jfn(a, b, c):
        src, dst = _patterns(comm2d)[pattern]
        return jax.grad(lambda u, v: (mj.sendrecv(
            u, v, source=src, dest=dst, comm=comm2d)[0] * c).sum(),
            argnums=(0, 1))(a, b)

    def tfn(comm, a, b, c):
        src, dst = _patterns(comm)[pattern]
        a.requires_grad_()
        b.requires_grad_()
        y, _ = mt.sendrecv(a, b, source=src, dest=dst, comm=comm)
        (y * c).sum().backward()
        return a.grad, b.grad

    _same(_jax(comm2d, jfn, s, r, w), _port("comm2d", tfn, s, r, w))


def test_sendrecv_multi_matches_jax(comm2d):
    a, b = _rows("float32", seed=16), _rows("int32", seed=17, shape=(4,))
    pairs = comm2d.shift_perm("y", 1, periodic=False)

    def jfn(u, v):
        outs, _ = mj.sendrecv_multi([u, v], [2 * u, 2 * v], source=pairs,
                                    dest=pairs, comm=comm2d)
        return tuple(outs)

    def tfn(comm, u, v):
        outs, _ = mt.sendrecv_multi([u, v], [2 * u, 2 * v], source=pairs,
                                    dest=pairs, comm=comm)
        return tuple(outs)

    expected, actual = _jax(comm2d, jfn, a, b), _port("comm2d", tfn, a, b)
    for e, g in zip(expected, actual):
        _same(e, g)


def test_sendrecv_pattern_errors():
    def body(comm):
        x = torch.zeros(2)
        with pytest.raises(ValueError, match="pattern, not one rank"):
            mt.sendrecv(x, x, source=1, dest=1, comm=comm)
        with pytest.raises(ValueError, match="disagree"):
            mt.sendrecv(x, x, source=lambda r: r, dest=lambda r: (r + 1) % 4,
                        comm=comm)
        with pytest.raises(ValueError, match="not a permutation"):
            mt.sendrecv(x, x, source=mt.ANY_SOURCE, dest=lambda r: 0,
                        comm=comm)

    local_world(4, body, timeout=TIMEOUT)


# -- send / recv (tests/collective_ops/test_send_and_recv.py:24-75) -------


def m_stack(m, *arrays):
    return (jnp if m is mj else torch).stack(arrays)


def _send_recv_cases():
    def ring(m, c, x):
        n = c.size
        tok = m.send(x, lambda r: (r + 1) % n, comm=c)
        return m.recv(x, lambda r: (r - 1) % n, comm=c, token=tok)[0]

    def fifo(m, c, x):
        n = c.size
        tok = m.send(x, lambda r: (r + 1) % n, tag=0, comm=c)
        tok = m.send(10 * x, lambda r: (r + 1) % n, tag=0, comm=c, token=tok)
        a, tok = m.recv(x, lambda r: (r - 1) % n, tag=0, comm=c, token=tok)
        b, tok = m.recv(x, lambda r: (r - 1) % n, tag=0, comm=c, token=tok)
        return m_stack(m, a, b)

    def tags(m, c, x):
        n = c.size
        tok = m.send(x, lambda r: (r + 1) % n, tag=1, comm=c)
        tok = m.send(-x, lambda r: (r + 1) % n, tag=2, comm=c, token=tok)
        b, tok = m.recv(x, lambda r: (r - 1) % n, tag=2, comm=c, token=tok)
        a, tok = m.recv(x, lambda r: (r - 1) % n, tag=1, comm=c, token=tok)
        return m_stack(m, b, a)

    def any_tag_any_source(m, c, x):
        n = c.size
        tok = m.send(x, lambda r: (r + 3) % n, tag=9, comm=c)
        return m.recv(x, m.ANY_SOURCE, m.ANY_TAG, comm=c, token=tok)[0]

    return {"ring": ring, "fifo": fifo, "tags": tags,
            "any_tag_any_source": any_tag_any_source}


@pytest.mark.parametrize("case", sorted(_send_recv_cases()))
def test_send_recv_matches_jax(comm1d, case):
    fn = _send_recv_cases()[case]
    rows = _rows("float32", seed=18)
    expected = _jax(comm1d, lambda a: fn(mj, comm1d, a), rows)
    actual = _port("comm1d", lambda c, a: fn(mt, c, a), rows)
    _same(expected, actual)


def test_send_recv_envelopes_and_status():
    # int partners are this rank's own; the status carries the true
    # envelope; a partner-less rank of a pattern sits out (PROC_NULL)
    def body(comm):
        r, n = comm.rank(), comm.size
        x = torch.full((2, 3), float(r), dtype=torch.float64)
        mt.send(x, (r + 1) % n, tag=40 + r, comm=comm)
        st = mt.Status()
        y, _ = mt.recv(torch.zeros(2, 3, dtype=torch.float64), (r - 1) % n,
                       mt.ANY_TAG, comm=comm, status=st)
        assert (st.Get_source(), st.Get_tag()) == ((r - 1) % n,
                                                   40 + (r - 1) % n)
        chain = [(q, q + 1) for q in range(n - 1)]  # no wrap
        mt.send(torch.tensor([r]), chain, tag=5, comm=comm)
        z, _ = mt.recv(torch.tensor([-1]), chain, tag=5, comm=comm, status=st)
        want = -1 if r == 0 else r - 1
        assert z.item() == want and (st.source == mt.ANY_SOURCE) == (r == 0)
        with pytest.raises(ValueError, match="does not match"):
            mt.send(torch.ones(3), (r + 1) % n, comm=comm)
            mt.recv(torch.ones(4), (r - 1) % n, comm=comm)
        with pytest.raises(ValueError, match="out of range"):
            mt.send(x, n, comm=comm)
        # a rank sends to itself: the message waits in its own box
        mt.send(x + 1, r, tag=3, comm=comm)
        me, _ = mt.recv(x, r, 3, comm=comm)
        with pytest.raises(RuntimeError, match="no matching send"):
            mt.recv(x, r, 3, comm=comm)
        return y, me

    for r, (y, me) in enumerate(local_world(4, body, timeout=TIMEOUT)):
        assert torch.equal(y, torch.full((2, 3), float((r - 1) % 4),
                                         dtype=torch.float64))
        assert torch.equal(me, torch.full((2, 3), r + 1.0,
                                          dtype=torch.float64))


def test_one_rank_send_recv():
    comm = mt.MeshComm()
    x = torch.arange(3.0)
    tok = mt.send(x, 0, tag=4, comm=comm)
    y, _ = mt.recv(torch.zeros(3), 0, 4, comm=comm, token=tok)
    assert torch.equal(y, x)
    with pytest.raises(RuntimeError, match="no matching send"):
        mt.recv(torch.zeros(3), 0, 4, comm=comm)


# -- split, sub, clone (tests/test_comm_split.py:24-132) --------------------


SPLITS = {
    "parity": lambda c: c.split(lambda r: r % 2),
    "halves": lambda c: c.split(lambda r: r // 4),
    "parity_reversed": lambda c: c.split(lambda r: r % 2, key=lambda r: -r),
    "undefined": lambda c: c.split(lambda r: 0 if r < 4 else None),
    "split_of_split": lambda c: c.split(lambda r: r // 4).split(
        lambda r: r % 2),
}


def test_split_groups_match_jax(comm1d, comm2d):
    # the partitions, sizes, ranks and group ids
    def body(comm):
        return {k: (s.groups, s.size, s.rank(), s.group_id())
                for k, make in SPLITS.items() for s in [make(comm)]}

    got = local_world(8, body, axes=GRIDS["comm1d"], timeout=TIMEOUT)
    for k, make in SPLITS.items():
        js = make(comm1d)
        assert all(g[k][:2] == (js.groups, js.size) for g in got), k
    # tests/test_comm_split.py's readings
    assert [g["halves"][2] + 10 * g["halves"][3] for g in got] == [
        0, 1, 2, 3, 10, 11, 12, 13]
    assert [g["parity_reversed"][2] for g in got] == [3, 3, 2, 2, 1, 1, 0, 0]
    assert got[0]["undefined"][0] == ((0, 1, 2, 3), (4, 5, 6, 7))
    assert got[0]["split_of_split"][0] == ((0, 2), (1, 3), (4, 6), (5, 7))
    rows = local_world(8, lambda c: c.split(lambda r: r // 4).groups,
                       axes=GRIDS["comm2d"], timeout=TIMEOUT)
    assert all(r == comm2d.split(lambda q: q // 4).groups for r in rows)


def test_split_errors():
    def errors(comm):
        with pytest.raises(ValueError, match="equal-size"):
            comm.split(lambda r: 0 if r < 3 else 1)
        with pytest.raises(ValueError, match="cover all 4 ranks"):
            comm.split(lambda r: r // 4).split([0] * 8)
        with pytest.raises(ValueError, match="Cartesian"):
            comm.split(lambda r: r % 2).shift_perm("y", 1)
        with pytest.raises(ValueError, match="sub-communicator"):
            comm.split(lambda r: r // 4).sub("x")

    local_world(8, errors, axes=GRIDS["comm2d"], timeout=TIMEOUT)


@pytest.mark.parametrize("color,key", [
    (lambda r: r % 2, None),
    (lambda r: r // 4, None),
    (lambda r: r % 2, lambda r: -r),
], ids=["parity", "halves", "parity_reversed"])
def test_split_collectives_match_jax(comm1d, color, key):
    # allreduce per group, scan within a group, allgather in (key, rank)
    # order and a ring within each group
    rows = _rows("float32", seed=19, shape=(2,))

    def make(c):
        return c.split(color, key=key)

    def jfn(a):
        h = make(comm1d)
        n = h.size
        return jnp.concatenate([
            mj.allreduce(a, mj.SUM, comm=h)[0],
            mj.scan(a, mj.SUM, comm=h)[0],
            mj.allgather(a, comm=h)[0].reshape(-1),
            mj.sendrecv(a, a, source=lambda r: (r - 1) % n,
                        dest=lambda r: (r + 1) % n, comm=h)[0],
        ])

    def tfn(comm, a):
        h = make(comm)
        n = h.size
        return torch.cat([
            mt.allreduce(a, mt.SUM, comm=h)[0],
            mt.scan(a, mt.SUM, comm=h)[0],
            mt.allgather(a, comm=h)[0].reshape(-1),
            mt.sendrecv(a, a, source=lambda r: (r - 1) % n,
                        dest=lambda r: (r + 1) % n, comm=h)[0],
        ])

    _same(_jax(comm1d, jfn, rows), _port("comm1d", tfn, rows),
          FLOAT_NATIVE_TOL)


def test_split_of_2d_rows_equals_sub():
    rows = _rows("float32", seed=20)

    def tfn(comm, a):
        by_split = mt.allgather(a, comm=comm.split(lambda r: r // 4))[0]
        by_sub = mt.allgather(a, comm=comm.sub("x"))[0]
        return torch.stack([by_split, by_sub])

    got = _port("comm2d", tfn, rows)
    _same(got[:, 0], got[:, 1])


def test_clone_is_a_fresh_namespace():
    # a message sent on a clone is not received on the original, and
    # sub-communicators of the clone stay in the clone's namespace
    def body(comm):
        r, n = comm.rank(), comm.size
        twin = comm.clone()
        assert twin != comm and twin.context == comm.clone().context - 1
        mt.send(torch.tensor([100 + r]), (r + 1) % n, tag=0, comm=twin)
        mt.send(torch.tensor([r]), (r + 1) % n, tag=0, comm=comm)
        mine, _ = mt.recv(torch.tensor([0]), mt.ANY_SOURCE, comm=comm)
        theirs, _ = mt.recv(torch.tensor([0]), mt.ANY_SOURCE, comm=twin)
        row = twin.sub("x")
        assert row.context == twin.context
        total, _ = mt.allreduce(torch.tensor([r]), mt.SUM, comm=row)
        return mine.item(), theirs.item(), total.item()

    got = local_world(8, body, axes=GRIDS["comm2d"], timeout=TIMEOUT)
    for r, (mine, theirs, total) in enumerate(got):
        assert (mine, theirs) == ((r - 1) % 8, 100 + (r - 1) % 8)
        assert total == sum(range(4 * (r // 4), 4 * (r // 4) + 4))


# -- worlds --------------------------------------------------------------


def test_failing_rank_fails_the_world_within_its_deadline():
    # rank 2 raises; the others wait on it in an allreduce until their
    # group timeout; the world re-raises rank 2's error, naming it
    def body(comm):
        if comm.rank() == 2:
            raise ValueError("planted failure")
        mt.allreduce(torch.ones(1), mt.SUM, comm=comm)

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 2 of a 4-rank local world "
                       "failed: ValueError: planted failure"):
        local_world(4, body, timeout=2.0)
    assert time.monotonic() - t0 < 12.0


def test_hanging_rank_hits_the_deadline():
    stop = threading.Event()

    def body(comm):
        if comm.rank() == 1:
            stop.wait(10.0)

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of a 2-rank"):
        local_world(2, body, timeout=2.0, deadline=1.0)
    stop.set()
    assert time.monotonic() - t0 < 5.0


def test_world_entry_points_without_a_world(monkeypatch):
    with pytest.raises(RuntimeError, match="initialize"):
        distributed.world_comm()
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.initialize(device="cpu")
    with pytest.raises(RuntimeError, match="does not cover"):
        local_world(2, lambda comm: comm.world.comm((("y", "x"), (2, 2))),
                    timeout=TIMEOUT)


def test_finalize_ends_a_local_world_after_every_rank():
    # its host barrier: no rank leaves before the late one arrives; then
    # the rank's groups are dropped
    reached = {}

    def body(comm):
        mt.allreduce(torch.ones(1), mt.SUM, comm=comm.sub("x"))
        if comm.rank() == 0:
            time.sleep(0.3)
            reached[0] = time.monotonic()
        distributed.finalize(comm.world)
        assert comm.world._transports == {}
        return time.monotonic()

    left = local_world(4, body, axes=(("y", "x"), (2, 2)), timeout=TIMEOUT)
    assert min(left) >= reached[0]


def test_finalize_ends_the_joined_world_in_order(monkeypatch):
    # device, graphs, barrier, groups; with no world joined, nothing
    from mpi4jax_tpu_torch.utils import runtime

    calls = []

    class Graph:
        def reset(self):
            calls.append("graph reset")

    class World:
        size, device = 1, torch.device("cpu")

        def release(self):
            calls.append("groups released")

    graphs = [Graph(), Graph()]
    for g in graphs:
        runtime._graphs.add(g)
    monkeypatch.setattr(distributed, "_dist_world", World())
    monkeypatch.setattr(distributed.dist, "destroy_process_group",
                        lambda: calls.append("default group destroyed"))
    distributed.finalize()
    assert calls == ["graph reset", "graph reset", "groups released",
                     "default group destroyed"]
    assert distributed._dist_world is None and len(runtime._graphs) == 0
    distributed.finalize()
    assert len(calls) == 4


def test_launch_counts_survive_racing_ranks(monkeypatch):
    # the ranks of a local world on one card launch from their own
    # threads: no count may be lost (more threads than cores, the
    # interpreter switching threads as often as it can)
    import sys

    from mpi4jax_tpu_torch.kernels import sw_step

    # this build of torch has no CUDA: no stream is ever capturing
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)

    n_threads, per_thread = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sw_step.reset_launch_counts()
        threads = [threading.Thread(target=lambda: [
            sw_step._count(sw_step.sw_main) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert not any(t.is_alive() for t in threads)
        assert sw_step.sw_main.launches == n_threads * per_thread
    finally:
        sys.setswitchinterval(old)
        sw_step.reset_launch_counts()


@pytest.mark.parametrize("shape", [(4, 2), (2, 1)], ids=["4x2", "2x1"])
def test_ops_on_other_grids_match_jax(shape):
    # the solver's other grids: every op kind once, in one program
    n = prod(shape)
    mesh = jax.make_mesh(shape, ("y", "x"), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jcomm = mj.MeshComm.from_mesh(mesh)
    f = _rows("float32", seed=21, n=n)
    i = _rows("int32", seed=22, n=n)
    b = _rows("bool", seed=23, n=n)

    def body(m, c, x, k, q):
        ring = [(r, (r + 1) % n) for r in range(n)]
        sx = c.shift_perm("x", 1, periodic=True)
        sy = c.shift_perm("y", -1, periodic=False)
        tok = m.send(x, lambda r: (r + 1) % n, tag=4, comm=c)
        got, tok = m.recv(x, lambda r: (r - 1) % n, m.ANY_TAG, comm=c,
                          token=tok)
        multi, _ = m.sendrecv_multi([x, k], [-x, -k], source=sy, dest=sy,
                                    comm=c)
        return (m.allreduce(x, m.MAX, comm=c)[0],
                m.allreduce(k, m.BXOR, comm=c)[0],
                m.allreduce(q, m.LXOR, comm=c)[0],
                m.scan(k, m.SUM, comm=c.sub("y"))[0],
                m.allgather(x, comm=c.sub("x"))[0],
                m.sendrecv(x, -x, source=ring, dest=ring, comm=c)[0],
                m.sendrecv(x, -x, source=sx, dest=sx, comm=c)[0],
                multi[0], multi[1], got)

    expected = _jax(jcomm, lambda x, k, q: body(mj, jcomm, x, k, q), f, i, b)

    def port(comm):
        r = comm.rank()
        out = body(mt, comm, *(torch.from_numpy(a[r].copy())
                               for a in (f, i, b)))
        return [t.numpy() for t in out]

    got = local_world(n, port, axes=(("y", "x"), shape), timeout=TIMEOUT)
    for k, e in enumerate(expected):
        _same(e, np.stack([g[k] for g in got]))
