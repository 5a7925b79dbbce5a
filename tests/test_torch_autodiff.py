"""Autodiff of the PyTorch port's communication ops: reverse mode,
forward mode (``torch.autograd.forward_ad``) and ``torch.func``
(``grad``, ``vmap``, ``jvp``), against JAX's ``grad``, ``jvp`` and
``vmap`` of the same ops on the 8-device virtual mesh (``comm1d``: 8
ranks, ``comm2d``: 2x4, ``tests/conftest.py``); the port runs in local
worlds of the same shape (threads over gloo).

The cases follow the JAX package's tests: the allgather gradient
(``tests/collective_ops/test_collectives.py::test_allgather_grad``), the
allreduce AD battery (``test_allreduce.py``: grad, jvp, vmap), the
sendrecv jvp (``test_sendrecv.py``), the distributed matvec
(``test_allreduce_matvec.py``: grad and jvp), the reduce_scatter grad
and jvp (``test_reduce_scatter.py``) and the vmap battery
(``test_dtypes_and_vmap.py``: bcast, allgather, sendrecv).

Forward mode has one dual level per process, so the thread ranks' dual
tensors live in one level entered around the world
(``parallel/distributed.py:local_world``); ``torch.func.jvp`` runs on
one rank.

Tolerances: exact where only data moves or integers add; float32 sums
within FLOAT_NATIVE_TOL (4e-6) of the largest value, since gloo and the
rank-ordered fold add in another order than XLA.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch import func

import mpi4jax_tpu as mj

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.parallel.distributed import local_world

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


# -- reverse mode ----------------------------------------------------------


def test_allgather_gradient_reaches_every_rank():
    # the probe of the fault: (2x).sum() + allgather(x).sum() on two
    # ranks gives 2 + 2 per element (it read 2.0 when the gather
    # dropped its gradient)
    def body(comm):
        x = torch.full((3,), comm.rank() + 1.0, requires_grad=True)
        y, _ = mt.allgather(x, comm=comm)
        assert y.requires_grad
        ((2 * x).sum() + y.sum()).backward()
        return x.grad

    for g in local_world(2, body, timeout=TIMEOUT):
        assert torch.equal(g, torch.full((3,), 4.0))


def _grad_cases(m, comm):
    """``(name, fn(x) -> y)`` of every differentiable op, on an (8, 3)
    per-rank input (the rank axis first where the op has one)."""
    sub = comm.sub("x") if "x" in comm.axes else comm.split(
        lambda r: r % 2, key=lambda r: -r)
    return [
        ("allgather", lambda x: m.allgather(x, comm=comm)[0]),
        ("allgather sub", lambda x: m.allgather(x, comm=sub)[0]),
        ("scan", lambda x: m.scan(x, m.SUM, comm=comm)[0]),
        ("scan sub", lambda x: m.scan(x, m.SUM, comm=sub)[0]),
        ("alltoall", lambda x: m.alltoall(x, comm=comm)[0]),
        ("alltoall sub", lambda x: m.alltoall(x[:4], comm=sub)[0]),
        ("reduce_scatter", lambda x: m.reduce_scatter(x, comm=comm)[0]),
        ("reduce_scatter sub",
         lambda x: m.reduce_scatter(x[:4], comm=sub)[0]),
        ("bcast 0", lambda x: m.bcast(x, 0, comm=comm)[0]),
        ("bcast 3", lambda x: m.bcast(x, 3, comm=comm)[0]),
        ("bcast sub", lambda x: m.bcast(x, 2, comm=sub)[0]),
        ("scatter 0", lambda x: m.scatter(x, 0, comm=comm)[0]),
        ("scatter 6", lambda x: m.scatter(x, 6, comm=comm)[0]),
        ("scatter sub", lambda x: m.scatter(x[:4], 3, comm=sub)[0]),
        ("allreduce", lambda x: m.allreduce(x, m.SUM, comm=comm)[0]),
        ("sendrecv", lambda x: m.sendrecv(
            x, 2 * x, source=lambda r: r - 1 if r > 0 else None,
            dest=lambda r: r + 1 if r < comm.size - 1 else None,
            comm=comm)[0]),
    ]


GRAD_NAMES = [name for name, _ in _grad_cases(mt, mt.MeshComm())]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_gradients_match_jax(request, grid):
    # d/dx of sum(op(x) * w) with w drawn per rank; sub comms are the
    # 2x4 grid's rows, or a split with reversed keys on 8 ranks
    jcomm = request.getfixturevalue(grid)
    x = _rows("float32", seed=1, shape=(N, 3))
    # per rank enough weights for the largest output, (8, 8, 3)
    weights = {name: _rows("float32", seed=10 + k, shape=(N * N * 3,))
               for k, name in enumerate(GRAD_NAMES)}

    def jfn(a, *ws):
        cases = dict(_grad_cases(mj, jcomm))
        out = []
        for name, w in zip(GRAD_NAMES, ws):
            fn = cases[name]

            def loss(v, fn=fn, w=w):
                y = fn(v)
                return (y * w[:y.size].reshape(y.shape)).sum()

            out.append(jax.grad(loss)(a))
        return tuple(out)

    def tfn(comm, a, *ws):
        cases = dict(_grad_cases(mt, comm))
        out = []
        for name, w in zip(GRAD_NAMES, ws):
            v = a.clone().requires_grad_()
            y = cases[name](v)
            (y * w[:y.numel()].reshape(y.shape)).sum().backward()
            out.append(v.grad)
        return tuple(out)

    ws = [weights[n] for n in GRAD_NAMES]
    expected = _jax(jcomm, jfn, x, *ws)
    actual = _port(grid, tfn, x, *ws)
    for name, e, g in zip(GRAD_NAMES, expected, actual, strict=True):
        exact = name.startswith(("alltoall", "scatter", "sendrecv",
                                 "allreduce"))
        _same(e, g, 0.0 if exact else FLOAT_NATIVE_TOL)


def test_scatter_template_gradient():
    # the multi-process form: the root gets the stacked cotangents, a
    # rank that passed a template gets zeros of the template's shape
    def body(comm):
        r = comm.rank()
        x = (torch.arange(8.0).reshape(4, 2) if r == 1
             else torch.zeros(2)).requires_grad_()
        y, _ = mt.scatter(x, 1, comm=comm)
        (y * (r + 1)).sum().backward()
        return x.grad

    got = local_world(4, body, timeout=TIMEOUT)
    assert torch.equal(got[1], torch.arange(1.0, 5.0)[:, None].expand(4, 2))
    for r in (0, 2, 3):
        assert torch.equal(got[r], torch.zeros(2))


def test_reduce_scatter_grad_closed_form(comm1d):
    # tests/collective_ops/test_reduce_scatter.py::test_reduce_scatter_grad
    xs = _rows("float32", seed=2, shape=(N, 2))

    def tfn(comm, v):
        v.requires_grad_()
        y, _ = mt.reduce_scatter(v, comm=comm)
        (y * y).sum().backward()
        return v.grad

    got = _port("comm1d", tfn, xs)
    sums = xs.sum(axis=0)
    np.testing.assert_allclose(got, 2.0 * np.broadcast_to(sums[None],
                                                          xs.shape),
                               atol=1e-5)


def test_matvec_gradient_matches_jax(comm1d):
    # tests/collective_ops/test_allreduce_matvec.py: per-rank loss
    # ||y||^2 of the allreduced partial products; 2 A^T A x
    a, x = _matvec_setup()

    def tfn(comm, xl):
        xl.requires_grad_()
        y = _matvec(mt, comm, a, xl)
        (y ** 2).sum().backward()
        return xl.grad

    got = _port("comm1d", tfn, x.reshape(N, -1)).reshape(-1)
    np.testing.assert_allclose(got, 2 * a.T @ (a @ x), rtol=1e-3, atol=1e-5)


def _matvec_setup():
    rng = np.random.RandomState(42)
    a = rng.randn(16, 16).astype(np.float32)
    return a, rng.randn(16).astype(np.float32)


def _matvec(m, comm, a, xl):
    cols = 16 // N
    r = comm.rank()
    if m is mj:
        al = jax.lax.dynamic_slice_in_dim(jnp.asarray(a), r * cols, cols,
                                          axis=1)
    else:
        al = torch.from_numpy(a[:, r * cols:(r + 1) * cols].copy())
    return m.allreduce(al @ xl, m.SUM, comm=comm)[0]


def test_non_sum_and_rooted_gradients_raise():
    # never a silent zero: non-SUM reductions, and gather / reduce across
    # ranks (the JAX package's multi-process backend has no rule)
    def body(comm):
        x = torch.ones(4, 2, requires_grad=True)
        for name, fn in (
                ("allreduce", lambda: mt.allreduce(x, mt.MAX, comm=comm)[0]),
                ("reduce_scatter",
                 lambda: mt.reduce_scatter(x, mt.PROD, comm=comm)[0]),
                ("scan", lambda: mt.scan(x, mt.MIN, comm=comm)[0])):
            with pytest.raises(NotImplementedError,
                               match=f"gradient of {name} is only defined"):
                fn().sum().backward()
        for name, fn in (("gather", lambda: mt.gather(x, 1, comm=comm)[0]),
                         ("reduce",
                          lambda: mt.reduce(x, mt.SUM, 1, comm=comm)[0])):
            with pytest.raises(NotImplementedError,
                               match=f"{name} across ranks is not "
                               f"differentiable.*all{name} has one"):
                fn().sum().backward()

    local_world(4, body, timeout=TIMEOUT)


def test_rank_skipping_a_backward_fails_within_the_timeout():
    # rank 1 never runs its backward: rank 0's backward reduce-scatter
    # waits for it until the group's timeout, then the world fails
    def body(comm):
        x = torch.ones(3, requires_grad=True)
        y, _ = mt.allgather(x, comm=comm)
        if comm.rank() == 0:
            y.sum().backward()

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of a 2-rank local world "
                       "failed"):
        local_world(2, body, timeout=2.0)
    assert time.monotonic() - t0 < 12.0


# -- forward mode ----------------------------------------------------------


def _tangent_cases(m, comm):
    ring = [(r, (r + 1) % comm.size) for r in range(comm.size)]
    chain = [(r, r + 1) for r in range(comm.size - 1)]
    return [
        ("allreduce", lambda x: m.allreduce(x, m.SUM, comm=comm)[0]),
        ("sendrecv ring", lambda x: m.sendrecv(x, x, source=ring, dest=ring,
                                               comm=comm)[0]),
        ("sendrecv chain", lambda x: m.sendrecv(x, -x, source=chain,
                                                dest=chain, comm=comm)[0]),
        ("reduce_scatter", lambda x: m.reduce_scatter(x, comm=comm)[0]),
        ("allgather", lambda x: m.allgather(x, comm=comm)[0]),
        ("alltoall", lambda x: m.alltoall(x, comm=comm)[0]),
        ("scan", lambda x: m.scan(x, m.SUM, comm=comm)[0]),
        ("bcast", lambda x: m.bcast(x, 5, comm=comm)[0]),
        ("scatter", lambda x: m.scatter(x, 2, comm=comm)[0]),
    ]


TANGENT_NAMES = [n for n, _ in _tangent_cases(mt, mt.MeshComm())]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_forward_mode_matches_jax_jvp(request, grid):
    jcomm = request.getfixturevalue(grid)
    x, t = (_rows("float32", seed=s, shape=(N, 3)) for s in (20, 21))

    def jfn(a, b):
        out = []
        for _, fn in _tangent_cases(mj, jcomm):
            y, yt = jax.jvp(fn, (a,), (b,))
            out += [y, yt]
        return tuple(out)

    def tfn(comm, a, b):
        out = []
        for _, fn in _tangent_cases(mt, comm):
            y = fn(fwAD.make_dual(a, b))
            primal, tangent = fwAD.unpack_dual(y)
            out += [primal, tangent]
        return tuple(out)

    expected = _jax(jcomm, jfn, x, t)
    with fwAD.dual_level():
        actual = _port(grid, tfn, x, t)
    for k, (e, g) in enumerate(zip(expected, actual, strict=True)):
        name = TANGENT_NAMES[k // 2]
        exact = name.startswith(("sendrecv", "allgather", "alltoall",
                                 "bcast", "scatter"))
        _same(e, g, 0.0 if exact else FLOAT_NATIVE_TOL)


def test_allreduce_jvp_closed_form():
    # tests/collective_ops/test_allreduce.py::test_allreduce_jvp
    ranks = np.arange(float(N), dtype=np.float32)[:, None]

    def tfn(comm, a):
        y = mt.allreduce(fwAD.make_dual(a, a), mt.SUM, comm=comm)[0]
        return torch.cat(fwAD.unpack_dual(y)[:2])

    with fwAD.dual_level():
        got = _port("comm1d", tfn, ranks)
    _same(np.full((N, 2), 28.0, np.float32), got)


def test_matvec_jvp_matches_jax(comm1d):
    # tests/collective_ops/test_allreduce_matvec.py::test_matvec_jvp
    a, x = _matvec_setup()
    ones = np.ones((N, 2), np.float32)
    expected = _jax(comm1d, lambda xl, v: jax.jvp(
        lambda u: _matvec(mj, comm1d, a, u), (xl,), (v,))[1],
        x.reshape(N, -1), ones)

    def tfn(comm, xl, v):
        y = _matvec(mt, comm, a, fwAD.make_dual(xl, v))
        return fwAD.unpack_dual(y).tangent

    with fwAD.dual_level():
        got = _port("comm1d", tfn, x.reshape(N, -1), ones)
    _same(expected, got, FLOAT_NATIVE_TOL)
    np.testing.assert_allclose(got, np.broadcast_to(a @ np.ones(16), got.shape),
                               rtol=1e-3)


def test_non_sum_tangents_raise():
    def body(comm):
        x = fwAD.make_dual(torch.ones(4, 2), torch.ones(4, 2))
        for name, fn in (
                ("allreduce", lambda: mt.allreduce(x, mt.MAX, comm=comm)),
                ("reduce_scatter",
                 lambda: mt.reduce_scatter(x, mt.MIN, comm=comm)),
                ("scan", lambda: mt.scan(x, mt.PROD, comm=comm))):
            with pytest.raises(NotImplementedError,
                               match=f"gradient of {name} is only defined"):
                fn()
        for name, fn in (("gather", lambda: mt.gather(x, 0, comm=comm)),
                         ("reduce", lambda: mt.reduce(x, mt.SUM, 0,
                                                      comm=comm))):
            with pytest.raises(NotImplementedError,
                               match=f"{name} across ranks"):
                fn()

    with fwAD.dual_level():
        local_world(4, body, timeout=TIMEOUT)


# -- torch.func ---------------------------------------------------------------


def test_vmap_matches_jax(comm1d):
    # tests/collective_ops/test_dtypes_and_vmap.py (bcast, allgather,
    # sendrecv) and test_allreduce.py::test_allreduce_vmap, per rank a
    # batch of columns; then every other op with the batch moved behind
    # the rank axis
    x = _rows("float32", seed=30, shape=(N, 3))
    shift = [(r, (r + 1) % N) for r in range(N)]

    def run(m, vmap, comm, v):
        v2 = v[:, :, None] * (jnp if m is mj else torch).ones(2)
        return (
            vmap(lambda c: m.allreduce(c, m.SUM, comm=comm)[0])(
                (jnp if m is mj else torch).stack([v, 2 * v, 3 * v])),
            vmap(lambda c: m.bcast(c, 2, comm=comm)[0], 1, 1)(v),
            vmap(lambda c: m.allgather(c, comm=comm)[0], 1, 1)(v),
            vmap(lambda c: m.sendrecv(c, c, source=shift, dest=shift,
                                      comm=comm)[0], 1, 1)(v),
            vmap(lambda c: m.alltoall(c, comm=comm)[0], 1, 1)(v),
            vmap(lambda c: m.scatter(c, 4, comm=comm)[0], 1, 0)(v2),
            vmap(lambda c: m.scan(c, m.SUM, comm=comm)[0], 1, 1)(v),
        )

    expected = _jax(comm1d, lambda v: run(mj, jax.vmap, comm1d, v), x)
    actual = _port("comm1d", lambda c, v: run(mt, func.vmap, c, v), x)
    for k, (e, g) in enumerate(zip(expected, actual, strict=True)):
        _same(e, g, FLOAT_NATIVE_TOL if k in (0, 6) else 0.0)

    # the JAX package's reduce_scatter does not batch (its fence meets a
    # batched psum_scatter): held to one reduce_scatter per column instead
    def rs(comm, v):
        v2 = v[:, :, None] * torch.ones(2)
        cols = torch.stack([mt.reduce_scatter(v2[:, j], comm=comm)[0]
                            for j in range(3)])
        return func.vmap(lambda c: mt.reduce_scatter(c, comm=comm)[0],
                         1, 0)(v2), cols

    batched, cols = _port("comm1d", rs, x)
    _same(cols, batched, FLOAT_NATIVE_TOL)
    np.testing.assert_allclose(batched, np.broadcast_to(
        x.sum(0)[:, :, None], (N, 3, 2)), rtol=1e-5, atol=1e-5)


def test_vmap_sendrecv_with_an_unbatched_buffer():
    # the recv buffer is not batched: the batching rule expands it
    def body(comm):
        n = comm.size
        ring = [(r, (r + 1) % n) for r in range(n)]
        recv = torch.full((2,), -1.0)
        return func.vmap(lambda c: mt.sendrecv(c, recv, source=ring,
                                               dest=ring, comm=comm)[0])(
            torch.full((3, 2), float(comm.rank())))

    for r, y in enumerate(local_world(4, body, timeout=TIMEOUT)):
        assert torch.equal(y, torch.full((3, 2), float((r - 1) % 4)))


def test_func_grad_matches_jax(comm1d):
    # test_allreduce.py::test_allreduce_grad: the identity transpose
    x = _rows("float32", seed=31, shape=(4,))
    expected = _jax(comm1d, lambda v: jax.grad(
        lambda u: (mj.allreduce(u, mj.SUM, comm=comm1d)[0] * u).sum())(v), x)
    got = _port("comm1d", lambda c, v: func.grad(
        lambda u: (mt.allreduce(u, mt.SUM, comm=c)[0] * u).sum())(v), x)
    _same(expected, got, FLOAT_NATIVE_TOL)


@pytest.mark.parametrize("comm", [mt.SelfComm(), mt.MeshComm()],
                         ids=["self", "mesh"])
def test_one_rank_transforms(comm):
    # on one rank every op is a local identity or reshape, and every
    # transform goes through it (torch.func.jvp included)
    x = torch.arange(6.0).reshape(1, 6)
    t = torch.ones(1, 6)
    ops = [lambda v: mt.allreduce(v, comm=comm)[0],
           lambda v: mt.allgather(v, comm=comm)[0][0],
           lambda v: mt.alltoall(v, comm=comm)[0],
           lambda v: mt.reduce_scatter(v, comm=comm)[0][None],
           lambda v: mt.scan(v, mt.SUM, comm=comm)[0],
           lambda v: mt.bcast(v, 0, comm=comm)[0],
           lambda v: mt.scatter(v, 0, comm=comm)[0][None],
           lambda v: mt.gather(v, 0, comm=comm)[0][0],
           lambda v: mt.reduce(v, mt.SUM, 0, comm=comm)[0],
           lambda v: mt.sendrecv(v, v, 0, 0, comm=comm)[0]]
    for fn in ops:
        assert torch.equal(func.jvp(fn, (x,), (t,))[1], t)
        assert torch.equal(func.grad(lambda v: (fn(v) * 3).sum())(x),
                           torch.full_like(x, 3.0))
        assert torch.equal(func.vmap(fn, 1, 1)(x[:, None].expand(1, 2, 6)),
                           x[:, None].expand(1, 2, 6))
