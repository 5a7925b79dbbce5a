"""The PyTorch port's shallow-water solver decomposed over a grid of
ranks, on the CPU (the kernels' plain versions), against the JAX
package.

At 24x48 on grids 2x4, 4x2 and 2x1 and at ghost 1, 2 and 4 (the shapes
of ``tests/test_shallow_water.py``'s decomposition tests), each rank of
a local world (threads, gloo) runs ``make_init``, ``make_first_step``
and ``make_multistep`` on its block, and ``gather_global`` reassembles
h:

* against the JAX package's ``run_h`` on the same grid: 2e-4 of max|h|,
  the tolerance of the port's one-rank solver tests;
* against the port's own one-rank run: atol 2e-4, the JAX package's
  decomposition tolerance (``tests/test_shallow_water.py``).  The mean
  depth's sum runs in another order on each grid, so bit equality is
  not expected.

Every rank must gather the same h.  ``state_from_jax`` hands each rank
its block of a JAX global state, so both packages can continue from
the same numbers, and ``make_solver`` keeps its timing contract on a
grid.
"""

import dataclasses
from math import prod

import jax
import numpy as np
import pytest
import torch

from mpi4jax_tpu.models import shallow_water as jsw
from tests.test_shallow_water import run_h

from mpi4jax_tpu_torch.models import shallow_water as tsw
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.parallel.distributed import local_world

torch.set_num_threads(1)

STEPS = 5
SHAPES = [(2, 4), (4, 2), (2, 1)]
GHOSTS = [1, 2, 4]
TIMEOUT = 30.0


def _cfg(ghost):
    return tsw.SWConfig(ny=24, nx=48, ghost=ghost)


def _run(cfg, comm):
    st = tsw.make_init(cfg, comm, device="cpu")()
    st = tsw.make_first_step(cfg, comm)(st)
    st = tsw.make_multistep(cfg, comm, STEPS)(st)
    return tsw.gather_global(st.h, comm, ghost=cfg.ghost).numpy()


def _on_grid(shape, fn):
    """``fn(comm)`` on every rank of a ``shape`` grid of ranks."""
    return local_world(prod(shape), fn, axes=(("y", "x"), shape),
                       timeout=TIMEOUT)


@pytest.fixture(scope="module")
def one_rank_h():
    return {g: _run(_cfg(g), MeshComm()) for g in GHOSTS}


def _rel_close(expected, actual, tol, what):
    scale = max(float(np.abs(expected).max()), 1e-30)
    err = float(np.abs(expected - actual).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ghost", GHOSTS, ids=lambda g: f"ghost{g}")
def test_decomposed_solver_matches_jax(one_rank_h, ghost, shape):
    cfg = _cfg(ghost)
    hs = _on_grid(shape, lambda comm: _run(cfg, comm))
    for h in hs[1:]:
        np.testing.assert_array_equal(h, hs[0])
    h = hs[0]
    assert h.shape == (24, 48) and np.isfinite(h).all()
    jcfg = jsw.SWConfig(**dataclasses.asdict(cfg))
    _rel_close(run_h(shape, steps=STEPS, cfg=jcfg), h, 2e-4, "vs JAX")
    np.testing.assert_allclose(h, one_rank_h[ghost], rtol=0, atol=2e-4)
    np.testing.assert_allclose(h.mean(), cfg.depth, rtol=1e-5)


def _jax_state(jcfg, shape, first_step):
    """A JAX state on a ``shape`` mesh: the initial state, after the
    first step if asked; the global arrays of its blocks."""
    mesh = jax.make_mesh(shape, ("y", "x"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    from mpi4jax_tpu import MeshComm as JMeshComm

    jcomm = JMeshComm.from_mesh(mesh)
    st = jsw.make_init(jcfg, jcomm)()
    if first_step:
        st = jsw.make_first_step(jcfg, jcomm)(st)
    return st, jcomm


def test_state_from_jax_gives_each_rank_its_block():
    # the port's initial state on a 2x4 grid against JAX's, block by
    # block (the tolerances of the one-rank initial-state test); then
    # both continue from JAX's first-step state for 5 AB2 steps
    cfg = _cfg(2)
    jcfg = jsw.SWConfig(**dataclasses.asdict(cfg))
    init, _ = _jax_state(jcfg, (2, 4), first_step=False)
    start, jcomm = _jax_state(jcfg, (2, 4), first_step=True)
    expected = jsw.make_multistep(jcfg, jcomm, STEPS)(start)
    arrays = [np.asarray(a) for a in init]
    start = [np.asarray(a) for a in start]
    expected = [np.asarray(a) for a in expected]

    def body(comm):
        want = tsw.state_to_numpy(tsw.state_from_jax(arrays, cfg, comm,
                                                     device="cpu"))
        got = tsw.state_to_numpy(tsw.make_init(cfg, comm, device="cpu")())
        for name, tol in (("h", 1e-5), ("u", 1e-6), ("v", 1e-6)):
            i = tsw.SWState._fields.index(name)
            _rel_close(want[i], got[i], tol, name)
        s0 = tsw.state_from_jax(start, cfg, comm, device="cpu")
        out = tsw.state_to_numpy(tsw.make_multistep(cfg, comm, STEPS)(s0))
        mine = tsw.state_to_numpy(tsw.state_from_jax(expected, cfg, comm,
                                                     device="cpu"))
        G = cfg.ghost
        for i in range(3):
            _rel_close(mine[i][G:-G, G:-G], out[i][G:-G, G:-G], 2e-4,
                       tsw.SWState._fields[i])
        return want[0].shape

    assert set(_on_grid((2, 4), body)) == {(16, 16)}
    with pytest.raises(ValueError, match="expected"):
        tsw.state_from_jax([a[:-1] for a in arrays], cfg, device="cpu")


def test_make_solver_on_a_grid():
    # make_solver on a 2x1 grid: its timing contract, and the same h as
    # the one-rank make_solver over the same steps (1 + 2 + 2 x 2)
    cfg = _cfg(2)

    def solve(comm):
        run = tsw.make_solver(cfg, comm, num_multisteps=2, device="cpu")
        state, wall, steps = run(6.5 * cfg.dt)
        assert steps == 4 and wall > 0
        assert run.multistep.replays == 0  # the CPU runs eagerly
        return tsw.gather_global(state.h, comm, ghost=cfg.ghost).numpy()

    hs = _on_grid((2, 1), solve)
    np.testing.assert_array_equal(hs[0], hs[1])
    np.testing.assert_allclose(hs[0], solve(MeshComm()), rtol=0, atol=2e-4)
