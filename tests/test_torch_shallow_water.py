"""The PyTorch port's shallow-water model and driver against the JAX
package, on the CPU (the plain versions of the kernels):

* ``initial_state`` against ``make_init``: 1e-5 relative on h, 1e-6 on
  u and v (the geostrophic prefix sum and the mean run in another
  order, and exp/sin/cos differ by an ulp between the libraries);
* ``make_solver`` for a few chunks against ``make_multistep`` over the
  same number of steps: 2e-4;
* the narrow (ghost-1) schedule, the default: the initial state, the
  Euler step and AB2 steps against the JAX ``shallow_water_step`` at
  ghost 1 from the same state (1e-6 on h, u, v and 1e-4 on the
  tendencies after the Euler step, 2e-4 after the AB2 steps, as the
  ghost-2 step tests), the solver against ``make_multistep`` (2e-4), and
  ghost 1 against ghost 2 to rounding (atol 1e-3, as
  tests/test_shallow_water.py holds the JAX schedules);
* ``gather_global``, the state conversions, the example entry point,
  and that entry points never fall back to the CPU on their own.

Relative tolerances are taken against each field's largest magnitude,
as in research/test_sw_step_pallas.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import shallow_water as jsw

from mpi4jax_tpu_torch.examples import shallow_water as demo
from mpi4jax_tpu_torch.models import shallow_water as tsw
from mpi4jax_tpu_torch.parallel.comm import MeshComm

torch.set_num_threads(1)

FIELDS = ["h", "u", "v", "dh", "du", "dv"]


def _jax_comm():
    mesh = jax.make_mesh(
        (1, 1), ("y", "x"), axis_types=(jax.sharding.AxisType.Auto,) * 2
    )
    return mj.MeshComm.from_mesh(mesh)


def _assert_rel_close(expected, actual, tol, what):
    expected, actual = np.asarray(expected), np.asarray(actual)
    assert expected.shape == actual.shape, what
    scale = max(float(np.abs(expected).max()), 1e-30)
    assert np.allclose(actual, expected, rtol=tol, atol=tol * scale), (
        what, float(np.abs(expected - actual).max()), scale,
    )


@pytest.fixture(scope="module")
def init_pair():
    jcfg = jsw.SWConfig(ny=40, nx=32, ghost=2)
    expected = jsw.make_init(jcfg, _jax_comm())()
    cfg = tsw.config_from_jax(dataclasses.asdict(jcfg))
    actual = tsw.make_init(cfg, MeshComm(), device="cpu")()
    return expected, tsw.state_to_numpy(tsw.crop_state(actual))


@pytest.mark.parametrize("name,tol", [("h", 1e-5), ("u", 1e-6), ("v", 1e-6)])
def test_initial_state_matches_jax(init_pair, name, tol):
    expected, actual = init_pair
    i = FIELDS.index(name)
    _assert_rel_close(expected[i], actual[i], tol, name)


def test_initial_state_layout(init_pair):
    expected, actual = init_pair
    for name, e, a in zip(FIELDS[3:], expected[3:], actual[3:]):
        assert e.shape == a.shape == (40, 32), name
        assert not a.any(), name


@pytest.fixture(scope="module")
def solver_pair():
    """The port's solver over 2 timed chunks of 5 steps after the
    bootstrap step and the warm-up chunk (16 steps), and the JAX model
    over the same 16 steps."""
    jcfg = jsw.SWConfig(ny=24, nx=48, ghost=2)
    jcomm = _jax_comm()
    state = jsw.make_first_step(jcfg, jcomm)(jsw.make_init(jcfg, jcomm)())
    expected = jsw.make_multistep(jcfg, jcomm, 15)(state)

    cfg = tsw.config_from_jax(dataclasses.asdict(jcfg))
    chunks = []
    solve = tsw.make_solver(cfg, MeshComm(), num_multisteps=5,
                            on_chunk=lambda s, t: chunks.append(t),
                            device="cpu")
    actual, wall, steps = solve(13.5 * cfg.dt)
    return expected, actual, wall, steps, chunks, cfg


@pytest.mark.parametrize("name", FIELDS)
def test_solver_matches_jax_multistep(solver_pair, name):
    expected, actual, *_ = solver_pair
    i = FIELDS.index(name)
    e = np.asarray(expected[i])
    a = tsw.state_to_numpy(tsw.crop_state(actual))[i]
    if name in ("h", "u", "v"):
        e, a = e[2:-2, 2:-2], a[2:-2, 2:-2]
    if name == "dv":
        # computed from h's wall ghost rows, which the two layouts treat
        # differently; never reaches v (research/test_sw_step_pallas.py)
        e, a = e[:-1], a[:-1]
    _assert_rel_close(e, a, 2e-4, name)


def test_solver_timing_contract(solver_pair):
    _, actual, wall, steps, chunks, cfg = solver_pair
    assert steps == 10 and wall > 0
    # warm-up chunk plus the two timed ones, at model times 6, 11, 16 dt
    np.testing.assert_allclose(chunks, [6 * cfg.dt, 11 * cfg.dt, 16 * cfg.dt])
    h = actual.h[2:-2, 2:-2]
    assert torch.isfinite(h).all()
    np.testing.assert_allclose(float(h.double().mean()), cfg.depth, rtol=1e-5)


def test_gather_global_matches_jax(solver_pair):
    expected, actual, *_ = solver_pair
    jcomm = _jax_comm()
    g = jax.jit(
        jax.shard_map(
            lambda h: jsw.gather_global(h, jcomm, ghost=2)[None],
            mesh=jcomm.mesh, in_specs=(jax.P(),),
            out_specs=jax.P(("y", "x"), None, None), check_vma=False,
        )
    )(expected.h)
    gathered = tsw.gather_global(actual.h, MeshComm(), ghost=2)
    assert tuple(gathered.shape) == (24, 48)
    _assert_rel_close(np.asarray(g)[0], gathered.numpy(), 2e-4, "h")


def test_state_conversions_round_trip():
    cfg = tsw.SWConfig(ny=6, nx=8, ghost=2)
    rng = np.random.default_rng(0)
    full = [rng.standard_normal((10, 12)).astype(np.float32)
            for _ in range(3)]
    tend = [rng.standard_normal((6, 8)).astype(np.float32) for _ in range(3)]
    state = tsw.state_from_jax(full + tend, cfg, device="cpu")
    back = tsw.state_to_numpy(state)
    for a, b in zip(full, back[:3]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tend, back[3:]):
        assert b.shape == (10, 12) and not b[:2].any() and not b[:, -2:].any()
        np.testing.assert_array_equal(a, b[2:-2, 2:-2])
    cropped = tsw.state_to_numpy(tsw.crop_state(state))
    for a, b in zip(tend, cropped[3:]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="expected"):
        tsw.state_from_jax(full + [t[:-1] for t in tend], cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown SWConfig fields"):
        tsw.config_from_jax({"ny": 4, "mesh": (1, 1)})


def test_example_check_runs_on_cpu():
    rate = demo.main(["--check", "--days", "0.005", "--multistep", "5",
                      "--device", "cpu"])
    assert rate > 0


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsw.SWConfig(ny=8, nx=8)
    comm = MeshComm()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsw.make_init(cfg, comm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsw.make_solver(cfg, comm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsw.initial_state(cfg, comm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(["--check"])
    zeros = [np.zeros((12, 12), np.float32)] * 6
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsw.state_from_jax(zeros, cfg)


def test_default_config_matches_jax():
    assert dataclasses.asdict(tsw.SWConfig()) == dataclasses.asdict(
        jsw.SWConfig())
    assert tsw.SWConfig().ghost == 1
    assert tsw.SWConfig().bench_size() == tsw.config_from_jax(
        dataclasses.asdict(jsw.SWConfig().bench_size()))


@pytest.fixture(scope="module")
def narrow_steps():
    """The JAX ghost-1 initial state (ny=40, nx=32, as ``init_pair``),
    then one Euler step and three AB2 steps, in the JAX package and in
    the port from the same state."""
    jcfg = jsw.SWConfig(ny=40, nx=32)
    jcomm = _jax_comm()
    s0 = jsw.make_init(jcfg, jcomm)()
    j_first = jsw.make_first_step(jcfg, jcomm)(s0)
    j_multi = jsw.make_multistep(jcfg, jcomm, 3)(j_first)

    cfg = tsw.config_from_jax(dataclasses.asdict(jcfg))
    comm = MeshComm()
    init = tsw.make_init(cfg, comm, device="cpu")()
    state0 = tsw.state_from_jax([np.asarray(a) for a in s0], cfg,
                                device="cpu")
    p_first = tsw.make_first_step(cfg, comm)(state0)
    p_multi = tsw.make_multistep(cfg, comm, 3)(
        tsw.SWState(*(t.clone() for t in p_first)))
    return {
        "jax_init": [np.asarray(a) for a in s0],
        "port_init": tsw.state_to_numpy(init),
        "jax_first": [np.asarray(a) for a in j_first],
        "port_first": tsw.state_to_numpy(p_first),
        "jax_multi": [np.asarray(a) for a in j_multi],
        "port_multi": tsw.state_to_numpy(p_multi),
    }


@pytest.mark.parametrize("name", FIELDS)
def test_narrow_initial_state_matches_jax(narrow_steps, name):
    i = FIELDS.index(name)
    tol = {"h": 1e-5, "u": 1e-6, "v": 1e-6}.get(name)
    if tol is None:  # full-shaped zero tendencies in both
        assert narrow_steps["port_init"][i].shape == (42, 34)
        assert not narrow_steps["port_init"][i].any()
        assert not narrow_steps["jax_init"][i].any()
        return
    _assert_rel_close(narrow_steps["jax_init"][i],
                      narrow_steps["port_init"][i], tol, name)


@pytest.mark.parametrize("name", FIELDS)
def test_narrow_first_step_matches_jax(narrow_steps, name):
    i = FIELDS.index(name)
    tol = 1e-4 if name.startswith("d") else 1e-6
    _assert_rel_close(narrow_steps["jax_first"][i],
                      narrow_steps["port_first"][i], tol, name)


@pytest.mark.parametrize("name", FIELDS)
def test_narrow_multistep_matches_jax(narrow_steps, name):
    i = FIELDS.index(name)
    _assert_rel_close(narrow_steps["jax_multi"][i],
                      narrow_steps["port_multi"][i], 2e-4, name)


@pytest.fixture(scope="module")
def narrow_solver_pair():
    """The port's solver at the default ghost 1 over 2 timed chunks of 5
    steps after the bootstrap and warm-up (16 steps), and the JAX model
    over the same 16 steps, as ``solver_pair`` at ghost 2."""
    jcfg = jsw.SWConfig(ny=24, nx=48)
    jcomm = _jax_comm()
    state = jsw.make_first_step(jcfg, jcomm)(jsw.make_init(jcfg, jcomm)())
    expected = jsw.make_multistep(jcfg, jcomm, 15)(state)
    cfg = tsw.config_from_jax(dataclasses.asdict(jcfg))
    solve = tsw.make_solver(cfg, MeshComm(), num_multisteps=5,
                            device="cpu")
    actual, _, steps = solve(13.5 * cfg.dt)
    assert steps == 10
    return expected, actual


@pytest.mark.parametrize("name", FIELDS)
def test_narrow_solver_matches_jax_multistep(narrow_solver_pair, name):
    expected, actual = narrow_solver_pair
    i = FIELDS.index(name)
    _assert_rel_close(np.asarray(expected[i]),
                      tsw.state_to_numpy(actual)[i], 2e-4, name)


def test_narrow_equals_wide():
    # the two schedules compute the same arithmetic, one communicating
    # what the other recomputes in its wider ring: equal to rounding
    comm = MeshComm()
    h = {}
    for ghost in (1, 2):
        cfg = tsw.SWConfig(ny=24, nx=48, ghost=ghost)
        state = tsw.make_first_step(cfg, comm)(
            tsw.make_init(cfg, comm, device="cpu")())
        state = tsw.make_multistep(cfg, comm, 15)(state)
        h[ghost] = tsw.gather_global(state.h, comm, ghost=ghost).numpy()
    assert h[1].shape == h[2].shape == (24, 48)
    np.testing.assert_allclose(h[2], h[1], rtol=0, atol=1e-3)


def test_unported_ghost_widths_raise():
    comm = MeshComm()
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        tsw.make_multistep(tsw.SWConfig(ny=8, nx=8, ghost=4), comm, 1)
    with pytest.raises(ValueError, match="ghost width"):
        tsw.make_init(tsw.SWConfig(ny=8, nx=8, ghost=3), comm,
                      device="cpu")
