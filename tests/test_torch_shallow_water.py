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
* the single-exchange (ghost-4) schedule against the JAX
  ``_step_wide4`` at the ghost-1 tolerances, on two grids, against
  ghost 1 to atol 1e-3, and its helpers (``gather_global``,
  ``state_from_jax`` at G = 4);
* bfloat16: the grid equal to JAX's bit for bit at ghost 1, 2 and 4 at
  the benchmark's widths, and the initial state and the first and AB2
  steps within one bf16 step of each field's largest magnitude
  (``top_steps``; the readings are 0 but for elements below 1e-30 of
  it, where exp's tail rounds another way);
* the schedule errors, with the JAX package's messages;
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


def _jax_error(jcfg):
    """The exception the JAX package raises for ``jcfg`` (built, then
    stepped once), or None."""
    jcomm = _jax_comm()
    try:
        jsw.make_multistep(jcfg, jcomm, 1)(jsw.make_init(jcfg, jcomm)())
    except (ValueError, NotImplementedError) as exc:
        return exc
    return None


@pytest.mark.parametrize("kw", [
    dict(ny=8, nx=8, ghost=3),
    dict(ny=8, nx=8, ghost=4, periodic_x=False),
    dict(ny=3, nx=3, ghost=4),
], ids=["ghost3", "ghost4_not_periodic", "ghost4_block_3x3"])
def test_unported_ghost_widths_raise(kw):
    # every ghost width the JAX package takes is ported; what it refuses,
    # the port refuses with its exception type and message
    expected = _jax_error(jsw.SWConfig(**kw))
    assert expected is not None
    comm = MeshComm()
    cfg = tsw.SWConfig(**kw)
    for build in (lambda: tsw.make_init(cfg, comm, device="cpu"),
                  lambda: tsw.make_first_step(cfg, comm),
                  lambda: tsw.make_multistep(cfg, comm, 1)):
        with pytest.raises(type(expected)) as info:
            build()
        assert str(info.value) == str(expected)


# -- the single-exchange (ghost-4) schedule --------------------------------

WIDE4_GRIDS = {"wide4_24x48": (24, 48), "wide4_40x32": (40, 32)}


def _steps_pair(jcfg):
    """The JAX initial state, one Euler step and three AB2 steps, and the
    port's from the same JAX state (and its own initial state)."""
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

    def jax_full(s):
        return tsw.state_to_numpy(tsw.state_from_jax(
            [np.asarray(a) for a in s], cfg, device="cpu"))

    return {
        "jax_init": jax_full(s0), "port_init": tsw.state_to_numpy(init),
        "jax_first": jax_full(j_first),
        "port_first": tsw.state_to_numpy(p_first),
        "jax_multi": jax_full(j_multi),
        "port_multi": tsw.state_to_numpy(p_multi),
    }


@pytest.fixture(scope="module", params=sorted(WIDE4_GRIDS))
def wide4_steps(request):
    ny, nx = WIDE4_GRIDS[request.param]
    return _steps_pair(jsw.SWConfig(ny=ny, nx=nx, ghost=4))


@pytest.mark.parametrize("name", FIELDS)
def test_wide4_initial_state_matches_jax(wide4_steps, name):
    i = FIELDS.index(name)
    tol = {"h": 1e-5, "u": 1e-6, "v": 1e-6}.get(name)
    port, jax_ = wide4_steps["port_init"][i], wide4_steps["jax_init"][i]
    if tol is None:  # full-shaped zero tendencies in both
        assert port.shape == jax_.shape == wide4_steps["port_init"][0].shape
        assert not port.any() and not jax_.any()
        return
    _assert_rel_close(jax_, port, tol, name)


# v after the Euler step is dt * dv (v starts at 0), a small difference
# of large terms (geostrophic balance).  XLA on the CPU fuses multiply-
# adds and divides by a constant as a product with its reciprocal, which
# PyTorch does not; at 24x48 that moves v by 1.72e-6 of max|v| (this
# comparison's reading with a 1e-6 limit), so v is held to 2e-6, h and u
# to the ghost-1 tests' 1e-6.
WIDE4_FIRST_TOL = {"h": 1e-6, "u": 1e-6, "v": 2e-6}


@pytest.mark.parametrize("name", FIELDS)
def test_wide4_first_step_matches_jax(wide4_steps, name):
    i = FIELDS.index(name)
    tol = WIDE4_FIRST_TOL.get(name, 1e-4)
    _assert_rel_close(wide4_steps["jax_first"][i],
                      wide4_steps["port_first"][i], tol, name)


@pytest.mark.parametrize("name", FIELDS)
def test_wide4_multistep_matches_jax(wide4_steps, name):
    i = FIELDS.index(name)
    _assert_rel_close(wide4_steps["jax_multi"][i],
                      wide4_steps["port_multi"][i], 2e-4, name)


def test_wide4_equals_narrow():
    # as tests/test_shallow_water.py holds the JAX schedules: the same
    # arithmetic, communicated or recomputed, equal to rounding
    comm = MeshComm()
    h = {}
    for ghost in (1, 4):
        cfg = tsw.SWConfig(ny=24, nx=48, ghost=ghost)
        state = tsw.make_first_step(cfg, comm)(
            tsw.make_init(cfg, comm, device="cpu")())
        state = tsw.make_multistep(cfg, comm, 15)(state)
        h[ghost] = tsw.gather_global(state.h, comm, ghost=ghost).numpy()
    assert h[1].shape == h[4].shape == (24, 48)
    np.testing.assert_allclose(h[4], h[1], rtol=0, atol=1e-3)


def test_wide4_gather_global_matches_jax(wide4_steps):
    jcomm = _jax_comm()
    h = wide4_steps["jax_multi"][0]
    g = jax.jit(
        jax.shard_map(
            lambda a: jsw.gather_global(a, jcomm, ghost=4)[None],
            mesh=jcomm.mesh, in_specs=(jax.P(),),
            out_specs=jax.P(("y", "x"), None, None), check_vma=False,
        )
    )(h)
    gathered = tsw.gather_global(torch.tensor(h), MeshComm(), ghost=4)
    np.testing.assert_array_equal(np.asarray(g)[0], gathered.numpy())
    assert gathered.shape == (h.shape[0] - 8, h.shape[1] - 8)


def test_state_from_jax_at_ghost4():
    # the single-exchange layout: full-shaped tendencies, taken as they
    # are; interior-shaped ones lifted onto a zero ring of width 4
    cfg = tsw.SWConfig(ny=6, nx=8, ghost=4)
    rng = np.random.default_rng(4)
    full = [rng.standard_normal((14, 16)).astype(np.float32)
            for _ in range(6)]
    back = tsw.state_to_numpy(tsw.state_from_jax(full, cfg, device="cpu"))
    for a, b in zip(full, back):
        np.testing.assert_array_equal(a, b)
    tend = [rng.standard_normal((6, 8)).astype(np.float32) for _ in range(3)]
    lifted = tsw.state_to_numpy(
        tsw.state_from_jax(full[:3] + tend, cfg, device="cpu"))
    for a, b in zip(tend, lifted[3:]):
        assert b.shape == (14, 16)
        np.testing.assert_array_equal(a, b[4:-4, 4:-4])
        b[4:-4, 4:-4] = 0
        assert not b.any()
    cropped = tsw.state_to_numpy(tsw.crop_state(
        tsw.state_from_jax(full[:3] + tend, cfg, device="cpu"), ghost=4))
    for a, b in zip(tend, cropped[3:]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="expected"):
        tsw.state_from_jax([f[:-1] for f in full], cfg, device="cpu")


# -- bfloat16 ---------------------------------------------------------------


def _top_steps(expected, actual):
    """max |actual - expected| in bf16 steps of max|expected| (a value in
    [2^(e-1), 2^e) has a step of 2^(e-8)): ``chip_smoke.py``'s
    ``top_steps``."""
    expected = np.asarray(expected, np.float64)
    diff = np.abs(np.asarray(actual, np.float64) - expected).max()
    scale = np.abs(expected).max()
    if scale == 0:
        return float(diff)
    return float(diff / 2.0 ** (np.frexp(scale)[1] - 8))


BF16_STEPS = 1.0


@pytest.mark.parametrize("ghost", [1, 2, 4])
def test_bf16_grid_matches_jax_bit_for_bit(ghost):
    # the benchmark's widths (n + 2G = 1802..3608), where torch's own
    # bfloat16 arange differs from JAX's iota-then-add in hundreds of
    # values
    jcfg = jsw.SWConfig(dtype="bfloat16", ghost=ghost).bench_size()
    jcfg = dataclasses.replace(jcfg, ghost=ghost)
    jcomm = _jax_comm()
    yy, xx = jax.jit(
        jax.shard_map(
            lambda: tuple(jsw._local_mesh_coords(jcfg, jcomm)),
            mesh=jcomm.mesh, in_specs=(), out_specs=(jax.P(), jax.P()),
            check_vma=False,
        )
    )()
    cfg = tsw.config_from_jax(dataclasses.asdict(jcfg))
    tyy, txx = tsw._local_mesh_coords(cfg, MeshComm(), torch.device("cpu"))
    assert tyy.dtype == torch.bfloat16
    for j, t in ((yy, tyy), (xx, txx)):
        np.testing.assert_array_equal(np.asarray(j, np.float32),
                                      t.float().numpy())


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda g: f"ghost{g}")
def bf16_steps(request):
    return _steps_pair(
        jsw.SWConfig(ny=40, nx=32, ghost=request.param, dtype="bfloat16"))


def test_bf16_initial_state_matches_jax(bf16_steps):
    port, jax_ = bf16_steps["port_init"], bf16_steps["jax_init"]
    assert all(a.dtype == np.float32 for a in port)  # widened bf16
    # h and v equal bit for bit; u where exp's tail (below 1e-30 of
    # max|u|) rounds alike
    np.testing.assert_array_equal(jax_[0], port[0])
    np.testing.assert_array_equal(jax_[2], port[2])
    assert _top_steps(jax_[1], port[1]) <= BF16_STEPS
    for t in port[3:]:
        assert t.shape == port[0].shape and not t.any()


@pytest.mark.parametrize("stage", ["first", "multi"])
@pytest.mark.parametrize("name", FIELDS)
def test_bf16_steps_match_jax(bf16_steps, stage, name):
    i = FIELDS.index(name)
    steps = _top_steps(bf16_steps[f"jax_{stage}"][i],
                       bf16_steps[f"port_{stage}"][i])
    assert steps <= BF16_STEPS, (name, stage, steps)


def test_bf16_state_stays_bf16():
    comm = MeshComm()
    for ghost in (1, 2, 4):
        cfg = tsw.SWConfig(ny=8, nx=16, ghost=ghost, dtype="bfloat16")
        state = tsw.make_multistep(cfg, comm, 2)(tsw.make_first_step(
            cfg, comm)(tsw.make_init(cfg, comm, device="cpu")()))
        assert all(t.dtype == torch.bfloat16 for t in state)
        assert all(torch.isfinite(t).all() for t in state)


def test_bf16_ghost2_on_the_card_raises_when_built(monkeypatch):
    # the kernels compute float32: ghost 2 in another dtype on the card
    # raises when the solver is built, naming the schedules that run it;
    # no fallback to the plain path
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    comm = MeshComm()
    cfg = tsw.SWConfig(ny=8, nx=16, ghost=2, dtype="bfloat16")
    for build in (lambda: tsw.make_init(cfg, comm),
                  lambda: tsw.make_solver(cfg, comm)):
        with pytest.raises(ValueError, match="ghost 1 and ghost 4"):
            build()
    for ghost in (1, 4):
        tsw.make_init(dataclasses.replace(cfg, ghost=ghost), comm)
    with pytest.raises(ValueError, match="dtype must be one of"):
        tsw.make_init(dataclasses.replace(cfg, dtype="int32"), comm,
                      device="cpu")
