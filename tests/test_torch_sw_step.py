"""The PyTorch port's shallow-water step against the JAX package.

The port's step on CPU tensors runs the plain versions of its two CUDA
kernels (``sw_main_reference``, ``sw_visc_reference``).  They are held
at ny=40, nx=32 on a one-rank grid against

* the Pallas kernels they port (``research/sw_step_pallas.py``, run in
  interpret mode): the first (Euler) step to 1e-6 of each field's
  largest magnitude on h/u/v and 1e-4 on the tendencies, whose values
  are small differences of large fluxes; three AB2 steps to 2e-4;
* the JAX package's XLA wide-halo step (``_step_wide``) through
  ``crop_state``, with the same tolerances.  The ghost rings are left
  out there (the XLA path does not clamp h's wall ghost rows), and so
  is dv's north-wall row, which is computed from those ghost rows and
  never reaches v (see research/test_sw_step_pallas.py).

The state starts from the JAX initial state, so the step is compared
alone.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import shallow_water as jsw

from mpi4jax_tpu_torch.kernels import sw_step
from mpi4jax_tpu_torch.models import shallow_water as tsw
from mpi4jax_tpu_torch.parallel.comm import MeshComm

torch.set_num_threads(1)

FIELDS = ["h", "u", "v", "dh", "du", "dv"]
N_AB2 = 3


def _load_pallas_step():
    path = (pathlib.Path(__file__).resolve().parent.parent / "research"
            / "sw_step_pallas.py")
    spec = importlib.util.spec_from_file_location("sw_step_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_rel_close(expected, actual, tol, what):
    expected, actual = np.asarray(expected), np.asarray(actual)
    assert expected.shape == actual.shape, what
    scale = max(float(np.abs(expected).max()), 1e-30)
    err = float(np.abs(expected - actual).max())
    assert np.allclose(actual, expected, rtol=tol, atol=tol * scale), (
        what, err, scale,
    )


@pytest.fixture(scope="module")
def runs():
    """One set of JAX and port runs shared by the comparisons below."""
    jcfg = jsw.SWConfig(ny=40, nx=32, ghost=2)
    mesh = jax.make_mesh(
        (1, 1), ("y", "x"), axis_types=(jax.sharding.AxisType.Auto,) * 2
    )
    jcomm = mj.MeshComm.from_mesh(mesh)
    swp = _load_pallas_step()

    s0 = jsw.make_init(jcfg, jcomm)()
    wide_first = jsw.make_first_step(jcfg, jcomm)(s0)
    wide_multi = jsw.make_multistep(jcfg, jcomm, N_AB2)(wide_first)
    pallas_first = swp.make_first_step_pallas(
        jcfg, jcomm, block_rows=16, interpret=True
    )(s0)
    pallas_multi = swp.make_multistep_pallas(
        jcfg, jcomm, N_AB2, block_rows=16, interpret=True
    )(pallas_first)

    cfg = tsw.config_from_jax(dataclasses.asdict(jcfg))
    comm = MeshComm()
    state0 = tsw.state_from_jax([np.asarray(a) for a in s0], cfg,
                                device="cpu")
    port_first = tsw.make_first_step(cfg, comm)(state0)
    port_multi = tsw.make_multistep(cfg, comm, N_AB2)(
        tsw.SWState(*(t.clone() for t in port_first))
    )

    def numpy_state(s):
        return [np.asarray(a) for a in s]

    return {
        "wide_first": numpy_state(wide_first),
        "wide_multi": numpy_state(wide_multi),
        "pallas_first": numpy_state(pallas_first),
        "pallas_multi": numpy_state(pallas_multi),
        "port_first": tsw.state_to_numpy(port_first),
        "port_multi": tsw.state_to_numpy(port_multi),
        "port_multi_crop": tsw.state_to_numpy(tsw.crop_state(port_multi)),
        "port_first_crop": tsw.state_to_numpy(tsw.crop_state(port_first)),
    }


def _first_tol(name):
    return 1e-4 if name.startswith("d") else 1e-6


@pytest.mark.parametrize("name", FIELDS)
def test_first_step_matches_pallas(runs, name):
    i = FIELDS.index(name)
    _assert_rel_close(runs["pallas_first"][i], runs["port_first"][i],
                      _first_tol(name), name)


@pytest.mark.parametrize("name", FIELDS)
def test_ab2_steps_match_pallas(runs, name):
    i = FIELDS.index(name)
    _assert_rel_close(runs["pallas_multi"][i], runs["port_multi"][i], 2e-4,
                      name)


def _interior(name, a):
    """Interior of a prognostic field; tendencies are already cropped.
    dv loses its north-wall row."""
    if name in ("h", "u", "v"):
        a = a[2:-2, 2:-2]
    if name == "dv":
        a = a[:-1]
    return a


@pytest.mark.parametrize("name", FIELDS)
def test_first_step_matches_step_wide(runs, name):
    i = FIELDS.index(name)
    _assert_rel_close(
        _interior(name, runs["wide_first"][i]),
        _interior(name, runs["port_first_crop"][i]),
        _first_tol(name), name,
    )


@pytest.mark.parametrize("name", FIELDS)
def test_ab2_steps_match_step_wide(runs, name):
    i = FIELDS.index(name)
    _assert_rel_close(
        _interior(name, runs["wide_multi"][i]),
        _interior(name, runs["port_multi_crop"][i]),
        2e-4, name,
    )


def _random_fields(seed, ny_l=12, nx_l=10):
    rng = np.random.default_rng(seed)
    shape = (ny_l + 4, nx_l + 4)
    h = 100.0 + rng.standard_normal(shape)
    rest = [rng.standard_normal(shape) for _ in range(5)]
    return [torch.tensor(a, dtype=torch.float32) for a in (h, *rest)]


@pytest.mark.parametrize("walls", [(True, True), (True, False), (False, True),
                                   (False, False)],
                         ids=["both", "south", "north", "none"])
@pytest.mark.parametrize("first_step", [True, False])
def test_cpu_wrappers_run_plain_versions(walls, first_step):
    # on CPU tensors the wrappers are the plain versions and launch no
    # kernel; ghost cells pass through and tendencies are zero there
    cfg = tsw.SWConfig(ny=12, nx=10)
    is_south, is_north = walls
    fields = _random_fields(7)
    sw_step.reset_launch_counts()
    geometry = dict(cfg=cfg, ny_l=12, nx_l=10, is_south=is_south,
                    is_north=is_north)
    out = sw_step.sw_main(*fields, iy=0, first_step=first_step, **geometry)
    ref = sw_step.sw_main_reference(*fields, iy=0, first_step=first_step,
                                    **geometry)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    uv = sw_step.sw_visc(fields[1], fields[2], **geometry)
    uv_ref = sw_step.sw_visc_reference(fields[1], fields[2], **geometry)
    for o, r in zip(uv, uv_ref):
        assert torch.equal(o, r)
    assert sw_step.sw_main.launches == 0 and sw_step.sw_visc.launches == 0

    h, u, v, dh, du, dv = out
    ring = torch.ones_like(h, dtype=torch.bool)
    ring[2:-2, 2:-2] = False
    if is_north:
        assert torch.all(v[12 + 1] == 0) and torch.all(uv[1][12 + 1] == 0)
        ring[12 + 1] = False  # v's north-wall row is zeroed, not passed
    for t in (dh, du, dv):
        assert torch.all(t[ring] == 0)
    assert torch.equal(h[ring], fields[0][ring])
    assert torch.equal(v[ring], fields[2][ring])
    assert torch.equal(uv[0][ring], fields[1][ring])


def test_step_rejects_unported_schedules():
    # the wide-halo (ghost 2) and single-exchange (ghost 4) schedules
    # need periodic x, as in the JAX package, while the narrow one
    # (ghost 1, the default) takes either; every width the JAX package
    # takes is ported
    comm = MeshComm()
    for ghost in (2, 4):
        with pytest.raises(NotImplementedError, match="periodic_x"):
            tsw.make_multistep(tsw.SWConfig(ny=8, nx=8, ghost=ghost,
                                            periodic_x=False), comm, 1)
        tsw.make_first_step(tsw.SWConfig(ny=8, nx=8, ghost=ghost), comm)
    for periodic_x in (True, False):
        tsw.make_first_step(
            tsw.SWConfig(ny=8, nx=8, periodic_x=periodic_x), comm)
