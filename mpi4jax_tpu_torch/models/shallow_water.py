"""Flagship workload: the nonlinear shallow-water solver on PyTorch.

Counterpart of ``mpi4jax_tpu/models/shallow_water.py``: the same C-grid
model (Sadourny 1975 energy-conserving potential-vorticity scheme,
Adams-Bashforth-2 stepping with coefficients (1.6, -0.6), periodic x,
solid walls in y, lateral viscosity), the same configuration object and
the same driver functions.

The port runs the JAX package's three schedules, on one rank or on each
rank's block of a ``("y", "x")`` grid of ranks (``parallel/distributed.py``;
each rank computes its own walls), chosen by ``cfg.ghost``:

* ``ghost=1`` (the default, as in the JAX package): the reference's
  narrow schedule, about 12 one-cell halo exchanges per step, in plain
  PyTorch (the JAX package has no Pallas kernel for it either);
* ``ghost=2`` (``bench_size()``): the wide-halo schedule (periodic x),
  in the order of the fused Pallas step
  (``research/sw_step_pallas.py:_step``):

  1. exchange the 2-deep halos of h, u, v;
  2. clamp h's wall ghost rows to the adjacent interior row (hc == h);
  3. the ``sw_main`` kernel: all tendencies and the AB2 update;
  4. exchange u, v;
  5. the ``sw_visc`` kernel: lateral viscosity.

  Fields on a CUDA device go through the hand-written kernels of
  ``kernels/sw_step.py``; fields on the CPU through their plain versions;
* ``ghost=4`` (periodic x): the single-exchange schedule, one batched
  4-deep exchange of (h, u, v) per step with everything else recomputed
  locally, in plain PyTorch (the JAX package has no kernel for it).

Every schedule computes in ``cfg.dtype`` ("float32", "bfloat16",
"float16" or "float64"), as the JAX package does, with the model's
constants rounded to that dtype first (JAX's weakly typed scalars).
The kernels compute float32 only, so ghost 2 on the card takes float32
alone and raises for another dtype when the solver is built.  The state
carries full-shaped tendencies at every ghost width (the Pallas layout;
:func:`crop_state` gives the JAX wide-halo layout).

``make_multistep`` stands for the JAX package's one XLA executable
(``jit`` around a ``fori_loop``): on the card it captures a chunk of
steps in a CUDA graph and replays it (one rank, or NCCL; a gloo world
runs the chunk eagerly); on the CPU it is a Python loop.
"""

import math
import pathlib
import time
from dataclasses import dataclass, fields, replace
from typing import NamedTuple

import numpy as np
import torch

from mpi4jax_tpu_torch.kernels.sw_step import (
    grid_coords,
    ring_view,
    scalars,
    sw_main,
    sw_visc,
)
from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops._core import as_token
from mpi4jax_tpu_torch.ops.allreduce import allreduce
from mpi4jax_tpu_torch.ops.collectives import allgather, scan
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.parallel.halo import (
    halo_exchange_2d,
    halo_exchange_2d_batch,
)
from mpi4jax_tpu_torch.utils.runtime import (
    drain,
    graph_capture,
    resolve_device,
    run_on_side_stream,
)

__all__ = [
    "SWConfig",
    "SWState",
    "initial_state",
    "shallow_water_step",
    "make_init",
    "make_first_step",
    "make_multistep",
    "make_solver",
    "gather_global",
    "pad_state",
    "crop_state",
    "config_from_jax",
    "state_from_jax",
    "state_to_numpy",
]

DAY_IN_SECONDS = 86_400.0
WIDE = 2  # the ghost width of the wide-halo schedule (the kernels')
SINGLE = 4  # the ghost width of the single-exchange schedule

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


@dataclass(frozen=True)
class SWConfig:
    """Static model configuration (the JAX package's ``SWConfig``)."""

    ny: int = 180  # global interior cells, y
    nx: int = 360  # global interior cells, x
    dx: float = 5e3  # metres
    dy: float = 5e3
    gravity: float = 9.81
    depth: float = 100.0
    coriolis_f: float = 2e-4
    coriolis_beta: float = 2e-11
    periodic_x: bool = True
    ab_a: float = 1.6  # Adams-Bashforth coefficients
    ab_b: float = -0.6
    dtype: str = "float32"
    # Ghost-ring width: 1 = the reference's narrow schedule, 2 = the
    # wide-halo schedule, 4 = the single-exchange schedule.
    ghost: int = 1

    @property
    def lateral_viscosity(self):
        return 1e-3 * self.coriolis_f * self.dx**2

    @property
    def dt(self):
        # CFL-limited gravity-wave time step
        return 0.125 * min(self.dx, self.dy) / math.sqrt(self.gravity * self.depth)

    @property
    def length_x(self):
        return self.nx * self.dx

    @property
    def length_y(self):
        return self.ny * self.dy

    def local_interior(self, comm):
        py, px = comm.axis_sizes
        if self.ny % py or self.nx % px:
            raise ValueError(
                f"grid {self.ny}x{self.nx} not divisible by mesh {py}x{px}"
            )
        return self.ny // py, self.nx // px

    def bench_size(self):
        """The published-benchmark domain: 3600x1800 interior cells on
        the wide-halo schedule."""
        return replace(self, ny=1800, nx=3600, ghost=2)


class SWState(NamedTuple):
    h: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    dh: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor


def _check_schedule(cfg, comm):
    """The JAX package's schedule errors, raised when a driver function
    is built (the JAX package raises them when it traces the step)."""
    if cfg.ghost not in (1, WIDE, SINGLE):
        raise ValueError(f"ghost width must be 1, 2 or 4, got {cfg.ghost}")
    if cfg.ghost == WIDE and not cfg.periodic_x:
        raise NotImplementedError(
            "wide-halo schedule currently requires periodic_x=True "
            "(x-boundary clamps are not implemented); use ghost=1"
        )
    if cfg.ghost == SINGLE:
        if not cfg.periodic_x:
            raise NotImplementedError(
                "single-exchange schedule requires periodic_x=True; use "
                "ghost=1"
            )
        ny_l, nx_l = cfg.local_interior(comm)
        if ny_l < SINGLE or nx_l < SINGLE:
            raise ValueError(
                f"ghost=4 needs local blocks >= 4x4, got {ny_l}x{nx_l}"
            )
    if cfg.dtype not in DTYPES:
        raise ValueError(
            f"dtype must be one of {sorted(DTYPES)}, got {cfg.dtype!r}"
        )


def _check_device(cfg, device):
    """Ghost 2 on the card runs the kernels, which compute float32."""
    if device.type == "cuda" and cfg.ghost == WIDE and cfg.dtype != "float32":
        raise ValueError(
            f"dtype={cfg.dtype!r} at ghost 2 on the card: the wide-halo "
            "schedule runs the sw_main and sw_visc kernels, which compute "
            "float32; ghost 1 and ghost 4 run that dtype on the card"
        )


def torch_dtype(cfg):
    """The torch dtype named by ``cfg.dtype``."""
    return DTYPES[cfg.dtype]


def _device_coords(comm):
    """(iy, ix) coordinates of this rank on the ("y", "x") comm."""
    return comm.coords_of(comm.rank())


def _local_mesh_coords(cfg, comm, device):
    """Physical coordinates of the local block, ghosts included, in
    ``cfg.dtype`` and rounded as the JAX package rounds them."""
    G = cfg.ghost
    ny_l, nx_l = cfg.local_interior(comm)
    iy, ix = _device_coords(comm)
    c = scalars(cfg, torch_dtype(cfg), device)
    y = grid_coords(ny_l, G, iy * ny_l, c.dy)
    x = grid_coords(nx_l, G, ix * nx_l, c.dx)
    return torch.meshgrid(y, x, indexing="ij")


def _coriolis(c, yy):
    return c.f + yy * c.beta


def _wall_masks(comm):
    """(is_north_edge, is_south_edge) for the solid-wall conditions."""
    py, _ = comm.axis_sizes
    iy, _ = _device_coords(comm)
    return iy == py - 1, iy == 0


def initial_state(cfg, comm, *, device="cuda", token=None):
    """Geostrophically balanced zonal jet plus a perturbation, built on
    this rank's block in ``cfg.dtype``; returns ``(SWState, token)``."""
    _check_schedule(cfg, comm)
    device = resolve_device(device)
    _check_device(cfg, device)
    token = as_token(token)
    G = cfg.ghost
    dtype = torch_dtype(cfg)
    c = scalars(cfg, dtype, device)

    def k(value):
        """A Python constant as JAX uses it: rounded to the dtype."""
        return torch.full((), value, dtype=dtype, device=device)

    yy, xx = _local_mesh_coords(cfg, comm, device)
    ly, lx = cfg.length_y, cfg.length_x

    u0 = k(10.0) * torch.exp(-((yy - k(0.5 * ly)) ** 2) / k((0.02 * lx) ** 2))
    v0 = torch.zeros_like(u0)

    # geostrophic balance h_y = -(f/g) u, integrated along global y: a
    # local cumsum plus the exclusive prefix of the blocks to the south
    integrand = -c.dy * u0 * _coriolis(c, yy) / c.g
    local_cum = torch.cumsum(integrand[G:-G, :], dim=0)
    local_total = local_cum[-1, :]
    incl, token = scan(local_total, reductions.SUM, comm=comm.sub("y"),
                       token=token)
    offset = incl - local_total
    interior = local_cum + offset[None, :]
    h_geo = torch.cat(
        [interior[:1].expand(G, -1), interior, interior[-1:].expand(G, -1)]
    )

    # centre around the mean depth
    local_sum = h_geo[G:-G, G:-G].sum()
    total, token = allreduce(local_sum, reductions.SUM, comm=comm, token=token)
    h_mean = total / k(float(cfg.ny * cfg.nx))

    h0 = (
        k(cfg.depth)
        + h_geo
        - h_mean
        + k(0.2)
        * torch.sin(xx / k(lx) * k(10.0) * k(math.pi))
        * torch.cos(yy / k(ly) * k(8.0) * k(math.pi))
    )

    per = (False, cfg.periodic_x)
    h0, token = halo_exchange_2d(h0, comm, periodic=per, token=token, width=G)
    u0, token = halo_exchange_2d(u0, comm, periodic=per, token=token, width=G)
    v0, token = halo_exchange_2d(v0, comm, periodic=per, token=token, width=G)

    zeros = [torch.zeros_like(h0) for _ in range(3)]
    return SWState(h0, u0, v0, *zeros), token


def clamp_wall_ghost_rows(h, comm, ny_l, ghost=WIDE):
    """Clamp ``h``'s wall-side ghost rows to the adjacent interior row,
    in place, so that the kernels can read ``hc == h``.

    The only consumer of h's true wall ghost rows is the pressure
    gradient of the wall-row ``v``, which the wall condition zeroes.
    """
    G = ghost
    is_north, is_south = _wall_masks(comm)
    if is_south:
        h[:G] = h[G : G + 1]
    if is_north:
        h[-G:] = h[ny_l + G - 1 : ny_l + G]
    return h


def shallow_water_step(state, cfg, comm, *, first_step=False, token=None):
    """One model step; returns ``(SWState, token)``.

    ``cfg.ghost == 1``: the reference's narrow schedule (:func:`_step_narrow`);
    ``cfg.ghost == 2``: the wide-halo schedule through the kernels
    (:func:`_step`); ``cfg.ghost == 4``: the single-exchange schedule
    (:func:`_step_wide4`).  Halo exchanges may write the ghost rings of
    the input's h, u, v in place; the step's results are new tensors.
    """
    _check_schedule(cfg, comm)
    _check_device(cfg, state.h.device)
    if cfg.ghost == 1:
        return _step_narrow(state, cfg, comm, first_step=first_step,
                            token=token)
    if cfg.ghost == SINGLE:
        return _step_wide4(state, cfg, comm, first_step=first_step,
                           token=token)
    return _step(state, cfg, comm, first_step=first_step, token=token,
                 main=sw_main, visc=sw_visc)


# finite-difference views of a (ny + 2, nx + 2) block: the interior and
# its east, west, north, south and north-east neighbours
def _i(a):
    return a[1:-1, 1:-1]


def _e(a):
    return a[1:-1, 2:]


def _w(a):
    return a[1:-1, :-2]


def _n(a):
    return a[2:, 1:-1]


def _s(a):
    return a[:-2, 1:-1]


def _ne(a):
    return a[2:, 2:]


def _with_interior(a, val):
    """A copy of ``a`` with its interior set to ``val``."""
    out = a.clone()
    out[1:-1, 1:-1] = val
    return out


def _step_narrow(state, cfg, comm, *, first_step, token):
    """The reference's narrow (ghost-1) schedule, term by term as
    ``mpi4jax_tpu/models/shallow_water.py:shallow_water_step`` computes
    it: every intermediate field (edge-padded h, the mass fluxes, the
    potential vorticity, the kinetic energy, the viscous fluxes) is built
    on a zero ring and exchanged, 12 one-cell exchanges per step."""
    token = as_token(token)
    per = (False, cfg.periodic_x)
    is_north, _ = _wall_masks(comm)
    h, u, v, dh, du, dv = state
    c = scalars(cfg, h.dtype, h.device)
    dx, dy, g = c.dx, c.dy, c.g

    def exchange(a):
        nonlocal token
        a, token = halo_exchange_2d(a, comm, periodic=per, token=token,
                                    width=1)
        return a

    def wall_v(a):
        """v = 0 on the northern wall row, in place."""
        if is_north:
            a[-2, :] = 0.0
        return a

    zeros = torch.zeros_like(h)

    # cell-centred height with edge-padded ghosts, then exchanged
    hc = h.clone()
    hc[0], hc[-1] = hc[1], hc[-2]
    hc[:, 0], hc[:, -1] = hc[:, 1], hc[:, -2]
    hc = exchange(hc)

    # mass fluxes on cell faces
    fe = exchange(_with_interior(zeros, 0.5 * (_i(hc) + _e(hc)) * _i(u)))
    fn = exchange(_with_interior(zeros, 0.5 * (_i(hc) + _n(hc)) * _i(v)))
    fn = wall_v(fn)
    dh_new = _with_interior(
        dh, -(_i(fe) - _w(fe)) / dx - (_i(fn) - _s(fn)) / dy
    )

    # potential vorticity (planetary + relative, over face-mean depth)
    yy, _ = _local_mesh_coords(cfg, comm, h.device)
    rel_vort = (_e(v) - _i(v)) / dx - (_n(u) - _i(u)) / dy
    q_int = (_coriolis(c, yy)[1:-1, 1:-1] + rel_vort) / (
        0.25 * (_i(hc) + _e(hc) + _n(hc) + _ne(hc))
    )
    q = exchange(_with_interior(zeros, q_int))

    # momentum tendencies: pressure gradient + PV flux (Sadourny 1975)
    du_new = _with_interior(
        du,
        -g * (_e(h) - _i(h)) / dx
        + 0.5
        * (
            _i(q) * 0.5 * (_i(fn) + _e(fn))
            + _s(q) * 0.5 * (_s(fn) + fn[:-2, 2:])
        ),
    )
    dv_new = _with_interior(
        dv,
        -g * (_n(h) - _i(h)) / dy
        - 0.5
        * (
            _i(q) * 0.5 * (_i(fe) + _n(fe))
            + _w(q) * 0.5 * (_w(fe) + fe[2:, :-2])
        ),
    )

    # kinetic energy gradient
    ke = exchange(_with_interior(
        zeros,
        0.5 * (0.5 * (_i(u) ** 2 + _w(u) ** 2)
               + 0.5 * (_i(v) ** 2 + _s(v) ** 2)),
    ))
    _i(du_new).add_(-(_e(ke) - _i(ke)) / dx)
    _i(dv_new).add_(-(_n(ke) - _i(ke)) / dy)

    # time step: forward Euler bootstrap, then AB2
    dt = c.dt
    if first_step:
        u = _with_interior(u, _i(u) + dt * _i(du_new))
        v = _with_interior(v, _i(v) + dt * _i(dv_new))
        h = _with_interior(h, _i(h) + dt * _i(dh_new))
    else:
        a, b = c.a, c.b
        u = _with_interior(u, _i(u) + dt * (a * _i(du_new) + b * _i(du)))
        v = _with_interior(v, _i(v) + dt * (a * _i(dv_new) + b * _i(dv)))
        h = _with_interior(h, _i(h) + dt * (a * _i(dh_new) + b * _i(dh)))
    h, u, v = exchange(h), exchange(u), exchange(v)
    v = wall_v(v)

    # lateral friction (the JAX package's form: v's branch reads v)
    nu = c.nu
    if cfg.lateral_viscosity > 0:
        for f in (u, v):
            gx = exchange(_with_interior(zeros, nu * (_e(f) - _i(f)) / dx))
            gy = exchange(_with_interior(zeros, nu * (_n(f) - _i(f)) / dy))
            _i(f).add_(
                dt * ((_i(gx) - _w(gx)) / dx + (_i(gy) - _s(gy)) / dy)
            )
        v = wall_v(v)

    return SWState(h, u, v, dh_new, du_new, dv_new), token


def _step(state, cfg, comm, *, first_step, token, main, visc):
    """The Pallas step schedule with the given ``main`` / ``visc``
    functions (the kernel wrappers, or their plain versions when a
    comparison runs the plain path on the card)."""
    G = WIDE
    token = as_token(token)
    per = (False, True)
    ny_l, nx_l = cfg.local_interior(comm)
    is_north, is_south = _wall_masks(comm)
    iy, _ = _device_coords(comm)
    h, u, v = state.h, state.u, state.v
    h, token = halo_exchange_2d(h, comm, periodic=per, token=token, width=G)
    u, token = halo_exchange_2d(u, comm, periodic=per, token=token, width=G)
    v, token = halo_exchange_2d(v, comm, periodic=per, token=token, width=G)
    h = clamp_wall_ghost_rows(h, comm, ny_l)
    geometry = dict(cfg=cfg, ny_l=ny_l, nx_l=nx_l, is_south=is_south,
                    is_north=is_north)
    h, u, v, dh, du, dv = main(
        h, u, v, state.dh, state.du, state.dv, iy=iy, first_step=first_step,
        **geometry,
    )
    if cfg.lateral_viscosity > 0:
        u, token = halo_exchange_2d(u, comm, periodic=per, token=token,
                                    width=G)
        v, token = halo_exchange_2d(v, comm, periodic=per, token=token,
                                    width=G)
        u, v = visc(u, v, **geometry)
    return SWState(h, u, v, dh, du, dv), token


def _step_wide4(state, cfg, comm, *, first_step, token):
    """The single-exchange (ghost-4) schedule, term by term as
    ``mpi4jax_tpu/models/shallow_water.py:_step_wide4`` computes it:

        exchange h, u, v (width 4, one batched exchange)
        ring 3: fluxes, potential vorticity, kinetic energy
        ring 2: tendencies, AB2 update of h, u, v
        ring 1: viscosity gradients of the locally updated u, v
        interior: viscosity divergence

    Tendencies are full-shaped and valid on ring 2; they are never
    exchanged.  JAX's ``jnp.where`` masks of the wall rows become
    assignments to the rows they select (a rank's walls are known on the
    host)."""
    G = SINGLE
    token = as_token(token)
    ny_l, _ = cfg.local_interior(comm)
    is_north, is_south = _wall_masks(comm)
    h, u, v, dh, du, dv = state
    c = scalars(cfg, h.dtype, h.device)
    dx, dy, g, dt = c.dx, c.dy, c.g, c.dt

    # --- the step's only exchange round ---
    (h, u, v), token = halo_exchange_2d_batch(
        [h, u, v], comm, periodic=(False, True), token=token, width=G
    )

    # cell-centred height: wall ghost rows clamped (edge-pad semantics)
    hc = clamp_wall_ghost_rows(h.clone(), comm, ny_l, ghost=G)

    def V(a, r, dyr=0, dxr=0, *, G=G):
        return ring_view(a, r, dyr, dxr, G=G)

    def zero_wall(a, ring, extra_north_interior=False):
        """Zero, in place, the rows of a ring-``ring`` field that lie
        beyond a wall (and the last interior row for the northern
        flux)."""
        if is_south:
            a[:ring] = 0.0
        if is_north:
            a[ny_l + ring:] = 0.0
            if extra_north_interior:
                a[ny_l + ring - 1] = 0.0
        return a

    # --- ring-3 intermediates, all local ---
    fe = 0.5 * (V(hc, 3) + V(hc, 3, 0, 1)) * V(u, 3)
    fn = 0.5 * (V(hc, 3) + V(hc, 3, 1, 0)) * V(v, 3)
    fe = zero_wall(fe, 3)
    fn = zero_wall(fn, 3, extra_north_interior=True)

    yy, _ = _local_mesh_coords(cfg, comm, h.device)
    rel_vort = (V(v, 3, 0, 1) - V(v, 3)) / dx - (V(u, 3, 1, 0) - V(u, 3)) / dy
    q = (_coriolis(c, V(yy, 3)) + rel_vort) / (
        0.25 * (V(hc, 3) + V(hc, 3, 0, 1) + V(hc, 3, 1, 0) + V(hc, 3, 1, 1))
    )
    q = zero_wall(q, 3)

    ke = 0.5 * (
        0.5 * (V(u, 3) ** 2 + V(u, 3, 0, -1) ** 2)
        + 0.5 * (V(v, 3) ** 2 + V(v, 3, -1, 0) ** 2)
    )
    ke = zero_wall(ke, 3)

    # --- ring-2 tendencies (ring-2 views of the ring-3 fields) ---
    def R2(a, dyr=0, dxr=0):
        return ring_view(a, 2, dyr, dxr, G=3)

    dh_new = -(R2(fe) - R2(fe, 0, -1)) / dx - (R2(fn) - R2(fn, -1, 0)) / dy
    du_new = -g * (V(h, 2, 0, 1) - V(h, 2)) / dx + 0.5 * (
        R2(q) * 0.5 * (R2(fn) + R2(fn, 0, 1))
        + R2(q, -1, 0) * 0.5 * (R2(fn, -1, 0) + R2(fn, -1, 1))
    )
    dv_new = -g * (V(h, 2, 1, 0) - V(h, 2)) / dy - 0.5 * (
        R2(q) * 0.5 * (R2(fe) + R2(fe, 1, 0))
        + R2(q, 0, -1) * 0.5 * (R2(fe, 0, -1) + R2(fe, 1, -1))
    )
    du_new = du_new - (R2(ke, 0, 1) - R2(ke)) / dx
    dv_new = dv_new - (R2(ke, 1, 0) - R2(ke)) / dy

    # --- AB2 update on ring 2 (wall ranks freeze the rows beyond it) ---
    if first_step:
        h2 = V(h, 2) + dt * dh_new
        u2 = V(u, 2) + dt * du_new
        v2 = V(v, 2) + dt * dv_new
    else:
        a, b = c.a, c.b
        h2 = V(h, 2) + dt * (a * dh_new + b * V(dh, 2))
        u2 = V(u, 2) + dt * (a * du_new + b * V(du, 2))
        v2 = V(v, 2) + dt * (a * dv_new + b * V(dv, 2))
    for new, old in ((h2, h), (u2, u), (v2, v)):
        if is_south:
            new[:2] = V(old, 2)[:2]
        if is_north:
            new[ny_l + 2:] = V(old, 2)[ny_l + 2:]

    def wall_v(a):
        """v = 0 on the northern wall row (the last interior row)."""
        if is_north:
            a[ny_l + 1] = 0.0
        return a

    v2 = wall_v(v2)

    # --- viscosity on the locally recomputed ring-2 velocities ---
    nu = c.nu
    if cfg.lateral_viscosity > 0:

        def visc_div(w2):
            gx = nu * (V(w2, 1, 0, 1, G=2) - V(w2, 1, G=2)) / dx
            gy = nu * (V(w2, 1, 1, 0, G=2) - V(w2, 1, G=2)) / dy
            gx = zero_wall(gx, 1)
            gy = zero_wall(gy, 1)
            return (V(gx, 0, G=1) - V(gx, 0, 0, -1, G=1)) / dx + (
                V(gy, 0, G=1) - V(gy, 0, -1, 0, G=1)
            ) / dy

        for w2 in (u2, v2):
            V(w2, 0, G=2).add_(dt * visc_div(w2))
        v2 = wall_v(v2)

    # --- one store per field ---
    out = []
    for full, ring2 in ((h, h2), (u, u2), (v, v2), (dh, dh_new),
                        (du, du_new), (dv, dv_new)):
        new = full.clone()
        V(new, 2).copy_(ring2)
        out.append(new)
    return SWState(*out), token


def pad_state(state):
    """Lift a state with interior-shaped tendencies (the JAX wide-halo
    layout) to full-shaped ones, the ghost width read from the shapes; a
    full-shaped state is returned as is."""
    if state.dh.shape == state.h.shape:
        return state
    G = (state.h.shape[0] - state.dh.shape[0]) // 2

    def lift(t):
        full = torch.zeros_like(state.h)
        full[G:-G, G:-G] = t
        return full

    return SWState(state.h, state.u, state.v, lift(state.dh),
                   lift(state.du), lift(state.dv))


def crop_state(state, ghost=WIDE):
    """Inverse of :func:`pad_state`: the tendencies cut to the interior
    of a ``ghost``-wide ring (the JAX wide-halo layout at ghost 2)."""
    G = ghost
    return SWState(
        state.h, state.u, state.v,
        state.dh[G:-G, G:-G], state.du[G:-G, G:-G], state.dv[G:-G, G:-G],
    )


def make_init(cfg, comm, *, device="cuda"):
    """Initial-condition builder: ``init() -> SWState`` on ``device``."""
    _check_schedule(cfg, comm)
    device = resolve_device(device)
    _check_device(cfg, device)

    def init():
        state, _tok = initial_state(cfg, comm, device=device)
        return state

    return init


def make_first_step(cfg, comm):
    """The Euler bootstrap step: ``first(state) -> SWState``."""
    _check_schedule(cfg, comm)

    def first(state):
        state, _tok = shallow_water_step(state, cfg, comm, first_step=True)
        return state

    return first


def make_multistep(cfg, comm, num_steps, *, donate=False):
    """``multi(state) -> SWState`` advancing ``num_steps`` AB2 steps: the
    JAX package's ``make_multistep``, one executable for the chunk.

    On the CPU it is a loop of eager steps.  On the card the comm's
    backend decides: a one-rank comm or an NCCL world captures the chunk
    in a CUDA graph, the NCCL exchanges inside it; a gloo world (a local
    world of ranks on one card) runs the chunk eagerly, because gloo
    stages through host memory, which a graph cannot hold, and because
    its ranks are threads that must not issue work while one captures.
    On the card with a graph:

    1. the first call runs the chunk eagerly on a side stream (the
       kernels' build, the allocator's first blocks) and returns that
       result; then it captures one chunk in a ``torch.cuda.CUDAGraph``
       on static copies of the state, the capture ending with copies of
       the outputs back into those buffers, so that replays chain;
    2. every later call copies the caller's state into the static
       buffers (unless it passed them back) and replays the graph.

    ``donate=True`` returns the static buffers themselves, so the state
    passed in is consumed, as with JAX's ``donate_argnums``: use it for
    ``state = multi(state)`` loops.  ``donate=False`` returns clones, so
    a later call never overwrites an earlier result.  A capture that
    fails raises; nothing falls back to the eager loop on the card.

    ``multi.replays`` counts the replays; ``multi.captured`` holds the
    kernel launches one chunk's graph makes (``{"sw_main": n,
    "sw_visc": n}``, 0 where the schedule runs no kernel), which the
    wrappers' host-side ``launches`` counts do not see.  The graph and
    its memory pool live as long as ``multi``.
    """
    _check_schedule(cfg, comm)

    def chunk(state):
        for _ in range(num_steps):
            state, _tok = shallow_water_step(state, cfg, comm)
        return state

    graph = None
    static = None

    def multi(state):
        nonlocal graph, static
        if state.h.device.type != "cuda" or not _captures(comm):
            return chunk(state)
        _check_device(cfg, state.h.device)
        if graph is None:
            out = run_on_side_stream(lambda: chunk(state), state.h.device)
            graph, static = _capture(chunk, comm, state, multi, num_steps)
            return out
        if any(a is not b for a, b in zip(state, static)):
            for a, b in zip(static, state):
                a.copy_(b)
        graph.replay()
        multi.replays += 1
        if donate:
            return static
        return SWState(*(t.clone() for t in static))

    multi.replays = 0
    multi.captured = {}
    return multi


def _captures(comm):
    """Whether a chunk on the card is captured: one rank, or NCCL."""
    transport = comm.transport()
    return transport is None or transport.backend == "nccl"


def _capture(chunk, comm, state, multi, num_steps):
    """Capture ``chunk`` on static copies of ``state``; returns
    ``(graph, static)`` and sets ``multi.captured``."""
    static = SWState(*(t.clone() for t in state))
    graph = torch.cuda.CUDAGraph()
    wrappers = (sw_main, sw_visc)
    before = [w.captures for w in wrappers]
    try:
        # NCCL's watchdog thread queries the device during a capture
        with graph_capture(graph, capture_error_mode=(
                None if comm.transport() is None else "thread_local")):
            out = chunk(static)
            for a, b in zip(static, out):
                a.copy_(b)
    except RuntimeError as exc:
        raise RuntimeError(
            f"CUDA graph capture of a {num_steps}-step shallow-water chunk "
            f"failed: {exc}"
        ) from exc
    multi.captured = {w.__name__: w.captures - n
                      for w, n in zip(wrappers, before)}
    return graph, static


def make_solver(cfg, comm, num_multisteps=10, on_chunk=None,
                checkpoint_dir=None, checkpoint_every=1, *, device="cuda"):
    """Full driver: init -> bootstrap step -> repeated multistep chunks.

    Returns ``solve(t1_seconds) -> (state, wall_seconds, n_steps)``.
    The wall time covers only the hot loop after one warm-up chunk, and
    ``n_steps`` counts the steps timed (the JAX package's contract).
    At least one chunk is timed on a fresh run even when the warm-up
    already passed ``t1``.  ``on_chunk(state, t_seconds)``, if given,
    runs after every chunk (the warm-up one included) and its time
    counts in the wall clock.  The chunks run through
    ``make_multistep(..., donate=True)`` (on the card: the warm-up chunk
    eagerly, then graph replays), which ``solve.multistep`` holds; so on
    the card the state ``on_chunk`` sees is overwritten by the next
    chunk, and a callback copies what it keeps.

    ``checkpoint_dir`` makes runs resumable: every ``checkpoint_every``
    chunks the state and the model time (a float64) are saved through
    :mod:`mpi4jax_tpu_torch.utils.checkpoint` (a host copy, taken before
    the next chunk overwrites the state), and a fresh ``solve`` in the
    same directory resumes from the latest checkpoint instead of
    initialising: no warm-up chunk, and a run that already reached
    ``t1`` returns the restored state with ``n_steps == 0`` and saves
    nothing.  A comm of one rank keeps the series in ``checkpoint_dir``
    itself (step ``s`` in ``<dir>/<s>``); on a comm of several ranks
    each rank keeps its own block's series in ``<dir>/rank<r>``, and the
    ranks resume from the lowest of their latest steps (a MIN
    allreduce), which every rank still holds.  Save time counts in the
    wall clock, so do not combine it with benchmark timing.
    """
    init = make_init(cfg, comm, device=device)
    first = make_first_step(cfg, comm)
    multi = make_multistep(cfg, comm, num_multisteps, donate=True)
    device = resolve_device(device)

    def restore_latest(mgr):
        """``(chunk, state, t)`` of the latest checkpoint every rank
        holds, or None."""
        latest = mgr.latest_step()
        if comm.size > 1:
            mine = torch.tensor([-1 if latest is None else latest],
                                dtype=torch.int64, device=device)
            agreed, _ = allreduce(mine, reductions.MIN, comm=comm)
            latest = int(agreed[0])
            latest = None if latest < 0 else latest
        if latest is None:
            return None
        ny_l, nx_l = cfg.local_interior(comm)
        G = cfg.ghost
        field = torch.empty((ny_l + 2 * G, nx_l + 2 * G),
                            dtype=torch_dtype(cfg), device=device)
        like = {"state": SWState(*(field,) * 6), "t": np.float64(0.0)}
        restored = mgr.restore(latest, like=like)
        return latest, restored["state"], float(restored["t"])

    def solve(t1):
        mgr = None
        if checkpoint_dir is not None:
            from mpi4jax_tpu_torch.utils import checkpoint

            series = pathlib.Path(checkpoint_dir)
            if comm.size > 1:
                series = series / f"rank{comm.rank()}"
            mgr = checkpoint.Manager(series)
        resumed = None if mgr is None else restore_latest(mgr)
        if resumed is not None:
            chunk, state, t = resumed
        else:
            chunk = 0
            state = first(init())
            t = cfg.dt
            state = multi(state)  # warm-up chunk (kernel builds, capture)
            t += cfg.dt * num_multisteps
        drain(state.h)
        if on_chunk is not None:
            on_chunk(state, t)
        steps = 0
        start = time.perf_counter()
        # a resumed run times no chunk past t1: rerunning a finished run
        # must not push the trajectory (and its checkpoints) on
        while t < t1 or (steps == 0 and resumed is None):
            state = multi(state)
            t += cfg.dt * num_multisteps
            steps += num_multisteps
            chunk += 1
            if on_chunk is not None:
                on_chunk(state, t)
            if mgr is not None:
                mgr.maybe_save(chunk, {"state": state, "t": np.float64(t)},
                               every=checkpoint_every)
        drain(state.h)
        wall = time.perf_counter() - start
        return state, wall, steps

    solve.multistep = multi
    return solve


def gather_global(local_field, comm, *, ghost=1):
    """Reassemble the global interior field from the per-rank blocks
    (``ghost``: the block's ghost width, 1 by default as in the JAX
    package)."""
    blocks, _ = allgather(local_field[ghost:-ghost, ghost:-ghost], comm=comm)
    py, px = comm.axis_sizes
    ny_l = local_field.shape[0] - 2 * ghost
    nx_l = local_field.shape[1] - 2 * ghost
    grid = blocks.reshape(py, px, ny_l, nx_l)
    return grid.permute(0, 2, 1, 3).reshape(py * ny_l, px * nx_l)


# -- carrying state across from the JAX package ---------------------------


def config_from_jax(cfg_fields):
    """The port's :class:`SWConfig` from a dict of the JAX ``SWConfig``'s
    fields (e.g. ``dataclasses.asdict(jax_cfg)``)."""
    known = {f.name for f in fields(SWConfig)}
    unknown = set(cfg_fields) - known
    if unknown:
        raise ValueError(f"unknown SWConfig fields {sorted(unknown)}")
    return SWConfig(**cfg_fields)


def state_from_jax(arrays, cfg, comm=None, *, device="cuda"):
    """This rank's port state in ``cfg.dtype`` on ``device`` from six
    numpy arrays ``(h, u, v, dh, du, dv)`` of a JAX state at
    ``cfg.ghost``: the global arrays of a ``shard_map`` over the
    ``("y", "x")`` grid of ``comm`` (one rank by default), i.e. every
    rank's block side by side.  Each block's tendencies are full-shaped
    (the narrow, single-exchange and Pallas layouts) or interior-shaped
    (the wide-halo layout).  A bfloat16 JAX array (an ``ml_dtypes`` numpy
    dtype, which torch cannot take) is widened to float32 in numpy
    first, which is exact."""
    device = resolve_device(device)
    comm = MeshComm() if comm is None else comm
    py, px = comm.axis_sizes
    iy, ix = _device_coords(comm)
    ny_l, nx_l = cfg.local_interior(comm)
    G = cfg.ghost
    full = (ny_l + 2 * G, nx_l + 2 * G)

    def block(name, a, shapes):
        for by, bx in shapes:
            if a.shape == (py * by, px * bx):
                return a[iy * by:(iy + 1) * by, ix * bx:(ix + 1) * bx]
        want = " or ".join(str((py * by, px * bx)) for by, bx in shapes)
        raise ValueError(f"{name} has shape {a.shape}, expected {want}")

    h, u, v, dh, du, dv = (
        block(name, np.asarray(a),
              [full] if name in ("h", "u", "v") else [full, (ny_l, nx_l)])
        for name, a in zip(("h", "u", "v", "dh", "du", "dv"), arrays)
    )

    def tensor(a):
        if a.dtype not in (np.float16, np.float32, np.float64):
            a = a.astype(np.float32)
        return torch.tensor(a, device=device).to(torch_dtype(cfg))

    return pad_state(SWState(*(tensor(a) for a in (h, u, v, dh, du, dv))))


def state_to_numpy(state):
    """The state's six fields as numpy arrays (full-shaped tendencies;
    bfloat16 widened to float32, which numpy can hold)."""
    return SWState(*(
        (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu().numpy()
        for t in state
    ))
