"""Flagship workload: the nonlinear shallow-water solver on PyTorch.

Counterpart of ``mpi4jax_tpu/models/shallow_water.py``: the same C-grid
model (Sadourny 1975 energy-conserving potential-vorticity scheme,
Adams-Bashforth-2 stepping with coefficients (1.6, -0.6), periodic x,
solid walls in y, lateral viscosity), the same configuration object and
the same driver functions.

This slice of the port runs the wide-halo schedule (``ghost=2``,
periodic x) on one rank, in the order of the fused Pallas step
(``research/sw_step_pallas.py:_step``):

1. exchange the 2-deep halos of h, u, v;
2. clamp h's wall ghost rows to the adjacent interior row (hc == h);
3. the ``sw_main`` kernel: all tendencies and the AB2 update;
4. exchange u, v;
5. the ``sw_visc`` kernel: lateral viscosity.

The state carries full-shaped tendencies (the Pallas layout).  Fields on
a CUDA device go through the hand-written kernels of
``kernels/sw_step.py``; fields on the CPU through their plain versions.

PyTorch runs eagerly, so ``make_multistep`` is a Python loop over steps
where the JAX package compiles one ``fori_loop``.
"""

import math
import time
from dataclasses import dataclass, fields, replace
from typing import NamedTuple

import numpy as np
import torch

from mpi4jax_tpu_torch.kernels.sw_step import sw_main, sw_visc
from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops._core import as_token
from mpi4jax_tpu_torch.ops.allreduce import allreduce
from mpi4jax_tpu_torch.ops.collectives import allgather, scan
from mpi4jax_tpu_torch.parallel.halo import halo_exchange_2d
from mpi4jax_tpu_torch.utils.runtime import drain, resolve_device

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
G = 2  # the ghost width of the only schedule ported so far

GHOST_ITEM = "ROADMAP.md Queue 1 item 2 (ghost-1 and ghost-4 schedules)"


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
    # wide-halo schedule, 4 = the single-exchange schedule.  Only 2 is
    # ported so far.
    ghost: int = 2

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


def _check_schedule(cfg):
    if cfg.ghost != G:
        raise NotImplementedError(
            f"ghost={cfg.ghost} is not ported yet (only the wide-halo "
            f"schedule, ghost=2): {GHOST_ITEM}"
        )
    if not cfg.periodic_x:
        raise NotImplementedError(
            "the wide-halo schedule requires periodic_x=True, as in the "
            "JAX package"
        )
    if cfg.dtype != "float32":
        raise ValueError(f"the kernels run float32, got dtype={cfg.dtype!r}")


def _device_coords(comm):
    """(iy, ix) coordinates of this rank on the ("y", "x") comm."""
    return comm.coords_of(comm.rank())


def _local_mesh_coords(cfg, comm, device):
    """Physical coordinates of the local block, ghosts included."""
    ny_l, nx_l = cfg.local_interior(comm)
    iy, ix = _device_coords(comm)
    f32 = torch.float32
    jy = torch.arange(-G, ny_l + G, dtype=f32, device=device) + float(iy * ny_l)
    jx = torch.arange(-G, nx_l + G, dtype=f32, device=device) + float(ix * nx_l)
    return torch.meshgrid(jy * cfg.dy, jx * cfg.dx, indexing="ij")


def _coriolis(cfg, yy):
    return cfg.coriolis_f + yy * cfg.coriolis_beta


def _wall_masks(comm):
    """(is_north_edge, is_south_edge) for the solid-wall conditions."""
    py, _ = comm.axis_sizes
    iy, _ = _device_coords(comm)
    return iy == py - 1, iy == 0


def initial_state(cfg, comm, *, device="cuda", token=None):
    """Geostrophically balanced zonal jet plus a perturbation, built on
    this rank's block; returns ``(SWState, token)``."""
    _check_schedule(cfg)
    device = resolve_device(device)
    token = as_token(token)
    yy, xx = _local_mesh_coords(cfg, comm, device)
    ly, lx = cfg.length_y, cfg.length_x

    u0 = 10.0 * torch.exp(-((yy - 0.5 * ly) ** 2) / (0.02 * lx) ** 2)
    v0 = torch.zeros_like(u0)

    # geostrophic balance h_y = -(f/g) u, integrated along global y: a
    # local cumsum plus the exclusive prefix of the blocks to the south
    integrand = -cfg.dy * u0 * _coriolis(cfg, yy) / cfg.gravity
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
    h_mean = total / float(cfg.ny * cfg.nx)

    h0 = (
        cfg.depth
        + h_geo
        - h_mean
        + 0.2
        * torch.sin(xx / lx * 10.0 * math.pi)
        * torch.cos(yy / ly * 8.0 * math.pi)
    )

    per = (False, cfg.periodic_x)
    h0, token = halo_exchange_2d(h0, comm, periodic=per, token=token, width=G)
    u0, token = halo_exchange_2d(u0, comm, periodic=per, token=token, width=G)
    v0, token = halo_exchange_2d(v0, comm, periodic=per, token=token, width=G)

    zeros = [torch.zeros_like(h0) for _ in range(3)]
    return SWState(h0, u0, v0, *zeros), token


def clamp_wall_ghost_rows(h, comm, ny_l):
    """Clamp ``h``'s wall-side ghost rows to the adjacent interior row,
    in place, so that the kernels can read ``hc == h``.

    The only consumer of h's true wall ghost rows is the pressure
    gradient of the wall-row ``v``, which the wall condition zeroes.
    """
    is_north, is_south = _wall_masks(comm)
    if is_south:
        h[:G] = h[G : G + 1]
    if is_north:
        h[-G:] = h[ny_l + G - 1 : ny_l + G]
    return h


def shallow_water_step(state, cfg, comm, *, first_step=False, token=None):
    """One model step; returns ``(SWState, token)``.

    Halo exchanges write the ghost rings of the input's h, u, v in
    place; the step's results are new tensors.
    """
    _check_schedule(cfg)
    return _step(state, cfg, comm, first_step=first_step, token=token,
                 main=sw_main, visc=sw_visc)


def _step(state, cfg, comm, *, first_step, token, main, visc):
    """The Pallas step schedule with the given ``main`` / ``visc``
    functions (the kernel wrappers, or their plain versions when a
    comparison runs the plain path on the card)."""
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


def pad_state(state):
    """Lift a state with interior-shaped tendencies (the JAX wide-halo
    layout) to full-shaped ones; a full-shaped state is returned as is."""
    if state.dh.shape == state.h.shape:
        return state

    def lift(t):
        full = torch.zeros_like(state.h)
        full[G:-G, G:-G] = t
        return full

    return SWState(state.h, state.u, state.v, lift(state.dh),
                   lift(state.du), lift(state.dv))


def crop_state(state):
    """Inverse of :func:`pad_state` (interior-shaped tendencies)."""
    return SWState(
        state.h, state.u, state.v,
        state.dh[G:-G, G:-G], state.du[G:-G, G:-G], state.dv[G:-G, G:-G],
    )


def make_init(cfg, comm, *, device="cuda"):
    """Initial-condition builder: ``init() -> SWState`` on ``device``."""
    _check_schedule(cfg)
    device = resolve_device(device)

    def init():
        state, _tok = initial_state(cfg, comm, device=device)
        return state

    return init


def make_first_step(cfg, comm):
    """The Euler bootstrap step: ``first(state) -> SWState``."""
    _check_schedule(cfg)

    def first(state):
        state, _tok = shallow_water_step(state, cfg, comm, first_step=True)
        return state

    return first


def make_multistep(cfg, comm, num_steps):
    """``multi(state) -> SWState`` advancing ``num_steps`` AB2 steps."""
    _check_schedule(cfg)

    def multi(state):
        for _ in range(num_steps):
            state, _tok = shallow_water_step(state, cfg, comm)
        return state

    return multi


def make_solver(cfg, comm, num_multisteps=10, on_chunk=None, *,
                device="cuda"):
    """Full driver: init -> bootstrap step -> repeated multistep chunks.

    Returns ``solve(t1_seconds) -> (state, wall_seconds, n_steps)``.
    The wall time covers only the hot loop after one warm-up chunk, and
    ``n_steps`` counts the steps timed (the JAX package's contract).
    At least one chunk is timed even when the warm-up already passed
    ``t1``.  ``on_chunk(state, t_seconds)``, if given, runs after every
    chunk (the warm-up one included) and its time counts in the wall
    clock.
    """
    init = make_init(cfg, comm, device=device)
    first = make_first_step(cfg, comm)
    multi = make_multistep(cfg, comm, num_multisteps)

    def solve(t1):
        state = first(init())
        t = cfg.dt
        state = multi(state)  # warm-up chunk (kernel builds, allocator)
        t += cfg.dt * num_multisteps
        drain(state.h)
        if on_chunk is not None:
            on_chunk(state, t)
        steps = 0
        start = time.perf_counter()
        while t < t1 or steps == 0:
            state = multi(state)
            t += cfg.dt * num_multisteps
            steps += num_multisteps
            if on_chunk is not None:
                on_chunk(state, t)
        drain(state.h)
        wall = time.perf_counter() - start
        return state, wall, steps

    return solve


def gather_global(local_field, comm, *, ghost=G):
    """Reassemble the global interior field from the per-rank blocks."""
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


def state_from_jax(arrays, cfg, *, device="cuda"):
    """Port state on ``device`` from six numpy arrays ``(h, u, v, dh, du,
    dv)`` of a one-rank JAX state: the wide-halo layout (interior-shaped
    tendencies) or the Pallas layout (full-shaped ones)."""
    device = resolve_device(device)
    h, u, v, dh, du, dv = (np.asarray(a) for a in arrays)
    full = (cfg.ny + 2 * G, cfg.nx + 2 * G)
    for name, a in zip("huv", (h, u, v)):
        if a.shape != full:
            raise ValueError(f"{name} has shape {a.shape}, expected {full}")
    for name, a in zip(("dh", "du", "dv"), (dh, du, dv)):
        if a.shape not in (full, (cfg.ny, cfg.nx)):
            raise ValueError(
                f"{name} has shape {a.shape}, expected {full} or "
                f"{(cfg.ny, cfg.nx)}"
            )

    def tensor(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return pad_state(SWState(*(tensor(a) for a in (h, u, v, dh, du, dv))))


def state_to_numpy(state):
    """The state's six fields as numpy arrays (full-shaped tendencies)."""
    return SWState(*(t.detach().cpu().numpy() for t in state))
