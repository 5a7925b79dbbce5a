"""The shallow-water wide-halo step's two kernels: wrappers, launchers
and plain PyTorch versions.

* :func:`sw_main` — one fused step: mass fluxes, potential vorticity,
  kinetic energy, the h/u/v tendencies and the AB2 (or, on the first
  step, Euler) update under the interior mask, with v = 0 on the north
  wall row.  Replaces ``research/sw_step_pallas.py:_main_kernel``.
* :func:`sw_visc` — the lateral-viscosity update of u and v.  Replaces
  ``research/sw_step_pallas.py:_visc_kernel``.

Both take and return the Pallas kernels' layout: every field, the
tendencies included, is a ``(ny_l + 4, nx_l + 4)`` block with a 2-deep
ghost ring (float32 for the kernels; the plain versions compute in the
fields' dtype, as the JAX package computes in ``cfg.dtype``); ghost
cells pass the input through and tendencies are zero there.
Preconditions (established by the caller, ``models.shallow_water``):
the ghost rings of h, u, v were exchanged, and h's wall ghost rows
were clamped to the adjacent interior row.

Beside them sit the helpers that every schedule of
``models.shallow_water`` shares with the plain versions:
:func:`scalars` (the model's constants as tensors of the dtype),
:func:`grid_coords` (the grid as the JAX package rounds it) and
:func:`ring_view`.

Dispatch is by the tensors' device alone: CUDA tensors go to the
hand-written kernels in ``csrc/sw_step.cu`` (built at first use, see
``_build.py``), CPU tensors to the plain versions
:func:`sw_main_reference` / :func:`sw_visc_reference`.  A failed build
or launch raises; nothing falls back to the plain versions on the card.
Each wrapper counts its kernel launches in ``<wrapper>.launches``; a
call made while the current stream is being captured into a CUDA graph
records the launch instead of making it, and counts in
``<wrapper>.captures`` (the graph's replays launch it).
"""

import ctypes
import functools
import threading
from types import SimpleNamespace

import torch

from mpi4jax_tpu_torch.kernels import _build
from mpi4jax_tpu_torch.utils.validation import check_kernel_fields

__all__ = [
    "sw_main",
    "sw_visc",
    "sw_main_reference",
    "sw_visc_reference",
    "reset_launch_counts",
    "scalars",
    "grid_coords",
    "ring_view",
]

G = 2  # ghost width: the kernels implement the wide-halo schedule only

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.cache
def _library():
    """The built kernel library with its launchers' C signatures (built
    and loaded once per process: ``_build.load_library`` holds a lock)."""
    lib = _build.load_library("sw_step")
    lib.sw_main_launch.argtypes = [_P] * 12 + [_I] * 7 + [_F] * 8 + [_I, _P]
    lib.sw_main_launch.restype = _I
    lib.sw_visc_launch.argtypes = [_P] * 4 + [_I] * 6 + [_F] * 4 + [_P]
    lib.sw_visc_launch.restype = _I
    lib.sw_step_error_string.argtypes = [_I]
    lib.sw_step_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(lib, name, code):
    if code != 0:
        msg = lib.sw_step_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def _check_shape(name, first, ny_l, nx_l):
    if tuple(first.shape) != (ny_l + 2 * G, nx_l + 2 * G):
        raise ValueError(
            f"{name}: fields have shape {tuple(first.shape)}, expected "
            f"{(ny_l + 2 * G, nx_l + 2 * G)} for a {ny_l}x{nx_l} interior "
            f"with a {G}-deep ghost ring"
        )


# -- ring views (the _ring_view / _i/_e/_w/_n/_s helpers of the JAX model)


def ring_view(a, r, dy=0, dx=0, *, G=G):
    """Ring-``r`` view of a ``(n + 2G)``-shaped block, shifted by
    ``(dy, dx)``: the rows and columns within ``r`` rings of the
    interior, read at offset ``(dy, dx)`` (the JAX package's
    ``_ring_view``; ghost 2, the kernels' width, by default)."""
    y0 = G - r + dy
    x0 = G - r + dx
    return a[y0 : y0 + a.shape[0] - 2 * (G - r),
             x0 : x0 + a.shape[1] - 2 * (G - r)]


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


def _zero_wall_rows(a1, is_south, is_north, extra_north=False):
    """Zero a ring-1 field's rows beyond the walls (and, for the
    northern flux, the last interior row), in place."""
    if is_south:
        a1[0] = 0.0
    if is_north:
        a1[-1] = 0.0
        if extra_north:
            a1[-2] = 0.0
    return a1


def scalars(cfg, dtype, device):
    """The model's constants as 0-d tensors of ``dtype`` on ``device``,
    made with ``torch.full`` (no host-to-device copy, so a CUDA
    graph can capture them).

    Two reasons.  PyTorch divides a CUDA tensor by a host scalar as a
    product with the scalar's reciprocal, which rounds differently from
    the kernels' IEEE division; a device tensor divisor divides exactly,
    on the card as on the CPU.  And JAX casts a Python scalar to the
    array's dtype before the operation (a weakly typed constant: 5e3 is
    4992 in bfloat16), where PyTorch keeps it in float32 for a bfloat16
    tensor; a tensor of the dtype rounds as JAX does.
    """
    values = dict(dx=cfg.dx, dy=cfg.dy, g=cfg.gravity, dt=cfg.dt,
                  nu=cfg.lateral_viscosity, a=cfg.ab_a, b=cfg.ab_b,
                  f=cfg.coriolis_f, beta=cfg.coriolis_beta)
    return SimpleNamespace(**{
        k: torch.full((), v, dtype=dtype, device=device)
        for k, v in values.items()
    })


def grid_coords(n, ghost, offset, spacing):
    """Physical coordinates of ``n + 2 * ghost`` cells along one axis,
    ghosts included, as the JAX package builds them
    (``(jnp.arange(-G, n + G, dtype) + offset) * spacing``): an iota in
    the dtype, then the start added in the dtype, then the block's
    global offset, then the product with ``spacing`` (a 0-d tensor of
    the dtype).  In bfloat16 this matches JAX bit for bit, where
    ``torch.arange(-G, n + G, dtype=torch.bfloat16)`` does not."""
    dtype, device = spacing.dtype, spacing.device
    iota = torch.arange(n + 2 * ghost, dtype=torch.float32,
                        device=device).to(dtype)
    j = iota + torch.full((), -ghost, dtype=dtype, device=device)
    j = j + torch.full((), offset, dtype=dtype, device=device)
    return j * spacing


def sw_main_reference(h, u, v, dh, du, dv, *, cfg, ny_l, nx_l, is_south,
                      is_north, iy, first_step):
    """Plain PyTorch version of :func:`sw_main`; returns
    ``(h, u, v, dh, du, dv)`` as new tensors."""
    V = ring_view
    c = scalars(cfg, h.dtype, h.device)
    dx, dy = c.dx, c.dy

    fe = 0.5 * (V(h, 1) + V(h, 1, 0, 1)) * V(u, 1)
    fn = 0.5 * (V(h, 1) + V(h, 1, 1, 0)) * V(v, 1)
    fe = _zero_wall_rows(fe, is_south, is_north)
    fn = _zero_wall_rows(fn, is_south, is_north, extra_north=True)

    dh_new = -(_i(fe) - _w(fe)) / dx - (_i(fn) - _s(fn)) / dy

    # Coriolis on the ring-1 rows: array row r has global y (r - 2 + iy*ny_l)*dy
    yy = grid_coords(ny_l, G, iy * ny_l, dy)[1:-1]
    cor = (c.f + yy * c.beta)[:, None]

    rel_vort = (V(v, 1, 0, 1) - V(v, 1)) / dx - (V(u, 1, 1, 0) - V(u, 1)) / dy
    q = (cor + rel_vort) / (
        0.25 * (V(h, 1) + V(h, 1, 0, 1) + V(h, 1, 1, 0) + V(h, 1, 1, 1))
    )
    q = _zero_wall_rows(q, is_south, is_north)

    du_new = -c.g * (V(h, 0, 0, 1) - V(h, 0)) / dx + 0.5 * (
        _i(q) * 0.5 * (_i(fn) + _e(fn))
        + _s(q) * 0.5 * (_s(fn) + fn[:-2, 2:])
    )
    dv_new = -c.g * (V(h, 0, 1, 0) - V(h, 0)) / dy - 0.5 * (
        _i(q) * 0.5 * (_i(fe) + _n(fe))
        + _w(q) * 0.5 * (_w(fe) + fe[2:, :-2])
    )

    ke = 0.5 * (
        0.5 * (V(u, 1) ** 2 + V(u, 1, 0, -1) ** 2)
        + 0.5 * (V(v, 1) ** 2 + V(v, 1, -1, 0) ** 2)
    )
    ke = _zero_wall_rows(ke, is_south, is_north)
    du_new = du_new - (_e(ke) - _i(ke)) / dx
    dv_new = dv_new - (_n(ke) - _i(ke)) / dy

    dt = c.dt
    if first_step:
        h_inc = dt * dh_new
        u_inc = dt * du_new
        v_inc = dt * dv_new
    else:
        a, b = c.a, c.b
        h_inc = dt * (a * dh_new + b * V(dh, 0))
        u_inc = dt * (a * du_new + b * V(du, 0))
        v_inc = dt * (a * dv_new + b * V(dv, 0))

    h_out, u_out, v_out = h.clone(), u.clone(), v.clone()
    V(h_out, 0).add_(h_inc)
    V(u_out, 0).add_(u_inc)
    V(v_out, 0).add_(v_inc)
    if is_north:
        v_out[ny_l + G - 1] = 0.0
    tendencies = []
    for t in (dh_new, du_new, dv_new):
        full = torch.zeros_like(h)
        V(full, 0).copy_(t)
        tendencies.append(full)
    return (h_out, u_out, v_out, *tendencies)


def sw_visc_reference(u, v, *, cfg, ny_l, nx_l, is_south, is_north):
    """Plain PyTorch version of :func:`sw_visc`; returns ``(u, v)`` as
    new tensors."""
    V = ring_view
    c = scalars(cfg, u.dtype, u.device)
    dx, dy, nu = c.dx, c.dy, c.nu

    def laplacian(w):
        gx = nu * (V(w, 1, 0, 1) - V(w, 1)) / dx
        gy = nu * (V(w, 1, 1, 0) - V(w, 1)) / dy
        gx = _zero_wall_rows(gx, is_south, is_north)
        gy = _zero_wall_rows(gy, is_south, is_north)
        return (_i(gx) - _w(gx)) / dx + (_i(gy) - _s(gy)) / dy

    u_out, v_out = u.clone(), v.clone()
    V(u_out, 0).add_(c.dt * laplacian(u))
    V(v_out, 0).add_(c.dt * laplacian(v))
    if is_north:
        v_out[ny_l + G - 1] = 0.0
    return u_out, v_out


def sw_main(h, u, v, dh, du, dv, *, cfg, ny_l, nx_l, is_south, is_north,
            iy, first_step):
    """One fused wide-halo step; returns ``(h, u, v, dh, du, dv)``.

    CUDA tensors launch the ``sw_main`` kernel on the current stream;
    CPU tensors run :func:`sw_main_reference`.
    """
    fields = {"h": h, "u": u, "v": v, "dh": dh, "du": du, "dv": dv}
    if h.device.type == "cpu":
        return sw_main_reference(
            h, u, v, dh, du, dv, cfg=cfg, ny_l=ny_l, nx_l=nx_l,
            is_south=is_south, is_north=is_north, iy=iy,
            first_step=first_step,
        )
    first = check_kernel_fields("sw_main", fields, device_type="cuda")
    _check_shape("sw_main", first, ny_l, nx_l)
    lib = _library()
    outs = [torch.empty_like(first) for _ in range(6)]
    rows, cols = first.shape
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        code = lib.sw_main_launch(
            *(t.data_ptr() for t in fields.values()),
            *(t.data_ptr() for t in outs),
            rows, cols, ny_l, nx_l, int(is_south), int(is_north), int(iy),
            cfg.dx, cfg.dy, cfg.gravity, cfg.coriolis_f, cfg.coriolis_beta,
            cfg.dt, cfg.ab_a, cfg.ab_b, int(first_step), stream,
        )
    _check_launch(lib, "sw_main", code)
    _count(sw_main)
    return tuple(outs)


def sw_visc(u, v, *, cfg, ny_l, nx_l, is_south, is_north):
    """Lateral-viscosity update; returns ``(u, v)``.

    CUDA tensors launch the ``sw_visc`` kernel on the current stream;
    CPU tensors run :func:`sw_visc_reference`.
    """
    if u.device.type == "cpu":
        return sw_visc_reference(
            u, v, cfg=cfg, ny_l=ny_l, nx_l=nx_l, is_south=is_south,
            is_north=is_north,
        )
    first = check_kernel_fields("sw_visc", {"u": u, "v": v},
                                device_type="cuda")
    _check_shape("sw_visc", first, ny_l, nx_l)
    lib = _library()
    u_out, v_out = torch.empty_like(u), torch.empty_like(v)
    rows, cols = first.shape
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        code = lib.sw_visc_launch(
            u.data_ptr(), v.data_ptr(), u_out.data_ptr(), v_out.data_ptr(),
            rows, cols, ny_l, nx_l, int(is_south), int(is_north),
            cfg.dx, cfg.dy, cfg.lateral_viscosity, cfg.dt, stream,
        )
    _check_launch(lib, "sw_visc", code)
    _count(sw_visc)
    return u_out, v_out


_count_lock = threading.Lock()


def _count(wrapper):
    """One launch of ``wrapper``'s kernel, or one recorded into the CUDA
    graph being captured on the current stream (under a lock: the ranks
    of a local world launch from their own threads)."""
    capturing = torch.cuda.is_current_stream_capturing()
    with _count_lock:
        if capturing:
            wrapper.captures += 1
        else:
            wrapper.launches += 1


def reset_launch_counts():
    """Set every kernel wrapper's launch and capture counts to 0."""
    for wrapper in (sw_main, sw_visc):
        wrapper.launches = 0
        wrapper.captures = 0


reset_launch_counts()
