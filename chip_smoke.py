#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mpi4jax_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. build: the hand-written kernels are compiled from
   ``mpi4jax_tpu_torch/kernels/csrc/*.cu`` with nvcc for sm_90a.
2. kernels: at the published 3600x1800 domain (ghost 2, one rank) each
   kernel is held against its plain PyTorch version on the same inputs
   on the card, and timed beside its bound, its plain version and the
   measured device-to-device copy rate.
3. path: the solver's main path, ``make_solver`` on the benchmark
   configuration for 0.1 model days, runs through the entry points with
   the kernel launch counts set to 0 just before and read just after;
   every kernel must have launched.  The result must be finite and
   conserve mass, and 25 steps on the kernel path must agree with 25
   steps on the plain path from the same state.
4. profile: one chunk of 25 steps under torch.profiler, for the device
   time per step by kernel and the device's idle share.

Prints, last, a ``{"kernels": [...]}`` line, the card's name and power
limit as nvidia-smi gives them, and ``{"ok": true, "device": ...}``.
Without a CUDA device it exits 1 before printing any result.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import torch

from mpi4jax_tpu_torch.kernels import _build, sw_step
from mpi4jax_tpu_torch.models import shallow_water as sw
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.parallel.halo import halo_exchange_2d

# H100 SXM data-sheet peaks (dense): device memory and float32 outside
# the tensor cores.  The kernels do float32 arithmetic on CUDA cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# float operations per interior cell, counted once per intermediate
# (the kernel recomputes some of them per thread; that is not work the
# function needs).  sw_main: fe 3, fn 3, q 16, ke 10, dh 6, du 15,
# dv 15, plus the AB2 update of h, u, v (5 each).  sw_visc: per field
# 3 + 3 for the two viscous fluxes, 5 for their divergence, 2 for the
# update.
FLOPS_PER_CELL = {"sw_main": 83, "sw_visc": 26}

KERNEL_TOL = {"state": 1e-6, "tendency": 1e-4}
PATH_TOL = 2e-4
MASS_RTOL = 1e-5
TIMED_LAUNCHES = 25


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def rel_close(expected, actual, tol):
    """(ok, max_abs_err, max_err / scale): allclose with rtol=tol and
    atol=tol * max|expected|, the metric of
    research/test_sw_step_pallas.py."""
    scale = max(expected.abs().max().item(), 1e-30)
    err = (expected - actual).abs().max().item()
    ok = torch.allclose(actual, expected, rtol=tol, atol=tol * scale)
    return bool(ok), err, err / scale


def time_ms(fn, n=TIMED_LAUNCHES, repeats=5, warmup=3):
    """Device time of one call of ``fn``: CUDA events around ``n``
    back-to-back calls, so the host's launch cost overlaps the device
    work, divided by ``n``; the median of ``repeats`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def copy_bytes_per_s(device):
    """Device-to-device copy rate of 512 MiB: bytes read plus bytes
    written per second."""
    n = 128 * 1024 * 1024
    src = torch.ones(n, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), n=20)
    return 2 * n * 4 / (ms * 1e-3)


def plain_step(state, cfg, comm, first_step):
    """The solver's step with the plain versions of both kernels."""
    state, _ = sw._step(
        state, cfg, comm, first_step=first_step, token=None,
        main=sw_step.sw_main_reference, visc=sw_step.sw_visc_reference,
    )
    return state


def clone(state):
    return sw.SWState(*(t.clone() for t in state))


def kernel_phase(cfg, comm, device, copy_rate):
    ny_l, nx_l = cfg.local_interior(comm)
    is_north, is_south = sw._wall_masks(comm)
    iy, _ = sw._device_coords(comm)
    geometry = dict(cfg=cfg, ny_l=ny_l, nx_l=nx_l, is_south=is_south,
                    is_north=is_north)

    # a non-trivial state (v != 0): the initial state plus a few steps
    state = sw.make_init(cfg, comm, device=device)()
    state = plain_step(state, cfg, comm, True)
    for _ in range(4):
        state = plain_step(state, cfg, comm, False)
    if state.v.abs().max().item() == 0.0:
        raise RuntimeError("kernel-phase state has v == 0")

    # the main kernel's inputs as the step gives them: exchanged, clamped
    per = (False, True)
    h, u, v, dh, du, dv = clone(state)
    for f in (h, u, v):
        halo_exchange_2d(f, comm, periodic=per, width=sw.G)
    sw.clamp_wall_ghost_rows(h, comm, ny_l)
    inputs = (h, u, v, dh, du, dv)
    rows, cols = h.shape
    cells = rows * cols
    interior = ny_l * nx_l
    results = {}

    for first_step in (True, False):
        kw = dict(iy=iy, first_step=first_step, **geometry)
        got = sw_step.sw_main(*inputs, **kw)
        want = sw_step.sw_main_reference(*inputs, **kw)
        torch.cuda.synchronize()
        worst_abs, worst_rel = 0.0, 0.0
        for name, w, g in zip(sw.SWState._fields, want, got):
            tol = KERNEL_TOL["tendency" if name.startswith("d") else "state"]
            ok, err, rel = rel_close(w, g, tol)
            log(f"  sw_main first_step={first_step} {name}: max_abs_err "
                f"{err:.3e}, max_err/max|plain| {rel:.3e} (limit {tol:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"sw_main disagrees with its plain "
                                   f"version on {name}")
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        results[f"sw_main_first_step_{first_step}"] = (worst_abs, worst_rel)
    main_out = got  # the AB2 case: the main path's launch

    # viscosity inputs: the main kernel's u, v after their exchange
    u2, v2 = main_out[1].clone(), main_out[2].clone()
    for f in (u2, v2):
        halo_exchange_2d(f, comm, periodic=per, width=sw.G)
    got = sw_step.sw_visc(u2, v2, **geometry)
    want = sw_step.sw_visc_reference(u2, v2, **geometry)
    torch.cuda.synchronize()
    worst_abs, worst_rel = 0.0, 0.0
    for name, w, g in zip("uv", want, got):
        ok, err, rel = rel_close(w, g, KERNEL_TOL["state"])
        log(f"  sw_visc {name}: max_abs_err {err:.3e}, max_err/max|plain| "
            f"{rel:.3e} (limit {KERNEL_TOL['state']:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"sw_visc disagrees with its plain version "
                               f"on {name}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    results["sw_visc"] = (worst_abs, worst_rel)

    # timing at the main path's shapes; each call allocates its outputs
    # as the step does
    ab2 = dict(iy=iy, first_step=False, **geometry)
    timings = {
        "sw_main": (
            time_ms(lambda: sw_step.sw_main(*inputs, **ab2)),
            time_ms(lambda: sw_step.sw_main_reference(*inputs, **ab2)),
            12 * cells * 4,
            FLOPS_PER_CELL["sw_main"] * interior,
            "research/sw_step_pallas.py:98",
            results["sw_main_first_step_False"],
        ),
        "sw_visc": (
            time_ms(lambda: sw_step.sw_visc(u2, v2, **geometry)),
            time_ms(lambda: sw_step.sw_visc_reference(u2, v2, **geometry)),
            4 * cells * 4,
            FLOPS_PER_CELL["sw_visc"] * interior,
            "research/sw_step_pallas.py:217",
            results["sw_visc"],
        ),
    }
    kernels = []
    for name, (ms, plain_ms, nbytes, flops, replaces, err) in timings.items():
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_F32_PER_S * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        copy_bound_ms = nbytes / copy_rate * 1e3
        log(f"  {name}: {ms:.4f} ms per launch, median of 5 runs of "
            f"{TIMED_LAUNCHES} (plain {plain_ms:.4f} ms), {nbytes / 1e6:.1f} MB, "
            f"bound {bound_ms:.4f} ms by "
            f"{'bytes' if bytes_ms >= flops_ms else 'operations'} at the "
            f"data-sheet peak, {copy_bound_ms:.4f} ms at the measured copy "
            f"rate ({nbytes / (ms * 1e-3) / 1e9:.0f} GB/s achieved)")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mpi4jax_tpu_torch/kernels/csrc/sw_step.cu",
            "replaces": replaces,
            "launches": None,  # filled from the path phase
            "max_abs_err": err[0],
            "max_rel_err": err[1],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": None,  # no single PyTorch call computes it
            "copy_bound_ms": copy_bound_ms,
            "bytes": nbytes,
            "flops": flops,
        })
    return kernels, state


def path_phase(cfg, comm, device, kernels, state0, card):
    days = 0.1
    solve = sw.make_solver(cfg, comm, num_multisteps=25, device=device)
    sw_step.reset_launch_counts()
    state, wall, steps = solve(days * sw.DAY_IN_SECONDS)
    launches = {"sw_main": sw_step.sw_main.launches,
                "sw_visc": sw_step.sw_visc.launches}
    total_steps = 1 + 25 + steps  # bootstrap, warm-up chunk, timed chunks
    log(f"  make_solver: {steps} timed steps in {wall:.4f} s, "
        f"{total_steps} steps in all; launches {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            raise RuntimeError(f"the main path never launched {k['name']}")
        if k["launches"] != total_steps:
            raise RuntimeError(f"{k['name']} launched {k['launches']} times "
                               f"in {total_steps} steps")

    for name, t in zip(sw.SWState._fields, state):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{name} is not finite after the solver run")
    G = sw.G
    mean_h = state.h[G:-G, G:-G].double().mean().item()
    if not math.isclose(mean_h, cfg.depth, rel_tol=MASS_RTOL):
        raise RuntimeError(f"mass not conserved: mean h {mean_h} vs depth "
                           f"{cfg.depth}")
    log(f"  mean(h interior) {mean_h:.7f} vs depth {cfg.depth} "
        f"(rtol {MASS_RTOL:g}) ok")
    rate = cfg.ny * cfg.nx * steps / wall
    step_ms = wall / steps * 1e3
    kernel_ms = sum(k["ms"] for k in kernels)
    log(f"  {rate:.4e} cell-updates/s, {step_ms:.4f} ms per step "
        f"(kernels {kernel_ms:.4f} ms of it), on {card}")

    # 25 steps on the kernel path and on the plain path, same start
    multi = sw.make_multistep(cfg, comm, 25)
    fast = multi(clone(state0))
    plain = clone(state0)
    for _ in range(25):
        plain = plain_step(plain, cfg, comm, False)
    torch.cuda.synchronize()
    for name, p, f in zip(sw.SWState._fields, plain, fast):
        ok, err, rel = rel_close(p, f, PATH_TOL)
        log(f"  25 steps kernel vs plain {name}: max_err/max|plain| "
            f"{rel:.3e} (limit {PATH_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"kernel path and plain path disagree on "
                               f"{name} after 25 steps")
    return {"cell_updates_per_s": rate, "step_ms": step_ms,
            "timed_steps": steps, "wall_s": wall}


def profile_phase(cfg, comm, state, step_ms, n_steps=25):
    """Where a step's time goes: device time per step by kernel from a
    torch.profiler trace of one chunk, against the untraced step time
    of the path phase (tracing slows the host, not the kernels)."""
    from torch.autograd import DeviceType

    multi = sw.make_multistep(cfg, comm, n_steps)
    s = clone(state)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        multi(s)
        torch.cuda.synchronize()
    per_kernel = {}
    host = {}
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3
        if getattr(e, "is_user_annotation", False):
            # the ops' record_function ranges; on the device side they
            # span kernels and are no device work of their own
            if e.device_type == DeviceType.CPU:
                host[e.name] = host.get(e.name, 0.0) + ms / n_steps
            continue
        if e.device_type == DeviceType.CUDA:
            total, count = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (total + ms, count + 1)
    if not per_kernel:
        log("  the profiler recorded no device activity: device busy share "
            "not measured")
        return None
    busy = sum(ms for ms, _ in per_kernel.values()) / n_steps
    log(f"  device busy {busy:.4f} ms per step of {step_ms:.4f} ms untraced "
        f"(idle share {1 - busy / step_ms:.3f})")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, count) in top:
        log(f"    {ms / n_steps:.4f} ms/step, {count / n_steps:g} "
            f"launches/step: {name[:90]}")
    for key, ms in sorted(host.items(), key=lambda kv: -kv[1]):
        log(f"    host, traced: {ms:.4f} ms/step in {key}")
    return {"device_busy_ms_per_step": busy,
            "idle_share": 1 - busy / step_ms,
            "launches_per_step": sum(c for _, c in per_kernel.values())
            / n_steps}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"card: {torch.cuda.get_device_name(0)} ({card})")
    t_all = time.perf_counter()

    log("phase build")
    t0 = time.perf_counter()
    _build.load_library("sw_step")
    log(f"  sw_step.cu built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds('sw_step'):.2f} s)")
    for line in (_build.library_dir("sw_step") / "build.log").read_text(
            ).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    cfg = sw.SWConfig().bench_size()
    comm = MeshComm()
    log(f"phase kernels ({cfg.ny}x{cfg.nx}, ghost {cfg.ghost}, one rank)")
    copy_rate = copy_bytes_per_s(device)
    log(f"  device-to-device copy: {copy_rate / 1e9:.1f} GB/s "
        f"(read + write)")
    kernels, state0 = kernel_phase(cfg, comm, device, copy_rate)

    log("phase path (make_solver, 0.1 model days)")
    path = path_phase(cfg, comm, device, kernels, state0, card)

    log("phase profile (one chunk of 25 steps under torch.profiler)")
    profile = profile_phase(cfg, comm, state0, path["step_ms"])

    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"path": path, "profile": profile,
                    "copy_bytes_per_s": copy_rate}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
