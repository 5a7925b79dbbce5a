#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mpi4jax_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. build: the hand-written kernels are compiled from
   ``mpi4jax_tpu_torch/kernels/csrc/*.cu`` with nvcc for sm_90a, one
   nvcc per source, all started together; ptxas's register and spill
   lines are printed.
2. kernels (shallow water): at the published 3600x1800 domain (ghost 2,
   one rank) each kernel is held against its plain PyTorch version on
   the same inputs on the card, and timed beside its bound, its plain
   version and the measured device-to-device copy rate.
3. path (shallow water): the solver's main path, ``make_solver`` on the
   benchmark configuration for 0.1 model days, runs through the entry
   points with every kernel launch count set to 0 just before and read
   just after; both step kernels must have launched once per step.  The
   result must be finite and conserve mass, and 25 steps on the kernel
   path must agree with 25 steps on the plain path from the same state.
4. profile (shallow water): one chunk of 25 steps under torch.profiler,
   for the device time per step by kernel and the device's idle share.
5. kernels (flash): the flash-attention forward kernel against its
   plain version (at the kernel's own key tile) on the card: the decode
   path's prefill shape [4, 8192, 8, 64] bf16 causal with the row
   statistics m and l, a padded f32 case, q/k offsets with and without
   fully masked rows, grouped-query heads, and the training geometry
   [2, 2048, 16, 128] bf16: the largest and the mean output difference
   and the largest m and l difference, each within a limit that planted
   faults exceed; every case is checked before the phase raises.  Timed
   at the path shape beside its bound, its plain version and one
   scaled_dot_product_attention call.
6. path (decode): the long-prompt serving point (batch 4, prompt 8192,
   256 generated tokens, bf16, flash prefill, kv_bucket 16) through
   ``make_global_decode`` with every launch count set to 0 just before
   and read just after: exactly one flash launch per layer.  Tokens are
   [4, 8448] with the prompt echoed; prefill ms, generate ms per step,
   generated tokens/s and the bytes bound are printed.  The kernel
   prefill's last-position logits are held against a prefill on the
   plain flash version, and in f32 (prompt 1024, batch 2, max_len 1152)
   the kernel path and the plain path give identical tokens.
7. profile (decode): one decode call under torch.profiler, for device
   time by kernel in the prefill and the generation loop, and the
   generation loop's idle share.

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
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from mpi4jax_tpu_torch.examples import transformer_decode
from mpi4jax_tpu_torch.kernels import _build, sw_step
from mpi4jax_tpu_torch.kernels import flash as kflash
from mpi4jax_tpu_torch.models import shallow_water as sw
from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.parallel.halo import halo_exchange_2d

SOURCES = ("sw_step", "flash_fwd")

# H100 SXM data-sheet peaks (dense): device memory, float32 outside the
# tensor cores, bf16 in them.  The shallow-water kernels do float32
# arithmetic on CUDA cores; attention's bound is the bf16 tensor-core
# rate, whatever this first flash kernel runs on.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12

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

# flash kernel against its plain version at the same key tile.  The two
# differ only where the summation order moves a score across a rounding
# boundary: in f32 by a few ulps; in bf16 where a weight's exponential or
# an output rounds to the other bf16 neighbour, which is rare but may
# move one output element by a bf16 step of its size.  out: the largest
# and the mean absolute difference; m and l: the largest difference over
# max(|plain|, 1).  f32: the dense oracle's 2e-5 of
# tests/parallel/test_flash.py.  bf16: each limit lies between the
# readings of the sound kernel on these seeded inputs and of planted
# faults (PERF.md, PR 3: a dropped diagonal key tile, the exponential of
# the unrounded argument, unrounded weights in P.V).  Sound at most /
# faults at least: out max 3.9e-3 (one bf16 step below |out| = 1) /
# 7.8e-3, out mean 3.7e-7 / 8.2e-5, m and l 3.4e-4 / 2.7e-3 (the P.V
# fault leaves m and l as they are).
FLASH_LIMITS = {
    torch.float32: {"out_max": 2e-5, "out_mean": 1e-6, "stat": 1e-5},
    torch.bfloat16: {"out_max": 6e-3, "out_mean": 5e-6, "stat": 1e-3},
}
# the decode path's last-prompt-position logits, kernel prefill against
# plain prefill, bf16: 8 layers of bf16 activations, each of whose
# elements may move by a bf16 step (2^-8 of its size) where the
# attention output did; held to 5e-2 of the largest logit
DECODE_LOGIT_RTOL = 5e-2

# the long-prompt serving point (docs/performance.md:1347-1357) on the
# decode benchmark's model (benchmarks/transformer.py:358-362)
DECODE_CFG = tfm.TransformerConfig(
    vocab=32768, d_model=512, layers=8, heads=8, kv_heads=8, head_dim=64,
    d_ff=2048,
)
LONG = transformer_decode.LONG
# the f32 token-identity check, kernel path against plain path
F32_DECODE = dict(batch=2, prompt=1024, max_len=1152)


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


def reset_launch_counts():
    sw_step.reset_launch_counts()
    kflash.reset_launch_counts()


def launch_counts():
    return {"sw_main": sw_step.sw_main.launches,
            "sw_visc": sw_step.sw_visc.launches,
            "flash_fwd": kflash.flash_fwd.launches}


def path_phase(cfg, comm, device, kernels, state0, card):
    days = 0.1
    solve = sw.make_solver(cfg, comm, num_multisteps=25, device=device)
    reset_launch_counts()
    state, wall, steps = solve(days * sw.DAY_IN_SECONDS)
    launches = launch_counts()
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


def build_phase():
    """Build every kernel source at once (one nvcc each, in threads:
    the compiles run as subprocesses) and print ptxas's report."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = [pool.submit(_build.load_library, name) for name in SOURCES]
        for f in futures:
            f.result()
    log(f"  {', '.join(SOURCES)} built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        log(f"  {name}.cu: nvcc {_build.build_seconds(name):.2f} s")
        for line in (_build.library_dir(name) / "build.log").read_text(
                ).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"    ptxas: {line.strip()}")


def flash_inputs(shape, dtype, device, seed):
    """q [B, Tq, Hq, D], k and v [B, Tk, Hkv, D], normal, from a seed."""
    b, tq, tk, hq, hk, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(
        torch.randn(s, generator=gen, device=device).to(dtype)
        for s in ((b, tq, hq, d), (b, tk, hk, d), (b, tk, hk, d))
    )


def causal_pairs(tq, tk, q_offset, k_offset):
    """(query, key) pairs a causal mask leaves visible."""
    q = q_offset + torch.arange(tq, dtype=torch.float64)
    return float((q - k_offset + 1).clamp(0, tk).sum())


def flash_kernel_phase(device):
    """The flash kernel against its plain version at the kernel's key
    tile, then timed at the decode path's prefill shape."""
    b, t, h, d = (LONG["batch"], LONG["prompt"], DECODE_CFG.heads,
                  DECODE_CFG.head_dim)
    cases = [
        # name, (B, Tq, Tk, Hq, Hkv, D), dtype, causal, q_offset, k_offset
        ("path", (b, t, t, h, h, d), torch.bfloat16, True, 0, 0),
        ("padding", (2, 1000, 1000, 4, 4, 64), torch.float32, False, 0, 0),
        ("offsets", (1, 96, 160, 2, 2, 32), torch.float32, True, 64, 0),
        ("fully_masked", (1, 96, 160, 2, 2, 32), torch.float32, True, 64,
         512),
        ("gqa", (2, 300, 300, 8, 2, 64), torch.float32, True, 0, 0),
        ("training", (2, 2048, 2048, 16, 16, 128), torch.bfloat16, True, 0,
         0),
    ]
    path_err = None
    failed = []
    for i, (name, shape, dtype, causal, qo, ko) in enumerate(cases):
        q, k, v = flash_inputs(shape, dtype, device, seed=i)
        kw = dict(causal=causal, scale=1.0 / math.sqrt(shape[5]),
                  q_offset=qo, k_offset=ko, with_lse=True)
        out, m, l = kflash.flash_fwd(q, k, v, **kw)
        r_out, r_m, r_l = kflash.flash_attention_reference(
            q, k, v, block_k=kflash.BLOCK_K, **kw)
        torch.cuda.synchronize()
        diff = (out.float() - r_out.float()).abs()
        errs = {
            "out_max": diff.max().item(),
            "out_mean": diff.mean().item(),
            "m": ((m - r_m).abs() / r_m.abs().clamp(min=1)).max().item(),
            "l": ((l - r_l).abs() / r_l.abs().clamp(min=1)).max().item(),
        }
        lim = FLASH_LIMITS[dtype]
        finite = bool(torch.isfinite(out.float()).all())
        ok = (errs["out_max"] <= lim["out_max"]
              and errs["out_mean"] <= lim["out_mean"]
              and max(errs["m"], errs["l"]) <= lim["stat"] and finite)
        log(f"  flash {name} {list(shape)} {str(dtype)[6:]} causal={causal} "
            f"q_offset={qo} k_offset={ko}: out max_abs_err "
            f"{errs['out_max']:.3e} (limit {lim['out_max']:g}), mean_abs_err "
            f"{errs['out_mean']:.3e} (limit {lim['out_mean']:g}), m "
            f"{errs['m']:.3e}, l {errs['l']:.3e} (limit {lim['stat']:g}), "
            f"finite {finite} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        if name == "path":
            path_err = errs
        del q, k, v, out, m, l, r_out, r_m, r_l, diff
    if failed:
        raise RuntimeError(f"flash_fwd disagrees with its plain version on "
                           f"cases {failed}")

    # timing at the path shape, as the prefill calls it (no m, l)
    q, k, v = flash_inputs(cases[0][1], torch.bfloat16, device, seed=0)
    kw = dict(causal=True, scale=1.0 / math.sqrt(d))
    ms = time_ms(lambda: kflash.flash_fwd(q, k, v, **kw), n=5, repeats=3)
    plain_ms = time_ms(
        lambda: kflash.flash_attention_reference(
            q, k, v, block_k=kflash.BLOCK_K, **kw),
        n=1, repeats=3, warmup=1,
    )
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        n=10, repeats=3,
    )
    nbytes = 4 * q.numel() * q.element_size()  # q, k, v read; out written
    flops = 4 * d * b * h * causal_pairs(t, t, 0, 0)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_BF16_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    log(f"  flash_fwd at the path shape: {ms:.4f} ms per launch (plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} "
        f"ms); {flops:.4e} flops, {nbytes / 1e6:.1f} MB; bound "
        f"{bound_ms:.4f} ms by {'bytes' if bytes_ms >= flops_ms else 'operations'} "
        f"at the data-sheet peak ({flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s "
        f"achieved)")
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "mpi4jax_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "mpi4jax_tpu/ops/flash.py:97",
        "launches": None,  # filled from the decode path phase
        "max_abs_err": path_err["out_max"],
        "mean_abs_err": path_err["out_mean"],
        "max_stat_err": max(path_err["m"], path_err["l"]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms,
        "bytes": nbytes,
        "flops": flops,
    }


def plain_flash(q, k, v, *, causal):
    """The prefill's attention through the flash kernel's plain version
    at the kernel's key tile, on the same (CUDA) tensors."""
    return kflash.flash_attention_reference(
        q, k, v, causal=causal, scale=1.0 / math.sqrt(q.shape[-1]),
        block_k=kflash.BLOCK_K,
    )


def synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def decode_path_phase(device, flash_kernel, copy_rate):
    cfg = DECODE_CFG
    batch, p_len, max_len = LONG["batch"], LONG["prompt"], LONG["max_len"]
    comm = MeshComm(axes=("dp", "tp"), axis_sizes=(1, 1))
    dp, tp = comm.sub("dp"), comm.sub("tp")
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(cfg, generator=gen, dtype=torch.bfloat16,
                             device=device)
    prompts = torch.randint(0, cfg.vocab, (batch, p_len), generator=gen,
                            device=device, dtype=torch.int32)
    decode = tfm.make_global_decode(
        dp, tp, cfg, max_len, kv_bucket=LONG["kv_bucket"],
        prefill_impl=LONG["prefill_impl"], device=device,
    )
    _, warm_s = synced_seconds(lambda: decode(params, prompts))

    reset_launch_counts()
    out, wall = synced_seconds(lambda: decode(params, prompts))
    launches = launch_counts()
    log(f"  make_global_decode(prefill_impl='flash', kv_bucket="
        f"{LONG['kv_bucket']}): one decode {wall:.4f} s (warm-up "
        f"{warm_s:.4f} s); launches {launches}")
    if launches["flash_fwd"] != cfg.layers:
        raise RuntimeError(f"flash_fwd launched {launches['flash_fwd']} "
                           f"times in one decode, expected {cfg.layers}")
    flash_kernel["launches"] = launches["flash_fwd"]
    if tuple(out.shape) != (batch, max_len) or out.dtype != torch.int32:
        raise RuntimeError(f"decode returned {out.dtype} {tuple(out.shape)}")
    if not torch.equal(out[:, :p_len], prompts):
        raise RuntimeError("decode did not echo the prompt")
    if not ((out >= 0) & (out < cfg.vocab)).all():
        raise RuntimeError("decode produced tokens outside the vocabulary")

    hq = cfg.heads
    (_, logits), prefill_s = synced_seconds(lambda: tfm._prefill_sharded(
        params, prompts, cfg, tp, hq, cfg.kv_heads, max_len, impl="flash"))
    n_gen = max_len - p_len
    gen_step_ms = (wall - prefill_s) / n_gen * 1e3
    walls = []
    for _ in range(2):  # run_decode's bursts of 2 decodes
        _, burst = synced_seconds(
            lambda: (decode(params, prompts), decode(params, prompts)))
        walls.append(burst / 2)
    best = min(walls)
    rate = batch * n_gen / best
    bytes_per_step, params_bytes = transformer_decode.decode_bytes_per_step(
        cfg, params, batch, p_len, max_len)
    bound_rate = batch * copy_rate / bytes_per_step
    sheet_rate = batch * PEAK_BYTES_PER_S / bytes_per_step
    log(f"  prefill {prefill_s * 1e3:.4f} ms ({cfg.layers} flash launches, "
        f"{flash_kernel['ms'] * cfg.layers:.4f} ms of kernel time at the "
        f"kernel phase's rate); generate {gen_step_ms:.4f} ms per step "
        f"over {n_gen} steps")
    log(f"  {rate:.2f} generated tokens/s (best of 2 bursts of 2 decodes, "
        f"{best:.4f} s per decode); bytes per generated step "
        f"{bytes_per_step:.4e} (params {params_bytes:.4e}): bound "
        f"{bound_rate:.2f} tokens/s at the measured copy rate, "
        f"{sheet_rate:.2f} at the data-sheet rate")

    # kernel prefill against plain prefill, bf16, full width
    _, plain_logits = tfm._prefill_sharded(
        params, prompts, cfg, tp, hq, cfg.kv_heads, max_len,
        impl=plain_flash)
    scale = logits.float().abs().max().item()
    err = (logits.float() - plain_logits.float()).abs().max().item()
    ok = err <= DECODE_LOGIT_RTOL * scale
    log(f"  bf16 last-prompt logits, kernel vs plain prefill: max_abs_err "
        f"{err:.4e}, max|logit| {scale:.4f} (limit {DECODE_LOGIT_RTOL:g} of "
        f"it) {'ok' if ok else 'FAIL'}; argmax agrees on "
        f"{(logits.argmax(-1) == plain_logits.argmax(-1)).sum().item()}/"
        f"{batch} rows")
    if not ok:
        raise RuntimeError("kernel and plain prefill disagree at bf16")
    plain_out = tfm._greedy_decode(
        params, prompts, cfg, max_len, comm_tp=tp, batched=True,
        kv_bucket=LONG["kv_bucket"], prefill_impl=plain_flash)
    token_share = (plain_out[:, p_len:] == out[:, p_len:]).float().mean(
        ).item()
    log(f"  bf16 generated tokens identical, kernel vs plain prefill: "
        f"{token_share:.4f} of {batch * n_gen}")
    bf16_run = (decode, params, prompts)
    del out, plain_out

    # f32: kernel path and plain path give identical tokens
    fb, fp, fm = F32_DECODE["batch"], F32_DECODE["prompt"], \
        F32_DECODE["max_len"]
    params32 = tfm.init_params(cfg, generator=gen, device=device)
    prompts32 = torch.randint(0, cfg.vocab, (fb, fp), generator=gen,
                              device=device, dtype=torch.int32)
    decode32 = tfm.make_global_decode(
        dp, tp, cfg, fm, kv_bucket=LONG["kv_bucket"], prefill_impl="flash",
        device=device)
    kernel_out = decode32(params32, prompts32)
    plain_out = tfm._greedy_decode(
        params32, prompts32, cfg, fm, comm_tp=tp, batched=True,
        kv_bucket=LONG["kv_bucket"], prefill_impl=plain_flash)
    same = torch.equal(kernel_out, plain_out)
    log(f"  f32 batch {fb}, prompt {fp}, max_len {fm}: kernel and plain "
        f"prefill give {'identical' if same else 'DIFFERENT'} tokens")
    if not same:
        raise RuntimeError("kernel and plain paths differ in f32")
    return {"prefill_ms": prefill_s * 1e3, "generate_ms_per_step":
            gen_step_ms, "tokens_per_s": rate, "decode_s": best,
            "bytes_per_step": bytes_per_step, "bound_tokens_per_s":
            bound_rate, "bf16_token_share": token_share}, bf16_run


def decode_profile_phase(decode, params, prompts, path):
    """Device time by kernel over one decode call, split at the end of
    the prefill's last flash launch, and the generation loop's idle
    share against its untraced time from the path phase."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        decode(params, prompts)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        log("  the profiler recorded no device activity: not measured")
        return None
    flash_end = max(e.time_range.end for e in kernels
                    if "flash_fwd_kernel" in e.name)
    phases = {"prefill": {}, "generate": {}}
    for e in kernels:
        part = phases["prefill" if e.time_range.start < flash_end
                      else "generate"]
        total, count = part.get(e.name, (0.0, 0))
        part[e.name] = (total + e.time_range.elapsed_us() / 1e3, count + 1)
    n_gen = LONG["max_len"] - LONG["prompt"]
    res = {}
    for name, part in phases.items():
        busy = sum(ms for ms, _ in part.values())
        launches = sum(c for _, c in part.values())
        log(f"  {name}: device busy {busy:.4f} ms in {launches} launches")
        for kname, (ms, count) in sorted(part.items(),
                                         key=lambda kv: -kv[1][0])[:6]:
            log(f"    {ms:.4f} ms, {count} launches: {kname[:90]}")
        res[name] = {"device_ms": busy, "launches": launches}
    flash_ms = sum(ms for kname, (ms, _) in phases["prefill"].items()
                   if "flash_fwd_kernel" in kname)
    gen_untraced_ms = path["generate_ms_per_step"] * n_gen
    idle = 1 - res["generate"]["device_ms"] / gen_untraced_ms
    log(f"  flash kernel {flash_ms:.4f} ms of the prefill's "
        f"{res['prefill']['device_ms']:.4f} ms device time; generation: "
        f"{res['generate']['device_ms'] / n_gen:.4f} ms device time per "
        f"step of {path['generate_ms_per_step']:.4f} ms untraced (idle "
        f"share {idle:.3f})")
    res["flash_ms"] = flash_ms
    res["generate_idle_share"] = idle
    return res



def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    # full-precision f32 products everywhere (PyTorch's defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"card: {torch.cuda.get_device_name(0)} ({card})")
    t_all = time.perf_counter()

    log("phase build")
    build_phase()

    cfg = sw.SWConfig().bench_size()
    comm = MeshComm()
    log(f"phase kernels, shallow water ({cfg.ny}x{cfg.nx}, ghost "
        f"{cfg.ghost}, one rank)")
    copy_rate = copy_bytes_per_s(device)
    log(f"  device-to-device copy: {copy_rate / 1e9:.1f} GB/s "
        f"(read + write)")
    kernels, state0 = kernel_phase(cfg, comm, device, copy_rate)

    log("phase path, shallow water (make_solver, 0.1 model days)")
    path = path_phase(cfg, comm, device, kernels, state0, card)

    log("phase profile, shallow water (one chunk of 25 steps under "
        "torch.profiler)")
    profile = profile_phase(cfg, comm, state0, path["step_ms"])
    del state0

    log("phase kernels, flash attention")
    flash_kernel = flash_kernel_phase(device)
    kernels.append(flash_kernel)

    log(f"phase path, decode (batch {LONG['batch']}, prompt "
        f"{LONG['prompt']}, max_len {LONG['max_len']}, bf16, flash prefill, "
        f"kv_bucket {LONG['kv_bucket']})")
    decode_path, bf16_run = decode_path_phase(device, flash_kernel,
                                              copy_rate)

    log("phase profile, decode (one decode call under torch.profiler)")
    decode_profile = decode_profile_phase(*bf16_run, decode_path)

    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"path": path, "profile": profile,
                    "decode_path": decode_path,
                    "decode_profile": decode_profile,
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
