"""Continuous-batching serving benchmark: p50/p99 latency, rps, shed
rate and goodput under an SLO, under open-loop Poisson load
(docs/serving.md "measuring it").

    python -m mpi4jax_tpu_torch.launch -np 8 \\
        mpi4jax_tpu_torch/benchmarks/serving.py --arms pairs --slo 4000

The port's copy of ``benchmarks/serving.py``: the transformer served by
``mpi4jax_tpu_torch.serving`` across the proc ranks of a launcher job
(tensor-parallel over every rank, each rank on ``launch.rank_device()``:
its card under ``--platform cuda``, the launcher's default, with the
collectives staged through host memory; the CPU under ``--platform
cpu``), driven by a seeded open-loop load generator.  The same
arguments, defaults and JSON records as the JAX script.

``--arms pairs`` (default) interleaves an **admission-on** and an
**admission-off** window back to back, ``--windows`` times, with the
SAME seeded arrival stream per window pair.  The off arm measures (but
never enforces) the same SLO, so the records show both what admission
control delivered and what the uncontrolled baseline did to the p99.
``--arms on`` / ``off`` runs one arm.  The injected straggler is the
bridge's own (``T4J_FAULT_MODE=delay T4J_FAULT_RANK=3
T4J_FAULT_DELAY_MS=80``); the records then carry ``fault_mode`` /
``fault_rank`` labels.

Open-loop, on purpose: arrivals keep coming at the configured rate; an
overloaded admission-on server SHEDS (counted), an overloaded baseline
QUEUES (the p99 blows up) — both outcomes are the measurement.

Rank 0 prints one JSON record per metric: ``serving_p50_ms_procN``,
``serving_p99_ms_procN``, ``serving_rps_procN``,
``serving_shed_rate_procN``, ``serving_slo_attainment_procN`` (and
``serving_slo_held_procN`` under an SLO), then the same with
``_admit_off`` for the baseline arm of ``pairs``.  ``--arms ramp``, the
autoscale contrast, needs the launcher's ``--elastic rejoin
--autoscale`` and comes with ROADMAP Queue 1 item 19.
"""

import argparse
import json
import os
import sys
import time

import torch

from mpi4jax_tpu_torch import get_default_comm
from mpi4jax_tpu_torch.launch import rank_device
from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.serving import LoadGen
from mpi4jax_tpu_torch.serving import engine as eng
from mpi4jax_tpu_torch.serving.request import Request
from mpi4jax_tpu_torch.serving.stats import ServingStats

__all__ = ["main"]


def _build(args):
    comm = get_default_comm()
    cfg = tfm.TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, layers=args.layers,
        heads=args.heads, kv_heads=args.kv_heads,
        head_dim=args.d_model // args.heads, d_ff=args.d_ff,
    )
    # the same parameters on every rank: one seeded CPU generator
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    engine = eng.ServingEngine(
        comm, cfg, params, max_len=args.max_len,
        max_batch=args.max_batch, admit="off", slo_ms=0.0,
        overlap=(args.overlap == "on"), markers=True,
        device=rank_device(),
    )
    return comm, engine


def _warmup(engine, args):
    """Run every prefill bucket in the prompt range and the decode once,
    seeding the SLO estimator with real step times, outside the measured
    windows."""
    lo, hi = args.prompt
    buckets = set()
    p = lo
    while True:
        buckets.add(engine._prefill_bucket(p))
        if p >= hi:
            break
        p = min(hi, p * 2 if p > 1 else 2)
    for i, b in enumerate(sorted(buckets)):
        p_len = min(b, args.max_len - 2)
        engine.offer(Request(-1 - i, tuple(range(1, p_len + 1)), 3, 0.0), 0.0)
    engine.drain(now_ms_fn=lambda: 0.0, stop=False)
    engine.finished.clear()


def _window(engine, args, arm, arm_stats, window_idx):
    """One measured window of ``arm`` ('on'|'off'): a fresh seeded
    arrival stream, real-time pacing, a drain at the end (the drain's
    time counts into the tail latencies: queued work is not free)."""
    slo = float(args.slo)
    engine.reconfigure(
        arm, slo_ms=slo, rate_limit=args.rate_limit,
        stats=arm_stats[arm], measure_slo_ms=slo,
    )
    # both arms stamp deadlines (the off arm measures the SLO it does
    # not enforce)
    deadline = (lambda t: t + slo) if slo else (lambda t: None)
    gen = LoadGen(
        seed=args.seed + 1000 * window_idx, rate_rps=args.rate,
        prompt_len=("uniform", *args.prompt),
        max_new=("uniform", *args.new),
        vocab=args.vocab, deadline_fn=deadline,
    )
    t0 = time.perf_counter()

    def now_ms():
        return (time.perf_counter() - t0) * 1e3

    dur_ms = args.duration * 1e3
    offered = 0
    while True:
        now = now_ms()
        if now >= dur_ms:
            break
        for req in gen.until(now):
            engine.offer(req, now_ms())
            offered += 1
        engine.step(now_ms())
    engine.drain(now_ms_fn=now_ms, stop=False)
    return {"offered": offered, "wall_s": time.perf_counter() - t0}


def _arm_records(stats, n, arm, walls, extra):
    s = stats.snapshot()
    offered = s["completed"] + s["shed"]
    wall = sum(walls) or 1e-9
    suffix = "" if arm == "primary" else f"_admit_{arm}"
    recs = []

    def rec(metric, value, unit, **kw):
        if value is None:
            return
        recs.append({"metric": metric, "value": value, "unit": unit,
                     "nprocs": n, **extra, **kw})

    def rnd(v):
        return None if v is None else round(v, 3)

    rec(f"serving_p50_ms_proc{n}{suffix}", rnd(s["latency_p50_ms"]),
        "ms", admit=s["admit_mode"], completed=s["completed"])
    rec(f"serving_p99_ms_proc{n}{suffix}", rnd(s["latency_p99_ms"]),
        "ms", admit=s["admit_mode"], completed=s["completed"],
        slo_ms=s["slo_ms"])
    rec(f"serving_rps_proc{n}{suffix}",
        round(s["completed"] / wall, 3), "req/s",
        admit=s["admit_mode"], wall_s=round(wall, 3))
    rec(f"serving_shed_rate_proc{n}{suffix}",
        round(s["shed"] / offered, 4) if offered else None, "fraction",
        admit=s["admit_mode"], shed=s["shed"], offered=offered,
        shed_by_reason=s["shed_by_reason"])
    rec(f"serving_slo_attainment_proc{n}{suffix}",
        rnd(s["slo_attainment"]), "fraction", admit=s["admit_mode"],
        slo_ms=s["slo_ms"], slo_ok=s["slo_ok"], offered=offered)
    if s["slo_ms"]:
        p99 = s["latency_p99_ms"]
        rec(f"serving_slo_held_proc{n}{suffix}",
            (1 if p99 is not None and p99 <= s["slo_ms"] else 0),
            "bool", p99_ms=rnd(p99), slo_ms=s["slo_ms"])
    return recs


def _pair(s):
    return tuple(int(x) for x in s.split(","))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arms", choices=("pairs", "on", "off", "ramp"),
                    default="pairs")
    ap.add_argument("--windows", type=int, default=2,
                    help="window repetitions per arm")
    ap.add_argument("--duration", type=float, default=8.0,
                    help="seconds of open-loop load per window")
    ap.add_argument("--rate", type=float, default=6.0,
                    help="open-loop arrival rate, requests/s")
    ap.add_argument("--rate-limit", type=float, default=0.0,
                    help="admission token-bucket rate (0 = SLO gate only)")
    ap.add_argument("--slo", type=float, default=4000.0,
                    help="end-to-end SLO in ms (0 = none)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--prompt", type=_pair, default=(2, 12),
                    help="prompt-length uniform bounds lo,hi")
    ap.add_argument("--new", type=_pair, default=(4, 16),
                    help="output-length uniform bounds lo,hi")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--overlap", choices=("on", "off"), default="on")
    ap.add_argument("--quick", action="store_true",
                    help="one short window per arm")
    args = ap.parse_args(argv)
    if args.arms == "ramp":
        raise SystemExit(
            "--arms ramp (the autoscale contrast) needs the launcher's "
            "--elastic rejoin --autoscale and the engine's autoscale "
            "wiring, which come with ROADMAP Queue 1 item 19")
    if args.quick:
        args.windows = 1
        args.duration = min(args.duration, 4.0)
    torch.set_num_threads(1)

    comm, engine = _build(args)
    n = comm.size
    if not engine.is_leader:
        engine.run_follower()
        return 0

    arms = ("on", "off") if args.arms == "pairs" else (args.arms,)
    arm_stats = {arm: ServingStats(slo_ms=float(args.slo),
                                   max_batch=args.max_batch, admit_mode=arm)
                 for arm in arms}
    _warmup(engine, args)
    walls = {arm: [] for arm in arms}
    for w in range(args.windows):
        for arm in arms:
            info = _window(engine, args, arm, arm_stats, w)
            walls[arm].append(info["wall_s"])
            s = arm_stats[arm].snapshot()
            p99 = s["latency_p99_ms"]
            print(f"[serving] window {w} arm={arm}: offered "
                  f"{info['offered']} completed {s['completed']} shed "
                  f"{s['shed']} p99 {p99 and round(p99)} ms",
                  file=sys.stderr, flush=True)
    engine.stop()

    extra = {
        "rate_rps": args.rate, "windows": args.windows,
        "duration_s": args.duration, "max_batch": args.max_batch,
        "max_len": args.max_len, "overlap": args.overlap,
        "interleaved_pairs": args.arms == "pairs",
        "model": {"layers": args.layers, "d_model": args.d_model,
                  "heads": args.heads, "vocab": args.vocab},
        "device": engine.device.type,
    }
    fault = os.environ.get("T4J_FAULT_MODE", "").strip()
    if fault:
        extra["fault_mode"] = fault
        extra["fault_rank"] = os.environ.get("T4J_FAULT_RANK")
        extra["fault_delay_ms"] = os.environ.get("T4J_FAULT_DELAY_MS")
    # the unsuffixed keys come from the admission-on arm when it ran
    # (the controlled configuration); a lone off arm reports itself
    # unsuffixed, labelled admit=off
    if "on" in arm_stats:
        records = _arm_records(arm_stats["on"], n, "primary", walls["on"],
                               extra)
        if "off" in arm_stats:
            records += _arm_records(arm_stats["off"], n, "off",
                                    walls["off"], extra)
    else:
        records = _arm_records(arm_stats["off"], n, "primary",
                               walls["off"], extra)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
