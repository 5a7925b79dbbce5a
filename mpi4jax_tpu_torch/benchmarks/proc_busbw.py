"""The proc tier's bus bandwidth and halo latency, over N OS processes.

    python -m mpi4jax_tpu_torch.launch -np 8 \\
        mpi4jax_tpu_torch/benchmarks/proc_busbw.py [--mb 16] [--reps 10]
    python -m mpi4jax_tpu_torch.launch -np 8 \\
        mpi4jax_tpu_torch/benchmarks/proc_busbw.py --op halo --widths 1 \\
        --halo-base 32 --fields 3 [--reps 10]

The port's copy of the two modes of ``benchmarks/proc_busbw.py`` that
the bench's proc legs run (``mpi4jax_tpu_torch/bench.py:proc_legs``).
Rank 0 prints one JSON line per record.

``--op allreduce`` (the default): a float32 SUM allreduce of ``--mb``
MB per rank, timed as the JAX script times it (a warm call, then the
best of 3 batches of ``--reps`` chained calls, each batch fenced by a
barrier and ending in a synchronise), bus bandwidth by the NCCL
convention (``bytes * 2(n-1)/n / t``).  Each arm is one record, the
arms' batches interleaved in one job: ``host``, CPU tensors (the JAX
leg's own setting), key ``allreduce_busbw_proc<n>_<plane>_host_gbps``;
and where the rank has a card (``launch.rank_device``: ``--platform
cuda``, the launcher's default) ``staged`` beside it, CUDA tensors
staged through pinned host memory (the reference's COPY_TO_HOST mode),
key ``allreduce_busbw_proc<n>_<plane>_gbps``.  ``<plane>`` is the data
plane the bridge takes (``shm``: the same-host shared-memory arena).
Beside them the in-run ceiling of the JAX script: one core's copy rate
(``single_core_copy_gbps``, rank 0 alone between fences), the
aggregate copy rate of N ranks copying at once (the copy gauntlet,
``gauntlet_agg_copy_gbps``), the arena's ceiling ``2 C k factor /
(5n + 1)`` and each arm's ``pct_of_ceiling``.  The native latency
histograms (p50, p99) come with ROADMAP Queue 1 item 10 and are printed
as skipped.

``--op halo``: the latency of a full 2-D halo exchange of ``--fields``
fields (``halo_exchange_2d_batch`` on the closest-to-square grid,
periodic both ways) at each width of ``--widths``, coalescing on and
off (``tuning.override_coalesce``) in interleaved rounds: p50 and p99
per side (``halo_p50_ms_proc<n>_w<w>``, ``coalesce`` on or off) and
the speedup (``halo_coalesce_speedup_proc<n>_w<w>``); the fields live
on the rank's launcher device (``launch.rank_device``).
"""

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from mpi4jax_tpu_torch import get_default_comm, tuning
from mpi4jax_tpu_torch import ops as m
from mpi4jax_tpu_torch.launch import rank_device
from mpi4jax_tpu_torch.ops._proc import proc_topology
from mpi4jax_tpu_torch.parallel.halo import halo_exchange_2d_batch
from mpi4jax_tpu_torch.parallel.proc import grid_comm
from mpi4jax_tpu_torch.utils import config

def _say(msg):
    print(f"[proc_busbw] {msg}", file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fence(comm):
    m.barrier(comm=comm)


def _busbw_factor(n):
    return 2 * (n - 1) / n


def _cores():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _copy_rate_gbps():
    """One core's copy rate (GB/s of payload): the best of 5 copies of
    16 MB."""
    src = np.random.default_rng(0).random((16 << 20) // 8)
    dst = np.empty_like(src)
    np.copyto(dst, src)
    best = math.inf
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return src.nbytes / best / 1e9


def _gauntlet_rate_gbps(comm, mb=16, reps=4):
    """The aggregate copy rate of every rank copying at once, fenced by
    barriers: the slowest rank's time (a MAX allreduce) over all the
    ranks' bytes."""
    src = np.random.default_rng(comm.rank()).random(int(mb * (1 << 20)) // 8)
    dst = np.empty_like(src)
    np.copyto(dst, src)
    best = math.inf
    for _ in range(3):
        _fence(comm)
        t0 = time.perf_counter()
        for _ in range(reps):
            np.copyto(dst, src)
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64)
        dt_max, _ = m.allreduce(dt, m.MAX, comm=comm)
        best = min(best, float(dt_max[0]))
    return comm.size * src.nbytes * reps / best / 1e9


def _data_plane(comm):
    topo = proc_topology(comm)
    shm_on = os.environ.get("T4J_NO_SHM", "").strip() in ("", "0")
    if shm_on and topo["n_hosts"] == 1 and comm.size > 1:
        return "shm", topo
    return "tcp", topo


def allreduce_main(args, comm):
    n, rank = comm.size, comm.rank()
    per = max(int(args.mb * 1e6 / 4), n)
    per -= per % n
    nbytes = per * 4
    devices = {"host": torch.device("cpu")}
    if rank_device().type == "cuda":
        devices["staged"] = rank_device()
    arms = list(devices)
    xs = {a: torch.ones(per, device=devices[a]) for a in arms}

    def batch(arm, reps):
        y = xs[arm]
        for _ in range(reps):
            y, _ = m.allreduce(xs[arm], m.SUM, comm=comm)
        _sync(devices[arm])
        return y

    for arm in arms:  # warm: the buffers' first touch, the staging cache
        batch(arm, 1)
    best = dict.fromkeys(arms, math.inf)
    for _ in range(3):
        for arm in arms:
            _fence(comm)
            t0 = time.perf_counter()
            batch(arm, args.reps)
            best[arm] = min(best[arm], (time.perf_counter() - t0) / args.reps)
    factor = _busbw_factor(n)
    # the in-run ceiling: rank 0 measures one core alone while the others
    # wait at the second fence, then every rank copies at once
    _fence(comm)
    copy_gbps = _copy_rate_gbps() if rank == 0 else 0.0
    _fence(comm)
    agg_gbps = _gauntlet_rate_gbps(comm)
    plane, topo = _data_plane(comm)
    if rank != 0:
        return
    cores = _cores()
    ceiling = 2 * copy_gbps * min(cores, n) * factor / (5 * n + 1)
    adj_ceiling = 2 * agg_gbps * factor / (5 * n + 1)
    for arm in arms:
        busbw = nbytes * factor / best[arm] / 1e9
        suffix = "_host" if arm == "host" else ""
        print(json.dumps({
            "metric": f"allreduce_busbw_proc{n}_{plane}{suffix}_gbps",
            "value": round(busbw, 3),
            "unit": "GB/s",
            "arm": arm,
            "tensors": "cuda, staged through pinned host memory"
            if arm == "staged" else "cpu",
            "nprocs": n,
            "payload_mb": nbytes / 1e6,
            "payload_bytes": nbytes,
            "sec_per_call": round(best[arm], 6),
            "data_plane": plane,
            "local_world": topo["local_size"],
            "leader_world": topo["n_hosts"],
            "ring_min_bytes": config.ring_min_bytes(),
            "seg_bytes": config.seg_bytes(),
            "single_core_copy_gbps": round(copy_gbps, 2),
            "gauntlet_agg_copy_gbps": round(agg_gbps, 2),
            "cores_available": cores,
            "ceiling_gbps": round(ceiling, 3),
            "pct_of_ceiling": round(100 * busbw / ceiling, 1),
            "ceiling_sched_adjusted_gbps": round(adj_ceiling, 3),
            "pct_of_sched_adjusted": round(100 * busbw / adj_ceiling, 1),
        }), flush=True)
    _say("skipped p50_ms and p99_ms: the bridge's latency histograms "
         "(telemetry) wait for ROADMAP Queue 1 item 10")


def halo_main(args, comm):
    n, rank = comm.size, comm.rank()
    device = rank_device()
    ny = next(c for c in range(int(n ** 0.5), 0, -1) if n % c == 0)
    grid = grid_comm((ny, n // ny))
    topo = proc_topology(comm)
    widths = [int(w) for w in str(args.widths).split(",") if w.strip()]
    reps = max(args.reps, 10)
    rng = np.random.default_rng(11 + 3 * rank)
    for w in widths:
        side = args.halo_base + 2 * w
        fields = [torch.from_numpy(rng.standard_normal((side, side))
                                   .astype(np.float32)).to(device)
                  for _ in range(args.fields)]
        slab_bytes = 4 * args.fields * w * side  # one direction's frame

        def exchange():
            halo_exchange_2d_batch(fields, grid, periodic=(True, True),
                                   width=w)
            _sync(device)

        times = {"off": [], "on": []}
        sides = (("off", 0), ("on", 1 << 30))
        for _, threshold in sides:
            tuning.override_coalesce(threshold)
            exchange()  # warm
        for _ in range(3):
            for mode, threshold in sides:
                tuning.override_coalesce(threshold)
                _fence(comm)
                for _ in range(reps):
                    t0 = time.perf_counter()
                    exchange()
                    times[mode].append(time.perf_counter() - t0)
        tuning.override_coalesce(None)
        if rank != 0:
            continue
        p = {}
        for mode, ts in times.items():
            ts = sorted(ts)
            p[mode] = {"p50": ts[len(ts) // 2] * 1e3,
                       "p99": ts[min(len(ts) - 1, int(len(ts) * 0.99))] * 1e3}
            print(json.dumps({
                "metric": f"halo_p50_ms_proc{n}_w{w}",
                "value": round(p[mode]["p50"], 4),
                "unit": "ms",
                "coalesce": mode,
                "p99_ms": round(p[mode]["p99"], 4),
                "nprocs": n,
                "grid": [ny, n // ny],
                "width": w,
                "fields": args.fields,
                "device": device.type,
                "direction_frame_bytes": slab_bytes,
                "local_world": topo["local_size"],
                "leader_world": topo["n_hosts"],
                "coalesce_bytes": 0 if mode == "off" else 1 << 30,
                "interleaved_pairs": True,
            }), flush=True)
        print(json.dumps({
            "metric": f"halo_coalesce_speedup_proc{n}_w{w}",
            "value": round(p["off"]["p50"] / p["on"]["p50"], 3),
            "unit": "x",
            "nprocs": n,
            "width": w,
            "fields": args.fields,
            "p99_speedup": round(p["off"]["p99"] / p["on"]["p99"], 3),
        }), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", default="allreduce", choices=("allreduce", "halo"))
    ap.add_argument("--mb", type=float, default=16.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--widths", default="1")
    ap.add_argument("--halo-base", type=int, default=32)
    ap.add_argument("--fields", type=int, default=3)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    comm = get_default_comm()
    if comm.backend != "proc":
        raise SystemExit("run under python -m mpi4jax_tpu_torch.launch")
    if args.op == "halo":
        return halo_main(args, comm)
    return allreduce_main(args, comm)


if __name__ == "__main__":
    main(sys.argv[1:])
