"""The proc tier's data-parallel training step: the gradient sync in
buckets that overlap the backward, against the same buckets through
blocking allreduces.

    python -m mpi4jax_tpu_torch.launch -np 8 \\
        mpi4jax_tpu_torch/benchmarks/transformer.py --overlap pairs

The port's copy of ``run_overlap`` of ``benchmarks/transformer.py`` (the
JAX script's other legs are ``examples/transformer_train.py`` and
``bench.py`` here).  Every rank trains the same ``StackParams`` (6
layers of width 1024 by default) on its own batch of 16 rows with
``models/train.py:make_dp_train_step``, buckets of ``T4J_BUCKET_BYTES``;
each rank computes on one thread (``torch.set_num_threads(1)``, as the
JAX leg pins XLA's CPU pool), so the overlap has idle cycles to use.

``--overlap on`` or ``off`` times one side, ``pairs`` both: both sides
are warmed and their losses asserted equal, then each timed batch runs
``--reps`` steps of each side back to back, fenced by a barrier, so
that noise hits both alike; the best batch of each side counts.  Each
arm is its own set of records, the arms' batches interleaved in one
job: ``host``, CPU tensors (the JAX leg's own setting), keys
``train_step_ms_proc<n>_host_overlap_on`` and ``_off`` and
``overlap_speedup_proc<n>_host``; and where the rank has a card
(``launch.rank_device``: ``--platform cuda``, the launcher's default)
``staged`` beside it, the step on the card with every bucket staged
through pinned host memory, keys ``train_step_ms_proc<n>_overlap_on``
and ``_off`` and ``overlap_speedup_proc<n>``.  Rank 0 prints one JSON
line per record.
"""

import argparse
import json
import math
import sys
import time

import torch

from mpi4jax_tpu_torch import get_default_comm
from mpi4jax_tpu_torch import ops as m
from mpi4jax_tpu_torch.launch import rank_device
from mpi4jax_tpu_torch.models import train
from mpi4jax_tpu_torch.utils import config

__all__ = ["run_overlap", "main"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_overlap(mode="pairs", layers=6, d_model=1024, batch=16, reps=3,
                batches=3, bucket_bytes=None, lr=1e-3):
    """Time the dp step with overlap on and off (``mode`` ``on``,
    ``off`` or ``pairs``) in each arm; rank 0 returns the records (and
    prints them), the other ranks None."""
    torch.set_num_threads(1)
    comm = get_default_comm()
    if comm.backend != "proc":
        raise SystemExit("--overlap measures the proc tier: run under "
                         "python -m mpi4jax_tpu_torch.launch -np N")
    n, rank = comm.size, comm.rank()
    if bucket_bytes is None:
        bucket_bytes = config.bucket_bytes()
    sides = ("on", "off") if mode == "pairs" else (mode,)
    devices = {"host": torch.device("cpu")}
    if rank_device().type == "cuda":
        devices["staged"] = rank_device()

    state = {}
    for arm, device in devices.items():
        params = train.init_stack_params(
            layers, d_model, generator=torch.Generator().manual_seed(0),
            device=device)
        x = torch.randn((batch, d_model),
                        generator=torch.Generator().manual_seed(rank + 1))
        data = (x.to(device), torch.zeros((batch, d_model), device=device))
        steps = {side: train.make_dp_train_step(
            comm, lr=lr, overlap=side == "on", bucket_bytes=bucket_bytes)
            for side in sides}
        state[arm] = (params, data, steps)
    n_params = sum(w.numel() + b.numel() for w, b in params.layers) \
        + params.w_out.numel()

    # warm both sides of each arm (the staging cache, first touches)
    for arm, (params, data, steps) in state.items():
        losses = {side: steps[side](params, data)[1] for side in sides}
        _sync(devices[arm])
        if len(sides) == 2 and not torch.equal(losses["on"], losses["off"]):
            raise AssertionError(f"overlap on/off steps disagree ({arm}): "
                                 f"{losses}")

    best = {(arm, side): math.inf for arm in state for side in sides}
    for _ in range(batches):
        for arm, (params, data, steps) in state.items():
            for side in sides:
                p = params
                m.barrier(comm=comm)
                t0 = time.perf_counter()
                for _ in range(reps):
                    p, loss = steps[side](p, data)
                _sync(devices[arm])
                best[arm, side] = min(best[arm, side],
                                      (time.perf_counter() - t0) / reps)
    if rank != 0:
        return None
    recs = []
    for arm in state:
        suffix = "_host" if arm == "host" else ""
        common = {"nprocs": n, "layers": layers, "d_model": d_model,
                  "bucket_bytes": int(bucket_bytes), "arm": arm,
                  "tensors": "cuda, staged through pinned host memory"
                  if arm == "staged" else "cpu"}
        for side in sides:
            recs.append({
                "metric": f"train_step_ms_proc{n}{suffix}_overlap_{side}",
                "value": round(best[arm, side] * 1e3, 3), "unit": "ms",
                **common, "batch": batch,
                "params_m": round(n_params / 1e6, 3),
                "grad_mb": round(n_params * 4 / 1e6, 2),
                "interleaved_pairs": mode == "pairs",
            })
        if len(sides) == 2:
            recs.append({
                "metric": f"overlap_speedup_proc{n}{suffix}",
                "value": round(best[arm, "off"] / best[arm, "on"], 3),
                "unit": "x", **common,
            })
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return recs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--overlap", choices=("on", "off", "pairs"),
                   default="pairs")
    p.add_argument("--layers", type=int, default=6)
    p.add_argument("--d-model", type=int, default=1024)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--bucket-bytes", type=int, default=None,
                   help="gradient bucket bytes (default T4J_BUCKET_BYTES)")
    args = p.parse_args(argv)
    return run_overlap(args.overlap, layers=args.layers,
                       d_model=args.d_model, batch=args.batch,
                       reps=args.reps, batches=args.batches,
                       bucket_bytes=args.bucket_bytes)


if __name__ == "__main__":
    main(sys.argv[1:])
