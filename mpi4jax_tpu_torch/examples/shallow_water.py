"""Shallow-water demo application for mpi4jax_tpu_torch.

The counterpart of ``examples/shallow_water.py`` on PyTorch.
``--benchmark`` runs the wide-halo schedule (ghost 2), with the step's
two kernels running as hand-written CUDA on the card; the demo and
``--check`` run the default configuration's narrow schedule (ghost 1,
plain PyTorch), as the JAX package's example does.

``--mesh PY PX`` decomposes the domain over a PY x PX grid of ranks.
Under ``torchrun`` each process is one rank: NCCL on the cards (one card
per rank), gloo with ``--device cpu``.  Without ``torchrun`` the ranks
run as threads of this process on one device (a local world over gloo).

Usage:

    # quick correctness check on a small grid
    python -m mpi4jax_tpu_torch.examples.shallow_water --check

    # demo run (360x180 grid, 10 model days)
    python -m mpi4jax_tpu_torch.examples.shallow_water

    # published-benchmark configuration (3600x1800, 0.1 model days)
    python -m mpi4jax_tpu_torch.examples.shallow_water --benchmark

    # the plain PyTorch path on the CPU, over a 2x2 grid of thread ranks
    python -m mpi4jax_tpu_torch.examples.shallow_water --check \
        --device cpu --mesh 2 2

    # a resumable run: a rerun with the same DIR resumes from the latest
    # checkpoint (each rank keeps its series in DIR/rank<r> on a grid)
    python -m mpi4jax_tpu_torch.examples.shallow_water --checkpoint DIR

    # four cards of one host over NCCL
    torchrun --nproc-per-node 4 -m mpi4jax_tpu_torch.examples.shallow_water \
        --benchmark --mesh 2 2
"""

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--mesh", nargs=2, type=int, metavar=("PY", "PX"),
                   help="a PY x PX grid of ranks (default 1 1)")
    p.add_argument("--days", type=float, default=None, help="model days")
    p.add_argument("--multistep", type=int, default=25)
    p.add_argument(
        "--device", default="cuda",
        help="'cuda' (default; the hand-written kernels) or 'cpu' (their "
        "plain PyTorch versions)",
    )
    p.add_argument(
        "--checkpoint", metavar="DIR",
        help="save resumable checkpoints every --checkpoint-every chunks; "
        "a rerun with the same DIR resumes from the latest (timing then "
        "includes checkpoint writes)",
    )
    p.add_argument("--checkpoint-every", type=int, default=1)
    args = p.parse_args(argv)

    from mpi4jax_tpu_torch.models import shallow_water as sw
    from mpi4jax_tpu_torch.parallel import distributed
    from mpi4jax_tpu_torch.parallel.comm import MeshComm
    from mpi4jax_tpu_torch.utils.runtime import resolve_device

    device = resolve_device(args.device)
    mesh = tuple(args.mesh) if args.mesh else (1, 1)

    if args.benchmark:
        cfg = sw.SWConfig().bench_size()
        days = args.days if args.days is not None else 0.1
    elif args.check:
        cfg = sw.SWConfig(ny=24, nx=48)
        days = args.days if args.days is not None else 0.02
    else:
        cfg = sw.SWConfig()
        days = args.days if args.days is not None else 10.0

    def run(comm):
        where = (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu")
        if comm.rank() == 0:
            print(
                f"shallow_water: grid {cfg.ny}x{cfg.nx}, ghost {cfg.ghost}, "
                f"ranks {mesh[0]}x{mesh[1]}, device {where}, "
                f"dt {cfg.dt:.1f}s, {days} model days",
                file=sys.stderr,
            )
        solve = sw.make_solver(cfg, comm, num_multisteps=args.multistep,
                               checkpoint_dir=args.checkpoint,
                               checkpoint_every=args.checkpoint_every,
                               device=device)
        state, wall, steps = solve(days * sw.DAY_IN_SECONDS)
        h = sw.gather_global(state.h, comm, ghost=cfg.ghost).cpu().numpy()
        if not np.isfinite(h).all():
            raise RuntimeError("solution diverged")
        rate = cfg.ny * cfg.nx * steps / wall if wall > 0 else float("nan")
        if comm.rank() == 0:
            print(
                f"steps timed: {steps}, wall: {wall:.3f}s, "
                f"{rate:.3e} cell-updates/s ({rate / comm.size:.3e} per "
                f"rank) on {where}",
                file=sys.stderr,
            )
            if args.check:
                print("check passed: solution finite", file=sys.stderr)
        return rate

    if "RANK" in os.environ:
        device = distributed.initialize(device)
        rate = run(distributed.world_comm((("y", "x"), mesh)))
        distributed.finalize()
        return rate
    if mesh == (1, 1):
        return run(MeshComm())
    return distributed.local_world(
        mesh[0] * mesh[1], run, axes=(("y", "x"), mesh),
        deadline=24 * 3600.0,
    )[0]


if __name__ == "__main__":
    main()
