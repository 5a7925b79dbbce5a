"""Shallow-water demo application for mpi4jax_tpu_torch.

The counterpart of ``examples/shallow_water.py`` on PyTorch: one process,
one rank.  ``--benchmark`` runs the wide-halo schedule (ghost 2), with
the step's two kernels running as hand-written CUDA on the card; the
demo and ``--check`` run the default configuration's narrow schedule
(ghost 1, plain PyTorch), as the JAX package's example does.

Usage:

    # quick correctness check on a small grid
    python -m mpi4jax_tpu_torch.examples.shallow_water --check

    # demo run (360x180 grid, 10 model days)
    python -m mpi4jax_tpu_torch.examples.shallow_water

    # published-benchmark configuration (3600x1800, 0.1 model days)
    python -m mpi4jax_tpu_torch.examples.shallow_water --benchmark

    # the plain PyTorch path on the CPU
    python -m mpi4jax_tpu_torch.examples.shallow_water --check --device cpu
"""

import argparse
import sys

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--benchmark", action="store_true")
    p.add_argument("--check", action="store_true")
    p.add_argument("--days", type=float, default=None, help="model days")
    p.add_argument("--multistep", type=int, default=25)
    p.add_argument(
        "--device", default="cuda",
        help="'cuda' (default; the hand-written kernels) or 'cpu' (their "
        "plain PyTorch versions)",
    )
    args = p.parse_args(argv)

    from mpi4jax_tpu_torch.models import shallow_water as sw
    from mpi4jax_tpu_torch.parallel.comm import MeshComm
    from mpi4jax_tpu_torch.utils.runtime import resolve_device

    device = resolve_device(args.device)
    comm = MeshComm()

    if args.benchmark:
        cfg = sw.SWConfig().bench_size()
        days = args.days if args.days is not None else 0.1
    elif args.check:
        cfg = sw.SWConfig(ny=24, nx=48)
        days = args.days if args.days is not None else 0.02
    else:
        cfg = sw.SWConfig()
        days = args.days if args.days is not None else 10.0

    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(
        f"shallow_water: grid {cfg.ny}x{cfg.nx}, ghost {cfg.ghost}, "
        f"device {where}, dt {cfg.dt:.1f}s, {days} model days",
        file=sys.stderr,
    )

    solve = sw.make_solver(cfg, comm, num_multisteps=args.multistep,
                           device=device)
    state, wall, steps = solve(days * sw.DAY_IN_SECONDS)

    h = state.h.cpu().numpy()
    if not np.isfinite(h).all():
        raise RuntimeError("solution diverged")

    cells = cfg.ny * cfg.nx
    rate = cells * steps / wall if wall > 0 else float("nan")
    print(
        f"steps timed: {steps}, wall: {wall:.3f}s, "
        f"{rate:.3e} cell-updates/s on {where}",
        file=sys.stderr,
    )
    if args.check:
        print("check passed: solution finite", file=sys.stderr)
    return rate


if __name__ == "__main__":
    main()
