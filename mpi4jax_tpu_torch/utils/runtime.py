"""Runtime helpers shared by the solver and the example driver.

Counterpart of ``mpi4jax_tpu/utils/runtime.py``.  ``drain`` becomes a
device synchronize: PyTorch returns before the card has finished, so a
host clock is only meaningful after one.  ``resolve_device`` is the one
place that decides where an entry point runs: on the card unless the
caller asked for the CPU, and never on the CPU by default.
"""

import math

import numpy as np
import torch

__all__ = ["drain", "best_mesh_shape", "resolve_device"]


def drain(x):
    """Block until the device work producing ``x`` has finished.

    Returns the first element of ``x`` as a numpy scalar.
    """
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return np.asarray(x.reshape(-1)[0].item())


def best_mesh_shape(n):
    """Closest-to-square (py, px) with py * px == n and py <= px."""
    best = (1, n)
    for py in range(1, int(math.isqrt(n)) + 1):
        if n % py == 0:
            best = (py, n // py)
    return best


def resolve_device(device):
    """``torch.device`` for an entry point's ``device`` argument.

    A CUDA device that is not there raises: the port's entry points run
    on the card unless the caller passes ``device="cpu"`` explicitly.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device
