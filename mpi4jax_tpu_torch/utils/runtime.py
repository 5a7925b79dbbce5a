"""Runtime helpers shared by the solver, the decoder and the example
drivers.

Counterpart of ``mpi4jax_tpu/utils/runtime.py``.  ``drain`` becomes a
device synchronize: PyTorch returns before the card has finished, so a
host clock is only meaningful after one.  ``resolve_device`` is the one
place that decides where an entry point runs: on the card unless the
caller asked for the CPU, and never on the CPU by default.
``run_on_side_stream`` and ``graph_capture`` are how the port's
entry points warm up and capture their CUDA graphs; ``release_graphs``
resets the graphs still alive before a world ends
(``parallel/distributed.py:finalize``).  ``slowest`` is how a timing
across ranks agrees: every rank reads the slowest rank's seconds.
"""

import contextlib
import gc
import math
import weakref

import numpy as np
import torch

__all__ = ["drain", "best_mesh_shape", "resolve_device",
           "run_on_side_stream", "graph_capture", "release_graphs",
           "slowest"]

# every graph captured through graph_capture and still referenced
_graphs = weakref.WeakSet()


def drain(x):
    """Block until the device work producing ``x`` has finished.

    Returns the first element of ``x`` as a numpy scalar.
    """
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return np.asarray(x.reshape(-1)[0].item())


def slowest(comm, seconds, device):
    """Each of ``seconds`` (a list of floats) as its largest value over
    the ranks of ``comm`` (a MAX allreduce): the same list on every rank,
    so that decisions taken from it agree.  One rank (or no comm):
    ``seconds``."""
    if comm is None or comm.size == 1:
        return list(seconds)
    from mpi4jax_tpu_torch.ops import reductions
    from mpi4jax_tpu_torch.ops.allreduce import allreduce

    x = torch.tensor(seconds, dtype=torch.float64, device=device)
    out, _ = allreduce(x, reductions.MAX, comm=comm)
    return out.tolist()


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


def run_on_side_stream(fn, device):
    """``fn()`` on a fresh stream of ``device`` ordered after the current
    one, its output (a tensor or a tuple of them) handed back to the
    current stream: the eager first call before a capture."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    for t in out if isinstance(out, tuple) else (out,):
        t.record_stream(current)
    return out


@contextlib.contextmanager
def graph_capture(graph, pool=None, capture_error_mode=None):
    """``torch.cuda.graph(graph, pool=pool)`` with Python's cyclic garbage
    collector held off until the capture ends.  ``capture_error_mode``,
    where given, is ``torch.cuda.graph``'s: ``"thread_local"`` lets other
    threads (NCCL's watchdog) query the device while this one captures.

    PyTorch no longer collects before a capture, so an automatic
    collection could run in the middle of one and free a CUDA graph that a
    dead reference cycle still held (a solver or decoder the caller let
    go: their functions refer to themselves).  Freeing a graph returns its
    memory pool to the device, which a capturing stream refuses, and the
    refused call invalidates the capture in progress."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        mode = ({} if capture_error_mode is None
                else {"capture_error_mode": capture_error_mode})
        with torch.cuda.graph(graph, pool=pool, **mode):
            yield
        _graphs.add(graph)
    finally:
        if enabled:
            gc.enable()


def release_graphs():
    """``reset()`` every CUDA graph captured through :func:`graph_capture`
    that is still alive (its memory and the work it holds, NCCL calls
    included, are let go; a reset graph cannot be replayed); returns how
    many."""
    graphs = list(_graphs)
    for graph in graphs:
        graph.reset()
    _graphs.clear()
    return len(graphs)
