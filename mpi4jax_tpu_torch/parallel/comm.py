"""Communicators: MPI-style (rank, size) groups.

Counterpart of ``mpi4jax_tpu/parallel/comm.py``.  A communicator is a
hashable description of a group of ranks:

* :class:`SelfComm` — the single-process world (size 1); ops are local
  identities.
* :class:`MeshComm` — a Cartesian grid of ranks with named axes, e.g.
  ``("y", "x")``, with the topology helpers the halo exchange needs
  (``sub``, ``rank_grid``, ``shift_perm``).  This slice of the port runs
  one rank: grids larger than 1 need ``torch.distributed`` process
  groups, which are ROADMAP.md Queue 1 item 1 ("Multi-rank comms over
  torch.distributed"), and asking for one raises.

PyTorch runs one process per device, so ``rank()`` is a Python int,
not a traced value as on the JAX mesh backend.
"""

import itertools
import threading
from contextlib import contextmanager
from dataclasses import dataclass, replace
from math import prod

import numpy as np

__all__ = [
    "Comm",
    "MeshComm",
    "SelfComm",
    "get_default_comm",
    "set_default_comm",
    "default_comm",
]

_context_counter = itertools.count(1)

MULTI_RANK_ITEM = (
    "ROADMAP.md Queue 1 item 1 (multi-rank comms over torch.distributed)"
)


class Comm:
    """Abstract communicator. Subclasses must be hashable value objects."""

    backend = None  # "mesh" | "self"

    @property
    def size(self):
        raise NotImplementedError

    def rank(self):
        """This process's rank in the communicator."""
        raise NotImplementedError

    def clone(self):
        """New communicator over the same group with a fresh context id."""
        raise NotImplementedError


@dataclass(frozen=True)
class SelfComm(Comm):
    """The trivial single-member communicator (MPI_COMM_SELF analog)."""

    context: int = 0

    backend = "self"

    @property
    def size(self):
        return 1

    def rank(self):
        return 0

    def clone(self):
        return SelfComm(context=next(_context_counter))


@dataclass(frozen=True)
class MeshComm(Comm):
    """A communicator over the named axes of a Cartesian grid of ranks.

    Ranks are the row-major ravel of the axis coordinates (the first
    axis varies slowest), as on the JAX package's ``MeshComm``.  The
    default is the one-rank ``("y", "x")`` grid that a single-device
    solver runs on.
    """

    axes: tuple = ("y", "x")
    axis_sizes: tuple = (1, 1)
    context: int = 0

    backend = "mesh"

    def __post_init__(self):
        if isinstance(self.axes, str):
            object.__setattr__(self, "axes", (self.axes,))
        object.__setattr__(self, "axes", tuple(self.axes))
        object.__setattr__(
            self, "axis_sizes", tuple(int(s) for s in self.axis_sizes)
        )
        if len(self.axes) != len(self.axis_sizes):
            raise ValueError("axes and axis_sizes must have equal length")
        if prod(self.axis_sizes) != 1:
            raise NotImplementedError(
                f"a {'x'.join(map(str, self.axis_sizes))} grid of ranks "
                f"needs torch.distributed process groups, not yet ported: "
                f"{MULTI_RANK_ITEM}"
            )

    @property
    def size(self):
        return prod(self.axis_sizes)

    def rank(self):
        return 0

    def clone(self):
        return replace(self, context=next(_context_counter))

    def sub(self, *axes):
        """Sub-communicator over a subset of axes (MPI_Cart_sub analog).

        On a ``("y", "x")`` comm, ``comm.sub("x")`` is the row
        communicator.  Keeps the context id, so a sub-communicator of a
        clone stays in the clone's message namespace.
        """
        for a in axes:
            if a not in self.axes:
                raise ValueError(f"axis {a!r} not in {self.axes}")
        sizes = tuple(self.axis_sizes[self.axes.index(a)] for a in axes)
        return MeshComm(axes=tuple(axes), axis_sizes=sizes,
                        context=self.context)

    # -- topology helpers -------------------------------------------------

    def rank_grid(self):
        """ndarray of shape ``axis_sizes`` holding each coordinate's rank."""
        return np.arange(self.size).reshape(self.axis_sizes)

    def coords_of(self, rank):
        """Inverse of the rank ravel: rank -> axis coordinates."""
        return tuple(int(c) for c in np.unravel_index(rank, self.axis_sizes))

    def shift_perm(self, axis, disp, periodic=True):
        """(source, dest) pairs shifting data by ``disp`` along ``axis``.

        Each rank's data moves to the rank whose coordinate along
        ``axis`` is ``disp`` greater (mod the axis size if ``periodic``).
        Non-periodic shifts drop the wrapping pairs, so edge ranks
        receive nothing: sendrecv then returns their recv buffer
        unchanged (MPI_PROC_NULL semantics).
        """
        ax = self.axes.index(axis)
        n = self.axis_sizes[ax]
        grid = self.rank_grid()
        pairs = []
        for src_coord in np.ndindex(*self.axis_sizes):
            dst_coord = list(src_coord)
            d = src_coord[ax] + disp
            if periodic:
                dst_coord[ax] = d % n
            elif 0 <= d < n:
                dst_coord[ax] = d
            else:
                continue
            pairs.append((int(grid[src_coord]), int(grid[tuple(dst_coord)])))
        return pairs


class _DefaultCommState(threading.local):
    def __init__(self):
        self.comm = None


_default = _DefaultCommState()
_WORLD_SELF = SelfComm()


def get_default_comm():
    """The ambient communicator used when ops get ``comm=None``: the
    single-process world unless one was set."""
    if _default.comm is not None:
        return _default.comm
    return _WORLD_SELF


def set_default_comm(comm):
    _default.comm = comm


@contextmanager
def default_comm(comm):
    """Context manager scoping the default communicator."""
    prev = _default.comm
    _default.comm = comm
    try:
        yield comm
    finally:
        _default.comm = prev
