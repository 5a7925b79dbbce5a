"""Multi-process (MPMD) communicators over the native DCN bridge.

The port's counterpart of ``mpi4jax_tpu/parallel/proc.py``: one OS
process per rank, started by ``python -m mpi4jax_tpu_torch.launch``, a
true per-process rank, and the bridge's C++ transport
(``mpi4jax_tpu/native/src/dcn.cc``, ``shm.cc``) underneath.

* :class:`ProcComm`: a group of the job's processes (its world ranks,
  sorted, and a context); ``split`` allows ragged groups.
* :class:`ProcGridComm`: a ProcComm with a Cartesian topology (the
  ``MeshComm`` surface: ``rank_grid``, ``coords_of``, ``shift_perm``,
  ``sub``), so grid code such as the halo exchange runs on it as on a
  mesh.
* :func:`grid_comm` builds one over the world; the world itself is
  :func:`world_comm_if_initialized` (``get_default_comm()`` inside a
  launcher job).

``ProcComm.transport()`` is the bridge-backed ``ProcTransport``
(``ops/_proc.py``), through which every op runs; CUDA tensors are
staged through pinned host memory.
"""

from dataclasses import dataclass
from math import prod

import numpy as np

from mpi4jax_tpu_torch.parallel import comm as _comm
from mpi4jax_tpu_torch.parallel.comm import Comm

__all__ = ["ProcComm", "ProcGridComm", "grid_comm",
           "world_comm_if_initialized"]


@dataclass(frozen=True)
class ProcComm(Comm):
    """A communicator over a group of OS processes (MPMD, static
    ranks): ``ranks`` are the members' world ranks, sorted."""

    ranks: tuple
    context: int = 0

    backend = "proc"

    @property
    def size(self):
        return len(self.ranks)

    def rank(self):
        from mpi4jax_tpu_torch.native import runtime

        return self.ranks.index(runtime.world_rank())

    def clone(self):
        return ProcComm(ranks=self.ranks,
                        context=next(_comm._context_counter))

    def transport(self):
        from mpi4jax_tpu_torch.ops._proc import transport_of

        return transport_of(self)

    def split(self, color, key=None):
        """MPI_Comm_split: ``color`` and ``key`` are functions of the
        comm rank (or sequences), the same on every process.  Unlike a
        mesh's, groups may differ in size: each process joins its own.
        None (MPI_COMM_NULL) where this rank's color is None.  The
        subgroup keeps the parent's context: the wire channel hashes the
        members with it (``native/runtime.py:_stable_ctx``), so the
        members agree without talking."""
        n = self.size
        colors = [color(r) for r in range(n)] if callable(color) \
            else list(color)
        if len(colors) != n:
            raise ValueError(
                f"color must cover all {n} ranks, got {len(colors)}")
        keys = ([key(r) for r in range(n)] if callable(key)
                else (list(key) if key is not None else [0] * n))
        me = self.rank()
        if colors[me] is None:
            return None
        members = sorted((r for r in range(n) if colors[r] == colors[me]),
                         key=lambda r: (keys[r], r))
        return ProcComm(ranks=tuple(self.ranks[r] for r in members),
                        context=self.context)


@dataclass(frozen=True)
class ProcGridComm(ProcComm):
    """A ProcComm with a Cartesian topology (MPI_Cart_create): comm
    ranks are the row-major ravel of the axis coordinates (axis 0
    varies slowest), as on a ``MeshComm``."""

    axes: tuple = ()
    axis_sizes: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "axes", tuple(self.axes))
        object.__setattr__(self, "axis_sizes",
                           tuple(int(s) for s in self.axis_sizes))
        if len(self.axes) != len(self.axis_sizes):
            raise ValueError("axes and axis_sizes must have equal length")
        if prod(self.axis_sizes) != len(self.ranks):
            raise ValueError(
                f"grid {self.axis_sizes} needs {prod(self.axis_sizes)} "
                f"ranks, comm has {len(self.ranks)}")

    def clone(self):
        return ProcGridComm(ranks=self.ranks,
                            context=next(_comm._context_counter),
                            axes=self.axes, axis_sizes=self.axis_sizes)

    def rank_grid(self):
        """ndarray of shape ``axis_sizes`` holding each coordinate's comm
        rank."""
        return np.arange(self.size).reshape(self.axis_sizes)

    def coords_of(self, rank):
        return tuple(int(c) for c in np.unravel_index(rank, self.axis_sizes))

    def shift_perm(self, axis, disp, periodic=True):
        """(source, dest) comm-rank pairs shifting data by ``disp`` along
        ``axis``; a non-periodic shift drops the wrapping pairs, so edge
        ranks receive nothing (MPI_PROC_NULL)."""
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

    def sub(self, *axes):
        """The communicator of this process's slab over ``axes``
        (MPI_Cart_sub): the ranks varying over them with this process's
        other coordinates held.  It keeps the parent's context; the wire
        channel hashes the members, so each row has its own."""
        for a in axes:
            if a not in self.axes:
                raise ValueError(f"axis {a!r} not in {self.axes}")
        coords = dict(zip(self.axes, self.coords_of(self.rank())))
        sizes = tuple(self.axis_sizes[self.axes.index(a)] for a in axes)
        grid = self.rank_grid()
        members = []
        for sub_coord in np.ndindex(*sizes):
            full = tuple(sub_coord[axes.index(a)] if a in axes else coords[a]
                         for a in self.axes)
            members.append(int(grid[full]))
        return ProcGridComm(ranks=tuple(self.ranks[r] for r in members),
                            context=self.context, axes=tuple(axes),
                            axis_sizes=sizes)


def grid_comm(axis_sizes, axes=None, base=None):
    """A :class:`ProcGridComm` over ``base`` (the world by default) with
    the given axis sizes; ``axes`` defaults to ``("y", "x")`` for two,
    ``("axis0", ...)`` otherwise."""
    if base is None:
        base = world_comm_if_initialized()
        if base is None:
            raise RuntimeError(
                "grid_comm: no multi-process world (launch with "
                "python -m mpi4jax_tpu_torch.launch, or pass base=)")
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if axes is None:
        axes = (("y", "x") if len(axis_sizes) == 2
                else tuple(f"axis{i}" for i in range(len(axis_sizes))))
    return ProcGridComm(ranks=tuple(base.ranks), context=base.context,
                        axes=tuple(axes), axis_sizes=axis_sizes)


def world_comm_if_initialized():
    """The world ProcComm once the bridge is up in this process, else
    None.  After an elastic resize the world is the current membership."""
    from mpi4jax_tpu_torch.native import runtime

    if not runtime.is_initialized():
        return None
    alive = runtime.alive_ranks()
    if alive is None:
        alive = tuple(range(runtime.world_size()))
    return ProcComm(ranks=tuple(alive))
