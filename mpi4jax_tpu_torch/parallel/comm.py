"""Communicators: MPI-style (rank, size) groups.

Counterpart of ``mpi4jax_tpu/parallel/comm.py``.  A communicator is a
hashable description of a group of ranks:

* :class:`SelfComm` — the single-process world (size 1); ops are local
  identities.
* :class:`MeshComm` — a Cartesian grid of ranks with named axes, e.g.
  ``("y", "x")``, with the topology helpers the halo exchange needs
  (``sub``, ``split``, ``rank_grid``, ``shift_perm``).
* ``ProcComm`` / ``ProcGridComm`` (``parallel/proc.py``) — the OS
  processes of a launcher job over the native bridge.

PyTorch runs one rank per process (or, in a local world, per thread), so
``rank()`` is a Python int, not a traced value as on the JAX mesh
backend.  A grid of more than one rank lives in a world of ranks
(``parallel/distributed.py``): ``world_comm`` over ``torch.distributed``
after ``initialize()`` (one process per card, NCCL; or gloo on the CPU),
or ``local_world`` (ranks as threads of one process, gloo).  The world
is held by the comm but kept out of equality and hashing, as the JAX
comm keeps its ``mesh`` out.  A one-rank grid needs no world: every
single-device caller passes ``MeshComm()``.

A comm with a world carries ``instances``: the world ranks of every copy
of its grid, one tuple per copy in grid-rank order.  The world comm has
one copy; ``sub("x")`` of a ("y", "x") grid has one copy per row.  Every
rank derives the same instances, split groups and context for a comm, so
each group's process group is the same object description on all of
its members (``World.transport``).
"""

import itertools
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field, replace
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


class Comm:
    """Abstract communicator. Subclasses must be hashable value objects."""

    backend = None  # "mesh" | "self" | "proc"

    @property
    def size(self):
        raise NotImplementedError

    def rank(self):
        """This process's rank in the communicator."""
        raise NotImplementedError

    def clone(self):
        """New communicator over the same group with a fresh context id."""
        raise NotImplementedError

    def transport(self):
        """The process group behind a communicator of several ranks
        (``parallel/distributed.py:Transport``); None for one rank."""
        return None


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

    def split(self, color, key=None):
        """MPI_Comm_split on a size-1 world: the only member keeps a
        size-1 communicator (None color -> MPI_COMM_NULL -> None)."""
        colors = [color(0)] if callable(color) else (
            [color] if isinstance(color, int) or color is None else list(color)
        )
        if len(colors) != 1:
            raise ValueError(f"color must cover all 1 ranks, got {len(colors)}")
        if colors[0] is None:
            return None
        return self.clone()


@dataclass(frozen=True)
class MeshComm(Comm):
    """A communicator over the named axes of a Cartesian grid of ranks.

    Ranks are the row-major ravel of the axis coordinates (the first
    axis varies slowest), as on the JAX package's ``MeshComm``.  The
    default is the one-rank ``("y", "x")`` grid that a single-device
    solver runs on.  ``groups`` is the result of :meth:`split`: a
    partition of the grid's ranks into equal-size subgroups, in which
    this rank's comm rank is its position within its own group.
    """

    axes: tuple = ("y", "x")
    axis_sizes: tuple = (1, 1)
    context: int = 0
    groups: tuple = None
    world: object = field(default=None, compare=False, repr=False)
    instances: tuple = field(default=None, compare=False, repr=False)

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
        if self.world is None:
            if self.global_size != 1:
                raise ValueError(
                    f"a {'x'.join(map(str, self.axis_sizes))} grid of ranks "
                    "needs a world of ranks: build its comm with "
                    "distributed.world_comm (one process per device, after "
                    "distributed.initialize) or inside "
                    "distributed.local_world (ranks as threads)"
                )
            return
        if self.instances is None:
            if self.global_size != self.world.size:
                raise ValueError(
                    f"a {'x'.join(map(str, self.axis_sizes))} grid does not "
                    f"cover the world's {self.world.size} ranks"
                )
            object.__setattr__(
                self, "instances", (tuple(range(self.world.size)),)
            )
        # build (or find) this comm's process group now: every rank
        # derives the comm at the same point of its program, so every
        # member creates the group in the same order
        self.transport()

    @property
    def size(self):
        if self.groups is not None:
            return len(self.groups[0])
        return prod(self.axis_sizes)

    @property
    def global_size(self):
        """Ranks across the member axes (== size unless split)."""
        return prod(self.axis_sizes)

    def _partition(self):
        """Every group of this comm, as tuples of world ranks in comm-rank
        order: each copy of the grid, split by ``groups``."""
        groups = self.groups or (tuple(range(self.global_size)),)
        return tuple(
            tuple(inst[i] for i in g) for inst in self.instances for g in groups
        )

    def transport(self):
        if self.world is None:
            return None
        cached = self.__dict__.get("_transport")
        if cached is None:
            cached = self.world.transport(self._partition(), self.context)
            object.__setattr__(self, "_transport", cached)
        return cached

    def rank(self):
        t = self.transport()
        return 0 if t is None else t.rank

    def group_id(self):
        """Index of this rank's subgroup among its grid's split groups
        (0 when the comm is not split)."""
        if self.groups is None or self.world is None:
            return 0
        me = self.world.rank
        for inst in self.instances:
            for j, g in enumerate(self.groups):
                if any(inst[i] == me for i in g):
                    return j
        raise AssertionError("rank not in its comm's partition")

    def clone(self):
        """Same group, fresh context (MPI_Comm_dup): collective on a
        world, whose ranks number their clones alike."""
        if self.world is None:
            return replace(self, context=next(_context_counter))
        return replace(self, context=self.world.next_context())

    def split(self, color, key=None):
        """Partition the communicator (MPI_Comm_split analog), as the JAX
        package's ``MeshComm.split``.

        ``color`` and ``key`` are functions of the communicator rank (or
        length-``size`` sequences), the same on every rank.  Members with
        equal color form a subgroup, ordered by (key, rank); subgroups
        must be equal-sized.  A color of None drops the rank from every
        subgroup (MPI_UNDEFINED); such ranks are packed into equal-size
        groups of their own.  Splitting a split communicator partitions
        within each existing subgroup.
        """
        n = self.size
        colors = [color(r) for r in range(n)] if callable(color) else list(color)
        if len(colors) != n:
            raise ValueError(
                f"color must cover all {n} ranks, got {len(colors)}"
            )
        keys = (
            [key(r) for r in range(n)]
            if callable(key)
            else (list(key) if key is not None else [0] * n)
        )
        if len(keys) != n:
            raise ValueError(f"key must cover all {n} ranks, got {len(keys)}")
        by_color = {}
        dropped = []
        for r, c in enumerate(colors):
            if c is None:
                dropped.append(r)
            else:
                by_color.setdefault(c, []).append(r)
        local_groups = [
            tuple(sorted(members, key=lambda r: (keys[r], r)))
            for _, members in sorted(by_color.items())
        ]
        sizes = {len(g) for g in local_groups}
        if len(sizes) > 1:
            raise ValueError(
                f"split requires equal-size subgroups, got sizes "
                f"{sorted(len(g) for g in local_groups)}"
            )
        if dropped:
            gsize = len(local_groups[0]) if local_groups else len(dropped)
            if len(dropped) % gsize:
                raise ValueError(
                    f"{len(dropped)} ranks have color None but subgroups "
                    f"have size {gsize}; dropped ranks must also pack into "
                    "equal-size groups"
                )
            for i in range(0, len(dropped), gsize):
                local_groups.append(tuple(dropped[i : i + gsize]))
        parents = (
            self.groups
            if self.groups is not None
            else (tuple(range(self.global_size)),)
        )
        groups = tuple(
            tuple(p[i] for i in lg) for p in parents for lg in local_groups
        )
        return replace(self, groups=groups)

    def expand_perm(self, pairs):
        """Map (source, dest) pairs in comm-rank space to grid ranks, one
        copy per split group (identity when the comm is not split)."""
        if self.groups is None:
            return list(pairs)
        return [(g[s], g[d]) for g in self.groups for s, d in pairs]

    def sub(self, *axes):
        """Sub-communicator over a subset of axes (MPI_Cart_sub analog).

        On a ``("y", "x")`` comm, ``comm.sub("x")`` is the row
        communicator.  Keeps the context id, so a sub-communicator of a
        clone stays in the clone's message namespace.
        """
        if self.groups is not None:
            raise ValueError(
                "cannot take an axis sub-communicator of a split "
                "communicator; split from the parent comm instead"
            )
        for a in axes:
            if a not in self.axes:
                raise ValueError(f"axis {a!r} not in {self.axes}")
        cache = self.__dict__.setdefault("_subs", {})
        if axes in cache:
            return cache[axes]
        sizes = tuple(self.axis_sizes[self.axes.index(a)] for a in axes)
        instances = None
        if self.world is not None:
            # each copy of the grid, its chosen axes moved last in the
            # order given: every row of the result is one copy of the sub
            keep = [self.axes.index(a) for a in axes]
            rest = [i for i in range(len(self.axes)) if i not in keep]
            instances = tuple(
                tuple(int(r) for r in row)
                for inst in self.instances
                for row in np.asarray(inst)
                .reshape(self.axis_sizes)
                .transpose(rest + keep)
                .reshape(-1, prod(sizes))
            )
        sub = MeshComm(axes=tuple(axes), axis_sizes=sizes,
                       context=self.context, world=self.world,
                       instances=instances)
        cache[axes] = sub
        return sub

    # -- topology helpers -------------------------------------------------

    def rank_grid(self):
        """ndarray of shape ``axis_sizes`` holding each coordinate's rank."""
        return np.arange(self.global_size).reshape(self.axis_sizes)

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
        if self.groups is not None:
            raise ValueError(
                "a split communicator has no Cartesian topology; pass an "
                "explicit rank->partner callable or (source, dest) pairs"
            )
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
    """The ambient communicator used when ops get ``comm=None``: the one
    set (per thread, so that each rank of a local world has its own),
    else the proc world once the native bridge is up in this process (a
    rank of ``python -m mpi4jax_tpu_torch.launch``), else the
    single-process world."""
    if _default.comm is not None:
        return _default.comm
    from mpi4jax_tpu_torch.parallel import proc

    world = proc.world_comm_if_initialized()
    return world if world is not None else _WORLD_SELF


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
