"""Reduction operator objects (the MPI.Op equivalents).

Counterpart of ``mpi4jax_tpu/ops/reductions.py``: an :class:`Op` is a
frozen, hashable value object that knows its pairwise ``combine`` (here
on torch tensors) and its identity element per dtype.
:func:`rank_ordered_fold` is the one reduction kernel behind user
operators: a left fold of per-rank rows in rank order.
"""

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "Op",
    "SUM",
    "PROD",
    "MIN",
    "MAX",
    "LAND",
    "LOR",
    "LXOR",
    "BAND",
    "BOR",
    "BXOR",
    "named_op",
    "rank_ordered_fold",
]


@dataclass(frozen=True)
class Op:
    """A reduction operator.

    User-defined operators come from :meth:`Op.create` (the
    ``MPI.Op.Create`` analog).  Two ``create`` calls yield distinct ops
    even with the same name: the combine function takes part in
    equality and hashing.
    """

    name: str
    user_combine: object = None  # callable (a, b) -> c, elementwise
    user_identity: object = None  # scalar identity element, or None
    commute: bool = True

    @classmethod
    def create(cls, combine, *, name="user_op", identity=None, commute=True):
        """Build a user-defined reduction operator.

        ``combine`` must be an associative, elementwise binary function
        on tensors.  ``commute=False`` guarantees rank-order application.
        """
        if not callable(combine):
            raise TypeError("combine must be callable, got " + repr(combine))
        return cls(
            name=name,
            user_combine=combine,
            user_identity=identity,
            commute=commute,
        )

    @property
    def is_user(self):
        return self.user_combine is not None

    def combine(self, a, b):
        if self.is_user:
            return self.user_combine(a, b)
        return _COMBINE[self.name](a, b)

    def identity(self, dtype):
        """Identity element as a 0-d numpy array of numpy ``dtype``."""
        if self.is_user:
            if self.user_identity is None:
                raise ValueError(
                    f"user-defined op {self.name!r} has no identity element"
                )
            return np.asarray(self.user_identity, dtype)
        return _IDENTITY[self.name](dtype)

    def __repr__(self):
        if self.is_user:
            return f"mpi4jax_tpu_torch.Op.create({self.name!r})"
        return f"mpi4jax_tpu_torch.{self.name.upper()}"


_COMBINE = {
    "sum": torch.add,
    "prod": torch.mul,
    "min": torch.minimum,
    "max": torch.maximum,
    "land": torch.logical_and,
    "lor": torch.logical_or,
    "lxor": torch.logical_xor,
    "band": torch.bitwise_and,
    "bor": torch.bitwise_or,
    "bxor": torch.bitwise_xor,
}


def _dtype_min(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return np.array(-np.inf, dtype)
    return np.array(np.iinfo(dtype).min, dtype)


def _dtype_max(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return np.array(np.inf, dtype)
    return np.array(np.iinfo(dtype).max, dtype)


_IDENTITY = {
    "sum": lambda dt: np.zeros((), dt),
    "prod": lambda dt: np.ones((), dt),
    "min": _dtype_max,
    "max": _dtype_min,
    "land": lambda dt: np.array(True),
    "lor": lambda dt: np.array(False),
    "lxor": lambda dt: np.array(False),
    "band": lambda dt: np.array(-1).astype(dt),
    "bor": lambda dt: np.zeros((), dt),
    "bxor": lambda dt: np.zeros((), dt),
}

SUM = Op("sum")
PROD = Op("prod")
MIN = Op("min")
MAX = Op("max")
LAND = Op("land")
LOR = Op("lor")
LXOR = Op("lxor")
BAND = Op("band")
BOR = Op("bor")
BXOR = Op("bxor")

_BY_NAME = {
    op.name: op
    for op in (SUM, PROD, MIN, MAX, LAND, LOR, LXOR, BAND, BOR, BXOR)
}


def named_op(name):
    """Look up an :class:`Op` by name (case-insensitive)."""
    try:
        return _BY_NAME[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown reduction op {name!r}; valid: {sorted(_BY_NAME)}"
        ) from None


def rank_ordered_fold(rows, op, upto=None):
    """Left fold of per-rank operand rows (dim 0, in rank order) with
    ``op.combine``.

    Rank order makes ``commute=False`` safe.  ``upto`` folds only ranks
    ``[0, upto]`` (the inclusive prefix of a scan).  Combines must be
    shape-preserving (checked); a dtype-promoting combine is cast back
    to the buffer dtype, since MPI reductions preserve the datatype.
    """
    n = rows.shape[0] if upto is None else upto + 1
    acc = rows[0]
    for i in range(1, n):
        acc = op.combine(acc, rows[i])
    acc = torch.as_tensor(acc)
    if tuple(acc.shape) != tuple(rows.shape[1:]):
        raise ValueError(
            f"reduction op {op.name!r} combine changed the operand shape "
            f"{tuple(rows.shape[1:])} -> {tuple(acc.shape)}; reduction "
            "combines must be shape-preserving"
        )
    return acc.to(rows.dtype)
