"""Collective ops: allgather, scan and barrier.

Counterpart of the ops of ``mpi4jax_tpu/ops/collectives.py`` that the
shallow-water solver and the split tests use: ``scan`` builds the
initial state's geostrophic prefix sum along y, ``allgather``
reassembles the global field, ``barrier`` synchronises the ranks.  On a
one-rank communicator ``allgather`` stacks the single contribution and
the inclusive prefix is the input.  Across ranks ``scan`` gathers the
rows and folds ranks ``0..rank`` in rank order, exactly as a user
operator folds.

The other collectives of the JAX package (``alltoall``,
``alltoall_multi``, ``bcast``, ``gather``, ``reduce``,
``reduce_scatter``, ``scatter``) are not ported yet: this module's
stand-ins raise naming :data:`COLLECTIVES_ITEM`, and the package does
not export them.
"""

import torch

from mpi4jax_tpu_torch.ops._core import as_token, publishes_token
from mpi4jax_tpu_torch.ops.reductions import rank_ordered_fold
from mpi4jax_tpu_torch.utils.validation import check_comm, check_op

__all__ = ["allgather", "scan", "barrier", "alltoall", "alltoall_multi",
           "bcast", "gather", "reduce", "reduce_scatter", "scatter",
           "COLLECTIVES_ITEM"]

COLLECTIVES_ITEM = "ROADMAP.md Queue 1 item 6 (the other collectives)"


def _rows(x, comm):
    """``(comm.size, *x.shape)``: every rank's ``x`` in rank order."""
    if comm.size == 1:
        return x[None].clone()
    return comm.transport().allgather(x)


@publishes_token
def allgather(x, *, comm=None, token=None):
    """Gather ``x`` from every rank onto every rank.

    Output shape is ``(comm.size, *x.shape)``.
    """
    comm = check_comm(comm)
    token = as_token(token)
    return _rows(torch.as_tensor(x), comm), token


@publishes_token
def scan(x, op, *, comm=None, token=None):
    """Inclusive prefix reduction over ranks (MPI_Scan): rank ``r``
    gets the fold of ranks ``0..r`` in rank order."""
    comm = check_comm(comm)
    token = as_token(token)
    op = check_op(op)
    rows = _rows(torch.as_tensor(x), comm)
    return rank_ordered_fold(rows, op, upto=comm.rank()).clone(), token


@publishes_token
def barrier(*, comm=None, token=None):
    """Synchronisation barrier; returns only a token.  Over gloo every
    rank waits for all; over NCCL, as on the JAX mesh backend, the
    barrier is a reduction ordered into the device stream."""
    comm = check_comm(comm)
    token = as_token(token)
    if comm.size > 1:
        comm.transport().barrier()
    return token


def _not_ported(name):
    def op(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to PyTorch yet: {COLLECTIVES_ITEM}"
        )

    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"The JAX package's ``{name}``; raises: {COLLECTIVES_ITEM}."
    return op


alltoall = _not_ported("alltoall")
alltoall_multi = _not_ported("alltoall_multi")
bcast = _not_ported("bcast")
gather = _not_ported("gather")
reduce = _not_ported("reduce")
reduce_scatter = _not_ported("reduce_scatter")
scatter = _not_ported("scatter")
