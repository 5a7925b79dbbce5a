"""Collective ops: allgather and scan.

Counterpart of the two ops of ``mpi4jax_tpu/ops/collectives.py`` that
the shallow-water solver uses: ``scan`` builds the initial state's
geostrophic prefix sum along y and ``allgather`` reassembles the global
field.  On the one-rank communicators of this slice, ``allgather``
stacks the single contribution and the inclusive prefix is the input.
"""

import torch

from mpi4jax_tpu_torch.ops._core import as_token, publishes_token
from mpi4jax_tpu_torch.ops.reductions import rank_ordered_fold
from mpi4jax_tpu_torch.utils.validation import check_comm, check_op

__all__ = ["allgather", "scan"]


@publishes_token
def allgather(x, *, comm=None, token=None):
    """Gather ``x`` from every rank onto every rank.

    Output shape is ``(comm.size, *x.shape)``.
    """
    comm = check_comm(comm)
    token = as_token(token)
    x = torch.as_tensor(x)
    return x[None].clone(), token


@publishes_token
def scan(x, op, *, comm=None, token=None):
    """Inclusive prefix reduction over ranks (MPI_Scan): rank ``r``
    gets the fold of ranks ``0..r`` in rank order."""
    comm = check_comm(comm)
    token = as_token(token)
    op = check_op(op)
    x = torch.as_tensor(x)
    rows = x[None]
    return rank_ordered_fold(rows, op, upto=comm.rank()).clone(), token
