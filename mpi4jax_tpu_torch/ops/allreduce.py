"""allreduce — differentiable all-reduce over a communicator.

Counterpart of ``mpi4jax_tpu/ops/allreduce.py`` with the same autodiff
convention: for ``op=SUM`` the gradient is the identity (the cotangent
of a replicated result is already replicated), and non-SUM ops are not
differentiable.  Here that rule is a ``torch.autograd.Function``.

Across ranks, SUM, PROD, MIN and MAX on float32/float64/int32/int64 are
the backend's own reductions (gloo also takes BAND, BOR and BXOR on
integers); every other operator and dtype (LAND, LOR, LXOR, user ops,
bool, NCCL's missing bitwise ops) gathers the rows and folds them in
rank order with ``rank_ordered_fold``, as the JAX package folds a user
operator.  A native float SUM or PROD adds in the backend's order, not
in rank order, so it may differ from the fold in the last bits; integer,
bool, MIN and MAX results are exact.  On one rank the reduction is a
fold of the single row.
"""

import torch

from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops._core import as_token, publishes_token
from mpi4jax_tpu_torch.utils.validation import check_comm, check_op

__all__ = ["allreduce"]


def _reduce(x, op, comm):
    if comm.size == 1:
        return reductions.rank_ordered_fold(x[None], op).clone()
    transport = comm.transport()
    native = transport.native_op(op, x.dtype)
    if native is not None:
        return transport.allreduce(x, native)
    return reductions.rank_ordered_fold(transport.allgather(x), op)


class _AllreduceFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, comm):
        ctx.op = op
        return _reduce(x, op, comm)

    @staticmethod
    def backward(ctx, grad):
        if ctx.op.name != "sum" or ctx.op.is_user:
            raise NotImplementedError(
                "the gradient of allreduce is only defined for op=SUM"
            )
        return grad, None, None


@publishes_token
def allreduce(x, op=reductions.SUM, *, comm=None, token=None):
    """All-reduce ``x`` with ``op`` across ``comm``.

    Returns ``(result, token)``.  Differentiable for ``op=SUM``.
    """
    op = check_op(op)
    comm = check_comm(comm)
    token = as_token(token)
    return _AllreduceFn.apply(torch.as_tensor(x), op, comm), token
