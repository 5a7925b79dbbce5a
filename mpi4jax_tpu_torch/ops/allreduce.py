"""allreduce — differentiable all-reduce over a communicator.

Counterpart of ``mpi4jax_tpu/ops/allreduce.py`` with the same autodiff
convention: for ``op=SUM`` the gradient is the identity (the cotangent
of a replicated result is already replicated), and non-SUM ops are not
differentiable.  Here that rule is a ``torch.autograd.Function``.

This slice of the port runs one rank (``SelfComm`` or a one-rank
``MeshComm``), where reducing over the ranks is the identity for every
operator.
"""

import torch

from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops._core import as_token, publishes_token
from mpi4jax_tpu_torch.utils.validation import check_comm, check_op

__all__ = ["allreduce"]


def _reduce_one_rank(x, op):
    """The reduction over a one-rank communicator: a left fold of the
    single row (the identity, through the user operator's cast rules)."""
    return reductions.rank_ordered_fold(x[None], op).clone()


class _AllreduceFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return _reduce_one_rank(x, op)

    @staticmethod
    def backward(ctx, grad):
        if ctx.op.name != "sum" or ctx.op.is_user:
            raise NotImplementedError(
                "the gradient of allreduce is only defined for op=SUM"
            )
        return grad, None


@publishes_token
def allreduce(x, op=reductions.SUM, *, comm=None, token=None):
    """All-reduce ``x`` with ``op`` across ``comm``.

    Returns ``(result, token)``.  Differentiable for ``op=SUM``.
    """
    op = check_op(op)
    comm = check_comm(comm)
    token = as_token(token)
    del comm  # every communicator of this slice has one rank
    return _AllreduceFn.apply(torch.as_tensor(x), op), token
