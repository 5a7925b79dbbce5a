"""allreduce — differentiable all-reduce over a communicator.

Counterpart of ``mpi4jax_tpu/ops/allreduce.py`` with the same autodiff
convention: for ``op=SUM`` the gradient is the identity (the cotangent
of a replicated result is already replicated), the tangent is the
allreduce of the tangent, issued after the primal's, and non-SUM ops
are not differentiable.  Here those rules are a
``torch.autograd.Function`` in the ``setup_context`` style, so the op
also runs under ``torch.autograd.forward_ad`` and ``torch.func``
(``vmap`` reduces the whole batched tensor once, as the JAX package's
batching rule passes the batch dimension through).

Across ranks, SUM, PROD, MIN and MAX on float32/float64/int32/int64 are
the backend's own reductions (gloo also takes BAND, BOR and BXOR on
integers); every other operator and dtype (LAND, LOR, LXOR, user ops,
bool, NCCL's missing bitwise ops) gathers the rows and folds them in
rank order with ``rank_ordered_fold``, as the JAX package folds a user
operator.  A native float SUM or PROD adds in the backend's order, not
in rank order, so it may differ from the fold in the last bits; integer,
bool, MIN and MAX results are exact.  On one rank the reduction is a
fold of the single row.

Collective backward and tangent rules run only on the ranks whose loss
reaches them: every rank must take its backward (and its forward-mode
tangents) through the same collectives in the same order, as with
``torch.distributed.nn``.  A rank that skips one leaves the others
waiting until their group's timeout.
"""

import torch

from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops._core import as_token, publishes_token
from mpi4jax_tpu_torch.utils.validation import check_comm, check_op

__all__ = ["allreduce"]


def require_sum(op, name):
    """The JAX package's rule: only SUM has a derivative (raise, never a
    silent zero, for every other operator and user ops)."""
    if op.name != "sum" or op.is_user:
        raise NotImplementedError(
            f"the gradient of {name} is only defined for op=SUM"
        )


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
    def forward(x, op, comm):
        return _reduce(x, op, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.op, ctx.comm = inputs

    @staticmethod
    def backward(ctx, grad):
        require_sum(ctx.op, "allreduce")
        return grad, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        require_sum(ctx.op, "allreduce")
        return _AllreduceFn.apply(tangent, ctx.op, ctx.comm)

    @staticmethod
    def vmap(info, in_dims, x, op, comm):
        return _AllreduceFn.apply(x, op, comm), in_dims[0]


@publishes_token
def allreduce(x, op=reductions.SUM, *, comm=None, token=None):
    """All-reduce ``x`` with ``op`` across ``comm``.

    Returns ``(result, token)``.  Differentiable for ``op=SUM``.
    """
    op = check_op(op)
    comm = check_comm(comm)
    token = as_token(token)
    return _AllreduceFn.apply(torch.as_tensor(x), op, comm), token
