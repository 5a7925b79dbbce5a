"""Collective ops: allgather, alltoall, alltoall_multi, barrier, bcast,
gather, reduce, reduce_scatter, scan and scatter.

Counterpart of ``mpi4jax_tpu/ops/collectives.py``, with its call surface
(``comm=``, ``token=``, ``(result, token)``), its checks and their
wording.  Each op runs on the comm's process group (``Transport``,
``parallel/distributed.py``): the backend's own ``broadcast``,
``gather``, ``scatter``, ``reduce``, ``reduce_scatter`` and
``all_to_all``, gloo and NCCL alike; on a proc comm, the native
bridge's calls (``ops/_proc.py``: every built-in operator, ``scan``
included, is the bridge's).  A reduction the backend does not
compute (``Transport.native_op``: user operators, LAND/LOR/LXOR, bool,
sub-32-bit dtypes) moves the rows instead (``gather`` to the root,
``alltoall`` for ``reduce_scatter``, ``allgather`` for ``scan``) and
folds them in rank order, so ``commute=False`` operators hold.  bool
travels as uint8 and every dtype keeps its own.

The rooted ops keep the JAX package's multi-process (MPMD) contract,
one rank per process as in MPI (``mpi4jax_tpu/ops/_proc.py``):

* ``gather``: ``(size, *x.shape)`` on the root, the input elsewhere;
* ``reduce``: the reduction on the root, the input elsewhere;
* ``scatter``: the root passes ``(size, *rest)``; another rank passes a
  ``rest``-shaped template or, as on the JAX mesh backend, the full
  ``(size, *rest)`` array, whose values are ignored (a template whose
  leading dimension is ``comm.size`` is read as the full form; on a proc
  comm, as on the JAX proc backend, it is always a template); every
  rank gets ``rest``;
* ``bcast``: the root's value everywhere.

On one rank every op is what the JAX package's ``self`` backend does
(``gather`` is ``allgather``, ``reduce`` is ``allreduce``).

Autodiff follows the JAX package's mesh rules, as
``torch.autograd.Function``s in the ``setup_context`` style with a
backward, a forward-mode ``jvp`` (the same collective on the tangent,
issued after the primal's) and a ``vmap`` rule (the collective once on
the whole batched tensor, the batch dimension moved behind the rank
axis where the op has one): ``allgather`` transposes to a SUM
``reduce_scatter`` and back, ``alltoall`` to itself, ``bcast`` to a SUM
``reduce`` to the root (zero elsewhere), ``scatter`` to a ``gather`` of
the cotangents to the root (zero elsewhere), ``scan`` SUM to the
``reduce_scatter`` of its prefix.  Non-SUM and user operators of
``reduce_scatter`` and ``scan`` raise, never a silent zero, and so do
``gather`` and ``reduce`` across ranks: the JAX package defines no
multi-process rule for them.  A backward collective runs only on the
ranks whose loss reaches it, so every rank must take its backward
through the same collectives in the same order (as with
``torch.distributed.nn``); a rank that skips one leaves the others
waiting until their group's timeout.
"""

import torch

from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops._core import as_token, publishes_token
from mpi4jax_tpu_torch.ops.allreduce import allreduce, require_sum
from mpi4jax_tpu_torch.utils.validation import check_comm, check_op, check_root

__all__ = ["allgather", "alltoall", "alltoall_multi", "barrier", "bcast",
           "gather", "reduce", "reduce_scatter", "scan", "scatter"]


def _prologue(x, comm, token):
    return torch.as_tensor(x), check_comm(comm), as_token(token)


def _check_rows(x, comm, name):
    if x.dim() == 0 or x.shape[0] != comm.size:
        raise ValueError(
            f"{name} input must have shape (nproc, ...) with nproc == "
            f"comm.size={comm.size}, got shape {tuple(x.shape)}"
        )


def _no_mpmd_rule(name):
    return NotImplementedError(
        f"{name} across ranks is not differentiable: its result has a "
        f"rank-dependent shape, and the JAX package defines no derivative "
        f"for its multi-process {name} either (all{name} has one)"
    )


# -- the autodiff rules ----------------------------------------------------


class _AllgatherFn(torch.autograd.Function):
    @staticmethod
    def forward(x, comm):
        return comm.transport().allgather(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceScatterFn.apply(grad, reductions.SUM, ctx.comm), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return _AllgatherFn.apply(tangent, ctx.comm)

    @staticmethod
    def vmap(info, in_dims, x, comm):
        return _AllgatherFn.apply(x, comm), in_dims[0] + 1


class _ReduceScatterFn(torch.autograd.Function):
    @staticmethod
    def forward(x, op, comm):
        transport = comm.transport()
        native = transport.native_op(op, x.dtype)
        if native is not None:
            return transport.reduce_scatter(x, native)
        # row p of the exchange came from comm rank p: a rank-ordered fold
        return reductions.rank_ordered_fold(transport.alltoall(x), op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.op, ctx.comm = inputs

    @staticmethod
    def backward(ctx, grad):
        require_sum(ctx.op, "reduce_scatter")
        return _AllgatherFn.apply(grad, ctx.comm), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        require_sum(ctx.op, "reduce_scatter")
        return _ReduceScatterFn.apply(tangent, ctx.op, ctx.comm)

    @staticmethod
    def vmap(info, in_dims, x, op, comm):
        return _ReduceScatterFn.apply(x.movedim(in_dims[0], 1), op, comm), 0


class _AlltoallFn(torch.autograd.Function):
    @staticmethod
    def forward(x, comm):
        return comm.transport().alltoall(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _AlltoallFn.apply(grad, ctx.comm), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return _AlltoallFn.apply(tangent, ctx.comm)

    @staticmethod
    def vmap(info, in_dims, x, comm):
        return _AlltoallFn.apply(x.movedim(in_dims[0], 1), comm), 1


class _AlltoallFusedFn(torch.autograd.Function):
    """``alltoall_multi`` in one fused frame a peer (a proc comm): each
    part moves as one :func:`alltoall` would, so the transpose is the
    fused exchange of the cotangents."""

    @staticmethod
    def forward(comm, *parts):
        return tuple(comm.transport().alltoall_fused(list(parts)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm = inputs[0]

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_AlltoallFusedFn.apply(ctx.comm, *grads))

    @staticmethod
    def jvp(ctx, _comm, *tangents):
        return _AlltoallFusedFn.apply(ctx.comm, *tangents)

    @staticmethod
    def vmap(info, in_dims, comm, *parts):
        parts = [p.movedim(d, 1) if d is not None
                 else p.unsqueeze(1).expand(p.shape[0], info.batch_size,
                                            *p.shape[1:])
                 for p, d in zip(parts, in_dims[1:])]
        out = _AlltoallFusedFn.apply(comm, *parts)
        return out, (1,) * len(out)


class _ScanFn(torch.autograd.Function):
    @staticmethod
    def forward(x, op, comm):
        transport = comm.transport()
        native = (transport.native_op(op, x.dtype) if transport.has_scan
                  else None)
        if native is not None:
            return transport.scan(x, native)
        rows = transport.allgather(x)
        return reductions.rank_ordered_fold(rows, op, upto=comm.rank())

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.op, ctx.comm = inputs

    @staticmethod
    def backward(ctx, grad):
        # rank r's prefix holds ranks 0..r: its cotangent goes to those
        # rows, and the reduce-scatter sums each row's over the ranks
        require_sum(ctx.op, "scan")
        r, n = ctx.comm.rank(), ctx.comm.size
        rows = torch.cat([grad.expand(r + 1, *grad.shape),
                          grad.new_zeros((n - r - 1, *grad.shape))])
        return _ReduceScatterFn.apply(rows, reductions.SUM, ctx.comm), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        require_sum(ctx.op, "scan")
        return _ScanFn.apply(tangent, ctx.op, ctx.comm)

    @staticmethod
    def vmap(info, in_dims, x, op, comm):
        return _ScanFn.apply(x, op, comm), in_dims[0]


class _BcastFn(torch.autograd.Function):
    @staticmethod
    def forward(x, root, comm):
        return comm.transport().broadcast(x, root)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.root, ctx.comm = inputs

    @staticmethod
    def backward(ctx, grad):
        # the root's value reached every rank: it gets the sum of their
        # cotangents, the other ranks' inputs none
        total = _ReduceFn.apply(grad, reductions.SUM, ctx.root, ctx.comm)
        if ctx.comm.rank() != ctx.root:
            total = torch.zeros_like(grad)
        return total, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _BcastFn.apply(tangent, ctx.root, ctx.comm)

    @staticmethod
    def vmap(info, in_dims, x, root, comm):
        return _BcastFn.apply(x, root, comm), in_dims[0]


class _ScatterFn(torch.autograd.Function):
    """``full``: this rank's ``x`` has the rank axis (always on the
    root); otherwise it is a template of the result."""

    @staticmethod
    def forward(x, root, comm, full):
        shape = x.shape[1:] if full else x.shape
        return comm.transport().scatter(x, root, shape, x.dtype, x.device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.root, ctx.comm, ctx.full = inputs
        ctx.in_shape = x.shape

    @staticmethod
    def backward(ctx, grad):
        rows = _GatherFn.apply(grad, ctx.root, ctx.comm)
        if ctx.comm.rank() != ctx.root:
            rows = grad.new_zeros(ctx.in_shape)
        return rows, None, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return _ScatterFn.apply(tangent, ctx.root, ctx.comm, ctx.full)

    @staticmethod
    def vmap(info, in_dims, x, root, comm, full):
        x = x.movedim(in_dims[0], 1 if full else 0)
        return _ScatterFn.apply(x, root, comm, full), 0


class _GatherFn(torch.autograd.Function):
    @staticmethod
    def forward(x, root, comm):
        rows = comm.transport().gather(x, root)
        return x if rows is None else rows

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise _no_mpmd_rule("gather")

    @staticmethod
    def jvp(ctx, *_):
        raise _no_mpmd_rule("gather")

    @staticmethod
    def vmap(info, in_dims, x, root, comm):
        root_dim = in_dims[0] + (comm.rank() == root)
        return _GatherFn.apply(x, root, comm), root_dim


class _ReduceFn(torch.autograd.Function):
    @staticmethod
    def forward(x, op, root, comm):
        transport = comm.transport()
        native = transport.native_op(op, x.dtype)
        if native is not None:
            y = transport.reduce(x, native, root)
        else:
            rows = transport.gather(x, root)
            y = None if rows is None else reductions.rank_ordered_fold(rows, op)
        return x if y is None else y

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise _no_mpmd_rule("reduce")

    @staticmethod
    def jvp(ctx, *_):
        raise _no_mpmd_rule("reduce")

    @staticmethod
    def vmap(info, in_dims, x, op, root, comm):
        return _ReduceFn.apply(x, op, root, comm), in_dims[0]


# -- the ops ---------------------------------------------------------------


@publishes_token
def allgather(x, *, comm=None, token=None):
    """Gather ``x`` from every rank onto every rank.

    Output shape is ``(comm.size, *x.shape)``.  Differentiable: the
    cotangent rows are summed over the ranks, row ``r`` to rank ``r``.
    """
    x, comm, token = _prologue(x, comm, token)
    if comm.size == 1:
        return x[None].clone(), token
    return _AllgatherFn.apply(x, comm), token


@publishes_token
def alltoall(x, *, comm=None, token=None):
    """All-to-all block exchange.

    ``x`` must have leading dimension ``comm.size``; output row ``j`` is
    rank ``j``'s row ``rank``.  Differentiable (its transpose is itself).
    """
    x, comm, token = _prologue(x, comm, token)
    _check_rows(x, comm, "alltoall")
    if comm.size == 1:
        return x.clone(), token
    return _AlltoallFn.apply(x, comm), token


@publishes_token
def alltoall_multi(parts, *, comm=None, token=None, coalesce=None):
    """Several independent alltoalls at once: the results of one
    :func:`alltoall` per part, every part checked before any moves.

    On a proc comm with more than one part, each peer gets one fused
    wire frame with its slice of every part when ``coalesce`` is True,
    or, with ``coalesce`` unset, when ``coalesce_eligible`` says so for
    the per-peer payload (``T4J_COALESCE_BYTES``).  Other backends run
    one :func:`alltoall` a part.  Returns ``(outs, token)``.
    """
    comm = check_comm(comm)
    token = as_token(token)
    parts = [torch.as_tensor(p) for p in parts]
    for p in parts:
        _check_rows(p, comm, "alltoall")
    if comm.backend == "proc" and len(parts) > 1:
        if isinstance(coalesce, bool):
            fuse = coalesce
        else:
            from mpi4jax_tpu_torch import tuning

            per_peer = sum(p.numel() * p.element_size() // comm.size
                           for p in parts)
            fuse = tuning.coalesce_eligible(per_peer, len(parts))
        if fuse:
            return list(_AlltoallFusedFn.apply(comm, *parts)), token
    outs = []
    for p in parts:
        y, token = alltoall(p, comm=comm, token=token)
        outs.append(y)
    return outs, token


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


@publishes_token
def bcast(x, root, *, comm=None, token=None):
    """Broadcast ``x`` from ``root`` to every rank (every rank passes a
    tensor of the same shape and dtype).  Differentiable: the root gets
    the sum of every rank's cotangent, the other ranks zero."""
    x, comm, token = _prologue(x, comm, token)
    root = check_root(root, comm)
    if comm.size == 1:
        return x.clone(), token
    return _BcastFn.apply(x, root, comm), token


@publishes_token
def gather(x, root, *, comm=None, token=None):
    """Gather ``x`` from every rank to ``root``: ``(comm.size,
    *x.shape)`` on the root and the input, unmodified, elsewhere."""
    x, comm, token = _prologue(x, comm, token)
    root = check_root(root, comm)
    if comm.size == 1:
        return allgather(x, comm=comm, token=token)
    return _GatherFn.apply(x, root, comm), token


@publishes_token
def reduce(x, op, root, *, comm=None, token=None):
    """Reduce ``x`` with ``op`` to ``root``: the reduction on the root
    and the input, unmodified, elsewhere."""
    op = check_op(op)
    x, comm, token = _prologue(x, comm, token)
    root = check_root(root, comm)
    if comm.size == 1:
        return allreduce(x, op, comm=comm, token=token)
    return _ReduceFn.apply(x, op, root, comm), token


@publishes_token
def reduce_scatter(x, op=reductions.SUM, *, comm=None, token=None):
    """Reduce ``x`` with ``op`` across ranks and scatter the result by
    row blocks (``MPI_Reduce_scatter_block``): ``x`` is ``(comm.size,
    *rest)`` on every rank and rank ``r`` gets row ``r`` reduced over
    the ranks, shape ``rest``.  Differentiable for ``op=SUM`` (the
    cotangent is allgathered)."""
    x, comm, token = _prologue(x, comm, token)
    op = check_op(op)
    _check_rows(x, comm, "reduce_scatter")
    if comm.size == 1:
        return x[0].clone(), token
    return _ReduceScatterFn.apply(x, op, comm), token


@publishes_token
def scan(x, op, *, comm=None, token=None):
    """Inclusive prefix reduction over ranks (MPI_Scan): rank ``r``
    gets the fold of ranks ``0..r`` in rank order.  Differentiable for
    ``op=SUM``."""
    x, comm, token = _prologue(x, comm, token)
    op = check_op(op)
    if comm.size == 1:
        return x.clone(), token
    return _ScanFn.apply(x, op, comm), token


@publishes_token
def scatter(x, root, *, comm=None, token=None):
    """Scatter the rows of the root's ``x`` (``(comm.size, *rest)``):
    rank ``r`` gets row ``r``, shape ``rest``.  Another rank passes a
    ``rest``-shaped template or an array of the root's shape (see the
    module docstring).  Differentiable: the root gets the stacked
    cotangents, the other ranks zero."""
    x, comm, token = _prologue(x, comm, token)
    root = check_root(root, comm)
    if comm.size == 1:
        _check_rows(x, comm, "Scatter")
        return x[0].clone(), token
    # a proc comm's other ranks pass a template, always (the JAX proc
    # backend's contract); a mesh's may pass the root's full form
    full = (comm.rank() == root if comm.backend == "proc"
            else x.dim() > 0 and x.shape[0] == comm.size)
    if comm.rank() == root and (not full or x.dim() == 0
                                or x.shape[0] != comm.size):
        raise ValueError(
            f"Scatter input must have shape (nproc, ...) with nproc "
            f"== comm.size={comm.size} on root, got shape {tuple(x.shape)}"
        )
    return _ScatterFn.apply(x, root, comm, full), token
