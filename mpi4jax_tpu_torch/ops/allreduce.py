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

:class:`BucketedGradSync` packs a gradient tree into per-dtype buckets
and sums each over the comm with a nonblocking :func:`~mpi4jax_tpu_torch.
ops.async_.iallreduce` (or, in its blocking arm and on a mesh comm, this
module's :func:`allreduce`).
"""

import torch

from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops._core import as_token, publishes_token
from mpi4jax_tpu_torch.utils.validation import check_comm, check_op

__all__ = ["allreduce", "BucketedGradSync", "tree_flatten"]


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


def _flatten_into(tree, leaves):
    """Append ``tree``'s leaves to ``leaves``; returns the function that
    rebuilds the tree from an iterator of new leaves."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        subs = [_flatten_into(t, leaves) for t in tree]
        cls = type(tree)
        return lambda it: cls(*[f(it) for f in subs])
    if isinstance(tree, (tuple, list)):
        subs = [_flatten_into(t, leaves) for t in tree]
        cls = type(tree)
        return lambda it: cls(f(it) for f in subs)
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_flatten_into(tree[k], leaves) for k in keys]
        return lambda it: {k: f(it) for k, f in zip(keys, subs)}
    leaves.append(tree)
    return lambda it: next(it)


def tree_flatten(tree):
    """``(leaves, unflatten)`` of a tree of tensors in the JAX package's
    leaf order: a NamedTuple's fields in order, a tuple's or a list's
    items, a dict's values by sorted key, recursively (None holds no
    leaf).  ``unflatten(new_leaves)`` rebuilds the same structure."""
    leaves = []
    build = _flatten_into(tree, leaves)
    return leaves, lambda new: build(iter(new))


# the wire dtype each compressed mode rounds a float32 bucket through
_WIRE_DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


class BucketedGradSync:
    """DDP-style bucketed gradient synchronisation with compute/comm
    overlap (``mpi4jax_tpu/ops/allreduce.py:BucketedGradSync``).

    Flattens a gradient tree (:func:`tree_flatten`) into buckets of
    about ``bucket_bytes`` (``T4J_BUCKET_BYTES`` by default; one dtype a
    bucket, filled greedily), submits one nonblocking ``iallreduce`` per
    bucket, and waits every request at the end, the optimizer step's
    boundary.  Buckets are built in reverse leaf order by default, the
    order in which the backward makes gradients.

    ``overlap=False`` keeps the same bucket layout with a blocking
    :func:`allreduce` per bucket: the control arm of the overlap
    benchmark, and the arm a mesh comm always takes (a mesh comm has no
    requests).  ``average=False`` returns sums instead of means.

    ``sync(grads, token=..., residuals=res)`` (``res = {}`` at the first
    step) returns ``(grads, token, new_residuals)`` and applies error
    feedback when the bridge's wire dtype (``T4J_WIRE_DTYPE``) is bf16 or
    fp8: for each float32 bucket, ``send = grad + residual``, ``q`` is
    ``send`` rounded through the wire dtype (``torch.bfloat16``,
    ``torch.float8_e4m3fn``), ``q`` travels and ``send - q`` is the next
    step's residual.  The residuals carry a ``"_world"`` stamp, ``(epoch,
    alive_count)`` of the bridge's membership: residuals stamped with
    another membership are dropped, as is a bucket's residual of the
    wrong shape.  The residual dict is the rank's own state.
    """

    def __init__(self, comm=None, bucket_bytes=None, average=True,
                 overlap=True, reverse=True):
        self.comm = check_comm(comm)
        if bucket_bytes is None:
            from mpi4jax_tpu_torch.utils import config

            bucket_bytes = config.bucket_bytes()
        self.bucket_bytes = max(1, int(bucket_bytes))
        self.average = bool(average)
        self.overlap = bool(overlap) and self.comm.backend != "mesh"
        self.reverse = bool(reverse)

    def _buckets(self, leaves):
        """Leaf indices in byte-bounded buckets, one dtype each, filled
        greedily in (reversed) leaf order."""
        n = len(leaves)
        order = range(n - 1, -1, -1) if self.reverse else range(n)
        buckets = []
        open_by_dtype = {}
        for i in order:
            leaf = leaves[i]
            nbytes = leaf.numel() * leaf.element_size()
            cur = open_by_dtype.get(leaf.dtype)
            if cur is None or cur["bytes"] + nbytes > self.bucket_bytes:
                cur = {"dtype": leaf.dtype, "idx": [], "bytes": 0}
                open_by_dtype[leaf.dtype] = cur
                buckets.append(cur)
            cur["idx"].append(i)
            cur["bytes"] += nbytes
        return buckets

    def _wire_dtype(self):
        """The bridge's wire dtype on a proc comm ("off" elsewhere)."""
        if self.comm.backend != "proc":
            return "off"
        from mpi4jax_tpu_torch.native import runtime

        return (runtime.wire_dtype_info() or {}).get("wire_dtype", "off")

    def _world_stamp(self):
        """``(epoch, alive_count)`` of the bridge's membership on a proc
        comm, None elsewhere."""
        if self.comm.backend != "proc":
            return None
        from mpi4jax_tpu_torch.native import runtime

        info = runtime.world_info()
        if not info:
            return None
        return (int(info["epoch"]), int(info["alive_count"]))

    def sync(self, grads, *, token=None, residuals=None):
        """``(synced_grads, token)``: the same tree with every leaf summed
        (or averaged) over the comm; with ``residuals``, ``(synced_grads,
        token, new_residuals)`` (see the class docstring)."""
        from mpi4jax_tpu_torch.ops.async_ import iallreduce, wait

        token = as_token(token)
        leaves, unflatten = tree_flatten(grads)
        if not leaves:
            return (grads, token) if residuals is None else (grads, token, {})
        leaves = [torch.as_tensor(x) for x in leaves]
        ef = residuals is not None
        qdt = _WIRE_DTYPES.get(self._wire_dtype()) if ef else None
        new_res = {} if ef else None
        carried = residuals if (ef and hasattr(residuals, "get")) else {}
        if ef:
            stamp = self._world_stamp()
            prev_stamp = carried.get("_world") if carried else None
            if (stamp is not None and prev_stamp is not None
                    and tuple(prev_stamp) != stamp):
                carried = {}  # quantised against another membership
            if stamp is not None:
                new_res["_world"] = stamp
        scale = 1.0 / float(self.comm.size) if self.average else None
        pending = []  # (bucket, request or reduced tensor)
        for bi, bucket in enumerate(self._buckets(leaves)):
            flat = torch.cat([leaves[i].reshape(-1) for i in bucket["idx"]])
            if qdt is not None and bucket["dtype"] == torch.float32:
                prev = carried.get(bi) if carried else None
                if prev is not None:
                    prev = torch.as_tensor(prev, dtype=flat.dtype,
                                           device=flat.device)
                    if prev.shape != flat.shape:
                        prev = None  # the layout changed under the carrier
                if prev is not None:
                    flat = flat + prev
                q = flat.to(qdt).to(flat.dtype)
                new_res[bi] = flat - q
                flat = q
            if self.overlap:
                req, token = iallreduce(flat, reductions.SUM, comm=self.comm,
                                        token=token)
                pending.append((bucket, req))
            else:
                red, token = allreduce(flat, reductions.SUM, comm=self.comm,
                                       token=token)
                pending.append((bucket, red))
        out = list(leaves)
        for bucket, handle in pending:
            if self.overlap:
                red, token = wait(handle, token=token)
            else:
                red = handle
            if scale is not None:
                # the scale in the bucket's dtype, as the JAX package has it
                red = red * torch.tensor(scale, dtype=red.dtype)
            off = 0
            for i in bucket["idx"]:
                n = leaves[i].numel()
                out[i] = red[off:off + n].reshape(leaves[i].shape)
                off += n
        synced = unflatten(out)
        if ef:
            return synced, token, new_res
        return synced, token

    __call__ = sync
