"""Distributed training steps of an MLP: data parallel, tensor parallel
and ZeRO.

The port's counterpart of ``mpi4jax_tpu/models/train.py``:

* :func:`make_train_step`, :func:`make_global_train_step` and
  :func:`make_global_zero_train_step`: a two-layer MLP with its hidden
  dimension split over the ``tp`` ranks (Megatron: ``w1`` by columns,
  ``w2`` by rows, the partial output summed by :func:`allreduce`, whose
  backward is the identity) and its batch over the ``dp`` ranks.  There
  is no mesh argument: ``comm_dp`` and ``comm_tp`` are the two 1-D
  sub-communicators of one world's comm (``comm.sub("dp")``,
  ``comm.sub("tp")``) and carry the layout.  Where the JAX package's
  ``shard_map`` differentiation sums a replicated parameter's gradient
  over the ranks it is replicated on, these steps sum explicitly, with
  the JAX package's scalings: ``g / dp`` for the tp-sharded leaves and
  ``g / (dp * tp)`` for ``b2`` after a sum over dp and then tp.
* :func:`make_dp_train_step`: pure data parallelism for the proc tier,
  every rank holding the full parameters, with the gradient sync in
  buckets that overlap the backward.
* :func:`run_elastic`: the dp step in a loop that survives rank deaths
  and rejoins under the launcher's ``--elastic``, resuming from per-rank
  checkpoints.

The steps return new parameters and leave the caller's untouched.
Parameters come from :func:`init_params` / :func:`init_stack_params`
(drawn from a ``torch.Generator``) or from the JAX package's
(:func:`params_from_jax`); :func:`shard_params` cuts a rank's tp shards.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops._core import create_token
from mpi4jax_tpu_torch.ops.allreduce import BucketedGradSync, allreduce
from mpi4jax_tpu_torch.utils.runtime import resolve_device

__all__ = [
    "MLPParams",
    "StackParams",
    "init_params",
    "init_stack_params",
    "shard_params",
    "params_from_jax",
    "make_train_step",
    "make_global_train_step",
    "make_global_zero_train_step",
    "make_dp_train_step",
    "run_elastic",
]


class MLPParams(NamedTuple):
    w1: torch.Tensor  # (d_in, d_hidden / tp) column shard
    b1: torch.Tensor  # (d_hidden / tp,)
    w2: torch.Tensor  # (d_hidden / tp, d_out) row shard
    b2: torch.Tensor  # (d_out,) replicated, added once after the sum


class StackParams(NamedTuple):
    """The deep MLP of the data-parallel step: one ``(w, b)`` pair of
    leaves a layer (not one stacked tensor), so that the gradient sync
    can bucket them in backward order.  The leaf order is ``(w0, b0,
    w1, b1, ..., w_out)``; reversed, it is the order the backward makes
    the gradients in."""

    layers: tuple  # L entries of (w: (d, d), b: (d,))
    w_out: torch.Tensor  # (d, d_out)


# the axis of each MLPParams leaf that the tp ranks split (None: kept whole)
_TP_AXIS = MLPParams(w1=1, b1=0, w2=0, b2=None)


def _normal(shape, scale, generator, dtype, device):
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (x * scale).to(device=device, dtype=dtype)


def init_params(d_in, d_hidden, d_out, tp_size=1, *, generator,
                dtype=torch.float32, device="cuda"):
    """Full (unsharded) MLP parameters drawn from ``generator``: normal
    weights of std ``sqrt(2 / fan_in)`` and zero biases, as the JAX
    package's ``init_params`` (the draws differ: a ``torch.Generator``
    is not JAX's key stream).  ``d_hidden`` must split over
    ``tp_size`` ranks (:func:`shard_params`)."""
    if d_hidden % tp_size:
        raise ValueError(
            f"d_hidden={d_hidden} must be divisible by tp_size={tp_size}"
        )
    device = resolve_device(device)
    return MLPParams(
        w1=_normal((d_in, d_hidden), (2.0 / d_in) ** 0.5, generator, dtype,
                   device),
        b1=torch.zeros((d_hidden,), dtype=dtype, device=device),
        w2=_normal((d_hidden, d_out), (2.0 / d_hidden) ** 0.5, generator,
                   dtype, device),
        b2=torch.zeros((d_out,), dtype=dtype, device=device),
    )


def init_stack_params(layers, d, d_out=None, *, generator,
                      dtype=torch.float32, device="cuda"):
    """A :class:`StackParams` of ``layers`` square layers of width ``d``
    and an output layer to ``d_out`` (``d`` by default), drawn from
    ``generator`` with std ``sqrt(2 / d)`` and zero biases."""
    d_out = d_out or d
    device = resolve_device(device)
    scale = (2.0 / d) ** 0.5
    return StackParams(
        layers=tuple(
            (_normal((d, d), scale, generator, dtype, device),
             torch.zeros((d,), dtype=dtype, device=device))
            for _ in range(layers)
        ),
        w_out=_normal((d, d_out), scale, generator, dtype, device),
    )


def shard_params(params, comm_tp):
    """This rank's tp shards of full MLP parameters (every rank passes
    the same ones): ``w1`` and ``b1`` cut on their hidden axis, ``w2``
    on its rows, ``b2`` whole; copies all."""
    tp, r = comm_tp.size, comm_tp.rank()

    def cut(t, axis):
        if axis is None:
            return t.detach().clone()
        n = t.shape[axis] // tp
        return t.detach().narrow(axis, r * n, n).contiguous().clone()

    return MLPParams(*(cut(t, a) for t, a in zip(params, _TP_AXIS)))


def params_from_jax(arrays, *, dtype=torch.float32, device="cuda",
                    comm_tp=None):
    """Port parameters on ``device`` from the JAX package's
    ``MLPParams`` or ``StackParams`` with numpy leaves (the same
    structure).  With ``comm_tp``, full MLP parameters land as this
    rank's tp shards (:func:`shard_params`)."""
    device = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    if hasattr(arrays, "layers"):
        if comm_tp is not None and comm_tp.size > 1:
            raise ValueError("StackParams are not split over tp ranks")
        return StackParams(
            layers=tuple((leaf(w), leaf(b)) for w, b in arrays.layers),
            w_out=leaf(arrays.w_out),
        )
    params = MLPParams(*(leaf(getattr(arrays, f)) for f in MLPParams._fields))
    if comm_tp is None or comm_tp.size == 1:
        return params
    return shard_params(params, comm_tp)


def _forward(params, x, comm_tp, token):
    """The tp forward: local products and one sum of the partial output
    over ``comm_tp`` (the g collective); the bias is added once, after
    the sum."""
    h = torch.relu(x @ params.w1 + params.b1)  # (B, hidden / tp)
    y, token = allreduce(h @ params.w2, reductions.SUM, comm=comm_tp,
                         token=token)
    return y + params.b2, token


def _loss_and_grads(params, x, targets, comm_tp):
    """The local mean squared error of the tp forward and its gradient
    with respect to each leaf of ``params``."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    y, _ = _forward(MLPParams(*leaves), x, comm_tp, create_token())
    loss = torch.mean((y - targets) ** 2)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), MLPParams(*grads)


def _sgd(params, grads, lr):
    return type(params)(*(p.detach() - lr * g for p, g in zip(params, grads)))


def _dp_block(t, comm_dp, like):
    """This dp rank's rows of a global batch tensor."""
    t = torch.as_tensor(t, device=like.device)
    n = t.shape[0]
    if n % comm_dp.size:
        raise ValueError(f"the global batch {n} must be divisible by its "
                         f"{comm_dp.size} dp ranks")
    rows = n // comm_dp.size
    r = comm_dp.rank()
    return t[r * rows:(r + 1) * rows]


def make_train_step(comm_dp, comm_tp, lr=1e-2):
    """The per-rank step: ``step(params, (x, targets)) -> (params,
    loss)`` with ``params`` this rank's tp shards and ``(x, targets)``
    this rank's micro-batch (the same across the tp ranks).  Every
    gradient is summed over ``comm_dp`` by its own allreduce and divided
    by dp; ``loss`` is the dp mean of the micro-batch losses, 0-d."""
    dp = float(comm_dp.size)

    def step(params, batch):
        x, targets = batch
        loss, grads = _loss_and_grads(params, x, targets, comm_tp)
        tok = create_token()
        with torch.no_grad():
            synced = []
            for g in grads:
                g_sum, tok = allreduce(g, reductions.SUM, comm=comm_dp,
                                       token=tok)
                synced.append(g_sum / dp)
            loss_sum, tok = allreduce(loss, reductions.SUM, comm=comm_dp,
                                      token=tok)
            return _sgd(params, synced, lr), loss_sum / dp

    return step


def make_global_train_step(comm_dp, comm_tp, lr=1e-2):
    """The global step over a ``(dp, tp)`` mesh of ranks:
    ``step(params, (x, targets)) -> (params, loss)``.

    ``params`` are this rank's tp shards, replicated over dp; ``x`` and
    ``targets`` are the global batch, the same on every rank, of which
    the step takes this rank's dp rows.  ``w1``, ``b1`` and ``w2`` get
    their gradients summed over dp and divided by dp, ``b2`` summed over
    dp, then tp, and divided by dp * tp (the JAX step's ``shard_map``
    sums the replicated ``b2`` over both).  ``loss`` is this rank's
    local loss, shape ``[1]`` (the JAX step returns every rank's, as
    the rows of one ``(dp * tp,)`` array)."""
    dp, tp = float(comm_dp.size), float(comm_tp.size)

    def step(params, batch):
        x, targets = (_dp_block(t, comm_dp, params.w1) for t in batch)
        loss, grads = _loss_and_grads(params, x, targets, comm_tp)
        with torch.no_grad():
            synced = []
            for name, g in zip(MLPParams._fields, grads):
                g, _ = allreduce(g, reductions.SUM, comm=comm_dp)
                if name == "b2":
                    g, _ = allreduce(g, reductions.SUM, comm=comm_tp)
                    synced.append(g / (dp * tp))
                else:
                    synced.append(g / dp)
            return _sgd(params, synced, lr), loss.reshape(1)

    return step


def make_global_zero_train_step(comm_dp, comm_tp, lr=1e-2, momentum=0.9):
    """ZeRO-1: momentum SGD with the optimizer state split over dp.

    Returns ``(step, init_opt_state)``:

    * ``init_opt_state(params)``: this rank's momentum, one ``(1,
      ceil(size / dp))`` chunk of zeros per parameter (``size`` that of
      the rank's tp shard), 1/dp of the parameter and its pad;
    * ``step(params, opt_state, (x, targets)) -> (params, opt_state,
      loss)``, with ``params`` and the batch as in
      :func:`make_global_train_step`.

    The JAX step's arithmetic: each gradient, scaled by 1/dp (``b2``:
    summed over tp first, then 1/(dp * tp)), is padded to dp chunks and
    reduce-scattered over dp, so rank r gets the dp sum of chunk r; the
    momentum update runs on that chunk and the updated chunk is
    rebroadcast as the masked sum over dp (``b2``: over dp and tp, then
    divided by tp)."""
    from mpi4jax_tpu_torch.ops.collectives import reduce_scatter

    dpn = comm_dp.size
    dp, tp = float(comm_dp.size), float(comm_tp.size)

    def chunk_of(n):
        return -(-n // dpn)

    def init_opt_state(params):
        return MLPParams(*(torch.zeros((1, chunk_of(p.numel())),
                                       dtype=p.dtype, device=p.device)
                           for p in params))

    def step(params, opt_state, batch):
        x, targets = (_dp_block(t, comm_dp, params.w1) for t in batch)
        loss, grads = _loss_and_grads(params, x, targets, comm_tp)
        rank = comm_dp.rank()
        new_p, new_v = [], []
        with torch.no_grad():
            for name, p, g, v in zip(MLPParams._fields, params, grads,
                                     opt_state):
                is_tp = name != "b2"
                n, chunk = p.numel(), chunk_of(p.numel())
                pad = dpn * chunk - n
                if not is_tp:
                    g, _ = allreduce(g, reductions.SUM, comm=comm_tp)
                scale = dp if is_tp else dp * tp
                gflat = F.pad(g.reshape(-1) / scale, (0, pad))
                gsh, _ = reduce_scatter(gflat.reshape(dpn, chunk),
                                        comm=comm_dp)
                v1 = momentum * v[0] + gsh
                psh = F.pad(p.detach().reshape(-1), (0, pad))[
                    rank * chunk:(rank + 1) * chunk]
                u = psh - lr * v1
                mine = (torch.arange(dpn, device=u.device) == rank)[:, None]
                buf = torch.where(mine, u[None, :],
                                  torch.zeros((), dtype=u.dtype,
                                              device=u.device))
                pnew, _ = allreduce(buf, reductions.SUM, comm=comm_dp)
                if not is_tp:
                    pnew, _ = allreduce(pnew, reductions.SUM, comm=comm_tp)
                    pnew = pnew / tp
                new_p.append(pnew.reshape(-1)[:n].reshape(p.shape))
                new_v.append(v1[None])
        return MLPParams(*new_p), MLPParams(*new_v), loss.reshape(1)

    return step, init_opt_state


def make_dp_train_step(comm, lr=1e-2, overlap=True, bucket_bytes=None,
                       loss_sync=True):
    """The pure data-parallel step of the proc tier, with the gradient
    sync in buckets that overlap the backward.

    Every rank holds the full parameters and its own micro-batch:
    ``step(params, (x, targets)) -> (params, loss)``.  For
    :class:`StackParams` the backward is written out layer by layer, last
    layer first, and as soon as a bucket of gradients reaches
    ``bucket_bytes`` (``T4J_BUCKET_BYTES`` by default) its
    ``iallreduce`` is submitted; the requests are waited at the optimizer
    step.  The JAX step fences the rest of the backward on each submit
    (``lax.optimization_barrier``) so that XLA cannot sink the submit
    below it; eager PyTorch needs no fence, as the submit returns before
    layer k-1's backward is queued.  For :class:`MLPParams` the step runs
    autograd and then :class:`~mpi4jax_tpu_torch.ops.allreduce.
    BucketedGradSync`.

    ``overlap=False`` runs the same buckets through blocking allreduces
    (the control arm of ``benchmarks/transformer.py --overlap``); both
    arms give the same parameters and loss bit for bit.  A mesh comm has
    no requests and always takes the blocking arm.  ``loss`` is the comm
    mean of the ranks' losses (the rank's own with
    ``loss_sync=False``), 0-d.
    """
    from mpi4jax_tpu_torch.ops.async_ import iallreduce, wait

    if bucket_bytes is None:
        from mpi4jax_tpu_torch.utils import config

        bucket_bytes = config.bucket_bytes()
    bucket_bytes = max(1, int(bucket_bytes))
    n = float(comm.size)
    use_async = overlap and getattr(comm, "backend", None) != "mesh"

    def sync_loss(loss):
        if not loss_sync:
            return loss
        loss_sum, _ = allreduce(loss, reductions.SUM, comm=comm)
        return loss_sum / n

    def generic_step(params, batch):
        x, targets = batch
        sync = BucketedGradSync(comm, bucket_bytes=bucket_bytes,
                                average=True, overlap=use_async)
        leaves = [p.detach().requires_grad_(True) for p in params]
        p = MLPParams(*leaves)
        y = torch.relu(x @ p.w1 + p.b1) @ p.w2 + p.b2
        loss = torch.mean((y - targets) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            grads, _ = sync(MLPParams(*grads))
            return _sgd(params, grads, lr), sync_loss(loss.detach())

    @torch.no_grad()
    def stack_step(params, batch):
        x, targets = batch
        layers = list(params.layers)

        # the forward, keeping each layer's input and pre-activation
        h = x
        saves = []
        for w, b in layers:
            pre = h @ w + b
            saves.append((h, pre))
            h = torch.relu(pre)
        y = h @ params.w_out
        diff = y - targets
        loss = torch.mean(diff ** 2)
        dy = (2.0 / diff.numel()) * diff

        itemsize = y.element_size()
        pending = []  # (entries, request or reduced tensor), submit order
        bucket = []   # [(key, grad)] filling toward bucket_bytes
        filled = 0

        def flush():
            nonlocal bucket, filled
            if not bucket:
                return
            flat = torch.cat([g.reshape(-1) for _, g in bucket])
            entries = [(k, g.shape, g.numel()) for k, g in bucket]
            if use_async:
                handle, _ = iallreduce(flat, reductions.SUM, comm=comm)
            else:
                handle, _ = allreduce(flat, reductions.SUM, comm=comm)
            pending.append((entries, handle))
            bucket, filled = [], 0

        def push(key, g):
            nonlocal filled
            bucket.append((key, g))
            filled += g.numel() * itemsize
            if filled >= bucket_bytes:
                flush()

        # the backward, last layer first: a full bucket is on the wire
        # before the next layer's products are queued
        push(("w_out",), h.T @ dy)
        dh = dy @ params.w_out.T
        zero = torch.zeros((), dtype=dh.dtype, device=dh.device)
        for i in reversed(range(len(layers))):
            h_in, pre = saves[i]
            w, _ = layers[i]
            dpre = torch.where(pre > 0, dh, zero)
            push(("w", i), h_in.T @ dpre)
            push(("b", i), dpre.sum(dim=0))
            if i > 0:
                dh = dpre @ w.T
        flush()

        # every request waited at the optimizer step
        scale = torch.tensor(1.0 / n, dtype=y.dtype)
        synced = {}
        for entries, handle in pending:
            red = wait(handle)[0] if use_async else handle
            red = red * scale
            off = 0
            for key, shape, size in entries:
                synced[key] = red[off:off + size].reshape(shape)
                off += size
        new_params = StackParams(
            layers=tuple((w - lr * synced[("w", i)], b - lr * synced[("b", i)])
                         for i, (w, b) in enumerate(layers)),
            w_out=params.w_out - lr * synced[("w_out",)],
        )
        return new_params, sync_loss(loss)

    def step(params, batch):
        if isinstance(params, StackParams):
            return stack_step(params, batch)
        if isinstance(params, MLPParams):
            return generic_step(params, batch)
        raise TypeError(
            f"make_dp_train_step knows StackParams/MLPParams, got "
            f"{type(params)}"
        )

    return step


# -- the elastic training loop ----------------------------------------------


def _resize_interrupted(exc):
    """True for an op failure caused by an elastic resize: the bridge's
    ``ResizeInterrupted`` status (an op drained mid-resize) or an op on a
    handle of the old world."""
    s = str(exc)
    return ("ResizeInterrupted" in s or "world resize" in s
            or "not a member of the current world" in s)


def _keyed_stack_params(key, layers, d, device):
    """The JAX package's ``init_stack_params(key, layers, d)`` drawn with
    ``utils/prng.py`` (JAX's key schedule and uniform bits; the normal's
    inverse error function is PyTorch's)."""
    from mpi4jax_tpu_torch.utils import prng

    keys = prng.split(key, layers + 1)
    scale = (2.0 / d) ** 0.5
    return StackParams(
        layers=tuple((prng.normal(keys[i], (d, d)) * scale,
                      torch.zeros((d,), dtype=torch.float32, device=device))
                     for i in range(layers)),
        w_out=prng.normal(keys[-1], (d, d)) * scale,
    )


def run_elastic(nsteps, checkpoint_dir, *, d=32, layers=2, batch=4,
                lr=1e-2, save_every=2, seed=0, log=print, device="cuda"):
    """The elastic data-parallel training loop of a launcher job run with
    ``--elastic shrink|rejoin``: the job survives rank deaths, and grows
    back under ``rejoin``, instead of restarting.

    1. Every rank checkpoints its (replicated) parameters into its own
       :class:`~mpi4jax_tpu_torch.utils.checkpoint.Manager` series,
       ``<checkpoint_dir>/rank<r>``, every ``save_every`` steps and at
       the last.
    2. At entry and after every resize the members agree on the resume
       point, the MIN of their latest saved steps (ranks may have died
       between saves, and a rejoined rank inherits its predecessor's
       series), and everyone restores it.
    3. A membership change mid-step surfaces as an op failure carrying
       the bridge's ``ResizeInterrupted`` status or as
       :class:`~mpi4jax_tpu_torch.WorldResized` at the next op.  The loop
       waits the resize out, calls ``runtime.refresh_after_resize``,
       rebuilds the comm over the members and the step
       (``make_dp_train_step(comm, lr=lr, overlap=False)``) and resumes
       at the agreed step.  The recovery runs through pending flags, so a
       second resize during it (a rejoin right after a shrink) is
       harmless.

    The template is the JAX package's ``init_stack_params(PRNGKey(seed),
    layers, d)`` and step ``i``'s batch on member ``c`` is drawn from
    ``fold_in(PRNGKey(seed), 1009 * i + c)``, as in JAX's loop, through
    ``utils/prng.py``, on ``device`` (the card unless ``"cpu"``).  Losses
    after a shrink differ from the full world's (fewer micro-batches a
    step).  Returns ``{"resizes", "final_world", "final_epoch",
    "last_step", "losses"}``.
    """
    from mpi4jax_tpu_torch.native import runtime
    from mpi4jax_tpu_torch.native.runtime import WorldResized
    from mpi4jax_tpu_torch.parallel.proc import world_comm_if_initialized
    from mpi4jax_tpu_torch.utils import checkpoint, prng

    device = resolve_device(device)
    runtime.ensure_initialized()
    comm = world_comm_if_initialized()
    if comm is None:
        raise RuntimeError(
            "run_elastic needs a multi-process world "
            "(python -m mpi4jax_tpu_torch.launch -np N --elastic shrink ...)")
    rank = runtime.world_rank()
    mgr = checkpoint.Manager(f"{checkpoint_dir}/rank{rank}", max_to_keep=5)
    root = prng.raw_key([0, seed], device)

    def template():
        return _keyed_stack_params(root, layers, d, device)

    def build(c):
        return make_dp_train_step(c, lr=lr, overlap=False)

    def batch_for(i, c):
        # one stream per (step, member index): the partition follows the
        # membership
        k = prng.fold_in(root, 1009 * i + c.rank())
        return (prng.normal(k, (batch, d)),
                prng.normal(prng.fold_in(k, 1), (batch, d)))

    def sync_start(c):
        """The agreed resume point: ``(params, first step)``."""
        mgr.wait_until_finished()
        local = mgr.latest_step()
        mine = torch.tensor([-1 if local is None else local],
                            dtype=torch.int32, device=device)
        agreed, _ = allreduce(mine, reductions.MIN, comm=c,
                              token=create_token())
        agreed = int(agreed[0])
        if agreed < 0:
            return template(), 0
        return mgr.restore(agreed, like=template()), agreed + 1

    step = build(comm)
    resizes = 0
    epoch = (runtime.world_info() or {}).get("epoch", 0)
    losses = []
    params = None
    i = 0
    pending_rebuild = False
    pending_sync = True
    while pending_rebuild or pending_sync or i < nsteps:
        try:
            if pending_rebuild:
                runtime.refresh_after_resize()
                comm = world_comm_if_initialized()
                step = build(comm)
                pending_rebuild = False
                pending_sync = True
            if pending_sync:
                params, i = sync_start(comm)
                pending_sync = False
                continue
            params, loss = step(params, batch_for(i, comm))
            losses.append(float(loss))
            if save_every and (i % save_every == 0 or i == nsteps - 1):
                mgr.save(i, params)
            i += 1
        except WorldResized as w:
            resizes += 1
            epoch = w.epoch
            pending_rebuild = True
            log(f"t4j elastic: world now {len(w.new_world)} member(s) at "
                f"epoch {w.epoch} — resuming from the last agreed "
                "checkpoint", flush=True)
        except Exception as e:  # noqa: BLE001 (only a resize's passes)
            if not _resize_interrupted(e):
                raise
            runtime.resize_wait()
            info = runtime.world_info() or {}
            if info.get("epoch", epoch) == epoch and not pending_rebuild:
                # settled with no new epoch: the runtime still owes a
                # WorldResized, or the resize became a fault
                try:
                    runtime.check_health()
                except WorldResized as w:
                    resizes += 1
                    epoch = w.epoch
                    pending_rebuild = True
                    continue
                raise
            resizes += 1
            epoch = info.get("epoch", epoch)
            pending_rebuild = True
            log(f"t4j elastic: step {i} interrupted by a resize (epoch "
                f"{epoch}) — rebuilding", flush=True)
    info = runtime.world_info() or {}
    return {
        "resizes": resizes,
        "final_world": comm.size,
        "final_epoch": int(info.get("epoch", epoch)),
        "last_step": i - 1,
        "losses": losses,
    }
