"""Pipeline parallelism built from the communication primitives.

Counterpart of ``mpi4jax_tpu/models/pipeline.py`` on PyTorch: the
reference's "PP building block" (the ``sendrecv`` ring step to rank±1)
as two schedules over a one-axis ``pp`` comm, rank = stage index, the
activations handed downstream by one :func:`sendrecv` a tick on the
pattern ``[(r, r + 1)]``.

* **GPipe** (:func:`pipeline_apply`): the forward schedule; autograd
  differentiates it, so the backward runs after every forward and the
  graph holds every microbatch's residuals until then (O(M) memory).
  The gradient of the handoff is the handoff of the cotangent the other
  way (the ``sendrecv`` transpose).
* **1F1B** (:func:`pipeline_train`): each steady-state tick runs one
  forward and one backward microbatch per stage, the cotangents going
  upstream on a second wire.  The backward is built by hand: each tick
  recomputes the stage at its stashed input (one ``torch.autograd.grad``
  of the stage, JAX's ``jax.vjp``), so in-flight activations are the
  ``min(M, 2S-1)`` stashed microbatch inputs.  The last stage forwards
  and backwards a microbatch in one tick, so it runs stage and head
  through one ``torch.autograd.grad`` and stashes nothing (JAX runs its
  forward twice there).

GPipe: ``T = M + S - 1`` ticks; at tick ``t`` stage ``s`` runs
microbatch ``t - s`` when that is valid.  1F1B: ``T = M + 2(S-1)``
ticks; at tick ``t`` stage ``s`` forwards microbatch ``t - s`` and
backwards microbatch ``t - (2(S-1) - s)`` (the last stage backwards a
microbatch in the tick it forwards it).

Every rank makes every tick's exchange, bubbles included, as the JAX
scan does.  Autograd runs a node's backward only if the node reaches the
root of the backward (and, under ``torch.autograd.grad``, lies on a path
to a requested input), and a rank that skipped a transposed exchange
would leave its neighbour waiting in it.  So the values a rank does not
read stay in its graph through ``_KeepInGraph`` (a zero cotangent): the
receive stage 0 ignores, a bubble's input, the last tick's handoff; and
the caller ties its loss to the outputs on every rank (zeros off the
last stage) and differentiates with respect to the stage parameters on
every rank.  A bubble runs no stage here (JAX computes it on masked
data and discards it): its output is zeros tied to its input and to the
stage parameters.
"""

import torch

from mpi4jax_tpu_torch.ops._core import as_token
from mpi4jax_tpu_torch.ops.allreduce import tree_flatten
from mpi4jax_tpu_torch.ops.p2p import sendrecv
from mpi4jax_tpu_torch.parallel.longseq import _KeepInGraph

__all__ = ["pipeline_apply", "pipeline_train"]


def _stages(comm, where):
    """The comm's size and this rank's stage; raises for a comm of more
    than one axis."""
    if len(getattr(comm, "axes", ())) != 1:
        raise ValueError(f"{where} needs a single-axis communicator")
    return comm.size, comm.rank()


# the (stage_fn, layout) pairs _check_stage has passed: JAX probes a
# stage once, when it traces the schedule; a probe here costs as much
# host time as the stage's own launches (meta kernels run in Python)
_CHECKED = set()
_CHECKED_MAX = 64


def _check_stage(stage_fn, stage_params, template, where):
    """Run ``stage_fn`` on meta tensors of the parameters' and the
    microbatch's shapes (no data, no device work; ``jax.eval_shape``'s
    stand-in) and raise unless it keeps the microbatch's shape and
    dtype: the handoff wire doubles as the next stage's input.  Once per
    stage function and layout."""
    leaves, unflatten = tree_flatten(stage_params)
    key = (stage_fn, type(stage_params), tuple(
        (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor)
        else type(t) for t in leaves), tuple(template.shape), template.dtype)
    try:
        if key in _CHECKED:
            return
    except TypeError:  # an unhashable stage function: probe every call
        key = None
    meta = unflatten([t.detach().to("meta") if isinstance(t, torch.Tensor)
                      else t for t in leaves])
    x = torch.empty(template.shape, dtype=template.dtype, device="meta")
    with torch.no_grad():
        out = stage_fn(meta, x)
    if out.shape != x.shape or out.dtype != x.dtype:
        raise ValueError(
            f"{where} requires shape/dtype-preserving stages (the handoff "
            f"wire doubles as the next stage's input): stage_fn maps "
            f"{tuple(x.shape)}/{x.dtype} -> {tuple(out.shape)}/{out.dtype}"
        )
    if key is not None:
        if len(_CHECKED) >= _CHECKED_MAX:
            _CHECKED.clear()
        _CHECKED.add(key)


def _handoff(x, pairs, comm):
    """One tick's exchange on ``pairs``: this rank's ``x`` to its
    partner, and what its own partner sent (zeros without one)."""
    out, _ = sendrecv(x, torch.zeros_like(x), source=pairs, dest=pairs,
                      comm=comm)
    return out


def pipeline_apply(stage_fn, stage_params, microbatches, comm, *, token=None):
    """Run a stage-sharded function as a GPipe pipeline over ``comm``.

    Args:
      stage_fn: ``(params, activation) -> activation``, this rank's stage
        (the same signature on every stage; what differs lives in
        ``stage_params``), shape- and dtype-preserving.
      stage_params: this rank's stage parameters (a tensor, or a tuple,
        list or NamedTuple of them).
      microbatches: ``(M, mb, ...)`` inputs.  Only stage 0 reads them;
        the other ranks pass a tensor of the same shape and dtype.
      comm: a one-axis comm (the pp ranks); rank = stage index.
      token: optional ordering token.

    Returns ``(outputs, token)``: ``outputs`` ``(M, mb, ...)`` holds the
    last stage's results on the **last** rank and zeros elsewhere, tied
    on every rank to every tick's exchange: a loss of the outputs on
    every rank (zero off the last stage) takes each rank through every
    transposed exchange in its backward.
    """
    token = as_token(token)
    n_stages, rank = _stages(comm, "pipeline_apply")
    n_micro = microbatches.shape[0]
    _check_stage(stage_fn, stage_params, microbatches[0], "pipeline_apply")
    fwd = [(r, r + 1) for r in range(n_stages - 1)]
    first, last = rank == 0, rank == n_stages - 1

    # under grad mode every exchange is in the graph on every rank from
    # the first tick, bubbles included, so that the ranks agree on which
    # exchanges have a transpose
    incoming = torch.zeros_like(microbatches[0]).requires_grad_(
        torch.is_grad_enabled())
    # a bubble's output is tied to the stage parameters too: a gradient
    # taken with respect to them (``torch.autograd.grad``) runs only the
    # nodes on a path to them, and the bubbles before a rank's first
    # microbatch are on no other
    params = [t for t in tree_flatten(stage_params)[0]
              if isinstance(t, torch.Tensor)]
    outs = []
    for t in range(n_micro + n_stages - 1):
        mb = t - rank
        if 0 <= mb < n_micro:
            a_in = (_KeepInGraph.apply(microbatches[mb], incoming) if first
                    else incoming)
            a_out = stage_fn(stage_params, a_in)
            if last:
                outs.append(a_out)
        else:  # a bubble: nothing to compute, the wire still runs
            a_out = _KeepInGraph.apply(torch.zeros_like(incoming), incoming,
                                       *params)
        incoming = _handoff(a_out, fwd, comm) if fwd else a_out
    outputs = (torch.stack(outs) if last
               else torch.zeros_like(microbatches))
    # the last tick's handoff carries only bubbles, but its transpose is
    # made on every rank, as in the JAX scan
    return _KeepInGraph.apply(outputs, incoming), token


def _vjp(fn, primals, cotangent):
    """``fn(*primals)`` and the gradients of ``<fn(*primals),
    cotangent>`` (or of the scalar output when ``cotangent`` is None)
    with respect to every tensor leaf of ``primals``: ``(out, grads)``,
    ``grads`` the primals' structure (zeros for a leaf the output does
    not reach)."""
    leaves, unflatten = tree_flatten(primals)
    with torch.enable_grad():
        views = [t.detach().requires_grad_(True) for t in leaves]
        out = fn(*unflatten(views))
        grads = torch.autograd.grad(out, views, cotangent,
                                    allow_unused=True,
                                    materialize_grads=True)
    return out.detach(), unflatten(list(grads))


def _add(acc, tree):
    leaves, unflatten = tree_flatten(tree)
    return unflatten([a + g for a, g in zip(tree_flatten(acc)[0], leaves)])


def _zeros_like(tree):
    leaves, unflatten = tree_flatten(tree)
    return unflatten([torch.zeros_like(t) for t in leaves])


def pipeline_train(
    stage_fn, stage_params, head_fn, head_params, microbatches, extras,
    comm, *, token=None,
):
    """1F1B pipeline schedule with its backward built by hand.

    After warm-up every tick runs one forward and one backward
    microbatch per stage, so at most ``2S-1`` microbatch inputs are in
    flight per stage; the backward recomputes the stage from the
    stashed input (rematerialisation built into the schedule).  The
    last stage backwards a microbatch in the tick it forwards it (the
    loss cotangent is local: one pass through stage and head); the
    earlier stages' cotangents ride an upstream wire, one tick behind
    the downstream stage's backward.  Both wires are plain exchanges
    outside autograd, activations downstream first, then cotangents
    upstream, on every tick.

    Args:
      stage_fn: ``(stage_params, a) -> a`` shape/dtype-preserving stage.
      stage_params: this rank's stage parameters.
      head_fn: ``(head_params, a, extra) -> scalar`` per-microbatch loss
        head, applied to the last stage's output (only there).
      head_params: loss-head parameters (replicated).
      microbatches: ``(M, mb, ...)`` inputs; only stage 0 reads them.
      extras: ``(M, ...)`` tensor (or tree of them) of per-microbatch
        loss inputs (e.g. targets), read on the last stage.
      comm: a one-axis comm (the pp ranks); rank = stage index.

    Returns ``(loss_sum, d_stage_params, d_head_params, d_microbatches,
    token)``: the SUM over microbatches of the per-microbatch losses
    (f32) and its gradients (divide by M for the mean).  The loss and
    ``d_head_params`` are nonzero only on the last stage,
    ``d_microbatches`` only on stage 0; every gradient is this rank's
    own, and the caller owns every sum across ranks.
    """
    token = as_token(token)
    n_stages, rank = _stages(comm, "pipeline_train")
    n_micro = microbatches.shape[0]
    _check_stage(stage_fn, stage_params, microbatches[0], "pipeline_train")
    fwd = [(r, r + 1) for r in range(n_stages - 1)]  # activations s -> s+1
    bwd = [(r + 1, r) for r in range(n_stages - 1)]  # cotangents s+1 -> s
    first, last = rank == 0, rank == n_stages - 1
    stash_k = min(n_micro, 2 * n_stages - 1)
    lag = 2 * (n_stages - 1)  # bwd of mb i at stage s runs at i + lag - s
    extra_leaves, extra_tree = tree_flatten(extras)

    zeros = torch.zeros_like(microbatches[0])
    incoming_a = incoming_g = zeros
    stash = [None] * stash_k
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=microbatches.device)
    d_stage = _zeros_like(stage_params)
    d_head = _zeros_like(head_params)
    d_mbs = torch.zeros_like(microbatches)
    with torch.no_grad():
        for t in range(n_micro + lag):
            # forward slot: microbatch f = t - rank; an invalid slot
            # writes no stash entry (a pending backward still reads it)
            f = t - rank
            a_out = zeros
            if 0 <= f < n_micro:
                a_in = microbatches[f] if first else incoming_a
                if last:
                    # the loss head's cotangent seeds this same tick's
                    # backward of f: one pass through stage and head
                    extra = extra_tree([e[f] for e in extra_leaves])
                    loss_mb, (d_stage_mb, d_head_mb, d_a_last) = _vjp(
                        lambda sp, hp, a: head_fn(hp, stage_fn(sp, a),
                                                  extra),
                        (stage_params, head_params, a_in), None)
                    loss_sum = loss_sum + loss_mb.float()
                    d_head = _add(d_head, d_head_mb)
                else:
                    stash[f % stash_k] = a_in
                    a_out = stage_fn(stage_params, a_in)
            # backward slot: microbatch b = t - (lag - rank), the stage
            # recomputed at its stashed input (on the last stage b == f,
            # done above)
            b = t - (lag - rank)
            d_a_in = zeros
            if 0 <= b < n_micro:
                if last:
                    d_a_in = d_a_last
                else:
                    _, (d_stage_mb, d_a_in) = _vjp(
                        stage_fn, (stage_params, stash[b % stash_k]),
                        incoming_g)
                d_stage = _add(d_stage, d_stage_mb)
                if first:
                    d_mbs[b] = d_a_in
            if fwd:
                incoming_a = _handoff(a_out, fwd, comm)
                incoming_g = _handoff(d_a_in, bwd, comm)
    return loss_sum, d_stage, d_head, d_mbs, token
