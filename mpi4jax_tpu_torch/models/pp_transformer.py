"""Pipeline-parallel decoder transformer over a ``(dp, pp)`` mesh.

Counterpart of ``mpi4jax_tpu/models/pp_transformer.py`` on PyTorch: the
dense decoder of ``models/transformer.py`` (its config, parameters,
``dense_layer`` and ``reference_loss``, reused as they are) with its
layers cut into pipeline stages over ``pp``, scheduled by
``models/pipeline.py``: GPipe (``pipeline_apply``, differentiated by
autograd, the gradient riding the reversed handoff) or 1F1B
(``pipeline_train``, the backward built by hand).  Each dp group runs
its own pipeline on its rows of the batch.

The stage's attention is ``dense_layer``'s, the dense ``"xla"`` path, as
in the JAX package: no flash kernel runs on this path.

The gradient sync is written out (JAX's ``shard_map`` AD does part of
it): a block leaf is this stage's own, so it is summed over dp only;
``embed``, ``ln_f`` and ``head`` each get their gradient on one stage
(the embedding on stage 0, the head on the last), so their sum over pp
gives every stage the same gradient, then over dp; everything is
divided by dp.
"""

import functools

import torch

from mpi4jax_tpu_torch.models import transformer as _tfm
from mpi4jax_tpu_torch.models.pipeline import pipeline_apply, pipeline_train
from mpi4jax_tpu_torch.models.transformer import (
    P,
    TransformerConfig,
    _ce,
    _rmsnorm,
    dense_layer,
    init_params,
    reference_loss,
)
from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops.allreduce import allreduce
from mpi4jax_tpu_torch.parallel.longseq import _KeepInGraph
from mpi4jax_tpu_torch.utils.runtime import resolve_device

__all__ = [
    "TransformerConfig",
    "init_params",
    "reference_loss",
    "param_specs",
    "shard_params",
    "gather_params",
    "make_global_train_step",
]

SCHEDULES = ("gpipe", "1f1b")


def param_specs(pp_ax):
    """Each leaf's layout (``models/transformer.py``'s :class:`P`): the
    block leaves cut into stages over ``pp`` on their layer axis,
    everything else replicated (no tp in the pipeline variant)."""
    dense = _tfm.param_specs(None)
    blocks = type(dense.blocks)(*(P(pp_ax, *spec[1:])
                                  for spec in dense.blocks))
    return dense._replace(blocks=blocks)


def _pp_axis(comm_pp):
    return _tfm._axis_name(comm_pp, "pp")


def shard_params(params, comm_pp):
    """This rank's stage of full parameters (every rank passes the same
    ``params``): layers ``[s·L/S, (s+1)·L/S)`` of every block leaf, the
    rest copied whole (:func:`param_specs`)."""
    ax = _pp_axis(comm_pp)
    return _tfm._cut(params, param_specs(ax), [(comm_pp, ax)])


def gather_params(params, comm_pp):
    """The full parameters from every stage's (each rank gets them
    all): the inverse of :func:`shard_params`, a collective over
    ``comm_pp``.  The replicated leaves are this rank's own."""
    ax = _pp_axis(comm_pp)
    return _tfm._join(params, param_specs(ax), [(comm_pp, ax)])


def _stage_fn(cfg, stage_blocks, a):
    """This rank's layers in order over the activation (shape-
    preserving, as the pipeline's wire requires)."""
    for i in range(stage_blocks.ln1.shape[0]):
        a = dense_layer(a, _tfm._layer(stage_blocks, i), cfg)
    return a


def _summed(x, comms):
    for comm in comms:
        if comm.size > 1:
            x, _ = allreduce(x, reductions.SUM, comm=comm)
    return x


def _sync_grads(grads, comm_dp, comm_pp):
    """The step's gradient sync: block leaves summed over dp, the
    replicated ``embed``, ``ln_f`` and ``head`` over pp then dp (each is
    nonzero on one stage only); all divided by dp."""
    dp = float(comm_dp.size)
    rep = [comm_pp, comm_dp]

    def mean(g, comms):
        g = _summed(g, comms)
        return g if dp == 1.0 else g / dp

    return grads._replace(
        embed=mean(grads.embed, rep),
        blocks=type(grads.blocks)(*(mean(g, [comm_dp])
                                    for g in grads.blocks)),
        ln_f=mean(grads.ln_f, rep),
        head=mean(grads.head, rep),
    )


def make_global_train_step(comm_dp, comm_pp, cfg, n_micro, lr=1e-1,
                           schedule="gpipe", *, device="cuda"):
    """The training step over a ``(dp, pp)`` mesh of ranks: forward,
    backward and one SGD update.

    ``step(params, (tokens, targets)) -> (new_params, loss)``:
    ``params`` are this rank's stage (:func:`shard_params`); ``tokens``
    and ``targets`` the global ``[B, S]`` int batch, the same on every
    rank, of which each dp group takes its rows and runs them as
    ``n_micro`` microbatches through ``comm_pp.size`` stages.  ``loss``
    is f32 of shape ``[1]``, the mean over the whole batch, the same on
    every rank.  The new parameters are new tensors; the caller's stay
    as they were (JAX's step has no ``donate``).

    ``schedule``: ``"gpipe"`` differentiates :func:`pipeline_apply` with
    autograd (all forwards, then all backwards; the graph holds every
    microbatch's residuals), ``"1f1b"`` runs :func:`pipeline_train`
    (bounded in-flight activations, the stage recomputed in its
    backward).  Needs ``cfg.layers`` divisible by the pp size and each
    dp group's rows by ``n_micro``.  Every rank of the mesh calls the
    step in the same order.
    """
    if schedule not in SCHEDULES:
        raise ValueError(
            f"schedule must be 'gpipe' or '1f1b', got {schedule!r}"
        )
    stages = comm_pp.size
    if cfg.layers % stages:
        raise ValueError(
            f"cfg.layers={cfg.layers} must be divisible by the pipeline "
            f"size {stages} (equal layer slices per stage)"
        )
    device = resolve_device(device)
    dp_rank, last = comm_dp.rank(), comm_pp.rank() == stages - 1
    stage = functools.partial(_stage_fn, cfg)

    def head_fn(hp, a, tgt):
        ln_f, head = hp
        return _ce(_rmsnorm(a, ln_f, cfg.eps) @ head, tgt)

    def rows(t, like):
        t = torch.as_tensor(t, device=like.device)
        b = t.shape[0]
        if b % comm_dp.size:
            raise ValueError(
                f"the global batch {b} must be divisible by its mesh "
                f"axis's {comm_dp.size} ranks"
            )
        bl = b // comm_dp.size
        return t[dp_rank * bl:(dp_rank + 1) * bl]

    def gpipe(params, tokens, targets, b_loc, s):
        """Loss and gradients by autograd through the pipeline: the
        loss off the last stage is zero, tied to the outputs so that the
        rank's backward makes every transposed exchange."""
        leaves = _tfm._leaves(params)
        views = [p.detach().requires_grad_(True) for p in leaves]
        p = _tfm._from_leaves(views, params)
        mbs = p.embed[tokens].reshape(n_micro, b_loc // n_micro, s, -1)
        out, _ = pipeline_apply(stage, p.blocks, mbs, comm_pp)
        if last:
            h = _rmsnorm(out.reshape(b_loc, s, -1), p.ln_f, cfg.eps)
            loss = _ce(h @ p.head, targets)
        else:
            loss = _KeepInGraph.apply(
                torch.zeros((), dtype=torch.float32, device=out.device), out)
        grads = torch.autograd.grad(loss, views, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), _tfm._from_leaves(list(grads), params)

    def one_f_one_b(params, tokens, targets, b_loc, s):
        """Loss and gradients from the 1F1B schedule: the means over
        the microbatches, the embedding's gradient scattered from the
        microbatches' on stage 0."""
        mb = b_loc // n_micro
        mbs = params.embed[tokens].reshape(n_micro, mb, s, -1)
        loss_sum, d_blocks, (d_ln_f, d_head), d_mbs, _ = pipeline_train(
            stage, params.blocks, head_fn, (params.ln_f, params.head),
            mbs, targets.reshape(n_micro, mb, s), comm_pp)
        dx = d_mbs.reshape(b_loc * s, -1) / n_micro
        d_embed = torch.zeros_like(params.embed).index_add_(
            0, tokens.reshape(-1), dx.to(params.embed.dtype))
        grads = params._replace(
            embed=d_embed,
            blocks=type(d_blocks)(*(g / n_micro for g in d_blocks)),
            ln_f=d_ln_f / n_micro, head=d_head / n_micro)
        return loss_sum / n_micro, grads

    run = gpipe if schedule == "gpipe" else one_f_one_b

    def step(params, batch):
        if params.embed.device.type != device.type:
            raise ValueError(
                f"params are on {params.embed.device}, the step was made "
                f"for {device}"
            )
        tokens, targets = (rows(t, params.embed) for t in batch)
        b_loc, s = tokens.shape
        if b_loc % n_micro:
            raise ValueError(
                f"per-dp-group batch {b_loc} must be divisible by "
                f"n_micro={n_micro}"
            )
        loss, grads = run(params, tokens, targets, b_loc, s)
        with torch.no_grad():
            grads = _sync_grads(grads, comm_dp, comm_pp)
            new = [p - lr * g for p, g in zip(_tfm._leaves(params),
                                               _tfm._leaves(grads))]
            # the last stage's loss (zero elsewhere) summed over pp, the
            # dp groups' mean
            loss = _summed(loss.float().reshape(1), [comm_pp, comm_dp])
            loss = loss / comm_dp.size
        return _tfm._from_leaves(new, params), loss

    return step
