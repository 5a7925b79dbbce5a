"""Mixture-of-experts decoder transformer over a ``(dp, tp, sp)`` mesh.

Counterpart of ``mpi4jax_tpu/models/moe_transformer.py`` on PyTorch.
The dense transformer's training step (``models/transformer.py``) with
its MLP replaced by an expert-parallel MoE: the ``sp`` axis is both the
sequence axis of the attention and the expert axis of the MLP, so the
experts are cut over the same ranks whose token blocks they serve, and
the dispatch and combine are two ``alltoall``\\s a layer over sp.

Routing is local expert choice by default (each expert takes its
top-``capacity`` tokens of this rank's block, ``capacity = T_local /
E``: balanced by construction, every (source rank, expert) bucket of
one static shape) or token-choice top-k with capacity
(``routing="topk"``, ``parallel/moe.py``'s :func:`topk_route`), with the
Switch balance loss and the router z-loss as options.

The expert leaves ``w1e`` and ``w2e`` are this sp rank's experts
(:func:`param_specs` cuts them over sp on dimension 1); the step sums
their gradients over dp only (``models/transformer.py``'s
``make_global_train_step`` reads that from the specs).  The attention
is the dense model's: on the card, under ``"auto"``, the flash kernels.
"""

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mpi4jax_tpu_torch.models import transformer as _tfm
from mpi4jax_tpu_torch.models.transformer import (
    P,
    _attn_residual,
    _ce,
    _rmsnorm,
)
from mpi4jax_tpu_torch.ops.collectives import alltoall
from mpi4jax_tpu_torch.parallel.moe import (
    default_capacity,
    dropped_fraction,
    gate_sum,
    load_balancing_loss,
    router_z_loss,
    top_k,
    topk_route,
)
from mpi4jax_tpu_torch.utils.runtime import resolve_device

__all__ = [
    "MoEConfig",
    "MoEBlockParams",
    "MoEParams",
    "init_params",
    "param_specs",
    "active_params",
    "make_global_train_step",
    "reference_loss",
    "routing_report",
    "shard_params",
    "gather_params",
    "config_from_jax",
    "params_from_jax",
    "params_to_numpy",
]


class MoEConfig(NamedTuple):
    vocab: int = 64
    d_model: int = 32
    layers: int = 2
    heads: int = 4
    kv_heads: int = 2
    head_dim: int = 8
    experts: int = 4      # total experts; must divide by the sp size
    d_ff: int = 64        # per-expert FFN width
    eps: float = 1e-6
    routing: str = "expert_choice"  # or "topk" (GShard/Switch)
    router_k: int = 2     # experts per token under routing="topk"
    aux_weight: float = 0.0  # Switch load-balancing loss weight
    z_weight: float = 0.0    # ST-MoE router z-loss weight (typ. 1e-3)


class MoEBlockParams(NamedTuple):
    ln1: torch.Tensor  # (L, d)            replicated
    wq: torch.Tensor   # (L, d, Hq*dh)     column-sharded over tp
    wk: torch.Tensor   # (L, d, Hkv*dh)    column-sharded over tp
    wv: torch.Tensor   # (L, d, Hkv*dh)    column-sharded over tp
    wo: torch.Tensor   # (L, Hq*dh, d)     row-sharded over tp
    ln2: torch.Tensor  # (L, d)            replicated
    wr: torch.Tensor   # (L, d, E)         router, replicated
    w1e: torch.Tensor  # (L, E, d, F)      expert-sharded over sp (dim 1)
    w2e: torch.Tensor  # (L, E, F, d)      expert-sharded over sp (dim 1)


class MoEParams(NamedTuple):
    embed: torch.Tensor
    blocks: MoEBlockParams
    ln_f: torch.Tensor
    head: torch.Tensor


def _param_shapes(cfg):
    c = cfg
    L, d, dh, E = c.layers, c.d_model, c.head_dim, c.experts
    blocks = MoEBlockParams(
        ln1=(L, d), wq=(L, d, c.heads * dh), wk=(L, d, c.kv_heads * dh),
        wv=(L, d, c.kv_heads * dh), wo=(L, c.heads * dh, d), ln2=(L, d),
        wr=(L, d, E), w1e=(L, E, d, c.d_ff), w2e=(L, E, c.d_ff, d),
    )
    return MoEParams(embed=(c.vocab, d), blocks=blocks, ln_f=(d,),
                     head=(d, c.vocab))


def active_params(cfg):
    """``(n, n_active)``: all parameters, and those one token meets, as
    the JAX bench counts them for model FLOPs: one expert's FFN of the
    ``E`` a layer (``n − expert + expert // E``)."""
    shapes = _param_shapes(cfg)
    n = sum(math.prod(s) for s in _tfm._leaves(shapes))
    expert = math.prod(shapes.blocks.w1e) + math.prod(shapes.blocks.w2e)
    return n, n - expert + expert // cfg.experts


def init_params(cfg, *, generator, dtype=torch.float32, device="cuda"):
    """Parameters drawn from ``generator``: unit norms, and projections
    normal with std ``1/sqrt(fan_in)`` as the JAX package's
    ``init_params`` (the draws differ: a ``torch.Generator`` is not
    JAX's key stream).  Drawn in f32 on the generator's device, then
    cast to ``dtype`` on ``device``."""
    device = resolve_device(device)
    shapes = _param_shapes(cfg)

    def norm(shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * (1.0 / math.sqrt(fan_in))).to(device=device, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    s = shapes.blocks
    d, hd = cfg.d_model, cfg.heads * cfg.head_dim
    blocks = MoEBlockParams(
        ln1=ones(s.ln1), wq=norm(s.wq, d), wk=norm(s.wk, d),
        wv=norm(s.wv, d), wo=norm(s.wo, hd), ln2=ones(s.ln2),
        wr=norm(s.wr, d), w1e=norm(s.w1e, d), w2e=norm(s.w2e, cfg.d_ff),
    )
    return MoEParams(
        embed=norm(shapes.embed, d), blocks=blocks, ln_f=ones(shapes.ln_f),
        head=norm(shapes.head, d),
    )


def param_specs(tp_ax, sp_ax):
    """Each leaf's layout (``models/transformer.py``'s :class:`P`): the
    attention's projections over tp, the experts over sp (dimension 1 of
    ``w1e`` and ``w2e``), the rest replicated."""
    blocks = MoEBlockParams(
        ln1=P(None, None),
        wq=P(None, None, tp_ax),
        wk=P(None, None, tp_ax),
        wv=P(None, None, tp_ax),
        wo=P(None, tp_ax, None),
        ln2=P(None, None),
        wr=P(None, None, None),
        w1e=P(None, sp_ax, None, None),
        w2e=P(None, sp_ax, None, None),
    )
    return MoEParams(
        embed=P(None, None),
        blocks=blocks,
        ln_f=P(None),
        head=P(None, None),
    )


def _route_local(logits, n_experts):
    """Local expert-choice routing on this rank's ``(T, E)`` router
    logits: ``(gates, idx)``, each ``(E, capacity)``, expert ``e``
    taking its ``capacity = T // E`` highest-probability local tokens
    (the lower index first among equal probabilities, as
    ``lax.top_k``)."""
    t = logits.shape[0]
    if t % n_experts:
        raise ValueError(
            f"local token count {t} must be divisible by experts="
            f"{n_experts} (capacity-1 expert choice)"
        )
    cap = t // n_experts
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    return top_k(probs.T, cap)  # (E, cap) each


def _expert_ffn(recv, w1e, w2e):
    """Per-slot expert FFN: ``recv`` is (src, e_local, cap, d).
    ``jax.nn.gelu`` is the tanh approximation, and so is this one."""
    h = torch.einsum("seci,eif->secf", recv, w1e)
    h = F.gelu(h, approximate="tanh")
    return torch.einsum("secf,efi->seci", h, w2e)


def _route(xt, wr, cfg):
    """Dispatch-ready routing under either scheme: ``(gates, idx,
    buckets, aux)``, the first three expert-major ``(E, cap, ...)``
    (top-k buckets zero their unfilled and overflow slots, whose gate is
    zero too); ``aux`` the weighted auxiliary loss (balance + z), or
    None when both weights are zero."""
    logits = xt @ wr
    if cfg.routing == "topk":
        scores = torch.softmax(logits, dim=-1)
        cap = default_capacity(cfg.router_k, xt.shape[0], cfg.experts)
        idx, gates, valid = topk_route(scores, cfg.router_k, cap)
        buckets = xt[idx] * valid[..., None].to(xt.dtype)
    elif cfg.routing == "expert_choice":
        gates, idx = _route_local(logits, cfg.experts)
        scores, buckets = None, xt[idx]
    else:
        raise ValueError(
            f"cfg.routing must be 'expert_choice' or 'topk', got "
            f"{cfg.routing!r}"
        )
    aux = None
    if cfg.aux_weight or cfg.z_weight:
        aux = torch.zeros((), dtype=torch.float32, device=xt.device)
        if cfg.z_weight:
            aux = aux + cfg.z_weight * router_z_loss(logits)
        if cfg.aux_weight and cfg.routing == "topk":
            # expert choice is balanced by construction; the balance
            # loss applies to token choice only
            aux = aux + cfg.aux_weight * load_balancing_loss(
                scores, cfg.router_k)
    return gates, idx, buckets, aux


def _moe_ffn(h, wr, w1e, w2e, cfg, comm_ep, token):
    """MoE MLP: route, alltoall dispatch, expert FFN, alltoall combine,
    gate-weighted scatter-add.  ``h``: (b, s_local, d).  Returns ``(y,
    token)``, or ``(y, token, aux)`` when the config enables auxiliary
    router losses."""
    ep = comm_ep.size
    e_local = cfg.experts // ep
    b, s, d = h.shape
    xt = h.reshape(b * s, d)
    gates, idx, buckets, aux = _route(xt, wr, cfg)  # (E, cap, ...)
    # expert e lives on ep rank e // e_local: grouping experts by
    # destination is a reshape because the layout is contiguous
    cap = buckets.shape[1]
    send = buckets.reshape(ep, e_local, cap, d)
    recv, token = alltoall(send, comm=comm_ep, token=token)
    out = _expert_ffn(recv, w1e, w2e)  # (src, e_local, cap, d)
    back, token = alltoall(out, comm=comm_ep, token=token)
    vals = back.reshape(cfg.experts, cap, d)
    y = gate_sum(xt, idx, gates, vals).reshape(b, s, d)
    if aux is None:
        return y, token
    return y, token, aux


def _moe_mlp(h2, bp, cfg, comm_tp, comm_sp, token):
    """MLP-sublayer callback for the dense transformer's scaffold."""
    return _moe_ffn(h2, bp.wr, bp.w1e, bp.w2e, cfg, comm_sp, token)


def _axes(comm_tp, comm_sp):
    return _tfm._axis_name(comm_tp, "tp"), _tfm._axis_name(comm_sp, "sp")


def make_global_train_step(comm_dp, comm_tp, comm_sp, cfg, lr=1e-1, *,
                           remat=False, device="cuda"):
    """The MoE model's training step over a ``(dp, tp, sp)`` mesh of
    ranks, the MLP expert-sharded over sp: the dense model's step
    (``models/transformer.py``) with :func:`_moe_mlp` and
    :func:`param_specs`.  ``step(params, (tokens, targets)) ->
    (new_params, loss)``, ``params`` this rank's shards
    (:func:`shard_params`), left as they were (the JAX MoE step has no
    ``donate``).  Needs ``cfg.experts % comm_sp.size == 0``; under
    ``routing="expert_choice"`` each rank's token count must divide by
    ``cfg.experts`` too (raised at the step), while ``"topk"`` takes the
    ceiling capacity.  Under ``remat`` the recompute runs the layer's
    two alltoalls again."""
    if cfg.experts % comm_sp.size:
        raise ValueError(
            f"cfg.experts={cfg.experts} must be divisible by the "
            f"expert-parallel (sp) size {comm_sp.size}"
        )
    return _tfm.make_global_train_step(
        comm_dp, comm_tp, comm_sp, cfg, lr, mlp=_moe_mlp,
        specs=param_specs(*_axes(comm_tp, comm_sp)), remat=remat,
        donate=False, device=device,
    )


def _blocks(h2, dp, sp):
    """``(B, S, d)`` activations as the ``(dp·sp, T_local, d)`` token
    blocks the mesh's ranks hold."""
    b, s, d = h2.shape
    blocks = h2.reshape(dp, b // dp, sp, s // sp, d).transpose(1, 2)
    return blocks.reshape(dp * sp, (b // dp) * (s // sp), d)


def _unblocks(m, b, s, dp, sp):
    """The inverse of :func:`_blocks`."""
    d = m.shape[-1]
    m = m.reshape(dp, sp, b // dp, s // sp, d).transpose(1, 2)
    return m.reshape(b, s, d)


def reference_loss(params, tokens, targets, cfg, dp, sp):
    """Unsharded oracle of the sharded step's loss: the global batch
    cut into the same ``(dp, sp)`` token blocks the mesh holds, routed
    within each block (expert choice is per block); the expert FFN is
    pointwise per token, so where an expert lives does not change the
    value.  The auxiliary losses enter as the mean over blocks of each
    block's layer sum, as the step's mean of the ranks' losses."""
    tokens = torch.as_tensor(tokens, device=params.embed.device)
    targets = torch.as_tensor(targets, device=params.embed.device)
    b, s = tokens.shape
    x = params.embed[tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li in range(cfg.layers):
        bp = _tfm._layer(params.blocks, li)
        x = _attn_residual(x, bp, cfg)
        h2 = _rmsnorm(x, bp.ln2, cfg.eps)
        outs, auxes = [], []
        for xt in _blocks(h2, dp, sp):
            gates, idx, buckets, blk_aux = _route(xt, bp.wr, cfg)
            vals = _expert_ffn(buckets[None], bp.w1e, bp.w2e)[0]
            outs.append(gate_sum(xt, idx, gates, vals))
            if blk_aux is not None:
                auxes.append(blk_aux)
        if auxes:
            aux = aux + torch.stack(auxes).mean()
        x = x + _unblocks(torch.stack(outs), b, s, dp, sp)
    x = _rmsnorm(x, params.ln_f, cfg.eps)
    return _ce(x @ params.head, targets) + aux


@torch.no_grad()
def routing_report(params, tokens, cfg, dp=1, sp=1):
    """Router-quality diagnostics for ``routing="topk"``, unsharded,
    routed per ``(dp, sp)`` block as on the mesh: ``load`` ((E,)
    fraction of assignments per expert before capacity, averaged over
    blocks and layers; uniform = 1/E), ``balance_loss`` (the unweighted
    Switch loss), ``z_loss`` (the unweighted router z-loss) and
    ``dropped_fraction`` (the assignments that overflowed capacity), the
    last three floats.  Expert choice is balanced by construction, so
    the report refuses it."""
    if cfg.routing != "topk":
        raise ValueError(
            "routing_report applies to routing='topk' only; expert-"
            "choice routing is load-balanced by construction"
        )
    tokens = torch.as_tensor(tokens, device=params.embed.device)
    b, s = tokens.shape
    t_loc = (b // dp) * (s // sp)
    cap = default_capacity(cfg.router_k, t_loc, cfg.experts)
    x = params.embed[tokens]
    loads, balances, zs, drops = [], [], [], []
    for li in range(cfg.layers):
        bp = _tfm._layer(params.blocks, li)
        x_attn = _attn_residual(x, bp, cfg)
        h2 = _rmsnorm(x_attn, bp.ln2, cfg.eps)
        outs, stats = [], []
        for xt in _blocks(h2, dp, sp):
            logits = xt @ bp.wr
            probs = torch.softmax(logits, dim=-1)
            idx, gates, valid = topk_route(probs, cfg.router_k, cap)
            buckets = xt[idx] * valid[..., None].to(xt.dtype)
            vals = _expert_ffn(buckets[None], bp.w1e, bp.w2e)[0]
            outs.append(gate_sum(xt, idx, gates, vals))
            _, top = top_k(probs, cfg.router_k)
            counts = torch.zeros(cfg.experts, dtype=torch.float32,
                                 device=x.device).index_add(
                0, top.reshape(-1),
                torch.ones(top.numel(), dtype=torch.float32,
                           device=x.device))
            f = counts / (t_loc * cfg.router_k)
            stats.append((f, cfg.experts * torch.sum(f * probs.mean(0)),
                          router_z_loss(logits),
                          dropped_fraction(valid, t_loc, cfg.router_k)))
        f, bal, z, drop = (torch.stack(col) for col in zip(*stats))
        loads.append(f.mean(0))
        balances.append(bal.mean())
        zs.append(z.mean())
        drops.append(drop.mean())
        x = x_attn + _unblocks(torch.stack(outs), b, s, dp, sp)
    return {
        "load": torch.stack(loads).mean(0),
        "balance_loss": float(torch.stack(balances).mean()),
        "z_loss": float(torch.stack(zs).mean()),
        "dropped_fraction": float(torch.stack(drops).mean()),
    }


# ------------------- weights carried across ------------------------


def shard_params(params, comm_tp, comm_sp):
    """This rank's shards of full parameters (every rank passes the
    same ``params``): the attention's projections cut over tp as the
    dense model's, ``w1e`` and ``w2e`` over sp on their expert
    dimension, the rest copied whole (:func:`param_specs`)."""
    tp_ax, sp_ax = _axes(comm_tp, comm_sp)
    return _tfm._cut(params, param_specs(tp_ax, sp_ax),
                     [(comm_tp, tp_ax), (comm_sp, sp_ax)])


def gather_params(params, comm_tp, comm_sp):
    """The full parameters from every rank's shards (each rank gets
    them all): the inverse of :func:`shard_params`, a collective over
    ``comm_tp`` and ``comm_sp``."""
    tp_ax, sp_ax = _axes(comm_tp, comm_sp)
    return _tfm._join(params, param_specs(tp_ax, sp_ax),
                      [(comm_tp, tp_ax), (comm_sp, sp_ax)])


def config_from_jax(cfg_fields):
    """The port's :class:`MoEConfig` from a dict of the JAX
    ``MoEConfig``'s fields (``jax_cfg._asdict()``)."""
    unknown = set(cfg_fields) - set(MoEConfig._fields)
    if unknown:
        raise ValueError(f"unknown MoEConfig fields {sorted(unknown)}")
    return MoEConfig(**cfg_fields)


def params_from_jax(arrays, cfg, *, dtype=torch.float32, device="cuda",
                    comm_tp=None, comm_sp=None):
    """Port parameters on ``device`` from the JAX ``MoEParams`` leaves as
    numpy arrays (the same structure), each through float32 and cast to
    ``dtype``.  With ``comm_tp`` and ``comm_sp``, the full parameters
    land as this rank's shards (:func:`shard_params`)."""
    device = resolve_device(device)
    shapes = _param_shapes(cfg)

    def leaf(name, a, shape):
        a = np.asarray(a)
        if a.shape != tuple(shape):
            raise ValueError(
                f"{name} has shape {a.shape}, expected {tuple(shape)}"
            )
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=dtype)

    params = MoEParams(
        embed=leaf("embed", arrays.embed, shapes.embed),
        blocks=MoEBlockParams(*(
            leaf(f"blocks.{name}", getattr(arrays.blocks, name), shape)
            for name, shape in zip(MoEBlockParams._fields, shapes.blocks))),
        ln_f=leaf("ln_f", arrays.ln_f, shapes.ln_f),
        head=leaf("head", arrays.head, shapes.head),
    )
    if comm_tp is None and comm_sp is None:
        return params
    if comm_tp is None or comm_sp is None:
        raise ValueError("pass both comm_tp and comm_sp, or neither")
    return shard_params(params, comm_tp, comm_sp)


def params_to_numpy(params):
    """The parameters as numpy arrays, same structure; bf16 leaves come
    back as float32, which holds them exactly."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return MoEParams(
        embed=leaf(params.embed),
        blocks=MoEBlockParams(*(leaf(t) for t in params.blocks)),
        ln_f=leaf(params.ln_f),
        head=leaf(params.head),
    )
