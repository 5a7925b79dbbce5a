"""Decoder transformer: greedy decoding with a KV cache.

Counterpart of the inference half of ``mpi4jax_tpu/models/transformer.py``
on PyTorch: the configuration and parameters (stacked ``(L, ...)``
leaves with the JAX package's names, so carrying weights across is a
copy per leaf), the layer math, the unsharded full-recompute oracle
:func:`reference_greedy_decode`, and :func:`make_global_decode` — a
batched causal prefill over the prompt that fills the cache, then one
cached step per generated token.  A long prompt's prefill runs the
hand-written CUDA flash-attention kernel (``prefill_impl="flash"``).

This slice runs one rank: the comms are a one-rank ``("dp", "tp")``
``MeshComm``'s sub-communicators, so the Megatron f/g collectives are
identities (they stay in the code, where a tensor-parallel run needs
them).  Larger comms raise naming :data:`~mpi4jax_tpu_torch.parallel.comm.MULTI_RANK_ITEM`.
The training step and ``sampler="categorical"`` are not ported yet.

Where the JAX package returns new arrays, the decoder here writes the
KV cache in place: one cache per decode call, each position written
once.
"""

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops.allreduce import allreduce
from mpi4jax_tpu_torch.parallel.comm import MULTI_RANK_ITEM
from mpi4jax_tpu_torch.parallel.longseq import local_attention
from mpi4jax_tpu_torch.utils.runtime import resolve_device

__all__ = [
    "TransformerConfig",
    "BlockParams",
    "TransformerParams",
    "init_params",
    "make_global_decode",
    "reference_greedy_decode",
    "config_from_jax",
    "params_from_jax",
    "params_to_numpy",
]

SAMPLER_ITEM = (
    "ROADMAP.md Queue 1 item 12 (categorical sampling in the decoder: "
    "the JAX package's threefry key stream)"
)


class TransformerConfig(NamedTuple):
    vocab: int = 64
    d_model: int = 32
    layers: int = 2
    heads: int = 4
    kv_heads: int = 2  # < heads = grouped-query attention
    head_dim: int = 8
    d_ff: int = 64
    eps: float = 1e-6
    # single-device attention kernel of the training forward ("auto" /
    # "flash" / "xla", see parallel.longseq.local_attention); kept for
    # the JAX package's configurations, read by no ported path yet
    attn_impl: str = "auto"
    # >0: the training loss in token chunks of this size (not ported)
    ce_chunk: int = 0


class BlockParams(NamedTuple):
    ln1: torch.Tensor  # (L, d)
    wq: torch.Tensor   # (L, d, Hq*dh)
    wk: torch.Tensor   # (L, d, Hkv*dh)
    wv: torch.Tensor   # (L, d, Hkv*dh)
    wo: torch.Tensor   # (L, Hq*dh, d)
    ln2: torch.Tensor  # (L, d)
    w1: torch.Tensor   # (L, d, F)
    w2: torch.Tensor   # (L, F, d)


class TransformerParams(NamedTuple):
    embed: torch.Tensor  # (V, d)
    blocks: BlockParams
    ln_f: torch.Tensor   # (d,)
    head: torch.Tensor   # (d, V)


def _param_shapes(cfg):
    c = cfg
    L, d, dh = c.layers, c.d_model, c.head_dim
    blocks = BlockParams(
        ln1=(L, d), wq=(L, d, c.heads * dh), wk=(L, d, c.kv_heads * dh),
        wv=(L, d, c.kv_heads * dh), wo=(L, c.heads * dh, d), ln2=(L, d),
        w1=(L, d, c.d_ff), w2=(L, c.d_ff, d),
    )
    return TransformerParams(embed=(c.vocab, d), blocks=blocks, ln_f=(d,),
                             head=(d, c.vocab))


def init_params(cfg, *, generator, dtype=torch.float32, device="cuda"):
    """Parameters drawn from ``generator``: unit norms, and projections
    normal with std ``1/sqrt(fan_in)`` as the JAX package's
    ``init_params`` (the draws themselves differ: a ``torch.Generator``
    is not JAX's key stream).  Drawn in f32 on the generator's device,
    then cast to ``dtype`` on ``device``."""
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
    blocks = BlockParams(
        ln1=ones(s.ln1), wq=norm(s.wq, d), wk=norm(s.wk, d),
        wv=norm(s.wv, d), wo=norm(s.wo, hd), ln2=ones(s.ln2),
        w1=norm(s.w1, d), w2=norm(s.w2, cfg.d_ff),
    )
    return TransformerParams(
        embed=norm(shapes.embed, d), blocks=blocks, ln_f=ones(shapes.ln_f),
        head=norm(shapes.head, d),
    )


def _check_tp_divisibility(cfg, tp):
    for name, heads in (("heads", cfg.heads), ("kv_heads", cfg.kv_heads)):
        if heads % tp:
            raise ValueError(
                f"cfg.{name}={heads} must be divisible by the tensor-"
                f"parallel size {tp} (each tp rank owns "
                f"{name}/tp heads; for MQA-style configs with fewer kv "
                f"heads than tp ranks, replicate kv heads to tp first)"
            )


def _layer(blocks, i):
    """Layer ``i``'s slice of the stacked block parameters."""
    return BlockParams(*(t[i] for t in blocks))


def _rmsnorm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g


class _FCollective(torch.autograd.Function):
    """Megatron "f": identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out, _ = allreduce(grad, reductions.SUM, comm=ctx.comm)
        return out, None


def _f_collective(x, comm, token):
    """Megatron "f" over ``comm``; returns ``(x, token)``."""
    return _FCollective.apply(x, comm), token


def _dense_mlp(h2, bp, comm_tp, token):
    """Megatron MLP: column-sharded up, row-sharded down, g-allreduce.
    ``jax.nn.gelu`` is the tanh approximation, and so is this one."""
    h2, token = _f_collective(h2, comm_tp, token)
    m_part = F.gelu(h2 @ bp.w1, approximate="tanh") @ bp.w2
    return allreduce(m_part, reductions.SUM, comm=comm_tp, token=token)


def _attn_residual(x, bp, cfg):
    """Unsharded attention sublayer: ln1 → QKV → causal attention → wo,
    plus the residual."""
    b, s, _ = x.shape
    h = _rmsnorm(x, bp.ln1, cfg.eps)
    q = (h @ bp.wq).reshape(b, s, cfg.heads, cfg.head_dim)
    k = (h @ bp.wk).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    v = (h @ bp.wv).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    attn = local_attention(q, k, v, causal=True, impl="xla")
    return x + attn.reshape(b, s, -1) @ bp.wo


def dense_layer(x, bp, cfg):
    """One full unsharded decoder layer (attention + dense MLP)."""
    x = _attn_residual(x, bp, cfg)
    h2 = _rmsnorm(x, bp.ln2, cfg.eps)
    return x + F.gelu(h2 @ bp.w1, approximate="tanh") @ bp.w2


# --------------------------- inference -----------------------------


def _check_sampler(sampler, temperature, top_k, vocab):
    if sampler not in ("greedy", "categorical"):
        raise ValueError(
            f"sampler must be 'greedy' or 'categorical', got {sampler!r}"
        )
    if sampler == "greedy":
        # greedy ignores both knobs — setting one is a forgotten
        # sampler="categorical", not a request for deterministic output
        if temperature != 1.0 or top_k is not None:
            raise ValueError(
                "temperature/top_k only apply to sampler='categorical' "
                f"(got sampler='greedy' with temperature={temperature}, "
                f"top_k={top_k})"
            )
        return
    if not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if top_k is not None and (
        int(top_k) != top_k or not 0 < int(top_k) <= vocab
    ):
        raise ValueError(
            f"top_k must be an integer in (0, vocab={vocab}], got {top_k!r}"
        )


def _choose_token(logits):
    """The greedy next token from ``[B, V]`` logits — the single copy
    shared by the decoder and the oracle: the first index of the
    maximum, as ``jnp.argmax`` (and ``torch.argmax``) pick it."""
    return torch.argmax(logits, dim=-1)


def _new_cache(cfg, b, max_len, hk_l, like):
    return torch.zeros(
        (cfg.layers, 2, b, max_len, hk_l, cfg.head_dim),
        dtype=like.dtype, device=like.device,
    )


def _decode_step_sharded(params, cache, last_tok, pos, cfg, comm_tp, hq_l,
                         hk_l):
    """One decode step on the local tp shard: embed the last token,
    write its K/V at ``pos`` (in place), attend over the cache view
    with positions <= ``pos`` visible, run the MLP, and return the
    position's logits — the caller picks the next token.

    ``cache``: (layers, 2, B, S_view, Hkv_local, dh), a view of the
    decoder's cache; ``last_tok``: (B,) int; ``pos``: Python int.
    Returns ``(cache, logits)``.
    """
    dh = cfg.head_dim
    b = last_tok.shape[0]
    x = params.embed[last_tok][:, None, :]  # (B, 1, d)
    token = None
    for i in range(cfg.layers):
        bp = _layer(params.blocks, i)
        h = _rmsnorm(x, bp.ln1, cfg.eps)
        h, token = _f_collective(h, comm_tp, token)
        q = (h @ bp.wq).reshape(b, 1, hq_l, dh)
        cache[i, 0, :, pos] = (h @ bp.wk).reshape(b, hk_l, dh)
        cache[i, 1, :, pos] = (h @ bp.wv).reshape(b, hk_l, dh)
        # attend over positions <= pos (masked full-view attention;
        # q_offset=pos makes the causal mask pass exactly those)
        attn = local_attention(
            q, cache[i, 0], cache[i, 1], causal=True, q_offset=pos,
            impl="xla",
        )
        a_part = attn.reshape(b, 1, hq_l * dh) @ bp.wo
        a, token = allreduce(a_part, reductions.SUM, comm=comm_tp,
                             token=token)
        x = x + a
        h2 = _rmsnorm(x, bp.ln2, cfg.eps)
        m, token = _dense_mlp(h2, bp, comm_tp, token)
        x = x + m
    x = _rmsnorm(x, params.ln_f, cfg.eps)
    return cache, (x @ params.head)[:, 0, :]  # (B, V)


def _attention_fn(impl):
    """The prefill's causal attention: ``local_attention`` with ``impl``
    ("xla", "flash" or "auto"), or ``impl`` itself when it is a function
    with ``local_attention``'s ``(q, k, v, *, causal)`` signature (a
    caller holding the flash kernel against its plain version passes
    one)."""
    if callable(impl):
        return impl

    def attend(q, k, v, *, causal):
        return local_attention(q, k, v, causal=causal, impl=impl)

    return attend


def _prefill_sharded(params, prompt, cfg, comm_tp, hq_l, hk_l, max_len,
                     impl="xla", logits_pos=None):
    """Batched prefill on the local tp shard: one causal forward pass
    over the whole prompt, writing every prompt position's K/V into a
    new ``max_len`` cache, whose later positions stay zero.

    Identical math to running :func:`_decode_step_sharded` position by
    position.  Returns ``(cache, logits)`` with the last prompt
    position's ``[B, V]`` logits, or those of position ``logits_pos``.
    ``impl`` is passed to ``local_attention`` (see :func:`_attention_fn`).
    """
    attend = _attention_fn(impl)
    dh = cfg.head_dim
    b, p_len = prompt.shape
    x = params.embed[prompt]  # (B, P, d)
    cache = _new_cache(cfg, b, max_len, hk_l, params.embed)
    token = None
    for i in range(cfg.layers):
        bp = _layer(params.blocks, i)
        h = _rmsnorm(x, bp.ln1, cfg.eps)
        h, token = _f_collective(h, comm_tp, token)
        q = (h @ bp.wq).reshape(b, p_len, hq_l, dh)
        k = (h @ bp.wk).reshape(b, p_len, hk_l, dh)
        v = (h @ bp.wv).reshape(b, p_len, hk_l, dh)
        attn = attend(q, k, v, causal=True)
        a_part = attn.reshape(b, p_len, hq_l * dh) @ bp.wo
        a, token = allreduce(a_part, reductions.SUM, comm=comm_tp,
                             token=token)
        x = x + a
        h2 = _rmsnorm(x, bp.ln2, cfg.eps)
        m, token = _dense_mlp(h2, bp, comm_tp, token)
        x = x + m
        cache[i, 0, :, :p_len] = k
        cache[i, 1, :, :p_len] = v
    last = x[:, -1] if logits_pos is None else x[:, logits_pos]
    return cache, _rmsnorm(last, params.ln_f, cfg.eps) @ params.head


def _greedy_decode(params, prompt, cfg, max_len, *, comm_tp, batched,
                   kv_bucket, prefill_impl):
    """The decoder behind :func:`make_global_decode` (arguments already
    validated).  ``prompt``: [B, P] int on the parameters' device."""
    tp = comm_tp.size
    hq_l, hk_l = cfg.heads // tp, cfg.kv_heads // tp
    b, p_len = prompt.shape
    if p_len > max_len:
        raise ValueError(
            f"prompt length {p_len} exceeds max_len={max_len} "
            f"(the decoder's static sequence budget)"
        )
    out = torch.zeros((b, max_len), dtype=prompt.dtype, device=prompt.device)
    out[:, :p_len] = prompt

    if batched and p_len > 1:
        cache, pre_logits = _prefill_sharded(
            params, prompt, cfg, comm_tp, hq_l, hk_l, max_len,
            impl=prefill_impl,
        )
        if p_len < max_len:
            # the token at position p_len is chosen from position
            # p_len - 1's logits
            out[:, p_len] = _choose_token(pre_logits)
        start = p_len  # positions start..max_len-2 remain
    else:
        cache = _new_cache(cfg, b, max_len, hk_l, params.embed)
        start = 0

    def step(view, pos):
        _, logits = _decode_step_sharded(
            params, view, out[:, pos], pos, cfg, comm_tp, hq_l, hk_l
        )
        # inside the prompt, keep the given token; past it, append the
        # chosen one
        if pos + 1 >= p_len:
            out[:, pos + 1] = _choose_token(logits)

    if kv_bucket is None:
        for pos in range(start, max_len - 1):
            step(cache, pos)
    else:
        # bucketed KV growth: segment s runs positions
        # [prev, min(end_s, max_len-1)) on a cache view of length end_s,
        # so each step reads ceil((pos+1)/N)·N positions, not max_len.
        # Positions past those written are zero, as the JAX package's
        # zero-padded view holds them.
        ends = list(range((start // kv_bucket + 1) * kv_bucket, max_len,
                          kv_bucket))
        ends.append(max_len)
        prev = start
        for end in ends:
            view = cache[:, :, :, :end]
            hi = min(end, max_len - 1)
            for pos in range(prev, hi):
                step(view, pos)
            prev = hi
    return out


def make_global_decode(comm_dp, comm_tp, cfg, max_len, *, prefill="batched",
                       kv_bucket=None, prefill_impl="xla", sampler="greedy",
                       temperature=1.0, top_k=None, device="cuda"):
    """Greedy autoregressive decoder.

    ``decode(params, prompt)``: ``prompt`` is ``[B, P]`` int (a tensor or
    array).  ``prefill="batched"`` (default) processes the whole prompt
    in one causal forward pass that fills the KV cache;
    ``prefill="stepwise"`` runs the prompt position by position through
    the cached step (same math).  Then generates ``max_len - P`` greedy
    tokens.  Returns ``[B, max_len]`` on ``device``, in the prompt's
    dtype — the prompt followed by the continuation.  Matches
    :func:`reference_greedy_decode`.

    ``prefill_impl`` picks the batched prefill's attention: ``"xla"``
    (dense scores) or ``"flash"`` (the flash kernel; on the card, the
    hand-written CUDA kernel) for long prompts.  ``kv_bucket=N`` runs
    the generate loop on a cache view whose length grows by N per
    segment, so each step reads ``ceil((pos+1)/N)·N`` positions instead
    of the full ``max_len`` budget; token-exact against the un-bucketed
    loop.

    There is no mesh argument: the comms carry the layout, one rank in
    this slice.  ``sampler="categorical"`` is validated as the JAX
    package validates it, then raises ``NotImplementedError``.
    """
    for name, comm in (("comm_dp", comm_dp), ("comm_tp", comm_tp)):
        if comm.size != 1:
            raise NotImplementedError(
                f"{name} has {comm.size} ranks; the decoder runs on one "
                f"rank in this port: {MULTI_RANK_ITEM}"
            )
    _check_tp_divisibility(cfg, comm_tp.size)
    if prefill not in ("batched", "stepwise"):
        raise ValueError(
            f"prefill must be 'batched' or 'stepwise', got {prefill!r}"
        )
    if prefill_impl not in ("xla", "flash"):
        raise ValueError(
            f"prefill_impl must be 'xla' or 'flash', got {prefill_impl!r}"
        )
    _check_sampler(sampler, temperature, top_k, cfg.vocab)
    if kv_bucket is not None and (
        int(kv_bucket) != kv_bucket or not 0 < int(kv_bucket) <= max_len
    ):
        raise ValueError(
            f"kv_bucket must be an integer in (0, max_len={max_len}], "
            f"got {kv_bucket!r}"
        )
    if sampler != "greedy":
        raise NotImplementedError(
            f"sampler={sampler!r} is not ported yet: {SAMPLER_ITEM}"
        )
    device = resolve_device(device)
    bucket = None if kv_bucket is None else int(kv_bucket)

    @torch.no_grad()
    def decode(params, prompt):
        if params.embed.device.type != device.type:
            raise ValueError(
                f"params are on {params.embed.device}, the decoder was "
                f"made for {device}"
            )
        prompt = torch.as_tensor(prompt, device=params.embed.device)
        return _greedy_decode(
            params, prompt, cfg, max_len, comm_tp=comm_tp,
            batched=prefill == "batched", kv_bucket=bucket,
            prefill_impl=prefill_impl,
        )

    return decode


@torch.no_grad()
def reference_greedy_decode(params, prompt, cfg, max_len):
    """Unsharded oracle: full-sequence recompute per position, dense
    attention (``impl="xla"``).  ``prompt``: ``[B, P]`` int tensor on the
    parameters' device."""
    b, p_len = prompt.shape
    if p_len > max_len:
        raise ValueError(
            f"prompt length {p_len} exceeds max_len={max_len}"
        )
    out = torch.zeros((b, max_len), dtype=prompt.dtype, device=prompt.device)
    out[:, :p_len] = prompt
    for pos in range(max_len - 1):
        x = params.embed[out]
        for i in range(cfg.layers):
            x = dense_layer(x, _layer(params.blocks, i), cfg)
        x = _rmsnorm(x, params.ln_f, cfg.eps)
        logits = x[:, pos] @ params.head  # (B, V)
        if pos + 1 >= p_len:
            out[:, pos + 1] = _choose_token(logits)
    return out


# ------------------- weights carried across ------------------------


def config_from_jax(cfg_fields):
    """The port's :class:`TransformerConfig` from a dict of the JAX
    ``TransformerConfig``'s fields (``jax_cfg._asdict()``)."""
    unknown = set(cfg_fields) - set(TransformerConfig._fields)
    if unknown:
        raise ValueError(
            f"unknown TransformerConfig fields {sorted(unknown)}"
        )
    return TransformerConfig(**cfg_fields)


def params_from_jax(arrays, cfg, *, dtype=torch.float32, device="cuda"):
    """Port parameters on ``device`` from the JAX ``TransformerParams``
    leaves as numpy arrays (the same structure: ``embed``, ``blocks``
    with its eight fields, ``ln_f``, ``head``).  bf16 arrives as
    ``ml_dtypes.bfloat16`` numpy; every leaf goes through float32, which
    holds bf16 exactly, and is cast to ``dtype``."""
    device = resolve_device(device)
    shapes = _param_shapes(cfg)

    def leaf(name, a, shape):
        a = np.asarray(a)
        if a.shape != tuple(shape):
            raise ValueError(
                f"{name} has shape {a.shape}, expected {tuple(shape)}"
            )
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=dtype
        )

    blocks = BlockParams(*(
        leaf(f"blocks.{name}", getattr(arrays.blocks, name), shape)
        for name, shape in zip(BlockParams._fields, shapes.blocks)
    ))
    return TransformerParams(
        embed=leaf("embed", arrays.embed, shapes.embed),
        blocks=blocks,
        ln_f=leaf("ln_f", arrays.ln_f, shapes.ln_f),
        head=leaf("head", arrays.head, shapes.head),
    )


def params_to_numpy(params):
    """The parameters as numpy arrays, same structure; bf16 leaves come
    back as float32 (numpy has no bfloat16), which holds them exactly."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return TransformerParams(
        embed=leaf(params.embed),
        blocks=BlockParams(*(leaf(t) for t in params.blocks)),
        ln_f=leaf(params.ln_f),
        head=leaf(params.head),
    )
