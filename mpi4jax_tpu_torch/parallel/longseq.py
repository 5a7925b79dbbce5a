"""Long-context attention: the single-device core and the sequence-
parallel schemes around it.

Counterpart of ``mpi4jax_tpu/parallel/longseq.py``:

* :func:`local_attention` with grouped-query heads and causal offsets,
  dense (the oracle) or through the flash kernels;
* :func:`ring_attention`: blockwise attention with an online softmax,
  the KV blocks rotating around a 1-D communicator through
  :func:`~mpi4jax_tpu_torch.ops.p2p.sendrecv_multi`, with the
  contiguous and the zigzag (balanced causal) layouts;
* :func:`ulysses_attention`: an all-to-all head<->sequence reshard
  around full-sequence :func:`local_attention`;
* :func:`zigzag_indices`, :func:`zigzag_shard`, :func:`zigzag_unshard`.

Both schemes take their one-rank shortcut to :func:`local_attention`.
Their gradients are autograd's, through the ops' rules: the ring's
cotangents travel back around the ring by the ``sendrecv`` transpose,
Ulysses's through the ``alltoall`` one.  A rank runs its backward
collectives in the reverse of the order it made them (autograd runs
the ready node made last first), so every rank must make the same
collectives in the same order and keep each in its backward: the ring
ties a block a causal rank skips to its accumulator
(:class:`_KeepInGraph`), where JAX's ``lax.cond`` keeps both branches'
transposes in the program.
"""

import math

import numpy as np
import torch

from mpi4jax_tpu_torch.kernels.flash import _NEG  # finite mask value
from mpi4jax_tpu_torch.kernels.flash import flash_supported
from mpi4jax_tpu_torch.ops._core import as_token, publishes_token
from mpi4jax_tpu_torch.ops.collectives import alltoall
from mpi4jax_tpu_torch.ops.p2p import sendrecv_multi

__all__ = ["local_attention", "ring_attention", "ulysses_attention",
           "zigzag_indices", "zigzag_shard", "zigzag_unshard"]


def _check_gqa(hq, hk, where):
    if hq % hk:
        raise ValueError(
            f"{where}: query heads must be a multiple of kv heads "
            f"(grouped-query attention), got Hq={hq}, Hkv={hk}"
        )


def _scores(q, k, scale):
    """q·kᵀ with GQA support: query head h attends kv head ``h // g``
    (g = Hq/Hkv).  Returns [B, Hq, Tq, Tk] f32 scores (the operands are
    widened to f32, so bf16 products are exact and summed in f32)."""
    b, tq, hq, d = q.shape
    hk = k.shape[2]
    qf, kf = q.float(), k.float()
    if hq == hk:
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    else:
        _check_gqa(hq, hk, "attention")
        g = hq // hk
        s = torch.einsum(
            "bqhgd,bkhd->bhgqk", qf.reshape(b, tq, hk, g, d), kf
        ).reshape(b, hq, tq, k.shape[1])
    return s * scale


def _weighted_values(w, v, hq):
    """w·v with GQA support; ``w``: [B, Hq, Tq, Tk], ``v``: [B, Tk, Hkv,
    D].  Accumulates in f32 and returns v's dtype."""
    hk = v.shape[2]
    wf, vf = w.float(), v.float()
    if hq == hk:
        out = torch.einsum("bhqk,bkhd->bqhd", wf, vf)
    else:
        g = hq // hk
        b, _, tq, tk = w.shape
        out = torch.einsum(
            "bhgqk,bkhd->bqhgd", wf.reshape(b, hk, g, tq, tk), vf
        ).reshape(b, tq, hq, v.shape[-1])
    return out.to(v.dtype)


def local_attention(q, k, v, *, causal=False, scale=None, q_offset=0,
                    k_offset=0, impl="auto"):
    """Single-device attention: softmax(q k^T) v.

    ``q``: [B, Tq, Hq, D]; ``k``/``v``: [B, Tk, Hkv, D] with
    ``Hq % Hkv == 0`` — grouped-query attention (query head h attends
    kv head ``h // (Hq/Hkv)``).  ``*_offset`` are the global positions
    of the first row/column (for causal masking of sharded blocks).
    Accumulates in float32.

    ``impl``: ``"xla"`` — dense (materialises the [Tq, Tk] scores, the
    oracle; the name is the JAX package's); ``"flash"`` — the flash
    kernels (``ops/flash.py``), which raise on operands they cannot run;
    ``"auto"`` — decided from the operands before any launch
    (``kernels.flash.flash_supported``): flash for CUDA tensors the
    kernels cover (f32 or bf16, D in {32, 64, 128}) with at least 128
    query rows, dense for everything else, so it computes wherever the
    dense path does, as the JAX package's ``"auto"`` does off the TPU.
    """
    _check_gqa(q.shape[2], k.shape[2], "local_attention")
    if impl == "auto":
        impl = "flash" if flash_supported(q, k, v) else "xla"
    if impl == "flash":
        from mpi4jax_tpu_torch.ops.flash import flash_attention

        return flash_attention(
            q, k, v, causal=causal, scale=scale,
            q_offset=q_offset, k_offset=k_offset,
        )
    if impl != "xla":
        raise ValueError(
            f"impl must be 'auto', 'flash' or 'xla', got {impl!r}"
        )
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    s = _scores(q, k, scale)
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, _NEG)
    w = torch.softmax(s, dim=-1)
    out = _weighted_values(w.to(v.dtype), v, q.shape[2])
    return out.to(q.dtype)




def zigzag_indices(p, t_global):
    """Global sequence positions each rank holds under the zigzag layout.

    Rank r holds chunks ``r`` and ``2p-1-r`` of the 2p equal chunks (the
    balanced causal layout of Megatron's context parallelism): every
    rank then owns one early and one late chunk, so the causal mask
    wastes the same half of the score blocks on every rank.

    Returns an int32 array of shape ``(p, t_global // p)``.
    """
    if t_global % (2 * p):
        raise ValueError(
            f"zigzag layout needs the global sequence divisible by "
            f"2*comm.size = {2 * p}, got T={t_global}"
        )
    c = t_global // (2 * p)
    rows = [
        np.concatenate([np.arange(r * c, (r + 1) * c),
                        np.arange((2 * p - 1 - r) * c, (2 * p - r) * c)])
        for r in range(p)
    ]
    return np.stack(rows).astype(np.int32)


def _take(x, idx, axis):
    return x.index_select(axis, torch.as_tensor(idx, dtype=torch.int64,
                                                 device=x.device))


def zigzag_shard(x, p, axis=1):
    """Reorder a globally ordered tensor so that a plain rank-major shard
    over ``axis`` gives each rank its zigzag chunks (apply before
    sharding)."""
    return _take(x, zigzag_indices(p, x.shape[axis]).reshape(-1), axis)


def zigzag_unshard(x, p, axis=1):
    """Inverse of :func:`zigzag_shard` on the gathered global tensor."""
    idx = zigzag_indices(p, x.shape[axis]).reshape(-1)
    inv = np.empty_like(idx)
    inv[idx] = np.arange(idx.size, dtype=np.int32)
    return _take(x, inv, axis)


class _KeepInGraph(torch.autograd.Function):
    """``acc`` unchanged, with ``blocks`` among its inputs and a zero
    cotangent for them: a KV block that a causal rank skips stays in
    this rank's backward graph, so the rank takes part in every
    transposed exchange of the ring, as its peers expect."""

    @staticmethod
    def forward(ctx, acc, *blocks):
        return acc.view_as(acc)

    @staticmethod
    def backward(ctx, grad, *_):
        return (grad, *(None for _ in ctx.needs_input_grad[1:]))


def _check_mesh(comm, where):
    if comm.backend != "mesh":
        raise NotImplementedError(
            f"{where} requires a mesh communicator, got {comm.backend!r}"
        )


@publishes_token
def ring_attention(q, k, v, comm, *, causal=False, scale=None, token=None,
                   layout="contiguous", impl="auto"):
    """Context-parallel attention over a 1-D ring communicator.

    Every rank holds the local sequence block ``q``/``k``/``v`` of shape
    [B, T_local, H, D] (the global sequence is the ring-rank-major
    concatenation).  Returns ``(out, token)`` with ``out`` the local
    block of softmax(QK^T)V over the global sequence.

    ``comm.size`` steps of blockwise attention with running (max, sum,
    accumulator) statistics in float32; after each step but the last
    the KV pair moves to the next rank (one ``sendrecv_multi`` batch),
    so at step i this rank holds the block of rank ``rank - i``.  The
    JAX scan also rotates after its last step and discards the blocks
    that come home; here that exchange is not made.  The gradient rides
    the ring the other way (the ``sendrecv`` transpose).

    ``impl`` selects the single-device attention for the one-rank
    shortcut; across ranks the ring runs its own dense blockwise update,
    as the JAX ring does, not the flash kernels.

    ``layout``: ``"contiguous"``: rank r holds positions
    ``[r*T_local, (r+1)*T_local)``, and a causal rank skips the blocks
    wholly in its future (the exchange still happens); ``"zigzag"``:
    rank r holds chunks ``r`` and ``2p-1-r`` (:func:`zigzag_indices`),
    which balances the causal work: each off-diagonal step attends half
    a block unmasked.  :func:`zigzag_shard` / :func:`zigzag_unshard`
    convert global tensors.
    """
    token = as_token(token)
    p = comm.size
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    # validated before the one-rank shortcut, as in the JAX package
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(
            f"layout must be 'contiguous' or 'zigzag', got {layout!r}"
        )
    _check_gqa(q.shape[2], k.shape[2], "ring_attention")
    if comm.backend == "self" or p == 1:
        out = local_attention(q, k, v, causal=causal, scale=scale, impl=impl)
        return out, token
    _check_mesh(comm, "ring_attention")
    if len(comm.axes) != 1:
        raise ValueError(
            f"ring_attention needs a 1-D communicator (one mesh axis), "
            f"got axes {comm.axes}; use comm.sub(axis)"
        )

    rank = comm.rank()
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    dev = q.device
    if layout == "zigzag":
        if tq != tk:
            raise ValueError(
                f"zigzag layout requires equal q/kv block lengths, got "
                f"Tq={tq}, Tk={tk} (the chunk table is shared)"
            )
        if tq % 2:
            raise ValueError(
                f"zigzag layout needs an even local block length "
                f"(two chunks per rank), got T_local={tq}"
            )
        pos_table = torch.as_tensor(zigzag_indices(p, p * tq),
                                    dtype=torch.int64, device=dev)
        qpos = pos_table[rank]
    else:
        qpos = rank * tq + torch.arange(tq, device=dev)

    # the forward ring: each block moves to the next rank
    perm = [(r, (r + 1) % p) for r in range(p)]

    def attend(q_sub, qpos_sub, k_blk, v_blk, acc, m, l, kpos, *, mask):
        """Online-softmax update of (acc, m, l) for the q rows of
        ``q_sub``; ``mask=False`` asserts full visibility."""
        s = _scores(q_sub, k_blk, scale)
        if mask:
            s = torch.where(qpos_sub[:, None] >= kpos[None, :], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        w = torch.exp(s - m_new[..., None])
        l_new = l * corr + w.sum(dim=-1)
        acc_new = acc * corr.transpose(1, 2)[..., None] + _weighted_values(
            w, v_blk.float(), q_sub.shape[2])
        return acc_new, m_new, l_new

    c = tq // 2  # the zigzag chunk length

    def zigzag_causal_update(i, src, k_blk, v_blk, acc, m, l):
        """The zigzag layout's chunk-level causal schedule: rank r's q
        chunks are (r, 2p-1-r), the step's kv block holds src's chunks
        (src, 2p-1-src).  At i == 0 the local block, one masked attend;
        src < rank: every q row sees only src's early chunk (k rows
        [:c]); src > rank: only the late q chunk (rows [c:]) sees
        anything, and it sees the whole block.  The last two need no
        mask and half the block's scores."""
        if i == 0:
            return attend(q, qpos, k_blk, v_blk, acc, m, l, pos_table[src],
                          mask=True)
        if src < rank:
            return attend(q, qpos, k_blk[:, :c], v_blk[:, :c], acc, m, l,
                          None, mask=False)
        a2, m2, l2 = attend(q[:, c:], None, k_blk, v_blk, acc[:, c:],
                            m[..., c:], l[..., c:], None, mask=False)
        return (torch.cat([acc[:, :c], a2], dim=1),
                torch.cat([m[..., :c], m2], dim=-1),
                torch.cat([l[..., :c], l2], dim=-1))

    acc = torch.zeros((b, tq, h, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, tq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=dev)
    k_blk, v_blk = k, v
    for i in range(p):
        src = (rank - i) % p
        if causal and layout == "zigzag":
            acc, m, l = zigzag_causal_update(i, src, k_blk, v_blk, acc, m, l)
        elif causal:
            # a block wholly in this rank's future contributes nothing:
            # no attention math, but the ring keeps rotating
            if rank * tq + tq - 1 >= src * tk:
                kpos = src * tk + torch.arange(tk, device=dev)
                acc, m, l = attend(q, qpos, k_blk, v_blk, acc, m, l, kpos,
                                   mask=True)
            else:
                acc = _KeepInGraph.apply(acc, k_blk, v_blk)
        else:
            acc, m, l = attend(q, qpos, k_blk, v_blk, acc, m, l, None,
                               mask=False)
        if i < p - 1:
            (k_blk, v_blk), token = sendrecv_multi(
                [k_blk, v_blk], [k_blk, v_blk], perm, perm, comm=comm,
                token=token)
    out = acc / l.transpose(1, 2)[..., None]
    return out.to(q.dtype), token


@publishes_token
def ulysses_attention(q, k, v, comm, *, causal=False, scale=None,
                      token=None, impl="auto"):
    """Ulysses-style context parallelism: an all-to-all head<->sequence
    reshard, :func:`local_attention` with ``impl`` over the full
    sequence for this rank's heads, and the reshard back.

    ``q``/``k``/``v``: local [B, T_local, H, D] with ``H % comm.size ==
    0`` (query and kv heads alike).  Returns ``(out, token)``.  Two
    collectives a direction instead of the ring's ``p`` exchanges; on
    the card ``impl="flash"`` or ``"auto"`` runs the flash kernels over
    the full sequence.
    """
    token = as_token(token)
    p = comm.size
    if comm.backend == "self" or p == 1:
        out = local_attention(q, k, v, causal=causal, scale=scale, impl=impl)
        return out, token
    _check_mesh(comm, "ulysses_attention")

    b, t, h, d = q.shape
    hk = k.shape[2]
    _check_gqa(h, hk, "ulysses_attention")
    for name, heads in (("query", h), ("kv", hk)):
        if heads % p:
            raise ValueError(
                f"ulysses_attention needs {name} heads divisible by the "
                f"ring size: H={heads}, comm.size={p}"
                + (
                    " (for GQA with fewer kv heads than ranks, repeat kv "
                    "heads to a multiple of comm.size first)"
                    if name == "kv"
                    else ""
                )
            )

    def to_heads(x, tok):
        # [B, T, H, D] -> rows [p, T, B, hp, D] -> alltoall -> the full
        # sequence for this rank's heads [B, p*T, hp, D]
        hp = x.shape[2] // p
        blocks = x.reshape(b, t, p, hp, d).permute(2, 1, 0, 3, 4)
        mixed, tok = alltoall(blocks, comm=comm, token=tok)
        # row j now holds rank j's sequence block for our heads
        return mixed.permute(2, 0, 1, 3, 4).reshape(b, p * t, hp, d), tok

    def to_seq(x, tok):
        # the inverse of to_heads
        hp = x.shape[2]
        blocks = x.reshape(b, p, t, hp, d).permute(1, 2, 0, 3, 4)
        mixed, tok = alltoall(blocks, comm=comm, token=tok)
        return mixed.permute(2, 1, 0, 3, 4).reshape(b, t, p * hp, d), tok

    qh, token = to_heads(q, token)
    kh, token = to_heads(k, token)
    vh, token = to_heads(v, token)
    out = local_attention(qh, kh, vh, causal=causal, scale=scale, impl=impl)
    return to_seq(out, token)
