"""Single-device attention, the core of the long-context schemes.

Counterpart of the dense core of ``mpi4jax_tpu/parallel/longseq.py``:
:func:`local_attention` with grouped-query heads and causal offsets,
dense (the oracle) or through the flash kernel.  The multi-rank schemes
of that module (``ring_attention``, ``ulysses_attention``, the zigzag
layout) need multi-rank comms and are not in this slice (ROADMAP.md
Queue 1 item 1).
"""

import math

import torch

from mpi4jax_tpu_torch.kernels.flash import _NEG  # finite mask value

__all__ = ["local_attention"]


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
    kernel (``ops/flash.py``); ``"auto"`` — flash for CUDA tensors with
    at least 128 query rows, dense otherwise.
    """
    _check_gqa(q.shape[2], k.shape[2], "local_attention")
    if impl == "auto":
        impl = "flash" if q.is_cuda and q.shape[1] >= 128 else "xla"
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
