"""Long-context attention: the single-device core and the sequence-
parallel schemes around it.

Counterpart of ``mpi4jax_tpu/parallel/longseq.py``:
:func:`local_attention` with grouped-query heads and causal offsets,
dense (the oracle) or through the flash kernels, and the signatures of
:func:`ring_attention` and :func:`ulysses_attention` with their
one-rank shortcut to it.  Their multi-rank schedules (KV blocks rotating
around the ring, the all-to-all reshards, the zigzag layout) are not
ported yet and raise naming :data:`LONGSEQ_ITEM`.
"""

import math

import torch

from mpi4jax_tpu_torch.kernels.flash import _NEG  # finite mask value
from mpi4jax_tpu_torch.kernels.flash import flash_supported
from mpi4jax_tpu_torch.ops._core import as_token, publishes_token

__all__ = ["local_attention", "ring_attention", "ulysses_attention",
           "LONGSEQ_ITEM"]

LONGSEQ_ITEM = (
    "ROADMAP.md Queue 1 item 4 (ring and Ulysses attention across ranks)"
)


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


def _check_one_rank(comm, where):
    """A one-rank communicator takes the shortcut to
    :func:`local_attention`; a larger one raises: its schedule is not
    ported yet."""
    if comm.backend == "self" or comm.size == 1:
        return
    raise NotImplementedError(
        f"{where} over {comm.size} ranks is not ported yet: {LONGSEQ_ITEM}"
    )


@publishes_token
def ring_attention(q, k, v, comm, *, causal=False, scale=None, token=None,
                   layout="contiguous", impl="auto"):
    """Context-parallel attention over a 1-D ring communicator.

    Every rank holds the local sequence block ``q``/``k``/``v`` of shape
    [B, T_local, H, D]; returns ``(out, token)`` with ``out`` the local
    block of softmax(QK^T)V over the global sequence.  ``layout`` is
    ``"contiguous"`` or ``"zigzag"`` (validated, with the GQA shapes,
    before the one-rank shortcut, as in the JAX package).  On one rank
    this is :func:`local_attention` with ``impl``; more ranks raise.
    """
    token = as_token(token)
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(
            f"layout must be 'contiguous' or 'zigzag', got {layout!r}"
        )
    _check_gqa(q.shape[2], k.shape[2], "ring_attention")
    _check_one_rank(comm, "ring_attention")
    out = local_attention(q, k, v, causal=causal, scale=scale, impl=impl)
    return out, token


@publishes_token
def ulysses_attention(q, k, v, comm, *, causal=False, scale=None,
                      token=None, impl="auto"):
    """Ulysses-style context parallelism: an all-to-all head<->sequence
    reshard around full-sequence local attention.  On one rank this is
    :func:`local_attention` with ``impl``; more ranks raise.  Returns
    ``(out, token)``."""
    token = as_token(token)
    _check_one_rank(comm, "ulysses_attention")
    out = local_attention(q, k, v, causal=causal, scale=scale, impl=impl)
    return out, token
