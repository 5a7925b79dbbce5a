"""The flash-attention forward kernel: wrapper, launcher binding and
plain PyTorch version.

* :func:`flash_fwd` — softmax(scale * q k^T) v over ``[B, T, H, D]``
  operands with an online softmax over key tiles, causal masking with
  static offsets and grouped-query heads; optionally also the f32 row
  statistics ``m`` (running max) and ``l`` (sum of weights), each
  ``[B*Hq, Tq]``.  Replaces ``mpi4jax_tpu/ops/flash.py:_kernel``.

Dispatch is by the tensors' device alone: CUDA tensors go to the
hand-written kernel in ``csrc/flash_fwd.cu`` (built at first use, see
``_build.py``), CPU tensors to the plain version
:func:`flash_attention_reference`.  A failed build or launch raises;
nothing falls back to the plain version on the card.  The wrapper counts
its kernel launches in ``flash_fwd.launches``.

The kernel walks keys in tiles of :data:`BLOCK_K`; the plain version
walks them in tiles of the size it is given, with the same per-tile
update, so the two agree to rounding when it is given ``BLOCK_K``.
"""

import ctypes
import functools
import math

import torch

from mpi4jax_tpu_torch.kernels import _build

__all__ = [
    "BLOCK_K",
    "HEAD_DIMS",
    "flash_fwd",
    "flash_attention_reference",
    "reset_launch_counts",
]

BLOCK_Q = 64  # query rows per thread block of the kernel
BLOCK_K = 32  # keys per shared-memory tile of the kernel
HEAD_DIMS = (32, 64, 128)
_MAX_Q_TILES = 65535  # the kernel's grid.y

# finite mask value of causally masked keys, here and in the dense oracle
# (parallel/longseq.py)
_NEG = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _library():
    """The built kernel library with its launcher's C signature."""
    lib = _build.load_library("flash_fwd")
    lib.flash_fwd_launch.argtypes = (
        [_P] * 6 + [_I] * 8 + [_L, _L, ctypes.c_float, _P]
    )
    lib.flash_fwd_launch.restype = _I
    lib.flash_fwd_error_string.argtypes = [_I]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _fold(x, pad):
    """[B, T, H, D] -> [B*H, T(+pad), D], zero-padded along T."""
    b, t, h, d = x.shape
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    return x.transpose(1, 2).reshape(b * h, t + pad, d)


def _unfold(x, t, b, h):
    """Inverse of :func:`_fold` (drops the padding)."""
    return x[:, :t].reshape(b, h, t, x.shape[-1]).transpose(1, 2)


def flash_attention_reference(q, k, v, *, causal, scale, q_offset=0,
                              k_offset=0, block_k=BLOCK_K, with_lse=False):
    """Plain PyTorch version of :func:`flash_fwd`.

    Walks the keys in tiles of ``block_k`` with the kernel's online
    softmax: f32 statistics and accumulator, the scale applied to q,
    ``_NEG`` for causally masked real keys and ``-inf`` for the padding
    of the last tile, and for bf16 operands weights taken as the bf16
    exponential of the bf16-rounded argument.  GQA repeats each kv head
    over its query heads.  Returns ``out`` (q's dtype), or ``(out, m,
    l)`` with ``m``, ``l`` f32 ``[B*Hq, Tq]``.
    """
    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    if hq != hk:
        k = k.repeat_interleave(hq // hk, dim=2)
        v = v.repeat_interleave(hq // hk, dim=2)
    pad_k = (-tk) % block_k
    qf = _fold(q, 0).float() * scale
    kf = _fold(k, pad_k)
    vf = _fold(v, pad_k)
    bf16 = q.dtype == torch.bfloat16

    rows = b * hq
    m = torch.full((rows, tq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((rows, tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((rows, tq, d), dtype=torch.float32, device=q.device)
    qpos = q_offset + torch.arange(tq, device=q.device)
    for k0 in range(0, tk + pad_k, block_k):
        kb = kf[:, k0:k0 + block_k].float()
        vb = vf[:, k0:k0 + block_k].float()
        s = qf @ kb.transpose(1, 2)  # [rows, tq, block_k]
        krow = k0 + torch.arange(block_k, device=q.device)
        if causal:
            visible = qpos[:, None] >= k_offset + krow[None, :]
            s = torch.where(visible, s, _NEG)
        s = torch.where(krow < tk, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        arg = s - m_new[..., None]
        if bf16:
            w = torch.exp(arg.to(torch.bfloat16)).float()
        else:
            w = torch.exp(arg)
        l = l * corr + w.sum(dim=-1)
        acc = acc * corr[..., None] + w @ vb
        m = m_new
    out = _unfold((acc / l[..., None]).to(q.dtype), tq, b, hq)
    if with_lse:
        return out, m, l
    return out


def _check_operands(q, k, v):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"flash_fwd: dtype {q.dtype} not supported by the kernel "
            "(float32 or bfloat16)"
        )
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(
                f"flash_fwd: {name} is {t.dtype} on {t.device}, q is "
                f"{q.dtype} on {q.device}"
            )
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(
            f"flash_fwd: expected q [B, Tq, Hq, D] and k, v [B, Tk, Hkv, "
            f"D], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, tq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(
            f"flash_fwd: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}"
            " (same B and D, Hq a multiple of Hkv)"
        )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"flash_fwd: head dim {d} not supported by the kernel "
            f"(one of {HEAD_DIMS})"
        )
    if k.shape[1] < 1 or -(-tq // BLOCK_Q) > _MAX_Q_TILES:
        raise ValueError(
            f"flash_fwd: Tk={k.shape[1]} must be >= 1 and Tq={tq} at most "
            f"{_MAX_Q_TILES * BLOCK_Q}"
        )


def flash_fwd(q, k, v, *, causal, scale, q_offset=0, k_offset=0,
              with_lse=False, block_k=BLOCK_K):
    """Flash-attention forward; returns ``out`` or ``(out, m, l)``.

    CUDA tensors launch the ``flash_fwd`` kernel on the current stream
    (``block_k`` is then the kernel's own :data:`BLOCK_K`); CPU tensors
    run :func:`flash_attention_reference` with tiles of ``block_k``.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            k_offset=k_offset, block_k=block_k, with_lse=with_lse,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    _check_operands(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stats = (
        [torch.empty((b * hq, tq), dtype=torch.float32, device=q.device)
         for _ in range(2)]
        if with_lse else []
    )
    if tq:
        lib = _library()
        m_ptr, l_ptr = (t.data_ptr() for t in stats) if stats else (None, None)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = lib.flash_fwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                m_ptr, l_ptr, b, tq, tk, hq, hk, d, _DTYPE_CODES[q.dtype],
                int(bool(causal)), int(q_offset), int(k_offset),
                float(scale), stream,
            )
        if code != 0:
            msg = lib.flash_fwd_error_string(code).decode()
            raise RuntimeError(f"flash_fwd kernel launch failed: {msg} "
                               f"({code})")
        flash_fwd.launches += 1
    return (out, *stats) if with_lse else out


flash_fwd.launches = 0


def reset_launch_counts():
    """Set the wrapper's launch count to 0."""
    flash_fwd.launches = 0
