"""The flash-attention forward kernel: wrapper, launcher binding and
plain PyTorch version.

* :func:`flash_fwd` — softmax(scale * q k^T) v over ``[B, T, H, D]``
  operands with an online softmax over key tiles, causal masking with
  static offsets and grouped-query heads; optionally also the f32 row
  statistics ``m`` (running max) and ``l`` (sum of weights), each
  ``[B*Hq, Tq]``.  Replaces ``mpi4jax_tpu/ops/flash.py:_kernel``.

Dispatch is by the tensors' device, then by their dtype: bf16 CUDA
tensors go to the tensor-core kernel in ``csrc/flash_fwd_mma.cu``
(``mma.sync`` bf16, ``ldmatrix``, ``cp.async``), f32 CUDA tensors to the
tensor-core kernel in ``csrc/flash_fwd.cu`` (``mma.sync`` TF32 in
3xTF32: each f32 operand split by :func:`tf32_split`, three products a
pair; ``cp.async``) (each built at first use, see ``_build.py``), CPU
tensors to the plain version
:func:`flash_attention_reference`.  A failed build or launch raises;
nothing falls back to the plain version on the card.  The wrapper counts
the launches of both kernels in ``flash_fwd.launches`` and those of the
tensor-core kernel alone in ``flash_fwd.mma_launches``.

The f32 kernel walks keys in tiles of :data:`BLOCK_K`, the bf16 kernel in
tiles of :data:`BLOCK_K_MMA` (:func:`kernel_block_k`); the plain version
walks them in tiles of the size it is given, with the same per-tile
update, so it agrees with a kernel to rounding when it is given that
kernel's tile.

:func:`flash_supported` is the rule by which ``"auto"`` attention takes
these kernels, decided from dtypes and shapes before any launch.
:func:`tf32_split` mirrors the f32 kernels' split of an operand into
its TF32 terms, for the tests.
"""

import ctypes
import functools
import math

import torch

from mpi4jax_tpu_torch.kernels import _build

__all__ = [
    "AUTO_MIN_ROWS",
    "auto_takes_flash",
    "BLOCK_K",
    "BLOCK_K_MMA",
    "HEAD_DIMS",
    "flash_covers",
    "flash_fwd",
    "flash_attention_reference",
    "flash_supported",
    "kernel_block_k",
    "reset_launch_counts",
    "tf32_split",
]

BLOCK_Q = 64  # query rows per block of the f32 kernel (bf16: 64 or 128)
BLOCK_K = 32  # keys per shared-memory tile of the f32 kernel
BLOCK_K_MMA = 64  # keys per shared-memory tile of the bf16 kernel
HEAD_DIMS = (32, 64, 128)
# the kernels' grid.y: query tiles of the forward and of the dq kernel,
# key blocks of the dkv kernel (kernels/flash_bwd.py), 64 rows each
_MAX_TILES = 65535
AUTO_MIN_ROWS = 128  # "auto" attention takes the kernels from this Tq

# finite mask value of causally masked keys, here and in the dense oracle
# (parallel/longseq.py)
_NEG = -0.7 * float(torch.finfo(torch.float32).max)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the forward kernel of each dtype: source csrc/<name>.cu, launcher
# <name>_launch
_KERNELS = {torch.float32: "flash_fwd", torch.bfloat16: "flash_fwd_mma"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _library(name):
    """The built kernel library ``name`` with its launcher's C signature
    (the same for both forward kernels)."""
    lib = _build.load_library(name)
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [_P] * 6 + [_I] * 7 + [_L, _L, ctypes.c_float, _P]
    launch.restype = _I
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [_I]
    error_string.restype = ctypes.c_char_p
    return lib


def tf32_split(x):
    """The f32 kernels' split of f32 operands into TF32 terms
    (``csrc/flash_fwd.cu:tf32_split``, ``csrc/flash_bwd.cu``), bit for
    bit: ``big`` is ``x`` rounded to 10 explicit mantissa bits, to
    nearest even (add ``0xfff`` plus the last kept bit to the f32
    pattern, clear the low 13 bits), and ``small`` is ``x - big`` (exact
    in f32) rounded the same way.  Returns ``(big, small)`` as f32
    tensors; the tests use it, no launch does."""

    def rne(t):
        u = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
        u = torch.where(u >= 1 << 31, u - (1 << 32), u)
        return u.to(torch.int32).view(torch.float32)

    x = x.float()
    big = rne(x)
    return big, rne(x - big)


def kernel_block_k(dtype):
    """Key tile of the forward kernel that runs ``dtype`` on the card:
    :data:`BLOCK_K_MMA` for bf16, :data:`BLOCK_K` otherwise (f32)."""
    return BLOCK_K_MMA if dtype == torch.bfloat16 else BLOCK_K


def _shape_fault(dtype, q_shape, k_shape):
    """Why the flash kernels, the forward and both backward ones, cannot
    take operands of ``dtype`` with q of ``q_shape`` ``[B, Tq, Hq, D]``
    and k, v of ``k_shape`` ``[B, Tk, Hkv, D]``, as ``(exception type,
    message)``; None when they can."""
    if dtype not in _KERNELS:
        return TypeError, (f"dtype {dtype} not supported by the kernels "
                           "(float32 or bfloat16)")
    if len(q_shape) != 4 or len(k_shape) != 4:
        return ValueError, (f"expected q [B, Tq, Hq, D] and k, v [B, Tk, "
                            f"Hkv, D], got {q_shape}, {k_shape}")
    b, tq, hq, d = q_shape
    if k_shape[0] != b or k_shape[3] != d or k_shape[2] < 1 \
            or hq % k_shape[2]:
        return ValueError, (f"k/v {k_shape} do not match q {q_shape} (same "
                            "B and D, Hq a multiple of Hkv)")
    if d not in HEAD_DIMS:
        return ValueError, (f"head dim {d} not supported by the kernels "
                            f"(one of {HEAD_DIMS})")
    if k_shape[1] < 1 or max(tq, k_shape[1]) > _MAX_TILES * BLOCK_Q:
        return ValueError, (f"Tk={k_shape[1]} must be >= 1 and Tq, Tk at "
                            f"most {_MAX_TILES * BLOCK_Q}")
    return None


def flash_covers(dtype, q_shape, k_shape):
    """True when the flash kernels, the forward and both backward ones,
    take operands of ``dtype`` with q of ``q_shape`` ``[B, Tq, Hq, D]``
    and k, v of ``k_shape`` ``[B, Tk, Hkv, D]``: f32 or bf16, D in
    :data:`HEAD_DIMS`, Hq a multiple of Hkv, Tk >= 1, and both lengths
    within the kernels' grids.  Plain Python on shapes: no card needed.
    """
    return _shape_fault(dtype, tuple(q_shape), tuple(k_shape)) is None


def auto_takes_flash(dtype, q_shape, k_shape):
    """The dtype and shape half of :func:`flash_supported`: the kernels
    cover the operands (:func:`flash_covers`) and q has at least
    :data:`AUTO_MIN_ROWS` rows.  Plain Python on shapes."""
    return (len(q_shape) == 4 and q_shape[1] >= AUTO_MIN_ROWS
            and flash_covers(dtype, q_shape, k_shape))


def flash_supported(q, k, v):
    """The rule of ``local_attention(impl="auto")``, decided before any
    launch: True only for CUDA tensors of one dtype and device for which
    :func:`auto_takes_flash` holds.  Anything else (the CPU, fp16, a head
    dim of 8, a short block) takes the dense path, as the JAX package's
    ``"auto"`` takes it off the TPU."""
    return (q.device.type == "cuda"
            and all(t.device == q.device and t.dtype == q.dtype
                    for t in (k, v))
            and k.shape == v.shape
            and auto_takes_flash(q.dtype, tuple(q.shape), tuple(k.shape)))


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
    """Raise on operands the kernels cannot take (the rule of
    :func:`flash_covers`, and k, v of q's dtype and device, one shape)."""
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(
                f"flash_fwd: {name} is {t.dtype} on {t.device}, q is "
                f"{q.dtype} on {q.device}"
            )
    if k.shape != v.shape:
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    fault = _shape_fault(q.dtype, tuple(q.shape), tuple(k.shape))
    if fault is not None:
        kind, msg = fault
        raise kind(f"flash_fwd: {msg}")


def _aligned(t):
    """``t`` contiguous, with its data on a 16-byte boundary (both
    kernels copy rows in 16-byte pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, out, m, l, *, causal, scale, q_offset, k_offset,
            stream):
    """Launch the forward kernel of q's dtype on ``stream`` (checked,
    contiguous, aligned operands; ``m``, ``l`` both None or both f32
    ``[B*Hq, Tq]``) and count it."""
    name = _KERNELS[q.dtype]
    lib = _library(name)
    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    code = getattr(lib, f"{name}_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(),
        b, tq, tk, hq, hk, d, int(bool(causal)), int(q_offset),
        int(k_offset), float(scale), stream,
    )
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")
    flash_fwd.launches += 1
    if name == "flash_fwd_mma":
        flash_fwd.mma_launches += 1


def flash_fwd(q, k, v, *, causal, scale, q_offset=0, k_offset=0,
              with_lse=False, block_k=None):
    """Flash-attention forward; returns ``out`` or ``(out, m, l)``.

    CUDA tensors launch the kernel of their dtype on the current stream
    (bf16: ``flash_fwd_mma``, f32: ``flash_fwd``; ``block_k`` is then
    that kernel's own tile); CPU tensors run
    :func:`flash_attention_reference` with tiles of ``block_k``, by
    default the tile of the kernel of their dtype
    (:func:`kernel_block_k`).
    """
    if q.device.type == "cpu":
        if block_k is None:
            block_k = kernel_block_k(q.dtype)
        return flash_attention_reference(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            k_offset=k_offset, block_k=block_k, with_lse=with_lse,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    _check_operands(q, k, v)
    q, k, v = (_aligned(t) for t in (q, k, v))
    b, tq, hq, _ = q.shape
    out = torch.empty_like(q)
    stats = (
        [torch.empty((b * hq, tq), dtype=torch.float32, device=q.device)
         for _ in range(2)]
        if with_lse else [None, None]
    )
    if tq:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            _launch(q, k, v, out, *stats, causal=causal, scale=scale,
                    q_offset=q_offset, k_offset=k_offset, stream=stream)
    return (out, *stats) if with_lse else out


flash_fwd.launches = 0
flash_fwd.mma_launches = 0


def reset_launch_counts():
    """Set the wrapper's launch counts to 0."""
    flash_fwd.launches = 0
    flash_fwd.mma_launches = 0
