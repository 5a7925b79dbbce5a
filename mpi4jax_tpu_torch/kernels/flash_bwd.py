"""The flash-attention backward kernels: wrappers, launcher bindings and
plain PyTorch versions.

* :func:`flash_bwd_dkv` — dK and dV, per block of keys over the query
  rows that see them.  Replaces ``mpi4jax_tpu/ops/flash.py:_bwd_dkv_kernel``.
* :func:`flash_bwd_dq` — dQ, per block of query rows over the keys they
  see.  Replaces ``mpi4jax_tpu/ops/flash.py:_bwd_dq_kernel``.
* :func:`flash_bwd` — the backward of ``flash_attention``: ``delta =
  rowsum(f32(dO) * f32(out))`` in plain PyTorch (as XLA forms it outside
  the Pallas kernels), then both kernels.  Returns ``(dq, dk, dv)``.

Both kernels recompute the scores and the softmax weights from the
forward's saved row statistics ``m`` and ``l`` (``kernels/flash.py``),
with the Pallas kernels' shared math (``_bwd_block``) term by term: the
scale on q in the dkv kernel and on k in the dq kernel, ``_NEG`` for
causally masked real keys and ``-inf`` for keys past ``Tk``, bf16
weights recomputed as the forward's own, ``ds`` zeroed outside the
visible set.  Grouped-query heads: dK and dV of a kv head are summed in
f32 over the query heads of its group.

Dispatch is by the tensors' device, then by their dtype: bf16 CUDA
tensors go to the tensor-core kernels in ``csrc/flash_bwd_mma.cu``
(``mma.sync`` bf16, ``ldmatrix``, ``cp.async``; ds enters the dK and dQ
products as three bf16 terms whose sum is its f32 value), f32 CUDA
tensors to the kernels in ``csrc/flash_bwd.cu``: both on the tensor cores
in 3xTF32 (``mma.sync`` TF32, each f32 operand split into two TF32
terms, three products a pair; ``cp.async``; each built at first use, see
``_build.py``), CPU tensors to the plain versions
:func:`flash_bwd_dkv_reference` and :func:`flash_bwd_dq_reference`.  A
failed build or launch raises; nothing falls back to the plain versions
or to the other dtype's kernels on the card.  Each wrapper counts the
launches of both its kernels in ``.launches`` and those of its
tensor-core kernel alone in ``.mma_launches``.

The plain versions walk keys in tiles of the size they are given (only
dQ's f32 summation order depends on it), by default
:func:`kernel_block_k` of their dtype: :data:`BLOCK_K_MMA`, the bf16 dq
kernel's tile, for bf16 and :data:`BLOCK_K` for f32.  The f32 dq kernel
sums dQ in 8-key chunks of 16-key tiles, two halves of each tile apart
and added at the end: the same sum in another f32 order.
"""

import ctypes
import functools
import math

import torch

from mpi4jax_tpu_torch.kernels import _build
from mpi4jax_tpu_torch.kernels.flash import (
    _DTYPE_CODES,
    _NEG,
    _aligned,
    _check_operands,
    _fold,
    _unfold,
)

__all__ = [
    "BLOCK_K",
    "BLOCK_K_MMA",
    "flash_bwd",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_bwd_reference",
    "flash_bwd_dkv_reference",
    "flash_bwd_dq_reference",
    "kernel_block_k",
    "row_delta",
    "reset_launch_counts",
]

BLOCK_KEYS = 64  # keys per thread block of the dkv kernel
BLOCK_Q = 64  # query rows per thread block of the dq kernel
BLOCK_K = 32  # keys per tile of the plain f32 versions
BLOCK_K_MMA = 64  # keys per shared-memory tile of the bf16 dq kernel
_MAX_GRID_Y = 65535
# the backward kernels of each dtype: source csrc/<name>.cu, launchers
# flash_bwd_dkv<suffix>_launch and flash_bwd_dq<suffix>_launch
_KERNELS = {torch.float32: ("flash_bwd", ""),
            torch.bfloat16: ("flash_bwd_mma", "_mma")}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 7  # q, k, v, dO, m, l, delta
_TAIL = [_I] * 8 + [_L, _L, ctypes.c_float, _P]


@functools.cache
def _library(name, suffix):
    """The built kernel library ``name`` with the C signatures of its
    launchers ``flash_bwd_dkv<suffix>_launch`` and
    ``flash_bwd_dq<suffix>_launch`` (the same for both libraries)."""
    lib = _build.load_library(name)
    for part, outs in (("dkv", 2), ("dq", 1)):
        launch = getattr(lib, f"flash_bwd_{part}{suffix}_launch")
        launch.argtypes = _ARGTYPES + [_P] * outs + _TAIL
        launch.restype = _I
    error_string = getattr(lib, f"{name}_error_string")
    error_string.argtypes = [_I]
    error_string.restype = ctypes.c_char_p
    return lib


def kernel_block_k(dtype):
    """Key tile of the plain versions for ``dtype``: :data:`BLOCK_K_MMA`
    (the bf16 dq kernel's tile) for bf16, :data:`BLOCK_K` otherwise."""
    return BLOCK_K_MMA if dtype == torch.bfloat16 else BLOCK_K


def row_delta(g, out):
    """``rowsum(f32(dO) * f32(out))`` as f32 ``[B*Hq, Tq]`` (row ``b*Hq +
    h``), the layout of the forward's ``m`` and ``l``."""
    b, tq, hq, _ = out.shape
    delta = (g.float() * out.float()).sum(dim=-1)  # [B, Tq, Hq]
    return delta.transpose(1, 2).reshape(b * hq, tq).contiguous()


# ----------------------------- plain versions ------------------------------


def _tiles(q, k, v, g, m, l, delta, *, causal, scale, q_offset, k_offset,
           block_k, scale_on):
    """``_bwd_block``'s math over key tiles of ``block_k``: yields ``(k0,
    qx, kx, p, ds)`` per tile, with ``qx`` [B*Hq, Tq, D] and ``kx``
    [B*Hq, block_k, D] the f32 operands (``scale_on`` of them scaled),
    ``p`` the recomputed weights and ``ds`` the score cotangents, each
    [B*Hq, Tq, block_k].  Every product upcasts its operands to f32
    first: exact for bf16 products, and summed in f32."""
    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    if hq != hk:
        k = k.repeat_interleave(hq // hk, dim=2)
        v = v.repeat_interleave(hq // hk, dim=2)
    pad_k = (-tk) % block_k
    qx = _fold(q, 0).float()
    kf = _fold(k, pad_k).float()
    vf = _fold(v, pad_k).float()
    gf = _fold(g, 0).float()
    if scale_on == "q":
        qx = qx * scale
    else:
        kf = kf * scale
    m, l, delta = m[..., None], l[..., None], delta[..., None]
    bf16 = q.dtype == torch.bfloat16
    qpos = q_offset + torch.arange(tq, device=q.device)
    for k0 in range(0, tk + pad_k, block_k):
        kx = kf[:, k0:k0 + block_k]
        s = qx @ kx.transpose(1, 2)
        krow = k0 + torch.arange(block_k, device=q.device)
        visible = (krow < tk)[None, :]
        if causal:
            causal_ok = qpos[:, None] >= k_offset + krow[None, :]
            s = torch.where(causal_ok, s, _NEG)
            visible = visible & causal_ok
        s = torch.where(krow < tk, s, -math.inf)
        if bf16:
            p = torch.exp((s - m).to(torch.bfloat16)).float() / l
        else:
            p = torch.exp(s - m) / l
        dp = gf @ vf[:, k0:k0 + block_k].transpose(1, 2)
        ds = torch.where(visible, p * (dp - delta), 0.0)
        yield k0, qx, kx, p, ds


def _sum_group(x, tk, b, hq, hk):
    """[B*Hq, Tk(+pad), D] per query head -> [B, Tk, Hkv, D], summed (in
    x's f32) over the query heads of each kv head."""
    x = _unfold(x, tk, b, hq)
    return x.reshape(b, tk, hk, hq // hk, x.shape[-1]).sum(dim=3)


def flash_bwd_dkv_reference(q, k, v, g, m, l, delta, *, causal, scale,
                            q_offset=0, k_offset=0, block_k=BLOCK_K):
    """Plain PyTorch version of :func:`flash_bwd_dkv`: ``(dk, dv)`` in
    k's and v's dtype.  ``dV += p' dO`` with ``p'`` the weights rounded to
    dO's dtype, ``dK += ds q_scaled``, in f32."""
    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    pad_k = (-tk) % block_k
    dk = torch.zeros((b * hq, tk + pad_k, d), dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)
    gf = _fold(g, 0).float()
    for k0, qx, _, p, ds in _tiles(
            q, k, v, g, m, l, delta, causal=causal, scale=scale,
            q_offset=q_offset, k_offset=k_offset, block_k=block_k,
            scale_on="q"):
        pv = p.to(g.dtype).float()
        dv[:, k0:k0 + block_k] = pv.transpose(1, 2) @ gf
        dk[:, k0:k0 + block_k] = ds.transpose(1, 2) @ qx
    return (_sum_group(dk, tk, b, hq, hk).to(k.dtype),
            _sum_group(dv, tk, b, hq, hk).to(v.dtype))


def flash_bwd_dq_reference(q, k, v, g, m, l, delta, *, causal, scale,
                           q_offset=0, k_offset=0, block_k=BLOCK_K):
    """Plain PyTorch version of :func:`flash_bwd_dq`: ``dq`` in q's
    dtype, ``dQ += ds k_scaled`` in f32 over key tiles of ``block_k``."""
    b, tq, hq, d = q.shape
    dq = torch.zeros((b * hq, tq, d), dtype=torch.float32, device=q.device)
    for _, _, kx, _, ds in _tiles(
            q, k, v, g, m, l, delta, causal=causal, scale=scale,
            q_offset=q_offset, k_offset=k_offset, block_k=block_k,
            scale_on="k"):
        dq = dq + ds @ kx
    return _unfold(dq, tq, b, hq).to(q.dtype)


def flash_bwd_reference(q, k, v, out, g, m, l, *, causal, scale, q_offset=0,
                        k_offset=0, block_k=BLOCK_K):
    """Plain PyTorch version of :func:`flash_bwd`: ``(dq, dk, dv)``."""
    delta = row_delta(g, out)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset, block_k=block_k)
    dk, dv = flash_bwd_dkv_reference(q, k, v, g, m, l, delta, **kw)
    dq = flash_bwd_dq_reference(q, k, v, g, m, l, delta, **kw)
    return dq, dk, dv


# -------------------------------- kernels ---------------------------------


def _check_backward(q, k, v, g, m, l, delta):
    _check_operands(q, k, v)
    b, tq, hq, _ = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(
            f"flash_bwd: dO is {g.dtype} {tuple(g.shape)} on {g.device}, q "
            f"is {q.dtype} {tuple(q.shape)} on {q.device}"
        )
    for name, t in (("m", m), ("l", l), ("delta", delta)):
        if (t.shape != (b * hq, tq) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(
                f"flash_bwd: {name} must be float32 [B*Hq, Tq] = "
                f"[{b * hq}, {tq}] on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
    for t, rows in ((q, BLOCK_Q), (k, BLOCK_KEYS)):
        if -(-t.shape[1] // rows) > _MAX_GRID_Y:
            raise ValueError(
                f"flash_bwd: sequence length {t.shape[1]} exceeds the "
                f"kernels' grid ({_MAX_GRID_Y * rows})"
            )


def _launch(part, q, k, v, g, m, l, delta, outs, *, causal, scale,
            q_offset, k_offset, stream):
    """Launch the ``part`` ("dkv" or "dq") kernel of q's dtype on
    ``stream`` (checked, contiguous, aligned operands) and count it."""
    name, suffix = _KERNELS[q.dtype]
    lib = _library(name, suffix)
    b, tq, hq, d = q.shape
    tk, hk = k.shape[1], k.shape[2]
    wrapper = flash_bwd_dkv if part == "dkv" else flash_bwd_dq
    code = getattr(lib, f"flash_bwd_{part}{suffix}_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        *(t.data_ptr() for t in outs), b, tq, tk, hq, hk, d,
        _DTYPE_CODES[q.dtype], int(bool(causal)), int(q_offset),
        int(k_offset), float(scale), stream,
    )
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"flash_bwd_{part}{suffix} kernel launch failed: "
                           f"{msg} ({code})")
    wrapper.launches += 1
    if suffix:
        wrapper.mma_launches += 1


def _prepare(q, k, v, g, m, l, delta):
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: unsupported device {q.device}")
    _check_backward(q, k, v, g, m, l, delta)
    # every kernel copies rows in 16-byte pieces
    return tuple(_aligned(t) for t in (q, k, v, g, m, l, delta))


def _run(part, q, k, v, g, m, l, delta, outs, **kw):
    """Launch ``part`` on q's device's current stream."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(part, q, k, v, g, m, l, delta, outs, stream=stream, **kw)


def flash_bwd_dkv(q, k, v, g, m, l, delta, *, causal, scale, q_offset=0,
                  k_offset=0, block_k=None):
    """``(dk, dv)`` of flash attention.

    CUDA tensors launch the dkv kernel of their dtype on the current
    stream (bf16: ``flash_bwd_dkv_mma``, f32: ``flash_bwd_dkv``); CPU
    tensors run :func:`flash_bwd_dkv_reference` with key tiles of
    ``block_k``, by default :func:`kernel_block_k` of their dtype (the
    tiling does not change dK's and dV's sums over the query rows)."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset)
    if q.device.type == "cpu":
        if block_k is None:
            block_k = kernel_block_k(q.dtype)
        return flash_bwd_dkv_reference(q, k, v, g, m, l, delta,
                                       block_k=block_k, **kw)
    q, k, v, g, m, l, delta = _prepare(q, k, v, g, m, l, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    _run("dkv", q, k, v, g, m, l, delta, (dk, dv), **kw)
    return dk, dv


def flash_bwd_dq(q, k, v, g, m, l, delta, *, causal, scale, q_offset=0,
                 k_offset=0, block_k=None):
    """``dq`` of flash attention.

    CUDA tensors launch the dq kernel of their dtype on the current
    stream (bf16: ``flash_bwd_dq_mma``, f32: ``flash_bwd_dq``; ``block_k``
    is then that kernel's own tile); CPU tensors run
    :func:`flash_bwd_dq_reference` with key tiles of ``block_k``, by
    default :func:`kernel_block_k` of their dtype."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset)
    if q.device.type == "cpu":
        if block_k is None:
            block_k = kernel_block_k(q.dtype)
        return flash_bwd_dq_reference(q, k, v, g, m, l, delta,
                                      block_k=block_k, **kw)
    q, k, v, g, m, l, delta = _prepare(q, k, v, g, m, l, delta)
    dq = torch.empty_like(q)
    if q.shape[1] == 0:
        return dq
    _run("dq", q, k, v, g, m, l, delta, (dq,), **kw)
    return dq


def flash_bwd(q, k, v, out, g, m, l, *, causal, scale, q_offset=0,
              k_offset=0, block_k=None):
    """The backward of flash attention: ``(dq, dk, dv)`` in the operands'
    dtypes, from the forward's ``out`` and its row statistics ``m``,
    ``l`` (f32 ``[B*Hq, Tq]``) and the cotangent ``g`` of ``out``."""
    delta = row_delta(g, out)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset, block_k=block_k)
    dk, dv = flash_bwd_dkv(q, k, v, g, m, l, delta, **kw)
    dq = flash_bwd_dq(q, k, v, g, m, l, delta, **kw)
    return dq, dk, dv


def reset_launch_counts():
    """Set both wrappers' launch counts to 0."""
    for wrapper in (flash_bwd_dkv, flash_bwd_dq):
        wrapper.launches = 0
        wrapper.mma_launches = 0


reset_launch_counts()
