"""Flash attention: the blockwise-local-attention hot op.

Counterpart of ``mpi4jax_tpu/ops/flash.py``.  :func:`flash_attention`
keeps the JAX package's contract: ``[B, T, H, D]`` operands, f32
accumulation, ``causal`` with static block offsets, grouped-query heads,
and a default scale of ``1/sqrt(D)``.  On the card it launches the
hand-written CUDA forward kernel (``kernels/flash.py``), on CPU tensors
that kernel's plain PyTorch version, which walks the keys in the tiles
``_blocks`` gives, as the Pallas kernel does.

This slice ports the forward only.  A gradient through
:func:`flash_attention` raises ``NotImplementedError``: the two backward
kernels belong to the training slice (:data:`TRAINING_ITEM`).
"""

import math

import torch

from mpi4jax_tpu_torch.kernels.flash import flash_fwd

__all__ = ["flash_attention"]

TRAINING_ITEM = (
    "ROADMAP.md Queue 1 item 4 (the transformer's training slice: the "
    "flash backward kernels of Queue 2 items 4-5)"
)


def _blocks(tq, tk, block_q, block_k):
    """Clamped block sizes and the padding that makes T a multiple of
    them (``mpi4jax_tpu/ops/flash.py:_blocks``)."""
    block_q = min(block_q, max(tq, 8))
    block_k = min(block_k, max(tk, 8))
    return block_q, block_k, (-tq) % block_q, (-tk) % block_k


class _FlashFn(torch.autograd.Function):
    """The forward kernel; its backward is not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, k_offset, block_k,
                with_lse):
        res = flash_fwd(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            k_offset=k_offset, with_lse=with_lse, block_k=block_k,
        )
        if with_lse:
            ctx.mark_non_differentiable(res[1], res[2])
        return res

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"the flash-attention backward is not ported yet: {TRAINING_ITEM}"
        )


def flash_attention(q, k, v, *, causal=False, scale=None, q_offset=0,
                    k_offset=0, block_q=1024, block_k=1024, with_lse=False):
    """Blockwise attention, same contract as ``local_attention``.

    ``q``: [B, Tq, Hq, D]; ``k``/``v``: [B, Tk, Hkv, D] with ``Hq % Hkv
    == 0`` (query head h attends kv head ``h // (Hq/Hkv)``; the kernel
    indexes the kv head, nothing is copied).  ``q_offset``/``k_offset``
    are the global positions of the first row/column, for causal
    masking of sequence-sharded blocks.  Sequence lengths need not be
    multiples of the blocks: keys past ``Tk`` are excluded as ``-inf``.

    ``block_q``/``block_k`` are kept for the JAX package's signature.
    They set the key tiles of the plain version on the CPU (clamped as
    ``_blocks`` clamps them); the CUDA kernel uses its own tiles.

    ``with_lse=True`` also returns the f32 row statistics ``m`` and
    ``l``, separately, each ``[B*Hq, Tq]`` (row ``b*Hq + h``).
    """
    d = q.shape[-1]
    hq, hk = q.shape[2], k.shape[2]
    if hq % hk:
        raise ValueError(
            f"flash_attention: query heads must be a multiple of kv "
            f"heads, got Hq={hq}, Hkv={hk}"
        )
    scale = (1.0 / math.sqrt(d)) if scale is None else float(scale)
    _, block_k, _, _ = _blocks(q.shape[1], k.shape[1], int(block_q),
                               int(block_k))
    return _FlashFn.apply(
        q, k, v, bool(causal), scale, int(q_offset), int(k_offset), block_k,
        bool(with_lse),
    )
