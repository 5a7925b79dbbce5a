"""JAX's threefry-2x32 key stream in PyTorch integer ops.

The decoder's categorical sampler draws the same tokens as the JAX
package's, so it needs ``jax.random``'s bits, not a ``torch.Generator``'s.
This module reproduces, bit for bit, the default implementation of the
installed JAX (``jax/_src/prng.py``, ``jax/_src/random.py``): the
threefry-2x32 hash, ``fold_in``, ``split`` and ``random_bits`` in their
partitionable form (``jax_threefry_partitionable=True``, the default
since JAX 0.5), ``uniform`` and ``gumbel`` in float32 (the "low"
dynamic-range mode, the default), ``categorical`` with replacement, and
``normal`` in float32, whose uniform bits are JAX's and whose inverse
error function is PyTorch's (a few float32 ulps from XLA's).

A key is JAX's legacy key, ``uint32[2]``: ``jax.random.PRNGKey(s)`` is
``[0, s]`` for ``0 <= s < 2**32``.  Keys are carried as int64 tensors
whose values lie in ``[0, 2**32)``; every sum is masked back to 32 bits,
so the hash is plain elementwise tensor arithmetic, with no host
synchronisation and nothing that a CUDA graph capture refuses.  Keys may
be batched: a key tensor of shape ``(..., 2)`` gives one result per key.
"""

import numpy as np
import torch

__all__ = ["raw_key", "threefry2x32", "fold_in", "split", "random_bits",
           "uniform", "normal", "gumbel", "categorical"]

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32: the smallest normal number and the mantissa width
_TINY = float(np.finfo(np.float32).tiny)
_NMANT = 23


def raw_key(key, device=None):
    """``key`` as an int64 tensor of shape ``(2,)`` on ``device``.

    Takes a legacy key (``uint32[2]``, or any integer pair in
    ``[0, 2**32)``) as a tensor, a numpy array or a JAX array, and a JAX
    typed key (``jax.random.key``), whose key data it unwraps, as the JAX
    decoder's ``_raw_key`` does (through the array's ``_base_array``: the
    port does not import JAX, whose public ``key_data`` this equals)."""
    if str(getattr(key, "dtype", "")).startswith("key<"):
        key = key._base_array
    if not torch.is_tensor(key):
        key = np.asarray(key)
        if key.dtype.kind not in "iu":
            key = torch.from_numpy(key.astype(np.float64))  # refused below
        else:
            key = torch.from_numpy(key.astype(np.int64))
    if tuple(key.shape) != (2,) or key.is_floating_point():
        raise ValueError(
            f"a key is an integer pair (jax.random.PRNGKey's uint32[2]), "
            f"got {key.dtype} of shape {tuple(key.shape)}"
        )
    return (key.to(device=device, dtype=torch.int64) & MASK)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash of the counts ``(x1, x2)`` under the key
    ``(k1, k2)``: 20 rounds, a key injection after every 4.  Arguments
    broadcast; values are 32-bit words in int64 tensors (or ints)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: the key hashed with the count
    ``[0, data]`` (``data`` as uint32).  ``data`` is an int or an
    integer tensor; a tensor of shape ``S`` gives keys of shape
    ``S + (2,)``, as ``jax.vmap`` over ``data`` would."""
    if not torch.is_tensor(data):
        data = torch.full((), int(data), dtype=torch.int64,
                          device=key.device)
    data = data.to(torch.int64) & MASK
    k1, k2 = key[..., 0], key[..., 1]
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def _counts(shape, device):
    """The flat index of each element of ``shape`` as the two 32-bit
    words of a 64-bit count (``iota_2x32_shape``)."""
    n = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                     device=device).reshape(shape)
    return n >> 32, n & MASK


def split(key, num=2):
    """``jax.random.split(key, num)`` (partitionable form): key ``n`` is
    the hash of the count ``n``, both words kept.  ``key``: ``(2,)``;
    returns ``(num, 2)``."""
    c1, c2 = _counts((int(num),), key.device)
    y1, y2 = threefry2x32(key[0], key[1], c1, c2)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key, shape):
    """``jax.random.bits(key, shape, uint32)`` (partitionable form): for
    each flat index n of ``shape``, the hash of the count ``(n >> 32,
    n & 0xffffffff)``, its two words xor-ed.  ``key``: ``(..., 2)``;
    returns int64 words of shape ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    c1, c2 = _counts(shape, key.device)
    lead = tuple(key.shape[:-1]) + (1,) * len(shape)
    k1, k2 = key[..., 0].reshape(lead), key[..., 1].reshape(lead)
    y1, y2 = threefry2x32(k1, k2, c1, c2)
    return y1 ^ y2


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled to
    ``[minval, maxval)`` in float32 and floored at ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> (32 - _NMANT)) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return (floats * float(hi - lo) + float(lo)).clamp_min(float(lo))


def normal(key, shape):
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erfinv(u)`` of a uniform ``u`` on ``[nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2)))


def gumbel(key, shape):
    """``jax.random.gumbel(key, shape, float32)`` ("low" mode):
    ``-log(-log(u))`` of a uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)`` along the last axis, by the
    Gumbel-max trick: the first index of the largest ``gumbel + logits``.
    ``key``: ``(..., 2)`` with ``...`` the batch of ``logits`` (float32,
    ``(..., V)``), one key per row, as ``jax.vmap(categorical)`` draws."""
    noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(noise + logits, dim=-1)
