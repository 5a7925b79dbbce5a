"""The port's flash attention and dense local attention against the JAX
package.

On CPU tensors the port's ``flash_attention`` runs the plain PyTorch
version of its CUDA kernel (``kernels/flash.py``), which walks the keys
in the tiles ``block_k`` gives, as the Pallas kernel does.  It is held
against the Pallas kernel in interpret mode on the cases of
``tests/parallel/test_flash.py`` (padding, ragged q/k with offsets,
fully masked rows, D 128), with bf16 operands and with grouped-query
heads: ``out`` to atol 2e-5 in f32 (the dense oracle's tolerance there)
and 3e-2 in bf16, the row statistics ``m`` and ``l`` to rtol 1e-5.
Inputs are made from a seed with numpy and handed to both.
"""

import functools
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mpi4jax_tpu.ops import flash as jflash
from mpi4jax_tpu.parallel import longseq as jlongseq

from mpi4jax_tpu_torch.kernels import flash as kflash
from mpi4jax_tpu_torch.ops.flash import flash_attention
from mpi4jax_tpu_torch.parallel.longseq import local_attention

torch.set_num_threads(1)

F32_ATOL = 2e-5
BF16_ATOL = 3e-2
STAT_RTOL = 1e-5

# B, Tq, Tk, Hq, Hkv, D, causal, q_offset, k_offset, block
CASES = {
    "mha": (2, 128, 128, 4, 4, 64, False, 0, 0, 64),
    "triangle": (1, 256, 256, 2, 2, 64, True, 0, 0, 64),
    "padding": (2, 100, 100, 3, 3, 64, False, 0, 0, 64),
    "ragged_offset": (1, 96, 160, 2, 2, 32, True, 64, 0, 64),
    "d128_offsets": (1, 64, 64, 1, 1, 128, True, 128, 64, 64),
    "triangle_8x8": (1, 512, 512, 1, 1, 64, True, 0, 0, 64),
    "fully_masked": (1, 64, 64, 2, 2, 64, True, 0, 512, 32),
    "padded_fully_masked": (1, 64, 100, 2, 2, 64, True, 0, 512, 64),
    "gqa_causal": (2, 80, 80, 4, 2, 32, True, 0, 0, 32),
    "gqa_offsets": (1, 48, 112, 4, 2, 64, True, 64, 0, 32),
}


def _qkv(case, dtype=np.float32, seed=0):
    b, tq, tk, hq, hk, d = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32).astype(dtype)
        for shape in ((b, tq, hq, d), (b, tk, hk, d), (b, tk, hk, d))
    )


def _torch(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
                 for a in arrays)


@functools.cache
def _pallas(name, bf16=False):
    """The Pallas kernel (interpret mode) on a case's inputs: ``(out, m,
    l)`` as numpy f32, from ``_flash_fwd_impl(..., with_lse=True)`` on
    kv heads repeated as ``flash_attention`` repeats them.  Cached: each
    interpret-mode call costs about a second of tracing."""
    case = CASES[name]
    b, tq, tk, hq, hk, d, causal, qo, ko, block = case
    q, k, v = _qkv(case, dtype=ml_dtypes.bfloat16 if bf16 else np.float32)
    k, v = (np.repeat(a, hq // hk, axis=2) for a in (k, v))
    run = jax.jit(functools.partial(
        jflash._flash_fwd_impl, causal=causal, scale=1.0 / math.sqrt(d),
        q_offset=qo, k_offset=ko, block_q=block, block_k=block,
        interpret=True, with_lse=True,
    ))
    res = run(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(r, np.float32) for r in res)


def _jax_dense(arrays, **kw):
    """The JAX package's dense local_attention, compiled once."""
    run = jax.jit(functools.partial(jlongseq.local_attention, impl="xla",
                                    **kw))
    return np.asarray(run(*(jnp.asarray(a) for a in arrays)), np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_matches_pallas(name):
    # out, and the row statistics m and l, which come back separately,
    # [B*H, Tq]; fully masked rows keep m == _NEG and l == the real key
    # count
    b, tq, tk, hq, hk, d, causal, qo, ko, block = CASES[name]
    out_want, m_want, l_want = _pallas(name)
    out, m, l = flash_attention(*_torch(_qkv(CASES[name])), causal=causal,
                                q_offset=qo, k_offset=ko, block_q=block,
                                block_k=block, with_lse=True)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), out_want, atol=F32_ATOL)
    assert m.shape == l.shape == (b * hq, tq)
    assert m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), m_want, rtol=STAT_RTOL)
    np.testing.assert_allclose(l.numpy(), l_want, rtol=STAT_RTOL)


@pytest.mark.parametrize("name", ["mha", "gqa_causal"])
def test_flash_bf16_matches_pallas(name):
    causal, qo, ko, block = CASES[name][6:]
    arrays = _qkv(CASES[name], dtype=ml_dtypes.bfloat16)
    got = flash_attention(*_torch(arrays, torch.bfloat16), causal=causal,
                          q_offset=qo, k_offset=ko, block_q=block,
                          block_k=block)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _pallas(name, True)[0],
                               atol=BF16_ATOL)


@pytest.mark.parametrize("name", ["padding", "ragged_offset", "gqa_offsets",
                                  "fully_masked"])
def test_kernel_tiles_match_pallas_tiles(name):
    # the plain version at the CUDA kernel's own key tile (what the card
    # is held against) still agrees with the Pallas kernel's tiling
    causal, qo, ko, _ = CASES[name][6:]
    q, k, v = _torch(_qkv(CASES[name]))
    got = kflash.flash_attention_reference(
        q, k, v, causal=causal, scale=1.0 / math.sqrt(q.shape[-1]),
        q_offset=qo, k_offset=ko, block_k=kflash.BLOCK_K,
    )
    np.testing.assert_allclose(got.numpy(), _pallas(name)[0], atol=F32_ATOL)


@pytest.mark.parametrize("name", ["ragged_offset", "gqa_offsets"])
def test_local_attention_dense_matches_jax(name):
    causal, qo, ko, _ = CASES[name][6:]
    arrays = _qkv(CASES[name], seed=1)
    want = _jax_dense(arrays, causal=causal, q_offset=qo, k_offset=ko)
    got = local_attention(*_torch(arrays), causal=causal, q_offset=qo,
                          k_offset=ko, impl="xla")
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL)


def test_local_attention_bf16_matches_jax():
    case = CASES["gqa_causal"]
    arrays = _qkv(case, dtype=ml_dtypes.bfloat16, seed=2)
    want = _jax_dense(arrays, causal=True)
    got = local_attention(*_torch(arrays, torch.bfloat16), causal=True,
                          impl="xla")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_ATOL)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_local_attention_impls_agree(impl):
    # "flash" on CPU tensors is the kernel's plain version; both agree
    # with the dense oracle, and "auto" resolves to dense on the CPU
    case = CASES["ragged_offset"]
    q, k, v = _torch(_qkv(case, seed=3))
    dense = local_attention(q, k, v, causal=True, q_offset=64, impl="xla")
    got = local_attention(q, k, v, causal=True, q_offset=64, impl=impl)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=F32_ATOL)
    auto = local_attention(q, k, v, causal=True, q_offset=64)
    assert torch.equal(auto, dense)


def test_local_attention_rejects_unknown_impl_and_gqa_mismatch():
    q, k, v = _torch(_qkv(CASES["gqa_causal"]))
    with pytest.raises(ValueError, match="impl"):
        local_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="multiple of kv heads"):
        local_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="multiple of kv"):
        flash_attention(q[:, :, :3], k, v)


def test_flash_backward_names_the_training_slice():
    q, k, v = _torch(_qkv(CASES["gqa_causal"]))
    q.requires_grad_(True)
    out = flash_attention(q, k, v, causal=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 4"):
        out.sum().backward()


@pytest.mark.parametrize(
    "bad, match",
    [
        (dict(dtype=torch.float16), "dtype"),
        (dict(d=48), "head dim"),
        (dict(hk=3), "multiple of Hkv"),
        (dict(tk=0), "Tk=0"),
    ],
)
def test_kernel_operand_checks(bad, match):
    # what the CUDA wrapper refuses before a launch (checked on CPU
    # tensors here: the checks are plain Python)
    d, hk, tk = bad.get("d", 64), bad.get("hk", 2), bad.get("tk", 16)
    dtype = bad.get("dtype", torch.float32)
    q = torch.zeros((1, 16, 4, d), dtype=dtype)
    k = torch.zeros((1, tk, hk, d), dtype=dtype)
    with pytest.raises((TypeError, ValueError), match=match):
        kflash._check_operands(q, k, k.clone())
