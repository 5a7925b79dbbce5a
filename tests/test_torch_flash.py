"""The port's flash attention, its gradient, and dense local attention
against the JAX package.

On CPU tensors the port's ``flash_attention`` runs the plain PyTorch
versions of its CUDA kernels (``kernels/flash.py``, ``kernels/
flash_bwd.py``), which walk the keys in the tiles ``block_k`` gives, as
the Pallas kernels do.  They are held against the Pallas kernels in
interpret mode on the cases of ``tests/parallel/test_flash.py``
(padding, ragged q/k with offsets, fully masked rows, D 128), with bf16
operands and with grouped-query heads: ``out`` to atol 2e-5 in f32 (the
dense oracle's tolerance there) and 3e-2 in bf16, the row statistics
``m`` and ``l`` to rtol 1e-5; the gradients dq, dk, dv (``jax.vjp`` of
the JAX ``flash_attention`` against autograd through the port's) to
atol 5e-6 in f32 (the JAX fully-masked-row gradient tolerance of 2e-5,
tightened to the readings) and, in bf16, to 1e-2 of each gradient's
largest magnitude.
Inputs and cotangents are made from a seed with numpy and handed to
both.  The bf16 plain backward is also held to the Pallas gradients at
the key tile of the tensor-core kernels that run bf16 on the card; the
launch step's dispatch by dtype is checked with the kernel libraries
replaced by a recorder; and a Python mirror of those kernels' split of
ds into three bf16 terms is checked to be exact.
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
from mpi4jax_tpu_torch.kernels import flash_bwd as kbwd
from mpi4jax_tpu_torch.ops.flash import flash_attention
from mpi4jax_tpu_torch.parallel.longseq import local_attention

torch.set_num_threads(1)

F32_ATOL = 2e-5
BF16_ATOL = 3e-2
STAT_RTOL = 1e-5
# f32 gradients, port against JAX: the JAX package's 2e-5 tightened to
# the readings, at most 2.5e-6 (triangle_8x8, gqa_causal), for f32 sums
# taken in another order
F32_GRAD_ATOL = 5e-6
# bf16 gradients, port against JAX: max |difference| over max |JAX| per
# gradient.  The two round the bf16 weights, dV's bf16 operand and the
# outputs at the same places but sum in another order, and the JAX
# package sums a kv head's dK, dV over its query heads after rounding
# each to bf16, so an element may land a bf16 step or two (2^-8 of its
# size each) away; the readings are 2.8e-3 to 7.5e-3 (d128_offsets dv).
BF16_GRAD = 1e-2

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


@pytest.mark.parametrize("block_k", [kflash.BLOCK_K, kflash.BLOCK_K_MMA],
                         ids=["f32_kernel", "bf16_kernel"])
@pytest.mark.parametrize("name", ["padding", "ragged_offset", "gqa_offsets",
                                  "fully_masked"])
def test_kernel_tiles_match_pallas_tiles(name, block_k):
    # the plain version at each CUDA kernel's own key tile (what the card
    # is held against) still agrees with the Pallas kernel's tiling
    causal, qo, ko, _ = CASES[name][6:]
    q, k, v = _torch(_qkv(CASES[name]))
    got = kflash.flash_attention_reference(
        q, k, v, causal=causal, scale=1.0 / math.sqrt(q.shape[-1]),
        q_offset=qo, k_offset=ko, block_k=block_k,
    )
    np.testing.assert_allclose(got.numpy(), _pallas(name)[0], atol=F32_ATOL)


def test_kernel_tile_by_dtype():
    # the plain version on CPU tensors walks the tile of the kernel that
    # runs their dtype on the card
    assert kflash.kernel_block_k(torch.float32) == kflash.BLOCK_K == 32
    assert kflash.kernel_block_k(torch.bfloat16) == kflash.BLOCK_K_MMA == 64
    q, k, v = _torch(_qkv(CASES["padding"], dtype=ml_dtypes.bfloat16),
                     torch.bfloat16)
    kw = dict(causal=False, scale=0.125)
    want = kflash.flash_attention_reference(q, k, v, block_k=64, **kw)
    assert torch.equal(kflash.flash_fwd(q, k, v, **kw), want)


class _Recorder:
    """A stand-in for a built kernel library: records each launcher
    call's name and arguments and returns 0 (success)."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, fn):
        def record(*args):
            self.calls.append((self.name, fn, args))
            return 0
        return record


@pytest.mark.parametrize("dtype, library", [
    (torch.bfloat16, "flash_fwd_mma"),
    (torch.float32, "flash_fwd"),
])
def test_forward_dispatch_by_dtype(monkeypatch, dtype, library):
    # the launch step, with the ctypes libraries replaced by a recorder:
    # bf16 goes to the tensor-core kernel, f32 to the CUDA-core one, with
    # the same arguments, and both count in flash_fwd.launches
    calls = []
    monkeypatch.setattr(kflash, "_library",
                        lambda name: _Recorder(name, calls))
    kflash.reset_launch_counts()
    q, k, v = (t.to(dtype) for t in _torch(_qkv(CASES["gqa_offsets"])))
    out = torch.empty_like(q)
    m, l = torch.empty((2, 4 * 48)), torch.empty((2, 4 * 48))
    kflash._launch(q, k, v, out, m, l, causal=True, scale=0.125,
                   q_offset=64, k_offset=0, stream=None)
    kflash._launch(q, k, v, out, None, None, causal=False, scale=0.125,
                   q_offset=0, k_offset=0, stream=None)
    assert [c[:2] for c in calls] == [(library, f"{library}_launch")] * 2
    args = calls[0][2]
    assert args[:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), m.data_ptr(), l.data_ptr())
    # B, Tq, Tk, Hq, Hkv, D, causal, q_offset, k_offset, scale, stream
    assert args[6:] == (1, 48, 112, 4, 2, 64, 1, 64, 0, 0.125, None)
    assert calls[1][2][4:6] == (None, None)
    assert kflash.flash_fwd.launches == 2
    assert kflash.flash_fwd.mma_launches == (2 if dtype == torch.bfloat16
                                             else 0)
    kflash.reset_launch_counts()
    assert kflash.flash_fwd.launches == kflash.flash_fwd.mma_launches == 0


@pytest.mark.parametrize("tq", [64, 128])
@pytest.mark.parametrize("d", [8, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_auto_rule(dtype, d, tq):
    # "auto" takes the kernels exactly for the dtypes and head dims both
    # the forward and the backward wrappers accept, from 128 query rows;
    # on CPU tensors never
    covered = dtype in (torch.float32, torch.bfloat16) and d in (32, 64,
                                                                 128)
    q_shape, k_shape = (2, tq, 4, d), (2, tq, 2, d)
    assert kflash.flash_covers(dtype, q_shape, k_shape) == covered
    assert kflash.auto_takes_flash(dtype, q_shape, k_shape) == (
        covered and tq >= 128)
    q = torch.zeros(q_shape, dtype=dtype)
    k = torch.zeros(k_shape, dtype=dtype)
    v = torch.zeros(k_shape, dtype=dtype)
    assert not kflash.flash_supported(q, k, v)
    b, _, hq, _ = q_shape
    g, m = torch.zeros_like(q), torch.zeros((b * hq, tq))
    for check in (lambda: kflash._check_operands(q, k, v),
                  lambda: kbwd._check_backward(q, k, v, g, m, m, m)):
        if covered:
            check()
        else:
            with pytest.raises((TypeError, ValueError)):
                check()


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_attention_auto_on_cpu_is_dense(dtype, d):
    # impl="auto" on CPU tensors is the dense path, at head dims the
    # kernels do not cover too
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in ((1, 160, 4, d),
                                             (1, 160, 2, d),
                                             (1, 160, 2, d)))
    dense = local_attention(q, k, v, causal=True, impl="xla")
    assert torch.equal(local_attention(q, k, v, causal=True), dense)
    assert torch.equal(local_attention(q, k, v, causal=True, impl="auto"),
                       dense)


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


def _cotangent(case, dtype=np.float32, seed=5):
    b, tq, _, hq, _, d = case[:6]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, tq, hq, d)).astype(np.float32).astype(
        dtype)


@functools.cache
def _pallas_grads(name, bf16=False):
    """``jax.vjp`` of the JAX ``flash_attention`` (Pallas kernels in
    interpret mode) at the case's blocks: ``(dq, dk, dv)`` as numpy f32.
    GQA cases go through its ``jnp.repeat``, whose transpose sums dK
    and dV over each kv head's query heads."""
    case = CASES[name]
    causal, qo, ko, block = case[6:]
    dtype = ml_dtypes.bfloat16 if bf16 else np.float32
    q, k, v = (jnp.asarray(a) for a in _qkv(case, dtype=dtype))
    fn = functools.partial(
        jflash.flash_attention, causal=causal, q_offset=qo, k_offset=ko,
        block_q=block, block_k=block, interpret=True,
    )
    _, vjp = jax.vjp(fn, q, k, v)
    grads = jax.jit(vjp)(jnp.asarray(_cotangent(case, dtype)))
    return tuple(np.asarray(gr, np.float32) for gr in grads)


def _port_grads(name, dtype=torch.float32, **kw):
    """Autograd through the port's ``flash_attention`` (the plain
    versions, on the CPU) at the case's blocks: ``(dq, dk, dv)``."""
    case = CASES[name]
    causal, qo, ko, block = case[6:]
    npdtype = ml_dtypes.bfloat16 if dtype == torch.bfloat16 else np.float32
    q, k, v = (t.requires_grad_(True)
               for t in _torch(_qkv(case, dtype=npdtype), dtype))
    out = flash_attention(q, k, v, causal=causal, q_offset=qo, k_offset=ko,
                          block_q=block, block_k=block, **kw)
    out.backward(_torch([_cotangent(case, npdtype)], dtype)[0])
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("name", list(CASES))
def test_flash_grad_matches_pallas(name):
    for label, got, want in zip("qkv", _port_grads(name),
                                _pallas_grads(name)):
        assert got.dtype == torch.float32
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, atol=F32_GRAD_ATOL,
                                   err_msg=f"d{label}")


@pytest.mark.parametrize("name", list(CASES))
def test_flash_grad_bf16_matches_pallas(name):
    for label, got, want in zip("qkv", _port_grads(name, torch.bfloat16),
                                _pallas_grads(name, True)):
        assert got.dtype == torch.bfloat16
        scale = max(np.abs(want).max(), 1e-30)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_GRAD * scale, (f"d{label}", err, scale)


@pytest.mark.parametrize("name", ["padding", "ragged_offset", "gqa_offsets",
                                  "fully_masked", "padded_fully_masked"])
def test_bwd_kernel_tiles_match_pallas_tiles(name):
    # the plain backward at the CUDA kernels' own key tile (what the card
    # is held against) agrees with itself at the Pallas kernels' tiling
    case = CASES[name]
    causal, qo, ko, block = case[6:]
    q, k, v = _torch(_qkv(case))
    g = _torch([_cotangent(case)])[0]
    kw = dict(causal=causal, scale=1.0 / math.sqrt(q.shape[-1]),
              q_offset=qo, k_offset=ko)
    out, m, l = kflash.flash_attention_reference(q, k, v, with_lse=True,
                                                 **kw)
    at_kernel = kbwd.flash_bwd_reference(q, k, v, out, g, m, l,
                                         block_k=kbwd.BLOCK_K, **kw)
    at_pallas = kbwd.flash_bwd_reference(q, k, v, out, g, m, l,
                                         block_k=block, **kw)
    for got, want in zip(at_kernel, at_pallas):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL)


@pytest.mark.parametrize("name", ["gqa_causal", "gqa_offsets"])
def test_gqa_grads_match_dense(name):
    # dk, dv of a kv head summed over its query heads, as autograd
    # through the dense oracle (which never repeats a kv head) gives them
    case = CASES[name]
    causal, qo, ko, _ = case[6:]
    g = _torch([_cotangent(case)])[0]
    grads = {}
    for impl in ("flash", "xla"):
        q, k, v = (t.requires_grad_(True) for t in _torch(_qkv(case)))
        local_attention(q, k, v, causal=causal, q_offset=qo, k_offset=ko,
                        impl=impl).backward(g)
        grads[impl] = (q.grad, k.grad, v.grad)
    assert grads["flash"][1].shape == (case[0], case[2], case[4], case[5])
    for got, want in zip(grads["flash"], grads["xla"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL)


def test_flash_saves_for_backward_only_when_needed():
    # no gradient asked for: the forward alone, no graph; asked for: the
    # row statistics stay non-differentiable beside a differentiable out
    q, k, v = _torch(_qkv(CASES["gqa_causal"]))
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    q.requires_grad_(True)
    out, m, l = flash_attention(q, k, v, causal=True, with_lse=True)
    assert out.grad_fn is not None
    assert not m.requires_grad and not l.requires_grad
    out.sum().backward()
    assert q.grad.shape == q.shape and k.grad is None


def test_backward_operand_checks():
    # what the CUDA wrappers refuse before a launch (plain Python checks)
    q, k, v = _torch(_qkv(CASES["gqa_causal"]))
    b, tq, hq, _ = q.shape
    m = torch.zeros((b * hq, tq))
    with pytest.raises(ValueError, match="dO"):
        kbwd._check_backward(q, k, v, q[:, :-1], m, m, m)
    with pytest.raises(ValueError, match="delta must be float32"):
        kbwd._check_backward(q, k, v, q, m, m, m[:, :-1])
    with pytest.raises(ValueError, match="unsupported device"):
        kbwd._prepare(q, k, v, q, m, m, m)


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


def test_bwd_kernel_tile_by_dtype():
    # the plain backward on CPU tensors walks the key tile of the dq
    # kernel that runs their dtype on the card
    assert kbwd.kernel_block_k(torch.float32) == kbwd.BLOCK_K == 32
    assert kbwd.kernel_block_k(torch.bfloat16) == kbwd.BLOCK_K_MMA == 64
    case = CASES["gqa_offsets"]
    causal, qo, ko, _ = case[6:]
    q, k, v = _torch(_qkv(case, dtype=ml_dtypes.bfloat16), torch.bfloat16)
    g = _torch([_cotangent(case, ml_dtypes.bfloat16)], torch.bfloat16)[0]
    kw = dict(causal=causal, scale=0.125, q_offset=qo, k_offset=ko)
    out, m, l = kflash.flash_fwd(q, k, v, with_lse=True, **kw)
    delta = kbwd.row_delta(g, out)
    args = (q, k, v, g, m, l, delta)
    assert torch.equal(kbwd.flash_bwd_dq(*args, **kw),
                       kbwd.flash_bwd_dq_reference(*args, block_k=64, **kw))
    for got, want in zip(
            kbwd.flash_bwd_dkv(*args, **kw),
            kbwd.flash_bwd_dkv_reference(*args, block_k=64, **kw)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype, library, suffix", [
    (torch.bfloat16, "flash_bwd_mma", "_mma"),
    (torch.float32, "flash_bwd", ""),
])
def test_backward_dispatch_by_dtype(monkeypatch, dtype, library, suffix):
    # the launch step, with the ctypes libraries replaced by a recorder:
    # bf16 goes to the tensor-core kernels, f32 to the CUDA-core ones,
    # with the same arguments; launches counts both, mma_launches the
    # tensor-core ones
    calls = []
    monkeypatch.setattr(kbwd, "_library",
                        lambda name, suffix: _Recorder(name, calls))
    kbwd.reset_launch_counts()
    q, k, v = (t.to(dtype) for t in _torch(_qkv(CASES["gqa_offsets"])))
    g = torch.empty_like(q)
    m, l, delta = (torch.empty((4, 48)) for _ in range(3))
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    kw = dict(causal=True, scale=0.125, q_offset=64, k_offset=0,
              stream=None)
    kbwd._launch("dkv", q, k, v, g, m, l, delta, (dk, dv), **kw)
    kbwd._launch("dq", q, k, v, g, m, l, delta, (dq,), **kw)
    assert [c[:2] for c in calls] == [
        (library, f"flash_bwd_dkv{suffix}_launch"),
        (library, f"flash_bwd_dq{suffix}_launch"),
    ]
    inputs = tuple(t.data_ptr() for t in (q, k, v, g, m, l, delta))
    # B, Tq, Tk, Hq, Hkv, D, dtype, causal, q_offset, k_offset, scale,
    # stream
    tail = (1, 48, 112, 4, 2, 64, int(dtype == torch.bfloat16), 1, 64, 0,
            0.125, None)
    assert calls[0][2] == inputs + (dk.data_ptr(), dv.data_ptr()) + tail
    assert calls[1][2] == inputs + (dq.data_ptr(),) + tail
    mma = 1 if dtype == torch.bfloat16 else 0
    for wrapper in (kbwd.flash_bwd_dkv, kbwd.flash_bwd_dq):
        assert (wrapper.launches, wrapper.mma_launches) == (1, mma)
    kbwd.reset_launch_counts()
    for wrapper in (kbwd.flash_bwd_dkv, kbwd.flash_bwd_dq):
        assert wrapper.launches == wrapper.mma_launches == 0


@pytest.mark.parametrize("name", list(CASES))
def test_bf16_grads_at_kernel_tiles_match_pallas(name):
    # the plain forward and backward at the tensor-core kernels' key tiles
    # (what the card is held against in bf16) against the Pallas kernels'
    # bf16 gradients in interpret mode
    case = CASES[name]
    causal, qo, ko, _ = case[6:]
    q, k, v = _torch(_qkv(case, dtype=ml_dtypes.bfloat16), torch.bfloat16)
    g = _torch([_cotangent(case, ml_dtypes.bfloat16)], torch.bfloat16)[0]
    kw = dict(causal=causal, scale=1.0 / math.sqrt(q.shape[-1]),
              q_offset=qo, k_offset=ko)
    out, m, l = kflash.flash_attention_reference(
        q, k, v, block_k=kflash.kernel_block_k(torch.bfloat16),
        with_lse=True, **kw)
    grads = kbwd.flash_bwd_reference(
        q, k, v, out, g, m, l,
        block_k=kbwd.kernel_block_k(torch.bfloat16), **kw)
    for label, got, want in zip("qkv", grads, _pallas_grads(name, True)):
        assert got.dtype == torch.bfloat16
        scale = max(np.abs(want).max(), 1e-30)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_GRAD * scale, (f"d{label}", err, scale)


def _split3(x):
    """The tensor-core kernels' split of an f32 ds into bf16 terms
    (``csrc/flash_bwd_mma.cu:split_fragments``), in the same steps: hi =
    bf16(x), rest = x - hi, mid = bf16(rest), lo = bf16(rest - mid), each
    in f32.  Returns ``(hi, rest, mid, lo)`` as f32 tensors."""
    hi = x.to(torch.bfloat16).float()
    rest = x - hi
    mid = rest.to(torch.bfloat16).float()
    lo = (rest - mid).to(torch.bfloat16).float()
    return hi, rest, mid, lo


def _f32_from_bits(bits):
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.float32))


# exactness holds for zero and every f32 of magnitude in [2^-110, 3.39e38]
# (biased exponent field 17 to 254, below bf16's overflow threshold
# (2 - 2^-8) 2^127): lo is a multiple of 2^(e-23) below 2^(e-15), which
# bf16 holds while e - 23 >= -133, its subnormal step
_EXACT_MIN_EXP, _EXACT_MAX = 17, 3.39e38


def _split_values(kind, rng, n=4096):
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    mant = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    if kind == "random":
        exp = rng.integers(_EXACT_MIN_EXP, 255, n, dtype=np.uint32)
    elif kind == "ties":
        # the 16 bits below bf16's last place exactly half a step: a
        # rounding tie for hi
        exp = rng.integers(_EXACT_MIN_EXP, 255, n, dtype=np.uint32)
        mant = (mant & ~np.uint32(0xFFFF)) | np.uint32(0x8000)
    elif kind == "large":
        exp = rng.integers(250, 255, n, dtype=np.uint32)
    elif kind == "tiny_normal":
        exp = rng.integers(_EXACT_MIN_EXP, _EXACT_MIN_EXP + 4, n,
                           dtype=np.uint32)
    x = _f32_from_bits(sign | (exp << 23) | mant)
    if kind == "large":
        x = torch.cat([x, torch.tensor([_EXACT_MAX, -_EXACT_MAX,
                                        3.3895313892515355e38])])
    return x[x.abs() <= _EXACT_MAX]


@pytest.mark.parametrize("kind", ["random", "ties", "large", "tiny_normal",
                                  "zero"])
def test_ds_split_is_exact(kind):
    # hi + mid + lo == ds exactly (summed in f64), each term a bf16 value,
    # and both f32 subtractions exact, for ds of every exponent where the
    # kernels' header claims it
    rng = np.random.default_rng(["random", "ties", "large", "tiny_normal",
                                 "zero"].index(kind))
    if kind == "zero":
        x = torch.tensor([0.0, -0.0])
    else:
        x = _split_values(kind, rng)
    assert x.numel() > 0
    hi, rest, mid, lo = _split3(x)
    xd = x.double()
    for t in (hi, mid, lo):
        assert torch.equal(t, t.to(torch.bfloat16).float())
    assert torch.equal(rest.double(), xd - hi.double())
    assert torch.equal((rest - mid).double(), rest.double() - mid.double())
    assert torch.equal(hi.double() + mid.double() + lo.double(), xd)
    if kind != "zero":
        # two terms leave up to 2^-16 of |ds|; the third removes it
        two = (hi.double() + mid.double() - xd).abs() / xd.abs()
        assert two.max() <= 2.0 ** -16


def test_ds_split_below_exact_range():
    # under 2^-110 the split is exact only to bf16's subnormal step:
    # what is left is at most half of 2^-133
    rng = np.random.default_rng(5)
    exp = rng.integers(1, _EXACT_MIN_EXP, 4096, dtype=np.uint32)
    mant = rng.integers(0, 1 << 23, 4096, dtype=np.uint32)
    x = _f32_from_bits((exp << 23) | mant)
    hi, _, mid, lo = _split3(x)
    left = (hi.double() + mid.double() + lo.double() - x.double()).abs()
    assert left.max() <= 2.0 ** -134
