"""The measures by which ``chip_smoke.py`` holds the flash backward
kernels to their plain versions, and the float64 witness that decided the
bf16 one.

bf16 (``BWD_LIMITS[bfloat16]``): the largest difference in bf16 steps of
the largest plain value (``top_steps``) and the mean difference over it.
A sound kernel differs from its plain version where an output rounds to
the other bf16 neighbour; at the top binade that is one step, which must
pass, while two steps there, or a mean shift as small as the planted
faults' smallest (1.1e-5 of the largest value), must fail.  The witness
(``witness_grads``) is the exact softmax-attention gradient in float64;
it is held to autograd of a dense float64 attention with the kernels'
masking conventions.
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # its run sits behind __main__
    return module


_SMOKE = _chip_smoke()
BF16 = _SMOKE.BWD_LIMITS[torch.bfloat16]


def _plain(seed, top):
    """A bf16 gradient-like tensor of 2^20 elements (a small case's
    size) whose largest element is ``top``, every other at most half
    of it."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(1 << 20), dtype=torch.float32)
    x = (x / x.abs().max() * 0.5 * abs(top)).to(torch.bfloat16)
    x[17] = top
    return x


def _moved(x, index, steps):
    """``x`` with element ``index`` moved by ``steps`` bf16 steps of its
    own binade (away from zero for positive ``steps``)."""
    y = x.clone()
    value = float(x[index])
    y[index] = value + steps * math.copysign(_SMOKE.bf16_step(value), value)
    assert float(y[index]) != value
    return y


# the largest element at the top or the bottom of its binade, or negative;
# moved away from zero or toward it
TOPS = [1.9921875, 1.0, -1.5, 0.01171875]


@pytest.mark.parametrize("top", TOPS)
@pytest.mark.parametrize("steps", [1, -1])
def test_one_step_flip_at_the_top_binade_passes(top, steps):
    want = _plain(0, top)
    got = _moved(want, 17, steps)
    assert float((got - want).abs().max()) > 0
    err = _SMOKE.readings(got, want)
    assert err["top_steps"] <= 1.0
    assert _SMOKE.within(err, BF16)


@pytest.mark.parametrize("top", TOPS)
def test_two_step_error_at_the_top_binade_fails(top):
    want = _plain(1, top)
    got = _moved(want, 17, -2)
    err = _SMOKE.readings(got, want)
    assert err["top_steps"] >= 2.0
    assert not _SMOKE.within(err, BF16)


@pytest.mark.parametrize("shift", [1e-5, 1e-4])
def test_mean_shift_like_the_faults_fails(shift):
    # every element moved by ``shift`` of the largest (ds_hi_only and
    # dv_trunc read their smallest means, 1.1e-5 and 1.6e-5, at the path
    # shape): far under a step of the largest, and the mean must see it
    want = _plain(2, 1.5).float()
    got = want + shift * 1.5
    err = _SMOKE.readings(got, want)
    assert err["top_steps"] < 1.0
    assert not _SMOKE.within(err, BF16)


def test_bf16_steps_is_a_step_of_each_element():
    ref = torch.tensor([1.0, 1.9921875, 0.5, 2.0 ** -20, 0.0],
                       dtype=torch.float64)
    got = ref + torch.tensor([2.0 ** -7, 2.0 ** -7, 2.0 ** -8, 0.0,
                              2.0 ** -17])
    # steps 2^-7 at [1, 2), 2^-8 at [0.5, 1); the floor 2^-8 max|ref|
    # lies in [2^-8, 2^-7), step 2^-15, for the tiny and zero elements
    assert torch.equal(_SMOKE.bf16_steps(got, ref),
                       torch.tensor([1.0, 1.0, 1.0, 0.0, 0.25],
                                    dtype=torch.float64))


CASES = [
    # B, Tq, Tk, Hq, Hkv, D, causal, q_offset, k_offset
    (1, 24, 24, 2, 2, 16, False, 0, 0),
    (1, 20, 30, 2, 2, 16, True, 8, 0),
    (1, 20, 30, 2, 2, 8, True, 0, 12),  # the first 12 rows see no key
    (2, 16, 16, 4, 2, 8, True, 0, 0),
]


@pytest.mark.parametrize("case", CASES, ids=["dense", "offsets",
                                             "fully_masked", "gqa"])
def test_witness_is_the_exact_gradient(case):
    b, tq, tk, hq, hk, d, causal, qo, ko = case
    rng = np.random.default_rng(tq + tk + hq)
    q, g = (torch.tensor(rng.standard_normal((b, tq, hq, d)))
            for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((b, tk, hk, d)))
            for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    wit = _SMOKE.witness_grads(q, k, v, g, causal=causal, scale=scale,
                               q_offset=qo, k_offset=ko)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ql, kl, vl = leaves
    kr = kl.repeat_interleave(hq // hk, dim=2)
    vr = vl.repeat_interleave(hq // hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", ql, kr) * scale
    if causal:
        seen = (qo + torch.arange(tq))[:, None] >= (ko + torch.arange(tk))
        # a large finite negative score, as the kernels' _NEG: a row that
        # sees no key gets uniform weights and no score gradient
        s = torch.where(seen, s, torch.tensor(-1e300, dtype=s.dtype))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vr)
    grads = torch.autograd.grad(out, leaves, g)
    for name, want in zip(("dq", "dk", "dv"), grads):
        assert wit[name].dtype == torch.float64
        torch.testing.assert_close(wit[name], want, rtol=0, atol=1e-12)


def test_extra_seeds_are_no_case_seed():
    # a case's seed is its index; the extra seeds of every case are new,
    # distinct, and the check runs the first of the witness's seeds
    n_cases = len(_SMOKE.bwd_check_cases())
    own = set(range(n_cases))
    extra = [s for i in range(n_cases)
             for s in _SMOKE.extra_seeds(i, _SMOKE.WITNESS_SEEDS)]
    assert len(set(extra)) == len(extra)
    assert not own & set(extra)
    for i in range(n_cases):
        assert (_SMOKE.extra_seeds(i, _SMOKE.BWD_EXTRA_SEEDS)
                == _SMOKE.extra_seeds(i, _SMOKE.WITNESS_SEEDS)[
                    :_SMOKE.BWD_EXTRA_SEEDS])
    names = {c[0] for c in _SMOKE.bwd_check_cases()}
    assert set(_SMOKE.WITNESS_CASES) <= names
