"""The measures by which ``chip_smoke.py`` holds the flash backward
kernels to their plain versions, and the float64 witness that decided the
bf16 one; and the training path's 2-layer gradient check: its float64
witness (``WitnessAttention``, ``witness_loss_and_grads``) equals
autograd of the loss written out in float64, and its measure
(``grad_readings``: the kernel path's mean difference from the witness
over the plain path's) passes two paths with rounding noise of one size
and fails an error like the planted forward fault's.

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


# ---- the training path's 2-layer gradient check (chip_smoke phase 9) ----


def test_witness_attention_is_causal_float64_attention():
    # forward and gradient of WitnessAttention equal autograd of a dense
    # float64 causal attention with grouped-query heads
    rng = np.random.default_rng(7)
    q, g = (torch.tensor(rng.standard_normal((2, 12, 4, 8)))
            for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((2, 12, 2, 8)))
            for _ in range(2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = _SMOKE.WitnessAttention.apply(*leaves)
    got = torch.autograd.grad(out, leaves, g)
    dense = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ql, kl, vl = dense
    s = torch.einsum("bqhd,bkhd->bhqk", ql, kl.repeat_interleave(2, dim=2))
    s = s / math.sqrt(8)
    s = s.masked_fill(~torch.ones(12, 12, dtype=torch.bool).tril(),
                      -math.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                        vl.repeat_interleave(2, dim=2))
    torch.testing.assert_close(out, want, rtol=0, atol=1e-12)
    for a, b in zip(got, torch.autograd.grad(want, dense, g)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def _float64_loss(leaves, tokens, targets, cfg):
    """The training loss written out in float64: the layer math of the
    port's transformer with dense causal attention."""
    embed, ln1, wq, wk, wv, wo, ln2, w1, w2, ln_f, head = leaves
    b, s = tokens.shape

    def norm(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + cfg.eps) * w

    x = embed[tokens]
    group = cfg.heads // cfg.kv_heads
    seen = torch.ones(s, s, dtype=torch.bool).tril()
    for i in range(cfg.layers):
        h = norm(x, ln1[i])
        q = (h @ wq[i]).reshape(b, s, cfg.heads, cfg.head_dim)
        k = (h @ wk[i]).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        v = (h @ wv[i]).reshape(b, s, cfg.kv_heads, cfg.head_dim)
        sc = torch.einsum("bqhd,bkhd->bhqk", q,
                          k.repeat_interleave(group, dim=2))
        sc = (sc / math.sqrt(cfg.head_dim)).masked_fill(~seen, -math.inf)
        a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1),
                         v.repeat_interleave(group, dim=2))
        x = x + a.reshape(b, s, -1) @ wo[i]
        m = torch.nn.functional.gelu(norm(x, ln2[i]) @ w1[i],
                                     approximate="tanh")
        x = x + m @ w2[i]
    logits = norm(x, ln_f) @ head
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - picked).mean()


def test_witness_gradient_is_the_float64_gradient():
    # the witness (float64 layers recomputed in the backward, chunked
    # cross-entropy) equals autograd of the loss written out in float64
    # from the same bf16 parameters and tokens
    from mpi4jax_tpu_torch.models import transformer as tfm
    from mpi4jax_tpu_torch.parallel.comm import MeshComm

    cfg = tfm.TransformerConfig(vocab=48, d_model=16, layers=2, heads=4,
                                kv_heads=2, head_dim=4, d_ff=32)
    gen = torch.Generator().manual_seed(3)
    params = tfm.init_params(cfg, generator=gen, dtype=torch.bfloat16,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=gen)
    targets = torch.roll(tokens, -1, dims=1)
    world = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    loss, grads = _SMOKE.witness_loss_and_grads(
        params, (tokens, targets), cfg, world.sub("tp"), world.sub("sp"),
        chunk=8)
    leaves = [t.detach().double().requires_grad_(True)
              for t in tfm._leaves(params)]
    want_loss = _float64_loss(leaves, tokens, targets, cfg)
    want = torch.autograd.grad(want_loss, leaves)
    assert loss.dtype == torch.float64
    torch.testing.assert_close(loss, want_loss.detach(), rtol=1e-13,
                               atol=0)
    for got, w in zip(grads, want):
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, w, rtol=1e-10, atol=1e-13)


def test_grad_readings():
    rng = np.random.default_rng(11)
    witness = torch.tensor(rng.standard_normal(4096))
    plain = (witness * (1 + 1e-3 * torch.tensor(
        rng.standard_normal(4096)))).to(torch.bfloat16)
    r = _SMOKE.grad_readings(plain, plain, witness)
    assert r["kp_max"] == r["kp_mean"] == 0.0 and r["finite"]
    assert r["kw_mean"] == r["pw_mean"] > 0
    moved = plain.double()
    moved[5] += 0.25 * plain.double().abs().max()
    r = _SMOKE.grad_readings(moved, plain)
    assert set(r) == {"kp_max", "kp_mean", "finite"}
    assert r["kp_max"] == pytest.approx(0.25)
    assert r["kp_mean"] == pytest.approx(0.25 / 4096)
    moved[7] = math.nan
    assert not _SMOKE.grad_readings(moved, plain)["finite"]


def test_witness_ratio_sees_a_systematic_error():
    # two paths with independent rounding noise of one size are as far
    # from the witness (ratio ~1, the sound readings 0.985-1.015); an
    # error on half the elements twice the noise's size, as the planted
    # forward fault's (readings 1.54-2.35), fails the limit
    rng = np.random.default_rng(5)
    n = 1 << 16
    witness = torch.tensor(rng.standard_normal(n))
    plain, kernel, extra = (witness * 1e-3 * torch.tensor(
        rng.standard_normal(n)) for _ in range(3))
    plain, kernel = witness + plain, witness + kernel
    sound = _SMOKE.grad_readings(kernel, plain, witness)
    assert abs(sound["ratio"] - 1) < 0.02
    assert sound["ratio"] <= _SMOKE.TRAIN_WITNESS_RATIO
    extra[n // 2:] = 0
    faulty = _SMOKE.grad_readings(kernel + 2 * extra, plain, witness)
    assert faulty["ratio"] > 1.5 > _SMOKE.TRAIN_WITNESS_RATIO
    assert faulty["kp_max"] < _SMOKE.TRAIN_GRAD_LIMIT
