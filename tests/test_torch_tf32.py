"""The f32 flash kernels' split of f32 operands into TF32 terms, and the
planted faults that ``chip_smoke.py --fault-readings`` edits into the
kernel sources.

The f32 forward and backward kernels (``kernels/csrc/flash_fwd.cu``,
``flash_bwd.cu``) take each f32 product on the tensor cores as three
TF32 products of big = tf32(x) and small = tf32(x - big).
``kernels/flash.py:tf32_split`` mirrors that split bit for bit; these
tests hold it to what the kernels' headers claim: big has its low 13
mantissa bits clear, rounded to nearest with ties to even; x - big is
exact; big + small is x to within 2^-22 of |x| (2^-137 absolute where
small falls below f32's normal range); and a dot product of split
operands, three products a pair summed in f32, stays within the stated
bound of a float64 dot.  The planted faults are exact string edits: each
old text must occur exactly once in its source, or ``--fault-readings``
stops on the card.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from mpi4jax_tpu_torch.kernels.flash import tf32_split

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "mpi4jax_tpu_torch" / "kernels" / "csrc"

# largest magnitude the split keeps finite and exact: big must not round
# up to infinity, (2 - 2^-11) 2^127 = 3.4020e38; the kernels' operands
# are far below it
_MAX = 3.39e38
_LOW13 = (1 << 13) - 1


def _bits(x):
    return x.view(torch.int32).numpy().view(np.uint32)


def _from_bits(bits):
    return torch.from_numpy(np.asarray(bits, np.uint32).view(np.float32))


def _values(kind, rng, n=4096):
    """f32 values of one kind: every exponent of the normal range, ties
    at the 13th bit, the top of the range, subnormals, zeros."""
    sign = rng.integers(0, 2, n, dtype=np.uint32) << 31
    mant = rng.integers(0, 1 << 23, n, dtype=np.uint32)
    if kind == "zero":
        return torch.tensor([0.0, -0.0])
    if kind == "subnormal":
        return _from_bits(sign | mant)
    exp = rng.integers(1, 255, n, dtype=np.uint32)
    if kind == "ties":
        # the 13 dropped bits exactly half a TF32 step: a tie for big
        mant = (mant & ~np.uint32(_LOW13)) | np.uint32(1 << 12)
    elif kind == "large":
        exp = rng.integers(250, 255, n, dtype=np.uint32)
    x = _from_bits(sign | (exp << 23) | mant)
    if kind == "large":
        x = torch.cat([x, torch.tensor([_MAX, -_MAX])])
    return x[x.abs() <= _MAX]


KINDS = ["random", "ties", "large", "subnormal", "zero"]


def _rne_reference(x):
    """big by round-to-nearest-even at bit 13 of the pattern, in numpy
    integer steps independent of the mirror: round down, then up when
    the dropped part is above half, or exactly half with an odd kept
    last bit."""
    u = _bits(x).astype(np.uint64)
    down = u & ~np.uint64(_LOW13)
    rest = u & np.uint64(_LOW13)
    half = np.uint64(1 << 12)
    odd = (down >> np.uint64(13)) & np.uint64(1)
    up = (rest > half) | ((rest == half) & (odd == 1))
    return _from_bits((down + up.astype(np.uint64) * np.uint64(1 << 13))
                      .astype(np.uint32))


@pytest.mark.parametrize("kind", KINDS)
def test_tf32_split_big_rounds_to_nearest_even(kind):
    x = _values(kind, np.random.default_rng(KINDS.index(kind)))
    assert x.numel() > 0
    big, small = tf32_split(x)
    for t in (big, small):
        assert t.dtype == torch.float32
        assert (_bits(t) & _LOW13 == 0).all()
    assert torch.equal(big, _rne_reference(x))
    assert torch.isfinite(big).all() and torch.isfinite(small).all()
    if kind == "ties":
        # ties go to the even neighbour: big's last kept bit is 0
        assert ((_bits(big) >> 13) & 1 == 0).all()


@pytest.mark.parametrize("kind", KINDS)
def test_tf32_split_is_exact_to_2_22(kind):
    # x - big is exact in f32, and big + small is x to within 2^-22 of
    # |x| (down to 2^-115; below, small's own subnormal step 2^-136 rules:
    # within 2^-137)
    x = _values(kind, np.random.default_rng(10 + KINDS.index(kind)))
    big, small = tf32_split(x)
    xd = x.double()
    assert torch.equal((x - big).double(), xd - big.double())
    left = (big.double() + small.double() - xd).abs()
    assert (left <= torch.maximum(2.0 ** -22 * xd.abs(),
                                  torch.tensor(2.0 ** -137))).all()
    if kind not in ("zero", "subnormal"):
        normal = xd.abs() >= 2.0 ** -115
        assert normal.any()
        assert (left[normal] <= 2.0 ** -22 * xd.abs()[normal]).all()


def _sum_f32(terms):
    """Sum ``terms`` [n, rows] in f32, one term after another."""
    acc = np.zeros(terms.shape[1], np.float32)
    for t in terms:
        acc = acc + t
    return acc


@pytest.mark.parametrize("d", [32, 64, 128])
def test_3xtf32_dot_within_bound(d):
    # a row of the kernels' S = Q K^T (or any of their products): three
    # TF32 products a pair, each exact in f32 (11 x 11 significant bits),
    # summed in f32.  Against a float64 dot the error is at most the
    # dropped small*small and the two splits' residues, 3 * 2^-22 of each
    # |x y|, plus f32 summation of 3 d terms, gamma(3 d) of sum |x y|;
    # one TF32 product a pair (1xTF32) errs by far more
    rng = np.random.default_rng(d)
    rows = 512
    x = rng.standard_normal((rows, d)).astype(np.float32)
    scale = np.exp(rng.uniform(-4, 4, (rows, 1)))
    y = (rng.standard_normal((rows, d)) * scale).astype(np.float32)
    xb, xs = (t.numpy() for t in tf32_split(torch.from_numpy(x)))
    yb, ys = (t.numpy() for t in tf32_split(torch.from_numpy(y)))
    terms = np.concatenate([xb * ys, xs * yb, xb * yb], axis=1)
    # the products are exact in f32
    for a, b, p in ((xb, ys, terms[:, :d]), (xs, yb, terms[:, d:2 * d]),
                    (xb, yb, terms[:, 2 * d:])):
        assert np.array_equal(p.astype(np.float64),
                              a.astype(np.float64) * b.astype(np.float64))
    dot3 = _sum_f32(terms.T)
    dot1 = _sum_f32((xb * yb).T)
    exact = (x.astype(np.float64) * y.astype(np.float64)).sum(axis=1)
    mag = np.abs(x.astype(np.float64) * y.astype(np.float64)).sum(axis=1)
    n = 3 * d
    gamma = n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
    # the terms' magnitudes exceed |x y| by at most 2^-9 of it
    bound = (3 * 2.0 ** -22 + 1.01 * gamma) * mag
    err3 = np.abs(dot3 - exact)
    assert (err3 <= bound).all(), (err3 / mag).max()
    err1 = np.abs(dot1 - exact)
    assert (err1 / mag).max() > 100 * (err3 / mag).max()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # its run sits behind __main__
    return module


_SMOKE = _chip_smoke()
PLANTED = [(prefix + name, source, edit)
           for prefix, source, faults, _, _ in _SMOKE.FAULT_PLANS
           for name, edit in faults.items()]


@pytest.mark.parametrize("name, source, edit", PLANTED,
                         ids=[p[0] for p in PLANTED])
def test_planted_fault_text_occurs_once(name, source, edit):
    old, new = edit
    text = (CSRC / source).read_text()
    assert text.count(old) == 1, f"{name}: {old!r} in {source}"
    assert new != old
