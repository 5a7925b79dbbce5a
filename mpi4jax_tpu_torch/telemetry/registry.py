"""Metrics registry: fixed log2-bucket histograms with p50/p99.

The port's copy of the histogram core of
``mpi4jax_tpu/telemetry/registry.py`` (``log2_bucket``, ``Histogram``
and the native bucket constants): the bucketing of the native metrics
table (``telemetry.h``), so a percentile here is the one the JAX
package reports for the same samples.

Percentiles come from the histograms: the value at quantile q is the
geometric midpoint of the bucket where the cumulative count crosses
q * total (clamped to the observed min/max by the caller) — a
<= 2x-per-bucket estimator.  Stdlib only.
"""

__all__ = ["LAT_BUCKETS", "LAT_BASE_LOG2", "SIZE_BUCKETS",
           "SIZE_BASE_LOG2", "SchemaError", "log2_bucket", "Histogram"]

# native defaults (telemetry.h)
LAT_BUCKETS = 24
LAT_BASE_LOG2 = 10
SIZE_BUCKETS = 20
SIZE_BASE_LOG2 = 6


class SchemaError(ValueError):
    """A telemetry artifact does not match the documented schema."""


def log2_bucket(value, base_log2, nbuckets):
    """The native ``tel::log2_bucket``, bit for bit: bucket i covers
    [2^(base+i), 2^(base+i+1)), everything below the base lands in
    bucket 0, everything at or above the top in the last bucket."""
    v = int(value) >> base_log2
    if v == 0:
        return 0
    b = 0
    while v > 1 and b < nbuckets - 1:
        v >>= 1
        b += 1
    return b


class Histogram:
    """Fixed log2-bucket histogram with quantile estimation."""

    def __init__(self, base_log2, nbuckets, counts=None):
        self.base_log2 = int(base_log2)
        self.counts = list(counts) if counts is not None else [0] * nbuckets
        if counts is not None and len(self.counts) != nbuckets:
            raise SchemaError(
                f"histogram has {len(self.counts)} buckets, want {nbuckets}"
            )

    @property
    def total(self):
        return sum(self.counts)

    def add(self, value):
        self.counts[
            log2_bucket(value, self.base_log2, len(self.counts))
        ] += 1

    def merge(self, other):
        if (other.base_log2 != self.base_log2
                or len(other.counts) != len(self.counts)):
            raise SchemaError("cannot merge histograms of different shape")
        for i, c in enumerate(other.counts):
            self.counts[i] += c

    def bucket_bounds(self, i):
        lo = 1 << (self.base_log2 + i)
        hi = 1 << (self.base_log2 + i + 1)
        if i == 0:
            lo = 0
        return lo, hi

    def quantile(self, q):
        """Estimated value at quantile ``q`` in [0, 1], or ``None`` when
        empty: the geometric midpoint of the crossing bucket."""
        total = self.total
        if total == 0:
            return None
        want = q * total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= want and c:
                lo, hi = self.bucket_bounds(i)
                return ((max(lo, 1)) * hi) ** 0.5
        return None  # unreachable with total > 0
