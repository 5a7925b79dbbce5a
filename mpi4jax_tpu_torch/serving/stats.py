"""Serving gauges: the exporter/t4j-top surface (docs/serving.md).

:class:`ServingStats` accumulates the engine's request accounting and
latency histogram; :func:`publish` installs the current snapshot in a
module global the live exporter (:func:`telemetry.exporter.
collect_snapshot`) folds into every scrape as the ``serving`` block —
queue depth, batch occupancy, shed count, p50/p99 vs SLO — so
``t4j-top`` and the launcher job view show the serving loop next to
the transport gauges it feeds on.

Latency percentiles reuse :class:`telemetry.registry.Histogram` (the
same clamped-geometric-midpoint estimate as every other p50/p99 in the
repo — one percentile convention, docs/observability.md).

The port's copy of ``mpi4jax_tpu/serving/stats.py``.  The live exporter
and ``t4j-top`` that read :func:`current` come with ROADMAP Queue 1
item 10; until then the snapshot is read by the engine's callers.
"""

from mpi4jax_tpu_torch.telemetry.registry import (
    LAT_BASE_LOG2,
    Histogram,
)

__all__ = ["SERVING_SCHEMA", "LatencyHist", "ServingStats", "current",
           "publish"]

SERVING_SCHEMA = "t4j-serving-v1"

# The native metrics table's 24 log2 buckets top out at ~8.6 s — right
# for op latencies, far too small for END-TO-END request latencies
# (an overloaded baseline's drained tail reaches minutes, and a
# saturated top bucket would report a ~12 s p99 for ANY blowup —
# flattering exactly the run the measurement exists to expose).  40
# buckets reach ~2^(10+39) ns ≈ 6 days.
LAT_E2E_BUCKETS = 40

_state = {"snapshot": None}


class LatencyHist:
    """Millisecond latencies over the repo-standard log2 ns bucketing
    (``registry.log2_bucket``), widened to end-to-end range, with the
    same clamp-to-observed-min/max convention as ``registry.Row``."""

    def __init__(self):
        self.hist = Histogram(LAT_BASE_LOG2, LAT_E2E_BUCKETS)
        self.count = 0
        self.min_ns = None
        self.max_ns = None

    def record(self, ms):
        ns = max(0, int(float(ms) * 1e6))
        self.hist.add(ns)
        self.count += 1
        self.min_ns = ns if self.min_ns is None else min(self.min_ns, ns)
        self.max_ns = ns if self.max_ns is None else max(self.max_ns, ns)

    def percentile_ms(self, q):
        v = self.hist.quantile(q)
        if v is None:
            return None
        v = min(max(v, self.min_ns), self.max_ns)
        return v / 1e6


def publish(snapshot):
    """Install ``snapshot`` (a :meth:`ServingStats.snapshot` dict, or
    ``None`` to clear) for the exporter to pick up."""
    _state["snapshot"] = snapshot


def current():
    """The last published serving snapshot, or ``None`` when no engine
    ever ran in this process.  A stopped engine's final snapshot stays
    published with ``"stopped": True`` — exit-time rank files and
    post-mortems want the last gauges, and live scrapers can tell a
    stopped engine from a running one by the flag."""
    return _state["snapshot"]


class ServingStats:
    """Request accounting + latency histogram for one engine.

    ``observe_*`` calls come from the engine/scheduler as requests
    move; :meth:`snapshot` renders the gauge dict.  ``slo_ms=0``
    means no SLO (attainment reported against completion only).
    """

    def __init__(self, slo_ms=0.0, max_batch=1, admit_mode="off"):
        self.slo_ms = float(slo_ms)
        self.max_batch = int(max_batch)
        self.admit_mode = str(admit_mode)
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.shed_by_reason = {}
        self.slo_ok = 0
        self.latency = LatencyHist()
        self.first_token = LatencyHist()
        self.queue_depth = 0
        self.occupancy = 0
        self.steps = 0
        # elastic epoch survival: reissued in-flight requests and the
        # number of resize epochs this engine rode out.
        self.reissued = 0
        self.epochs_survived = 0
        self.autoscale_state = None  # autoscaler state string, or None

    # ---- engine feed -----------------------------------------------------

    def observe_submitted(self):
        self.submitted += 1

    def observe_shed(self, reason):
        self.shed += 1
        key = str(reason)
        self.shed_by_reason[key] = self.shed_by_reason.get(key, 0) + 1

    def observe_completed(self, req):
        self.completed += 1
        lat = req.latency_ms()
        if lat is not None:
            self.latency.record(lat)
        if req.first_token_ms is not None:
            self.first_token.record(req.first_token_ms - req.arrival_ms)
        if req.within_slo():
            self.slo_ok += 1

    def observe_step(self, queue_depth, occupancy):
        self.steps += 1
        self.queue_depth = int(queue_depth)
        self.occupancy = int(occupancy)

    def observe_reissued(self, n):
        """``n`` in-flight requests went back to the queue after a
        resize wiped their slot state (docs/failure-semantics.md)."""
        self.reissued += int(n)

    def observe_epoch(self):
        """The engine survived one resize epoch."""
        self.epochs_survived += 1

    # ---- gauges ----------------------------------------------------------

    def slo_attainment(self):
        """Goodput fraction: requests finished WITHIN the SLO over all
        requests OFFERED (completed + shed) — sheds count against
        attainment; a controller that shed everything would score 0,
        not 1 (docs/serving.md "honest accounting")."""
        offered = self.completed + self.shed
        if offered == 0:
            return None
        return self.slo_ok / offered

    @staticmethod
    def _wire_dtype():
        """The effective compressed-collective wire dtype the engine's
        decode/prefill allreduces run under (docs/performance.md
        "Compressed collectives").  The knob is global — it opts in via
        the tuning broadcast at bridge init, not per engine — but the
        serving snapshot surfaces it because a latency regression that
        is really a fleet-wide knob change should be visible from the
        serving gauges alone.  ``"off"`` outside a native job (the
        bridge's library never loaded)."""
        from mpi4jax_tpu_torch.native import runtime

        info = runtime.wire_dtype_info()
        if info:
            return info.get("wire_dtype", "off")
        return "off"

    def snapshot(self):
        p = [self.latency.percentile_ms(q) for q in (0.50, 0.99)]
        ft = [self.first_token.percentile_ms(q) for q in (0.50, 0.99)]
        return {
            "schema": SERVING_SCHEMA,
            "admit_mode": self.admit_mode,
            "wire_dtype": self._wire_dtype(),
            "slo_ms": self.slo_ms or None,
            "max_batch": self.max_batch,
            "queue_depth": self.queue_depth,
            "batch_occupancy": self.occupancy,
            "steps": self.steps,
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "reissued": self.reissued,
            "epochs_survived": self.epochs_survived,
            "autoscale_state": self.autoscale_state,
            "shed_by_reason": dict(self.shed_by_reason),
            "slo_ok": self.slo_ok,
            "slo_attainment": self.slo_attainment(),
            "latency_p50_ms": p[0],
            "latency_p99_ms": p[1],
            "first_token_p50_ms": ft[0],
            "first_token_p99_ms": ft[1],
        }
