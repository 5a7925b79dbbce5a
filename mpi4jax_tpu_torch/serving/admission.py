"""Deadline-aware admission control (docs/serving.md).

The port's copy of ``mpi4jax_tpu/serving/admission.py``.

Three composable pieces, all pure and time-injected:

* :class:`TokenBucket` — the classic rate limiter: sustained
  ``rate_per_s`` with a ``burst`` allowance.  The coarse front door.
* :class:`SLOEstimator` — EWMA service-time model fed by the engine's
  measured step/prefill times (in the JAX package sourced from
  the metrics-table latency histograms when telemetry is on), multiplied
  by a fabric :func:`degradation_factor` read off the live exporter's
  job view: a repairing link or a lagging straggler slows every
  decode step, so predicted completions stretch BEFORE the p99 shows
  it.
* :class:`AdmissionController` — the decision: admit, or shed with a
  named reason.  ``mode="off"`` admits everything (the uncontrolled
  baseline every benchmark arm compares against); ``mode="on"`` sheds
  when the bucket is dry or when the predicted completion blows the
  request's deadline.  Sheds are returned to the caller, never
  swallowed — the shed rate is a first-class metric.
"""

__all__ = [
    "AdmissionController",
    "SLOEstimator",
    "TokenBucket",
    "degradation_factor",
]


class TokenBucket:
    """Sustained-rate limiter: ``burst`` tokens capacity, refilled at
    ``rate_per_s``.  ``rate_per_s=0`` disables the bucket (always
    allows) — the SLO gate is then the only control."""

    def __init__(self, rate_per_s, burst):
        if rate_per_s < 0:
            raise ValueError(f"rate_per_s must be >= 0, got {rate_per_s}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last_ms = None

    def allow(self, now_ms):
        """Consume one token if available; refills lazily."""
        if self.rate == 0:
            return True
        now_ms = float(now_ms)
        if self._last_ms is not None:
            elapsed_s = max(0.0, (now_ms - self._last_ms) / 1e3)
            self._tokens = min(
                self.burst, self._tokens + elapsed_s * self.rate
            )
        self._last_ms = now_ms
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


class SLOEstimator:
    """EWMA service-time model for the continuous-batching engine.

    The engine reports what it measures: ``observe_step(ms)`` after
    each decode step (one token for every active slot) and
    ``observe_prefill(ms, prompt_len)`` after each prefill.  The
    estimator keeps EWMAs (``alpha`` weighting the newest sample) and
    predicts a queued request's completion as

        queue_wait + prefill(p_len) + (new_tokens - 1) · step · degr

    where ``queue_wait`` models the slot it must wait for: with
    ``queue_ahead`` requests already queued and ``max_batch`` slots,
    roughly ``(queue_ahead / max_batch + occupancy_fraction) ·
    mean_residual_service``.  Deliberately simple and CONSERVATIVE in
    shape — admission needs a stable early-warning signal, not a
    simulator; docs/serving.md discusses the bias."""

    def __init__(self, alpha=0.25, seed_step_ms=50.0,
                 seed_prefill_ms_per_tok=1.0):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.step_ms = float(seed_step_ms)
        self.prefill_ms_per_tok = float(seed_prefill_ms_per_tok)
        self.samples = 0

    def observe_step(self, ms):
        if ms < 0:
            raise ValueError(f"negative step time {ms}")
        self.step_ms += self.alpha * (float(ms) - self.step_ms)
        self.samples += 1

    def observe_prefill(self, ms, prompt_len):
        if prompt_len < 1:
            raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
        per_tok = float(ms) / float(prompt_len)
        self.prefill_ms_per_tok += self.alpha * (
            per_tok - self.prefill_ms_per_tok
        )

    def residual_service_ms(self, active_requests):
        """Mean remaining decode time over the active requests (0 when
        the batch is empty)."""
        reqs = list(active_requests)
        if not reqs:
            return 0.0
        remaining = [
            max(0, r.max_new - r.generated) for r in reqs
        ]
        return (sum(remaining) / len(remaining)) * self.step_ms

    def predict_ms(self, prompt_len, max_new, queue_ahead, occupancy,
                   max_batch, residual_ms=0.0, degradation=1.0):
        """Predicted arrival→completion latency in ms for a request
        arriving NOW with ``queue_ahead`` requests already queued."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        degradation = max(1.0, float(degradation))
        # slot wait: how many "service turns" until a slot frees for
        # THIS request.  Every queued request ahead occupies one turn;
        # a full batch adds the residual of the slot that must drain.
        turns = float(queue_ahead) / float(max_batch)
        wait = turns * max(residual_ms, self.step_ms) * degradation
        if occupancy >= max_batch:
            wait += residual_ms * degradation
        prefill = self.prefill_ms_per_tok * float(prompt_len)
        decode = max(0, int(max_new) - 1) * self.step_ms * degradation
        return wait + prefill + decode


def degradation_factor(job_view, reconnect_penalty=0.5,
                       repairing_penalty=1.0):
    """Fabric health → service-time multiplier (>= 1.0), from the live
    exporter's job aggregate (:func:`telemetry.exporter.
    aggregate_snapshots`: the straggler/worst-link gauges).

    * a worst link in the broken/repairing state (``state == 1``)
      means decode collectives are stalling on replay: +
      ``repairing_penalty``;
    * accumulated reconnects on the worst link mean a flaky path that
      will stall again: + ``reconnect_penalty`` once any exist;
    * a missing/empty view degrades to 1.0 — no telemetry is no
      evidence, and admission must not shed on absence of data.

    Returns ``(factor, reasons)`` with ``reasons`` a tuple of short
    strings naming what contributed (the shed log prints them)."""
    if not job_view:
        return 1.0, ()
    factor = 1.0
    reasons = []
    worst = job_view.get("worst_link") or {}
    state = int(worst.get("state") or 0)
    if state >= 1:
        factor += float(repairing_penalty)
        reasons.append(
            f"worst link r{worst.get('rank')}–r{worst.get('peer')} "
            f"state={state}"
        )
    if int(worst.get("reconnects") or 0) > 0:
        factor += float(reconnect_penalty)
        reasons.append(
            f"worst link saw {worst['reconnects']} reconnect(s)"
        )
    return factor, tuple(reasons)


class AdmissionController:
    """The admit/shed decision (docs/serving.md "admission control").

    ``mode`` is validated ``"off"`` | ``"on"`` (utils/config.py
    ``admit_mode``).  ``slo_ms`` stamps every admitted request's
    deadline; with ``mode="on"`` a predicted completion past the
    deadline (x ``headroom``) sheds at the door, and
    :meth:`reconsider_queued` sheds queued requests whose deadline
    became hopeless as the estimator learned — both paths count
    honestly through the scheduler.
    """

    SHED_BUCKET = "token-bucket"
    SHED_PREDICTED = "predicted-miss"
    SHED_HOPELESS = "deadline-hopeless"

    def __init__(self, mode, slo_ms=0.0, estimator=None, bucket=None,
                 headroom=1.0):
        if mode not in ("off", "on"):
            raise ValueError(
                f"admission mode must be 'off' or 'on', got {mode!r}"
            )
        if mode == "off" and slo_ms:
            # mirrors the ensure_initialized rejection: an SLO with
            # admission off cannot be enforced, only missed
            raise ValueError(
                "slo_ms set with admission mode 'off' — nothing would "
                "enforce it (set mode='on' or drop the SLO)"
            )
        if slo_ms < 0:
            raise ValueError(f"slo_ms must be >= 0, got {slo_ms}")
        if headroom <= 0:
            raise ValueError(f"headroom must be > 0, got {headroom}")
        self.mode = mode
        self.slo_ms = float(slo_ms)
        self.estimator = estimator or SLOEstimator()
        self.bucket = bucket
        self.headroom = float(headroom)
        self.degradation = 1.0
        self.degradation_reasons = ()

    def observe_fabric(self, job_view):
        """Feed the latest exporter job view (straggler / worst-link
        gauges) into the service-time model."""
        self.degradation, self.degradation_reasons = degradation_factor(
            job_view
        )

    def deadline_for(self, arrival_ms):
        if not self.slo_ms:
            return None
        return float(arrival_ms) + self.slo_ms

    def decide(self, req, now_ms, scheduler):
        """``(verdict, reason)``: verdict ``"admit"`` or ``"shed"``.
        The caller routes an admitted request to
        ``scheduler.submit`` and a shed one to
        ``scheduler.shed_request`` — decisions and effects stay
        separated so tests can probe decisions alone."""
        if self.mode == "off":
            return "admit", None
        if self.bucket is not None and not self.bucket.allow(now_ms):
            return "shed", self.SHED_BUCKET
        if self.slo_ms and req.deadline_ms is not None:
            est = self.estimator
            predicted = est.predict_ms(
                req.prompt_len, req.max_new,
                queue_ahead=scheduler.queue_depth(),
                occupancy=scheduler.occupancy(),
                max_batch=scheduler.max_batch,
                residual_ms=est.residual_service_ms(
                    scheduler.active_requests()
                ),
                degradation=self.degradation,
            )
            if now_ms + predicted * self.headroom > req.deadline_ms:
                return "shed", self.SHED_PREDICTED
        return "admit", None

    def reconsider_queued(self, now_ms, scheduler):
        """Shed queued requests whose deadline can no longer be met
        even if a slot freed right now (their queue wait already ate
        the budget).  Returns the shed requests."""
        if self.mode == "off" or not self.slo_ms:
            return []
        est = self.estimator
        victims = []
        for req in scheduler.queued():
            if req.deadline_ms is None:
                continue
            floor = (
                est.prefill_ms_per_tok * req.prompt_len
                + max(0, req.max_new - 1) * est.step_ms
                * self.degradation
            )
            if now_ms + floor > req.deadline_ms:
                victims.append(req)
        for req in victims:
            scheduler.shed_request(req, now_ms, self.SHED_HOPELESS)
        return victims
