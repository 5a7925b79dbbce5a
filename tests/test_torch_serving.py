"""The port's serving pure core (``mpi4jax_tpu_torch/serving/``) held to
the JAX package's.

* Every case of ``tests/test_serving.py``, with the same assertions, run
  against the port's modules: request lifecycle, slot scheduler,
  follower mirror, plan codec, token bucket, SLO estimator, fabric
  degradation, admission controller, load generator, stats and the
  pure closed loop.
* Parity on seeded traffic: the same ``LoadGen`` stream, the same
  ``SlotScheduler`` plans and ``encode_plan`` words over the 300-step
  closed loop, the same admission verdicts and the same
  ``ServingStats.snapshot()`` as the JAX package's pure modules (loaded
  as ``tests/test_serving.py`` loads them).
* The serving knobs (``T4J_SLO_MS``, ``T4J_MAX_BATCH``, ``T4J_ADMIT``)
  and ``ensure_initialized``'s refusals, as ``tests/test_config_
  tuning.py`` holds the JAX package's.
"""

import importlib
import pathlib
import random
import sys
import types

import pytest

from mpi4jax_tpu_torch.native import build as tbuild
from mpi4jax_tpu_torch.native import runtime as truntime
from mpi4jax_tpu_torch.serving import admission, loadgen
from mpi4jax_tpu_torch.serving import plan as plan_mod
from mpi4jax_tpu_torch.serving import request, scheduler
from mpi4jax_tpu_torch.serving import stats as stats_mod
from mpi4jax_tpu_torch.utils import config

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load_jax_serving():
    """The JAX package's pure serving core, as tests/test_serving.py
    loads it (a package stub where ``import mpi4jax_tpu`` fails)."""
    try:
        import mpi4jax_tpu.serving as serving

        return serving
    except Exception:
        stubbed = "mpi4jax_tpu" not in sys.modules
        if stubbed:
            stub = types.ModuleType("mpi4jax_tpu")
            stub.__path__ = [str(REPO / "mpi4jax_tpu")]
            sys.modules["mpi4jax_tpu"] = stub
        try:
            return importlib.import_module("mpi4jax_tpu.serving")
        finally:
            if stubbed:
                sys.modules.pop("mpi4jax_tpu", None)


jserving = _load_jax_serving()
J = {name: importlib.import_module(f"{jserving.__name__}.{name}")
     for name in ("admission", "loadgen", "plan", "request", "scheduler",
                  "stats")}
T = {"admission": admission, "loadgen": loadgen, "plan": plan_mod,
     "request": request, "scheduler": scheduler, "stats": stats_mod}

Request = request.Request
RequestState = request.RequestState
SlotScheduler = scheduler.SlotScheduler
FollowerMirror = scheduler.FollowerMirror
SchedulerError = scheduler.SchedulerError


def _req(rid=0, p_len=4, max_new=4, arrival=0.0, deadline=None):
    return Request(rid, tuple(range(1, p_len + 1)), max_new, arrival,
                   deadline_ms=deadline)


# ---- request lifecycle ---------------------------------------------------


class TestRequest:
    def test_validation(self):
        with pytest.raises(ValueError, match="max_new"):
            Request(0, (1, 2), 0, 0.0)
        with pytest.raises(ValueError, match="empty prompt"):
            Request(0, (), 3, 0.0)

    def test_latency_none_in_flight(self):
        r = _req()
        assert r.latency_ms() is None
        r.done_ms = 50.0
        assert r.latency_ms() == 50.0

    def test_within_slo_requires_completion(self):
        r = _req(deadline=100.0)
        assert not r.within_slo()  # still queued
        r.state = RequestState.DONE
        r.done_ms = 80.0
        assert r.within_slo()
        r.done_ms = 120.0
        assert not r.within_slo()

    def test_no_deadline_completion_is_within(self):
        r = _req()
        r.state = RequestState.DONE
        r.done_ms = 9999.0
        assert r.within_slo()

    def test_shed_never_within_slo(self):
        r = _req(deadline=1e9)
        r.state = RequestState.SHED
        r.done_ms = 1.0
        assert not r.within_slo()


# ---- slot scheduler ------------------------------------------------------


class TestSlotScheduler:
    def test_admits_fifo_into_free_slots(self):
        s = SlotScheduler(max_batch=2, max_len=16,
                          max_prefill_per_step=2)
        a, b, c = _req(0), _req(1), _req(2)
        for r in (a, b, c):
            s.submit(r, 0.0)
        plan = s.plan_step(0.0)
        assert [(sl, r.rid) for sl, r in plan.admissions] == [
            (0, 0), (1, 1)
        ]
        assert s.queue_depth() == 1
        assert s.occupancy() == 2
        assert a.state == RequestState.ADMITTED

    def test_prefill_per_step_bound(self):
        s = SlotScheduler(max_batch=4, max_len=16)
        for i in range(3):
            s.submit(_req(i), 0.0)
        plan = s.plan_step(0.0)
        assert len(plan.admissions) == 1  # default bound = 1

    def test_decode_joins_after_prefill(self):
        s = SlotScheduler(max_batch=2, max_len=16)
        s.submit(_req(0, p_len=4, max_new=3), 0.0)
        p0 = s.plan_step(0.0)
        assert p0.decode_slots == []
        s.prefill_done(0, 0.0)
        s.step_done(p0, 0.0)
        p1 = s.plan_step(1.0)
        assert p1.decode_slots == [0]
        assert p1.positions == [4]  # next write pos = prompt_len

    def test_completion_after_max_new(self):
        s = SlotScheduler(max_batch=1, max_len=32)
        r = _req(0, p_len=4, max_new=3)
        s.submit(r, 0.0)
        p = s.plan_step(0.0)
        s.prefill_done(0, 0.0)  # token 1
        s.step_done(p, 0.0)
        for _ in range(2):  # tokens 2, 3
            p = s.plan_step(0.0)
            s.step_done(p, 0.0)
        assert r.state == RequestState.DONE
        assert r.generated == 3
        assert s.finished == [r]
        assert s.occupancy() == 0

    def test_budget_clamps_generation(self):
        s = SlotScheduler(max_batch=1, max_len=8)
        r = _req(0, p_len=6, max_new=50)
        s.submit(r, 0.0)
        p = s.plan_step(0.0)
        s.prefill_done(0, 0.0)
        s.step_done(p, 0.0)
        p = s.plan_step(0.0)
        s.step_done(p, 0.0)
        # positions 6..7 exist; prefill emits idx 6, one decode emits 7
        assert r.state == RequestState.DONE
        assert r.generated == 2

    def test_prompt_filling_budget_completes_at_prefill(self):
        s = SlotScheduler(max_batch=1, max_len=8)
        r = _req(0, p_len=7, max_new=5)
        s.submit(r, 0.0)
        s.plan_step(0.0)
        s.prefill_done(0, 0.0)
        assert r.state == RequestState.DONE
        assert r.generated == 1

    def test_oversized_prompt_rejected(self):
        s = SlotScheduler(max_batch=1, max_len=8)
        with pytest.raises(SchedulerError, match="no room"):
            s.submit(_req(0, p_len=8), 0.0)

    def test_freed_slot_reusable_next_plan(self):
        s = SlotScheduler(max_batch=1, max_len=16)
        s.submit(_req(0, p_len=4, max_new=1), 0.0)
        s.plan_step(0.0)
        s.prefill_done(0, 0.0)  # completes instantly (max_new=1)
        s.submit(_req(1), 1.0)
        p = s.plan_step(1.0)
        assert [(sl, r.rid) for sl, r in p.admissions] == [(0, 1)]

    def test_shed_queued(self):
        s = SlotScheduler(max_batch=1, max_len=16)
        r = _req(0)
        s.submit(r, 0.0)
        s.shed_request(r, 1.0, "test-reason")
        assert r.state == RequestState.SHED
        assert r.shed_reason == "test-reason"
        assert s.shed == 1
        assert s.queue_depth() == 0
        s.check_accounting()

    def test_shed_at_door_counts(self):
        s = SlotScheduler(max_batch=1, max_len=16)
        r = _req(0)
        s.shed_request(r, 0.0, "bucket")  # never submitted
        assert s.submitted == 1 and s.shed == 1
        s.check_accounting()

    def test_shed_active_raises(self):
        s = SlotScheduler(max_batch=1, max_len=16)
        r = _req(0)
        s.submit(r, 0.0)
        s.plan_step(0.0)
        with pytest.raises(SchedulerError, match="completion"):
            s.shed_request(r, 0.0, "late")

    def test_accounting_leak_detected(self):
        s = SlotScheduler(max_batch=1, max_len=16)
        s.submit(_req(0), 0.0)
        s.submitted += 1  # corrupt the books
        with pytest.raises(SchedulerError, match="request leak"):
            s.check_accounting()

    def test_step_done_on_free_slot_raises(self):
        s = SlotScheduler(max_batch=2, max_len=16)
        s.submit(_req(0), 0.0)
        p = s.plan_step(0.0)
        s.prefill_done(0, 0.0)
        p2 = s.plan_step(0.0)
        s.step_done(p2, 0.0)
        fake = scheduler.StepPlan(99, [], [1], [4])
        with pytest.raises(SchedulerError, match="free"):
            s.step_done(fake, 0.0)

    def test_validation(self):
        with pytest.raises(ValueError, match="max_batch"):
            SlotScheduler(0, 16)
        with pytest.raises(ValueError, match="max_len"):
            SlotScheduler(1, 1)


# ---- follower mirror + digest -------------------------------------------


class TestFollowerMirror:
    def _drive(self, steps=12, max_batch=2, max_len=16):
        """Leader and mirror side by side: every plan's pre-state
        digest must agree, every applied plan must keep them agreeing."""
        leader = SlotScheduler(max_batch, max_len,
                               max_prefill_per_step=2)
        mirror = FollowerMirror(max_batch, max_len)
        rid = 0
        for i in range(steps):
            if i % 3 == 0:
                leader.submit(_req(rid, p_len=3 + rid % 4,
                                   max_new=1 + rid % 5), float(i))
                rid += 1
            digest = leader.state_digest()
            assert digest == mirror.state_digest(), f"drift at step {i}"
            plan = leader.plan_step(float(i))
            vec = plan_mod.encode_plan(plan, max_batch, max_len, digest)
            decoded = plan_mod.decode_plan(
                vec, max_batch, max_len,
                expect_digest=mirror.state_digest(),
            )
            admitted, _fin = mirror.apply(decoded)
            for slot, _req2 in plan.admissions:
                leader.prefill_done(slot, float(i))
            for slot, _r, _p, _m in admitted:
                mirror.prefill_done(slot)
            leader.step_done(plan, float(i))
        return leader, mirror

    def test_stays_in_lockstep(self):
        leader, mirror = self._drive()
        assert leader.state_digest() == mirror.state_digest()
        assert mirror.completed == leader.completed

    def test_drift_raises_plan_error(self):
        leader = SlotScheduler(2, 16)
        mirror = FollowerMirror(2, 16)
        leader.submit(_req(0), 0.0)
        digest = leader.state_digest()
        plan = leader.plan_step(0.0)
        vec = plan_mod.encode_plan(plan, 2, 16, digest)
        decoded = plan_mod.decode_plan(vec, 2, 16,
                                       expect_digest=digest)
        mirror.apply(decoded)
        # replaying the same admission plan = follower drift
        with pytest.raises(plan_mod.PlanError, match="diverged"):
            plan_mod.decode_plan(vec, 2, 16,
                                 expect_digest=mirror.state_digest())

    def test_decode_pos_mismatch_raises(self):
        mirror = FollowerMirror(2, 16)
        decoded = {
            "step": 0, "stop": False, "admissions": [], "prompts": [],
            "decode_slots": [0], "positions": [4],
        }
        with pytest.raises(SchedulerError, match="mirror has"):
            mirror.apply(decoded)


# ---- plan codec ----------------------------------------------------------


class TestPlanCodec:
    def test_roundtrip_with_prompts(self):
        s = SlotScheduler(3, 16, max_prefill_per_step=2)
        s.submit(_req(7, p_len=5, max_new=4, deadline=1234.0), 0.0)
        s.submit(_req(8, p_len=2, max_new=9), 0.0)
        digest = s.state_digest()
        plan = s.plan_step(0.0)
        vec = plan_mod.encode_plan(plan, 3, 16, digest)
        assert len(vec) == plan_mod.plan_words(3, 16)
        d = plan_mod.decode_plan(vec, 3, 16, expect_digest=digest)
        assert d["step"] == plan.step
        assert not d["stop"]
        assert d["admissions"] == [
            (0, 7, 5, 4, 1234.0), (1, 8, 2, 9, None)
        ]
        assert d["prompts"] == [(1, 2, 3, 4, 5), (1, 2)]

    def test_stop_flag(self):
        plan = scheduler.StepPlan(3, [], [], [])
        vec = plan_mod.encode_plan(plan, 2, 8, 0, stop=True)
        assert plan_mod.decode_plan(vec, 2, 8)["stop"]

    def test_bad_magic(self):
        vec = [0] * plan_mod.plan_words(2, 8)
        with pytest.raises(plan_mod.PlanError, match="magic"):
            plan_mod.decode_plan(vec, 2, 8)

    def test_truncated_vector(self):
        with pytest.raises(plan_mod.PlanError, match="words"):
            plan_mod.decode_plan([plan_mod.MAGIC, 0, 0], 2, 8)

    def test_counts_out_of_range(self):
        vec = [plan_mod.MAGIC, 0, 0, 99, 0, 0] + [0] * (
            plan_mod.plan_words(2, 8) - 6
        )
        with pytest.raises(plan_mod.PlanError, match="out of range"):
            plan_mod.decode_plan(vec, 2, 8)

    def test_prompt_over_p_max_rejected(self):
        plan = scheduler.StepPlan(
            0, [(0, _req(0, p_len=9))], [], []
        )
        with pytest.raises(plan_mod.PlanError, match="p_max"):
            plan_mod.encode_plan(plan, 2, 8, 0)

    def test_digest_check_optional(self):
        plan = scheduler.StepPlan(0, [], [], [])
        vec = plan_mod.encode_plan(plan, 2, 8, 42)
        d = plan_mod.decode_plan(vec, 2, 8)  # no expect_digest
        assert d["digest"] == 42


# ---- token bucket --------------------------------------------------------


class TestTokenBucket:
    def test_burst_then_dry(self):
        b = admission.TokenBucket(rate_per_s=10, burst=3)
        assert [b.allow(0.0) for _ in range(4)] == [
            True, True, True, False
        ]

    def test_refills_at_rate(self):
        b = admission.TokenBucket(rate_per_s=10, burst=1)
        assert b.allow(0.0)
        assert not b.allow(50.0)   # 0.5 token accrued
        assert b.allow(150.0)      # >= 1 token accrued

    def test_rate_zero_always_allows(self):
        b = admission.TokenBucket(0, 1)
        assert all(b.allow(t) for t in range(100))

    def test_validation(self):
        with pytest.raises(ValueError):
            admission.TokenBucket(-1, 1)
        with pytest.raises(ValueError):
            admission.TokenBucket(1, 0)


# ---- SLO estimator -------------------------------------------------------


class TestSLOEstimator:
    def test_ewma_converges(self):
        e = admission.SLOEstimator(alpha=0.5, seed_step_ms=100.0)
        for _ in range(20):
            e.observe_step(10.0)
        assert abs(e.step_ms - 10.0) < 0.1

    def test_prefill_per_token(self):
        e = admission.SLOEstimator(alpha=1.0)
        e.observe_prefill(50.0, prompt_len=10)
        assert e.prefill_ms_per_tok == pytest.approx(5.0)

    def test_predict_monotonic_in_queue(self):
        e = admission.SLOEstimator(seed_step_ms=10.0)
        args = dict(prompt_len=8, max_new=8, occupancy=2, max_batch=4,
                    residual_ms=40.0)
        a = e.predict_ms(queue_ahead=0, **args)
        b = e.predict_ms(queue_ahead=6, **args)
        assert b > a

    def test_predict_scales_with_degradation(self):
        e = admission.SLOEstimator(seed_step_ms=10.0)
        args = dict(prompt_len=8, max_new=8, queue_ahead=2,
                    occupancy=4, max_batch=4, residual_ms=40.0)
        assert (e.predict_ms(degradation=3.0, **args)
                > e.predict_ms(degradation=1.0, **args))

    def test_residual_service(self):
        e = admission.SLOEstimator(seed_step_ms=10.0)
        reqs = [_req(0, max_new=10), _req(1, max_new=2)]
        reqs[0].generated = 4
        reqs[1].generated = 1
        # mean remaining = (6 + 1)/2 tokens * 10 ms
        assert e.residual_service_ms(reqs) == pytest.approx(35.0)
        assert e.residual_service_ms([]) == 0.0


# ---- fabric degradation --------------------------------------------------


class TestDegradationFactor:
    def test_empty_view_is_neutral(self):
        assert admission.degradation_factor(None) == (1.0, ())
        assert admission.degradation_factor({}) == (1.0, ())

    def test_repairing_link_penalised(self):
        f, reasons = admission.degradation_factor(
            {"worst_link": {"state": 1, "rank": 0, "peer": 3,
                            "reconnects": 0}}
        )
        assert f == pytest.approx(2.0)
        assert any("state=1" in r for r in reasons)

    def test_reconnects_penalised(self):
        f, reasons = admission.degradation_factor(
            {"worst_link": {"state": 0, "reconnects": 4}}
        )
        assert f == pytest.approx(1.5)
        assert any("4 reconnect" in r for r in reasons)

    def test_both_stack(self):
        f, _ = admission.degradation_factor(
            {"worst_link": {"state": 2, "reconnects": 9}}
        )
        assert f == pytest.approx(2.5)


# ---- admission controller ------------------------------------------------


class TestAdmissionController:
    def test_off_admits_everything(self):
        c = admission.AdmissionController("off")
        s = SlotScheduler(1, 16)
        for i in range(50):
            v, reason = c.decide(_req(i), 0.0, s)
            assert v == "admit" and reason is None

    def test_off_with_slo_rejected(self):
        with pytest.raises(ValueError, match="admission mode 'off'"):
            admission.AdmissionController("off", slo_ms=100.0)

    def test_bad_mode_rejected(self):
        with pytest.raises(ValueError, match="'off' or 'on'"):
            admission.AdmissionController("auto")

    def test_bucket_shed(self):
        c = admission.AdmissionController(
            "on", bucket=admission.TokenBucket(1, 1)
        )
        s = SlotScheduler(1, 16)
        assert c.decide(_req(0), 0.0, s)[0] == "admit"
        v, reason = c.decide(_req(1), 0.0, s)
        assert v == "shed" and reason == c.SHED_BUCKET

    def test_predicted_miss_shed(self):
        est = admission.SLOEstimator(seed_step_ms=100.0)
        c = admission.AdmissionController("on", slo_ms=200.0,
                                          estimator=est)
        s = SlotScheduler(1, 16)
        # 8 tokens x 100 ms/step >> 200 ms deadline
        r = _req(0, max_new=8, deadline=200.0)
        v, reason = c.decide(r, 0.0, s)
        assert v == "shed" and reason == c.SHED_PREDICTED

    def test_fast_service_admits_under_slo(self):
        est = admission.SLOEstimator(seed_step_ms=1.0,
                                     seed_prefill_ms_per_tok=0.1)
        c = admission.AdmissionController("on", slo_ms=500.0,
                                          estimator=est)
        s = SlotScheduler(4, 16)
        assert c.decide(_req(0, deadline=500.0), 0.0, s)[0] == "admit"

    def test_degradation_tips_the_decision(self):
        est = admission.SLOEstimator(seed_step_ms=20.0,
                                     seed_prefill_ms_per_tok=0.1)
        c = admission.AdmissionController("on", slo_ms=200.0,
                                          estimator=est)
        s = SlotScheduler(4, 16)
        r = _req(0, max_new=8, deadline=200.0)
        assert c.decide(r, 0.0, s)[0] == "admit"
        c.observe_fabric(
            {"worst_link": {"state": 1, "reconnects": 3}}
        )
        r2 = _req(1, max_new=8, deadline=200.0)
        assert c.decide(r2, 0.0, s)[0] == "shed"

    def test_reconsider_sheds_hopeless_queued(self):
        est = admission.SLOEstimator(seed_step_ms=1.0,
                                     seed_prefill_ms_per_tok=0.1)
        c = admission.AdmissionController("on", slo_ms=100.0,
                                          estimator=est)
        s = SlotScheduler(1, 16)
        r = _req(0, max_new=8, deadline=100.0)
        s.submit(r, 0.0)
        assert c.reconsider_queued(0.0, s) == []
        # 99 ms later even a free slot cannot land it inside 100 ms
        victims = c.reconsider_queued(99.0, s)
        assert victims == [r]
        assert r.state == RequestState.SHED
        assert r.shed_reason == c.SHED_HOPELESS
        s.check_accounting()

    def test_reconsider_noop_when_off(self):
        c = admission.AdmissionController("off")
        s = SlotScheduler(1, 16)
        s.submit(_req(0), 0.0)
        assert c.reconsider_queued(1e9, s) == []


# ---- load generator ------------------------------------------------------


class TestLoadGen:
    def test_deterministic(self):
        a = loadgen.LoadGen(seed=5, rate_rps=100)
        b = loadgen.LoadGen(seed=5, rate_rps=100)
        ra, rb = a.take(20), b.take(20)
        assert [r.prompt for r in ra] == [r.prompt for r in rb]
        assert [r.arrival_ms for r in ra] == [r.arrival_ms for r in rb]
        assert [r.max_new for r in ra] == [r.max_new for r in rb]

    def test_poisson_mean_rate(self):
        g = loadgen.LoadGen(seed=1, rate_rps=50)
        reqs = g.take(2000)
        mean_gap = reqs[-1].arrival_ms / len(reqs)
        assert 15 < mean_gap < 25  # 1/50 s = 20 ms +- sampling noise

    def test_until_matches_take(self):
        a = loadgen.LoadGen(seed=9, rate_rps=200)
        b = loadgen.LoadGen(seed=9, rate_rps=200)
        taken = a.take(30)
        horizon = taken[-1].arrival_ms
        got = []
        t = 0.0
        while t < horizon:
            t = min(t + 7.0, horizon)
            got.extend(b.until(t))
        assert [r.rid for r in got] == [r.rid for r in taken]
        assert [r.prompt for r in got] == [r.prompt for r in taken]
        assert [r.arrival_ms for r in got] == [
            r.arrival_ms for r in taken
        ]

    def test_rids_sequential(self):
        g = loadgen.LoadGen(seed=2, rate_rps=10)
        assert [r.rid for r in g.take(5)] == [0, 1, 2, 3, 4]

    def test_prompt_bounds_and_vocab(self):
        g = loadgen.LoadGen(seed=3, rate_rps=10,
                            prompt_len=("uniform", 2, 5), vocab=16)
        for r in g.take(100):
            assert 2 <= r.prompt_len <= 5
            assert all(0 <= t < 16 for t in r.prompt)

    def test_deadline_stamping(self):
        g = loadgen.LoadGen(seed=4, rate_rps=10,
                            deadline_fn=lambda t: t + 500.0)
        r = g.next_request()
        assert r.deadline_ms == pytest.approx(r.arrival_ms + 500.0)

    def test_dist_specs(self):
        rng = __import__("random").Random(0)
        assert loadgen.make_dist(("fixed", 7))(rng) == 7
        lo_hi = {loadgen.make_dist(("bimodal", 2, 9, 0.5))(rng)
                 for _ in range(50)}
        assert lo_hi == {2, 9}
        with pytest.raises(ValueError, match="unknown distribution"):
            loadgen.make_dist(("zipf", 1))
        with pytest.raises(ValueError, match="lo <= hi"):
            loadgen.make_dist(("uniform", 5, 2))
        with pytest.raises(ValueError, match="rate_rps"):
            loadgen.LoadGen(seed=0, rate_rps=0)


# ---- stats / gauges ------------------------------------------------------


class TestServingStats:
    def _completed(self, lat_ms, deadline=None):
        r = _req(0, deadline=deadline)
        r.state = RequestState.DONE
        r.first_token_ms = lat_ms / 2
        r.done_ms = lat_ms
        return r

    def test_slo_attainment_counts_sheds(self):
        s = stats_mod.ServingStats(slo_ms=100.0)
        s.observe_completed(self._completed(50.0, deadline=100.0))
        s.observe_completed(self._completed(150.0, deadline=100.0))
        s.observe_shed("predicted-miss")
        # 1 in-SLO out of 3 offered: sheds count against attainment
        assert s.slo_attainment() == pytest.approx(1 / 3)

    def test_attainment_none_before_traffic(self):
        assert stats_mod.ServingStats().slo_attainment() is None

    def test_percentiles_clamped_to_observed(self):
        s = stats_mod.ServingStats()
        for ms in (10.0, 12.0, 14.0):
            s.observe_completed(self._completed(ms))
        snap = s.snapshot()
        assert 10.0 <= snap["latency_p50_ms"] <= 14.0
        assert 10.0 <= snap["latency_p99_ms"] <= 14.0

    def test_minute_scale_tail_not_flattened(self):
        # the native op-latency histogram tops out at ~8.6 s; the
        # end-to-end histogram must keep resolving far beyond it, or
        # an overloaded baseline's p99 would read ~12 s no matter how
        # badly it blew up
        s = stats_mod.ServingStats()
        for ms in [10_000.0] * 9 + [300_000.0]:
            s.observe_completed(self._completed(ms))
        snap = s.snapshot()
        assert snap["latency_p50_ms"] < 20_000
        assert snap["latency_p99_ms"] > 100_000

    def test_snapshot_schema(self):
        s = stats_mod.ServingStats(slo_ms=250.0, max_batch=4,
                                   admit_mode="on")
        s.observe_step(queue_depth=3, occupancy=2)
        s.observe_shed("token-bucket")
        snap = s.snapshot()
        assert snap["schema"] == stats_mod.SERVING_SCHEMA
        for key in ("queue_depth", "batch_occupancy", "shed",
                    "completed", "submitted", "slo_ms",
                    "slo_attainment", "latency_p50_ms",
                    "latency_p99_ms", "admit_mode", "max_batch"):
            assert key in snap, key
        assert snap["queue_depth"] == 3
        assert snap["batch_occupancy"] == 2
        assert snap["shed_by_reason"] == {"token-bucket": 1}

    def test_publish_current(self):
        stats_mod.publish({"schema": stats_mod.SERVING_SCHEMA})
        assert stats_mod.current() == {
            "schema": stats_mod.SERVING_SCHEMA
        }
        stats_mod.publish(None)
        assert stats_mod.current() is None


# ---- closed loop (pure) --------------------------------------------------


class TestClosedLoop:
    def _run(self, admit, rate, slo=300.0, steps=300, step_ms=5.0):
        gen = loadgen.LoadGen(
            seed=11, rate_rps=rate, prompt_len=("uniform", 2, 6),
            max_new=("uniform", 2, 8), vocab=32,
        )
        sched = SlotScheduler(4, 16)
        est = admission.SLOEstimator(seed_step_ms=step_ms,
                                     seed_prefill_ms_per_tok=0.5)
        ctrl = admission.AdmissionController(
            admit, slo_ms=slo if admit == "on" else 0.0,
            estimator=est,
        )
        stats = stats_mod.ServingStats(slo_ms=slo, max_batch=4,
                                       admit_mode=admit)
        gen.deadline_fn = lambda t: t + slo
        now = 0.0
        for _ in range(steps):
            now += step_ms
            for req in gen.until(now):
                stats.observe_submitted()
                v, reason = ctrl.decide(req, now, sched)
                if v == "admit":
                    sched.submit(req, now)
                else:
                    sched.shed_request(req, now, reason)
                    stats.observe_shed(reason)
            for r in ctrl.reconsider_queued(now, sched):
                stats.observe_shed(r.shed_reason)
            plan = sched.plan_step(now)
            for slot, req in plan.admissions:
                est.observe_prefill(step_ms / 2, req.prompt_len)
                sched.prefill_done(slot, now)
            if plan.decode_slots:
                est.observe_step(step_ms)
            sched.step_done(plan, now)
            for r in sched.finished:
                stats.observe_completed(r)
            sched.finished.clear()
            stats.observe_step(sched.queue_depth(), sched.occupancy())
        sched.check_accounting()
        return sched, stats

    def test_overload_with_admission_sheds_and_balances(self):
        sched, stats = self._run("on", rate=400)
        snap = stats.snapshot()
        assert snap["shed"] > 0
        assert snap["completed"] > 0
        # honest books: offered = completed + shed + still in system
        assert (sched.submitted
                == sched.completed + sched.shed
                + sched.queue_depth() + sched.occupancy())

    def test_gentle_load_no_sheds(self):
        _sched, stats = self._run("on", rate=20)
        assert stats.snapshot()["shed"] == 0

    def test_admission_off_never_sheds(self):
        _sched, stats = self._run("off", rate=400)
        assert stats.snapshot()["shed"] == 0


# ---- parity with the JAX package's pure core ------------------------------

GEN_SPECS = [
    dict(seed=5, rate_rps=100),
    dict(seed=11, rate_rps=400, prompt_len=("uniform", 2, 6),
         max_new=("uniform", 2, 8), vocab=32),
    dict(seed=3, rate_rps=7.5, prompt_len=("bimodal", 2, 40, 0.7),
         max_new=("fixed", 9), vocab=32768, start_ms=125.0),
    dict(seed=2026, rate_rps=6, prompt_len=("uniform", 16, 256),
         max_new=("uniform", 8, 96), vocab=32768),
]


def _fields(r):
    return (r.rid, r.prompt, r.max_new, r.arrival_ms, r.deadline_ms,
            r.state)


@pytest.mark.parametrize("spec", GEN_SPECS, ids=lambda s: str(s["seed"]))
def test_loadgen_stream_matches_jax(spec):
    gens = [mods["loadgen"].LoadGen(deadline_fn=lambda t: t + 250.0, **spec)
            for mods in (T, J)]
    assert ([_fields(r) for r in gens[0].take(200)]
            == [_fields(r) for r in gens[1].take(200)])
    # until() over a ragged clock continues both streams alike
    clock = random.Random(spec["seed"])
    t = gens[0]._t_ms
    for _ in range(50):
        t += clock.uniform(0.0, 40.0)
        assert ([_fields(r) for r in gens[0].until(t)]
                == [_fields(r) for r in gens[1].until(t)])


def _closed_loop_trace(mods, admit, rate, slo=300.0, steps=300,
                       step_ms=5.0):
    """tests/test_serving.py's 300-step closed loop on one package's
    modules, every decision recorded: each arrival's verdict, the
    reconsidered victims, each plan and its words, the completions, and
    the final snapshot and books."""
    adm, lg, pm, sch, st = (mods[k] for k in ("admission", "loadgen", "plan",
                                              "scheduler", "stats"))
    gen = lg.LoadGen(seed=11, rate_rps=rate, prompt_len=("uniform", 2, 6),
                     max_new=("uniform", 2, 8), vocab=32)
    sched = sch.SlotScheduler(4, 16)
    est = adm.SLOEstimator(seed_step_ms=step_ms, seed_prefill_ms_per_tok=0.5)
    ctrl = adm.AdmissionController(
        admit, slo_ms=slo if admit == "on" else 0.0, estimator=est)
    stats = st.ServingStats(slo_ms=slo, max_batch=4, admit_mode=admit)
    gen.deadline_fn = lambda t: t + slo
    trace = {"verdicts": [], "victims": [], "plans": [], "words": [],
             "done": []}
    now = 0.0
    for _ in range(steps):
        now += step_ms
        for req in gen.until(now):
            stats.observe_submitted()
            v, reason = ctrl.decide(req, now, sched)
            trace["verdicts"].append((req.rid, v, reason))
            if v == "admit":
                sched.submit(req, now)
            else:
                sched.shed_request(req, now, reason)
                stats.observe_shed(reason)
        for r in ctrl.reconsider_queued(now, sched):
            stats.observe_shed(r.shed_reason)
            trace["victims"].append((r.rid, r.shed_reason))
        digest = sched.state_digest()
        plan = sched.plan_step(now)
        trace["plans"].append((plan.step, [(s, r.rid) for s, r in
                                           plan.admissions],
                               list(plan.decode_slots),
                               list(plan.positions)))
        trace["words"].append(pm.encode_plan(plan, 4, 16, digest))
        for slot, req in plan.admissions:
            est.observe_prefill(step_ms / 2, req.prompt_len)
            sched.prefill_done(slot, now)
        if plan.decode_slots:
            est.observe_step(step_ms)
        sched.step_done(plan, now)
        for r in sched.finished:
            stats.observe_completed(r)
            trace["done"].append((r.rid, r.generated, r.done_ms))
        sched.finished.clear()
        stats.observe_step(sched.queue_depth(), sched.occupancy())
    sched.check_accounting()
    trace["snapshot"] = stats.snapshot()
    trace["books"] = (sched.submitted, sched.completed, sched.shed,
                      sched.queue_depth(), sched.occupancy())
    trace["estimator"] = (est.step_ms, est.prefill_ms_per_tok)
    return trace


LOOPS = [("on", 400), ("on", 20), ("off", 400)]
_traces = {}


def traces(admit, rate):
    if (admit, rate) not in _traces:
        _traces[admit, rate] = tuple(_closed_loop_trace(m, admit, rate)
                                     for m in (T, J))
    return _traces[admit, rate]


@pytest.mark.parametrize("admit,rate", LOOPS)
def test_closed_loop_plans_match_jax(admit, rate):
    port, jax_ = traces(admit, rate)
    assert len(port["plans"]) == 300
    assert port["plans"] == jax_["plans"]
    assert port["done"] == jax_["done"]
    assert port["books"] == jax_["books"]


@pytest.mark.parametrize("admit,rate", LOOPS)
def test_closed_loop_plan_words_match_jax(admit, rate):
    port, jax_ = traces(admit, rate)
    assert port["words"] == jax_["words"]
    # and the port decodes the JAX package's words to the same plans
    for vec in jax_["words"]:
        assert plan_mod.decode_plan(vec, 4, 16) == J["plan"].decode_plan(
            vec, 4, 16)


@pytest.mark.parametrize("admit,rate", LOOPS)
def test_closed_loop_admission_verdicts_match_jax(admit, rate):
    port, jax_ = traces(admit, rate)
    assert port["verdicts"] == jax_["verdicts"]
    assert port["victims"] == jax_["victims"]
    assert port["estimator"] == jax_["estimator"]
    if admit == "on" and rate == 400:
        assert any(v == "shed" for _, v, _ in port["verdicts"])


@pytest.mark.parametrize("admit,rate", LOOPS)
def test_closed_loop_snapshot_matches_jax(admit, rate):
    port, jax_ = traces(admit, rate)
    assert port["snapshot"] == jax_["snapshot"]
    assert port["snapshot"]["completed"] > 0


def test_plan_words_with_flags_match_jax():
    plans = []
    for mods in (T, J):
        sched = mods["scheduler"].SlotScheduler(3, 8, max_prefill_per_step=3)
        for rid in range(4):
            sched.submit(mods["request"].Request(
                rid, tuple(range(rid + 1, 2 * rid + 3)), 3, 0.0,
                deadline_ms=None if rid % 2 else 100.0 * rid), 0.0)
        plans.append(sched.plan_step(0.0))
    for stop, retire in ((False, None), (True, None), (False, 5),
                         (True, 0)):
        words = [m["plan"].encode_plan(p, 3, 8, 0xBEEF, stop=stop,
                                       retire=retire)
                 for m, p in zip((T, J), plans)]
        assert words[0] == words[1]
        assert plan_mod.decode_plan(words[0], 3, 8) == \
            J["plan"].decode_plan(words[1], 3, 8)


def test_admission_decisions_match_jax():
    # seeded requests against a loaded scheduler under every fabric view
    # and bucket the controller reads
    views = [None, {}, {"worst_link": {"state": 1, "reconnects": 0}},
             {"worst_link": {"state": 0, "reconnects": 4}},
             {"worst_link": {"state": 2, "reconnects": 9}}]
    for view in views:
        got = []
        for mods in (T, J):
            adm, sch = mods["admission"], mods["scheduler"]
            est = adm.SLOEstimator(seed_step_ms=12.0,
                                   seed_prefill_ms_per_tok=0.3)
            ctrl = adm.AdmissionController(
                "on", slo_ms=250.0, estimator=est,
                bucket=adm.TokenBucket(40, 4))
            ctrl.observe_fabric(view)
            sched = sch.SlotScheduler(2, 64)
            gen = mods["loadgen"].LoadGen(
                seed=8, rate_rps=80, prompt_len=("uniform", 2, 40),
                max_new=("uniform", 1, 20),
                deadline_fn=lambda t: t + 250.0)
            out = []
            for req in gen.take(60):
                v, reason = ctrl.decide(req, req.arrival_ms, sched)
                if v == "admit":
                    sched.submit(req, req.arrival_ms)
                out.append((v, reason))
            out.append(adm.degradation_factor(view))
            got.append(out)
        assert got[0] == got[1], view


# ---- the serving knobs (tests/test_config_tuning.py's cases) ---------------


class TestSloMs:
    def test_default_is_zero(self, monkeypatch):
        monkeypatch.delenv("T4J_SLO_MS", raising=False)
        assert config.slo_ms() == 0.0

    def test_value(self, monkeypatch):
        monkeypatch.setenv("T4J_SLO_MS", "2500")
        assert config.slo_ms() == 2500.0

    def test_fractional_ok(self, monkeypatch):
        monkeypatch.setenv("T4J_SLO_MS", "0.5")
        assert config.slo_ms() == 0.5

    @pytest.mark.parametrize("bad", ["soon", "-100", "inf", "nan"])
    def test_rejects_garbage(self, bad, monkeypatch):
        monkeypatch.setenv("T4J_SLO_MS", bad)
        with pytest.raises(ValueError, match="T4J_SLO_MS"):
            config.slo_ms()


class TestMaxBatch:
    def test_default(self, monkeypatch):
        monkeypatch.delenv("T4J_MAX_BATCH", raising=False)
        assert config.max_batch() == 8

    def test_value(self, monkeypatch):
        monkeypatch.setenv("T4J_MAX_BATCH", "32")
        assert config.max_batch() == 32

    @pytest.mark.parametrize("bad", ["0", "1025", "-3"])
    def test_rejects_out_of_range(self, bad, monkeypatch):
        monkeypatch.setenv("T4J_MAX_BATCH", bad)
        with pytest.raises(ValueError, match="T4J_MAX_BATCH"):
            config.max_batch()

    def test_rejects_garbage(self, monkeypatch):
        monkeypatch.setenv("T4J_MAX_BATCH", "many")
        with pytest.raises(ValueError, match="T4J_MAX_BATCH"):
            config.max_batch()


class TestAdmitMode:
    def test_default_is_off(self, monkeypatch):
        monkeypatch.delenv("T4J_ADMIT", raising=False)
        assert config.admit_mode() == "off"

    @pytest.mark.parametrize("value,want", [
        ("off", "off"), ("on", "on"), (" ON ", "on"), ("", "off"),
    ])
    def test_values(self, value, want, monkeypatch):
        monkeypatch.setenv("T4J_ADMIT", value)
        assert config.admit_mode() == want

    @pytest.mark.parametrize("bad", ["auto", "1", "slo", "shed"])
    def test_rejects_garbage(self, bad, monkeypatch):
        monkeypatch.setenv("T4J_ADMIT", bad)
        with pytest.raises(ValueError, match="T4J_ADMIT"):
            config.admit_mode()


@pytest.fixture
def one_rank_job(monkeypatch):
    """A one-rank job's environment in which ``ensure_initialized`` must
    refuse before building the bridge."""
    if truntime.is_initialized():
        pytest.skip("bridge already initialised in this process")
    monkeypatch.setenv("T4J_RANK", "0")
    monkeypatch.setenv("T4J_SIZE", "1")
    for var in ("T4J_SLO_MS", "T4J_ADMIT", "T4J_MAX_BATCH", "T4J_ELASTIC",
                "T4J_AUTOSCALE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tbuild, "ensure_built", lambda: pytest.fail(
        "the bridge was built for a refused knob"))
    return monkeypatch


@pytest.mark.parametrize("env,match", [
    ({"T4J_SLO_MS": "1000", "T4J_ADMIT": "off"}, "T4J_ADMIT=off"),
    ({"T4J_SLO_MS": "1000"}, "T4J_ADMIT=off"),
    ({"T4J_ADMIT": "shed-everything"}, "T4J_ADMIT"),
    ({"T4J_MAX_BATCH": "0"}, "T4J_MAX_BATCH"),
    ({"T4J_SLO_MS": "-1", "T4J_ADMIT": "on"}, "T4J_SLO_MS"),
])
def test_ensure_initialized_refuses_serving_knobs(one_rank_job, env, match):
    for var, value in env.items():
        one_rank_job.setenv(var, value)
    with pytest.raises(ValueError, match=match):
        truntime.ensure_initialized()
