"""The port's autoscale policy (``mpi4jax_tpu_torch/serving/
autoscale.py``) and plan-stream mirror rebuild (``serving/plan.py``)
held to the JAX package's.

* Every case of ``tests/test_autoscale.py``, with the same assertions,
  against the port's modules: the hysteresis state machine (doubling
  grow, halving drain-then-shrink, flap suppression, floor and ceiling
  clamps, the shrink cascade), the grow-request file channel, and the
  late joiner's mirror rebuild from a plan stream.
* The same decisions as the JAX package's ``Autoscaler`` on a seeded
  stream of windows, and the same request files.
* The ``T4J_AUTOSCALE`` knob as ``tests/test_config_tuning.py`` holds
  the JAX package's, and ``ensure_initialized`` refusing
  ``T4J_AUTOSCALE=on`` until the port has elastic jobs (ROADMAP Queue 1
  item 19, which also brings the window and request-file knobs).
"""

import importlib
import json
import pathlib
import random
import sys
import types

import pytest

from mpi4jax_tpu_torch.native import build as tbuild
from mpi4jax_tpu_torch.native import runtime as truntime
from mpi4jax_tpu_torch.serving import autoscale
from mpi4jax_tpu_torch.serving import plan as plan_mod
from mpi4jax_tpu_torch.serving import request, scheduler
from mpi4jax_tpu_torch.utils import config

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load_jax_serving():
    """The JAX package's pure serving core, as tests/test_autoscale.py
    loads it."""
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


jautoscale = importlib.import_module(_load_jax_serving().__name__
                                     + ".autoscale")

Autoscaler = autoscale.Autoscaler
IDLE = autoscale.IDLE
PENDING_GROW = autoscale.PENDING_GROW
DRAINING = autoscale.DRAINING
PENDING_SHRINK = autoscale.PENDING_SHRINK


def _scaler(floor=4, ceiling=8, up=3, occ=0.35, down=6, cooldown=4):
    return Autoscaler(floor=floor, ceiling=ceiling, up_windows=up,
                      down_occ=occ, down_windows=down,
                      cooldown_windows=cooldown)


def _busy(s, world=4):
    """One over-budget window (counts toward scale-up)."""
    return s.observe(predicted_wait_ms=900.0, budget_ms=500.0,
                     occupancy=0.95, world=world)


def _idle_w(s, world=8):
    """One low-occupancy window (counts toward scale-down)."""
    return s.observe(predicted_wait_ms=10.0, budget_ms=500.0,
                     occupancy=0.10, world=world)


def _calm(s, world=4):
    """A window that qualifies for neither streak."""
    return s.observe(predicted_wait_ms=10.0, budget_ms=500.0,
                     occupancy=0.60, world=world)


# ---- construction validation ---------------------------------------------


class TestValidation:
    def test_floor_below_one_raises(self):
        with pytest.raises(ValueError, match="floor"):
            _scaler(floor=0)

    def test_ceiling_below_floor_raises(self):
        with pytest.raises(ValueError, match="ceiling"):
            _scaler(floor=4, ceiling=2)

    @pytest.mark.parametrize("kw", [{"up": 0}, {"down": 0}])
    def test_zero_windows_raise(self, kw):
        with pytest.raises(ValueError, match="windows"):
            _scaler(**kw)

    @pytest.mark.parametrize("occ", [-0.1, 1.0, 2.0])
    def test_down_occ_out_of_range_raises(self, occ):
        with pytest.raises(ValueError, match="down_occ"):
            _scaler(occ=occ)

    def test_negative_cooldown_raises(self):
        with pytest.raises(ValueError, match="cooldown"):
            _scaler(cooldown=-1)


# ---- scale-up: doubling with hysteresis ----------------------------------


class TestGrow:
    def test_streak_of_up_windows_triggers_doubling(self):
        s = _scaler(up=3)
        assert _busy(s).action == "none"
        assert _busy(s).action == "none"
        dec = _busy(s)
        # doubling, not +1: TP head counts only divide at 1/2/4/8
        assert dec.action == "grow"
        assert dec.target_world == 8
        assert dec.victims == ()
        assert s.state == PENDING_GROW
        assert "budget" in dec.reason

    def test_good_window_resets_the_streak(self):
        s = _scaler(up=3)
        _busy(s)
        _busy(s)
        _calm(s)  # one good window: the streak is noise, not a trend
        assert _busy(s).action == "none"
        assert _busy(s).action == "none"
        assert _busy(s).action == "grow"

    def test_grow_clamps_to_ceiling(self):
        s = _scaler(floor=1, ceiling=6, up=1)
        dec = _busy(s, world=4)
        assert dec.action == "grow"
        assert dec.target_world == 6  # min(2 * 4, ceiling)

    def test_no_grow_at_ceiling(self):
        s = _scaler(up=1)
        dec = _busy(s, world=8)
        assert dec.action == "none"
        assert s.state == IDLE

    def test_pending_grow_holds_until_commit(self):
        s = _scaler(up=1)
        assert _busy(s).action == "grow"
        dec = _busy(s)
        assert dec.action == "none"
        assert dec.reason == "resize-pending"
        s.resize_committed(8)
        assert s.state == IDLE


# ---- scale-down: drain, then a halving cascade ---------------------------


class TestDrainShrink:
    def _drained(self, s, world=8):
        for _ in range(s.down_windows):
            dec = _idle_w(s, world=world)
        return dec

    def test_low_occupancy_streak_starts_a_drain(self):
        s = _scaler(down=6)
        for _ in range(5):
            assert _idle_w(s).action == "none"
        dec = _idle_w(s)
        assert dec.action == "drain"
        assert dec.target_world == 4          # max(8 // 2, floor)
        assert dec.victims == (7, 6, 5, 4)    # top half, descending
        assert s.state == DRAINING

    def test_victims_never_include_rank_zero(self):
        # rank 0 owns the coordinator port and the leader role
        s = _scaler(floor=1, down=1)
        dec = self._drained(s, world=2)
        assert dec.victims == (1,)

    def test_shrink_clamps_to_floor(self):
        s = _scaler(floor=3, down=1)
        dec = self._drained(s, world=4)
        assert dec.target_world == 3          # max(4 // 2, floor)
        assert dec.victims == (3,)

    def test_no_drain_at_floor(self):
        s = _scaler(floor=4, down=1)
        assert _idle_w(s, world=4).action == "none"
        assert s.state == IDLE

    def test_draining_freezes_streaks(self):
        s = _scaler(down=1, up=1)
        self._drained(s)
        # even a hard over-budget window cannot interrupt mid-drain
        # from observe(); only abandon_drain() can
        dec = _busy(s, world=8)
        assert dec.action == "none"
        assert dec.reason == "draining"
        assert s.state == DRAINING

    def test_drain_complete_yields_shrink_with_victims(self):
        s = _scaler(down=1)
        self._drained(s)
        dec = s.drain_complete()
        assert dec.action == "shrink"
        assert dec.target_world == 4
        assert dec.victims == (7, 6, 5, 4)
        assert s.state == PENDING_SHRINK

    def test_drain_complete_outside_drain_raises(self):
        s = _scaler()
        with pytest.raises(RuntimeError, match="drain_complete"):
            s.drain_complete()

    def test_abandon_drain_returns_to_idle_with_cooldown(self):
        s = _scaler(down=1, cooldown=2)
        self._drained(s)
        s.abandon_drain("load returned")
        assert s.state == IDLE
        assert s.victims == ()
        # the cooldown armed: the next windows accumulate nothing
        assert _idle_w(s).reason == "cooldown"
        assert ("abandon-drain" in [a for _, a, _r in s.history])

    def test_abandon_drain_outside_drain_is_noop(self):
        s = _scaler()
        s.abandon_drain()
        assert s.state == IDLE

    def test_shrink_cascade_commits_one_rank_per_epoch(self):
        # a single scale-down decision retires one rank per step-plan:
        # the machine must survive the intermediate epochs without
        # resetting or re-deciding
        s = _scaler(down=1)
        self._drained(s)
        s.drain_complete()
        for world in (7, 6, 5):
            s.resize_committed(world)
            assert s.state == PENDING_SHRINK
            assert all(v < world for v in s.victims)
            assert _calm(s, world=world).reason == "resize-pending"
        s.resize_committed(4)  # target reached: cascade over
        assert s.state == IDLE
        assert s.victims == ()
        assert _calm(s).reason == "cooldown"


# ---- flap suppression ----------------------------------------------------


class TestCooldown:
    def test_commit_arms_cooldown(self):
        s = _scaler(up=1, cooldown=3)
        _busy(s)
        s.resize_committed(8)
        for _ in range(3):
            dec = _busy(s, world=8)
            assert dec.action == "none"
            assert dec.reason == "cooldown"

    def test_cooldown_discards_pre_resize_streaks(self):
        s = _scaler(ceiling=16, up=2, cooldown=2)
        _busy(s)
        s.resize_committed(8)   # an external commit mid-streak
        _idle_w(s, world=8)     # cooldown window 1
        _idle_w(s, world=8)     # cooldown window 2
        # post-cooldown the old up-streak is gone: one busy window
        # must not trigger a grow on its own
        assert _busy(s, world=8).action == "none"
        assert s.state == IDLE

    def test_zero_cooldown_disables_refractory(self):
        s = _scaler(floor=1, ceiling=16, up=1, cooldown=0)
        assert _busy(s, world=4).action == "grow"
        s.resize_committed(8)
        assert _busy(s, world=8).action == "grow"

    def test_history_records_the_story(self):
        s = _scaler(up=1)
        _busy(s)
        s.resize_committed(8)
        actions = [a for _w, a, _r in s.history]
        assert actions == ["grow", "commit"]


# ---- grow-request file channel -------------------------------------------


class TestRequestChannel:
    def test_roundtrip(self, tmp_path):
        path = str(tmp_path / "req.json")
        autoscale.post_request(path, 8, 3, reason="ramp")
        req = autoscale.read_request(path)
        assert req == {"want_world": 8, "epoch": 3, "reason": "ramp"}
        autoscale.clear_request(path)
        assert autoscale.read_request(path) is None

    def test_missing_file_reads_none(self, tmp_path):
        assert autoscale.read_request(str(tmp_path / "nope")) is None

    def test_clear_is_idempotent(self, tmp_path):
        path = str(tmp_path / "req.json")
        autoscale.clear_request(path)
        autoscale.clear_request(path)

    @pytest.mark.parametrize("body", [
        "not json{",
        json.dumps([1, 2, 3]),
        json.dumps({"format": "something-else", "want_world": 8}),
        json.dumps({"format": "t4j-autoscale-req-v1"}),
        json.dumps({"format": "t4j-autoscale-req-v1",
                    "want_world": "many", "epoch": 0}),
    ])
    def test_malformed_file_reads_none(self, tmp_path, body):
        # the launcher must never crash on a half-written or foreign
        # file at the request path
        path = tmp_path / "req.json"
        path.write_text(body)
        assert autoscale.read_request(str(path)) is None

    def test_post_overwrites_atomically(self, tmp_path):
        path = str(tmp_path / "req.json")
        autoscale.post_request(path, 8, 1)
        autoscale.post_request(path, 16, 2)
        req = autoscale.read_request(path)
        assert req["want_world"] == 16
        assert req["epoch"] == 2
        # no tempfile litter from the atomic replace
        assert [p.name for p in tmp_path.iterdir()] == ["req.json"]


# ---- late-joiner mirror rebuild ------------------------------------------


def _drive_stream(steps=6, max_batch=2, p_max=16):
    """Drive a live leader + mirror, recording every encoded vector —
    the plan log a late joiner replays."""
    leader = scheduler.SlotScheduler(max_batch, p_max)
    mirror = scheduler.FollowerMirror(max_batch, p_max)
    vecs = []
    rid = 0
    for i in range(steps):
        if i % 2 == 0:
            leader.submit(
                request.Request(rid, tuple(range(1, 4 + rid % 3)),
                                2 + rid % 4, float(i)),
                float(i),
            )
            rid += 1
        digest = leader.state_digest()
        plan = leader.plan_step(float(i))
        vec = plan_mod.encode_plan(plan, max_batch, p_max, digest)
        vecs.append(vec)
        decoded = plan_mod.decode_plan(vec, max_batch, p_max,
                                       expect_digest=mirror.state_digest())
        admitted, _fin = mirror.apply(decoded)
        for slot, _r in plan.admissions:
            leader.prefill_done(slot, float(i))
        for slot, _r, _p, _m in admitted:
            mirror.prefill_done(slot)
        leader.step_done(plan, float(i))
    return leader, mirror, vecs, max_batch, p_max


class TestRebuildMirror:
    def test_rebuild_matches_live_mirror(self, tmp_path):
        leader, mirror, vecs, mb, pm = _drive_stream()
        path = str(tmp_path / "plan.jsonl")
        plan_mod.save_plan_stream(path, vecs, mb, pm, world=2)
        meta, loaded = plan_mod.load_plan_stream(path)
        rebuilt, reqs = plan_mod.rebuild_mirror(
            meta, loaded, source=path,
            expect_digest=mirror.state_digest(),
        )
        assert rebuilt.state_digest() == mirror.state_digest()
        # the request map covers exactly the rids still holding slots
        live = {row[0] for row in mirror.rows().values()}
        assert set(reqs) == live
        for rid, req in reqs.items():
            assert req.rid == rid

    def test_digest_gate_blocks_stale_log(self, tmp_path):
        # a truncated plan log rebuilds fine but disagrees with the
        # leader's live digest: the joiner must not serve
        _leader, mirror, vecs, mb, pm = _drive_stream()
        path = str(tmp_path / "plan.jsonl")
        plan_mod.save_plan_stream(path, vecs[:-1], mb, pm)
        meta, loaded = plan_mod.load_plan_stream(path)
        with pytest.raises(plan_mod.PlanError, match="must not serve"):
            plan_mod.rebuild_mirror(
                meta, loaded, source=path,
                expect_digest=mirror.state_digest(),
            )

    def test_diverged_stream_raises(self, tmp_path):
        _leader, _mirror, vecs, mb, pm = _drive_stream()
        # replaying an admission step twice is follower drift
        dup = vecs + [vecs[0]]
        meta = {"max_batch": mb, "p_max": pm}
        with pytest.raises(plan_mod.PlanError, match="diverged"):
            plan_mod.rebuild_mirror(meta, dup, source="<dup>")

    def test_rebuild_without_pin_skips_the_gate(self):
        _leader, mirror, vecs, mb, pm = _drive_stream()
        meta = {"max_batch": mb, "p_max": pm}
        rebuilt, _reqs = plan_mod.rebuild_mirror(meta, vecs)
        assert rebuilt.state_digest() == mirror.state_digest()


# ---- parity with the JAX package's policy ----------------------------------


def _decision(d):
    return None if d is None else (d.action, d.target_world,
                                   tuple(d.victims), d.reason)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_policy_matches_jax_on_seeded_windows(seed):
    kw = dict(floor=2, ceiling=16, up_windows=2, down_occ=0.35,
              down_windows=3, cooldown_windows=1 + seed % 2)
    port, jax_ = autoscale.Autoscaler(**kw), jautoscale.Autoscaler(**kw)
    rng = random.Random(seed)
    world = 4
    for _ in range(400):
        window = dict(predicted_wait_ms=rng.choice([5.0, 300.0, 900.0]),
                      budget_ms=500.0, occupancy=rng.random(), world=world)
        got = [_decision(s.observe(**window)) for s in (port, jax_)]
        assert got[0] == got[1]
        assert port.state == jax_.state
        action = rng.random()
        if port.state == autoscale.PENDING_GROW and action < 0.5:
            world = got[0][1]
            for s in (port, jax_):
                s.resize_committed(world)
        elif port.state == autoscale.DRAINING and action < 0.5:
            got = [_decision(s.drain_complete()) for s in (port, jax_)]
            assert got[0] == got[1]
        elif port.state == autoscale.DRAINING and action < 0.6:
            for s in (port, jax_):
                s.abandon_drain()
        elif port.state == autoscale.PENDING_SHRINK and action < 0.5:
            world = max(kw["floor"], world - 1)
            for s in (port, jax_):
                s.resize_committed(world)
        assert port.state == jax_.state
    assert port.history == jax_.history


def test_request_files_match_jax(tmp_path):
    t, j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    autoscale.post_request(t, 8, 3, "wait 900ms > budget")
    jautoscale.post_request(j, 8, 3, "wait 900ms > budget")
    want = {k: v for k, v in json.loads(pathlib.Path(j).read_text()).items()
            if k != "posted_at"}
    got = {k: v for k, v in json.loads(pathlib.Path(t).read_text()).items()
           if k != "posted_at"}
    assert got == want
    assert autoscale.read_request(j) == jautoscale.read_request(j)
    assert jautoscale.read_request(t) == autoscale.read_request(t)


# ---- the autoscale knobs (tests/test_config_tuning.py's cases) -------------


class TestAutoscaleMode:
    def test_default_is_off(self, monkeypatch):
        monkeypatch.delenv("T4J_AUTOSCALE", raising=False)
        assert config.autoscale_mode() == "off"

    @pytest.mark.parametrize("value,want", [
        ("off", "off"), ("on", "on"), (" ON ", "on"), ("", "off"),
    ])
    def test_values(self, value, want, monkeypatch):
        monkeypatch.setenv("T4J_AUTOSCALE", value)
        assert config.autoscale_mode() == want

    @pytest.mark.parametrize("bad", ["auto", "1", "grow", "elastic"])
    def test_rejects_garbage(self, bad, monkeypatch):
        monkeypatch.setenv("T4J_AUTOSCALE", bad)
        with pytest.raises(ValueError, match="T4J_AUTOSCALE"):
            config.autoscale_mode()


@pytest.mark.parametrize("env,match", [
    ({"T4J_AUTOSCALE": "on"}, "item 19"),
    ({"T4J_AUTOSCALE": "bogus"}, "T4J_AUTOSCALE"),
])
def test_ensure_initialized_refuses_autoscale(monkeypatch, env, match):
    # JAX refuses T4J_AUTOSCALE=on without --elastic rejoin; the port,
    # which has no elastic jobs yet, refuses it with the item that
    # brings them, before building anything
    if truntime.is_initialized():
        pytest.skip("bridge already initialised in this process")
    monkeypatch.setenv("T4J_RANK", "0")
    monkeypatch.setenv("T4J_SIZE", "1")
    for var in ("T4J_ELASTIC", "T4J_SLO_MS", "T4J_ADMIT"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(tbuild, "ensure_built", lambda: pytest.fail(
        "the bridge was built for a refused knob"))
    with pytest.raises(ValueError, match=match):
        truntime.ensure_initialized()
