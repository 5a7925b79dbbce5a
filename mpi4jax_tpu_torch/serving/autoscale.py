"""Traffic-driven elastic autoscaling for the serving engine.

The port's copy of ``mpi4jax_tpu/serving/autoscale.py``.  Nothing in
the port drives it yet: the engine's autoscale wiring, the launcher's
``--autoscale`` and the ``T4J_SCALE_*`` / ``T4J_AUTOSCALE_REQ`` knobs
named below come with the port's elastic jobs (ROADMAP Queue 1 item
19).

Pure-core policy (docs/serving.md "Autoscaling"): the leader feeds one
observation per decision window — the SLOEstimator's predicted wait for
a hypothetical head-of-queue request, the current batch occupancy, and
the live world size — and the :class:`Autoscaler` answers with an
action.  Everything here is time- and world-injected so the state
machine is unit-testable without a tensor library, a bridge, or a clock.

The machine:

::

    IDLE --(predicted wait > budget for up_windows)--> PENDING_GROW
    IDLE --(occupancy < down_occ for down_windows)---> DRAINING
    DRAINING --(batch drained)-----------------------> PENDING_SHRINK
    PENDING_GROW --(epoch commit)--------------------> IDLE (cooldown)
    PENDING_SHRINK --(epoch commits, world==target)--> IDLE (cooldown)

Hysteresis is structural: scale-up and scale-down each require their
own run of *consecutive* qualifying windows (a single good window
resets the streak), a post-resize ``cooldown_windows`` refractory
period suppresses flapping, and the world is clamped to
``[floor, ceiling]`` (floor reuses ``T4J_MIN_WORLD``; the ceiling is
the boot-time rank budget — the launcher cannot mint new hosts).

Scale steps are **doubling/halving**, not +-1: the serving engine is
tensor-parallel, and a model's head counts divide evenly only at a
sparse set of world sizes (8 heads shard over 1/2/4/8 ranks, never
7).  A grow jumps to ``min(ceiling, 2 * world)`` — load is already
hurting, add the capacity in one epoch instead of five — and a shrink
targets ``max(floor, world // 2)``, retiring the top half one rank per
step-plan (the in-band ``retire`` flag) so the launcher observes an
orderly cascade rather than a mass exit.  Scale-down is never abrupt:
the policy first *drains* by holding admissions and clamping in-slot
completion horizons (``SlotScheduler.clamp_completions``), and only
once the batch is empty does it start retiring victims.  Grow
requests travel over a file channel (:func:`post_request` /
:func:`read_request`) that ``launch.py --autoscale`` polls: the
launcher owns process lifecycles, the engine owns policy, and the
kept-open coordinator port admits the ``T4J_REJOIN=1`` expansion
ranks into the next epoch.
"""

import json
import os
import tempfile

__all__ = [
    "Autoscaler",
    "AutoscaleDecision",
    "IDLE",
    "PENDING_GROW",
    "DRAINING",
    "PENDING_SHRINK",
    "post_request",
    "read_request",
    "clear_request",
]

IDLE = "idle"
PENDING_GROW = "pending-grow"
DRAINING = "draining"
PENDING_SHRINK = "pending-shrink"

#: request-file format tag (versioned like every other t4j artifact).
_REQ_FORMAT = "t4j-autoscale-req-v1"


class AutoscaleDecision:
    """One window's verdict.  ``action`` is ``"none"``, ``"grow"``,
    ``"drain"`` or ``"shrink"``; ``target_world`` is the world size the
    policy wants next (unchanged for ``"none"``/``"drain"``),
    ``victims`` the world ranks a shrink retires (empty otherwise),
    and ``reason`` a short human-readable trigger description carried
    into telemetry/membership history."""

    __slots__ = ("action", "target_world", "victims", "reason")

    def __init__(self, action, target_world, victims=(), reason=""):
        self.action = action
        self.target_world = int(target_world)
        self.victims = tuple(victims)
        self.reason = reason

    def __repr__(self):  # pragma: no cover - debugging nicety
        return (
            f"AutoscaleDecision({self.action!r}, world={self.target_world},"
            f" victims={self.victims}, reason={self.reason!r})"
        )


class Autoscaler:
    """Hysteresis-guarded scale policy.

    Parameters
    ----------
    floor, ceiling:
        Inclusive world-size bounds.  ``floor`` reuses the elastic
        ``T4J_MIN_WORLD`` contract; ``ceiling`` is the launch-time rank
        budget.
    up_windows:
        Consecutive windows of predicted-wait > budget before a grow is
        requested (``T4J_SCALE_UP_WINDOWS``).
    down_occ:
        Occupancy threshold below which a window counts toward
        scale-down (``T4J_SCALE_DOWN_OCC``).
    down_windows:
        Consecutive low-occupancy windows before a drain starts
        (``T4J_SCALE_DOWN_WINDOWS``).
    cooldown_windows:
        Refractory windows after any epoch commit during which neither
        streak accumulates (``T4J_SCALE_COOLDOWN_WINDOWS``) — the flap
        suppressor.
    """

    def __init__(
        self,
        *,
        floor,
        ceiling,
        up_windows,
        down_occ,
        down_windows,
        cooldown_windows=4,
    ):
        floor = int(floor)
        ceiling = int(ceiling)
        if floor < 1:
            raise ValueError(f"floor must be >= 1, got {floor}")
        if ceiling < floor:
            raise ValueError(
                f"ceiling must be >= floor, got ceiling={ceiling} floor={floor}"
            )
        if int(up_windows) < 1 or int(down_windows) < 1:
            raise ValueError("up_windows and down_windows must be >= 1")
        if not (0.0 <= float(down_occ) < 1.0):
            raise ValueError(
                f"down_occ must be in [0, 1), got {down_occ}"
            )
        if int(cooldown_windows) < 0:
            raise ValueError(
                f"cooldown_windows must be >= 0, got {cooldown_windows}"
            )
        self.floor = floor
        self.ceiling = ceiling
        self.up_windows = int(up_windows)
        self.down_occ = float(down_occ)
        self.down_windows = int(down_windows)
        self.cooldown_windows = int(cooldown_windows)
        self.state = IDLE
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = 0
        self._victims = ()
        self._target = None
        # decision history for telemetry: (window_idx, action, reason)
        self.history = []
        self._window = 0

    # -- observation -------------------------------------------------

    def observe(self, *, predicted_wait_ms, budget_ms, occupancy, world):
        """Feed one decision window; returns an :class:`AutoscaleDecision`.

        ``predicted_wait_ms`` is the estimator's queue-wait forecast
        for a head-of-queue arrival, ``budget_ms`` the SLO share spent
        waiting we are willing to tolerate, ``occupancy`` the mean slot
        occupancy over the window in ``[0, 1]``, ``world`` the current
        alive world size.
        """
        self._window += 1
        world = int(world)
        if self.state in (PENDING_GROW, PENDING_SHRINK):
            # A resize is in flight; hold position until the caller
            # reports the epoch commit (or abandonment).
            return self._decide("none", world, reason="resize-pending")
        if self.state == DRAINING:
            # Streaks freeze during a drain; the only way forward is
            # drain_complete() or abandon_drain().
            return self._decide("none", world, reason="draining")
        if self._cooldown > 0:
            self._cooldown -= 1
            self._up_streak = 0
            self._down_streak = 0
            return self._decide("none", world, reason="cooldown")

        over = float(predicted_wait_ms) > float(budget_ms)
        under = float(occupancy) < self.down_occ
        self._up_streak = self._up_streak + 1 if over else 0
        self._down_streak = self._down_streak + 1 if under else 0

        if self._up_streak >= self.up_windows and world < self.ceiling:
            self.state = PENDING_GROW
            # Doubling keeps the world on TP-divisible sizes (see the
            # module docstring); load already breached the budget, so
            # add the capacity in one epoch rather than several.
            self._target = min(world * 2, self.ceiling)
            self._up_streak = 0
            self._down_streak = 0
            return self._decide(
                "grow",
                self._target,
                reason=(
                    f"predicted wait {predicted_wait_ms:.0f}ms > budget"
                    f" {budget_ms:.0f}ms for {self.up_windows} windows"
                ),
            )
        if self._down_streak >= self.down_windows and world > self.floor:
            self.state = DRAINING
            self._target = max(world // 2, self.floor)
            # The highest alive ranks are the victims: rank 0 (the
            # leader and coordinator-port owner) must never be retired,
            # and the launcher reuses the freed top slots on a grow.
            self._victims = tuple(range(world - 1, self._target - 1, -1))
            self._up_streak = 0
            self._down_streak = 0
            return self._decide(
                "drain",
                self._target,
                victims=self._victims,
                reason=(
                    f"occupancy {occupancy:.2f} < {self.down_occ:.2f}"
                    f" for {self.down_windows} windows"
                ),
            )
        return self._decide("none", world)

    # -- transitions reported by the engine --------------------------

    def drain_complete(self):
        """The batch is empty; start retiring the victims now."""
        if self.state != DRAINING:
            raise RuntimeError(
                f"drain_complete in state {self.state!r} (expected draining)"
            )
        self.state = PENDING_SHRINK
        return AutoscaleDecision(
            "shrink",
            self._target,
            victims=self._victims,
            reason="drain complete",
        )

    def abandon_drain(self, reason="load returned"):
        """Cancel an in-progress drain (e.g. traffic came back)."""
        if self.state != DRAINING:
            return
        self.state = IDLE
        self._victims = ()
        self._target = None
        self._cooldown = self.cooldown_windows
        self.history.append((self._window, "abandon-drain", reason))

    def resize_committed(self, new_world):
        """An epoch committed (grow or shrink, ours or not).

        A shrink cascade retires one rank per step-plan, so a single
        scale-down decision produces several epochs; the machine stays
        in PENDING_SHRINK until the world reaches the target, then
        resets to IDLE and arms the cooldown so back-to-back resizes
        can't flap."""
        new_world = int(new_world)
        self.history.append((self._window, "commit", f"world={new_world}"))
        if self.state == PENDING_SHRINK and self._target is not None:
            self._victims = tuple(v for v in self._victims if v < new_world)
            if new_world > self._target:
                return  # mid-cascade; more victims still to retire
        self.state = IDLE
        self._victims = ()
        self._target = None
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown = self.cooldown_windows

    @property
    def victims(self):
        return self._victims

    def _decide(self, action, target, victims=(), reason=""):
        if action != "none":
            self.history.append((self._window, action, reason))
        return AutoscaleDecision(action, target, victims=victims, reason=reason)


# -- grow-request file channel ---------------------------------------
#
# The engine cannot fork processes; launch.py can.  A grow request is a
# single JSON object written atomically (tempfile + rename) to the path
# in T4J_AUTOSCALE_REQ.  The launcher polls it from the elastic loop,
# spawns the T4J_REJOIN=1 expansion rank, and clears the file.  Stale
# requests (older epoch than the launcher has seen) are dropped.


def post_request(path, want_world, epoch, reason=""):
    """Atomically publish a grow request for the launcher to act on."""
    req = {
        "format": _REQ_FORMAT,
        "want_world": int(want_world),
        "epoch": int(epoch),
        "reason": str(reason),
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".t4j-scale-", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(req, f)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return req


def read_request(path):
    """Read and validate a pending grow request; None if absent/bad.

    A malformed file is treated as no-request (and left for
    :func:`clear_request`) — the launcher must never crash because a
    half-written or foreign file appeared at the path.
    """
    try:
        with open(path, "r") as f:
            obj = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(obj, dict) or obj.get("format") != _REQ_FORMAT:
        return None
    try:
        want = int(obj["want_world"])
        epoch = int(obj["epoch"])
    except (KeyError, TypeError, ValueError):
        return None
    return {
        "want_world": want,
        "epoch": epoch,
        "reason": str(obj.get("reason", "")),
    }


def clear_request(path):
    """Remove a consumed (or rejected) request file."""
    try:
        os.unlink(path)
    except OSError:
        pass
