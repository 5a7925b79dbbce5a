"""Slot-based continuous-batching scheduler (docs/serving.md).

The port's copy of ``mpi4jax_tpu/serving/scheduler.py``.

The KV cache is a fixed pool of ``max_batch`` *slots*, each a
``max_len``-position budget.  Decode runs every ACTIVE slot one
position per engine step; a free slot can be filled by a *prefill*
(one causal pass over a queued request's prompt) **while the other
slots keep decoding** — that interleaving is the whole point of
continuous batching: a long generation never blocks a short request
behind it, and the batch stays as full as the queue allows.

This module is the pure state machine: which request enters which slot
when, where each slot's write position is, and when a request
completes.  It never touches a tensor or the clock — the engine supplies
time and executes the plans; tests drive it step by step.

Invariant (checked by :meth:`SlotScheduler.check_accounting`): every
submitted request is in exactly one of queued / holding-a-slot /
done / shed, with each elastic *reissue* (a resize wiped a slot's
state and the request went back to the queue) counted as a fresh
submission balanced by the ``reissued`` counter:

    queued + in_slots + done + shed + reissued == submitted

A violated invariant raises :class:`SchedulerError` instead of
silently leaking a slot — a leaked slot is capacity the admission
controller thinks it has.
"""

from collections import deque

from .request import Request, RequestState

__all__ = ["FollowerMirror", "SchedulerError", "SlotScheduler",
           "StepPlan", "slots_digest"]


def slots_digest(rows):
    """FNV-1a digest over slot-table rows ``(rid_or_-1, pos, end)`` —
    THE shared digest between the leader's :class:`SlotScheduler` and
    a follower's :class:`FollowerMirror`, carried in every step plan
    so state drift fails attributably (:mod:`.plan`)."""
    acc = 2166136261
    for i, (rid, pos, end) in enumerate(rows):
        for v in (i, rid, pos, end):
            acc ^= (v + 1) & 0xFFFFFFFF
            acc = (acc * 16777619) & 0xFFFFFFFF
    return acc


class SchedulerError(RuntimeError):
    """A scheduler invariant was violated (slot leak, double admit,
    stepping an empty batch...)."""


class StepPlan:
    """One engine step, as decided by the scheduler: which queued
    requests enter which free slots (``admissions``: list of
    ``(slot, Request)``) and which slots decode this step
    (``decode_slots``: sorted slot indices, with ``positions[i]`` the
    KV write position of ``decode_slots[i]``)."""

    __slots__ = ("step", "admissions", "decode_slots", "positions")

    def __init__(self, step, admissions, decode_slots, positions):
        self.step = step
        self.admissions = admissions
        self.decode_slots = decode_slots
        self.positions = positions

    @property
    def empty(self):
        return not self.admissions and not self.decode_slots

    def __repr__(self):
        return (
            f"StepPlan(step={self.step}, "
            f"admit={[(s, r.rid) for s, r in self.admissions]}, "
            f"decode={list(zip(self.decode_slots, self.positions))})"
        )


class _Slot:
    __slots__ = ("req", "pos", "end")

    def __init__(self):
        self.req = None   # Request holding this slot (None = free)
        self.pos = 0      # next KV write position (absolute)
        self.end = 0      # stop when pos reaches this (exclusive)


class SlotScheduler:
    """Continuous-batching slot allocator + step planner.

    ``max_prefill_per_step`` bounds how many prefills one step admits
    (each prefill is a full causal pass — admitting many at once would
    stall the in-flight decodes it shares the step with; 1 is the
    classic continuous-batching choice).
    """

    def __init__(self, max_batch, max_len, max_prefill_per_step=1):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_len < 2:
            raise ValueError(
                f"max_len must be >= 2 (a prompt position plus at "
                f"least one generated token), got {max_len}"
            )
        if max_prefill_per_step < 1:
            raise ValueError("max_prefill_per_step must be >= 1")
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.max_prefill_per_step = int(max_prefill_per_step)
        self._slots = [_Slot() for _ in range(self.max_batch)]
        self._queue = deque()
        self._step = 0
        self._hold = False  # admissions held (autoscale drain)
        # accounting
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.reissued = 0
        self.finished = []  # completed Requests, engine drains this

    # ---- queue side ------------------------------------------------------

    def submit(self, req, now_ms):
        """Enqueue an (admission-approved) request."""
        if req.state != RequestState.QUEUED:
            raise SchedulerError(
                f"submit of request {req.rid} in state {req.state}"
            )
        if req.prompt_len >= self.max_len:
            raise SchedulerError(
                f"request {req.rid}: prompt length {req.prompt_len} "
                f"leaves no room to generate within max_len="
                f"{self.max_len} (admission should have shed it)"
            )
        self.submitted += 1
        self._queue.append(req)

    def shed_request(self, req, now_ms, reason):
        """Mark a request shed (admission refusal, or a hopeless
        deadline discovered while queued) and drop it from the queue if
        it is there.  Sheds are COUNTED — a controller that quietly
        drops work would fake its SLO numbers (docs/serving.md)."""
        if req.state != RequestState.QUEUED:
            raise SchedulerError(
                f"shed of request {req.rid} in state {req.state} "
                "(in-slot requests run to completion)"
            )
        was_submitted = req in self._queue
        if was_submitted:
            self._queue.remove(req)
        req.state = RequestState.SHED
        req.shed_reason = str(reason)
        req.done_ms = float(now_ms)
        if was_submitted:
            self.shed += 1
        else:
            # shed at the door (never submitted): count it here so the
            # accounting invariant covers both shed paths
            self.submitted += 1
            self.shed += 1

    def queue_depth(self):
        return len(self._queue)

    def queued(self):
        """The queued requests, arrival order (read-only view)."""
        return tuple(self._queue)

    # ---- slot side -------------------------------------------------------

    def free_slots(self):
        return [i for i, s in enumerate(self._slots) if s.req is None]

    def occupancy(self):
        """Slots currently held (admitted or decoding)."""
        return self.max_batch - len(self.free_slots())

    def active_requests(self):
        return tuple(
            s.req for s in self._slots if s.req is not None
        )

    # ---- planning --------------------------------------------------------

    def plan_step(self, now_ms):
        """Decide one engine step: admit queue-head requests into free
        slots (bounded by ``max_prefill_per_step``) and decode every
        slot that is past its prefill.  Admitted requests transition to
        ADMITTED here; the engine reports their prefill via
        :meth:`prefill_done` (same step — prefill yields the first
        generated token)."""
        admissions = []
        free = [] if self._hold else self.free_slots()
        while (self._queue and free
               and len(admissions) < self.max_prefill_per_step):
            req = self._queue.popleft()
            slot = free.pop(0)
            s = self._slots[slot]
            s.req = req
            s.pos = req.prompt_len
            # effective continuation: clamped by the slot budget.
            # pos runs prompt_len .. end-1; prefill emits token at
            # index prompt_len, each decode step one more, and the
            # LAST token needs no KV write, so end = prompt_len +
            # max_new - 1 decode positions (bounded by max_len - 1:
            # position max_len-1 is the last writable one).
            s.end = min(
                req.prompt_len + req.max_new - 1, self.max_len - 1
            )
            req.state = RequestState.ADMITTED
            req.slot = slot
            req.last_slot = slot
            req.admitted_ms = float(now_ms)
            admissions.append((slot, req))
        decode_slots = []
        positions = []
        for i, s in enumerate(self._slots):
            if s.req is not None and s.req.state == RequestState.ACTIVE:
                decode_slots.append(i)
                positions.append(s.pos)
        plan = StepPlan(self._step, admissions, decode_slots, positions)
        self._step += 1
        return plan

    # ---- execution reports ----------------------------------------------

    def prefill_done(self, slot, now_ms):
        """The engine finished the prefill for ``slot``: the request
        got its first generated token and joins decode from the next
        step on (or completes right here when it asked for a single
        token / its prompt fills the budget)."""
        s = self._slots[slot]
        req = s.req
        if req is None or req.state != RequestState.ADMITTED:
            raise SchedulerError(
                f"prefill_done on slot {slot} in state "
                f"{req.state if req else 'free'}"
            )
        req.state = RequestState.ACTIVE
        req.generated = 1
        req.first_token_ms = float(now_ms)
        if s.pos >= s.end:
            self._complete(slot, now_ms)

    def step_done(self, plan, now_ms):
        """The engine executed ``plan``'s decode: every decoded slot
        advanced one position and emitted one token.  Completions free
        their slots; the freed capacity is visible to the very next
        :meth:`plan_step`."""
        for slot in plan.decode_slots:
            s = self._slots[slot]
            req = s.req
            if req is None or req.state != RequestState.ACTIVE:
                raise SchedulerError(
                    f"step_done on slot {slot} in state "
                    f"{req.state if req else 'free'}"
                )
            s.pos += 1
            req.generated += 1
            if s.pos >= s.end:
                self._complete(slot, now_ms)

    def _complete(self, slot, now_ms):
        s = self._slots[slot]
        req = s.req
        req.state = RequestState.DONE
        req.done_ms = float(now_ms)
        req.slot = None
        s.req = None
        s.pos = s.end = 0
        self.completed += 1
        self.finished.append(req)

    # ---- elastic epoch survival -----------------------------------------

    def hold_admissions(self, hold=True):
        """Stop (or resume) admitting queued requests into free slots.
        Used by the autoscaler's drain phase: in-flight requests run to
        completion while the batch empties, and by the resize window
        itself (no request should enter a slot the next epoch will not
        remember)."""
        self._hold = bool(hold)

    @property
    def admissions_held(self):
        return self._hold

    def clamp_completions(self, max_remaining):
        """Clamp every occupied slot to at most ``max_remaining`` more
        generated tokens — the autoscaler's drain bound.  Requests
        still complete through the normal :meth:`step_done` path (DONE,
        not shed; ``generated`` reflects what they actually got), the
        drain just finishes within a known number of steps instead of
        waiting out the longest continuation.  Returns the number of
        slots whose horizon actually moved."""
        if max_remaining < 0:
            raise ValueError(
                f"max_remaining must be >= 0, got {max_remaining}"
            )
        clamped = 0
        for s in self._slots:
            if s.req is None:
                continue
            new_end = s.pos + int(max_remaining)
            if new_end < s.end:
                s.end = new_end
                clamped += 1
        return clamped

    def snapshot_inflight(self):
        """The requests currently holding slots, as ``(slot, Request)``
        pairs — the leader's pre-resize snapshot (engine epoch
        survival) and the promotion handoff's source of truth."""
        return [
            (i, s.req)
            for i, s in enumerate(self._slots)
            if s.req is not None
        ]

    def reissue_inflight(self, now_ms):
        """A resize wiped the KV/slot state: return every in-slot
        request to the FRONT of the queue (they were admitted first;
        they re-enter first) and free all slots.

        Each reissued request remembers how many tokens it had already
        emitted (``req.emitted``) so the engine's dedupe-on-rid+position
        contract holds: re-generation is deterministic, and only tokens
        past the reissue point are emitted again.  Accounting-wise a
        reissue is a fresh submission balanced by ``reissued`` — see
        :meth:`check_accounting`.  Returns the reissued requests in
        re-queue order."""
        lost = self.snapshot_inflight()
        out = []
        # Reverse so appendleft preserves slot order at the queue head.
        for slot, req in reversed(lost):
            s = self._slots[slot]
            req.emitted = max(req.emitted, req.generated)
            req.reissues += 1
            req.state = RequestState.QUEUED
            req.slot = None
            req.generated = 0
            s.req = None
            s.pos = s.end = 0
            self._queue.appendleft(req)
            self.submitted += 1
            self.reissued += 1
            out.append(req)
        out.reverse()
        return out

    # ---- lifecycle -------------------------------------------------------

    def idle(self):
        """Nothing queued, nothing in a slot — safe to stop stepping."""
        return not self._queue and all(
            s.req is None for s in self._slots
        )

    def check_accounting(self):
        """Raise :class:`SchedulerError` unless every submitted request
        is queued, in a slot, done, or shed — with each elastic reissue
        counted as a fresh submission balanced by ``reissued`` — the
        request-leak check shutdown runs (tests/proc/
        test_serving_proc.py pins it; tools/autoscale_smoke.py asserts
        it on every rank at every epoch)."""
        in_slots = sum(1 for s in self._slots if s.req is not None)
        total = (len(self._queue) + in_slots + self.completed
                 + self.shed + self.reissued)
        if total != self.submitted:
            raise SchedulerError(
                f"request leak: submitted={self.submitted} but "
                f"queued={len(self._queue)} + in_slots={in_slots} + "
                f"done={self.completed} + shed={self.shed} + "
                f"reissued={self.reissued} = {total}"
            )
        return True

    def state_digest(self):
        """Slot-table digest (:func:`slots_digest`) — cross-rank step
        plans carry it so a follower whose mirrored state drifted
        raises attributably instead of decoding garbage
        (:mod:`.plan`)."""
        return slots_digest(
            (-1 if s.req is None else s.req.rid, s.pos, s.end)
            for s in self._slots
        )


class FollowerMirror:
    """A follower rank's slot-table mirror, fed ONLY by decoded step
    plans (docs/serving.md "the control plane").

    Followers never see the queue or the admission decisions — they
    execute what the leader broadcast.  The mirror tracks exactly the
    slot rows the digest covers, so :meth:`state_digest` must match
    the leader's pre-plan digest every step; :meth:`apply` returns
    the slots freed by completions this step (the engine clears their
    output rows)."""

    def __init__(self, max_batch, max_len):
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        # slot -> [rid, pos, end] (absent = free)
        self._rows = {}
        self.completed = 0

    def state_digest(self):
        return slots_digest(
            (self._rows[i][0], self._rows[i][1], self._rows[i][2])
            if i in self._rows else (-1, 0, 0)
            for i in range(self.max_batch)
        )

    def apply(self, decoded):
        """Apply a :func:`.plan.decode_plan` dict: admissions fill
        slots, decodes advance positions, completions free.  Returns
        ``(admitted, finished)`` — ``admitted`` the list of
        ``(slot, rid, prompt, max_new)`` to prefill, ``finished`` the
        ``(slot, rid)`` pairs whose requests completed this step."""
        finished = []
        admitted = []
        for (slot, rid, p_len, max_new, _dl), prompt in zip(
                decoded["admissions"], decoded["prompts"]):
            if slot in self._rows:
                raise SchedulerError(
                    f"plan step {decoded['step']}: admission of "
                    f"request {rid} into occupied slot {slot}"
                )
            end = min(p_len + max_new - 1, self.max_len - 1)
            self._rows[slot] = [rid, p_len, end]
            admitted.append((slot, rid, prompt, max_new))
        for slot, pos in zip(decoded["decode_slots"],
                             decoded["positions"]):
            row = self._rows.get(slot)
            if row is None or row[1] != pos:
                raise SchedulerError(
                    f"plan step {decoded['step']}: decode of slot "
                    f"{slot} at pos {pos} but mirror has "
                    f"{row if row else 'free'}"
                )
            row[1] += 1
            if row[1] >= row[2]:
                finished.append((slot, row[0]))
                del self._rows[slot]
                self.completed += 1
        return admitted, finished

    def prefill_done(self, slot):
        """Prefill-instant completion check (a request whose prompt
        fills its budget completes without any decode step — the
        leader's :meth:`SlotScheduler.prefill_done` path).  Returns
        the ``(slot, rid)`` pair if the request completed."""
        row = self._rows.get(slot)
        if row is None:
            raise SchedulerError(f"prefill_done on free slot {slot}")
        if row[1] >= row[2]:
            del self._rows[slot]
            self.completed += 1
            return (slot, row[0])
        return None

    def occupancy(self):
        return len(self._rows)

    def idle(self):
        return not self._rows

    def rows(self):
        """Occupied slots as ``{slot: (rid, pos, end)}`` — read-only
        copy for promotion (a follower elected leader after rank 0
        died rebuilds a :class:`SlotScheduler` from its mirror plus the
        per-rid requests it retained) and for rebuild verification."""
        return {i: tuple(r) for i, r in self._rows.items()}

    def reset(self):
        """Drop every mirrored slot (resize wiped the KV state; the
        new epoch's plans re-admit from scratch)."""
        self._rows.clear()
