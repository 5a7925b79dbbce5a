"""Cross-rank step-plan codec (docs/serving.md "the control plane").

The port's copy of ``mpi4jax_tpu/serving/plan.py``.

Scheduling is rank 0's job — admission reads live telemetry that other
ranks legitimately see differently, so the plan CANNOT be recomputed
per rank (divergent plans would issue mismatched collectives and
deadlock; the same uniformity argument as tuning's rank-0 knob
broadcast).  Rank 0 encodes each step's decisions into one fixed-size
``int64`` vector, broadcast over the existing ``host_bcast`` control
plane; followers decode and execute.

Layout (``plan_words(max_batch, p_max)`` words total)::

    [0] MAGIC            [1] step index        [2] flags
    [3] n_admissions     [4] n_decode          [5] scheduler digest
    [6 .. 6+5*max_batch) admission entries (slot, rid, p_len,
                         max_new, deadline_ms or -1), -1-padded
    [.. +max_batch)      decode slot indices, -1-padded
    [.. +max_batch)      decode positions,    -1-padded
    [.. +max_batch*p_max) admitted prompts' token ids, row per
                         admission slot order, -1-padded

``flags`` bit 0 is *stop* (followers leave the serve loop after this
step); bits 1+ carry ``retire_rank + 1`` — the autoscaler's
drain-then-shrink handshake: a plan with ``retire == r`` tells rank
``r`` (and only rank ``r``) to exit cleanly after executing the step,
which the launcher's elastic loop observes as a scale-down.  Plans
recorded before this field existed have flags 0/1 and decode with
``retire is None`` — old streams stay replayable.

The ``scheduler digest`` is the leader's
:meth:`SlotScheduler.state_digest` BEFORE applying the plan: a
follower whose mirrored state drifted raises :class:`PlanError`
naming the step instead of decoding garbage with a straight face
(the analysis subsystem's fingerprint philosophy).
"""

import json
from dataclasses import dataclass

from .request import Request

__all__ = ["MAGIC", "Finding", "PlanError", "append_plan_stream",
           "decode_plan", "encode_plan", "follower_request", "load_plan_stream",
           "plan_stream_schedule", "plan_words", "rebuild_mirror",
           "replay_stream", "save_plan_stream"]

MAGIC = 0x74346A53  # "t4jS"

_HEADER = 6


@dataclass
class Finding:
    """One rule violation, with its stable ID and source anchor: the
    fields of the JAX package's ``analysis.contracts.Finding`` (the
    port's analysis package comes with ROADMAP Queue 1 item 11)."""

    rule: str
    message: str
    src_info: str = ""
    event_seq: int | None = None

    def __str__(self):
        loc = f" [{self.src_info}]" if self.src_info else ""
        return f"{self.rule}: {self.message}{loc}"


class PlanError(RuntimeError):
    """A step plan failed validation (bad magic, truncated vector,
    or a leader/follower scheduler-state divergence)."""


def plan_words(max_batch, p_max):
    """Vector length in int64 words for a ``max_batch``-slot engine
    with prompts bounded by ``p_max`` tokens."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if p_max < 1:
        raise ValueError(f"p_max must be >= 1, got {p_max}")
    return _HEADER + 5 * max_batch + 2 * max_batch + max_batch * p_max


def encode_plan(plan, max_batch, p_max, digest, stop=False,
                retire=None):
    """Scheduler :class:`~.scheduler.StepPlan` -> list of ints.

    ``digest`` is the leader scheduler's pre-plan state digest.  A
    ``stop=True`` plan tells followers to leave the serve loop after
    this step (its admissions/decode lists are usually empty).
    ``retire`` names one rank that should exit cleanly after this step
    — the autoscaler's drained-victim handoff."""
    n_admit = len(plan.admissions)
    n_decode = len(plan.decode_slots)
    if n_admit > max_batch or n_decode > max_batch:
        raise PlanError(
            f"plan exceeds max_batch={max_batch}: "
            f"{n_admit} admissions, {n_decode} decodes"
        )
    flags = 1 if stop else 0
    if retire is not None:
        if int(retire) < 0:
            raise PlanError(f"retire rank must be >= 0, got {retire}")
        flags |= (int(retire) + 1) << 1
    vec = [MAGIC, int(plan.step), flags, n_admit, n_decode,
           int(digest)]
    for slot, req in plan.admissions:
        if req.prompt_len > p_max:
            raise PlanError(
                f"request {req.rid}: prompt length {req.prompt_len} "
                f"exceeds the plan payload bound p_max={p_max}"
            )
        dl = -1 if req.deadline_ms is None else int(req.deadline_ms)
        vec += [int(slot), int(req.rid), req.prompt_len,
                int(req.max_new), dl]
    vec += [-1] * (5 * (max_batch - n_admit))
    vec += [int(s) for s in plan.decode_slots]
    vec += [-1] * (max_batch - n_decode)
    vec += [int(p) for p in plan.positions]
    vec += [-1] * (max_batch - n_decode)
    for _slot, req in plan.admissions:
        vec += list(req.prompt) + [-1] * (p_max - req.prompt_len)
    vec += [-1] * (p_max * (max_batch - n_admit))
    assert len(vec) == plan_words(max_batch, p_max)
    return vec


def decode_plan(vec, max_batch, p_max, expect_digest=None):
    """Int vector -> dict with keys ``step``, ``stop``, ``retire``
    (rank told to exit after this step, or ``None``), ``admissions``
    (list of ``(slot, rid, p_len, max_new, deadline_ms-or-None)``),
    ``prompts`` (token tuple per admission), ``decode_slots``,
    ``positions``.

    ``expect_digest`` is the follower's own mirrored-scheduler digest;
    a mismatch raises :class:`PlanError` naming the step (state drift
    must fail attributably, not decode garbage)."""
    vec = [int(v) for v in vec]
    if len(vec) != plan_words(max_batch, p_max):
        raise PlanError(
            f"plan vector has {len(vec)} words, want "
            f"{plan_words(max_batch, p_max)} for "
            f"max_batch={max_batch}, p_max={p_max}"
        )
    if vec[0] != MAGIC:
        raise PlanError(f"bad plan magic {vec[0]:#x} (want {MAGIC:#x})")
    step, flags, n_admit, n_decode, digest = vec[1:_HEADER]
    if not 0 <= n_admit <= max_batch or not 0 <= n_decode <= max_batch:
        raise PlanError(
            f"plan step {step}: counts out of range "
            f"(admit={n_admit}, decode={n_decode}, "
            f"max_batch={max_batch})"
        )
    if expect_digest is not None and digest != int(expect_digest):
        raise PlanError(
            f"scheduler state diverged at step {step}: leader digest "
            f"{digest:#x} != local {int(expect_digest):#x} — a "
            "follower missed or misapplied an earlier plan"
        )
    admissions = []
    base = _HEADER
    for i in range(n_admit):
        slot, rid, p_len, max_new, dl = vec[base + 5 * i:base + 5 * i + 5]
        admissions.append(
            (slot, rid, p_len, max_new, None if dl < 0 else float(dl))
        )
    base += 5 * max_batch
    decode_slots = vec[base:base + n_decode]
    base += max_batch
    positions = vec[base:base + n_decode]
    base += max_batch
    prompts = []
    for i, (_s, _r, p_len, _m, _d) in enumerate(admissions):
        row = vec[base + i * p_max:base + i * p_max + p_len]
        if len(row) != p_len or any(t < 0 for t in row):
            raise PlanError(
                f"plan step {step}: truncated prompt payload for "
                f"admission {i}"
            )
        prompts.append(tuple(row))
    retire = (flags >> 1) - 1
    return {
        "step": step,
        "stop": bool(flags & 1),
        "retire": None if retire < 0 else retire,
        "admissions": admissions,
        "prompts": prompts,
        "decode_slots": decode_slots,
        "positions": positions,
        "digest": digest,
    }


def follower_request(rid, prompt_tokens, max_new, arrival_ms=0.0,
                     deadline_ms=None):
    """Rebuild a :class:`Request` on a follower rank from plan fields +
    the broadcast prompt payload (arrival time is leader-side state the
    follower doesn't need; it defaults inert)."""
    return Request(rid, prompt_tokens, max_new, arrival_ms,
                   deadline_ms)


# ---------------------------------------------------------- plan streams
#
# A recorded plan stream makes follower-drift bugs reproducible offline:
# the engine's leader appends every broadcast vector to a jsonl file
# (``ServingEngine(plan_log=...)`` / ``T4J_PLAN_LOG``), and
# ``t4j-verify --plan-stream`` replays it through a fresh
# :class:`~.scheduler.FollowerMirror` — exactly the code path a live
# follower runs — so a digest mismatch reproduces on a laptop with no
# cluster, no model, and no model framework.

_STREAM_FORMAT = "t4j-plan-stream-v1"


def save_plan_stream(path, vecs, max_batch, p_max, world=None):
    """Write a full plan stream: one header line + one line per step."""
    with open(path, "w") as fh:
        fh.write(json.dumps({
            "format": _STREAM_FORMAT, "max_batch": int(max_batch),
            "p_max": int(p_max), "world": world,
        }) + "\n")
        for vec in vecs:
            fh.write(json.dumps({"vec": [int(v) for v in vec]}) + "\n")


def append_plan_stream(path, vec, max_batch, p_max, world=None):
    """Append one step's vector, writing the header first when the file
    is new/empty (the engine calls this once per ``_leader_step``)."""
    import os

    need_header = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a") as fh:
        if need_header:
            fh.write(json.dumps({
                "format": _STREAM_FORMAT, "max_batch": int(max_batch),
                "p_max": int(p_max), "world": world,
            }) + "\n")
        fh.write(json.dumps({"vec": [int(v) for v in vec]}) + "\n")


def load_plan_stream(path):
    """Read a stream back as ``(meta, [vec, ...])``; raises
    :class:`PlanError` on a malformed file."""
    meta = None
    vecs = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except ValueError as exc:
                raise PlanError(f"{path}:{ln}: not JSON: {exc}")
            if meta is None:
                if doc.get("format") != _STREAM_FORMAT:
                    raise PlanError(
                        f"{path}: not a {_STREAM_FORMAT} stream "
                        f"(format={doc.get('format')!r})"
                    )
                meta = doc
            else:
                vec = doc.get("vec")
                if not isinstance(vec, list):
                    raise PlanError(f"{path}:{ln}: missing 'vec' list")
                vecs.append(vec)
    if meta is None:
        raise PlanError(f"{path}: empty plan stream")
    return meta, vecs


def replay_stream(meta, vecs, source="<plan-stream>"):
    """Replay a recorded stream through a fresh follower mirror.

    Runs the literal follower code path (``decode_plan`` with the
    mirror's own digest as ``expect_digest``, then
    :meth:`FollowerMirror.apply`), so any drift a live follower would
    hit reproduces here.  Returns a list of
    :class:`Finding` — drift maps to
    rule T4J007 (cross-rank schedule divergence: the leader's plan and
    the follower's mirrored state ARE the two diverging schedules).
    """
    from .scheduler import FollowerMirror, SchedulerError

    max_batch = int(meta["max_batch"])
    p_max = int(meta["p_max"])
    mirror = FollowerMirror(max_batch, p_max)
    findings = []
    for i, vec in enumerate(vecs):
        anchor = f"{source}:step {i}"
        try:
            decoded = decode_plan(
                vec, max_batch, p_max,
                expect_digest=mirror.state_digest(),
            )
        except PlanError as exc:
            findings.append(Finding(
                rule="T4J007",
                message=(
                    f"plan-stream replay: follower mirror rejects the "
                    f"leader's plan at stream entry {i}: {exc}"
                ),
                src_info=anchor,
            ))
            break
        try:
            admitted, _finished = mirror.apply(decoded)
            for slot, _rid, _prompt, _max_new in admitted:
                mirror.prefill_done(slot)
        except SchedulerError as exc:
            findings.append(Finding(
                rule="T4J007",
                message=(
                    f"plan-stream replay: mirrored scheduler state "
                    f"diverged applying stream entry {i} "
                    f"(plan step {decoded['step']}): {exc}"
                ),
                src_info=anchor,
            ))
            break
        if decoded["stop"]:
            break
    return findings


def rebuild_mirror(meta, vecs, source="<plan-stream>",
                   expect_digest=None):
    """Rebuild a live :class:`~.scheduler.FollowerMirror` from a
    recorded plan stream — the late joiner's bootstrap (docs/
    failure-semantics.md): an expansion rank admitted into a serving
    epoch replays the leader's plan log through the literal follower
    code path and starts serving only if every step's digest agreed.

    Unlike :func:`replay_stream` (offline triage, returns Findings)
    this RAISES :class:`PlanError` on any drift — a joiner with a
    divergent mirror must not serve a single step.  Returns
    ``(mirror, requests)`` where ``requests`` maps rid ->
    :class:`Request` for every request still holding a slot (what the
    joiner needs to decode their remaining tokens, and what a promoted
    leader reissues).  ``expect_digest`` optionally pins the final
    mirror digest to the leader's current one (fetched out-of-band) —
    the digest-agreement gate before the first served step."""
    from .scheduler import FollowerMirror, SchedulerError

    max_batch = int(meta["max_batch"])
    p_max = int(meta["p_max"])
    mirror = FollowerMirror(max_batch, p_max)
    requests = {}
    for i, vec in enumerate(vecs):
        try:
            decoded = decode_plan(
                vec, max_batch, p_max,
                expect_digest=mirror.state_digest(),
            )
            admitted, finished = mirror.apply(decoded)
        except (PlanError, SchedulerError) as exc:
            raise PlanError(
                f"{source}: mirror rebuild diverged at stream entry "
                f"{i}: {exc}"
            )
        for slot, rid, prompt, max_new in admitted:
            dl = next(
                d for s, r, _p, _m, d in decoded["admissions"]
                if r == rid
            )
            requests[rid] = follower_request(rid, prompt, max_new,
                                             deadline_ms=dl)
            done = mirror.prefill_done(slot)
            if done is not None:
                finished = list(finished) + [done]
        for _slot, rid in finished:
            requests.pop(rid, None)
        if decoded["stop"]:
            break
    alive = {row[0] for row in mirror.rows().values()}
    requests = {rid: req for rid, req in requests.items()
                if rid in alive}
    if expect_digest is not None:
        got = mirror.state_digest()
        if got != int(expect_digest):
            raise PlanError(
                f"{source}: rebuilt mirror digest {got:#x} != leader's "
                f"{int(expect_digest):#x} — plan log is stale or "
                "truncated; joiner must not serve"
            )
    return mirror, requests


def plan_stream_schedule(meta, vecs, source="<plan-stream>"):
    """Synthesize per-rank simulator schedules from a recorded stream.

    Every step plan is one ``host_bcast`` of the fixed-size vector from
    rank 0 — a root collective on the serving control comm, identical
    on every rank.  Feeding these through the analysis simulator
    (``t4j-verify --plan-stream``) checks the *transport* shape of the
    control plane — a world-size disagreement or a truncated stream on
    one rank shows up as a collective-slot mismatch — complementing
    :func:`replay_stream`'s state-level drift check.  Returns
    ``[rank0_events, rank1_events, ...]`` as plain dicts.
    """
    world = int(meta.get("world") or 2)
    max_batch = int(meta["max_batch"])
    p_max = int(meta["p_max"])
    words = plan_words(max_batch, p_max)
    schedules = []
    for rank in range(world):
        events = []
        for i, _vec in enumerate(vecs):
            events.append({
                "kind": "bcast",
                "comm_key": "serving-ctrl",
                "comm_size": world,
                "comm_ranks": list(range(world)),
                "dtype": "int64",
                "shape": [words],
                "reduce_op": "",
                "root": 0,
                "rank": rank,
                "tag": None,
                "src_info": f"{source}:step {i}",
            })
        schedules.append(events)
    return schedules
