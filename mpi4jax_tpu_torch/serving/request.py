"""Request lifecycle for the serving subsystem (docs/serving.md).

The port's copy of ``mpi4jax_tpu/serving/request.py``.

A request is one prompt → one bounded continuation.  Its state walks

    QUEUED → ADMITTED → ACTIVE → DONE
       └──────────→ SHED   (admission refused, or deadline hopeless)

with every transition stamped in caller-supplied milliseconds (time is
injected, never read — the state machines stay deterministic under
test).  Import-free of torch, like the rest of the pure core.
"""

__all__ = ["Request", "RequestState"]


class RequestState:
    """String-valued request states (compared by identity-safe str)."""

    QUEUED = "queued"
    ADMITTED = "admitted"  # slot assigned, prefill pending/running
    ACTIVE = "active"      # decoding in a slot
    DONE = "done"
    SHED = "shed"

    ALL = (QUEUED, ADMITTED, ACTIVE, DONE, SHED)


class Request:
    """One inference request.

    ``prompt`` is a tuple of token ids (the pure core never interprets
    them; the engine feeds them to the model).  ``max_new`` is the
    requested continuation length; the effective value is clamped by
    the engine's ``max_len`` budget at admission.  ``deadline_ms`` is
    absolute (arrival + SLO) or ``None`` when the job has no SLO.
    """

    __slots__ = (
        "rid", "prompt", "max_new", "arrival_ms", "deadline_ms",
        "state", "slot", "last_slot", "generated", "admitted_ms",
        "first_token_ms", "done_ms", "shed_reason",
        "reissues", "emitted",
    )

    def __init__(self, rid, prompt, max_new, arrival_ms,
                 deadline_ms=None):
        if max_new < 1:
            raise ValueError(
                f"request {rid}: max_new must be >= 1, got {max_new}"
            )
        if len(prompt) < 1:
            raise ValueError(f"request {rid}: empty prompt")
        self.rid = int(rid)
        self.prompt = tuple(int(t) for t in prompt)
        self.max_new = int(max_new)
        self.arrival_ms = float(arrival_ms)
        self.deadline_ms = (
            None if deadline_ms is None else float(deadline_ms)
        )
        self.state = RequestState.QUEUED
        self.slot = None
        self.last_slot = None  # survives completion (the engine's
        # harvest reads the freed slot's token buffer the same step)
        self.generated = 0
        self.admitted_ms = None
        self.first_token_ms = None
        self.done_ms = None
        self.shed_reason = None
        # elastic epoch survival (docs/failure-semantics.md): how many
        # times this request was reissued after a resize wiped its slot
        # state, and how many leading tokens had already been emitted
        # to the client before the loss.  Re-generation is
        # deterministic (greedy argmax), so the engine re-runs the
        # request from its prompt but only emits tokens at index >=
        # ``emitted`` — the rid+position dedupe contract: completed
        # tokens are never re-emitted.
        self.reissues = 0
        self.emitted = 0

    @property
    def prompt_len(self):
        return len(self.prompt)

    def latency_ms(self):
        """End-to-end latency (arrival → completion), or ``None`` while
        in flight."""
        if self.done_ms is None:
            return None
        return self.done_ms - self.arrival_ms

    def within_slo(self):
        """Did the request complete before its deadline?  ``True`` for
        completed requests without a deadline; ``False`` for shed or
        unfinished ones (a shed request by definition missed the
        service it asked for — the honest accounting docs/serving.md
        insists on)."""
        if self.state != RequestState.DONE:
            return False
        if self.deadline_ms is None:
            return True
        return self.done_ms <= self.deadline_ms

    def __repr__(self):
        return (
            f"Request(rid={self.rid}, p={self.prompt_len}, "
            f"new={self.generated}/{self.max_new}, {self.state}"
            + (f", slot={self.slot}" if self.slot is not None else "")
            + ")"
        )
