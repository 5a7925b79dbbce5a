"""Step markers: the program's own iteration boundaries.

The port's copy of ``mpi4jax_tpu/ops/step.py``.  Each boundary goes into
the native bridge's telemetry ring (``t4j_annotate_step``: phase 1
begin, 2 end, with the step's index) when the bridge is loaded in this
process, so that every rank's step k is the same iteration of the
program.  The JAX package also writes a named row on its Python
recorder lane, which carries the step's name; the port's recorder comes
with the telemetry package (ROADMAP Queue 1 item 10), so here the name
is only kept in :func:`current_step`.

Two idioms::

    for batch in data:                      # marker style
        m.annotate_step("train")            # closes the previous step
        loss = train_step(state, batch)
    m.end_step()                            # closes the last one

    for batch in data:                      # scope style
        with m.step_scope("train"):
            loss = train_step(state, batch)

Steps never nest: ``annotate_step`` closes the open step, and a
``step_scope`` inside another closes the outer one first.  A marker
never fails the step it marks.
"""

import threading
from contextlib import contextmanager

__all__ = ["annotate_step", "end_step", "step_scope", "current_step"]

_PHASE_BEGIN, _PHASE_END = 1, 2

_state = {
    "lock": threading.Lock(),
    "index": -1,   # the last step index given out
    "open": None,  # (index, name) of the open step
}


def _emit(index, phase, name):
    del name  # the recorder lane that carries it comes with item 10
    try:
        from mpi4jax_tpu_torch.native import runtime

        runtime.annotate_step(index, phase)
    except Exception:  # noqa: BLE001 (a marker never fails its step)
        pass


def annotate_step(name="step"):
    """Mark the start of a new step: close the open step (if any) and
    open the next.  Returns the new step's index (0-based, rising in
    each process)."""
    name = str(name)
    with _state["lock"]:
        if _state["open"] is not None:
            idx, open_name = _state["open"]
            _emit(idx, _PHASE_END, open_name)
        _state["index"] += 1
        idx = _state["index"]
        _state["open"] = (idx, name)
        _emit(idx, _PHASE_BEGIN, name)
        return idx


def end_step():
    """Close the open step (nothing when none is open)."""
    with _state["lock"]:
        if _state["open"] is None:
            return
        idx, name = _state["open"]
        _state["open"] = None
        _emit(idx, _PHASE_END, name)


@contextmanager
def step_scope(name="step"):
    """Begin a step on entry and end it on exit; yields its index."""
    idx = annotate_step(name)
    try:
        yield idx
    finally:
        with _state["lock"]:
            # a nested annotate_step may have closed this step already
            if _state["open"] is not None and _state["open"][0] == idx:
                _, open_name = _state["open"]
                _state["open"] = None
                _emit(idx, _PHASE_END, open_name)


def current_step():
    """``(index, name)`` of the open step, or None."""
    with _state["lock"]:
        return _state["open"]


def _reset():
    """Forget every step (for tests)."""
    with _state["lock"]:
        _state["index"] = -1
        _state["open"] = None
