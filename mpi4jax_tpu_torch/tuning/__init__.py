"""Small-message coalescing: the run-time gate of the proc tier.

The port's copy of ``coalesce_bytes``, ``coalesce_eligible`` and
``override_coalesce`` (``mpi4jax_tpu/tuning/__init__.py:93-118``): the
op layer asks :func:`coalesce_eligible` whether a run of same-peer
messages travels as one fused wire frame (``sendrecv_multi``,
``alltoall_multi``).  Both ends of an exchange take the decision from
the same part shapes and the same threshold, so it must be uniform
across ranks.  The autotuner and its cache come with ROADMAP Queue 1
item 10; until then the threshold is ``T4J_COALESCE_BYTES`` (16K by
default) or a process's override.  The JAX package reads the variable
leniently here because its autotune cache may also set the value; the
port has no such cache, so it keeps the one strict reader of
``utils/config.py``.
"""

from mpi4jax_tpu_torch.utils import config

__all__ = ["coalesce_bytes", "coalesce_eligible", "override_coalesce"]

_state = {"coalesce_override": None}


def coalesce_bytes():
    """The coalescing threshold in bytes (0: fusion off): the override
    (:func:`override_coalesce`) if set, else ``config.coalesce_bytes``
    (``T4J_COALESCE_BYTES``, 16K by default; an unreadable value raises
    ``ValueError``, as it does at the bridge's init)."""
    ov = _state["coalesce_override"]
    if ov is not None:
        return int(ov)
    return config.coalesce_bytes()


def coalesce_eligible(total_bytes, nparts):
    """Should a run of ``nparts`` messages of ``total_bytes`` in all
    travel as one fused frame?  One message gains nothing, and a
    threshold of 0 turns fusion off."""
    if nparts < 2:
        return False
    threshold = coalesce_bytes()
    return threshold > 0 and int(total_bytes) <= threshold


def override_coalesce(bytes_or_none):
    """Force this process's threshold (``None`` restores the
    environment's): the benchmark's interleaved on/off pairs.  Mirrored
    into the native knob once the bridge is up."""
    _state["coalesce_override"] = (None if bytes_or_none is None
                                   else int(bytes_or_none))
    from mpi4jax_tpu_torch.native import runtime

    if runtime.is_initialized():
        runtime.set_coalesce(coalesce_bytes())
