"""Environment knobs of the native proc tier.

The port's copy of the knobs of ``mpi4jax_tpu/utils/config.py`` that
the bridge reads before it starts (``native/runtime.py:
ensure_initialized`` checks each and passes it down): the deadlines, the
collective tuning, small-message coalescing, the wire path, the
hierarchical collectives, the self-healing transport and elastic
membership.  Each parses the same values as the JAX package's and
raises the same ``ValueError`` for the same bad ones: a mistyped knob
fails at launch, never falls back in silence.

* ``T4J_OP_TIMEOUT`` (0: wait forever), ``T4J_CONNECT_TIMEOUT`` (30 s);
* ``T4J_RING_MIN_BYTES`` (256K), ``T4J_SEG_BYTES`` (1M);
* ``T4J_COALESCE_BYTES`` (16K; 0 turns fusion off);
* ``T4J_STRIPES`` (auto or 1..16), ``T4J_ZEROCOPY_MIN_BYTES`` (0),
  ``T4J_SENDMSG_BATCH`` (8), ``T4J_EMU_FLOW_BPS`` (0);
* ``T4J_WIRE_DTYPE`` (off|bf16|fp8), ``T4J_WIRE_BACKEND``
  (auto|sendmsg|uring);
* ``T4J_HIER`` (auto|on|off), ``T4J_LEADER_RING_MIN_BYTES`` (256K);
* ``T4J_RETRY_MAX`` (3), ``T4J_BACKOFF_BASE`` (0.05 s),
  ``T4J_BACKOFF_MAX`` (2 s), ``T4J_REPLAY_BYTES`` (32M);
* ``T4J_ELASTIC`` (off|shrink|rejoin), ``T4J_MIN_WORLD`` (1),
  ``T4J_RESIZE_TIMEOUT`` (30 s);
* ``T4J_BUCKET_BYTES`` (4M), the gradient buckets of
  ``BucketedGradSync`` and ``models/train.py:make_dp_train_step``;
* the serving engine's ``T4J_SLO_MS`` (0: none), ``T4J_MAX_BATCH``
  (8) and ``T4J_ADMIT`` (off|on), and ``T4J_AUTOSCALE`` (off; ``on``
  is refused until the port has elastic jobs).

Byte counts take a K/M/G suffix.  The autoscaler's window and
request-file knobs and the telemetry knobs come with the code that
reads them (ROADMAP Queue 1 items 19 and 10).
"""

import math
import os

__all__ = [
    "truthy", "seconds", "byte_count", "int_count",
    "op_timeout", "connect_timeout",
    "ring_min_bytes", "seg_bytes", "coalesce_bytes",
    "MAX_STRIPES", "stripes", "zerocopy_min_bytes", "sendmsg_batch",
    "emu_flow_bps",
    "WIRE_DTYPES", "wire_dtype", "WIRE_BACKENDS", "wire_backend",
    "hier_mode", "leader_ring_min_bytes",
    "retry_max", "backoff_base", "backoff_max", "replay_bytes",
    "elastic_mode", "min_world", "resize_timeout", "bucket_bytes",
    "slo_ms", "max_batch", "admit_mode", "autoscale_mode",
]

_TRUE = {"1", "true", "on", "yes"}
_FALSE = {"0", "false", "off", "no", ""}
_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


def truthy(value, default=False):
    if value is None:
        return default
    v = str(value).strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"cannot interpret {value!r} as a boolean flag")


def seconds(value, default, name="value", minimum=0.0):
    """A duration in seconds: ``None``/empty gives ``default``; anything
    but a finite number >= ``minimum`` raises, naming the variable."""
    if value is None or str(value).strip() == "":
        return float(default)
    try:
        v = float(str(value).strip())
    except (TypeError, ValueError):
        raise ValueError(
            f"cannot interpret {name}={value!r} as seconds (want a number)"
        )
    if not math.isfinite(v):
        raise ValueError(f"{name}={value!r} must be finite")
    if v < minimum:
        raise ValueError(f"{name}={value!r} must be >= {minimum}")
    return v


def byte_count(value, default, name="value", minimum=0):
    """A byte count with an optional K/M/G suffix: ``None``/empty gives
    ``default``; anything but a whole number >= ``minimum`` raises."""
    if value is None or str(value).strip() == "":
        return int(default)
    s = str(value).strip()
    mult = 1
    if s and s[-1].lower() in _SUFFIX:
        mult = _SUFFIX[s[-1].lower()]
        s = s[:-1].strip()
    try:
        v = int(s, 10)
    except (TypeError, ValueError):
        raise ValueError(
            f"cannot interpret {name}={value!r} as a byte count "
            "(want an integer, optionally suffixed K/M/G)"
        )
    v *= mult
    if v < minimum:
        raise ValueError(f"{name}={value!r} must be >= {minimum}")
    if v >= 1 << 62:
        # the native side takes an int64
        raise ValueError(f"{name}={value!r} is implausibly large")
    return v


def int_count(value, default, name="value", minimum=0):
    """A plain integer count (no suffix), as :func:`byte_count`."""
    if value is None or str(value).strip() == "":
        return int(default)
    try:
        v = int(str(value).strip(), 10)
    except (TypeError, ValueError):
        raise ValueError(
            f"cannot interpret {name}={value!r} as an integer count"
        )
    if v < minimum:
        raise ValueError(f"{name}={value!r} must be >= {minimum}")
    return v


def _choice(var, choices, default):
    v = os.environ.get(var)
    if v is None or not str(v).strip():
        return default
    v = str(v).strip().lower()
    if v not in choices:
        raise ValueError(
            f"cannot interpret {var}={v!r} (want {'|'.join(choices)})"
        )
    return v


def _positive_seconds(var, default, why):
    v = seconds(os.environ.get(var), default, name=var)
    if v <= 0:
        raise ValueError(f"{var} must be > 0{why}")
    return v


# -- deadlines --------------------------------------------------------------


def op_timeout():
    """Per-call progress deadline of a bridge op in seconds; 0 (the
    default) waits forever, as MPI does."""
    return seconds(os.environ.get("T4J_OP_TIMEOUT"), 0.0,
                   name="T4J_OP_TIMEOUT")


def connect_timeout():
    """Bootstrap connect/accept deadline in seconds (> 0; default 30)."""
    return _positive_seconds(
        "T4J_CONNECT_TIMEOUT", 30.0,
        " (the bootstrap cannot wait forever for a rank that never starts)")


# -- collective tuning and coalescing ---------------------------------------


def ring_min_bytes():
    """Tree -> ring switchover of the TCP-tier collectives (bytes; 0
    forces the ring)."""
    return byte_count(os.environ.get("T4J_RING_MIN_BYTES"), 256 << 10,
                      name="T4J_RING_MIN_BYTES")


def seg_bytes():
    """Ring segment size in bytes (>= 1)."""
    v = byte_count(os.environ.get("T4J_SEG_BYTES"), 1 << 20,
                   name="T4J_SEG_BYTES")
    if v < 1:
        raise ValueError(
            "T4J_SEG_BYTES must be >= 1 (a ring segment cannot be empty)"
        )
    return v


def coalesce_bytes():
    """Small-message coalescing threshold in bytes: runs of same-peer
    messages at or below it travel as one fused frame; 0 turns fusion
    off.  Must be uniform across ranks."""
    return byte_count(os.environ.get("T4J_COALESCE_BYTES"), 16 << 10,
                      name="T4J_COALESCE_BYTES")


# -- the wire path ----------------------------------------------------------

MAX_STRIPES = 16


def stripes():
    """Parallel TCP connections per link: ``"auto"`` (default) or
    1..16.  Must be uniform across ranks."""
    v = os.environ.get("T4J_STRIPES")
    if v is None or not str(v).strip():
        return "auto"
    s = str(v).strip().lower()
    if s == "auto":
        return "auto"
    try:
        n = int(s, 10)
    except ValueError:
        raise ValueError(
            f"cannot interpret T4J_STRIPES={v!r} (want auto or an "
            f"integer 1..{MAX_STRIPES})"
        ) from None
    if not 1 <= n <= MAX_STRIPES:
        raise ValueError(
            f"T4J_STRIPES={n} out of range (want 1..{MAX_STRIPES}: one "
            "flow cannot be split below one connection, and the "
            "per-stripe reader/replay state is bounded)"
        )
    return n


def zerocopy_min_bytes():
    """MSG_ZEROCOPY floor in bytes (0, the default: the copy path)."""
    return byte_count(os.environ.get("T4J_ZEROCOPY_MIN_BYTES"), 0,
                      name="T4J_ZEROCOPY_MIN_BYTES")


def sendmsg_batch():
    """Frames gathered into one ``sendmsg`` (default 8, 1..256)."""
    v = int_count(os.environ.get("T4J_SENDMSG_BATCH"), 8,
                  name="T4J_SENDMSG_BATCH")
    if not 1 <= v <= 256:
        raise ValueError(
            f"T4J_SENDMSG_BATCH={v} out of range (want 1..256: a batch "
            "cannot be empty, and each frame costs two iovec entries "
            "against IOV_MAX)"
        )
    return v


def emu_flow_bps():
    """Per-connection test throttle in bytes/second (0, the default:
    off)."""
    return byte_count(os.environ.get("T4J_EMU_FLOW_BPS"), 0,
                      name="T4J_EMU_FLOW_BPS")


WIRE_DTYPES = ("off", "bf16", "fp8")


def wire_dtype():
    """Compressed-collective wire dtype: ``off`` (default), ``bf16`` or
    ``fp8``.  Must be uniform across ranks."""
    return _choice("T4J_WIRE_DTYPE", WIRE_DTYPES, "off")


WIRE_BACKENDS = ("auto", "sendmsg", "uring")


def wire_backend():
    """Wire data-plane backend: ``auto`` (default), ``sendmsg`` or
    ``uring``."""
    return _choice("T4J_WIRE_BACKEND", WIRE_BACKENDS, "auto")


# -- hierarchical collectives -----------------------------------------------


def hier_mode():
    """Hierarchical-collective selection: ``auto`` (default), ``on`` or
    ``off``.  Must be uniform across ranks."""
    return _choice("T4J_HIER", ("auto", "on", "off"), "auto")


def leader_ring_min_bytes():
    """Auto mode's switchover to the hierarchical path, in bytes
    (default 256K; 0: whenever the topology allows)."""
    return byte_count(os.environ.get("T4J_LEADER_RING_MIN_BYTES"),
                      256 << 10, name="T4J_LEADER_RING_MIN_BYTES")


# -- self-healing transport -------------------------------------------------


def retry_max():
    """Reconnect attempts per broken link (default 3; 0 turns
    self-healing off: the first transport error fails the job)."""
    return int_count(os.environ.get("T4J_RETRY_MAX"), 3,
                     name="T4J_RETRY_MAX")


def backoff_base():
    """First re-dial delay in seconds (> 0)."""
    return _positive_seconds("T4J_BACKOFF_BASE", 0.05, " seconds")


def backoff_max():
    """Re-dial delay cap in seconds (> 0, >= ``T4J_BACKOFF_BASE``)."""
    v = _positive_seconds("T4J_BACKOFF_MAX", 2.0, " seconds")
    if v < backoff_base():
        raise ValueError(
            "T4J_BACKOFF_MAX must be >= T4J_BACKOFF_BASE "
            f"(got {v} < {backoff_base()})"
        )
    return v


def replay_bytes():
    """Per-peer replay-ring capacity in bytes (default 32M)."""
    return byte_count(os.environ.get("T4J_REPLAY_BYTES"), 32 << 20,
                      name="T4J_REPLAY_BYTES")


# -- elastic membership -----------------------------------------------------


def elastic_mode():
    """``off`` (default: a dead rank aborts the job), ``shrink`` or
    ``rejoin``."""
    return _choice("T4J_ELASTIC", ("off", "shrink", "rejoin"), "off")


def min_world():
    """Survivor floor of an elastic shrink (default 1, >= 1)."""
    v = int_count(os.environ.get("T4J_MIN_WORLD"), 1, name="T4J_MIN_WORLD")
    if v < 1:
        raise ValueError(
            "T4J_MIN_WORLD must be >= 1 (a world cannot shrink to "
            "nothing)"
        )
    return v


def resize_timeout():
    """Per-phase bound of an elastic resize in seconds (> 0; default
    30)."""
    return _positive_seconds(
        "T4J_RESIZE_TIMEOUT", 30.0,
        " (the membership agreement cannot wait forever for a dead "
        "rank's reports)")


# -- gradient buckets -------------------------------------------------------


def bucket_bytes():
    """Gradient-bucket size of ``BucketedGradSync`` in bytes (default
    4M; >= 1).  Gradients in backward order are packed into buckets of
    about this size, and each bucket's ``iallreduce`` is submitted as
    soon as it is full, so its wire phase overlaps the rest of the
    backward.  Smaller buckets start overlapping earlier but pay more
    per-op latency."""
    v = byte_count(os.environ.get("T4J_BUCKET_BYTES"), 4 << 20,
                   name="T4J_BUCKET_BYTES")
    if v < 1:
        raise ValueError(
            "T4J_BUCKET_BYTES must be >= 1 (a gradient bucket cannot "
            "be empty)"
        )
    return v


# -- serving ----------------------------------------------------------------


def slo_ms():
    """Per-request end-to-end latency SLO in milliseconds (docs/
    serving.md), or 0 when unset.  Must be finite and >= 0.
    ``ensure_initialized`` also refuses an SLO with ``T4J_ADMIT=off``:
    nothing would enforce it."""
    return seconds(os.environ.get("T4J_SLO_MS"), 0.0, name="T4J_SLO_MS")


def max_batch():
    """Concurrent decode slots in the serving engine's KV-cache pool
    (default 8; 1..1024: the slot cache is ``layers x 2 x max_batch x
    max_len`` KV positions of real memory, and the per-step plan vector
    grows with it)."""
    v = int_count(os.environ.get("T4J_MAX_BATCH"), 8,
                  name="T4J_MAX_BATCH")
    if not 1 <= v <= 1024:
        raise ValueError(
            f"T4J_MAX_BATCH={v} out of range (want 1..1024: at least "
            "one slot, and the KV slot pool is real memory)"
        )
    return v


def admit_mode():
    """Serving admission control: ``off`` (default: every request is
    admitted, the uncontrolled baseline) or ``on`` (token bucket and
    SLO-estimator shedding)."""
    return _choice("T4J_ADMIT", ("off", "on"), "off")


def autoscale_mode():
    """Traffic-driven autoscaling of the serving world: ``off``
    (default) or ``on``.  ``ensure_initialized`` refuses ``on`` until
    the port has elastic jobs (ROADMAP Queue 1 item 19)."""
    return _choice("T4J_AUTOSCALE", ("off", "on"), "off")
