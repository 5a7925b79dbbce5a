"""Python side of the native DCN bridge, on torch tensors.

The port's counterpart of ``mpi4jax_tpu/native/runtime.py``: the ctypes
loader of the port's own bridge library (``native/build.py``), the
process world's control plane (init, rank, size, communicators, health,
the abort broadcast) and the blocking data plane.  There are no XLA
handlers to register: the port calls the plain-C API directly.

The data plane (``host_*``) takes contiguous CPU tensors and passes
their raw pointers, so every dtype of the bridge's table travels as it
is, bfloat16 (code 14) included.  ``out=`` lets a caller receive into a
buffer of its own (``ops/_proc.py`` stages CUDA tensors through pinned
host buffers that way).  Every call returns a status; a nonzero one
raises :class:`BridgeError` with the bridge's own rank, peer and op
context.

The async engine (``host_i*``, :func:`host_wait`, :func:`host_test`)
takes the same raw pointers: a registry holds each request's input and
output tensors until its wait, since the bridge's progress thread reads
and writes them after the submit returns.  Requests never waited are
reported on stderr at :func:`finalize`.

Elastic membership (``T4J_ELASTIC=shrink|rejoin``, the launcher's
``--elastic``): after a resize the next op raises :class:`WorldResized`;
the program waits out a resize in flight (:func:`resize_wait`), drops
the old world's handles (:func:`refresh_after_resize`) and rebuilds its
comms over :func:`alive_ranks` (``models/train.py:run_elastic`` is the
template).  Telemetry, the flight recorder and the tuning cache come
with ROADMAP Queue 1 item 10, the wire info surfaces with item 19.
:func:`link_stats` (the self-healing transport's counters) is here for
serving admission's fabric poll.
"""

import atexit
import ctypes
import os
import sys

import torch

from mpi4jax_tpu_torch.utils import config

__all__ = [
    "BridgeError",
    "WorldResized",
    "available",
    "is_initialized",
    "ensure_initialized",
    "finalize",
    "world_rank",
    "world_size",
    "world_info",
    "alive_ranks",
    "effective_world_size",
    "resize_wait",
    "refresh_after_resize",
    "set_elastic",
    "topology",
    "link_stats",
    "comm_handle",
    "last_error",
    "check_health",
    "notify_abort",
    "set_timeouts",
    "set_tuning",
    "set_coalesce",
    "coalesce_bytes",
    "set_wire",
    "set_wire_dtype",
    "set_wire_backend",
    "set_hier",
    "set_resilience",
    "dtype_code",
    "host_allreduce",
    "host_reduce",
    "host_reduce_scatter",
    "host_scan",
    "host_barrier",
    "host_bcast",
    "host_allgather",
    "host_gather",
    "host_scatter",
    "host_alltoall",
    "host_send",
    "host_recv",
    "host_sendrecv",
    "host_sendrecv_fused",
    "host_alltoall_fused",
    "host_iallreduce",
    "host_ireduce_scatter",
    "host_isend",
    "host_irecv",
    "host_wait",
    "host_test",
    "async_inflight",
    "async_pending",
    "async_assert_drained",
    "wire_dtype_info",
    "annotate_step",
]


class BridgeError(RuntimeError):
    """A bridge call failed (a transport error, a deadline, or a peer's
    abort broadcast).  The message carries the bridge's rank, peer and
    op context.  The bridge is faulted afterwards: every further op of
    the proc tier raises until the job restarts."""


class WorldResized(RuntimeError):
    """The world's membership changed under an elastic resize.

    Raised at the next op of the proc tier after a resize committed (and
    by :func:`check_health`).  Unlike :class:`BridgeError` it is
    recoverable: the transport is already rebuilt over the new members,
    and the program rebuilds its communicators over ``new_world``.

    Attributes: ``old_world`` and ``new_world`` (tuples of world ranks)
    and ``epoch`` (the committed world epoch, one more per resize).
    """

    def __init__(self, old_world, new_world, epoch):
        self.old_world = tuple(old_world)
        self.new_world = tuple(new_world)
        self.epoch = int(epoch)
        joined = ",".join(str(r) for r in self.new_world)
        super().__init__(
            f"world resized at epoch {self.epoch}: "
            f"{len(self.old_world)} -> {len(self.new_world)} member(s) "
            f"(now [{joined}]) — rebuild communicators over the new "
            "world and redistribute state"
        )


_state = {"lib": None, "comm_cache": {}, "world_view": None,
          "atexit": False}

_i32, _i64, _u64, _dbl = (ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64,
                          ctypes.c_double)
_vp = ctypes.c_void_p
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_vpp = ctypes.POINTER(ctypes.c_void_p)

# every symbol this module calls: (argtypes, restype); the names and
# signatures are those of mpi4jax_tpu/native/runtime.py's bindings
SIGNATURES = {
    "t4j_init": ([], ctypes.c_int),
    "t4j_finalize": ([], None),
    "t4j_initialized": ([], ctypes.c_int),
    "t4j_world_rank": ([], ctypes.c_int),
    "t4j_world_size": ([], ctypes.c_int),
    "t4j_last_error": ([], ctypes.c_char_p),
    "t4j_health": ([], ctypes.c_int),
    "t4j_fault_msg": ([], ctypes.c_char_p),
    "t4j_abort_notify": ([ctypes.c_char_p], None),
    "t4j_comm_create": ([_i32p, _i32, _i32], ctypes.c_int),
    "t4j_comm_rank": ([_i32], ctypes.c_int),
    "t4j_comm_size": ([_i32], ctypes.c_int),
    "t4j_set_timeouts": ([_dbl, _dbl], None),
    "t4j_set_tuning": ([_i64, _i64], None),
    "t4j_set_coalesce": ([_i64], None),
    "t4j_coalesce_bytes": ([], _i64),
    "t4j_set_hier": ([_i32, _i64], None),
    "t4j_set_resilience": ([_i32, _dbl, _dbl, _i64], None),
    "t4j_set_elastic": ([_i32, _i32, _dbl], None),
    "t4j_set_wire": ([_i32, _i64, _i32, _i64], None),
    "t4j_set_wire_dtype": ([_i32], None),
    "t4j_set_wire_backend": ([_i32], None),
    "t4j_wire_backend_info": ([_i32p, _i32p, _i32p], _i32),
    "t4j_world_info": ([_u32p, _i32p, _u64p, _i32p, _u64p], _i32),
    "t4j_resize_wait": ([_dbl], _i32),
    "t4j_topo": ([_i32p] * 5, _i32),
    "t4j_link_stats": ([_i32, _u64p, _u64p, _u64p, _u64p, _u64p, _i32p],
                       _i32),
    "t4j_link_stripe_stats": ([_i32, _i32, _u64p, _u64p, _u64p, _u64p,
                               _u64p, _i32p], _i32),
    "t4j_c_allreduce": ([_i32, _vp, _vp, _u64, _i32, _i32], _i32),
    "t4j_c_reduce": ([_i32, _vp, _vp, _u64, _i32, _i32, _i32], _i32),
    "t4j_c_scan": ([_i32, _vp, _vp, _u64, _i32, _i32], _i32),
    "t4j_c_reduce_scatter": ([_i32, _vp, _vp, _u64, _i32, _i32], _i32),
    "t4j_c_barrier": ([_i32], _i32),
    "t4j_c_bcast": ([_i32, _vp, _u64, _i32], _i32),
    "t4j_c_allgather": ([_i32, _vp, _vp, _u64], _i32),
    "t4j_c_gather": ([_i32, _vp, _vp, _u64, _i32], _i32),
    "t4j_c_scatter": ([_i32, _vp, _vp, _u64, _i32], _i32),
    "t4j_c_alltoall": ([_i32, _vp, _vp, _u64], _i32),
    "t4j_c_send": ([_i32, _vp, _u64, _i32, _i32], _i32),
    "t4j_c_recv": ([_i32, _vp, _u64, _i32, _i32, _i32p, _i32p], _i32),
    "t4j_c_sendrecv": ([_i32, _vp, _u64, _vp, _u64, _i32, _i32, _i32,
                        _i32, _i32p, _i32p], _i32),
    "t4j_c_sendrecv_fused": ([_i32, _vpp, _u64p, _i32, _vpp, _u64p, _i32,
                              _i32, _i32, _i32, _i32, _i32p, _i32p], _i32),
    "t4j_c_alltoall_fused": ([_i32, _vpp, _vpp, _u64p, _i32], _i32),
    "t4j_wire_dtype_info": ([_i32p, _u64p, _u64p], _i32),
    "t4j_annotate_step": ([_i64, _i32], None),
    # the async engine: a submit returns a request id, 0 on failure
    "t4j_iallreduce": ([_i32, _vp, _vp, _u64, _i32, _i32], _u64),
    "t4j_ireduce_scatter": ([_i32, _vp, _vp, _u64, _i32, _i32], _u64),
    "t4j_isend": ([_i32, _vp, _u64, _i32, _i32], _u64),
    "t4j_irecv": ([_i32, _vp, _u64, _i32, _i32], _u64),
    "t4j_wait": ([_u64, _i32p, _i32p], _i32),
    "t4j_test": ([_u64, _i32p, _i32p, _i32p], _i32),
    "t4j_async_inflight": ([], _i32),
    "t4j_async_pending": ([], _i32),
}

_ELASTIC_MODES = {"off": 0, "shrink": 1, "rejoin": 2}
_HIER_MODES = {"auto": 0, "on": 1, "off": 2}
WIRE_DTYPE_CODES = {"off": 0, "bf16": 1, "fp8": 2}
WIRE_DTYPE_NAMES = {v: k for k, v in WIRE_DTYPE_CODES.items()}
WIRE_BACKEND_CODES = {"sendmsg": 0, "uring": 1, "auto": 2}


def _load():
    if _state["lib"] is not None:
        return _state["lib"]
    from mpi4jax_tpu_torch.native.build import ensure_built

    lib = ctypes.CDLL(str(ensure_built()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _state["lib"] = lib
    return lib


def available():
    """True when this process is a rank of a launcher job
    (``T4J_RANK`` and ``T4J_SIZE`` set)."""
    return "T4J_RANK" in os.environ and "T4J_SIZE" in os.environ


def is_initialized():
    lib = _state["lib"]
    return bool(lib and lib.t4j_initialized())


def last_error():
    """The message of the last failed bridge call on this thread."""
    lib = _state["lib"]
    if lib is None:
        return ""
    raw = lib.t4j_last_error()
    return raw.decode("utf-8", "replace") if raw else ""


def _check(status):
    if status:
        raise BridgeError(
            last_error() or "native bridge call failed (no detail)")


def check_health():
    """Raise :class:`WorldResized` after a committed resize, and
    :class:`BridgeError` once the bridge posted a fault (a peer died, an
    op timed out, or an abort broadcast arrived): the op tier calls it
    before every op, so no op is fed to a dead transport."""
    lib = _state["lib"]
    if lib is None or not lib.t4j_initialized():
        return
    _check_world_epoch(lib)
    if lib.t4j_health():
        raw = lib.t4j_fault_msg()
        raise BridgeError(raw.decode("utf-8", "replace") if raw
                          else "bridge faulted")


def notify_abort(why):
    """The MPI_Abort analog: tell every peer this process is going down,
    so that their blocked ops raise instead of hanging."""
    lib = _state["lib"]
    if lib is not None and lib.t4j_initialized():
        lib.t4j_abort_notify(str(why).encode("utf-8", "replace"))


# -- knobs (None keeps the current value) -----------------------------------


def set_timeouts(op_s=None, connect_s=None):
    """Bridge deadlines in seconds (``op_s=0``: no per-op deadline)."""
    _load().t4j_set_timeouts(-1.0 if op_s is None else float(op_s),
                             -1.0 if connect_s is None else float(connect_s))


def set_tuning(ring_min_bytes=None, seg_bytes=None):
    """Tree -> ring switchover and ring segment, in bytes; uniform
    across ranks."""
    _load().t4j_set_tuning(
        -1 if ring_min_bytes is None else int(ring_min_bytes),
        0 if seg_bytes is None else int(seg_bytes))


def set_coalesce(bytes_threshold=None):
    """The native coalescing threshold in bytes (0: no fusion)."""
    _load().t4j_set_coalesce(
        -1 if bytes_threshold is None else int(bytes_threshold))


def coalesce_bytes():
    """The native layer's coalescing threshold in bytes."""
    return int(_load().t4j_coalesce_bytes())


def set_wire(stripes=None, zerocopy_min_bytes=None, sendmsg_batch=None,
             emu_flow_bps=None):
    """The wire path's knobs; uniform across ranks."""
    _load().t4j_set_wire(
        0 if stripes is None else int(stripes),
        -1 if zerocopy_min_bytes is None else int(zerocopy_min_bytes),
        0 if sendmsg_batch is None else int(sendmsg_batch),
        -1 if emu_flow_bps is None else int(emu_flow_bps))


def _code(mode, codes, what):
    if mode is None:
        return -1
    if isinstance(mode, str):
        try:
            return codes[mode.strip().lower()]
        except KeyError:
            raise ValueError(
                f"unknown {what} {mode!r} (want {'|'.join(codes)})") from None
    return int(mode)


def set_wire_dtype(mode=None):
    """Compressed-collective wire dtype: off, bf16 or fp8 (or 0/1/2)."""
    _load().t4j_set_wire_dtype(_code(mode, WIRE_DTYPE_CODES, "wire dtype"))


def wire_dtype_info():
    """The compressed-collective state: ``{"wire_dtype",
    "wire_logical_bytes", "wire_bytes"}`` (the byte counters count the
    compressed send path alone); None when the library was never
    loaded."""
    lib = _state["lib"]
    if lib is None:
        return None
    mode, logical, wire = (ctypes.c_int32(0), ctypes.c_uint64(0),
                           ctypes.c_uint64(0))
    lib.t4j_wire_dtype_info(ctypes.byref(mode), ctypes.byref(logical),
                            ctypes.byref(wire))
    return {"wire_dtype": WIRE_DTYPE_NAMES.get(int(mode.value), "off"),
            "wire_logical_bytes": int(logical.value),
            "wire_bytes": int(wire.value)}


def annotate_step(index, phase):
    """A step boundary into the bridge's native ring (``phase`` 1 begin,
    2 end; ``index`` the caller's step number).  False, and nothing
    done, when the library was never loaded; never loads or builds it.
    The public surface is ``ops/step.py``."""
    lib = _state["lib"]
    if lib is None:
        return False
    lib.t4j_annotate_step(int(index), int(phase))
    return True


def set_wire_backend(mode=None):
    """Wire data-plane backend: sendmsg, uring or auto (or 0/1/2)."""
    _load().t4j_set_wire_backend(
        _code(mode, WIRE_BACKEND_CODES, "wire backend"))


def set_hier(mode=None, leader_ring_min_bytes=None):
    """Hierarchical-collective selection (auto, on, off) and auto mode's
    switchover in bytes; uniform across ranks."""
    _load().t4j_set_hier(
        -1 if mode is None else _HIER_MODES[str(mode)],
        -1 if leader_ring_min_bytes is None else int(leader_ring_min_bytes))


def set_resilience(retry_max=None, backoff_base_s=None, backoff_max_s=None,
                   replay_bytes=None):
    """The self-healing transport's knobs; before init, uniform across
    ranks."""
    _load().t4j_set_resilience(
        -1 if retry_max is None else int(retry_max),
        -1.0 if backoff_base_s is None else float(backoff_base_s),
        -1.0 if backoff_max_s is None else float(backoff_max_s),
        -1 if replay_bytes is None else int(replay_bytes))


def set_elastic(mode=None, min_world=None, resize_timeout_s=None):
    """The elastic-membership knobs: ``mode`` ``"off"`` (a dead rank
    ends the job), ``"shrink"`` (the survivors agree on a smaller world
    and go on) or ``"rejoin"`` (shrink, and rank 0 keeps the bootstrap
    port open for relaunched ranks); ``min_world`` the survivor floor,
    ``resize_timeout_s`` the bound of each resize phase.  None keeps a
    value.  Before init, uniform across ranks (the launcher's
    ``--elastic`` sets ``T4J_ELASTIC`` for every rank)."""
    if mode is not None and str(mode) not in _ELASTIC_MODES:
        raise ValueError(f"cannot interpret elastic mode {mode!r} "
                         "(want off|shrink|rejoin)")
    _load().t4j_set_elastic(
        -1 if mode is None else _ELASTIC_MODES[str(mode)],
        0 if min_world is None else int(min_world),
        -1.0 if resize_timeout_s is None else float(resize_timeout_s))


def _uring_supported(lib):
    mode, supported, active = (ctypes.c_int32(0) for _ in range(3))
    lib.t4j_wire_backend_info(ctypes.byref(mode), ctypes.byref(supported),
                              ctypes.byref(active))
    return bool(supported.value)


# -- the world --------------------------------------------------------------


def world_info():
    """The live membership, or None before init: ``{"epoch",
    "boot_size", "alive_count", "alive_mask", "resizing",
    "stale_frames"}``; epoch 0 is the bootstrap world and each committed
    resize adds one."""
    lib = _state["lib"]
    if lib is None or not lib.t4j_initialized():
        return None
    epoch, alive, mask = ctypes.c_uint32(0), ctypes.c_int32(0), \
        ctypes.c_uint64(0)
    resizing, stale = ctypes.c_int32(0), ctypes.c_uint64(0)
    if not lib.t4j_world_info(ctypes.byref(epoch), ctypes.byref(alive),
                              ctypes.byref(mask), ctypes.byref(resizing),
                              ctypes.byref(stale)):
        return None
    return {
        "epoch": int(epoch.value),
        "boot_size": int(lib.t4j_world_size()),
        "alive_count": int(alive.value),
        "alive_mask": int(mask.value),
        "resizing": bool(resizing.value),
        "stale_frames": int(stale.value),
    }


def _mask_ranks(mask, boot_size):
    if boot_size > 64:
        return tuple(range(boot_size))
    return tuple(r for r in range(boot_size) if (mask >> r) & 1)


def alive_ranks():
    """The current members as a sorted tuple of world ranks (None before
    init)."""
    info = world_info()
    if info is None:
        return None
    return _mask_ranks(info["alive_mask"], info["boot_size"])


def effective_world_size():
    """The current member count: :func:`world_size` until a resize
    changes the membership."""
    info = world_info()
    if info is None:
        return world_size()
    return info["alive_count"]


def resize_wait(timeout_s=None):
    """Block until no elastic resize is in flight; True when settled.
    ``None`` waits twice ``T4J_RESIZE_TIMEOUT`` plus 10 s: a resize that
    cannot finish in that time posts a fault anyway."""
    lib = _state["lib"]
    if lib is None or not lib.t4j_initialized():
        return True
    if timeout_s is None:
        timeout_s = 2 * config.resize_timeout() + 10.0
    return bool(lib.t4j_resize_wait(float(timeout_s)))


def refresh_after_resize():
    """Re-resolve this process's view of the substrate after a resize:
    drop the old world's comm handles and pass the coalescing gate down
    again.  Local, no collective: the port runs no tuning resolution at
    init (the JAX package re-runs its collective ``tuning.startup`` here,
    paired with the one in a rejoined rank's init; both come with ROADMAP
    Queue 1 item 10)."""
    from mpi4jax_tpu_torch import tuning

    _state["comm_cache"].clear()
    if is_initialized():
        set_coalesce(tuning.coalesce_bytes())


def _check_world_epoch(lib):
    """Raise :class:`WorldResized` when the membership changed since the
    last check (the comm handles of the old world dropped first); an
    in-flight resize is waited out, so the caller sees its verdict."""
    info = world_info()
    if info is None:
        return
    if info["resizing"]:
        resize_wait()
        info = world_info()
        if info is None:
            return
    last = _state["world_view"]
    if last is None:
        _state["world_view"] = info
        return
    if info["epoch"] != last["epoch"]:
        _state["world_view"] = info
        _state["comm_cache"].clear()
        raise WorldResized(
            _mask_ranks(last["alive_mask"], info["boot_size"]),
            _mask_ranks(info["alive_mask"], info["boot_size"]),
            info["epoch"],
        )


def topology():
    """This rank's bootstrap topology, or None before init:
    ``{"host_id", "local_rank", "local_size", "leader_rank",
    "n_hosts"}``."""
    lib = _state["lib"]
    if lib is None or not lib.t4j_initialized():
        return None
    vals = [ctypes.c_int32(0) for _ in range(5)]
    if not lib.t4j_topo(*[ctypes.byref(v) for v in vals]):
        return None
    keys = ("host_id", "local_rank", "local_size", "leader_rank", "n_hosts")
    return dict(zip(keys, (v.value for v in vals)))


_LINK_KEYS = ("reconnects", "replayed_frames", "replayed_bytes",
              "tx_syscalls", "rx_syscalls", "state")


def _link_counters(fn, *args):
    """The six counters of ``t4j_link_stats`` or ``t4j_link_stripe_stats``
    as a dict, or None where the call filled nothing."""
    vals = [ctypes.c_uint64(0) for _ in range(5)] + [ctypes.c_int32(0)]
    if not fn(*args, *[ctypes.byref(v) for v in vals]):
        return None
    return dict(zip(_LINK_KEYS, (v.value for v in vals)))


def _link_stats_one(lib, peer):
    return _link_counters(lib.t4j_link_stats, int(peer))


def _stripe_stats_one(lib, peer, stripe):
    return _link_counters(lib.t4j_link_stripe_stats, int(peer), int(stripe))


def link_stats(peer=None):
    """The self-healing transport's counters, or None before init.

    ``peer=None`` aggregates every link: ``{"reconnects",
    "replayed_frames", "replayed_bytes", "tx_syscalls", "rx_syscalls",
    "state"}`` with ``state`` the worst link's (0 up, 1 broken or
    repairing, 2 dead), plus the per-peer maxima (``"worst_peer"``,
    ``"max_reconnects"``, ``"max_replayed_frames"``,
    ``"max_replayed_bytes"``): serving admission sheds by the worst
    link, not the average.  ``worst_peer`` is the rank with the most
    reconnects (ties broken by replayed bytes, then by the worse
    state); None when no link has any counter.  An integer ``peer``
    selects that world rank's link, with one dict per stripe under
    ``"stripes"`` (None for this rank itself or out of range)."""
    lib = _state["lib"]
    if lib is None or not lib.t4j_initialized():
        return None
    if peer is not None:
        s = _link_stats_one(lib, peer)
        if s is None:
            return None
        stripes = []
        while True:
            ss = _stripe_stats_one(lib, peer, len(stripes))
            if ss is None:
                break
            stripes.append(ss)
        if stripes:
            s["stripes"] = stripes
        return s
    agg = _link_stats_one(lib, -1)
    if agg is None:
        return None
    agg.update(worst_peer=None, max_reconnects=0, max_replayed_frames=0,
               max_replayed_bytes=0)
    worst_key = (0, 0, 0)
    for r in range(int(lib.t4j_world_size())):
        s = _link_stats_one(lib, r)
        if s is None:
            continue
        for k in ("reconnects", "replayed_frames", "replayed_bytes"):
            agg[f"max_{k}"] = max(agg[f"max_{k}"], s[k])
        key = (s["reconnects"], s["replayed_bytes"], s["state"])
        if key > worst_key and any(key):
            worst_key = key
            agg["worst_peer"] = r
    return agg


def ensure_initialized():
    """Join the launcher job of this process (idempotent); False when
    this process is not a rank of one.

    Every knob of ``utils/config.py`` is read and checked first (a bad
    value, an elastic mode with ``T4J_RETRY_MAX=0`` or
    ``T4J_AUTOSCALE=on`` raises ``ValueError`` before the library is
    built), then passed down, then the bridge bootstraps: a rank
    relaunched into an elastic job (``T4J_REJOIN=1``) joins the
    survivors through rank 0's kept-open port.  A failed bootstrap
    raises :class:`BridgeError`.  ``finalize`` runs at exit."""
    if is_initialized():
        return True
    if not available():
        return False
    op_s, connect_s = config.op_timeout(), config.connect_timeout()
    ring_min, seg = config.ring_min_bytes(), config.seg_bytes()
    coalesce = config.coalesce_bytes()
    wire_stripes = config.stripes()
    zc_min = config.zerocopy_min_bytes()
    batch = config.sendmsg_batch()
    flow = config.emu_flow_bps()
    wdtype = config.wire_dtype()
    wbackend = config.wire_backend()
    if 0 < zc_min < 4096:
        raise ValueError(
            f"T4J_ZEROCOPY_MIN_BYTES={zc_min} is below the page floor "
            "(4096): MSG_ZEROCOPY pins whole pages per send, and sub-page "
            "frames pay the pin/completion round-trip for no copy saved "
            "— use 0 (off) or >= 4096"
        )
    hier, hier_min = config.hier_mode(), config.leader_ring_min_bytes()
    retry = config.retry_max()
    boff_base, boff_max = config.backoff_base(), config.backoff_max()
    replay = config.replay_bytes()
    elastic = config.elastic_mode()
    world_floor = config.min_world()
    resize_s = config.resize_timeout()
    if elastic != "off" and retry == 0:
        raise ValueError(
            f"T4J_ELASTIC={elastic} requires T4J_RETRY_MAX > 0: the "
            "elastic rung triggers when the self-healing ladder's "
            "escalation declares a rank unrecoverable, and "
            "T4J_RETRY_MAX=0 disables that ladder entirely "
            "(docs/failure-semantics.md \"elastic membership\")"
        )
    # the serving knobs act in the Python serving tier after init; they
    # are checked here, before anything is built, as the JAX package's
    serve_slo = config.slo_ms()
    config.max_batch()
    serve_admit = config.admit_mode()
    if serve_slo > 0 and serve_admit == "off":
        raise ValueError(
            f"T4J_SLO_MS={serve_slo:g} with T4J_ADMIT=off: an SLO "
            "with admission control off cannot be enforced, only "
            "missed — set T4J_ADMIT=on (shed to hold the deadline) "
            "or drop the SLO (docs/serving.md \"admission control\")"
        )
    if config.autoscale_mode() == "on":
        raise ValueError(
            "T4J_AUTOSCALE=on: growing the serving world admits relaunched "
            "ranks into the serving engine's elastic epochs, which the "
            "port does not run yet (the autoscale wiring and the "
            "launcher's --autoscale come with ROADMAP Queue 1 item 19) — "
            "unset T4J_AUTOSCALE or set it to off"
        )
    lib = _load()
    lib.t4j_set_timeouts(op_s, connect_s)
    lib.t4j_set_tuning(ring_min, seg)
    lib.t4j_set_coalesce(coalesce)
    lib.t4j_set_wire(0 if wire_stripes == "auto" else int(wire_stripes),
                     zc_min, batch, flow)
    lib.t4j_set_wire_dtype(WIRE_DTYPE_CODES[wdtype])
    lib.t4j_set_wire_backend(WIRE_BACKEND_CODES[wbackend])
    if wbackend == "uring" and not _uring_supported(lib):
        raise ValueError(
            "T4J_WIRE_BACKEND=uring but this kernel has no usable "
            "io_uring (the probe failed) — use auto (resolves to sendmsg "
            "here) or sendmsg"
        )
    lib.t4j_set_hier(_HIER_MODES[hier], hier_min)
    lib.t4j_set_resilience(retry, boff_base, boff_max, replay)
    set_elastic(elastic, world_floor, resize_s)
    if lib.t4j_init() != 0:
        raise BridgeError(last_error()
                          or "native bridge init failed (check T4J_* env)")
    _state["world_view"] = world_info()
    if not _state["atexit"]:
        atexit.register(finalize)
        _state["atexit"] = True
    return True


def finalize():
    """Leave the job: the bridge's exit barrier (skipped after a fault)
    and its teardown.  Runs at exit; idempotent."""
    lib = _state["lib"]
    if lib and lib.t4j_initialized():
        if _async_reqs:
            # loud on stderr, not raised: finalize runs from atexit, where
            # an exception would hide the job's real outcome
            kinds = ", ".join(rec["kind"]
                              for rec in list(_async_reqs.values())[:8])
            print(f"t4j: {len(_async_reqs)} async request(s) never waited "
                  f"at finalize ({kinds}) — request leak; every "
                  "iallreduce/ireduce_scatter/isend/irecv must be completed "
                  "by wait/waitall", file=sys.stderr, flush=True)
        lib.t4j_finalize()
    _state["comm_cache"].clear()


def world_rank():
    ensure_initialized()
    return _state["lib"].t4j_world_rank()


def world_size():
    ensure_initialized()
    return _state["lib"].t4j_world_size()


def _stable_ctx(ranks, context):
    """Deterministic 30-bit channel id of a communicator: FNV-1a over the
    rank list and the clone generation, so every member derives the same
    id whatever order it made its comms in.  The world comm is context 0
    natively."""
    h = 0x811C9DC5
    for v in (*ranks, 0x7FFFFFFF, context):
        h ^= (v + 1) & 0xFFFFFFFF
        h = (h * 0x01000193) & 0xFFFFFFFF
    ctx = h & 0x3FFFFFFF
    return ctx if ctx != 0 else 1


def comm_handle(comm):
    """The native handle of a ProcComm (cached per (ranks, context))."""
    ensure_initialized()
    key = (tuple(comm.ranks), comm.context)
    cached = _state["comm_cache"].get(key)
    if cached is not None:
        return cached
    lib = _state["lib"]
    if len(comm.ranks) == world_size() and comm.context == 0:
        handle = 0  # the world communicator, made at init
    else:
        arr = (ctypes.c_int32 * len(comm.ranks))(*comm.ranks)
        handle = lib.t4j_comm_create(arr, len(comm.ranks),
                                     _stable_ctx(comm.ranks, comm.context))
    _state["comm_cache"][key] = handle
    return handle


# -- the data plane: contiguous CPU tensors, raw pointers -------------------

# the bridge's dtype enum (dcn.h; the JAX package's table, :1171-1188)
DTYPE_CODES = {
    torch.float32: 0,
    torch.float64: 1,
    torch.int8: 2,
    torch.int16: 3,
    torch.int32: 4,
    torch.int64: 5,
    torch.uint8: 6,
    torch.uint16: 7,
    torch.uint32: 8,
    torch.uint64: 9,
    torch.bool: 10,
    torch.complex64: 11,
    torch.complex128: 12,
    torch.float16: 13,
    torch.bfloat16: 14,
}


def dtype_code(dtype):
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise ValueError(
            f"unsupported dtype for the native bridge: {dtype}") from None


def _host(x):
    """``x`` as the bridge reads it: a contiguous CPU tensor."""
    if x.device.type != "cpu":
        raise ValueError(
            f"the bridge's data plane takes CPU tensors, got {x.device} "
            "(ops/_proc.py stages CUDA tensors through host memory)")
    return x.detach().contiguous()


def _out(out, shape, like):
    if out is None:
        return torch.empty(shape, dtype=like.dtype)
    if tuple(out.shape) != tuple(shape) or out.dtype != like.dtype \
            or not out.is_contiguous() or out.device.type != "cpu":
        raise ValueError("out must be a contiguous CPU tensor of the "
                         "result's shape and dtype")
    return out


def _lib():
    return _state["lib"]


def _nbytes(t):
    return t.numel() * t.element_size()


def host_allreduce(handle, x, opcode, out=None):
    x = _host(x)
    out = _out(out, x.shape, x)
    _check(_lib().t4j_c_allreduce(handle, x.data_ptr(), out.data_ptr(),
                                  x.numel(), dtype_code(x.dtype), opcode))
    return out


def host_reduce(handle, x, opcode, root, out=None):
    """The reduction on ``root``; the input, unmodified, elsewhere."""
    x = _host(x)
    out = _out(out, x.shape, x)
    _check(_lib().t4j_c_reduce(handle, x.data_ptr(), out.data_ptr(),
                               x.numel(), dtype_code(x.dtype), opcode, root))
    if _lib().t4j_comm_rank(handle) != root:
        return x
    return out


def host_reduce_scatter(handle, x, opcode, out=None):
    """``x`` is ``(comm_size, *rest)``; row ``rank`` reduced."""
    x = _host(x)
    out = _out(out, x.shape[1:], x)
    _check(_lib().t4j_c_reduce_scatter(handle, x.data_ptr(), out.data_ptr(),
                                       out.numel(), dtype_code(x.dtype),
                                       opcode))
    return out


def host_scan(handle, x, opcode, out=None):
    x = _host(x)
    out = _out(out, x.shape, x)
    _check(_lib().t4j_c_scan(handle, x.data_ptr(), out.data_ptr(),
                             x.numel(), dtype_code(x.dtype), opcode))
    return out


def host_barrier(handle):
    _check(_lib().t4j_c_barrier(handle))


def host_bcast(handle, x, root, out=None):
    """The root's ``x`` on every rank (in ``out``, or in a copy)."""
    x = _host(x)
    out = _out(out, x.shape, x)
    out.copy_(x)
    _check(_lib().t4j_c_bcast(handle, out.data_ptr(), _nbytes(out), root))
    return out


def host_allgather(handle, x, out=None):
    x = _host(x)
    n = _lib().t4j_comm_size(handle)
    out = _out(out, (n, *x.shape), x)
    _check(_lib().t4j_c_allgather(handle, x.data_ptr(), out.data_ptr(),
                                  _nbytes(x)))
    return out


def host_gather(handle, x, root, out=None):
    """``(comm_size, *x.shape)``; only the root's holds the rows."""
    x = _host(x)
    n = _lib().t4j_comm_size(handle)
    out = _out(out, (n, *x.shape), x)
    _check(_lib().t4j_c_gather(handle, x.data_ptr(), out.data_ptr(),
                               _nbytes(x), root))
    return out


def host_scatter(handle, x, root, out=None):
    """The root passes ``(comm_size, *rest)``, the others a
    ``rest``-shaped template; every rank gets ``rest``."""
    x = _host(x)
    lib = _lib()
    shape = x.shape[1:] if lib.t4j_comm_rank(handle) == root else x.shape
    out = _out(out, shape, x)
    _check(lib.t4j_c_scatter(handle, x.data_ptr(), out.data_ptr(),
                             _nbytes(out), root))
    return out


def host_alltoall(handle, x, out=None):
    x = _host(x)
    n = _lib().t4j_comm_size(handle)
    out = _out(out, x.shape, x)
    _check(_lib().t4j_c_alltoall(handle, x.data_ptr(), out.data_ptr(),
                                 _nbytes(x) // n))
    return out


def host_send(handle, x, dest, tag):
    x = _host(x)
    _check(_lib().t4j_c_send(handle, x.data_ptr(), _nbytes(x), dest, tag))


def host_recv(handle, out, source, tag):
    """Receive into ``out`` (a contiguous CPU tensor); returns ``(out,
    source, tag)`` as the wire gave them."""
    out = _out(out, out.shape, out)
    src, tg = ctypes.c_int32(0), ctypes.c_int32(0)
    _check(_lib().t4j_c_recv(handle, out.data_ptr(), _nbytes(out), source,
                             tag, ctypes.byref(src), ctypes.byref(tg)))
    return out, src.value, tg.value


def host_sendrecv(handle, sendbuf, out, source, dest, sendtag, recvtag):
    """Send ``sendbuf`` to ``dest`` and receive into ``out`` from
    ``source``; returns ``(out, source, tag)`` as the wire gave them."""
    sendbuf = _host(sendbuf)
    out = _out(out, out.shape, out)
    src, tg = ctypes.c_int32(0), ctypes.c_int32(0)
    _check(_lib().t4j_c_sendrecv(
        handle, sendbuf.data_ptr(), _nbytes(sendbuf), out.data_ptr(),
        _nbytes(out), source, dest, sendtag, recvtag, ctypes.byref(src),
        ctypes.byref(tg)))
    return out, src.value, tg.value


def _ptr_array(tensors):
    arr = (ctypes.c_void_p * max(len(tensors), 1))()
    for i, t in enumerate(tensors):
        arr[i] = t.data_ptr()
    return arr


def _u64_array(sizes):
    return (ctypes.c_uint64 * max(len(sizes), 1))(*sizes)


def host_sendrecv_fused(handle, sends, outs, source, dest, sendtag,
                        recvtag):
    """Every part of ``sends`` in one frame to ``dest``, and one frame
    from ``source`` scattered into ``outs`` (contiguous CPU tensors);
    an empty list is the one-sided half (its partner -1).  Returns
    ``(outs, source, tag)``."""
    sends = [_host(s) for s in sends]
    outs = [_out(o, o.shape, o) for o in outs]
    src, tg = ctypes.c_int32(-1), ctypes.c_int32(-1)
    _check(_lib().t4j_c_sendrecv_fused(
        handle, _ptr_array(sends), _u64_array([_nbytes(s) for s in sends]),
        len(sends), _ptr_array(outs), _u64_array([_nbytes(o) for o in outs]),
        len(outs), source, dest, sendtag, recvtag, ctypes.byref(src),
        ctypes.byref(tg)))
    return outs, src.value, tg.value


def host_alltoall_fused(handle, parts, outs=None):
    """Part ``i`` is ``(comm_size, *rest_i)``; each peer gets one frame
    with its slice of every part (equal to one alltoall a part)."""
    parts = [_host(p) for p in parts]
    outs = ([torch.empty_like(p) for p in parts] if outs is None
            else [_out(o, p.shape, p) for o, p in zip(outs, parts)])
    n = _lib().t4j_comm_size(handle)
    _check(_lib().t4j_c_alltoall_fused(
        handle, _ptr_array(parts), _ptr_array(outs),
        _u64_array([_nbytes(p) // n for p in parts]), len(parts)))
    return outs


# -- the async engine -------------------------------------------------------
#
# A submit hands the progress engine raw pointers, so the tensors behind
# them must outlive the request: the registry holds each request's input
# and output until the wait (or a failed test) consumes it.

_async_reqs = {}  # request id -> {"kind", "out", "keep"}


def _async_submit(kind, rid, out, keep):
    if not rid:
        raise BridgeError(last_error()
                          or f"native {kind} submit failed (no detail)")
    _async_reqs[int(rid)] = {"kind": kind, "out": out, "keep": keep}
    return int(rid)


def host_iallreduce(handle, x, opcode, out=None):
    """Submit a nonblocking allreduce; returns the request id.
    :func:`host_wait` returns the result (in ``out`` when given)."""
    x = _host(x)
    out = _out(out, x.shape, x)
    rid = _lib().t4j_iallreduce(handle, x.data_ptr(), out.data_ptr(),
                                x.numel(), dtype_code(x.dtype), opcode)
    return _async_submit("iallreduce", rid, out, (x,))


def host_ireduce_scatter(handle, x, opcode, out=None):
    """Submit a nonblocking reduce-scatter of ``x`` ``(comm_size,
    *rest)``; the wait returns row ``rank`` reduced."""
    x = _host(x)
    out = _out(out, x.shape[1:], x)
    rid = _lib().t4j_ireduce_scatter(handle, x.data_ptr(), out.data_ptr(),
                                     out.numel(), dtype_code(x.dtype),
                                     opcode)
    return _async_submit("ireduce_scatter", rid, out, (x,))


def host_isend(handle, x, dest, tag):
    x = _host(x)
    rid = _lib().t4j_isend(handle, x.data_ptr(), _nbytes(x), int(dest),
                           int(tag))
    return _async_submit("isend", rid, None, (x,))


def host_irecv(handle, out, source, tag):
    """Submit a nonblocking receive into ``out`` (a contiguous CPU
    tensor); it parks in the engine until a matching message comes."""
    out = _out(out, out.shape, out)
    rid = _lib().t4j_irecv(handle, out.data_ptr(), _nbytes(out), int(source),
                           int(tag))
    return _async_submit("irecv", rid, out, ())


def host_wait(rid):
    """Block until request ``rid`` completes, and consume it.  Returns
    ``(out, source, tag)``: the result tensor (None for an isend) and,
    for an irecv, the envelope the wire gave (-1 otherwise).  A failed
    op, or a second wait, raises :class:`BridgeError`."""
    rec = _async_reqs.pop(int(rid), None)
    src, tag = ctypes.c_int32(-1), ctypes.c_int32(-1)
    _check(_lib().t4j_wait(int(rid), ctypes.byref(src), ctypes.byref(tag)))
    return (None if rec is None else rec["out"]), src.value, tag.value


def host_test(rid):
    """True when request ``rid`` is complete.  It is not consumed: the
    wait fetches the result.  A failed op raises here, consuming it."""
    done = ctypes.c_int32(0)
    status = _lib().t4j_test(int(rid), ctypes.byref(done), None, None)
    if status:
        _async_reqs.pop(int(rid), None)
        _check(status)
    return bool(done.value)


def async_inflight():
    """Requests submitted and not yet complete (0 before the load)."""
    lib = _state["lib"]
    return int(lib.t4j_async_inflight()) if lib is not None else 0


def async_pending():
    """Requests this process submitted and never waited: the engine's
    count once the bridge is up, else the registry's."""
    lib = _state["lib"]
    if lib is not None and lib.t4j_initialized():
        return int(lib.t4j_async_pending())
    return len(_async_reqs)


def async_assert_drained():
    """Raise :class:`BridgeError` if a request was submitted and never
    waited."""
    n = async_pending()
    if n:
        kinds = ", ".join(f"{rec['kind']} (req {rid})"
                          for rid, rec in list(_async_reqs.items())[:8])
        raise BridgeError(
            f"{n} async request(s) never waited: {kinds} — every "
            "iallreduce/ireduce_scatter/isend/irecv must be completed by "
            "wait/waitall exactly once")
