// The plain-C API of the native DCN bridge, for the PyTorch port.
//
// The port loads the bridge through ctypes (mpi4jax_tpu_torch/native/
// runtime.py) and never through XLA, so its library is built from the
// bridge's two XLA-free sources, compiled where they stand
// (mpi4jax_tpu/native/src/dcn.cc and shm.cc), and this file.  It is the
// extern "C" block of mpi4jax_tpu/native/src/ffi.cc (lines 636-1172),
// its thread-local error message (g_tls_err, :39) and its status guard
// (c_guard, :53-65), without the XLA FFI handlers and without any XLA
// header.  The names and signatures are the same, so the port's ctypes
// bindings match the JAX package's one for one.
//
// Data-plane entry points return 0 on success; nonzero means the call
// failed and t4j_last_error() (same thread) holds the contextual
// message, which the port raises as BridgeError.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "dcn.h"
#include "telemetry.h"

namespace {

// last failure message for the ctypes tier (per thread: the Python
// caller reads it right after the failing call on the same thread)
thread_local std::string g_tls_err;

template <typename F>
int32_t c_guard(F&& f) {
  try {
    f();
    return 0;
  } catch (const t4j::BridgeError& e) {
    g_tls_err = e.what();
    return 1;
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return 2;
  }
}

}  // namespace

extern "C" {

int t4j_init() {
  try {
    return t4j::init_from_env();  // 0 ok, 1 not a multi-process job
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return 2;  // bootstrap failed; message via t4j_last_error()
  }
}
void t4j_finalize() { t4j::finalize(); }
int t4j_initialized() { return t4j::initialized() ? 1 : 0; }
int t4j_world_rank() { return t4j::world_rank(); }
int t4j_world_size() { return t4j::world_size(); }
void t4j_set_logging(int enabled) { t4j::set_logging(enabled != 0); }
const char* t4j_last_error() { return g_tls_err.c_str(); }

// fault surface: 0 = healthy, 1 = a bridge failure was posted (every
// further call on any thread fails fast with t4j_fault_msg())
int t4j_health() { return t4j::faulted() ? 1 : 0; }
const char* t4j_fault_msg() {
  thread_local std::string msg;
  msg = t4j::fault_message();
  return msg.c_str();
}
void t4j_set_timeouts(double op_s, double connect_s) {
  t4j::set_timeouts(op_s, connect_s);
}
void t4j_set_tuning(int64_t ring_min_bytes, int64_t seg_bytes) {
  t4j::set_tuning(ring_min_bytes, seg_bytes);
}
void t4j_set_hier(int32_t mode, int64_t min_bytes) {
  t4j::set_hier(mode, min_bytes);
}
// Small-message coalescing threshold (docs/performance.md
// "small-message coalescing"): bytes < 0 keeps, 0 disables fusion,
// > 0 sets.  Must be uniform across ranks like the other data-plane
// knobs.
void t4j_set_coalesce(int64_t bytes) { t4j::set_coalesce(bytes); }
int64_t t4j_coalesce_bytes() { return t4j::coalesce_threshold(); }
// Self-healing transport knobs (docs/failure-semantics.md
// "self-healing transport"); must be set before t4j_init and
// uniformly across ranks.  retry_max < 0 keeps, 0 disables; backoffs
// <= 0 keep; replay_bytes < 0 keeps.
void t4j_set_resilience(int32_t retry_max, double backoff_base_s,
                        double backoff_max_s, int64_t replay_bytes) {
  t4j::set_resilience(retry_max, backoff_base_s, backoff_max_s,
                      replay_bytes);
}
// Wire-path knobs (docs/performance.md "striped links and the
// zero-copy path"): stripes >= 1 sets the dealing width (pre-init it
// also fixes the connections bootstrap builds per link), <= 0 keeps;
// zc_min < 0 keeps, 0 disables MSG_ZEROCOPY, > 0 sets the opt-in
// floor; batch >= 1 sets the frames-per-sendmsg gather cap; emu_flow
// < 0 keeps, 0 disables the per-connection test throttle, > 0 sets it
// (bytes/second).  Must be uniform across ranks; utils/config.py owns
// validation.
void t4j_set_wire(int32_t stripes, int64_t zc_min, int32_t batch,
                  int64_t emu_flow_bps) {
  t4j::set_wire(stripes, zc_min, batch, emu_flow_bps);
}
// Effective wire-path state: built/active stripe width, zerocopy
// floor + whether the kernel honours it, sendmsg batch, throttle,
// and the zerocopy completion diagnostics (completions reaped /
// kernel-copied-anyway — loopback reports copied~completions).
// Returns 1 always (pre-init it reports the requested values).
int32_t t4j_wire_info(int32_t* stripes_built, int32_t* stripes_active,
                      int64_t* zc_min, int32_t* batch,
                      int64_t* emu_flow_bps, int32_t* zerocopy,
                      uint64_t* zc_completions, uint64_t* zc_copied) {
  t4j::WireInfo w;
  t4j::wire_info(&w);
  if (stripes_built) *stripes_built = w.stripes_built;
  if (stripes_active) *stripes_active = w.stripes_active;
  if (zc_min) *zc_min = w.zc_min_bytes;
  if (batch) *batch = w.sendmsg_batch;
  if (emu_flow_bps) *emu_flow_bps = w.emu_flow_bps;
  if (zerocopy) *zerocopy = w.zerocopy ? 1 : 0;
  if (zc_completions) *zc_completions = w.zc_completions;
  if (zc_copied) *zc_copied = w.zc_copied;
  return 1;
}
// Compressed-collective wire dtype (docs/performance.md "Compressed
// collectives"): mode 0 off, 1 bf16, 2 fp8(e4m3); < 0 keeps.
// Runtime-changeable (the calibrator A/Bs it); must be uniform across
// ranks.  utils/config.py owns env validation.
void t4j_set_wire_dtype(int32_t mode) { t4j::set_wire_dtype(mode); }
// Wire backend (docs/performance.md "io_uring wire backend"): mode
// 0 sendmsg, 1 io_uring, 2 auto (< 0 keeps, > 2 clamps to auto).
// Runtime-changeable between collectives (the calibrator A/Bs it);
// must be uniform across ranks.  utils/config.py owns env validation.
void t4j_set_wire_backend(int32_t mode) { t4j::set_wire_backend(mode); }
// Requested mode, whether the kernel's io_uring probe succeeded, and
// whether the uring data plane is actually in effect (mode == uring
// AND supported).  Valid pre-init so ensure_initialized can reject an
// explicit uring request on a kernel without io_uring before sockets
// exist.  Returns 1 always.
int32_t t4j_wire_backend_info(int32_t* mode, int32_t* supported,
                              int32_t* active) {
  int m = 0, s = 0, a = 0;
  t4j::wire_backend_info(&m, &s, &a);
  if (mode) *mode = m;
  if (supported) *supported = s;
  if (active) *active = a;
  return 1;
}
// Effective wire dtype plus the cumulative logical (f32) vs wire
// (compressed) byte counters over the compressed send path — the
// provable byte saving.  Returns 1 always (pre-init it reports the
// requested mode and zero counters).
int32_t t4j_wire_dtype_info(int32_t* mode, uint64_t* logical_bytes,
                            uint64_t* wire_bytes) {
  int m = 0;
  unsigned long long lb = 0, wb = 0;
  t4j::wire_dtype_info(&m, &lb, &wb);
  if (mode) *mode = m;
  if (logical_bytes) *logical_bytes = lb;
  if (wire_bytes) *wire_bytes = wb;
  return 1;
}
// Elastic membership knobs (docs/failure-semantics.md "elastic
// membership"): mode 0 off, 1 shrink, 2 rejoin (other values keep);
// min_world >= 1 sets; resize_timeout_s > 0 sets.  Must be set before
// t4j_init and uniformly across ranks; utils/config.py owns
// validation (including rejecting elastic with T4J_RETRY_MAX=0).
void t4j_set_elastic(int32_t mode, int32_t min_world,
                     double resize_timeout_s) {
  t4j::set_elastic(mode, min_world, resize_timeout_s);
}
// Live membership: world epoch (0 = bootstrap), current member count,
// alive bitmask (bit r = world rank r is a member), whether a resize
// is in progress, and the stale-epoch frame drop counter (diagnostic).
// Returns 1 when filled, 0 before init.
int32_t t4j_world_info(uint32_t* epoch, int32_t* alive_count,
                       uint64_t* alive_mask, int32_t* resizing,
                       uint64_t* stale_frames) {
  t4j::WorldInfo w;
  if (!t4j::world_info(&w)) return 0;
  if (epoch) *epoch = w.epoch;
  if (alive_count) *alive_count = w.alive_count;
  if (alive_mask) *alive_mask = w.alive_mask;
  if (resizing) *resizing = w.resizing ? 1 : 0;
  if (stale_frames) *stale_frames = w.stale_frames;
  return 1;
}
// Block until no resize is in progress (bounded by timeout_s; <= 0 =
// one nonblocking check).  Returns 1 when settled, 0 on timeout.
int32_t t4j_resize_wait(double timeout_s) {
  return t4j::resize_wait(timeout_s) ? 1 : 0;
}
// Per-peer reconnect/replay/syscall counters.  peer >= 0 selects one
// link; peer < 0 aggregates every link (state = worst: 0 up, 1 broken,
// 2 dead).  tx/rx_syscalls count kernel crossings made by the wire
// threads (sendmsg/recv/poll or io_uring_enter) — the syscalls-per-
// frame metric reads these, never a hand-derived estimate.  Returns 1
// when the outputs were filled, 0 before init or for an invalid peer.
int32_t t4j_link_stats(int32_t peer, uint64_t* reconnects,
                       uint64_t* replayed_frames,
                       uint64_t* replayed_bytes, uint64_t* tx_syscalls,
                       uint64_t* rx_syscalls, int32_t* state) {
  t4j::LinkStats s;
  if (!t4j::link_stats(peer, &s)) return 0;
  if (reconnects) *reconnects = s.reconnects;
  if (replayed_frames) *replayed_frames = s.replayed_frames;
  if (replayed_bytes) *replayed_bytes = s.replayed_bytes;
  if (tx_syscalls) *tx_syscalls = s.tx_syscalls;
  if (rx_syscalls) *rx_syscalls = s.rx_syscalls;
  if (state) *state = s.state;
  return 1;
}
// One stripe's reconnect/replay/syscall counters + state (0 up,
// 1 broken, 2 dead).  Returns 1 when filled, 0 before init or for an
// invalid peer/stripe index (docs/performance.md "striped links").
int32_t t4j_link_stripe_stats(int32_t peer, int32_t stripe,
                              uint64_t* reconnects,
                              uint64_t* replayed_frames,
                              uint64_t* replayed_bytes,
                              uint64_t* tx_syscalls,
                              uint64_t* rx_syscalls, int32_t* state) {
  t4j::LinkStats s;
  if (!t4j::link_stripe_stats(peer, stripe, &s)) return 0;
  if (reconnects) *reconnects = s.reconnects;
  if (replayed_frames) *replayed_frames = s.replayed_frames;
  if (replayed_bytes) *replayed_bytes = s.replayed_bytes;
  if (tx_syscalls) *tx_syscalls = s.tx_syscalls;
  if (rx_syscalls) *rx_syscalls = s.rx_syscalls;
  if (state) *state = s.state;
  return 1;
}
// Bootstrap topology (host_id, local_rank, local_size, leader_rank,
// n_hosts); returns 0 and leaves the outputs untouched before init.
int32_t t4j_topo(int32_t* host_id, int32_t* local_rank,
                 int32_t* local_size, int32_t* leader_rank,
                 int32_t* n_hosts) {
  t4j::TopoInfo t;
  if (!t4j::topology(&t)) return 0;
  if (host_id) *host_id = t.host_id;
  if (local_rank) *local_rank = t.local_rank;
  if (local_size) *local_size = t.local_size;
  if (leader_rank) *leader_rank = t.leader_rank;
  if (n_hosts) *n_hosts = t.n_hosts;
  return 1;
}
// Pure selection query (never communicates): would a collective of
// total_bytes on this comm take the hierarchical path right now?
int32_t t4j_hier_would_select(int32_t comm, uint64_t total_bytes) {
  try {
    return t4j::hier_would_select(comm, total_bytes) ? 1 : 0;
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return -1;
  }
}
int32_t t4j_hier_active(int32_t comm) {
  try {
    return t4j::hier_active(comm) ? 1 : 0;
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return -1;
  }
}
void t4j_abort_notify(const char* why) { t4j::abort_notify(why); }

// ---- telemetry control surface (docs/observability.md) ------------------
//
// mode: 0 off, 1 counters, 2 trace (< 0 keeps); ring_bytes sizes the
// per-rank event ring (< 0 keeps; clamped to a small floor).  Must be
// set before the first instrumented call — the ring is sized on first
// use and never re-sized.  utils/config.py owns validation
// (T4J_TELEMETRY / T4J_TELEMETRY_BYTES); the env parse in telemetry.h
// is the fallback for hand-run processes.
void t4j_set_telemetry(int32_t mode, int64_t ring_bytes) {
  t4j::tel::set(mode, ring_bytes);
}
int32_t t4j_telemetry_mode() { return t4j::tel::mode(); }
// Consume up to max_bytes/32 ring events (oldest first) into `out` as
// packed 32-byte records (telemetry/schema.py mirrors the layout);
// returns bytes written.  Call repeatedly until 0.
int64_t t4j_telemetry_drain(void* out, int64_t max_bytes) {
  if (!out || max_bytes < 0) return 0;
  return static_cast<int64_t>(
      t4j::tel::drain(out, static_cast<size_t>(max_bytes)));
}
// Copy the NEWEST events without consuming (the check_health
// post-mortem peek); same record format, returns bytes written.
int64_t t4j_telemetry_peek_last(void* out, int64_t max_bytes) {
  if (!out || max_bytes < 0) return 0;
  return static_cast<int64_t>(
      t4j::tel::peek_last(out, static_cast<size_t>(max_bytes)));
}
uint64_t t4j_telemetry_dropped() { return t4j::tel::dropped(); }
// Clock anchor: one (monotonic, realtime) pair captured right after
// the bootstrap join barrier (or lazily now for single-process jobs).
// Returns 1 when a bootstrap anchor existed, 0 when it was captured
// lazily by this call.
int32_t t4j_telemetry_anchor(uint64_t* mono_ns, uint64_t* unix_ns) {
  return t4j::tel::anchor(mono_ns, unix_ns) ? 1 : 0;
}
// Metrics-table snapshot as u64 words (header + nonzero rows; layout
// in telemetry.h / telemetry/schema.py).  out == null returns the
// word count required.
int64_t t4j_metrics_snapshot(uint64_t* out, int64_t max_words) {
  return static_cast<int64_t>(t4j::tel::metrics_snapshot(
      out, max_words < 0 ? 0 : static_cast<size_t>(max_words)));
}
// Step marker (ops.step.annotate_step / step_scope): emit a step-
// boundary event — phase 1 begin, 2 end — with the caller-assigned
// step index.  No-op below counters mode; never fails.
void t4j_annotate_step(int64_t index, int32_t phase) {
  t4j::tel::step_event(
      phase == 2 ? t4j::tel::kEnd : t4j::tel::kBegin,
      index < 0 ? 0 : static_cast<uint64_t>(index));
}
// Flight recorder (docs/observability.md "flight recorder"): on < 0
// keeps, dir null/empty keeps.  Must run before t4j_init — the mmap'd
// arena is created once during init, while still single-threaded.
// utils/config.py owns validation (T4J_FLIGHT / T4J_FLIGHT_DIR); the
// env parse in telemetry.h is the fallback for hand-run processes.
void t4j_set_flight(int32_t on, const char* dir) {
  t4j::tel::set_flight(on, dir);
}
// Live status of this rank's flight recorder: returns 1 and fills the
// out-params when active, 0 when off/unmapped.  heartbeat_ns is the
// recorder's CLOCK_MONOTONIC heartbeat (compare against the anchor to
// translate to wall time).
int32_t t4j_flight_info(char* path_out, int32_t path_cap,
                        uint64_t* file_bytes, uint64_t* heartbeat_ns,
                        uint64_t* heartbeat_count, uint64_t* epoch) {
  std::string path;
  uint64_t fb = 0, hb = 0, hc = 0, ep = 0;
  if (!t4j::tel::flight_info(&path, &fb, &hb, &hc, &ep)) return 0;
  if (path_out && path_cap > 0) {
    std::snprintf(path_out, static_cast<size_t>(path_cap), "%s",
                  path.c_str());
  }
  if (file_bytes) *file_bytes = fb;
  if (heartbeat_ns) *heartbeat_ns = hb;
  if (heartbeat_count) *heartbeat_count = hc;
  if (epoch) *epoch = ep;
  return 1;
}

// ---- async progress engine (docs/async.md) ------------------------------
//
// Nonblocking submits return a request id (> 0) or 0 on failure (the
// message is in t4j_last_error on this thread).  Buffers must stay
// valid until the request completes; every request must be consumed
// by wait/waitall (or test returning done) exactly once — leaks are
// reported at finalize.

uint64_t t4j_iallreduce(int32_t comm, const void* in, void* out,
                        uint64_t count, int32_t dt, int32_t op) {
  try {
    return t4j::iallreduce(comm, in, out, count,
                           static_cast<t4j::DType>(dt),
                           static_cast<t4j::ReduceOp>(op));
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return 0;
  }
}
uint64_t t4j_ireduce_scatter(int32_t comm, const void* in, void* out,
                             uint64_t count_each, int32_t dt, int32_t op) {
  try {
    return t4j::ireduce_scatter(comm, in, out, count_each,
                                static_cast<t4j::DType>(dt),
                                static_cast<t4j::ReduceOp>(op));
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return 0;
  }
}
uint64_t t4j_isend(int32_t comm, const void* buf, uint64_t nbytes,
                   int32_t dest, int32_t tag) {
  try {
    return t4j::isend(comm, buf, nbytes, dest, tag);
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return 0;
  }
}
uint64_t t4j_irecv(int32_t comm, void* buf, uint64_t nbytes,
                   int32_t source, int32_t tag) {
  try {
    return t4j::irecv(comm, buf, nbytes, source, tag);
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return 0;
  }
}
// Blocks until the request completes and consumes it; src_out/tag_out
// carry the matched envelope for irecv (null ok).
int32_t t4j_wait(uint64_t req, int32_t* src_out, int32_t* tag_out) {
  return c_guard([&] {
    int s = -1, t = -1;
    t4j::wait(req, &s, &t);
    if (src_out) *src_out = s;
    if (tag_out) *tag_out = t;
  });
}
// Nonblocking probe: *done = 1 when complete (request NOT consumed —
// a later wait reaps it); a failed op returns nonzero and consumes.
int32_t t4j_test(uint64_t req, int32_t* done, int32_t* src_out,
                 int32_t* tag_out) {
  return c_guard([&] {
    int s = -1, t = -1;
    bool d = t4j::test(req, &s, &t);
    if (done) *done = d ? 1 : 0;
    if (d) {
      if (src_out) *src_out = s;
      if (tag_out) *tag_out = t;
    }
  });
}
int32_t t4j_waitall(const uint64_t* reqs, int32_t n) {
  return c_guard([&] { t4j::waitall(reqs, n); });
}
// In-flight-depth gauge (submitted, not yet complete) and the
// never-consumed request count (the finalize leak check's input).
int32_t t4j_async_inflight() { return t4j::async_inflight(); }
int32_t t4j_async_pending() { return t4j::async_pending(); }

int t4j_comm_create(const int32_t* ranks, int32_t n, int32_t ctx) {
  try {
    return t4j::comm_create(reinterpret_cast<const int*>(ranks),
                            static_cast<int>(n), static_cast<int>(ctx));
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return -1;
  }
}
int t4j_comm_rank(int32_t comm) {
  try {
    return t4j::comm_rank(comm);
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return -1;
  }
}
int t4j_comm_size(int32_t comm) {
  try {
    return t4j::comm_size(comm);
  } catch (const std::exception& e) {
    g_tls_err = e.what();
    return -1;
  }
}
void t4j_abort(int32_t code) { t4j::abort_job(code, "user abort"); }

// ctypes data plane: used by the host-callback tier (TPU jits stage
// HBM->host via jax io_callback, then these run the wire ops — the
// analog of the reference's GPU COPY_TO_HOST staging path,
// mpi_xla_bridge_gpu.pyx:211-251).

int32_t t4j_c_send(int32_t comm, const void* buf, uint64_t nbytes,
                   int32_t dest, int32_t tag) {
  return c_guard([&] { t4j::send(comm, buf, nbytes, dest, tag); });
}
int32_t t4j_c_recv(int32_t comm, void* buf, uint64_t nbytes, int32_t source,
                   int32_t tag, int32_t* src_out, int32_t* tag_out) {
  return c_guard([&] {
    int s = 0, t = 0;
    t4j::recv(comm, buf, nbytes, source, tag, &s, &t);
    if (src_out) *src_out = s;
    if (tag_out) *tag_out = t;
  });
}
int32_t t4j_c_sendrecv(int32_t comm, const void* sendbuf,
                       uint64_t send_nbytes, void* recvbuf,
                       uint64_t recv_nbytes, int32_t source, int32_t dest,
                       int32_t sendtag, int32_t recvtag, int32_t* src_out,
                       int32_t* tag_out) {
  return c_guard([&] {
    int s = 0, t = 0;
    t4j::sendrecv(comm, sendbuf, send_nbytes, recvbuf, recv_nbytes, source,
                  dest, sendtag, recvtag, &s, &t);
    if (src_out) *src_out = s;
    if (tag_out) *tag_out = t;
  });
}
int32_t t4j_c_barrier(int32_t comm) {
  return c_guard([&] { t4j::barrier(comm); });
}
int32_t t4j_c_bcast(int32_t comm, void* buf, uint64_t nbytes, int32_t root) {
  return c_guard([&] { t4j::bcast(comm, buf, nbytes, root); });
}
int32_t t4j_c_allreduce(int32_t comm, const void* in, void* out,
                        uint64_t count, int32_t dt, int32_t op) {
  return c_guard([&] {
    t4j::allreduce(comm, in, out, count, static_cast<t4j::DType>(dt),
                   static_cast<t4j::ReduceOp>(op));
  });
}
int32_t t4j_c_reduce(int32_t comm, const void* in, void* out, uint64_t count,
                     int32_t dt, int32_t op, int32_t root) {
  return c_guard([&] {
    t4j::reduce(comm, in, out, count, static_cast<t4j::DType>(dt),
                static_cast<t4j::ReduceOp>(op), root);
  });
}
int32_t t4j_c_scan(int32_t comm, const void* in, void* out, uint64_t count,
                   int32_t dt, int32_t op) {
  return c_guard([&] {
    t4j::scan(comm, in, out, count, static_cast<t4j::DType>(dt),
              static_cast<t4j::ReduceOp>(op));
  });
}
int32_t t4j_c_hier_allreduce(int32_t comm, const void* in, void* out,
                             uint64_t count, int32_t dt, int32_t op) {
  return c_guard([&] {
    t4j::hier_allreduce(comm, in, out, count, static_cast<t4j::DType>(dt),
                        static_cast<t4j::ReduceOp>(op));
  });
}
int32_t t4j_c_reduce_scatter(int32_t comm, const void* in, void* out,
                             uint64_t count_each, int32_t dt, int32_t op) {
  return c_guard([&] {
    t4j::reduce_scatter(comm, in, out, count_each,
                        static_cast<t4j::DType>(dt),
                        static_cast<t4j::ReduceOp>(op));
  });
}
int32_t t4j_c_allgather(int32_t comm, const void* in, void* out,
                        uint64_t nbytes_each) {
  return c_guard([&] { t4j::allgather(comm, in, out, nbytes_each); });
}
int32_t t4j_c_gather(int32_t comm, const void* in, void* out,
                     uint64_t nbytes_each, int32_t root) {
  return c_guard([&] { t4j::gather(comm, in, out, nbytes_each, root); });
}
int32_t t4j_c_scatter(int32_t comm, const void* in, void* out,
                      uint64_t nbytes_each, int32_t root) {
  return c_guard([&] { t4j::scatter(comm, in, out, nbytes_each, root); });
}
int32_t t4j_c_alltoall(int32_t comm, const void* in, void* out,
                       uint64_t nbytes_each) {
  return c_guard([&] { t4j::alltoall(comm, in, out, nbytes_each); });
}
// Fused multi-part p2p (small-message coalescing): pointer-array
// iovec surface for the staged/host-callback tier and standalone
// harnesses.  Part sizes travel as u64 so ctypes callers never deal
// with platform size_t.
int32_t t4j_c_sendrecv_fused(int32_t comm, void* const* send_parts,
                             const uint64_t* send_nbytes, int32_t n_send,
                             void* const* recv_parts,
                             const uint64_t* recv_nbytes, int32_t n_recv,
                             int32_t source, int32_t dest, int32_t sendtag,
                             int32_t recvtag, int32_t* src_out,
                             int32_t* tag_out) {
  return c_guard([&] {
    std::vector<size_t> sb(send_nbytes, send_nbytes + n_send);
    std::vector<size_t> rb(recv_nbytes, recv_nbytes + n_recv);
    int s = -1, t = -1;
    t4j::sendrecv_fused(comm, const_cast<const void* const*>(send_parts),
                        sb.data(), n_send, recv_parts, rb.data(), n_recv,
                        source, dest, sendtag, recvtag, &s, &t);
    if (src_out) *src_out = s;
    if (tag_out) *tag_out = t;
  });
}
int32_t t4j_c_alltoall_fused(int32_t comm, void* const* parts,
                             void* const* outs,
                             const uint64_t* nbytes_each, int32_t nparts) {
  return c_guard([&] {
    std::vector<size_t> each(nbytes_each, nbytes_each + nparts);
    t4j::alltoall_fused(comm, const_cast<const void* const*>(parts), outs,
                        each.data(), nparts);
  });
}

}  // extern "C"
