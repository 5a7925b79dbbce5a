"""Continuous-batching tensor-parallel inference engine (docs/serving.md).

The port's counterpart of ``mpi4jax_tpu/serving/engine.py``.  It turns
``models/transformer.py``'s prefill and cached decode step into a served
loop: the KV cache is a pool of ``max_batch`` *slots*, every engine
step decodes every slot one position (:func:`_decode_step_slots`, each
slot at its own depth) while a queued request's prefill is admitted
into a free slot in the same step, so a long generation never blocks a
short request and the batch stays as full as admission allows.

Control plane: rank 0 is the frontend (load generator, admission
controller, scheduler); every step it broadcasts a fixed-size int64
plan vector (:mod:`.plan`) over the proc tier's ``host_bcast``, and the
followers execute it against a :class:`~.scheduler.FollowerMirror`
whose digest is checked every step.  On one rank the leader is the
whole control plane.  A ``MeshComm`` of several ranks (threads over
gloo or NCCL) has no such control plane in the JAX package either, and
is refused.

Data plane: the per-layer Megatron f/g allreduces inside the decode
and the prefill, on the comm's own transport (a proc comm stages CUDA
tensors through host memory).  PyTorch launches asynchronously, so in
eager mode the decode's kernels are queued before the prefills' either
way; ``overlap=False`` synchronises the card after the decode, before
any prefill is launched, as the JAX engine blocks on the decode's
result.  A proc comm's staged allreduce synchronises the host at every
layer anyway.  The decode's time reaches the admission estimator apart
from the prefills' (:meth:`ServingEngine._execute`).

The slot step reads no position on the host: the positions and last
tokens are copied into static device buffers before it, so its shapes
(``max_batch x max_len``) and buffers are those a CUDA graph could hold.

Each step runs in a ``step_scope`` marker, and the leader publishes its
:class:`~.stats.ServingStats` snapshot after every step.

Left for ROADMAP Queue 1 item 19: riding a resize (``WorldResized``
propagates out of :meth:`ServingEngine.step` unchanged), promotion of a
follower when the leader dies, the ``T4J_REJOIN=1`` joiner's bootstrap
and the autoscale wiring (:meth:`ServingEngine.enable_autoscale`
raises).
"""

import os
import time

import numpy as np
import torch

from mpi4jax_tpu_torch.kernels.flash import _NEG  # finite mask value
from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops import step as step_mod
from mpi4jax_tpu_torch.ops.allreduce import allreduce
from mpi4jax_tpu_torch.parallel.longseq import _scores, _weighted_values
from mpi4jax_tpu_torch.serving import plan as plan_mod
from mpi4jax_tpu_torch.serving import stats as stats_mod
from mpi4jax_tpu_torch.serving.admission import (
    AdmissionController,
    SLOEstimator,
    TokenBucket,
)
from mpi4jax_tpu_torch.serving.scheduler import FollowerMirror, SlotScheduler
from mpi4jax_tpu_torch.serving.stats import ServingStats
from mpi4jax_tpu_torch.utils import config
from mpi4jax_tpu_torch.utils.runtime import resolve_device

__all__ = ["ServingEngine", "shard_params"]

ITEM_19 = "ROADMAP Queue 1 item 19"


def shard_params(params, tp, rank):
    """Rank ``rank``'s tensor-parallel shard of full (replicated)
    transformer parameters: the qkv and MLP-up column blocks, the o and
    MLP-down row blocks, everything else whole (the layout of
    ``models.transformer.param_specs``).  Contiguous copies."""
    if tp == 1:
        return params
    b = params.blocks

    def cols(w):  # (L, d, n) -> rank's n/tp column block
        n = w.shape[2]
        if n % tp:
            raise ValueError(f"cannot shard {n} columns over tp={tp}")
        k = n // tp
        return w[:, :, rank * k:(rank + 1) * k].contiguous()

    def rows(w):  # (L, n, d) -> rank's n/tp row block
        n = w.shape[1]
        if n % tp:
            raise ValueError(f"cannot shard {n} rows over tp={tp}")
        k = n // tp
        return w[:, rank * k:(rank + 1) * k, :].contiguous()

    blocks = b._replace(
        wq=cols(b.wq), wk=cols(b.wk), wv=cols(b.wv), wo=rows(b.wo),
        w1=cols(b.w1), w2=rows(b.w2),
    )
    return params._replace(blocks=blocks)


def _slot_attention(q, k, v, pos):
    """Causal attention of one query per slot over its slot's cache,
    each row at its own position: row b sees the cache positions
    ``<= pos[b]``.  ``local_attention``'s dense path with a per-row
    offset (the JAX engine vmaps it over the rows): f32 scores, the same
    finite mask value, softmax, f32 accumulation.  ``q``: [B, 1, Hq, D];
    ``k``/``v``: [B, S, Hkv, D]; ``pos``: [B] int64 on their device."""
    s = _scores(q, k, 1.0 / float(q.shape[-1]) ** 0.5)  # [B, Hq, 1, S]
    kpos = torch.arange(k.shape[1], device=k.device)
    seen = (kpos[None, :] <= pos[:, None])[:, None, None, :]
    w = torch.softmax(torch.where(seen, s, _NEG), dim=-1)
    return _weighted_values(w.to(v.dtype), v, q.shape[2]).to(q.dtype)


def _decode_step_slots(params, cache, last_tok, pos, cfg, comm_tp, hq_l,
                       hk_l):
    """One decode step over EVERY slot, each at its own position: the
    cached decode step (``models.transformer._decode_step_sharded``) with
    its one position generalised to a ``[B]`` vector.  Inactive slots are
    computed and ignored (static shapes).

    ``cache``: (layers, 2, B, max_len, Hkv_local, dh), written in place:
    row b's K/V at ``pos[b]`` (a scatter, which gives the bits of the
    JAX engine's exact one-hot multiply-add); ``last_tok``, ``pos``:
    [B] int64 on the cache's device, read by the kernels only.  Returns
    ``(cache, logits)`` with the [B, V] logits."""
    dh = cfg.head_dim
    b = last_tok.shape[0]
    rows = torch.arange(b, device=pos.device)
    x = params.embed[last_tok][:, None, :]  # (B, 1, d)
    token = None
    for i in range(cfg.layers):
        bp = tfm._layer(params.blocks, i)
        h = tfm._rmsnorm(x, bp.ln1, cfg.eps)
        h, token = tfm._f_collective(h, comm_tp, token)
        q = (h @ bp.wq).reshape(b, 1, hq_l, dh)
        cache[i, 0].index_put_((rows, pos), (h @ bp.wk).reshape(b, hk_l, dh))
        cache[i, 1].index_put_((rows, pos), (h @ bp.wv).reshape(b, hk_l, dh))
        attn = _slot_attention(q, cache[i, 0], cache[i, 1], pos)
        a_part = attn.reshape(b, 1, hq_l * dh) @ bp.wo
        a, token = allreduce(a_part, reductions.SUM, comm=comm_tp,
                             token=token)
        x = x + a
        h2 = tfm._rmsnorm(x, bp.ln2, cfg.eps)
        m, token = tfm._dense_mlp(h2, bp, cfg, comm_tp, None, token)
        x = x + m
    x = tfm._rmsnorm(x, params.ln_f, cfg.eps)
    return cache, (x @ params.head)[:, 0, :]


def _check_comm(comm):
    if comm.size == 1 or comm.backend == "proc":
        return
    raise ValueError(
        f"the serving engine's control plane across {comm.size} ranks is "
        f"the proc tier's host_bcast (the JAX engine's too), and a "
        f"{comm.backend!r} comm has none: run the ranks under python -m "
        "mpi4jax_tpu_torch.launch -np N (a ProcComm), or serve on one "
        "rank"
    )


class ServingEngine:
    """One rank's half of the serving loop (the leader on rank 0).

    ``comm`` is the tensor-parallel communicator: a ``SelfComm`` (or any
    one-rank comm) or the proc world of a launcher job; ``params`` are
    FULL (replicated) parameters, which the engine shards and places on
    ``device`` (the card unless the caller passes ``"cpu"``).  Knobs
    default from the environment (``T4J_MAX_BATCH`` / ``T4J_ADMIT`` /
    ``T4J_SLO_MS``, ``utils/config.py``).
    """

    def __init__(self, comm, cfg, params, *, max_len, max_batch=None,
                 admit=None, slo_ms=None, rate_limit=0.0, burst=8,
                 overlap=True, markers=True, seed_step_ms=20.0,
                 fabric_poll_s=0.5, estimator=None, plan_log=None,
                 device="cuda"):
        _check_comm(comm)
        if os.environ.get("T4J_REJOIN") == "1":
            raise ValueError(
                "T4J_REJOIN=1: a rank joining a serving epoch rebuilds "
                "its mirror from the leader's plan log, which comes with "
                f"serving's elastic epochs ({ITEM_19})"
            )
        self.device = resolve_device(device)
        self.comm = comm
        self.cfg = cfg
        self.tp = comm.size
        self.rank = comm.rank()
        self.is_leader = self.rank == 0
        self.max_len = int(max_len)
        self.max_batch = (config.max_batch() if max_batch is None
                          else int(max_batch))
        self.admit_mode = (config.admit_mode() if admit is None
                           else admit)
        slo = config.slo_ms() if slo_ms is None else float(slo_ms)
        if self.admit_mode == "off":
            slo = 0.0  # cannot be enforced; config rejects it being set
        self.slo_ms = slo
        self.overlap = bool(overlap)
        self.markers = bool(markers)
        tfm._check_tp_divisibility(cfg, self.tp)
        self.hq_l = cfg.heads // self.tp
        self.hk_l = cfg.kv_heads // self.tp
        self.params = tfm._from_leaves(
            [t.detach().to(self.device) for t in
             tfm._leaves(shard_params(params, self.tp, self.rank))])
        self.cache = tfm._new_cache(cfg, self.max_batch, self.max_len,
                                    self.hk_l, self.params.embed)
        # the slot step's inputs: static device buffers, filled by copy
        self._pos = torch.zeros(self.max_batch, dtype=torch.int64,
                                device=self.device)
        self._last = torch.zeros_like(self._pos)
        # host-side token buffers (one row per slot)
        self.toks = np.zeros((self.max_batch, self.max_len), np.int64)
        self._row_len = np.zeros(self.max_batch, np.int64)
        self.finished = []  # (rid, token tuple) in completion order

        self.stats = ServingStats(
            slo_ms=self.slo_ms, max_batch=self.max_batch,
            admit_mode=self.admit_mode,
        )
        if self.is_leader:
            self.sched = SlotScheduler(self.max_batch, self.max_len)
            est = estimator or SLOEstimator(seed_step_ms=seed_step_ms)
            bucket = (TokenBucket(rate_limit, burst)
                      if rate_limit else None)
            self.ctrl = AdmissionController(
                self.admit_mode, slo_ms=self.slo_ms, estimator=est,
                bucket=bucket,
            )
            self.mirror = None
        else:
            self.sched = None
            self.ctrl = None
            self.mirror = FollowerMirror(self.max_batch, self.max_len)

        # the leader's plan-stream recorder: every broadcast vector is
        # appended, so a follower's drift replays offline
        # (serving/plan.py replay_stream)
        if plan_log is None:
            plan_log = os.environ.get("T4J_PLAN_LOG") or None
        self.plan_log = plan_log if self.is_leader else None

        self._plan_words = plan_mod.plan_words(self.max_batch,
                                               self.max_len)
        self._stopped = False
        self._fabric_poll_s = float(fabric_poll_s)
        self._last_fabric_poll = 0.0

    # ---- the bodies ------------------------------------------------------

    def _prefill_bucket(self, p_len):
        """Compile-size bucket of the JAX engine: the smallest power of
        two >= p_len (floor 8), capped at max_len.  The prompt is padded
        to it, so the slot's cache row holds the K/V of every bucket
        position (the padding's are overwritten in order by the decode
        steps that follow, and causally invisible before that)."""
        b = 8
        while b < p_len:
            b <<= 1
        return min(b, self.max_len)

    def _prefill(self, padded, slot, p_len):
        """The prefill of ``padded`` ([1, bucket] int64 on the device)
        into ``slot``: the slot's whole ``max_len`` row zeroed, the
        bucket's K/V written into it (so no earlier occupant's K/V
        survives, as the JAX engine's row update leaves none), and the
        logits of position ``p_len - 1``."""
        row = self.cache[:, :, slot:slot + 1]
        row.zero_()
        _, logits = tfm._prefill_sharded(
            self.params, padded, self.cfg, self.comm, self.hq_l, self.hk_l,
            self.max_len, logits_pos=p_len - 1, cache=row,
        )
        return logits[0]

    # ---- leader: request intake -----------------------------------------

    SHED_PROMPT = "prompt-too-long"

    def offer(self, req, now_ms):
        """Admission decision for one arriving request (leader only).
        Returns ``"admit"`` or ``"shed"``."""
        assert self.is_leader, "offer() is the leader's entry point"
        self.stats.observe_submitted()
        if req.prompt_len >= self.max_len:
            # unservable regardless of load: no room to generate.  Shed
            # (counted) instead of letting sched.submit raise and take
            # the serving loop down with one oversized request
            self.sched.shed_request(req, now_ms, self.SHED_PROMPT)
            self.stats.observe_shed(self.SHED_PROMPT)
            return "shed"
        verdict, reason = self.ctrl.decide(req, now_ms, self.sched)
        if verdict == "admit":
            self.sched.submit(req, now_ms)
        else:
            self.sched.shed_request(req, now_ms, reason)
            self.stats.observe_shed(reason)
        return verdict

    def _poll_fabric(self, now_ms):
        """Feed the admission controller the worst-link gauges from this
        rank's own link stats (``native/runtime.py:link_stats``, None
        outside a launcher job), at most every ``fabric_poll_s``."""
        if now_ms - self._last_fabric_poll < self._fabric_poll_s * 1e3:
            return
        self._last_fabric_poll = now_ms
        from mpi4jax_tpu_torch.native import runtime

        agg = runtime.link_stats() or {}
        view = {"worst_link": {
            "state": agg.get("state", 0),
            "reconnects": agg.get("max_reconnects", 0),
            "peer": agg.get("worst_peer"),
            "rank": self.rank,
        }}
        self.ctrl.observe_fabric(view)

    def set_fabric_view(self, job_view):
        """Feed an exporter job-view dict into admission's degradation
        model."""
        if self.ctrl is not None:
            self.ctrl.observe_fabric(job_view)

    # ---- the step --------------------------------------------------------

    def _bcast(self, vec_or_none):
        if vec_or_none is None:
            vec = np.zeros(self._plan_words, np.int64)
        else:
            vec = np.asarray(vec_or_none, np.int64)
        if self.tp == 1:
            return vec  # the leader is the whole control plane
        from mpi4jax_tpu_torch.native import runtime

        return runtime.host_bcast(runtime.comm_handle(self.comm),
                                  torch.from_numpy(vec), 0).numpy()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def _execute(self, admissions, decode_slots, positions):
        """Run one step: the decode over all slots (when any slot is
        active), then each admission's prefill.  Returns ``(decode_ms,
        prefill_ms)``: the wall up to the decode's tokens (its device
        time included), and the marginal wall the prefills added after
        that, so that a batch with a slot always decoding still teaches
        the prefill estimator.

        The prefills are launched before the decode's tokens are read
        (eager launches cost host time), so on the card the decode is
        timed by a CUDA event pair: from an event recorded at the start
        (the stream is idle then: the last step read its tokens) to one
        recorded after the decode's argmax.  On the CPU every op runs
        synchronously and the host clock after the argmax is the
        decode's end."""
        t0 = time.perf_counter()
        on_card = self.device.type == "cuda"
        decode_out = None
        decode_ms = 0.0
        if decode_slots:
            if on_card:
                ev_start = torch.cuda.Event(enable_timing=True)
                ev_end = torch.cuda.Event(enable_timing=True)
                ev_start.record()
            pos_all = np.zeros(self.max_batch, np.int64)
            last_all = np.zeros(self.max_batch, np.int64)
            for s, p in zip(decode_slots, positions):
                pos_all[s] = p
                last_all[s] = self.toks[s, p]
            self._pos.copy_(torch.from_numpy(pos_all))
            self._last.copy_(torch.from_numpy(last_all))
            _, logits = _decode_step_slots(
                self.params, self.cache, self._last, self._pos, self.cfg,
                self.comm, self.hq_l, self.hk_l,
            )
            decode_out = torch.argmax(logits, dim=-1)  # the first maximum
            if on_card:
                ev_end.record()
                if not self.overlap:
                    self._sync()
            else:
                decode_ms = (time.perf_counter() - t0) * 1e3
        prefill_out = []
        for slot, _rid, prompt, _max_new in admissions:
            p_len = len(prompt)
            padded = np.zeros((1, self._prefill_bucket(p_len)), np.int64)
            padded[0, :p_len] = prompt
            self.toks[slot] = 0
            self.toks[slot, :p_len] = prompt
            self._row_len[slot] = p_len
            logits = self._prefill(
                torch.from_numpy(padded).to(self.device), slot, p_len)
            prefill_out.append((slot, torch.argmax(logits)))
        # the decode's tokens first (launched first), then the prefills'
        if decode_out is not None:
            nxt = decode_out.cpu().numpy()
            for s, p in zip(decode_slots, positions):
                self.toks[s, p + 1] = nxt[s]
                self._row_len[s] = p + 2
            if on_card:  # the read above waited for ev_end
                decode_ms = ev_start.elapsed_time(ev_end)
        for slot, tok in prefill_out:
            p_len = int(self._row_len[slot])
            self.toks[slot, p_len] = int(tok)
            self._row_len[slot] = p_len + 1
        wall_ms = (time.perf_counter() - t0) * 1e3
        return decode_ms, max(wall_ms - decode_ms, 0.0)

    def step(self, now_ms=None):
        """One serve step.  Leader: plan + broadcast + execute + book;
        follower: receive + verify + execute + book.  Returns False once
        a stop plan has been processed.  A ``WorldResized`` propagates
        unchanged (riding it comes with the port's elastic jobs)."""
        if self._stopped:
            return False
        if now_ms is None:
            now_ms = time.monotonic() * 1e3
        if self.is_leader:
            return self._leader_step(now_ms)
        return self._follower_step()

    def _scoped(self, step, fn):
        if not self.markers:
            return fn()
        with step_mod.step_scope(f"serve:{step}"):
            return fn()

    def _leader_step(self, now_ms, stop=False):
        self._poll_fabric(now_ms)
        for req in self.ctrl.reconsider_queued(now_ms, self.sched):
            self.stats.observe_shed(req.shed_reason)
        digest = self.sched.state_digest()
        plan = self.sched.plan_step(now_ms)
        vec = plan_mod.encode_plan(plan, self.max_batch, self.max_len,
                                   digest, stop=stop)
        if self.plan_log:
            plan_mod.append_plan_stream(
                self.plan_log, vec, self.max_batch, self.max_len,
                world=self.tp,
            )
        self._bcast(vec)
        admissions = [
            (slot, req.rid, req.prompt, req.max_new)
            for slot, req in plan.admissions
        ]
        t0 = time.perf_counter()
        decode_ms, prefill_ms = self._scoped(plan.step, lambda: self._execute(
            admissions, plan.decode_slots, plan.positions))
        wall_ms = (time.perf_counter() - t0) * 1e3
        est = self.ctrl.estimator
        if plan.decode_slots:
            est.observe_step(decode_ms)
        if admissions:
            # the marginal prefill cost when a decode shared the step (so
            # the prefill model keeps learning under load), the full
            # wall otherwise
            p_wall = (prefill_ms if plan.decode_slots
                      else decode_ms + prefill_ms)
            if p_wall > 0:
                est.observe_prefill(
                    p_wall, max(len(p) for _s, _r, p, _m in admissions))
        # completions happened at the END of the executed step: stamp
        # them with the post-execution clock, or TTFT and latency would
        # leave out the step that produced the token
        done_ms = now_ms + wall_ms
        for slot, _req in plan.admissions:
            self.sched.prefill_done(slot, done_ms)
        self.sched.step_done(plan, done_ms)
        for req in self.sched.finished:
            # completion and harvest in the same step: the freed slot's
            # host row still holds the tokens (a new admission can only
            # land there in the NEXT plan)
            n = req.prompt_len + req.generated
            row = self.toks[req.last_slot, :n]
            self.finished.append((req.rid, tuple(int(t) for t in row)))
            self.stats.observe_completed(req)
        self.sched.finished.clear()
        self.stats.observe_step(self.sched.queue_depth(),
                                self.sched.occupancy())
        return self._publish(stop)

    def _publish(self, stop):
        snap = self.stats.snapshot()
        if stop:
            # the final gauges stay visible, marked: a live scrape must
            # tell a stopped engine from a running one
            snap["stopped"] = True
        stats_mod.publish(snap)
        if stop:
            self._stopped = True
            return False
        return True

    def _follower_step(self):
        vec = self._bcast(None)
        decoded = plan_mod.decode_plan(
            vec, self.max_batch, self.max_len,
            expect_digest=self.mirror.state_digest(),
        )

        def run():
            admitted, finished = self.mirror.apply(decoded)
            self._execute(admitted, decoded["decode_slots"],
                          decoded["positions"])
            return admitted, finished

        admitted, finished = self._scoped(decoded["step"], run)
        # the leader's completion order: prefill-instant completions
        # first (prefill_done runs before step_done there), then the
        # decode completions
        done = [self.mirror.prefill_done(slot)
                for slot, _rid, _prompt, _mn in admitted]
        for slot, rid in [d for d in done if d is not None] + list(finished):
            n = int(self._row_len[slot])
            self.finished.append(
                (rid, tuple(int(t) for t in self.toks[slot, :n])))
        self.stats.observe_step(0, self.mirror.occupancy())
        return self._publish(decoded["stop"])

    # ---- autoscaling -----------------------------------------------------

    def enable_autoscale(self, *args, **kwargs):
        """The traffic-driven scale policy needs elastic jobs (a grow
        admits relaunched ranks, a shrink retires drained ones): it
        comes with the port's ``--elastic`` launcher."""
        raise NotImplementedError(
            "the serving engine's autoscale wiring (enable_autoscale, "
            "autoscale_window, the retire cascade) comes with the port's "
            f"elastic jobs ({ITEM_19}); serving/autoscale.py's policy is "
            "ported and pure"
        )

    # ---- lifecycle -------------------------------------------------------

    def reconfigure(self, admit, slo_ms=0.0, rate_limit=0.0, burst=8,
                    stats=None, measure_slo_ms=None):
        """Swap the leader's admission arm between serving windows (the
        followers only execute broadcast plans, so the switch is
        leader-side).  The learned service-time estimator carries over;
        ``stats`` keeps one accumulating :class:`ServingStats` per arm;
        ``measure_slo_ms`` is an off arm's REPORTING SLO (measured
        against, never enforced)."""
        assert self.is_leader, "reconfigure is leader-side"
        if not self.sched.idle():
            raise RuntimeError(
                "reconfigure with requests in flight; drain the "
                "window first"
            )
        est = self.ctrl.estimator
        enforce_slo = float(slo_ms) if admit == "on" else 0.0
        self.admit_mode = admit
        self.slo_ms = enforce_slo
        self.ctrl = AdmissionController(
            admit, slo_ms=enforce_slo, estimator=est,
            bucket=TokenBucket(rate_limit, burst) if rate_limit else None,
        )
        report_slo = (measure_slo_ms if measure_slo_ms is not None
                      else enforce_slo)
        self.stats = stats if stats is not None else ServingStats(
            slo_ms=report_slo, max_batch=self.max_batch, admit_mode=admit,
        )
        return self

    def drain(self, now_ms_fn=None, max_steps=100000, stop=True):
        """Leader: step (no new arrivals) until every queued and
        in-flight request finished, then (``stop=True``) broadcast the
        stop plan; ``stop=False`` leaves the followers in the loop (the
        between-windows drain of an interleaved benchmark).  Checks the
        request accounting: a leaked slot fails loudly."""
        assert self.is_leader
        steps = 0

        def now():
            return now_ms_fn() if now_ms_fn else time.monotonic() * 1e3

        while not self.sched.idle():
            self._leader_step(now())
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"drain did not converge in {max_steps} steps "
                    f"(queue={self.sched.queue_depth()}, "
                    f"occupancy={self.sched.occupancy()})"
                )
        if stop:
            self._leader_step(now(), stop=True)
        self.sched.check_accounting()

    def stop(self, now_ms=None):
        """Leader: broadcast the stop plan (the world must be idle: use
        :meth:`drain` when requests may be in flight)."""
        assert self.is_leader
        if now_ms is None:
            now_ms = time.monotonic() * 1e3
        self._leader_step(now_ms, stop=True)

    def run_follower(self):
        """Follower loop: execute broadcast plans until the stop plan.
        Returns the completions seen on this rank."""
        assert not self.is_leader
        while self.step():
            pass
        return self.finished
