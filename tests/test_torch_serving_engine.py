"""The port's serving engine (``mpi4jax_tpu_torch/serving/engine.py``) held
to the JAX package's on the CPU, in process.

The model of ``tests/proc/test_serving_proc.py`` (vocab 32, d_model 16,
2 layers, 4 heads over 2 KV heads), its parameters carried across from
the JAX package's ``init_params`` by ``params_from_jax``; f32, one
thread.

* ``_decode_step_slots`` against JAX's over mixed per-slot positions:
  logits within ``LOGIT_RTOL`` of the largest magnitude, every cache
  position the step does not write equal bit for bit, the written ones
  within the same tolerance; the scatter write gives the bits of the
  JAX step's one-hot multiply-add;
* one slot prefill into a cache full of an earlier occupant's values:
  the slot's row equal to JAX's (zero past the prompt's bucket), the
  other slots untouched;
* the port's engine and the JAX engine (on a ``SelfComm``) on the 7
  seeded requests of ``tests/proc/test_serving_proc.py`` and on a
  20-request ``LoadGen`` stream offered while the engine steps, with
  ``max_batch=3``: the same ``finished`` list (rid order included), the
  same plan-log words, the caches equal in their zeros and within
  ``LOGIT_RTOL`` after every step, and every response equal to both
  packages' ``reference_greedy_decode``;
* an oversized prompt is shed as ``prompt-too-long``; ``reconfigure``
  with requests in flight raises; the accounting holds after ``drain``;
  a ``MeshComm`` of two ranks is refused; ``T4J_REJOIN=1`` and
  ``enable_autoscale`` raise naming ROADMAP Queue 1 item 19; a
  ``WorldResized`` leaves ``step`` unchanged; the fabric poll reads
  ``link_stats``; the default device is the card.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi4jax_tpu import SelfComm as JSelfComm
from mpi4jax_tpu.models import transformer as jtfm
from mpi4jax_tpu.serving import engine as jeng
from mpi4jax_tpu.serving.loadgen import LoadGen as JLoadGen
from mpi4jax_tpu.serving.request import Request as JRequest

from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.native import runtime as truntime
from mpi4jax_tpu_torch.parallel import distributed
from mpi4jax_tpu_torch.parallel.comm import MeshComm, SelfComm
from mpi4jax_tpu_torch.serving import engine as eng
from mpi4jax_tpu_torch.serving import stats as stats_mod
from mpi4jax_tpu_torch.serving.loadgen import LoadGen
from mpi4jax_tpu_torch.serving.request import Request

torch.set_num_threads(1)

# f32 roundoff between XLA's and PyTorch's CPU products, over the
# largest magnitude of the compared tensor
LOGIT_RTOL = 1e-5
MAX_LEN = 16
MAX_BATCH = 3

JCFG = jtfm.TransformerConfig(vocab=32, d_model=16, layers=2, heads=4,
                              kv_heads=2, head_dim=4, d_ff=32)
JPARAMS = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
CFG = tfm.config_from_jax(JCFG._asdict())
PARAMS = tfm.params_from_jax(jax.tree_util.tree_map(np.asarray, JPARAMS),
                             CFG, device="cpu")


def port_engine(**kw):
    kw.setdefault("admit", "off")
    return eng.ServingEngine(SelfComm(), CFG, PARAMS, max_len=MAX_LEN,
                             max_batch=MAX_BATCH, device="cpu", **kw)


def jax_engine(**kw):
    kw.setdefault("admit", "off")
    return jeng.ServingEngine(JSelfComm(), JCFG, JPARAMS, max_len=MAX_LEN,
                              max_batch=MAX_BATCH, **kw)


def seven_requests(make):
    """The 7 seeded requests of tests/proc/test_serving_proc.py."""
    rng = np.random.RandomState(3)
    reqs = []
    for i in range(7):
        p_len = int(rng.randint(2, 7))
        prompt = tuple(int(x) for x in rng.randint(0, CFG.vocab, p_len))
        reqs.append(make(i, prompt, int(rng.randint(1, 8)), 0.0))
    return reqs


def close(got, want, rtol=LOGIT_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    return np.abs(got - want).max() <= rtol * scale


# ---- the slot step ----------------------------------------------------------

POSITIONS = [(0, 5, 15), (7, 7, 7), (15, 0, 3), (2, 9, 1)]


@pytest.mark.parametrize("pos", POSITIONS, ids=str)
def test_decode_step_slots_matches_jax(pos):
    rng = np.random.RandomState(sum(pos))
    shape = (CFG.layers, 2, MAX_BATCH, MAX_LEN, CFG.kv_heads, CFG.head_dim)
    cache = rng.standard_normal(shape).astype(np.float32)
    last = rng.randint(0, CFG.vocab, MAX_BATCH)
    hq, hk = CFG.heads, CFG.kv_heads
    jcomm = JSelfComm()
    step = jax.jit(lambda c, t, p: jeng._decode_step_slots(
        JPARAMS, c, t, p, JCFG, jcomm, hq, hk))
    jcache, jlogits = step(jnp.asarray(cache), jnp.asarray(last, jnp.int32),
                           jnp.asarray(pos, jnp.int32))
    tcache = torch.from_numpy(cache.copy())
    with torch.no_grad():
        out, logits = eng._decode_step_slots(
            PARAMS, tcache, torch.from_numpy(last), torch.tensor(pos),
            CFG, SelfComm(), hq, hk)
    assert out is tcache  # written in place
    assert logits.shape == (MAX_BATCH, CFG.vocab)
    assert close(logits.numpy(), jlogits)
    jcache = np.asarray(jcache)
    written = np.zeros(shape, bool)
    for b, p in enumerate(pos):
        written[:, :, b, p] = True
    got = tcache.numpy()
    assert np.array_equal(got[~written], cache[~written])
    assert np.array_equal(jcache[~written], cache[~written])
    assert close(got[written], jcache[written])
    assert not np.array_equal(got[written], cache[written])


def test_slot_write_is_the_one_hot_update():
    # the scatter at (arange(B), pos) against JAX's exact f32 one-hot
    # multiply-add, on the same values: the same bits
    g = torch.Generator().manual_seed(1)
    kv = torch.randn((4, 16, 2, 8), generator=g)
    new = torch.randn((4, 2, 8), generator=g)
    pos = torch.tensor([3, 0, 15, 3])
    oh = (torch.arange(16)[None, :] == pos[:, None]).float()[..., None, None]
    want = kv * (1 - oh) + new[:, None] * oh
    got = kv.clone()
    got.index_put_((torch.arange(4), pos), new)
    assert torch.equal(got, want)


def test_slot_step_makes_no_host_read():
    # the positions and last tokens are read by the kernels only: the
    # step has the static shapes and buffers a CUDA graph could hold
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Reads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.split(".")[0] in (
                    "_local_scalar_dense", "nonzero", "is_nonzero", "item"):
                seen.append(func.__name__)
            return func(*args, **(kwargs or {}))

    cache = torch.zeros((CFG.layers, 2, MAX_BATCH, MAX_LEN, CFG.kv_heads,
                         CFG.head_dim))
    with torch.no_grad(), Reads():
        eng._decode_step_slots(PARAMS, cache, torch.tensor([1, 2, 3]),
                               torch.tensor([4, 0, 9]), CFG, SelfComm(),
                               CFG.heads, CFG.kv_heads)
    assert seen == []


# ---- the slot prefill -------------------------------------------------------


@pytest.mark.parametrize("p_len", [3, 8, 9, 15])
def test_slot_prefill_matches_jax(p_len):
    rng = np.random.RandomState(p_len)
    shape = (CFG.layers, 2, MAX_BATCH, MAX_LEN, CFG.kv_heads, CFG.head_dim)
    # an earlier occupant's K/V everywhere: none of it may survive in
    # the prefilled slot
    garbage = rng.standard_normal(shape).astype(np.float32)
    prompt = rng.randint(0, CFG.vocab, p_len)
    slot = 1
    E, J = port_engine(), jax_engine()
    bucket = E._prefill_bucket(p_len)
    assert bucket == J._prefill_bucket(p_len) == min(max(8, 1 << (
        p_len - 1).bit_length()), MAX_LEN)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :p_len] = prompt
    E.cache.copy_(torch.from_numpy(garbage))
    with torch.no_grad():
        logits = E._prefill(torch.from_numpy(padded), slot, p_len)
    jcache, jlogits = J._prefill_jit(bucket)(
        J.params, jnp.asarray(garbage), jnp.asarray(padded, jnp.int32),
        jnp.int32(slot), jnp.int32(p_len))
    jcache = np.asarray(jcache)
    got = E.cache.numpy()
    assert close(logits.numpy(), jlogits)
    others = [s for s in range(MAX_BATCH) if s != slot]
    assert np.array_equal(got[:, :, others], garbage[:, :, others])
    assert np.array_equal(jcache[:, :, others], garbage[:, :, others])
    row, jrow = got[:, :, slot], jcache[:, :, slot]
    assert not row[:, :, bucket:].any() and not jrow[:, :, bucket:].any()
    assert close(row, jrow)
    assert int(torch.argmax(logits)) == int(np.argmax(np.asarray(jlogits)))


# ---- the engines on seeded traffic ------------------------------------------


def drive(engine, reqs, offer_every=None):
    """Offer ``reqs`` (all at t = 0, or one every ``offer_every`` steps
    while the engine steps) and drain; returns the cache after every
    step (numpy)."""
    caches = []
    now = 0.0
    if offer_every is None:
        for r in reqs:
            engine.offer(r, 0.0)
    else:
        for r in reqs:
            engine.offer(r, now)
            for _ in range(offer_every):
                engine.step(now)
                caches.append(np.array(engine.cache))
                now += 10.0
    while not engine.sched.idle():
        engine._leader_step(now)
        caches.append(np.array(engine.cache))
        now += 10.0
    engine.stop(now)
    engine.sched.check_accounting()
    return caches


STREAMS = {
    "seven": (lambda: seven_requests(Request),
              lambda: seven_requests(JRequest), None),
    "loadgen20": (lambda: LoadGen(seed=7, rate_rps=50,
                                  prompt_len=("uniform", 2, 12),
                                  max_new=("uniform", 1, 10),
                                  vocab=CFG.vocab).take(20),
                  lambda: JLoadGen(seed=7, rate_rps=50,
                                   prompt_len=("uniform", 2, 12),
                                   max_new=("uniform", 1, 10),
                                   vocab=CFG.vocab).take(20), 1),
}
_runs = {}


def runs(name, tmp_path_factory):
    if name not in _runs:
        port_reqs, jax_reqs, every = STREAMS[name]
        d = tmp_path_factory.mktemp(f"plans_{name}")
        E = port_engine(plan_log=str(d / "port.jsonl"))
        J = jax_engine(plan_log=str(d / "jax.jsonl"))
        reqs = port_reqs()
        with torch.no_grad():
            port_caches = drive(E, reqs, every)
        jax_caches = drive(J, jax_reqs(), every)
        _runs[name] = (E, J, reqs, port_caches, jax_caches,
                       (d / "port.jsonl").read_text(),
                       (d / "jax.jsonl").read_text())
    return _runs[name]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_engine_finished_equals_jax(name, tmp_path_factory):
    E, J, reqs, *_ = runs(name, tmp_path_factory)
    assert len(E.finished) == len(reqs)
    assert E.finished == J.finished
    if name == "loadgen20":
        # completion order, which is not rid order here
        rids = [rid for rid, _ in E.finished]
        assert rids != sorted(rids)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_engine_plan_log_equals_jax(name, tmp_path_factory):
    *_, port_log, jax_log = runs(name, tmp_path_factory)
    assert port_log == jax_log
    assert len(port_log.splitlines()) > 10


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_engine_caches_equal_jax_after_every_step(name, tmp_path_factory):
    _, _, _, port_caches, jax_caches, _, _ = runs(name, tmp_path_factory)
    assert len(port_caches) == len(jax_caches) > 0
    for k, (got, want) in enumerate(zip(port_caches, jax_caches)):
        want = np.asarray(want)
        assert np.array_equal(got == 0, want == 0), k
        assert close(got, want), k


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_engine_responses_equal_both_references(name, tmp_path_factory):
    E, _, reqs, *_ = runs(name, tmp_path_factory)
    by_rid = {r.rid: r for r in reqs}
    for rid, toks in E.finished:
        req = by_rid[rid]
        n = req.prompt_len + min(req.max_new, MAX_LEN - req.prompt_len)
        want = tfm.reference_greedy_decode(
            PARAMS, torch.tensor([req.prompt]), CFG, n)
        jwant = jtfm.reference_greedy_decode(
            JPARAMS, jnp.asarray([req.prompt], jnp.int32), JCFG, n)
        assert toks == tuple(want[0].tolist()), rid
        assert toks == tuple(int(t) for t in np.asarray(jwant)[0]), rid


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_engine_stats_equal_jax(name, tmp_path_factory):
    E, J, reqs, *_ = runs(name, tmp_path_factory)
    keys = ("submitted", "completed", "shed", "steps", "queue_depth",
            "batch_occupancy", "slo_attainment", "admit_mode",
            "max_batch", "shed_by_reason")
    snap, jsnap = E.stats.snapshot(), J.stats.snapshot()
    assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
    assert snap["completed"] == len(reqs)
    assert stats_mod.current()["stopped"] is True


# ---- the engine's edges -----------------------------------------------------


def test_oversized_prompt_is_shed():
    E = port_engine()
    long = Request(0, tuple(range(1, MAX_LEN + 1)), 3, 0.0)
    ok = Request(1, (1, 2, 3), 2, 0.0)
    assert E.offer(long, 0.0) == "shed"
    assert E.offer(ok, 0.0) == "admit"
    assert long.shed_reason == eng.ServingEngine.SHED_PROMPT == \
        jeng.ServingEngine.SHED_PROMPT == "prompt-too-long"
    with torch.no_grad():
        E.drain(now_ms_fn=lambda: 0.0)
    snap = E.stats.snapshot()
    assert snap["shed_by_reason"] == {"prompt-too-long": 1}
    assert [rid for rid, _ in E.finished] == [1]


def test_reconfigure_with_requests_in_flight_raises():
    E = port_engine()
    E.offer(Request(0, (1, 2, 3), 5, 0.0), 0.0)
    with torch.no_grad():
        E.step(0.0)
    with pytest.raises(RuntimeError, match="in flight"):
        E.reconfigure("on", slo_ms=1000.0)
    with torch.no_grad():
        E.drain(now_ms_fn=lambda: 0.0, stop=False)
    assert E.reconfigure("on", slo_ms=1000.0).slo_ms == 1000.0
    assert E.ctrl.mode == "on"


def frozen(estimator_cls):
    """An SLO estimator that keeps its seeds: the verdicts then depend on
    the engine's clock alone, not on the host's step times."""

    class Frozen(estimator_cls):
        def observe_step(self, ms):
            pass

        def observe_prefill(self, ms, prompt_len):
            pass

    return Frozen(seed_step_ms=10.0, seed_prefill_ms_per_tok=0.5)


def test_accounting_holds_after_drain_under_admission():
    from mpi4jax_tpu.serving.admission import SLOEstimator as JEstimator

    from mpi4jax_tpu_torch.serving.admission import SLOEstimator

    engines = (port_engine(admit="on", slo_ms=150.0,
                           estimator=frozen(SLOEstimator)),
               jax_engine(admit="on", slo_ms=150.0,
                          estimator=frozen(JEstimator)))
    for E, gen in zip(engines, (LoadGen, JLoadGen)):
        gen = gen(seed=4, rate_rps=400, prompt_len=("uniform", 2, 10),
                  max_new=("uniform", 4, 10), vocab=CFG.vocab,
                  deadline_fn=lambda t: t + 150.0)
        now = 0.0
        with torch.no_grad():
            for _ in range(12):
                for req in gen.until(now):
                    E.offer(req, now)
                E.step(now)
                now += 10.0
            E.drain(now_ms_fn=lambda: now)
    E, J = engines
    s = E.sched
    assert s.idle()
    assert s.submitted == s.completed + s.shed + s.reissued
    snap = E.stats.snapshot()
    assert snap["shed"] > 0 and snap["completed"] == len(E.finished) > 0
    assert snap["submitted"] == snap["completed"] + snap["shed"]
    # the same sheds and the same responses as the JAX engine
    jsnap = J.stats.snapshot()
    assert snap["shed_by_reason"] == jsnap["shed_by_reason"]
    assert E.finished == J.finished


def test_live_estimator_books_a_slow_prefill_as_prefill(monkeypatch):
    # a prefill slowed by a sleep must reach observe_prefill, and the
    # decode that shared its step observe_step without it
    from mpi4jax_tpu_torch.serving.admission import SLOEstimator

    slow_s = 0.25
    seen = {"step": [], "prefill": []}

    class Recording(SLOEstimator):
        def observe_step(self, ms):
            seen["step"].append(ms)
            super().observe_step(ms)

        def observe_prefill(self, ms, prompt_len):
            seen["prefill"].append(ms)
            super().observe_prefill(ms, prompt_len)

    E = port_engine(admit="on", slo_ms=60000.0, estimator=Recording())
    prefill = E._prefill

    def slow_prefill(*args):
        time.sleep(slow_s)
        return prefill(*args)

    monkeypatch.setattr(E, "_prefill", slow_prefill)
    with torch.no_grad():
        assert E.offer(Request(0, (1, 2, 3), 6, 0.0), 0.0) == "admit"
        E.step(0.0)  # the prefill alone
        assert seen["step"] == [] and len(seen["prefill"]) == 1
        assert seen["prefill"][0] >= slow_s * 1e3
        assert E.offer(Request(1, (4, 5), 3, 0.0), 0.0) == "admit"
        E.step(0.0)  # slot 0's decode and request 1's prefill
    assert len(seen["step"]) == 1 and len(seen["prefill"]) == 2
    assert seen["step"][0] < slow_s * 1e3
    assert seen["prefill"][1] >= slow_s * 1e3
    est = E.ctrl.estimator
    assert est.step_ms < slow_s * 1e3


def test_mesh_comm_of_two_ranks_is_refused():
    def body(comm):
        with pytest.raises(ValueError, match="proc tier's host_bcast"):
            eng.ServingEngine(comm, CFG, PARAMS, max_len=MAX_LEN,
                              max_batch=MAX_BATCH, admit="off", device="cpu")
        return True

    assert distributed.local_world(2, body, axes=(("tp",), (2,)),
                                   deadline=120.0) == [True, True]
    # a one-rank mesh is a one-rank world
    assert port_engine().tp == 1
    assert eng.ServingEngine(MeshComm(axes=("tp",), axis_sizes=(1,)), CFG,
                             PARAMS, max_len=MAX_LEN, max_batch=MAX_BATCH,
                             admit="off", device="cpu").tp == 1


def test_rejoin_and_autoscale_name_item_19(monkeypatch):
    monkeypatch.setenv("T4J_REJOIN", "1")
    with pytest.raises(ValueError, match="item 19"):
        port_engine()
    monkeypatch.delenv("T4J_REJOIN")
    with pytest.raises(NotImplementedError, match="item 19"):
        port_engine().enable_autoscale()


def test_world_resized_leaves_step_unchanged(monkeypatch):
    E = port_engine()
    err = truntime.WorldResized((0, 1), (0,), 1)

    def resized(now_ms):
        raise err

    monkeypatch.setattr(E, "_leader_step", resized)
    with pytest.raises(truntime.WorldResized) as got:
        E.step(0.0)
    assert got.value is err


def test_fabric_poll_reads_link_stats(monkeypatch):
    E = port_engine(admit="on", slo_ms=500.0, fabric_poll_s=0.0)
    E._poll_fabric(1.0)  # outside a launcher job: None, a neutral view
    assert E.ctrl.degradation == 1.0
    monkeypatch.setattr(truntime, "link_stats", lambda: {
        "state": 1, "max_reconnects": 4, "worst_peer": 3})
    E._poll_fabric(2.0)
    assert E.ctrl.degradation == pytest.approx(2.5)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eng.ServingEngine(SelfComm(), CFG, PARAMS, max_len=MAX_LEN,
                          max_batch=MAX_BATCH, admit="off")
