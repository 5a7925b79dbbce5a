"""The proc tier across OS processes: launcher jobs of the port
(``python -m mpi4jax_tpu_torch.launch --platform cpu``) held to launcher
jobs of the JAX package (``python -m mpi4jax_tpu.launch``) on the same
seeded inputs, over the same native bridge.

* ``chip_smoke.py``'s proc battery (every op with several operators and
  dtypes, user operators, rank-dependent ``gather``/``scatter``, tagged
  ``send``/``recv`` with ``Status``, ``sendrecv`` with int partners and a
  pattern, ``sendrecv_multi`` and ``alltoall_multi`` fused and unfused,
  the gradients of ``allreduce`` SUM and ``sendrecv``) at 2 and 4 ranks
  equals a JAX proc job running the same ops, bit for bit, floats
  included (the same ``dcn.cc`` adds in the same order), and the
  gradients equal ``jax.grad``'s;
* at 4 ranks the 2x2 halo exchange on a ProcGridComm (h, u, v at ghost
  2), fused and unfused, equals the JAX package's and each other;
* a planted failure: the launcher exits nonzero within its deadline and
  names the failing rank first;
* the bench's proc legs (``benchmarks/proc_busbw.py``: the busbw with its
  in-run ceiling, the halo latency on and off; ``benchmarks/
  transformer.py``: the dp step with overlap on and off) at a tiny size;
* the nonblocking requests (``chip_smoke.py --proc-rank async``: the JAX
  package's async matrix, a submit whose operand is dropped and
  collected before its wait, ``make_dp_train_step`` with overlap on and
  off, error feedback with the wire dtype at bf16) at 4 ranks, every
  result equal to the port's blocking op bit for bit, and the dp step's
  parameters within 1e-5 relative of a JAX proc job on the same seeds;
* a request never waited is reported on stderr at finalize;
* the serving engine over a 2-rank ``--serve`` job: both ranks' responses
  equal ``reference_greedy_decode`` (the port's and the JAX package's)
  and each other's; the port's ``benchmarks/serving.py`` at a tiny size
  gives the serving leg's records, and refuses ``--arms ramp``.

Twelve jobs of at most 4 ranks, each with its own deadline (the
launcher's ``--timeout``, and the process group killed 30 s later); the
ranks run one thread each on small payloads.
"""

import importlib.util
import inspect
import json
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JOB_TIMEOUT_S = 180
HALO_BLOCK = (14, 12)  # a rank's block, ghosts included
GROUPS = ("allreduce", "scan", "allgather", "alltoall_", "reduce_scatter",
          "bcast", "reduce_", "gather", "scatter", "recv", "sendrecv_",
          "sendrecv_multi", "alltoall_multi", "grad")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()

JAX_WORKER = """
import sys

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # the float64 case stays float64
import jax.numpy as jnp

import mpi4jax_tpu as m
from mpi4jax_tpu import tuning
from mpi4jax_tpu.parallel import grid_comm
from mpi4jax_tpu.parallel.halo import halo_exchange_2d_batch

PROC_FIELDS = {fields!r}
PROC_GHOST = {ghost!r}
{inputs}
{halo_inputs}
{strips}
out_dir, *block = sys.argv[1:]
block = tuple(int(a) for a in block) or None
comm = m.get_default_comm()
assert comm.backend == "proc"
n, r = comm.size, comm.rank()
prev, nxt = (r - 1) % n, (r + 1) % n
inp = proc_inputs(r, n)
user = {{"max2": m.Op.create(lambda a, b: jnp.maximum(a, b) * 2,
                             name="max2"),
        "lin": m.Op.create(lambda a, b: a * 3 + b, name="lin",
                           commute=False)}}
OPS = {{k: getattr(m, k.upper()) for k in ("sum", "prod", "min", "max",
       "land", "lor", "lxor", "band", "bor", "bxor")}}
out = {{}}


def keep(name, y):
    out[name] = np.asarray(y)


def status(name, st):
    out[name] = np.array([int(np.asarray(st.source)),
                          int(np.asarray(st.tag))], np.int32)


x, i, b = (jnp.asarray(inp[k]) for k in ("x", "i", "b"))
for op in ("sum", "prod", "min", "max"):
    keep(f"allreduce_{{op}}_f32", m.allreduce(x, OPS[op], comm=comm)[0])
for op in ("sum", "band", "bor", "bxor"):
    keep(f"allreduce_{{op}}_i32", m.allreduce(i, OPS[op], comm=comm)[0])
for op in ("land", "lor", "lxor"):
    keep(f"allreduce_{{op}}_bool", m.allreduce(b, OPS[op], comm=comm)[0])
keep("allreduce_sum_f64", m.allreduce(inp["x64"], m.SUM, comm=comm)[0])
keep("allreduce_sum_bf16", np.asarray(m.allreduce(
    jnp.asarray(inp["xb16"]).astype(jnp.bfloat16), m.SUM,
    comm=comm)[0]).view(np.int16))
keep("allreduce_user_max2", m.allreduce(x, user["max2"], comm=comm)[0])
keep("allreduce_user_lin", m.allreduce(i, user["lin"], comm=comm)[0])
keep("scan_sum_f32", m.scan(x, m.SUM, comm=comm)[0])
keep("scan_max_i32", m.scan(i, m.MAX, comm=comm)[0])
keep("scan_user_lin", m.scan(i, user["lin"], comm=comm)[0])
keep("allgather_f32", m.allgather(x, comm=comm)[0])
keep("allgather_bool", m.allgather(b, comm=comm)[0])
rows, rows_i = jnp.asarray(inp["rows"]), jnp.asarray(inp["rows_i"])
keep("alltoall_f32", m.alltoall(rows, comm=comm)[0])
keep("alltoall_i32", m.alltoall(rows_i, comm=comm)[0])
keep("reduce_scatter_sum_f32", m.reduce_scatter(rows, m.SUM, comm=comm)[0])
keep("reduce_scatter_max_f32", m.reduce_scatter(rows, m.MAX, comm=comm)[0])
keep("reduce_scatter_sum_i32", m.reduce_scatter(rows_i, m.SUM,
                                                comm=comm)[0])
keep("reduce_scatter_sum_bool", m.reduce_scatter(
    jnp.asarray(inp["rows_b"]), m.SUM, comm=comm)[0])
keep("reduce_scatter_user_max2", m.reduce_scatter(rows, user["max2"],
                                                  comm=comm)[0])
for root in sorted({{min(1, n - 1), n - 1}}):
    keep(f"bcast_root{{root}}", m.bcast(x, root, comm=comm)[0])
keep("reduce_sum_root0", m.reduce(x, m.SUM, 0, comm=comm)[0])
keep(f"reduce_user_lin_root{{n - 1}}", m.reduce(i, user["lin"], n - 1,
                                               comm=comm)[0])
keep("gather_f32_root0", m.gather(x, 0, comm=comm)[0])
keep(f"gather_i32_root{{n - 1}}", m.gather(i, n - 1, comm=comm)[0])
full = jnp.asarray(inp["full"])
for root in (0, n - 1):
    keep(f"scatter_root{{root}}", m.scatter(full if r == root else full[0],
                                           root, comm=comm)[0])

st = m.Status()
m.send(x, nxt, tag=5, comm=comm)
keep("recv_tag5", m.recv(x, prev, 5, comm=comm, status=st)[0])
status("recv_tag5_status", st)
m.send(x * 2, nxt, tag=9, comm=comm)
keep("recv_any", m.recv(x, m.ANY_SOURCE, m.ANY_TAG, comm=comm,
                        status=st)[0])
status("recv_any_status", st)
m.send(x, nxt, tag=7, comm=comm)
m.send(i, nxt, tag=8, comm=comm)
keep("recv_tag8_first", m.recv(i, prev, 8, comm=comm, status=st)[0])
keep("recv_tag7_second", m.recv(x, prev, 7, comm=comm)[0])
keep("sendrecv_ints", m.sendrecv(x, x, prev, nxt, sendtag=3, comm=comm,
                                 status=st)[0])
status("sendrecv_ints_status", st)
back = [(q, (q - 1) % n) for q in range(n)]
keep("sendrecv_pattern", m.sendrecv(rows, rows, back, back, comm=comm)[0])
parts = [jnp.asarray(a) for a in inp["parts"]]
for label, co in (("fused", True), ("unfused", False), ("auto", None)):
    outs, _ = m.sendrecv_multi(parts, list(parts), prev, nxt, sendtag=4,
                               comm=comm, status=st, coalesce=co)
    for k, y in enumerate(outs):
        keep(f"sendrecv_multi_{{label}}_{{k}}", y)
    status(f"sendrecv_multi_{{label}}_status", st)
a2a = [jnp.asarray(a) for a in inp["a2a"]]
for label, co in (("fused", True), ("unfused", False)):
    outs, _ = m.alltoall_multi(a2a, comm=comm, coalesce=co)
    for k, y in enumerate(outs):
        keep(f"alltoall_multi_{{label}}_{{k}}", y)
m.barrier(comm=comm)

w = jnp.asarray(inp["w"])
keep("grad_allreduce_sum", jax.grad(
    lambda v: (m.allreduce(v * w, m.SUM, comm=comm)[0] * w).sum())(x))
keep("grad_sendrecv", jax.grad(lambda v: (m.sendrecv(
    v, jnp.zeros_like(v), prev, nxt, comm=comm)[0] * w).sum())(x))

if block is not None and n == 4:
    grid = grid_comm((2, 2))
    for label, threshold in (("fused", 1 << 30), ("unfused", 0)):
        tuning.override_coalesce(threshold)
        fields = [jnp.asarray(a) for a in proc_halo_inputs(r, block)]
        fields, _ = halo_exchange_2d_batch(
            fields, grid, periodic=(False, True), width=PROC_GHOST)
        for k, y in ghost_strips(fields, PROC_GHOST).items():
            keep(f"halo_{{label}}_{{k}}", y)
    tuning.override_coalesce(None)
np.savez(f"{{out_dir}}/rank{{r}}.npz", **out)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env.pop("T4J_COALESCE_BYTES", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["T4J_TUNING_CACHE"] = "off"  # the knobs are the defaults, both sides
    return env


def run_job(launcher, n, args, timeout=JOB_TIMEOUT_S, platform=True):
    """A launcher job with its own deadline; (exit code, stdout, stderr).
    The job's process group is killed if the launcher outlives its
    deadline by 30 s."""
    cmd = [sys.executable, "-m", launcher, "-np", str(n), "--timeout",
           str(timeout), *(("--platform", "cpu") if platform else ()),
           *map(str, args)]
    popen = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=_env(),
                             cwd=str(ROOT), start_new_session=True)
    try:
        out, err = popen.communicate(timeout=timeout + 30)
    except subprocess.TimeoutExpired:
        os.killpg(os.getpgid(popen.pid), signal.SIGKILL)
        out, err = popen.communicate()
        raise AssertionError(f"job timed out\n{out}\n{err}")
    return popen.returncode, out, err


def _load(out_dir, n):
    return {r: dict(np.load(pathlib.Path(out_dir) / f"rank{r}.npz"))
            for r in range(n)}


_jobs = {}


def batteries(n):
    """The port's and the JAX package's battery jobs at ``n`` ranks (run
    once per module)."""
    if n not in _jobs:
        block = HALO_BLOCK if n == 4 else ()
        with tempfile.TemporaryDirectory() as port_dir, \
                tempfile.TemporaryDirectory() as jax_dir:
            rc, out, err = run_job(
                "mpi4jax_tpu_torch.launch", n,
                [ROOT / "chip_smoke.py", "--proc-rank", "battery", port_dir,
                 *block])
            assert rc == 0, (out, err[-6000:])
            worker = pathlib.Path(jax_dir) / "jax_battery.py"
            worker.write_text(textwrap.dedent(JAX_WORKER.format(
                fields=SMOKE.PROC_FIELDS, ghost=SMOKE.PROC_GHOST,
                inputs=inspect.getsource(SMOKE.proc_inputs),
                halo_inputs=inspect.getsource(SMOKE.proc_halo_inputs),
                strips=inspect.getsource(SMOKE.ghost_strips))))
            rc, out, err = run_job("mpi4jax_tpu.launch", n,
                                   [worker, jax_dir, *block],
                                   platform=False)
            assert rc == 0, (out, err[-6000:])
            _jobs[n] = (_load(port_dir, n), _load(jax_dir, n))
    return _jobs[n]


@pytest.mark.parametrize("n", [2, 4])
def test_battery_cases_match_jax(n):
    port, jax_ = batteries(n)
    for r in range(n):
        assert set(port[r]) == set(jax_[r])
    # the rooted ops' rank-dependent shapes
    assert port[0]["gather_f32_root0"].shape == (n, 5, 3)
    assert port[n - 1]["gather_f32_root0"].shape == (5, 3)
    assert port[n - 1][f"scatter_root{n - 1}"].shape == (4,)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("n", [2, 4])
def test_ops_bit_for_bit_with_jax(n, group):
    port, jax_ = batteries(n)
    names = [k for k in port[0] if k.startswith(group)]
    assert names
    for r in range(n):
        for k in names:
            assert SMOKE.same_bits(port[r][k], jax_[r][k]), (r, k)


@pytest.mark.parametrize("n", [2, 4])
def test_gradients_equal_jax_grad(n):
    port, jax_ = batteries(n)
    for r in range(n):
        w = SMOKE.proc_inputs(r, n)["w"]
        nxt_w = SMOKE.proc_inputs((r + 1) % n, n)["w"]
        # allreduce SUM: the identity transpose; sendrecv: the cotangent
        # comes back from the rank the value went to
        assert SMOKE.same_bits(port[r]["grad_allreduce_sum"], w * w)
        assert SMOKE.same_bits(port[r]["grad_sendrecv"], nxt_w)
        assert SMOKE.same_bits(port[r]["grad_sendrecv"],
                               jax_[r]["grad_sendrecv"])


@pytest.mark.parametrize("n", [2, 4])
def test_status_and_float_sums_are_the_wires(n):
    port, _ = batteries(n)
    for r in range(n):
        prev = (r - 1) % n
        assert port[r]["recv_tag5_status"].tolist() == [prev, 5]
        assert port[r]["recv_any_status"].tolist() == [prev, 9]
        assert port[r]["sendrecv_ints_status"].tolist() == [prev, 3]
        for label in ("fused", "unfused", "auto"):
            assert port[r][f"sendrecv_multi_{label}_status"].tolist() == \
                [prev, 4]
    # every rank holds the same float sum, the native layer's
    total = sum(SMOKE.proc_inputs(r, n)["x"].astype(np.float64)
                for r in range(n))
    np.testing.assert_allclose(port[0]["allreduce_sum_f32"], total,
                               rtol=1e-6)


def test_halo_fused_unfused_and_jax():
    port, jax_ = batteries(4)
    for r in range(4):
        halo = sorted(k for k in port[r] if k.startswith("halo_fused_"))
        assert len(halo) == 12  # h, u, v x four sides
        for k in halo:
            other = k.replace("fused", "unfused")
            assert SMOKE.same_bits(port[r][k], port[r][other]), (r, k)
            assert SMOKE.same_bits(port[r][k], jax_[r][k]), (r, k)
            assert SMOKE.same_bits(port[r][other], jax_[r][other]), (r, k)


def test_planted_failure_is_named_within_the_deadline():
    n = 4
    # the file's job deadline: the job's four torch imports stretch with
    # the host's load (about 10 s alone, 27 s beside 32 busy processes on
    # 8 cores)
    rc, out, err = run_job("mpi4jax_tpu_torch.launch", n,
                           [ROOT / "chip_smoke.py", "--proc-rank", "fail",
                            "-"], timeout=JOB_TIMEOUT_S)
    bad = SMOKE.proc_failing_rank(n)
    assert rc not in (0, 124), err
    # named by its error, however the ranks' exits are ordered
    assert (f"rank {bad} failed first (RuntimeError: planted failure on "
            f"rank {bad})") in err
    assert err.count("— first exit; terminating 3 remaining rank(s)") == 1
    # the others raised on the abort broadcast, not at the deadline
    assert "deadline" not in err


def test_bench_proc_legs_tiny():
    legs = textwrap.dedent("""
        from mpi4jax_tpu_torch.benchmarks import proc_busbw
        proc_busbw.main(["--mb", "0.5", "--reps", "2"])
        proc_busbw.main(["--op", "halo", "--widths", "1", "--reps", "10",
                         "--halo-base", "8", "--fields", "3"])
        from mpi4jax_tpu_torch.benchmarks import transformer
        transformer.main(["--overlap", "pairs", "--layers", "2",
                          "--d-model", "32", "--batch", "4", "--reps", "1",
                          "--batches", "1"])
    """)
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "legs.py"
        path.write_text(legs)
        rc, out, err = run_job("mpi4jax_tpu_torch.launch", 2, [path])
    assert rc == 0, err[-4000:]
    recs = {json.loads(line)["metric"] + json.loads(line).get("coalesce", ""):
            json.loads(line) for line in out.splitlines()}
    busbw = recs["allreduce_busbw_proc2_shm_host_gbps"]
    assert busbw["value"] > 0 and busbw["arm"] == "host"
    for key in ("single_core_copy_gbps", "gauntlet_agg_copy_gbps",
                "ceiling_gbps", "pct_of_ceiling"):
        assert busbw[key] > 0
    assert recs["halo_p50_ms_proc2_w1on"]["value"] > 0
    assert recs["halo_p50_ms_proc2_w1off"]["value"] > 0
    assert recs["halo_coalesce_speedup_proc2_w1"]["value"] > 0
    assert "skipped p50_ms and p99_ms" in err and "item 10" in err
    # the overlap leg: the host arm alone off the card
    for side in ("on", "off"):
        rec = recs[f"train_step_ms_proc2_host_overlap_{side}"]
        assert rec["value"] > 0 and rec["arm"] == "host"
        assert rec["layers"] == 2 and rec["interleaved_pairs"]
    assert recs["overlap_speedup_proc2_host"]["value"] > 0
    assert not any(k.startswith("train_step_ms_proc2_overlap") for k in recs)


JAX_DP_WORKER = """
import sys

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

import mpi4jax_tpu as m
from mpi4jax_tpu.models import train

DP_LAYERS, DP_WIDTH, DP_STEPS = {layers!r}, {width!r}, {steps!r}
{dp_inputs}
comm = m.get_default_comm()
assert comm.backend == "proc"
r = comm.rank()
inp = dp_inputs(r)
stack = train.StackParams(
    layers=tuple((jnp.asarray(w), jnp.asarray(b))
                 for w, b in inp["stack"]["layers"]),
    w_out=jnp.asarray(inp["stack"]["w_out"]))
mlp = train.MLPParams(*map(jnp.asarray, inp["mlp"]))
out = {{}}
for name, params, batch, bucket in (
        ("stack", stack, (inp["x_stack"], inp["t_stack"]), 1 << 14),
        ("mlp", mlp, (inp["x_mlp"], inp["t_mlp"]), 1 << 12)):
    step = jax.jit(train.make_dp_train_step(comm, overlap=True,
                                            bucket_bytes=bucket))
    p = params
    for _ in range(DP_STEPS):
        p, loss = step(p, tuple(map(jnp.asarray, batch)))
    for k, leaf in enumerate(jax.tree_util.tree_leaves(p)):
        out[f"dp_{{name}}_on_{{k}}"] = np.asarray(leaf)
    out[f"dp_{{name}}_on_loss"] = np.asarray(loss)
m.assert_requests_drained()
np.savez(f"{{sys.argv[1]}}/rank{{r}}.npz", **out)
"""

ASYNC_RANKS = 4
_async = {}


def async_jobs():
    """The port's async job and the JAX package's dp-step job at 4 ranks
    (run once per module): ``(port, jax)``, ``{rank: {case: array}}``."""
    if not _async:
        n = ASYNC_RANKS
        with tempfile.TemporaryDirectory() as port_dir, \
                tempfile.TemporaryDirectory() as jax_dir:
            rc, out, err = run_job(
                "mpi4jax_tpu_torch.launch", n,
                [ROOT / "chip_smoke.py", "--proc-rank", "async", port_dir])
            assert rc == 0, (out, err[-6000:])
            worker = pathlib.Path(jax_dir) / "jax_dp.py"
            worker.write_text(textwrap.dedent(JAX_DP_WORKER.format(
                layers=SMOKE.DP_LAYERS, width=SMOKE.DP_WIDTH,
                steps=SMOKE.DP_STEPS,
                dp_inputs=inspect.getsource(SMOKE.dp_inputs))))
            rc, out, err = run_job("mpi4jax_tpu.launch", n,
                                   [worker, jax_dir], platform=False)
            assert rc == 0, (out, err[-6000:])
            _async["jobs"] = (_load(port_dir, n), _load(jax_dir, n))
    return _async["jobs"]


def test_async_matrix_equals_the_blocking_sums():
    # the job raised on any nonblocking result unequal to its blocking
    # op; here the exact sums of the small integers, recomputed
    port, _ = async_jobs()
    n = ASYNC_RANKS
    data = SMOKE.async_data
    for r in range(n):
        got = port[r]
        for count in (1, 997, 65537):
            assert SMOKE.same_bits(got[f"iallreduce_sum_{count}"], sum(
                data(count, q, 1) for q in range(n)))
            assert SMOKE.same_bits(got[f"iallreduce_max_{count}"], np.max(
                [data(count, q, 2) for q in range(n)], axis=0))
        for k in range(6):
            assert SMOKE.same_bits(got[f"waitall_{k}"], sum(
                data(4096, q, 10 + k) for q in range(n)))
        left = (r - 1) % n
        assert (got["ring_irecv"] == left).all()
        assert (got["ring_irecv_any"] == 10 * left).all()
        assert got["ring_irecv_any"].dtype == np.int32
        assert SMOKE.same_bits(got["ireduce_scatter"], sum(
            data(33, q, 50 + r) for q in range(n)))
        assert SMOKE.same_bits(got["test_then_wait"], sum(
            data(512, q, 99) for q in range(n)))
        assert SMOKE.same_bits(got["dropped_operand"], sum(
            data(65537, q, 77) for q in range(n)))


def test_dp_step_arms_equal_and_match_a_jax_proc_job():
    port, jax_ = async_jobs()
    for r in range(ASYNC_RANKS):
        for name in ("stack", "mlp"):
            keys = sorted(k for k in jax_[r] if k.startswith(f"dp_{name}_"))
            assert len(keys) == (2 * SMOKE.DP_LAYERS + 2 if name == "stack"
                                 else 5)
            for k in keys:
                off = k.replace("_on_", "_off_")
                assert SMOKE.same_bits(port[r][k], port[r][off]), (r, k)
                want = jax_[r][k].astype(np.float64)
                got = port[r][k].astype(np.float64)
                scale = max(np.abs(want).max(), 1e-30)
                assert np.abs(got - want).max() <= 1e-5 * scale, (r, k)
            # every rank holds the same synced parameters and mean loss
            for k in keys:
                assert SMOKE.same_bits(port[r][k], port[0][k]), (r, k)


def test_error_feedback_residual_is_send_minus_q():
    from mpi4jax_tpu_torch.ops.allreduce import BucketedGradSync
    from mpi4jax_tpu_torch.parallel.comm import SelfComm

    port, _ = async_jobs()
    n = ASYNC_RANKS
    # the job's bucket layout (a self comm lays buckets out alike)
    sync = BucketedGradSync(SelfComm(), bucket_bytes=1 << 10, average=False)
    for r in range(n):
        shapes = [a.shape for a in SMOKE.dp_inputs(r)["mlp"]]
        rng = np.random.default_rng(300 + r)
        res = {}
        for k in range(SMOKE.EF_STEPS):
            leaves = [torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)) for s in shapes]
            buckets = sync._buckets(leaves)
            assert len(buckets) == 4
            new = {}
            for bi, bucket in enumerate(buckets):
                send = torch.cat([leaves[i].reshape(-1)
                                  for i in bucket["idx"]])
                if bi in res:
                    send = send + res[bi]
                q = send.bfloat16().float()
                got = port[r][f"ef_{k}_{bi}_residual"]
                assert SMOKE.same_bits(got, (send - q).numpy()), (r, k, bi)
                assert np.abs(got).max() <= 2.0 ** -8 * np.abs(
                    send.numpy()).max()
                new[bi] = torch.from_numpy(got)
                # the synced bucket: the sum over ranks of the q's, which
                # the job held to the blocking allreduce bit for bit
                assert port[r][f"ef_{k}_{bi}"].shape == send.shape
            res = new


LEAK_PROG = """
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.native import runtime

comm = mt.get_default_comm()
assert comm.backend == "proc"
req, _ = mt.iallreduce(torch.ones(256), comm=comm)
try:
    mt.assert_requests_drained()
    raise SystemExit("assert_requests_drained did not raise")
except runtime.BridgeError as e:
    assert "never waited" in str(e), e
print("LEAK-DETECTED-OK", flush=True)
# exits without the wait: finalize reports the leak on stderr
"""


def test_request_never_waited_is_reported_at_finalize():
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d) / "leak.py"
        path.write_text(LEAK_PROG)
        rc, out, err = run_job("mpi4jax_tpu_torch.launch", 2, [path],
                               timeout=120)
    assert rc == 0, err[-4000:]
    assert out.count("LEAK-DETECTED-OK") == 2
    assert err.count("async request(s) never waited at finalize "
                     "(iallreduce)") == 2


SERVE_PROG = """
import json
import sys
import types

import numpy as np
import torch

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.launch import rank_device
from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.serving import engine as eng
from mpi4jax_tpu_torch.serving.request import Request
from mpi4jax_tpu_torch.utils import config

torch.set_num_threads(1)
comm = mt.get_default_comm()
assert comm.backend == "proc" and comm.size == 2, comm
assert config.admit_mode() == "on"  # the launcher's --serve
with np.load(sys.argv[1]) as f:
    leaves = {k: f[k] for k in f.files}
cfg = tfm.TransformerConfig(**json.loads(sys.argv[2]))
arrays = types.SimpleNamespace(
    embed=leaves["embed"], ln_f=leaves["ln_f"], head=leaves["head"],
    blocks=types.SimpleNamespace(**{k[7:]: v for k, v in leaves.items()
                                    if k.startswith("blocks.")}))
params = tfm.params_from_jax(arrays, cfg, device="cpu")
E = eng.ServingEngine(comm, cfg, params, max_len=16, max_batch=3,
                      admit="off", markers=True, device=rank_device())
rng = np.random.RandomState(3)
reqs = []
for i in range(7):
    p_len = int(rng.randint(2, 7))
    prompt = tuple(int(x) for x in rng.randint(0, cfg.vocab, p_len))
    reqs.append(Request(i, prompt, int(rng.randint(1, 8)), 0.0))
if E.is_leader:
    for r in reqs:
        E.offer(r, 0.0)
    E.drain(now_ms_fn=lambda: 0.0)
else:
    E.run_follower()
assert len(E.finished) == len(reqs), E.finished
for rid, toks in sorted(E.finished):
    req = reqs[rid]
    n_new = min(req.max_new, 16 - req.prompt_len)
    ref = tfm.reference_greedy_decode(params, torch.tensor([req.prompt]), cfg,
                                      req.prompt_len + n_new)
    assert toks == tuple(ref[0].tolist()), (comm.rank(), rid, toks, ref)
print("FINISHED", comm.rank(), json.dumps(E.finished), flush=True)
print("BITWISE-OK", comm.rank(), flush=True)
"""


def test_serve_job_two_ranks_equal_the_references():
    # the serving engine tensor-parallel over a 2-rank launcher job
    # (--serve): both ranks' responses equal reference_greedy_decode,
    # the port's in the job and the JAX package's here, and the two
    # ranks finish the same requests in the same order
    import jax
    import jax.numpy as jnp

    from mpi4jax_tpu.models import transformer as jtfm

    cfg = jtfm.TransformerConfig(vocab=32, d_model=16, layers=2, heads=4,
                                 kv_heads=2, head_dim=4, d_ff=32)
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    leaves = {"embed": params.embed, "ln_f": params.ln_f,
              "head": params.head,
              **{f"blocks.{k}": v for k, v in params.blocks._asdict().items()}}
    with tempfile.TemporaryDirectory() as d:
        np.savez(pathlib.Path(d) / "params.npz",
                 **{k: np.asarray(v) for k, v in leaves.items()})
        prog = pathlib.Path(d) / "serve.py"
        prog.write_text(SERVE_PROG)
        rc, out, err = run_job(
            "mpi4jax_tpu_torch.launch", 2,
            ["--serve", prog, pathlib.Path(d) / "params.npz",
             json.dumps(cfg._asdict())])
    assert rc == 0, err[-4000:]
    assert out.count("BITWISE-OK") == 2, (out, err[-4000:])
    finished = {}
    for line in out.splitlines():
        if line.startswith("FINISHED "):
            _, rank, body = line.split(" ", 2)
            finished[int(rank)] = [(rid, tuple(t)) for rid, t in
                                   json.loads(body)]
    assert finished[0] == finished[1] and len(finished[0]) == 7
    rng = np.random.RandomState(3)
    prompts = {}
    for i in range(7):
        p_len = int(rng.randint(2, 7))
        prompts[i] = tuple(int(x) for x in rng.randint(0, cfg.vocab, p_len))
        rng.randint(1, 8)
    for rid, toks in finished[0]:
        ref = jtfm.reference_greedy_decode(
            params, jnp.asarray([prompts[rid]], jnp.int32), cfg, len(toks))
        assert toks == tuple(int(t) for t in np.asarray(ref)[0]), rid


def test_serving_bench_tiny():
    # the port's benchmarks/serving.py, one admission-on window on 2 CPU
    # ranks: the records the bench's serving leg reads
    rc, out, err = run_job(
        "mpi4jax_tpu_torch.launch", 2,
        [ROOT / "mpi4jax_tpu_torch" / "benchmarks" / "serving.py", "--arms",
         "on", "--windows", "1", "--duration", "2", "--rate", "6", "--slo",
         "4000", "--layers", "1", "--heads", "4", "--kv-heads", "4"])
    assert rc == 0, err[-4000:]
    recs = {json.loads(line)["metric"]: json.loads(line)
            for line in out.splitlines() if line.startswith("{")}
    assert set(recs) == {f"serving_{k}_proc2" for k in (
        "p50_ms", "p99_ms", "rps", "shed_rate", "slo_attainment",
        "slo_held")}
    for rec in recs.values():
        assert rec["nprocs"] == 2 and rec["device"] == "cpu"
        assert not rec["interleaved_pairs"] and rec["max_batch"] == 4
    assert recs["serving_p99_ms_proc2"]["admit"] == "on"
    assert 0 < recs["serving_p50_ms_proc2"]["value"] <= \
        recs["serving_p99_ms_proc2"]["value"]
    assert recs["serving_rps_proc2"]["value"] > 0
    assert 0 <= recs["serving_shed_rate_proc2"]["value"] <= 1
    assert 0 <= recs["serving_slo_attainment_proc2"]["value"] <= 1
    assert "window 0 arm=on" in err
    # the autoscale contrast is refused, naming the item that brings it
    rc, out, err = run_job(
        "mpi4jax_tpu_torch.launch", 1,
        [ROOT / "mpi4jax_tpu_torch" / "benchmarks" / "serving.py", "--arms",
         "ramp"], timeout=120)
    assert rc != 0 and "item 19" in err

