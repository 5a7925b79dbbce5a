"""Fault tolerance of the proc tier across OS processes: launcher jobs of
the port (``python -m mpi4jax_tpu_torch.launch --platform cpu``) with
``--restarts`` and ``--elastic``, held to the JAX package's contracts
(tests/proc/test_fault_injection.py, tests/proc/test_failure_recovery.py)
and, where both run the same job, to its results:

* ``--restarts``: a job whose first attempt dies is relaunched and
  succeeds, with the attempt lines; a job that keeps failing exhausts
  the budget and exits with its last code;
* kill and resume over three launches of ``chip_smoke.py --proc-rank
  recover`` (the failure-recovery contract on torch tensors): the first
  dies nonzero after the step-5 checkpoint is committed, the second
  resumes from it, the third runs uninterrupted; the resumed and the
  uninterrupted final states are equal bit for bit, and equal to the
  JAX package's own job (tests/proc/test_failure_recovery.py's ``JOB``
  through ``mpi4jax_tpu.launch``): the allreduce is the same native call
  on both sides;
* ``--elastic shrink`` on 4 ranks: a rank exits hard after a barrier, the
  survivors' ops raise ``WorldResized`` or the ``ResizeInterrupted``
  status, and after ``refresh_after_resize`` their sums equal the new
  ``comm.size``; ``world_info`` reads epoch 1 with 3 alive,
  ``effective_world_size()`` is 3, no survivor escalates to an abort,
  and the launcher prints the membership history;
* a shrink below ``T4J_MIN_WORLD`` fails the job, naming the floor;
* ``run_elastic`` under ``--elastic rejoin`` on 4 ranks (``chip_smoke.py
  --proc-rank elastic`` at d 16, 1 layer): rank 2 exits hard after the
  step-4 checkpoint, the launcher relaunches its slot, the job exits 0
  with every slot in the final world, the survivors through at least 2
  resizes and every rank's final parameters equal bit for bit to those
  of the same job without the death (``chip_smoke.hold_elastic``, the
  card's own checks);
* ``run_elastic`` under ``--elastic shrink`` on 4 ranks: rank 2 exits
  hard after the step-4 checkpoint and the three survivors finish in
  the shrunk world, their final parameters equal bit for bit to a job
  without the death that runs four ranks to step 4 and three ranks on
  from their checkpoints;
* a 2-rank ``run_elastic`` without a fault gives the losses of the JAX
  package's ``run_elastic`` on the same seed within ``LOSS_RTOL`` (the
  template and batches come from ``utils/prng.py``, whose normal is
  within 1e-5 of JAX's; the losses read 5e-7).

Deaths are planted deterministically (``os._exit`` after a committed save
and a barrier, in the first incarnation only), never by timers.  Each job
has its own deadline (the launcher's ``--timeout``, and the process group
killed 30 s later); the ranks run one thread each on tiny payloads.
"""

import importlib.util
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import textwrap

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JOB_TIMEOUT_S = 150
LOSS_RTOL = 1e-5


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("chip_smoke", ROOT / "chip_smoke.py")
RECOVERY = _load("failure_recovery",
                 ROOT / "tests" / "proc" / "test_failure_recovery.py")

# the knobs of the JAX package's elastic tests: a dead rank is declared
# after 2 failed reconnects, each resize phase bounded by 15 s
ELASTIC_ENV = dict(SMOKE.ELASTIC_ENV)

PREAMBLE = """
import os
import sys
import time

import torch

import mpi4jax_tpu_torch as m
from mpi4jax_tpu_torch.native import runtime
from mpi4jax_tpu_torch.native.runtime import WorldResized

torch.set_num_threads(1)
comm = m.get_default_comm()
rank, size = comm.rank(), comm.size
"""


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["T4J_TUNING_CACHE"] = "off"
    for k in ("T4J_ELASTIC", "T4J_REJOIN", "T4J_MIN_WORLD"):
        env.pop(k, None)
    env.update(extra or {})
    return env


def run_job(n, args, *, launcher="mpi4jax_tpu_torch.launch", flags=(),
            env=None, timeout=JOB_TIMEOUT_S):
    """A launcher job with its own deadline; (exit code, stdout, stderr).
    The job's process group is killed if the launcher outlives its
    deadline by 30 s."""
    port = launcher == "mpi4jax_tpu_torch.launch"
    cmd = [sys.executable, "-m", launcher, "-np", str(n),
           *(("--platform", "cpu", "--timeout", str(timeout)) if port
             else ()), *map(str, flags), *map(str, args)]
    popen = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             env=_env(env), cwd=str(ROOT),
                             start_new_session=True)
    try:
        out, err = popen.communicate(timeout=timeout + 30)
    except subprocess.TimeoutExpired:
        os.killpg(os.getpgid(popen.pid), signal.SIGKILL)
        out, err = popen.communicate()
        raise AssertionError(f"job timed out\n{out}\n{err}")
    return popen.returncode, out, err


def _program(tmp_path, body, name="prog.py"):
    prog = tmp_path / name
    prog.write_text(PREAMBLE + textwrap.dedent(body))
    return prog


# -- --restarts ---------------------------------------------------------------


def test_launcher_restarts_until_success(tmp_path):
    marker = tmp_path / "first-attempt-done"
    prog = _program(tmp_path, f"""
        marker = {str(marker)!r}
        first = not os.path.exists(marker)
        m.barrier(comm=comm)  # every rank has read the marker
        if first and rank == 0:
            open(marker, "w").close()
        x = torch.ones(4)
        for i in range(5):
            y, _ = m.allreduce(x, op=m.SUM, comm=comm)
        if first and rank == 1:
            os._exit(17)
        try:
            for i in range(5):
                y, _ = m.allreduce(x, op=m.SUM, comm=comm)
        except Exception:
            sys.exit(5)
        assert float(y[0]) == size
        print("JOB-OK", flush=True)
    """)
    rc, out, err = run_job(2, [prog], flags=("--restarts", 2))
    assert rc == 0, (rc, out[-1000:], err[-3000:])
    assert "attempt 1/3 exited with code 17; restarting the job" in err, \
        err[-3000:]
    assert "job succeeded on attempt 2/3" in err, err[-3000:]
    assert out.count("JOB-OK") == 2, out[-1000:]


def test_launcher_restarts_budget_exhausted(tmp_path):
    prog = _program(tmp_path, """
        if rank == 0:
            os._exit(9)
        time.sleep(60)
    """)
    rc, out, err = run_job(2, [prog], flags=("--restarts", 1))
    assert rc == 9, (rc, out[-1000:], err[-3000:])
    assert "attempt 1/2 exited with code 9; restarting the job" in err
    assert "attempt 2/2 exited with code 9; restart budget exhausted " \
        "(--restarts 1)" in err, err[-3000:]
    assert "succeeded" not in err


# -- kill and resume ------------------------------------------------------------


def test_kill_resume_bit_identical_to_jax(tmp_path):
    total, kill_rank, kill_step = 10, 1, 7
    run_a, run_c, run_j = (tmp_path / d for d in ("a", "c", "jax"))
    for d in (run_a, run_c, run_j):
        d.mkdir()

    def recover(out_dir, kill):
        return run_job(2, [ROOT / "chip_smoke.py", "--proc-rank", "recover",
                           out_dir, total, *kill])

    # A: rank 1 dies hard after step 7 (the step-5 checkpoint is
    # committed); the fail-fast launcher ends the job nonzero
    rc, out, err = recover(run_a, (kill_rank, kill_step))
    assert rc == 17, (rc, out[-1500:], err[-3000:])
    assert "rank 1 exited with code 17" in err
    assert not (run_a / "final.json").exists()
    assert sorted(os.listdir(run_a / "ck")) == ["5"]
    # B: the same job in the same directory resumes from step 5 (the
    # marker of A's death keeps rank 1 alive)
    rc, out, err = recover(run_a, (kill_rank, kill_step))
    assert rc == 0, (rc, out[-1500:], err[-3000:])
    assert "start=5" in out and "start=0" not in out, out[-1500:]
    resumed = json.loads((run_a / "final.json").read_text())
    # C: the uninterrupted oracle
    rc, out, err = recover(run_c, (-1, -1))
    assert rc == 0 and "start=0" in out, (rc, out[-1500:], err[-3000:])
    oracle = json.loads((run_c / "final.json").read_text())
    assert resumed == oracle
    # the JAX package's own job, uninterrupted, through its launcher
    job = tmp_path / "jax_job.py"
    job.write_text(RECOVERY.JOB)
    rc, out, err = run_job(2, [job, run_j, total, -1, -1],
                           launcher="mpi4jax_tpu.launch")
    assert rc == 0, (rc, out[-1500:], err[-3000:])
    assert json.loads((run_j / "final.json").read_text()) == oracle


# -- elastic membership ------------------------------------------------------


SHRINK = """
    x = torch.ones(1024)
    m.allreduce(x, op=m.SUM, comm=comm)
    m.barrier(comm=comm)
    if rank == 2:
        os._exit(42)  # a hard death once every rank passed the barrier
    resized = False
    done = 0
    t0 = time.monotonic()

    def rebuild():
        runtime.refresh_after_resize()
        return m.get_default_comm()

    while done < 6:
        assert time.monotonic() - t0 < 90, "timed out before completing"
        try:
            y, _ = m.allreduce(x, op=m.SUM, comm=comm)
            assert float(y[0]) == float(comm.size), (float(y[0]), comm.size)
            if resized:
                done += 1
        except WorldResized as e:
            resized = True
            assert 2 not in e.new_world and len(e.new_world) == size - 1, e
            comm = rebuild()
            assert comm.size == size - 1, comm.ranks
        except Exception as e:
            if "ResizeInterrupted" not in str(e):
                raise
            runtime.resize_wait()
            try:
                runtime.check_health()
            except WorldResized as w:
                resized = True
                assert 2 not in w.new_world, w
                comm = rebuild()
    assert resized, "the world never resized"
    info = runtime.world_info()
    assert info["epoch"] == 1 and info["alive_count"] == size - 1, info
    assert runtime.effective_world_size() == size - 1
    assert runtime.alive_ranks() == (0, 1, 3), runtime.alive_ranks()
    print(f"SHRUNK-OK {rank} epoch={info['epoch']} "
          f"alive={info['alive_count']}", flush=True)
"""


def test_dead_rank_shrinks_world(tmp_path):
    prog = _program(tmp_path, SHRINK)
    rc, out, err = run_job(4, [prog], flags=("--elastic", "shrink"),
                           env=ELASTIC_ENV)
    assert rc == 0, (rc, out[-2000:], err[-4000:])
    assert out.count("SHRUNK-OK") == 3, out[-2000:]
    for r in (0, 1, 3):
        assert f"SHRUNK-OK {r} epoch=1 alive=3" in out
    assert "escalating to abort" not in err, err[-4000:]
    assert "rank 2 exited with code 42 — elastic shrink: 3 rank(s) " \
        "continue" in err
    assert "world membership history: boot(4) -> e1:shrink(3) [rank 2 " \
        "exited with code 42" in err, err[-2000:]
    assert "final world membership: 3/4 rank(s) [0, 1, 3] after 1 " \
        "membership epoch(s)" in err
    # a death in an elastic job claims no first failure
    assert "failed first" not in err


def test_shrink_below_min_world_fails_the_job(tmp_path):
    prog = _program(tmp_path, """
        x = torch.ones(1024)
        m.barrier(comm=comm)
        if rank == 2:
            os._exit(42)
        try:
            for i in range(2000):
                m.allreduce(x, op=m.SUM, comm=comm)
            print("NO-RAISE", flush=True)
        except Exception as e:
            print(f"OP-RAISED {rank}: {type(e).__name__}: {e}", flush=True)
            sys.exit(3)
    """)
    rc, out, err = run_job(4, [prog], flags=("--elastic", "shrink"),
                           env={**ELASTIC_ENV, "T4J_MIN_WORLD": "4"})
    assert rc != 0, (rc, out[-2000:], err[-4000:])
    assert "NO-RAISE" not in out
    # the ranks' lines may interleave on the one pipe
    assert out.count("OP-RAISED") == 3, out[-2000:]
    assert "T4J_MIN_WORLD=4" in out, out[-2000:]
    assert "below T4J_MIN_WORLD=4; the elastic world did not survive" in err
    assert "final world membership: 0/4 rank(s) []" in err


def test_run_elastic_rejoins(tmp_path):
    run = dict(SMOKE.ELASTIC_RUN, d=16, layers=1, batch=2, steps=16)
    oracle = tmp_path / "oracle"
    oracle.mkdir()
    rc, out, err = run_job(4, SMOKE.elastic_args(
        oracle, dict(run, kill_rank=-1, kill_step=-1)),
        flags=("--elastic", "rejoin"), env=ELASTIC_ENV)
    assert rc == 0, (rc, out[-2000:], err[-4000:])
    rc, out, err = run_job(4, SMOKE.elastic_args(tmp_path, run),
                           flags=("--elastic", "rejoin"), env=ELASTIC_ENV)
    res, rejoin_s = SMOKE.hold_elastic(tmp_path, run, rc, out, err, oracle)
    assert "relaunching rank 2 as a rejoin replacement" in err
    assert "rejoin(4)" in err
    assert rejoin_s > 0
    for r in range(4):
        assert res[r]["last_step"] == run["steps"] - 1
        assert res[r]["final_epoch"] == 2, res[r]


def test_run_elastic_shrinks(tmp_path):
    # the loop's leg in a shrunk world: rank 2 dies after the step-4
    # checkpoint and the three survivors run steps 5-9 without it
    run = dict(SMOKE.ELASTIC_RUN, d=16, layers=1, batch=2, steps=10)
    clean = dict(run, kill_rank=-1, kill_step=-1)
    rc, out, err = run_job(4, SMOKE.elastic_args(tmp_path, run),
                           flags=("--elastic", "shrink"), env=ELASTIC_ENV)
    assert rc == 0, (rc, out[-2000:], err[-4000:])
    assert "final world membership: 3/4 rank(s) [0, 1, 3]" in err, \
        err[-2000:]
    assert "escalating to abort" not in err, err[-4000:]
    survivors = (0, 1, 3)
    for r in survivors:
        res = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert res["final_world"] == 3 and res["final_epoch"] == 1, res
        assert res["resizes"] >= 1 and res["last_step"] == 9, res
    # the oracle without a death: four ranks to the committed step 4,
    # then three ranks from their checkpoints, member m from survivor
    # survivors[m]'s series (a member's batches follow its index)
    head, tail = tmp_path / "head", tmp_path / "tail"
    head.mkdir()
    rc, out, err = run_job(4, SMOKE.elastic_args(
        head, dict(clean, steps=run["kill_step"] + 1)),
        flags=("--elastic", "shrink"), env=ELASTIC_ENV)
    assert rc == 0, (rc, out[-2000:], err[-4000:])
    for m, r in enumerate(survivors):
        shutil.copytree(head / "ck" / f"rank{r}", tail / "ck" / f"rank{m}")
    rc, out, err = run_job(3, SMOKE.elastic_args(tail, dict(clean, ranks=3)),
                           flags=("--elastic", "shrink"), env=ELASTIC_ENV)
    assert rc == 0, (rc, out[-2000:], err[-4000:])
    want = SMOKE.load_results(tail / "rank0.npz")
    for m, r in enumerate(survivors):
        got = SMOKE.load_results(tmp_path / f"rank{r}.npz")
        oracle = SMOKE.load_results(tail / f"rank{m}.npz")
        for k in want:
            assert SMOKE.same_bits(oracle[k], want[k]), (m, k)
            assert SMOKE.same_bits(got[k], want[k]), (r, k)


JAX_ELASTIC = """
import json
import sys

import jax

jax.config.update("jax_platforms", "cpu")
from mpi4jax_tpu.models.train import run_elastic

out = run_elastic(int(sys.argv[2]), sys.argv[1], d=16, layers=1, batch=2,
                  save_every=2)
print("LOSSES " + json.dumps(out["losses"]), flush=True)
"""


def test_run_elastic_losses_match_jax(tmp_path):
    steps = 6
    run = dict(SMOKE.ELASTIC_RUN, ranks=2, d=16, layers=1, batch=2,
               steps=steps, kill_rank=-1, kill_step=-1)
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    rc, out, err = run_job(2, SMOKE.elastic_args(port_dir, run),
                           flags=("--elastic", "rejoin"), env=ELASTIC_ENV)
    assert rc == 0, (rc, out[-2000:], err[-4000:])
    port = [json.loads((port_dir / f"rank{r}.json").read_text())
            for r in range(2)]
    assert port[0]["losses"] == port[1]["losses"]
    assert port[0]["resizes"] == 0 and port[0]["final_world"] == 2
    prog = tmp_path / "jax_elastic.py"
    prog.write_text(JAX_ELASTIC)
    rc, out, err = run_job(2, [prog, tmp_path / "jax", steps],
                           launcher="mpi4jax_tpu.launch")
    assert rc == 0, (rc, out[-2000:], err[-4000:])
    jax_losses = [json.loads(line.split(" ", 1)[1])
                  for line in out.splitlines() if line.startswith("LOSSES")]
    assert len(jax_losses) == 2 and jax_losses[0] == jax_losses[1]
    np.testing.assert_allclose(port[0]["losses"], jax_losses[0],
                               rtol=LOSS_RTOL, atol=0)
