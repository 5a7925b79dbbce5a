"""Multi-process job launcher of the proc tier: the ``mpirun``
equivalent.

    python -m mpi4jax_tpu_torch.launch -np 4 prog.py [args...]
    python -m mpi4jax_tpu_torch.launch -np 2 --platform cpu prog.py
    python -m mpi4jax_tpu_torch.launch -np 2 --serve --slo 2000 serve.py
    python -m mpi4jax_tpu_torch.launch -np 2 --restarts 2 prog.py
    python -m mpi4jax_tpu_torch.launch -np 4 --elastic rejoin prog.py

The port's counterpart of ``mpi4jax_tpu/launch.py``.  It builds the
native bridge once (``native/build.py``), then starts N worker processes
with the bridge's bootstrap environment (``T4J_RANK``, ``T4J_SIZE``,
``T4J_COORD`` on a free local port, ``T4J_JOB``).  Each worker waits
until every worker has started (a file each in the launcher's
``T4J_READY_DIR``: the bridge's bootstrap deadline then leaves out the
ranks' import skew), joins the bridge
(``native/runtime.py:ensure_initialized``) and runs the program with
``runpy``, so ``mpi4jax_tpu_torch.get_default_comm()`` is the world
``ProcComm`` there.  A worker that dies sends the abort
broadcast first, so its peers' blocked ops raise instead of hanging.

``--platform cuda`` (the default) puts rank r on card ``r % cards``
(``torch.cuda.set_device``; :func:`rank_device` names it), and a rank
on a host with no card raises.  ``--platform cpu`` hides the cards from
the workers (``CUDA_VISIBLE_DEVICES`` empty) and :func:`rank_device` is
the CPU.

The job is fail-fast: the first worker to exit with an error ends it,
and a summary names the rank that failed first (the first to raise,
which claims the job's first-failure file before its abort broadcast,
so a peer failing on that broadcast comes second) with its error, and
the rank that exited first and how (an exit code or a signal); the
launcher's exit code is that worker's (128 + signal for a signal).
``--timeout SECONDS`` is a whole-job deadline: past it the launcher
names the ranks still running and exits 124.  The workers form one
process group, which a failure or a timeout ends (SIGTERM, then SIGKILL
after 10 s).

``--serve`` is the serving job's wiring: ``T4J_ADMIT=on`` for every
rank unless the environment chose (``off`` included), ``--slo MS`` sets
``T4J_SLO_MS`` and ``--max-batch N`` ``T4J_MAX_BATCH`` (both need
``--serve``); the program runs a ``mpi4jax_tpu_torch.serving`` engine
(``benchmarks/serving.py`` is the reference loop).

``--restarts N`` relaunches a failed job whole, up to N more times,
each attempt with a fresh coordinator port and job id ("attempt k/N+1
exited with code ...; restarting the job", "restart budget exhausted",
"job succeeded on attempt k/N+1"); without it the output is the one
attempt's.  Pair it with ``utils/checkpoint.py`` so that a relaunch
resumes at the last saved step.

``--elastic shrink|rejoin`` sets ``T4J_ELASTIC`` for every rank: a rank
that dies is a shrink, not the job's end (the survivors' bridge agrees
on the smaller world, ``native/runtime.py``), and no rank claims the
first-failure file.  Under ``rejoin`` the launcher relaunches the dead
slot alone while rank 0 runs (never rank 0, which owns the coordinator
port) with ``T4J_REJOIN=1``, in the job's process group and under its
deadline; the replacement skips the start-up rendezvous and joins the
survivors at the next epoch.  The job succeeds when at least ``T4J_MIN_WORLD`` ranks
finish cleanly, and the launcher prints the world's membership history
(``boot(4) -> e1:shrink(3) -> e2:rejoin(4)``) and its final membership.

``--autoscale`` comes with ROADMAP Queue 1 item 19's serving job;
``--telemetry``, ``--metrics``, ``--autotune`` and ``--shims`` with item
10.
"""

import argparse
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import uuid

from mpi4jax_tpu_torch.utils import config

__all__ = ["main", "child_main", "rank_device", "run_job"]

KILL_AFTER_S = 10.0  # SIGTERM -> SIGKILL escalation of a torn-down job


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _say(msg):
    print(f"mpi4jax_tpu_torch.launch: {msg}", file=sys.stderr, flush=True)


def rank_device():
    """This worker's ``torch.device``: its card under ``--platform
    cuda`` (rank r on card ``r % cards``), the CPU under ``--platform
    cpu``."""
    import torch

    if os.environ.get("T4J_PLATFORM", "cuda") == "cpu":
        return torch.device("cpu")
    rank = int(os.environ.get("T4J_RANK", "0"))
    return torch.device("cuda", rank % torch.cuda.device_count())


def run_job(n, prog_args, *, platform="cuda", timeout, flags=(), env=None):
    """Run ``python -m mpi4jax_tpu_torch.launch -np n --platform platform
    --timeout timeout *flags *prog_args`` from this checkout (its root on
    ``PYTHONPATH``; ``flags`` such as ``("--serve",)``, ``env`` extra
    variables for the launcher and its ranks) and wait; returns (exit
    code, stdout, stderr, seconds).  The launcher's deadline ends the
    job; this call's, 60 s later, is the backstop."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, **(env or {})}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "mpi4jax_tpu_torch.launch", "-np", str(n),
           "--platform", platform, "--timeout", str(timeout),
           *map(str, flags), *map(str, prog_args)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=root, timeout=timeout + 60)
    return (proc.returncode, proc.stdout, proc.stderr,
            time.perf_counter() - t0)


def _rendezvous():
    """Wait until every worker of the job has started (imported torch),
    so that the bridge's bootstrap, bounded by ``T4J_CONNECT_TIMEOUT``,
    does not also have to absorb the ranks' start-up skew: on a loaded
    host one rank's imports may take longer than that.  Each worker
    marks itself in the launcher's ``T4J_READY_DIR`` and polls for the
    others; the job's deadline and its fail-fast teardown bound the
    wait.  Nothing to wait for outside the launcher, nor for a rank
    relaunched into an elastic job, whose peers are long past it."""
    ready = os.environ.get("T4J_READY_DIR")
    if not ready or os.environ.get("T4J_REJOIN") == "1":
        return
    open(os.path.join(ready, os.environ["T4J_RANK"]), "w").close()
    size = int(os.environ["T4J_SIZE"])
    while len(os.listdir(ready)) < size:
        time.sleep(0.02)


def child_main(argv):
    """A worker: pin the platform, wait for the other workers, join the
    bridge, run the program.  A failure from the bridge's bootstrap on
    is reported as the rank's first failure."""
    prog, *prog_args = argv
    if os.environ.get("T4J_PLATFORM", "cuda") == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {os.environ.get('T4J_RANK', '?')} was launched with "
                "--platform cuda, but torch.cuda.is_available() is False; "
                "pass --platform cpu to run the ranks on the CPU")
        torch.cuda.set_device(rank_device())
    from mpi4jax_tpu_torch.native import runtime

    _rendezvous()
    sys.argv = [prog, *prog_args]
    import runpy

    try:
        runtime.ensure_initialized()
        runpy.run_path(prog, run_name="__main__")
    except BaseException as e:
        code = e.code if isinstance(e, SystemExit) else None
        if not (isinstance(e, SystemExit) and code in (0, None)):
            if os.environ.get("T4J_ELASTIC") not in ("shrink", "rejoin"):
                # in an elastic job a death is a shrink, not the job's end
                _report_first_failure(f"{type(e).__name__}: {e}")
            # the MPI_Abort analog: the peers' blocked ops raise at once
            why = (f"rank {os.environ.get('T4J_RANK', '?')} died: "
                   f"{type(e).__name__}: {e}")
            try:
                runtime.notify_abort(why)
            except Exception:  # noqa: BLE001 (the real failure is raised)
                pass
        raise


def _report_first_failure(what):
    """Claim the job's first-failure file (``T4J_FIRST_FAILURE``, made
    by the launcher; the first rank to create it wins).  A failing rank
    claims it before its abort broadcast, so a peer that fails on that
    broadcast always comes second, whichever exits first."""
    path = os.environ.get("T4J_FIRST_FAILURE")
    if not path:
        return
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
    except FileExistsError:
        return
    with os.fdopen(fd, "w") as f:
        f.write(f"{os.environ.get('T4J_RANK', '?')}\n{what[:500]}")


def _describe_exit(rc):
    """A worker's end in words: a signal kill apart from an exit code."""
    if rc is not None and rc < 0:
        try:
            name = signal.Signals(-rc).name
        except ValueError:
            name = f"signal {-rc}"
        return f"killed by {name} (signal {-rc})"
    return f"exited with code {rc}"


def _job_exit_code(rc):
    """A worker's status as the launcher's exit code: 128 + signal
    number for a signal kill (the shell's convention)."""
    if rc is None:
        return 1
    if rc < 0:
        return 128 - rc
    return rc


def _signal_group(pgid, sig):
    try:
        os.killpg(pgid, sig)
    except ProcessLookupError:
        pass


def _first_failure(path):
    """``(rank, what)`` from the first-failure file, or None."""
    try:
        with open(path) as f:
            rank, _, what = f.read().partition("\n")
    except OSError:
        return None
    return rank, what


def _run_job(args):
    """One launch attempt in a fresh temporary directory (the ready
    marks, the first-failure file)."""
    with tempfile.TemporaryDirectory(prefix="t4j-launch-") as tmp:
        ready = os.path.join(tmp, "ready")
        os.mkdir(ready)
        return _run_workers(args, os.path.join(tmp, "first_failure"), ready)


def _run_workers(args, failure_file, ready_dir):
    n = args.nprocs
    coord = f"127.0.0.1:{_free_port()}"
    job = uuid.uuid4().hex[:12]  # names the job's shared-memory segments
    env = dict(os.environ)
    env.update(T4J_SIZE=str(n), T4J_COORD=coord, T4J_JOB=job,
               T4J_PLATFORM=args.platform, T4J_FIRST_FAILURE=failure_file,
               T4J_READY_DIR=ready_dir)
    env.pop("T4J_REJOIN", None)
    if args.platform == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    if args.elastic:
        env["T4J_ELASTIC"] = args.elastic
    if args.serve:
        # admission on unless the environment chose (off included: the
        # uncontrolled-baseline arm of the benchmarks)
        env.setdefault("T4J_ADMIT", "on")
        if args.slo is not None:
            env["T4J_SLO_MS"] = str(args.slo)
        if args.max_batch is not None:
            env["T4J_MAX_BATCH"] = str(args.max_batch)
    pgid = None

    def spawn(rank, rejoin=False):
        nonlocal pgid
        cmd = [sys.executable, "-m", "mpi4jax_tpu_torch.launch", "--child",
               *args.prog]
        rank_env = dict(env, T4J_RANK=str(rank))
        if rejoin:
            # a replacement re-bootstraps through rank 0's kept-open
            # coordinator port, not the start-up rendezvous
            rank_env["T4J_REJOIN"] = "1"
        # one new process group for the workers (the first one's pid),
        # relaunched ones included
        proc = subprocess.Popen(cmd, env=rank_env, process_group=pgid or 0)
        if pgid is None:
            pgid = proc.pid
        return proc

    procs = [spawn(rank) for rank in range(n)]
    exit_code = 0
    start = time.monotonic()
    torn_down = None
    # the elastic job's membership as the launcher sees it: boot, then
    # one epoch per shrink (a rank died) and per rejoin (its slot
    # relaunched)
    epoch = 0
    members = n
    history = [f"boot({n})"]
    exited_ok = set()
    last_bad_rc = None
    relaunches = 0

    def tear_down(why):
        nonlocal torn_down
        _say(why)
        torn_down = time.monotonic()
        _signal_group(pgid, signal.SIGTERM)

    try:
        remaining = set(range(n))
        while remaining:
            for i in sorted(remaining):
                rc = procs[i].poll()
                if rc is None:
                    continue
                remaining.discard(i)
                if rc == 0:
                    exited_ok.add(i)
                    continue
                if args.elastic and exit_code == 0 and torn_down is None:
                    # a dead rank is a shrink, not the job's end: the
                    # survivors' bridge is agreeing on the smaller world
                    last_bad_rc = rc
                    epoch += 1
                    members -= 1
                    history.append(
                        f"e{epoch}:shrink({members}) [rank {i} "
                        f"{_describe_exit(rc)} at "
                        f"+{time.monotonic() - start:.1f}s]")
                    _say(f"rank {i} {_describe_exit(rc)} — elastic "
                         f"{args.elastic}: {len(remaining)} rank(s) continue")
                    if args.elastic == "rejoin" and i != 0 \
                            and 0 in remaining and relaunches < n:
                        # only the dead slot, and only while rank 0 runs:
                        # it owns the coordinator port a replacement dials
                        relaunches += 1
                        epoch += 1
                        members += 1
                        history.append(f"e{epoch}:rejoin({members}) "
                                       f"[rank {i} relaunched]")
                        _say(f"relaunching rank {i} as a rejoin "
                             f"replacement ({relaunches} so far)")
                        procs[i] = spawn(i, rejoin=True)
                        remaining.add(i)
                    continue
                if exit_code == 0:
                    exit_code = _job_exit_code(rc)
                    first = _first_failure(failure_file)
                    named = ("" if first is None else
                             f"rank {first[0]} failed first ({first[1]}); ")
                    tear_down(f"{named}rank {i} {_describe_exit(rc)} — "
                              f"first exit; terminating {len(remaining)} "
                              "remaining rank(s)")
            if not remaining:
                break
            now = time.monotonic()
            if (args.timeout is not None and exit_code == 0
                    and now - start > args.timeout):
                exit_code = 124
                still = ", ".join(str(i) for i in sorted(remaining))
                tear_down(f"job deadline of {args.timeout:g}s exceeded; "
                          f"rank(s) {still} still running — terminating the "
                          "job")
            if torn_down is not None and now - torn_down > KILL_AFTER_S:
                _signal_group(pgid, signal.SIGKILL)  # a wedged worker
            time.sleep(0.05)
    except KeyboardInterrupt:
        _signal_group(pgid, signal.SIGINT)
        for p in procs:
            p.wait()
        return 130
    if args.elastic:
        floor = config.min_world()
        if exit_code == 0 and len(exited_ok) < floor:
            # below the floor the world did not survive; the nonzero
            # code is what --restarts relaunches the whole job on
            exit_code = _job_exit_code(last_bad_rc)
            _say(f"only {len(exited_ok)} rank(s) finished cleanly — below "
                 f"T4J_MIN_WORLD={floor}; the elastic world did not survive")
        final = sorted(exited_ok)
        _say("world membership history: " + " -> ".join(history))
        _say(f"final world membership: {len(final)}/{n} rank(s) "
             f"[{', '.join(str(r) for r in final)}] after {epoch} "
             "membership epoch(s)")
    return exit_code


def _run_attempts(args):
    """The job, relaunched whole up to ``--restarts`` times while it
    fails (Ctrl-C ends it); without ``--restarts`` the output is the one
    attempt's."""
    attempts = args.restarts + 1
    for attempt in range(1, attempts + 1):
        exit_code = _run_job(args)
        if exit_code in (0, 130):
            break
        if attempt < attempts:
            _say(f"attempt {attempt}/{attempts} exited with code "
                 f"{exit_code}; restarting the job ({attempts - attempt} "
                 "restart(s) left)")
        elif args.restarts:
            _say(f"attempt {attempt}/{attempts} exited with code "
                 f"{exit_code}; restart budget exhausted (--restarts "
                 f"{args.restarts})")
    if args.restarts and exit_code == 0 and attempt > 1:
        _say(f"job succeeded on attempt {attempt}/{attempts}")
    return exit_code


def main(argv=None):
    parser = argparse.ArgumentParser(prog="mpi4jax_tpu_torch.launch")
    parser.add_argument("-np", "--nprocs", type=int, required=False)
    parser.add_argument(
        "--platform", choices=("cuda", "cpu"), default="cuda",
        help="where the ranks run: cuda (default; rank r on card r %% "
        "cards, and a host without a card raises) or cpu")
    parser.add_argument(
        "--timeout", type=float, default=None, metavar="SECONDS",
        help="whole-job deadline: past it the workers are torn down and "
        "the launcher exits 124, naming the ranks still running")
    parser.add_argument(
        "--restarts", type=int, default=0, metavar="N",
        help="bounded auto-relaunch: a job exiting nonzero (other than "
        "Ctrl-C) is relaunched up to N more times with a fresh "
        "coordinator and job id; pair it with utils/checkpoint.py so the "
        "relaunch resumes at the last saved step")
    parser.add_argument(
        "--elastic", choices=("shrink", "rejoin"), default=None,
        metavar="MODE",
        help="elastic membership: a dead rank no longer ends the job; the "
        "survivors agree on a smaller world and go on (shrink), and with "
        "rejoin the launcher relaunches only the dead slot (T4J_REJOIN=1), "
        "which joins again at the next epoch.  Sets T4J_ELASTIC for every "
        "rank; T4J_MIN_WORLD floors the shrink, and the job succeeds when "
        "at least that many ranks finish cleanly.  With --restarts the "
        "whole job is relaunched only when it failed")
    parser.add_argument(
        "--serve", action="store_true",
        help="serving-job wiring (docs/serving.md): T4J_ADMIT=on for every "
        "rank unless the environment chose; pair with --slo for the "
        "latency target.  The program runs a mpi4jax_tpu_torch.serving "
        "engine (benchmarks/serving.py is the reference loop)")
    parser.add_argument(
        "--slo", type=float, default=None, metavar="MS",
        help="with --serve: per-request end-to-end latency SLO in "
        "milliseconds (T4J_SLO_MS for every rank)")
    parser.add_argument(
        "--max-batch", type=int, default=None, metavar="N",
        help="with --serve: concurrent decode slots in the serving "
        "engine's KV pool (T4J_MAX_BATCH)")
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("prog", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.child:
        child_main(args.prog)
        return 0
    if not args.nprocs or not args.prog:
        parser.error("usage: python -m mpi4jax_tpu_torch.launch -np N "
                     "prog.py ...")
    if args.nprocs < 1:
        parser.error("-np must be >= 1")
    if args.timeout is not None and args.timeout <= 0:
        parser.error("--timeout must be > 0 seconds (omit it for no "
                     "deadline)")
    if args.restarts < 0:
        parser.error("--restarts must be >= 0")
    if args.elastic:
        try:
            config.min_world()
        except ValueError as e:
            parser.error(str(e))
    if args.slo is not None and not args.serve:
        parser.error("--slo requires --serve (it sets the serving "
                     "engine's T4J_SLO_MS)")
    if args.max_batch is not None and not args.serve:
        parser.error("--max-batch requires --serve (it sets the "
                     "serving engine's T4J_MAX_BATCH)")
    if args.slo is not None and args.slo <= 0:
        parser.error("--slo must be > 0 milliseconds (omit it for no "
                     "SLO)")
    from mpi4jax_tpu_torch.native import build

    build.ensure_built()  # once, before the ranks' bootstrap deadline
    return _run_attempts(args)


if __name__ == "__main__":
    sys.exit(main())
