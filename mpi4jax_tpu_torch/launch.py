"""Multi-process job launcher of the proc tier: the ``mpirun``
equivalent.

    python -m mpi4jax_tpu_torch.launch -np 4 prog.py [args...]
    python -m mpi4jax_tpu_torch.launch -np 2 --platform cpu prog.py
    python -m mpi4jax_tpu_torch.launch -np 2 --serve --slo 2000 serve.py

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

``--restarts``, ``--elastic`` and ``--autoscale`` come with ROADMAP
Queue 1 item 19; ``--telemetry``, ``--metrics``, ``--autotune`` and
``--shims`` with item 10.
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


def run_job(n, prog_args, *, platform="cuda", timeout, flags=()):
    """Run ``python -m mpi4jax_tpu_torch.launch -np n --platform platform
    --timeout timeout *flags *prog_args`` from this checkout (its root on
    ``PYTHONPATH``; ``flags`` such as ``("--serve",)``) and wait; returns
    (exit code, stdout, stderr, seconds).  The launcher's deadline ends
    the job; this call's, 60 s later, is the backstop."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
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
    wait.  Nothing to wait for outside the launcher."""
    ready = os.environ.get("T4J_READY_DIR")
    if not ready:
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
    if args.platform == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    if args.serve:
        # admission on unless the environment chose (off included: the
        # uncontrolled-baseline arm of the benchmarks)
        env.setdefault("T4J_ADMIT", "on")
        if args.slo is not None:
            env["T4J_SLO_MS"] = str(args.slo)
        if args.max_batch is not None:
            env["T4J_MAX_BATCH"] = str(args.max_batch)
    procs = []
    pgid = None
    for rank in range(n):
        cmd = [sys.executable, "-m", "mpi4jax_tpu_torch.launch", "--child",
               *args.prog]
        # one new process group for the workers (the first one's pid)
        procs.append(subprocess.Popen(cmd, env=dict(env, T4J_RANK=str(rank)),
                                      process_group=pgid or 0))
        if pgid is None:
            pgid = procs[0].pid
    exit_code = 0
    start = time.monotonic()
    torn_down = None

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
                if rc != 0 and exit_code == 0:
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
        exit_code = 130
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
    return _run_job(args)


if __name__ == "__main__":
    sys.exit(main())
