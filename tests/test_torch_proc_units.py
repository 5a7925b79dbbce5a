"""The proc tier's pure parts held to the JAX package's, with no process
spawned:

* every environment knob of ``utils/config.py`` on a table of valid and
  invalid values: the same value, or the same ``ValueError``;
* ``_stable_ctx``, the operator codes and the dtype codes;
* ``coalesce_eligible`` under the environment and an override;
* ``ProcGridComm``'s ``coords_of``, ``shift_perm`` and ``sub`` on grids
  (2, 2), (2, 4), (1, 8) and (3, 2), periodic and not, from every rank,
  and ``ProcComm.split`` with ragged groups;
* the launcher's ``_describe_exit`` and ``_job_exit_code``, its
  start-up rendezvous, a bootstrap failure claiming the job's
  first-failure file, and ``--restarts``'s loop (its lines and exit
  code) and parse errors with ``--elastic``'s, word for word as the JAX
  launcher's;
* ``T4J_ELASTIC=shrink|rejoin`` reaching the (stubbed) bridge with the
  JAX package's codes;
* the port's bridge, built with g++ from ``dcn.cc``, ``shm.cc`` and the
  port's C shim: every symbol the port's runtime binds is in it, with
  the JAX package's ctypes signature, and no XLA handler is.
"""

import ctypes
import random
import re
import subprocess

import pytest
import torch

from mpi4jax_tpu import launch as jlaunch
from mpi4jax_tpu import tuning as jtuning
from mpi4jax_tpu.native import runtime as jruntime
from mpi4jax_tpu.ops import _proc as jproc_ops
from mpi4jax_tpu.parallel import proc as jproc
from mpi4jax_tpu.utils import config as jconfig

from mpi4jax_tpu_torch import launch as tlaunch
from mpi4jax_tpu_torch import tuning as ttuning
from mpi4jax_tpu_torch.native import build as tbuild
from mpi4jax_tpu_torch.native import runtime as truntime
from mpi4jax_tpu_torch.ops import _proc as tproc_ops
from mpi4jax_tpu_torch.parallel import proc as tproc
from mpi4jax_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

KNOBS = {
    "op_timeout": "T4J_OP_TIMEOUT",
    "connect_timeout": "T4J_CONNECT_TIMEOUT",
    "ring_min_bytes": "T4J_RING_MIN_BYTES",
    "seg_bytes": "T4J_SEG_BYTES",
    "coalesce_bytes": "T4J_COALESCE_BYTES",
    "stripes": "T4J_STRIPES",
    "zerocopy_min_bytes": "T4J_ZEROCOPY_MIN_BYTES",
    "sendmsg_batch": "T4J_SENDMSG_BATCH",
    "emu_flow_bps": "T4J_EMU_FLOW_BPS",
    "wire_dtype": "T4J_WIRE_DTYPE",
    "wire_backend": "T4J_WIRE_BACKEND",
    "hier_mode": "T4J_HIER",
    "leader_ring_min_bytes": "T4J_LEADER_RING_MIN_BYTES",
    "retry_max": "T4J_RETRY_MAX",
    "backoff_base": "T4J_BACKOFF_BASE",
    "backoff_max": "T4J_BACKOFF_MAX",
    "replay_bytes": "T4J_REPLAY_BYTES",
    "elastic_mode": "T4J_ELASTIC",
    "min_world": "T4J_MIN_WORLD",
    "resize_timeout": "T4J_RESIZE_TIMEOUT",
    "slo_ms": "T4J_SLO_MS",
    "max_batch": "T4J_MAX_BATCH",
    "admit_mode": "T4J_ADMIT",
    "autoscale_mode": "T4J_AUTOSCALE",
}

# every knob reads every value: numbers, sizes, words, and typos
VALUES = [None, "", "  ", "0", "1", "3", "8", "16", "17", "256", "257",
          "4096", "-1", "-0.5", "0.5", "0.01", "2.5", "1e9", "inf", "nan",
          "16K", "2m", " 1G ", "8 k", "1.5K", "9" * 20, "abc", "auto",
          "AUTO", " Off ", "on", "bf16", "FP8", "sendmsg", "uring",
          "shrink", "rejoin", "true"]


def _outcome(fn):
    try:
        return "value", fn()
    except ValueError as e:
        return "ValueError", str(e)


def _set(monkeypatch, var, value):
    if value is None:
        monkeypatch.delenv(var, raising=False)
    else:
        monkeypatch.setenv(var, value)


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_matches_jax(knob, monkeypatch):
    for var in KNOBS.values():
        monkeypatch.delenv(var, raising=False)
    for value in VALUES:
        _set(monkeypatch, KNOBS[knob], value)
        assert _outcome(getattr(tconfig, knob)) == \
            _outcome(getattr(jconfig, knob)), (knob, value)


def test_backoff_max_against_base_matches_jax(monkeypatch):
    for base in (None, "0.05", "3", "0", "x"):
        for cap in (None, "0.01", "2", "3", "10"):
            _set(monkeypatch, "T4J_BACKOFF_BASE", base)
            _set(monkeypatch, "T4J_BACKOFF_MAX", cap)
            assert _outcome(tconfig.backoff_max) == \
                _outcome(jconfig.backoff_max), (base, cap)


@pytest.mark.parametrize("helper", ["seconds", "byte_count", "int_count"])
def test_parsers_match_jax(helper):
    for value in VALUES:
        for minimum in (0, 1):
            assert _outcome(lambda: getattr(tconfig, helper)(
                value, 7, name="X", minimum=minimum)) == _outcome(
                lambda: getattr(jconfig, helper)(
                    value, 7, name="X", minimum=minimum)), (helper, value)
    for value in VALUES:
        assert _outcome(lambda: tconfig.truthy(value, default=True)) == \
            _outcome(lambda: jconfig.truthy(value, default=True)), value


def test_stable_ctx_matches_jax():
    rng = random.Random(5)
    cases = [((0,), 0), ((0, 1), 0), ((1, 0), 3), ((0, 1, 2, 3), 0)]
    cases += [(tuple(sorted(rng.sample(range(64), rng.randint(1, 16)))),
               rng.randint(0, 1 << 20)) for _ in range(200)]
    for ranks, context in cases:
        got = truntime._stable_ctx(ranks, context)
        assert got == jruntime._stable_ctx(ranks, context)
        assert 0 < got < 1 << 30


def test_op_and_dtype_codes_match_jax():
    assert tproc_ops.OP_CODES == jproc_ops._OP_CODES
    by_name = {str(dt).removeprefix("torch."): code
               for dt, code in truntime.DTYPE_CODES.items()}
    assert by_name == jruntime._DTYPE_CODES
    assert truntime.dtype_code(torch.bfloat16) == 14
    with pytest.raises(ValueError, match="unsupported dtype"):
        truntime.dtype_code(torch.float8_e4m3fn)


@pytest.fixture
def clean_coalesce(monkeypatch):
    monkeypatch.delenv("T4J_COALESCE_BYTES", raising=False)
    monkeypatch.setitem(jtuning._state, "effective", None)
    monkeypatch.setitem(jtuning._state, "coalesce_override", None)
    monkeypatch.setitem(ttuning._state, "coalesce_override", None)


def test_coalesce_eligible_matches_jax(monkeypatch, clean_coalesce):
    sizes = (0, 1, 100, 16 << 10, (16 << 10) + 1, 1 << 20, 1 << 31)
    for env in (None, "", "0", "16K", "1k", "64", "-5", "bogus", "2M"):
        _set(monkeypatch, "T4J_COALESCE_BYTES", env)
        for override in (None, 0, 1 << 30, 4096):
            ttuning._state["coalesce_override"] = override
            jtuning._state["coalesce_override"] = override
            if env in ("-5", "bogus") and override is None:
                # the port has no autotune cache and so no lenient
                # reader: an unreadable value raises the JAX config's
                # error here too, as it does at either bridge's init
                with pytest.raises(ValueError) as want:
                    jconfig.coalesce_bytes()
                with pytest.raises(ValueError,
                                   match=re.escape(str(want.value))):
                    ttuning.coalesce_bytes()
                continue
            assert ttuning.coalesce_bytes() == jtuning.coalesce_bytes()
            for total in sizes:
                for nparts in (0, 1, 2, 3, 12):
                    assert ttuning.coalesce_eligible(total, nparts) == \
                        jtuning.coalesce_eligible(total, nparts), (
                            env, override, total, nparts)


def test_override_coalesce_before_init(clean_coalesce):
    # no bridge in this process: the override is this process's alone
    ttuning.override_coalesce(0)
    assert ttuning.coalesce_eligible(10, 2) is False
    ttuning.override_coalesce(None)
    assert ttuning.coalesce_eligible(10, 2) is True


def _as_world_rank(monkeypatch, rank):
    monkeypatch.setattr(truntime, "world_rank", lambda: rank)
    monkeypatch.setattr(jruntime, "world_rank", lambda: rank)


def _same_comm(t, j):
    assert type(t).__name__ == type(j).__name__
    assert (t.ranks, t.context, t.size) == (tuple(j.ranks), j.context, j.size)
    if hasattr(j, "axes"):
        assert (t.axes, t.axis_sizes) == (j.axes, j.axis_sizes)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (1, 8), (3, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_grid_comm_topology_matches_jax(shape, monkeypatch):
    n = shape[0] * shape[1]
    # a world of n ranks, and a subgroup of odd world ranks
    for members in (tuple(range(n)), tuple(range(1, 2 * n, 2))):
        t_base = tproc.ProcComm(ranks=members, context=4)
        j_base = jproc.ProcComm(ranks=members, context=4)
        tg = tproc.grid_comm(shape, base=t_base)
        jg = jproc.grid_comm(shape, base=j_base)
        _same_comm(tg, jg)
        assert (tg.rank_grid() == jg.rank_grid()).all()
        for r in range(n):
            assert tg.coords_of(r) == tuple(int(c) for c in jg.coords_of(r))
        for axis in tg.axes:
            for disp in (-2, -1, 1, 2):
                for periodic in (True, False):
                    assert tg.shift_perm(axis, disp, periodic) == \
                        jg.shift_perm(axis, disp, periodic)
        for world_rank in members:
            _as_world_rank(monkeypatch, world_rank)
            assert tg.rank() == jg.rank()
            for axes in (("y",), ("x",), ("y", "x"), ("x", "y")):
                _same_comm(tg.sub(*axes), jg.sub(*axes))
        with pytest.raises(ValueError, match="not in"):
            tg.sub("z")
    with pytest.raises(ValueError, match="needs"):
        tproc.ProcGridComm(ranks=(0, 1, 2), axes=("y", "x"),
                           axis_sizes=shape)


def test_split_ragged_groups_match_jax(monkeypatch):
    t_comm = tproc.ProcComm(ranks=tuple(range(7)))
    j_comm = jproc.ProcComm(ranks=tuple(range(7)))
    colors = [
        lambda r: r % 3,
        [0, 0, 1, 1, 1, None, 0],
        lambda r: None if r == 3 else r < 2,
    ]
    keys = [None, lambda r: -r, [3, 1, 2, 0, 5, 4, 6]]
    for world_rank in range(7):
        _as_world_rank(monkeypatch, world_rank)
        for color in colors:
            for key in keys:
                t, j = t_comm.split(color, key), j_comm.split(color, key)
                assert (t is None) == (j is None)
                if t is not None:
                    _same_comm(t, j)
    with pytest.raises(ValueError, match="color must cover all 7"):
        t_comm.split([0, 1])


def test_world_comm_needs_a_job():
    # no launcher job here: no proc world, the default comm is SelfComm
    assert tproc.world_comm_if_initialized() is None
    with pytest.raises(RuntimeError, match="no multi-process world"):
        tproc.grid_comm((2, 2))


class _StubBridge:
    """A bridge library that records its knob calls and fails its init,
    so ``ensure_initialized`` runs its checks and passes every knob down
    without building or joining anything."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 1 if name == "t4j_init" else 0

        return call


@pytest.mark.parametrize("mode", ["shrink", "rejoin"])
def test_elastic_modes_refused_before_the_build(mode, monkeypatch):
    # the launcher's --elastic runs an elastic job now: init accepts the
    # mode and passes it down with the JAX package's code, the floor and
    # the resize bound (the stubbed bridge then fails its init); what is
    # still refused before anything is loaded is elastic without the
    # self-healing ladder and a mode that is not one
    monkeypatch.setenv("T4J_RANK", "0")
    monkeypatch.setenv("T4J_SIZE", "2")
    monkeypatch.setenv("T4J_ELASTIC", mode)
    monkeypatch.setenv("T4J_RETRY_MAX", "3")
    monkeypatch.setenv("T4J_MIN_WORLD", "2")
    monkeypatch.setenv("T4J_RESIZE_TIMEOUT", "12.5")
    lib = _StubBridge()
    monkeypatch.setattr(truntime, "_load", lambda: lib)
    assert jconfig.elastic_mode() == tconfig.elastic_mode() == mode
    with pytest.raises(truntime.BridgeError, match="init failed"):
        truntime.ensure_initialized()
    assert lib.calls["t4j_set_elastic"] == (
        jruntime._ELASTIC_MODES[mode], 2, 12.5)
    assert "t4j_init" in lib.calls
    # elastic needs the self-healing ladder, as in the JAX package; a
    # bad mode raises before anything is loaded
    monkeypatch.setenv("T4J_RETRY_MAX", "0")
    with pytest.raises(ValueError, match="T4J_RETRY_MAX > 0"):
        truntime.ensure_initialized()
    monkeypatch.setenv("T4J_ELASTIC", "bogus")
    monkeypatch.setattr(truntime, "_load", lambda: pytest.fail(
        "the bridge was loaded for a refused knob"))
    with pytest.raises(ValueError, match="T4J_ELASTIC"):
        truntime.ensure_initialized()


@pytest.mark.parametrize("rc", [None, 0, 1, 2, 124, 255, -2, -6, -9, -15,
                                -99])
def test_launcher_exit_reports_match_jax(rc):
    assert tlaunch._describe_exit(rc) == jlaunch._describe_exit(rc)
    assert tlaunch._job_exit_code(rc) == jlaunch._job_exit_code(rc)


def _parse_error(main, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2
    return capsys.readouterr().err.splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["-np", "2", "--slo", "100", "prog.py"],
    ["-np", "2", "--max-batch", "4", "prog.py"],
    ["-np", "2", "--serve", "--slo", "0", "prog.py"],
    ["-np", "2", "--serve", "--slo", "-5", "prog.py"],
    ["-np", "2", "--serve", "--max-batch", "x", "prog.py"],
    ["-np", "2", "--serve", "--slo", "soon", "prog.py"],
])
def test_launcher_serve_parse_errors_match_jax(argv, capsys, monkeypatch):
    # refused before anything is built or spawned, with the JAX
    # launcher's own words
    monkeypatch.setattr(tbuild, "ensure_built", lambda: pytest.fail(
        "the launcher built the bridge for a refused command line"))
    assert _parse_error(tlaunch.main, argv, capsys) == \
        _parse_error(jlaunch.main, argv, capsys)


@pytest.mark.parametrize("argv", [
    ["-np", "2", "--restarts", "-1", "prog.py"],
    ["-np", "2", "--restarts", "two", "prog.py"],
    ["-np", "2", "--elastic", "grow", "prog.py"],
])
def test_launcher_fault_tolerance_parse_errors_match_jax(argv, capsys,
                                                         monkeypatch):
    monkeypatch.setattr(tbuild, "ensure_built", lambda: pytest.fail(
        "the launcher built the bridge for a refused command line"))
    assert _parse_error(tlaunch.main, argv, capsys) == \
        _parse_error(jlaunch.main, argv, capsys)


def _attempt_lines(launcher, restarts, codes, capsys, monkeypatch):
    """The launcher's exit code and its stderr lines (prefix dropped) for
    a job whose attempts exit with ``codes`` in turn."""
    codes = list(codes)
    monkeypatch.setattr(launcher, "_run_job", lambda args: codes.pop(0))
    monkeypatch.setattr(tbuild, "ensure_built", lambda: None)
    rc = launcher.main(["-np", "2", "--restarts", str(restarts), "prog.py"])
    lines = [line.split(": ", 1)[1]
             for line in capsys.readouterr().err.splitlines()]
    return rc, lines, codes


@pytest.mark.parametrize("restarts,codes", [
    (2, [17, 0]), (1, [9, 9]), (0, [3]), (0, [0]), (2, [130]),
    (3, [5, 6, 0]), (2, [1, 1, 1]),
])
def test_launcher_restart_loop_matches_jax(restarts, codes, capsys,
                                           monkeypatch):
    # the attempt, budget and success lines, word for word, and the exit
    # code: the last attempt's, Ctrl-C (130) ending the loop
    port = _attempt_lines(tlaunch, restarts, codes, capsys, monkeypatch)
    jax_ = _attempt_lines(jlaunch, restarts, codes, capsys, monkeypatch)
    assert port == jax_


@pytest.mark.parametrize("flags,ambient,want", [
    (["--serve"], {}, {"T4J_ADMIT": "on"}),
    (["--serve", "--slo", "2500", "--max-batch", "16"], {},
     {"T4J_ADMIT": "on", "T4J_SLO_MS": "2500.0", "T4J_MAX_BATCH": "16"}),
    (["--serve"], {"T4J_ADMIT": "off"}, {"T4J_ADMIT": "off"}),
    ([], {}, {}),
])
def test_launcher_serve_wires_the_environment(flags, ambient, want,
                                              monkeypatch):
    # every worker gets the serving knobs the JAX launcher gives it:
    # admission on unless the environment chose, the SLO and the slots
    for var in ("T4J_ADMIT", "T4J_SLO_MS", "T4J_MAX_BATCH"):
        monkeypatch.delenv(var, raising=False)
    for var, value in ambient.items():
        monkeypatch.setenv(var, value)
    envs = []

    class Worker:
        pid = 4242

        def __init__(self, cmd, env, process_group):
            envs.append(env)

        def poll(self):
            return 0

    monkeypatch.setattr(tlaunch.subprocess, "Popen", Worker)
    monkeypatch.setattr(tbuild, "ensure_built", lambda: None)
    assert tlaunch.main(["-np", "2", *flags, "prog.py"]) == 0
    assert len(envs) == 2
    for env in envs:
        got = {k: env[k] for k in ("T4J_ADMIT", "T4J_SLO_MS",
                                   "T4J_MAX_BATCH") if k in env}
        assert got == want


@pytest.fixture(scope="module")
def bridge():
    return tbuild.ensure_built()


def _exported(path):
    out = subprocess.run(["nm", "-D", "--defined-only", str(path)],
                         capture_output=True, text=True, check=True).stdout
    return {line.split()[-1] for line in out.splitlines() if line.strip()}


def test_bridge_builds_in_the_ports_tree(bridge):
    assert bridge.parent.parent == tbuild.BUILD_ROOT
    assert bridge.name == tbuild.LIB_NAME
    log = (bridge.parent / "build.log").read_text()
    for src in tbuild.SOURCES:
        assert str(src) in log
    assert "ffi.cc" not in log and "_t4j_dcn" not in log
    # a second call is the same library, built once
    assert tbuild.ensure_built() == bridge


def test_bridge_exports_the_bound_symbols_and_no_handler(bridge):
    names = _exported(bridge)
    missing = set(truntime.SIGNATURES) - names
    assert not missing
    assert not set(jruntime.HANDLER_NAMES) & names
    # the whole plain-C API of ffi.cc: 69 entry points
    assert len({n for n in names if n.startswith("t4j_")}) == 69


def test_bindings_match_jax_signatures(bridge, monkeypatch):
    # the JAX package's loader binds the same library: its argtypes and
    # restypes are the port's, name for name
    from mpi4jax_tpu.native import build as jbuild

    monkeypatch.setattr(jbuild, "ensure_built", lambda: bridge)
    monkeypatch.setitem(jruntime._state, "lib", None)
    jlib = jruntime._load()
    tlib = ctypes.CDLL(str(bridge))
    for name, (argtypes, restype) in truntime.SIGNATURES.items():
        jfn = getattr(jlib, name)
        getattr(tlib, name)  # resolvable
        if jfn.argtypes is not None:
            assert list(jfn.argtypes) == list(argtypes), name
        if restype is not None and jfn.restype is not ctypes.c_int:
            assert jfn.restype == restype, name


def test_launcher_rendezvous_waits_for_every_worker(tmp_path, monkeypatch):
    import threading
    import time

    monkeypatch.setenv("T4J_READY_DIR", str(tmp_path))
    monkeypatch.setenv("T4J_SIZE", "3")
    monkeypatch.setenv("T4J_RANK", "0")

    def late(rank, delay):
        time.sleep(delay)
        (tmp_path / str(rank)).touch()

    for rank, delay in ((1, 0.1), (2, 0.3)):
        threading.Thread(target=late, args=(rank, delay)).start()
    t0 = time.monotonic()
    tlaunch._rendezvous()
    assert time.monotonic() - t0 >= 0.3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["0", "1", "2"]
    monkeypatch.delenv("T4J_READY_DIR")
    tlaunch._rendezvous()  # outside the launcher: nothing to wait for


def test_a_bootstrap_failure_is_named_first(tmp_path, monkeypatch):
    import sys

    first = tmp_path / "first_failure"
    monkeypatch.setenv("T4J_PLATFORM", "cpu")
    monkeypatch.setenv("T4J_RANK", "3")
    monkeypatch.setenv("T4J_FIRST_FAILURE", str(first))
    monkeypatch.delenv("T4J_READY_DIR", raising=False)

    def refuse():
        raise truntime.BridgeError("r3 | t4j: bootstrap refused")

    monkeypatch.setattr(truntime, "ensure_initialized", refuse)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    with pytest.raises(truntime.BridgeError, match="bootstrap refused"):
        tlaunch.child_main([str(tmp_path / "never_run.py")])
    assert first.read_text() == "3\nBridgeError: r3 | t4j: bootstrap refused"
