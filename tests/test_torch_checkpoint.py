"""The port's checkpoints (``utils/checkpoint.py``) and resumable solver
runs (``make_solver(..., checkpoint_dir=...)``), the cases of
tests/test_checkpoint.py on torch tensors:

* round trips of a plain tree (float32, bfloat16, int64, Python and
  numpy scalars) and of a solver state with its float64 model time: bit
  for bit, in the template's dtype and on its device;
* ``Manager`` retention, ``latest_step``, the commit by rename (a step
  half written, or a temporary left by a crash, is invisible) and the
  durability barrier;
* a solver state saved mid-run and restored continues bit for bit as the
  uninterrupted run, on one rank and on each rank of a 2x2 local world;
* ``make_solver`` resumes from its checkpoints (ny=16, nx=32, ghost 2)
  bit for bit against an uninterrupted run, on one rank and on the 2x2
  local world (one series a rank, resumed at the ranks' common step), and
  a rerun of a finished run returns its state with ``steps == 0`` and
  writes no checkpoint;
* against the JAX package: JAX's ``make_solver`` state at ``t_half``
  carried across into a port checkpoint and resumed by the port's
  ``make_solver`` to ``t_full`` equals JAX's ``make_solver(t_full)``
  within the solver's 2e-4 of tests/test_torch_shallow_water.py.

All in process, on the CPU, on small grids.
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import shallow_water as jsw

from mpi4jax_tpu_torch.models import shallow_water as tsw
from mpi4jax_tpu_torch.parallel import distributed
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

CFG = tsw.SWConfig(ny=16, nx=32, ghost=2)
CHUNK = 5
T_HALF = CFG.dt * (1 + CHUNK) + CFG.dt * CHUNK * 2  # warm-up + 2 chunks
T_FULL = T_HALF + CFG.dt * CHUNK * 2  # + 2 more
FIELDS = list(tsw.SWState._fields)
SOLVER_TOL = 2e-4  # tests/test_torch_shallow_water.py's solver tolerance


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _on_grid(fn, grid):
    """``fn(comm)`` on one rank (``grid`` None) or on every rank of a
    local world of that grid; the list of results."""
    if grid is None:
        return [fn(MeshComm())]
    return distributed.local_world(grid[0] * grid[1], fn,
                                   axes=(("y", "x"), grid), deadline=120.0)


def test_roundtrip_plain_tree(tmp_path):
    tree = {
        "a": torch.arange(6.0).reshape(2, 3),
        "half": torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16),
        "ints": torch.arange(-3, 4, dtype=torch.int64),
        "view": torch.arange(12.0)[::3],
        "step": np.int64(7),
        "t": np.float64(1.0 / 3.0),
        "lr": 0.1,
        "n": 3,
        "ok": True,
        "nested": [np.arange(4, dtype=np.int32), (torch.ones(2),)],
    }
    ckpt.save(tmp_path / "c1", tree)
    like = {
        "a": torch.zeros(2, 3),
        "half": torch.zeros(3, dtype=torch.bfloat16),
        "ints": torch.zeros(7, dtype=torch.int64),
        "view": torch.zeros(4),
        "step": np.int64(0),
        "t": np.float64(0),
        "lr": 0.0,
        "n": 0,
        "ok": False,
        "nested": [np.zeros(4, np.int32), (torch.zeros(2),)],
    }
    out = ckpt.restore(tmp_path / "c1", like=like)
    assert list(out) == list(like)
    for k in ("a", "half", "ints", "view"):
        assert _same(out[k], tree[k]), k
    assert type(out["step"]) is np.int64 and out["step"] == 7
    assert type(out["t"]) is np.float64 and out["t"] == np.float64(1 / 3)
    assert type(out["lr"]) is float and out["lr"] == 0.1
    assert type(out["n"]) is int and out["n"] == 3
    assert out["ok"] is True
    assert np.array_equal(out["nested"][0], tree["nested"][0])
    assert out["nested"][0].dtype == np.int32
    assert _same(out["nested"][1][0], tree["nested"][1][0])
    # the template's dtype wins; the structure and shapes must match
    wide = {**like, "a": torch.zeros(2, 3, dtype=torch.float64)}
    as64 = ckpt.restore(tmp_path / "c1", like=wide)
    assert as64["a"].dtype == torch.float64
    assert torch.equal(as64["a"], tree["a"].double())
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path / "c1", like={**like, "a": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path / "c1", like={"a": torch.zeros(2, 3)})
    with pytest.raises(FileExistsError):
        ckpt.save(tmp_path / "c1", tree, force=False)


def test_roundtrip_solver_state(tmp_path):
    state = tsw.make_first_step(CFG, MeshComm())(
        tsw.make_init(CFG, MeshComm(), device="cpu")())
    tree = {"state": state, "t": np.float64(CFG.dt)}
    ckpt.save(tmp_path / "s", tree)
    blank = tsw.SWState(*(torch.empty_like(f) for f in state))
    out = ckpt.restore(tmp_path / "s", like={"state": blank,
                                             "t": np.float64(0)})
    assert isinstance(out["state"], tsw.SWState)
    for name, a, b in zip(FIELDS, state, out["state"]):
        assert _same(a, b), name
    assert out["t"] == np.float64(CFG.dt)


def test_manager_retention_and_latest(tmp_path):
    with ckpt.Manager(tmp_path / "series", max_to_keep=2) as mgr:
        assert mgr.latest_step() is None
        for step in (1, 2, 3):
            mgr.save(step, {"v": torch.tensor(float(step))})
        assert mgr.latest_step() == 3
        out = mgr.restore(3, like={"v": torch.zeros(())})
        assert float(out["v"]) == 3.0
        # saving a step again replaces it
        mgr.save(3, {"v": torch.tensor(30.0)})
        assert float(mgr.restore(3, like={"v": torch.zeros(())})["v"]) == 30
    assert ckpt.latest_step(tmp_path / "series") == 3
    assert sorted(os.listdir(tmp_path / "series")) == ["2", "3"]
    with ckpt.Manager(tmp_path / "series", max_to_keep=2) as mgr:
        with pytest.raises(FileNotFoundError, match="step 1"):
            mgr.restore(1, like={"v": torch.zeros(())})
    assert ckpt.latest_step(tmp_path / "nothing") is None


def test_manager_wait_until_finished_commits(tmp_path):
    with ckpt.Manager(tmp_path / "d", max_to_keep=2) as mgr:
        mgr.save(5, {"v": torch.tensor(5.0)})
        mgr.wait_until_finished()
        names = os.listdir(tmp_path / "d")
        assert names == ["5"], names
        assert os.listdir(tmp_path / "d" / "5") == [ckpt.PAYLOAD]


def test_uncommitted_step_is_invisible(tmp_path, monkeypatch):
    d = tmp_path / "d"
    with ckpt.Manager(d) as mgr:
        mgr.save(2, {"v": torch.tensor(2.0)})
        # a crash mid-save leaves its temporary behind, never the step
        real_save = torch.save

        def crash(obj, f):
            real_save(obj, f)
            raise KeyboardInterrupt("killed mid-save")

        monkeypatch.setattr(torch, "save", crash)
        with pytest.raises(KeyboardInterrupt):
            mgr.save(4, {"v": torch.tensor(4.0)})
        monkeypatch.undo()
        assert mgr.latest_step() == 2
        # a temporary left by a killed process, and a step directory
        # without its payload, are not steps either
        (d / ".6.tmp-dead").mkdir()
        (d / ".6.tmp-dead" / ckpt.PAYLOAD).write_bytes(b"partial")
        (d / "7").mkdir()
        assert mgr.latest_step() == 2
        assert mgr.all_steps() == [2]


@pytest.mark.parametrize("grid", [None, (2, 2)], ids=["one_rank", "grid2x2"])
def test_solver_resume_bit_identical(tmp_path, grid):
    def body(comm):
        init = tsw.make_init(CFG, comm, device="cpu")
        first = tsw.make_first_step(CFG, comm)
        multi = tsw.make_multistep(CFG, comm, CHUNK)
        s_mid = multi(first(init()))
        s_full = multi(s_mid)  # 1 + 10 steps, uninterrupted
        path = tmp_path / f"mid{comm.rank()}"
        ckpt.save(path, {"state": s_mid})
        blank = tsw.SWState(*(torch.empty_like(f) for f in s_mid))
        restored = ckpt.restore(path, like={"state": blank})["state"]
        s_resumed = multi(restored)
        return all(_same(a, b) for a, b in zip(s_full, s_resumed))

    assert all(_on_grid(body, grid))


@pytest.mark.parametrize("grid", [None, (2, 2)], ids=["one_rank", "grid2x2"])
def test_make_solver_resume(tmp_path, grid):
    def body(comm):
        ck = tmp_path / "run"
        _, _, steps_a = tsw.make_solver(CFG, comm, CHUNK, checkpoint_dir=ck,
                                        device="cpu")(T_HALF)
        # "crash" and resume: a fresh solver, the same directory, a longer
        # horizon; no warm-up chunk, 2 more timed chunks
        state_b, _, steps_b = tsw.make_solver(
            CFG, comm, CHUNK, checkpoint_dir=ck, device="cpu")(T_FULL)
        state_c, _, _ = tsw.make_solver(CFG, comm, CHUNK,
                                        device="cpu")(T_FULL)
        return (steps_a, steps_b,
                all(_same(b, c) for b, c in zip(state_b, state_c)))

    results = _on_grid(body, grid)
    assert all(r == (2 * CHUNK, 2 * CHUNK, True) for r in results), results
    if grid is None:
        assert ckpt.latest_step(tmp_path / "run") == 4
    else:
        for r in range(4):
            assert ckpt.latest_step(tmp_path / "run" / f"rank{r}") == 4


def test_multirank_solver_resumes_at_the_common_step(tmp_path):
    # rank 3 lost its newest checkpoint: every rank resumes from the step
    # all of them hold, and the run still equals the uninterrupted one
    def run_to(comm, t1):
        return tsw.make_solver(CFG, comm, CHUNK, checkpoint_dir=tmp_path,
                               device="cpu")(t1)

    def first(comm):
        run_to(comm, T_HALF)

    def second(comm):
        state, _, steps = run_to(comm, T_FULL)
        ref, _, _ = tsw.make_solver(CFG, comm, CHUNK, device="cpu")(T_FULL)
        return steps, all(_same(a, b) for a, b in zip(state, ref))

    _on_grid(first, (2, 2))
    with ckpt.Manager(tmp_path / "rank3") as mgr:
        assert mgr.all_steps() == [1, 2]
    shutil.rmtree(tmp_path / "rank3" / "2")
    results = _on_grid(second, (2, 2))
    assert results == [(3 * CHUNK, True)] * 4, results


@pytest.mark.parametrize("grid", [None, (2, 2)], ids=["one_rank", "grid2x2"])
def test_rerun_completed_run_does_not_advance(tmp_path, grid):
    def body(comm):
        ck = tmp_path / "run"
        series = ck if grid is None else ck / f"rank{comm.rank()}"
        state_a, _, steps_a = tsw.make_solver(
            CFG, comm, CHUNK, checkpoint_dir=ck, device="cpu")(T_HALF)
        last = ckpt.latest_step(series)
        before = sorted(os.listdir(series))
        state_b, _, steps_b = tsw.make_solver(
            CFG, comm, CHUNK, checkpoint_dir=ck, device="cpu")(T_HALF)
        return (steps_a, steps_b, last, ckpt.latest_step(series),
                before == sorted(os.listdir(series)),
                all(_same(a, b) for a, b in zip(state_a, state_b)))

    results = _on_grid(body, grid)
    assert all(r == (2 * CHUNK, 0, 2, 2, True, True) for r in results), \
        results


def test_example_checkpoint_flags(tmp_path):
    from mpi4jax_tpu_torch.examples import shallow_water as demo

    ck = tmp_path / "demo"
    args = ["--check", "--device", "cpu", "--days", "0.01", "--multistep",
            "9", "--checkpoint", str(ck), "--checkpoint-every", "2"]
    assert demo.main(args) > 0
    first = sorted(int(n) for n in os.listdir(ck))
    assert first and all(s % 2 == 0 for s in first)
    # the rerun resumes at its horizon: nothing timed, nothing saved
    assert demo.main(args) == 0
    assert sorted(int(n) for n in os.listdir(ck)) == first


# -- against the JAX package ------------------------------------------------


def _jax_comm():
    mesh = jax.make_mesh(
        (1, 1), ("y", "x"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return mj.MeshComm.from_mesh(mesh)


def _assert_rel_close(expected, actual, tol, what):
    expected, actual = np.asarray(expected), np.asarray(actual)
    assert expected.shape == actual.shape, what
    scale = max(float(np.abs(expected).max()), 1e-30)
    assert np.allclose(actual, expected, rtol=tol, atol=tol * scale), (
        what, float(np.abs(expected - actual).max()), scale)


@pytest.fixture(scope="module")
def jax_runs():
    jcfg = jsw.SWConfig(**dataclasses.asdict(CFG))
    half, _, _ = jsw.make_solver(jcfg, _jax_comm(), num_multisteps=CHUNK)(
        T_HALF)
    full, _, _ = jsw.make_solver(jcfg, _jax_comm(), num_multisteps=CHUNK)(
        T_FULL)
    return ([np.asarray(a) for a in half], [np.asarray(a) for a in full])


def test_resumed_run_matches_jax_make_solver(tmp_path, jax_runs):
    # JAX's state at the second chunk, carried across into the port's
    # checkpoint of that chunk, resumed by the port to t_full
    half, full = jax_runs
    cfg = tsw.config_from_jax(dataclasses.asdict(CFG))
    ck = tmp_path / "run"
    with ckpt.Manager(ck) as mgr:
        mgr.save(2, {"state": tsw.state_from_jax(half, cfg, device="cpu"),
                     "t": np.float64(T_HALF)})
    state, _, steps = tsw.make_solver(cfg, MeshComm(), CHUNK,
                                      checkpoint_dir=ck,
                                      device="cpu")(T_FULL)
    assert steps == 2 * CHUNK
    actual = tsw.state_to_numpy(tsw.crop_state(state))
    for i, name in enumerate(FIELDS):
        e, a = full[i], actual[i]
        if name in ("h", "u", "v"):
            e, a = e[2:-2, 2:-2], a[2:-2, 2:-2]
        if name == "dv":
            # from h's wall ghost rows, which the layouts treat apart
            # (tests/test_torch_shallow_water.py)
            e, a = e[:-1], a[:-1]
        _assert_rel_close(e, a, SOLVER_TOL, name)
