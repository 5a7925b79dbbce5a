"""The port's flagship bench (``python -m mpi4jax_tpu_torch.bench``) on
the CPU, at a tiny size:

* the estimator: from given (wall, calls) draws, the fastest and the
  median per-call time among the credible draws, and all draws when
  none is credible;
* the record: its keys, and exactly one JSON line on stdout, from a
  ``--device cpu`` run at a tiny ``SWConfig`` with short batches (every
  ghost width, and ``--quick``), the decode legs on a tiny model (their
  three tokens/s keys; the bandwidth bound's two keys need the card's
  copy rate and are absent on the CPU; ``--quick`` names the legs
  skipped), and the allreduce legs at a tiny payload (one rank's call
  site floor, the 8-rank local world's bus bandwidth);
* ``make_multistep(donate=False)`` leaves the states that earlier calls
  returned intact, and ``donate=True`` chains;
* without ``--device cpu`` and without CUDA the bench raises.

No process is spawned and no port opened: the bench calls nvidia-smi
only for a CUDA device.
"""

import json

import pytest
import torch

from mpi4jax_tpu_torch import bench
from mpi4jax_tpu_torch.models import shallow_water as tsw
from mpi4jax_tpu_torch.parallel.comm import MeshComm

torch.set_num_threads(1)

TINY = tsw.SWConfig(ny=8, nx=16, ghost=2)


@pytest.mark.parametrize("draws,expected", [
    # two credible draws (>= 1.2 s): the faster per call, their median
    ([(2.0, 100), (1.5, 100), (1.0, 100)], (0.015, 0.0175, 2)),
    # the fast 1.0 s draw is not credible, however fast per call
    ([(1.0, 200), (2.4, 100), (1.3, 50), (2.2, 100)], (0.022, 0.024, 3)),
    # none credible: all draws count
    ([(0.5, 10), (0.3, 10), (0.4, 10)], (0.03, 0.04, 0)),
], ids=["credible", "fast_but_short", "fallback"])
def test_estimate(draws, expected):
    best, median, n_credible = bench.estimate(draws)
    assert best == pytest.approx(expected[0])
    assert median == pytest.approx(expected[1])
    assert n_credible == expected[2]


@pytest.fixture
def tiny_bench(monkeypatch):
    monkeypatch.setattr(bench, "CONFIG", TINY)
    monkeypatch.setattr(bench, "TARGET_S", 0.02)
    monkeypatch.setattr(bench, "QUICK_TARGET_S", 0.01)
    monkeypatch.setattr(bench, "CREDIBLE_S", 0.012)
    monkeypatch.setattr(bench, "STEPS_PER_CALL", 2)
    monkeypatch.setattr(bench, "MIN_CALLS", 1)
    monkeypatch.setattr(bench, "DECODE_MODEL", dict(
        layers=2, d_model=32, heads=4, kv_heads=2, d_ff=64, vocab=64,
        prompt=4, max_len=24))
    monkeypatch.setattr(bench, "DECODE_BATCHES", 1)
    monkeypatch.setattr(bench, "ALLREDUCE_MB", 0.01)
    monkeypatch.setattr(bench, "VMESH_MB", 0.01)


RECORD_KEYS = {
    "metric", "value", "unit", "vs_baseline",
    "median_cell_updates_per_sec_per_chip", "ghost", "steps_per_call",
    "calls_per_batch", "draws", "credible_draws", "device",
}


ALLREDUCE_KEYS = {"allreduce_callsite_floor_gbps", "allreduce_devices",
                  "allreduce_busbw_cpu8_hostmem_gbps"}


DECODE_KEYS = {
    "decode_tokens_per_sec_bf16", "decode_tokens_per_sec_batch16",
    "decode_tokens_per_sec_batch16_kv_bucket16",
}


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
def test_cpu_run_prints_one_json_record(tiny_bench, capsys, quick):
    rec = bench.main(["--device", "cpu"] + (["--quick"] if quick else []))
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    ghosts = (2,) if quick else (1, 2, 4)
    keys = RECORD_KEYS | {f"autotune_ghost{g}_ms" for g in ghosts}
    if quick:
        keys.add("quick")
    else:
        keys |= DECODE_KEYS | ALLREDUCE_KEYS
    # no copy rate on the CPU (it has no HBM), so no bandwidth bound, and
    # no TPU-derived key
    assert set(rec) == keys
    assert rec["metric"] == "shallow_water_cell_updates_per_sec_per_chip"
    assert rec["unit"] == "cell-updates/s/chip"
    assert rec["device"] == "cpu" and rec["ghost"] in ghosts
    assert rec["value"] > 0 and rec["median_cell_updates_per_sec_per_chip"] > 0
    assert rec["value"] >= rec["median_cell_updates_per_sec_per_chip"]
    assert rec["vs_baseline"] == round(rec["value"] / 4.5e8, 4)
    assert rec["draws"] >= (3 if quick else 10)
    for leg, _ in bench.SKIPPED:
        assert f"[bench] skipped {leg}" in err
    for item in (5, 9, 13):
        assert f"ROADMAP Queue 1 item {item}" in err
    # the training legs' meshes wait for item 15; the multi-rank comms
    # (item 1) and the decode loop (item 14) are ported
    assert "item 15" in err
    assert "item 14" not in err and "item 1 " not in err
    for leg in ("decode", "decode_kv_bucket", "allreduce_sweep",
                "vmesh_busbw"):
        assert (f"[bench] skipped {leg}: quick mode" in err) == quick
    if not quick:
        assert all(rec[key] > 0 for key in DECODE_KEYS | ALLREDUCE_KEYS)
        assert rec["allreduce_devices"] == 1


def test_nominal_hbm():
    assert bench.nominal_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert bench.nominal_hbm_gbps("TPU v5 lite") is None


def test_bench_needs_cuda_unless_cpu_is_asked(monkeypatch, tiny_bench):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run_bench(quick=True)


@pytest.mark.parametrize("ghost", [1, 2, 4])
def test_multistep_donate(ghost):
    # donate=False: every call returns its own tensors, so an earlier
    # result survives a later call; donate=True: state = multi(state)
    # chains to the same trajectory
    comm = MeshComm()
    cfg = tsw.SWConfig(ny=8, nx=16, ghost=ghost)
    state = tsw.make_first_step(cfg, comm)(
        tsw.make_init(cfg, comm, device="cpu")())
    keep = tsw.make_multistep(cfg, comm, 2)
    first = keep(tsw.SWState(*(t.clone() for t in state)))
    snapshot = [t.clone() for t in first]
    second = keep(tsw.SWState(*(t.clone() for t in first)))
    for a, b in zip(first, snapshot):
        assert torch.equal(a, b)
    assert not torch.equal(second.h, first.h)

    chained = tsw.make_multistep(cfg, comm, 2, donate=True)
    s = tsw.SWState(*(t.clone() for t in state))
    for _ in range(2):
        s = chained(s)
    for a, b in zip(s, second):
        assert torch.equal(a, b)
