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
  skipped), the training legs on tiny presets (their keys but the MFU
  ones, which need the card's peak, and the attention each ran; the
  caller's context around each leg's timed batches), and the allreduce
  legs at a tiny
  payload (one rank's call site floor, the 8-rank local world's bus
  bandwidth);
* ``run_bench`` across a 2x2 local world of gloo thread ranks: every
  rank takes the same decisions and returns the same record, per card,
  with the bus bandwidth over the four ranks, and (not under
  ``--quick``) the decode legs on the ``(2, 2)`` mesh and the training
  legs on ``(1, 2, 2)``, at tiny presets;
* the training example's ``--remat-policy`` and presets, and
  ``autotune_attn_impl`` off the card;
* ``make_multistep(donate=False)`` leaves the states that earlier calls
  returned intact, and ``donate=True`` chains;
* without ``--device cpu`` and without CUDA the bench raises;
* the proc overlap leg's keys from its job's records (the job itself
  runs in ``tests/test_torch_proc.py``), and its absence raising.

No process is spawned and no port opened: the bench calls nvidia-smi
only for a CUDA device.
"""

import contextlib
import json
import re

import pytest
import torch

from mpi4jax_tpu_torch import bench
from mpi4jax_tpu_torch.examples import transformer_train
from mpi4jax_tpu_torch.models import shallow_water as tsw
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.parallel.distributed import local_world

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
    tiny = dict(batch=2, seq=16, layers=2, d_model=32, heads=4, kv_heads=2,
                d_ff=64)
    monkeypatch.setattr(bench, "TRAIN_SIZES", {
        "small": tiny, "large": dict(tiny, remat="names"),
        "long": dict(tiny, seq=32, remat="names", attn_impl="flash")})
    monkeypatch.setattr(bench, "TRAIN_VOCAB", 64)
    monkeypatch.setattr(bench, "TRAIN_BATCHES", dict.fromkeys(
        bench.TRAIN_BATCHES, 1))
    monkeypatch.setattr(bench, "ROOFLINE_SHAPES", ((32, 2), (64, 2)))
    monkeypatch.setattr(bench, "ROOFLINE_REPS", 1)


RECORD_KEYS = {
    "metric", "value", "unit", "vs_baseline",
    "median_cell_updates_per_sec_per_chip", "ghost", "steps_per_call",
    "calls_per_batch", "draws", "credible_draws", "devices", "mesh",
    "device",
}


ALLREDUCE_KEYS = {"allreduce_callsite_floor_gbps", "allreduce_devices",
                  "allreduce_busbw_cpu8_hostmem_gbps"}


DECODE_KEYS = {
    "decode_tokens_per_sec_bf16", "decode_tokens_per_sec_batch16",
    "decode_tokens_per_sec_batch16_kv_bucket16",
}


# the training legs' keys on the CPU: the MFU ones need the card's peak
TRAIN_KEYS = {
    "transformer_train_tokens_per_sec_bf16", "matmul_bf16_tflops",
    "transformer_large_tokens_per_sec_bf16",
    "transformer_large_tflops_per_sec", "achievable_bf16_tflops",
    "transformer_mfu_vs_achievable_pct", "transformer_long_seq",
    "transformer_long_tokens_per_sec_bf16",
    "transformer_long_tflops_per_sec", "transformer_long_tflops_incl_attn",
}
# the attention each training leg ran
ATTN_KEYS = {"transformer_train_attn_impl", "transformer_large_attn_impl",
             "transformer_long_attn_impl"}
# the meshes the transformer legs ran on
MESH_KEYS = {"decode_mesh", "decode_devices", "transformer_mesh",
             "transformer_devices"}


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
        keys |= (DECODE_KEYS | ALLREDUCE_KEYS | TRAIN_KEYS | ATTN_KEYS
                 | MESH_KEYS)
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
    # only the rest of the proc tier (the second world kinds, elastic
    # jobs and so the serving autoscale leg) waits: one rank runs every
    # single-card leg, the training legs with their remat policies
    # included (the transformer's meshes are named only across ranks);
    # the proc legs, serving's SLO leg among them, need the card
    assert set(re.findall(r"item (\d+)", err)) == {"19"}
    assert (f"[bench] skipped {bench.PROC_SKIPPED[0]}: the staged leg "
            "moves CUDA tensors") in err
    assert rec["devices"] == 1 and rec["mesh"] == [1, 1]
    for leg in ("decode", "decode_kv_bucket", "allreduce_sweep",
                "vmesh_busbw", *bench.TRAIN_LEGS):
        assert (f"[bench] skipped {leg}: quick mode" in err) == quick
    if not quick:
        assert all(rec[key] > 0
                   for key in DECODE_KEYS | ALLREDUCE_KEYS | TRAIN_KEYS)
        assert rec["allreduce_devices"] == 1
        assert rec["transformer_long_seq"] == 32
        # the MFU against the yardstick, unclamped
        assert rec["transformer_mfu_vs_achievable_pct"] == pytest.approx(
            100.0 * rec["transformer_large_tflops_per_sec"]
            / rec["matmul_bf16_tflops"])
        assert rec["achievable_bf16_tflops"] == rec["matmul_bf16_tflops"]
        # the presets' remat policy and the autotuned attention (off the
        # card: "auto") reach the runs
        assert "(large, remat names, attention auto)" in err
        assert "(long, remat names, attention flash)" in err
        assert {key: rec[key] for key in ATTN_KEYS} == {
            "transformer_train_attn_impl": "auto",
            "transformer_large_attn_impl": "auto",
            "transformer_long_attn_impl": "flash"}
        assert rec["decode_mesh"] == [1, 1] and rec["decode_devices"] == 1
        assert rec["transformer_mesh"] == [1, 1, 1]
        assert rec["transformer_devices"] == 1


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
def test_run_bench_across_a_local_world(tiny_bench, monkeypatch, capsys,
                                        quick):
    # four gloo thread ranks on a 2x2 grid: each rank times its own
    # block, every decision is taken on the slowest rank's time, so every
    # rank runs the same schedule and calls and returns the same record;
    # the value is per card, and the bus bandwidth is over four ranks
    estimates = []

    def spy(draws, credible_s=bench.CREDIBLE_S):
        out = bench_estimate(draws, credible_s)
        estimates.append(out)
        return out

    bench_estimate = bench.estimate
    monkeypatch.setattr(bench, "estimate", spy)
    records = local_world(
        4, lambda comm: bench.run_bench(quick, device="cpu", comm=comm),
        axes=(("y", "x"), (2, 2)))
    err = capsys.readouterr().err
    assert all(r == records[0] for r in records)
    assert len(estimates) == 4 and len(set(estimates)) == 1
    rec = records[0]
    ghosts = (2,) if quick else (1, 2, 4)
    keys = RECORD_KEYS | {f"autotune_ghost{g}_ms" for g in ghosts} | {
        "allreduce_busbw_gbps", "allreduce_devices"}
    if quick:
        keys.add("quick")
    else:
        # one card's keys but its allreduce call site and the local
        # world's busbw; the transformer legs on the JAX bench's meshes
        keys |= DECODE_KEYS | TRAIN_KEYS | ATTN_KEYS | MESH_KEYS
    assert set(rec) == keys
    assert rec["devices"] == 4 and rec["mesh"] == [2, 2]
    assert rec["allreduce_devices"] == 4 and rec["allreduce_busbw_gbps"] > 0
    best = estimates[0][0]
    assert rec["value"] == round(
        TINY.ny * TINY.nx * bench.STEPS_PER_CALL / best / 4, 1)
    if not quick:
        assert rec["decode_mesh"] == [2, 2] and rec["decode_devices"] == 4
        assert rec["transformer_mesh"] == [1, 2, 2]
        assert rec["transformer_devices"] == 4
        assert all(rec[key] > 0 for key in DECODE_KEYS | TRAIN_KEYS)
        assert rec["transformer_long_seq"] == 32  # per sp rank
        assert "mesh [1, 2, 2]" in err and "mesh [2, 2]" in err
    # rank 0 alone speaks; the local world's busbw is named skipped, and
    # no leg waits for the transformer's meshes
    assert err.count("[bench] schedule ghost=") == 1
    assert err.count(f"[bench] skipped {bench.WORLD_SKIPPED[0]}") == 1
    assert "item 15" not in err
    assert err.count("quick mode") == (len(bench.TRAIN_LEGS) + 2 if quick
                                       else 0)


def test_nominal_hbm():
    assert bench.nominal_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert bench.nominal_hbm_gbps("TPU v5 lite") is None


def test_bench_needs_cuda_unless_cpu_is_asked(monkeypatch, tiny_bench):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run_bench(quick=True)


@pytest.mark.parametrize("argv, want", [
    (["--size", "long"], dict(remat="names", attn_impl="flash", seq=8192)),
    (["--size", "large"], dict(remat="names", attn_impl="auto", batch=16)),
    (["--size", "small"], dict(remat=False, attn_impl="auto", batch=8)),
    (["--size", "long", "--remat-policy", "full"], dict(remat=True)),
    (["--size", "long", "--remat-policy", "dots"], dict(remat="dots")),
    (["--remat-policy", "save:attn_out,mlp_out"],
     dict(remat=("attn_out", "mlp_out"))),
    (["--remat"], dict(remat=True)),
    (["--size", "large", "--attn-impl", "autotune"],
     dict(attn_impl="auto")),  # autotune off the card
    (["--size", "long", "--attn-impl", "xla"], dict(attn_impl="xla")),
], ids=["long", "large", "small", "full", "dots", "save", "remat",
        "autotune", "explicit-attn"])
def test_train_cli_passes_the_presets_policy(monkeypatch, argv, want):
    seen = {}
    monkeypatch.setattr(transformer_train, "run",
                        lambda **kw: seen.update(kw) or {})
    transformer_train.main([*argv, "--device", "cpu"])
    assert {key: seen[key] for key in want} == want


@pytest.mark.parametrize("value, message", [
    ("save:", "save: needs at least one tag"),
    ("some", "--remat-policy must be full, dots, names or "
             "save:TAG[,TAG...], got 'some'"),
])
def test_train_cli_refuses_bad_remat_policies(monkeypatch, capsys, value,
                                              message):
    monkeypatch.setattr(transformer_train, "run", lambda **kw: {})
    with pytest.raises(SystemExit):
        transformer_train.main(["--remat-policy", value, "--device", "cpu"])
    assert message in capsys.readouterr().err


def test_remat_policy_parsing():
    def error(msg):
        raise ValueError(msg)

    parse = transformer_train.remat_policy
    assert parse("full", error) is True
    assert parse("names", error) == "names"
    assert parse("save:qkv,,v_proj", error) == ("qkv", "v_proj")
    with pytest.raises(ValueError, match="at least one tag"):
        parse("save:,", error)
    # a tag is checked by the step, as in the JAX CLI
    assert parse("save:kv", error) == ("kv",)


def test_autotune_attn_impl_off_the_card():
    # on the CPU it times nothing and answers "auto", as the JAX version
    # does off the TPU; a missing card raises as every entry point does
    assert transformer_train.autotune_attn_impl(device="cpu") == "auto"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            transformer_train.autotune_attn_impl()


def test_training_legs_time_inside_the_callers_context(tiny_bench):
    # timed(leg, steps) is entered around each leg's timed batches, once
    # a leg, with the number of steps they run; nothing else is timed
    # inside it (the warm-up and sizing steps run before, the autotune
    # probe before the large leg's)
    entered = []

    @contextlib.contextmanager
    def timed(leg, steps):
        entered.append((leg, steps))
        yield

    bench.training_legs("cpu", timed=timed)
    assert [leg for leg, _ in entered] == [
        "transformer", "transformer_large", "long_context"]
    assert all(steps >= 4 for _, steps in entered)


def test_matmul_roofline_on_cpu():
    # the yardstick's arithmetic: 2·size³·chain operations a call
    tflops = bench.matmul_roofline_tflops("cpu", shapes=((16, 3),), reps=1)
    assert 0 < tflops < 1


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


def test_overlap_leg_keys_from_the_jobs_records(monkeypatch):
    seen = {}

    def job(args, script="proc_busbw.py"):
        seen["args"], seen["script"] = [str(a) for a in args], script
        return [{"metric": k, "value": i + 1.5, "bucket_bytes": 4194304}
                for i, k in enumerate(bench.OVERLAP_KEYS)], 12.25

    monkeypatch.setattr(bench, "_proc_job", job)
    keys = bench.overlap_leg(batches=1, say=lambda msg: None)
    assert seen["script"] == "transformer.py"
    assert seen["args"] == ["--overlap", "pairs", "--layers", "6",
                            "--d-model", "1024", "--batch", "16", "--reps",
                            "3", "--batches", "1"]
    assert keys == {**{k: i + 1.5 for i, k in enumerate(bench.OVERLAP_KEYS)},
                    "proc_overlap_job_s": 12.25}
    assert set(bench.OVERLAP_KEYS) == {
        "train_step_ms_proc8_overlap_on", "train_step_ms_proc8_overlap_off",
        "overlap_speedup_proc8", "train_step_ms_proc8_host_overlap_on",
        "train_step_ms_proc8_host_overlap_off",
        "overlap_speedup_proc8_host"}
    monkeypatch.setattr(bench, "_proc_job",
                        lambda args, script: (job(args, script)[0][:3], 1.0))
    with pytest.raises(RuntimeError, match="overlap job gave no"):
        bench.overlap_leg(batches=1, say=lambda msg: None)


def test_serving_leg_keys_from_the_jobs_records(monkeypatch):
    # the root bench's proc_serving: its argv, its seven keys
    seen = {}

    def job(args, script="proc_busbw.py"):
        seen["args"], seen["script"] = [str(a) for a in args], script
        return [{"metric": k, "value": i + 0.5}
                for i, k in enumerate(bench.SERVING_KEYS)] + [
            {"metric": "serving_slo_held_proc8", "value": 1}], 30.5

    monkeypatch.setattr(bench, "_proc_job", job)
    keys = bench.serving_leg(say=lambda msg: None)
    assert seen["script"] == "serving.py"
    assert seen["args"] == ["--arms", "pairs", "--windows", "2",
                            "--duration", "6", "--rate", "6", "--slo",
                            "6000"]
    assert keys == {**{k: i + 0.5 for i, k in enumerate(bench.SERVING_KEYS)},
                    "proc_serving_job_s": 30.5}
    assert bench.SERVING_KEYS == (
        "serving_p50_ms_proc8", "serving_p99_ms_proc8", "serving_rps_proc8",
        "serving_shed_rate_proc8", "serving_slo_attainment_proc8",
        "serving_p99_ms_proc8_admit_off",
        "serving_slo_attainment_proc8_admit_off")
    monkeypatch.setattr(bench, "_proc_job",
                        lambda args, script: (job(args, script)[0][:5], 1.0))
    with pytest.raises(RuntimeError, match="serving job gave no"):
        bench.serving_leg(say=lambda msg: None)
