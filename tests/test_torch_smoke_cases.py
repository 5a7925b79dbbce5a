"""``chip_smoke.py``'s multi-rank op cases and BASELINE configs 3-4 on
the CPU: the cases it holds on the card to a CPU local world (one card:
a 2x2 local world over gloo; ``--nccl-world 4``: four NCCL processes)
run here in a 2x2 local world, where the device is the CPU itself, and
its holds raise on a shape that differs, naming the rank.  The
multi-rank transformer phase's training check at a tiny width: each
scheme within its limit of the one-rank step, the planted fault far
outside it.  Phase 12 (the MLP's tp and ZeRO steps on a (2, 2) world) at
a tiny width, the CPU world standing in for the card's.  Phase 13's
checks at a tiny width: the MoE step's kernel path, plain path and
``reference_loss`` step agree, and across four thread ranks the sound
step holds to the one-rank step while the planted expert sync over sp
is caught, for both routings.  Phase 14's helpers and its check across
four thread ranks at a tiny width: the exchange counter, the identity
of the replicated leaves across pp ranks, both schedules within the
limit of the one-rank step and the planted sync that skips pp for the
replicated leaves caught.  Phase 15's one-card check at a tiny width:
the engine's responses held to the oracle under the tie rule, the
books, no flash launch, and the planted slot-0 position caught; the tie
rule itself on a flipped near tie and a short response."""

import importlib.util
import pathlib

import pytest
import torch

from mpi4jax_tpu_torch.ops.allreduce import allreduce
from mpi4jax_tpu_torch.parallel import distributed, longseq

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
AXES = (("y", "x"), (2, 2))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_op_cases_run_and_hold(smoke):
    # every case, the rooted ones with rank-dependent shapes, held to
    # themselves (89: the 26 earlier ones, 54 of the other collectives,
    # 8 backward and 1 forward-mode case)
    n = smoke.multirank_ops_phase("cpu")
    assert n == 89
    with torch.autograd.forward_ad.dual_level():
        got = distributed.local_world(
            4, lambda c: smoke.run_op_cases(c, "cpu"), axes=AXES)
    gather = [k for k, (name, dtype, _) in enumerate(got[0])
              if name == "gather root 3" and dtype == "int32"][0]
    assert tuple(got[3][gather][2].shape) == (4, 4, 257)
    assert tuple(got[0][gather][2].shape) == (4, 257)
    # the first case whose shapes differ between ranks 0 and 3
    with pytest.raises(RuntimeError, match=r"rank 0: gather root 0 float32: "
                       r"torch.float32 \(4, 4, 257\), not torch.float32 "
                       r"\(4, 257\)"):
        smoke.hold_op_cases(got[0], got[3], 0)


def test_baseline_configs_round_trip(smoke, monkeypatch):
    # configs 3 and 4 at 64x64 in place of 1024x1024: rank 0 gathers its
    # own array back; the holds are exact
    monkeypatch.setattr(smoke, "BASELINE_SIDE", 64)
    got = distributed.local_world(
        4, lambda c: smoke.baseline_collectives(c, "cpu", False)[0],
        axes=AXES)
    assert tuple(got[0]["config 3 gather"].shape) == (4, 16, 64)
    assert tuple(got[1]["config 3 gather"].shape) == (16, 64)
    assert torch.equal(got[2]["config 3 bcast"], got[0]["config 3 bcast"])
    # row 0 of rank r's exchange is block r of rank 0's array
    for r, g in enumerate(got):
        assert torch.equal(g["config 4 alltoall world"][0],
                           got[0]["config 3 bcast"][16 * r:16 * (r + 1)])
    for r, g in enumerate(got):
        readings = smoke.hold_baseline(g, g, r)
        assert len(readings) == 6 and all(ok for *_, ok in readings)
    with pytest.raises(RuntimeError, match="rank 1: config 3 gather"):
        smoke.hold_baseline(got[1], got[0], 1)


TINY_TFM = dict(vocab=64, d_model=32, layers=2, heads=8, kv_heads=8,
                head_dim=4, d_ff=64)


@pytest.mark.parametrize("name, sequence, layout", [
    ("ring", "ring", "contiguous"), ("ring_zigzag", "ring", "zigzag"),
    ("ulysses", "ulysses", None)])
def test_mesh_schemes_hold_to_one_rank(smoke, monkeypatch, name, sequence,
                                       layout):
    # the training check of the multi-rank transformer phase at a tiny
    # width on the CPU: every scheme (the zigzag ring on the reordered
    # batch) within the limit of the one-rank step; the planted sync
    # that skips sp far outside it
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = smoke.tfm.TransformerConfig(**TINY_TFM)
    params, batch = smoke.train_data(cfg, "cpu", seed=3,
                                     dtype=torch.float32, batch=2, seq=16)
    p0 = [t.detach().clone() for t in smoke.tfm._leaves(params)]
    one = smoke.MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    ref_step = smoke.tfm.make_global_train_step(
        *smoke.mesh_comms(one), cfg, lr=smoke.MESH_CHECK_LR, remat="names",
        device="cpu")
    ref, ref_loss = ref_step(smoke.tfm.shard_params(params, one.sub("tp")),
                             batch)
    loss, full, _ = smoke.mesh_train_run(params, batch, cfg, sequence,
                                         layout, "cpu", smoke.MESH_CHECK_LR)
    read = smoke.mesh_readings(loss, full, ref_loss, ref, p0)
    assert set(read) == {"loss", *smoke.transformer_names()}
    assert max(read.values()) < 1e-5 < smoke.MESH_TRAIN_LIMIT
    if name == "ring":
        loss, full, _ = smoke.mesh_train_run(
            params, batch, cfg, sequence, layout, "cpu",
            smoke.MESH_CHECK_LR, smoke.sync_skipping_sp)
        read = smoke.mesh_readings(loss, full, ref_loss, ref, p0)
        assert max(read.values()) > 100 * smoke.MESH_TRAIN_LIMIT
    # the patches are gone
    assert smoke.tfm.ring_attention is longseq.ring_attention
    assert smoke.tfm.allreduce is allreduce


def test_mlp_mesh_phase_runs_and_holds(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "MLP_SIZES", (8, 16, 4, 8))
    got = smoke.mlp_mesh_phase(torch.device("cpu"), "the CPU")
    assert got["card_vs_cpu"] == 0.0  # the same world twice
    run = smoke.mlp_mesh_world(torch.device("cpu"))
    # each rank: its shards (tp 2 halves w1's columns), its momentum
    # chunks (dp 2 halves each shard), its losses
    assert run[0]["plain_w1"].shape == (8, 8)
    assert run[3]["zero_momentum_w1"].shape == (1, 32)
    assert run[1]["zero_momentum_b2"].shape == (1, 2)
    assert run[2]["plain_loss_0"].shape == (1,)


TINY_MOE = dict(vocab=64, d_model=32, layers=2, heads=8, kv_heads=8,
                head_dim=4, experts=4, d_ff=64)


def test_moe_phase_checks_hold_and_catch_the_fault(smoke, monkeypatch):
    # phase 13 (b) and (c) at a tiny width on the CPU: the plain and the
    # "kernel" path (both plain here) and the oracle within the limit,
    # the sound mesh step within it, the planted sync of the expert
    # leaves over sp far outside it (it raises only if a reading lands
    # on the wrong side), and topk_moe's world equal to itself
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cfg = smoke.moe.MoEConfig(**TINY_MOE)
    monkeypatch.setattr(smoke, "MOE_CFG", cfg)
    monkeypatch.setattr(smoke, "MOE_RUN", dict(batch=2, seq=16))
    monkeypatch.setattr(smoke, "MOE_MESH_CFG", cfg._replace(experts=8))
    monkeypatch.setattr(smoke, "MOE_MESH_SEQ", 16)
    monkeypatch.setattr(smoke, "MOE_A2A", dict(ranks=4, experts=8, k=2,
                                               tokens=32, d_model=8))
    check = smoke.moe_check(torch.device("cpu"))
    assert set(check["launches"].values()) == {0}  # no kernel on the CPU
    for pair in ("kernel_vs_plain", "kernel_vs_reference",
                 "plain_vs_reference"):
        assert check[pair]["routes_equal"]
        assert check[pair]["worst"] < 1e-4 < smoke.MOE_CHECK_LIMIT
    mesh = smoke.moe_mesh_phase(torch.device("cpu"), "the CPU")
    for routing in ("expert_choice", "topk"):
        assert mesh[f"{routing}_mesh"]["worst"] < 1e-4
        fault = mesh[f"{routing}_fault_experts_over_sp"]["readings"]
        assert min(fault["w1e"], fault["w2e"]) > 100 * smoke.MOE_CHECK_LIMIT
        assert fault["loss"] < 1e-4  # the fault is in the update alone
    assert mesh["topk_moe_card_vs_cpu"] == 0.0
    # the routes' recorder is gone
    assert smoke.moe._route.__name__ == "_route"


def test_moe_bench_leg_counts_and_records(smoke, monkeypatch):
    # phase 13 (d) at a tiny width on the CPU: the bench's moe mode runs,
    # its record is the moe one and no kernel launches off the card
    cfg = smoke.moe.MoEConfig(**TINY_MOE)
    monkeypatch.setattr(smoke, "MOE_CFG", cfg)
    monkeypatch.setattr(smoke, "MOE_RUN", dict(batch=2, seq=16))
    got = smoke.moe_bench(torch.device("cpu"), "the CPU")
    for name in ("float32", "bfloat16"):
        rec = got[name]
        assert rec["metric"] == "transformer_moe_train_tokens_per_sec"
        assert rec["dtype"] == ("f32" if name == "float32" else "bf16")
        assert set(rec["launches"].values()) == {0}
        assert rec["params_active_m"] < rec["params_m"]


TINY_PP = dict(vocab=64, d_model=32, layers=4, heads=8, kv_heads=8,
               head_dim=4, d_ff=64, attn_impl="xla")


def test_pp_exchange_counter_and_identity(smoke):
    # phase 14's helpers: the counter sees every exchange of a 4-rank
    # GPipe step (its handoffs and their transposes) and of a 1F1B step
    # (two plain exchanges a tick), the same number on every rank; the
    # identity check names a leaf whose bits differ
    cfg = smoke.tfm.TransformerConfig(**TINY_PP)
    params, batch = smoke.train_data(cfg, "cpu", seed=3,
                                     dtype=torch.float32, batch=4, seq=8)

    def body(comm):
        dp, pp = comm.sub("dp"), comm.sub("pp")
        stage = smoke.ppt.shard_params(params, pp)
        for schedule in ("gpipe", "1f1b"):
            smoke.ppt.make_global_train_step(
                dp, pp, cfg, 4, schedule=schedule, device="cpu")(stage,
                                                                 batch)

    with smoke.exchange_counter() as counts:
        distributed.local_world(4, body, axes=(("dp", "pp"), (1, 4)))
    want = smoke.pp_exchanges("gpipe", 4, 4) + smoke.pp_exchanges("1f1b",
                                                                   4, 4)
    assert want == 2 * 7 + 2 * 10
    assert counts == {(("pp",), r): want for r in range(4)}
    assert smoke.p_p2p.move.__name__ == "move"  # the counter is gone
    assert smoke.pp_exchanges("gpipe", 4, 1) == 0
    a, b = torch.zeros(3), torch.ones(3)
    assert smoke.pp_identity([{"head": a, "ln_f": a}, {"head": a.clone(),
                                                       "ln_f": b}]) == {
        "head": True, "ln_f": False}


def test_pp_mesh_phase_holds_and_catches_the_fault(smoke, monkeypatch):
    # phase 14 (b) at a tiny width on the CPU: both schedules within the
    # limit of the one-rank dense step, every rank's exchanges counted
    # and its replicated leaves the same bits; the planted sync that
    # skips pp for them far outside the limit (stage 0's head and ln_f
    # keep their values), the loss untouched by it
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(smoke, "PP_CFG",
                        smoke.tfm.TransformerConfig(**TINY_PP))
    monkeypatch.setattr(smoke, "PP_RUN", dict(batch=4, seq=8, micro=4))
    got = smoke.pp_mesh_phase(torch.device("cpu"), "the CPU")
    for name, want in (("gpipe", 14), ("1f1b", 20)):
        assert got[name]["worst"] < 1e-5 < smoke.MESH_TRAIN_LIMIT
        assert got[name]["exchanges"] == [want] * 4
        assert all(got[name]["identity"].values())
    fault = got["fault_replicated_not_summed_over_pp"]
    assert min(fault["readings"]["head"], fault["readings"]["ln_f"]) > (
        100 * smoke.MESH_TRAIN_LIMIT)
    assert fault["readings"]["loss"] < 1e-5
    assert not fault["identity"]["head"]
    assert smoke.ppt._sync_grads.__name__ == "_sync_grads"


TINY_SERVE = dict(vocab=64, d_model=32, layers=2, heads=4, kv_heads=2,
                  head_dim=8, d_ff=64)
TINY_SERVE_RUN = dict(max_batch=3, max_len=32, requests=8, prompt=(2, 12),
                      new=(2, 10), seed=5)


def test_serve_one_card_holds_and_catches_the_fault(smoke, monkeypatch):
    # phase 15 (a) and (b) at a tiny width on the CPU: the engine's
    # responses equal the oracle's (one kind of product here, so none
    # departs), the books balance in the drive and the open-loop window,
    # no flash kernel runs, and the planted slot-0 position departs at a
    # gap far above the limit
    monkeypatch.setattr(smoke, "time_ms", lambda fn, **kw: (fn(), 0.25)[1])
    monkeypatch.setattr(smoke, "device_trace", lambda fn: (fn(), ({}, 0.0))[1])
    got = smoke.serve_one_card(
        torch.device("cpu"), "the CPU", run=TINY_SERVE_RUN,
        cfg=smoke.tfm.TransformerConfig(**TINY_SERVE),
        open_loop=dict(slo_ms=500.0, seconds=0.5, rate=200.0, seed=1))
    assert got["equal"] == 8 and got["departed"] == []
    assert set(got["flash_launches"].values()) == {0}
    assert got["generated"] > 8 and got["steps"] > 0
    assert 0 < got["mean_occupancy"] <= 3
    assert got["decode_step_ms"] == 0.25 and got["step_trace"] is None
    assert sorted(got["prefill_ms"]) == [8, 16]
    assert got["open_loop"]["offered"] == (got["open_loop"]["completed"]
                                           + got["open_loop"]["shed"]) > 0
    assert got["fault"]["departed"] > 0
    assert got["fault"]["worst_gap"] >= 10 * smoke.SERVE_TIE_LIMIT
    # the fault is planted for its drive only
    assert smoke.serving_engine._slot_attention.__name__ == \
        "_slot_attention"


def test_hold_responses_tie_rule(smoke):
    # a departure is accepted only below the limit of the oracle's top
    # two logits at the departing position; a response of the wrong
    # length is named
    cfg = smoke.tfm.TransformerConfig(**TINY_SERVE)
    params = smoke.serve_params(cfg, "cpu")
    reqs = smoke.serve_requests(dict(TINY_SERVE_RUN, requests=3), cfg.vocab)
    refs = smoke.serve_oracle(params, cfg, reqs, 32, "cpu")
    r0 = reqs[0]
    j = r0.prompt_len
    prefix = torch.tensor([refs[0][:j]])
    logits = smoke.oracle_logits(params, prefix, cfg)[0]
    top2 = torch.topk(logits, 2)
    gap = float(top2.values[0] - top2.values[1])
    flipped = list(refs[0])
    flipped[j] = int(top2.indices[1])
    finished = [(0, tuple(flipped)), (1, refs[1]), (2, refs[2][:-1])]
    held = smoke.hold_responses(finished, reqs, refs, params, cfg, 32,
                                limit=gap * 2)
    assert held["equal"] == 1
    assert held["departed"] == [(0, j, pytest.approx(gap))]
    assert held["bad"] == [(2, "length or prompt", len(refs[2]) - 1)]
    held = smoke.hold_responses(finished[:1], reqs, refs, params, cfg, 32,
                                limit=gap / 2)
    assert held["bad"] == [(0, j, pytest.approx(gap))]
