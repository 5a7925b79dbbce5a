"""The port's pipeline-parallel transformer (``models/pp_transformer.py``)
against the JAX package's, and the bench's pp mode.

``tests/parallel/test_pp_transformer.py``'s setup: vocab 32, d_model 16,
4 layers, 4 heads over 2 kv heads of 8, d_ff 32; batch 8, sequence 12;
(dp, pp) = (2, 4).  The weights come from the JAX ``init_params`` and
the tokens from ``jax.random``, handed over as numpy.  The port runs on
eight thread ranks of a local world (gloo), each holding its stage
(``shard_params``); the JAX step on the virtual (2, 4) mesh.  For both
schedules one step's loss equals JAX's step and ``jax.grad`` of
``reference_loss`` (rtol 2e-5, atol 2e-5) on every rank, and every
parameter gathered with ``gather_params`` their update (rtol 3e-4,
atol 3e-4); 1 and 4 microbatches give the oracle's loss; the loss falls
over 8 steps.

The replicated leaves (``embed``, ``ln_f``, ``head``) get their
gradient on one stage each, so the step sums them over pp: after a step
every rank holds the same bits of them, the oracle's update (the
one-rank tests cannot see a missing sum).  The caller's parameters are
left as they were.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import pp_transformer as jppt

from mpi4jax_tpu_torch.examples import transformer_train
from mpi4jax_tpu_torch.models import pp_transformer as ppt
from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.parallel.distributed import local_world

torch.set_num_threads(1)

JCFG = jppt.TransformerConfig(vocab=32, d_model=16, layers=4, heads=4,
                              kv_heads=2, head_dim=8, d_ff=32)
B, S = 8, 12
DP, PP = 2, 4
LOSS_TOL = 2e-5
PARAM_TOL = 3e-4
TIMEOUT = 60.0
NAMES = ["embed", "ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2", "ln_f",
         "head"]
REPLICATED = ("embed", "ln_f", "head")


def _batch(seed=0):
    tokens = jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0,
                                JCFG.vocab)
    return np.array(tokens), np.array(jnp.roll(tokens, -1, axis=1))


def _oracle(jparams, batch, lr=1e-1):
    loss, grads = jax.value_and_grad(
        lambda p: jppt.reference_loss(p, *batch, JCFG))(jparams)
    new = jax.tree.map(lambda p, g: p - lr * g, jparams, grads)
    return float(loss), [np.asarray(t) for t in jax.tree.leaves(new)]


def _on_mesh(fn, shape=(DP, PP)):
    return local_world(int(np.prod(shape)), fn, axes=(("dp", "pp"), shape),
                       timeout=TIMEOUT)


def _port_steps(jparams, batch, schedule, n_micro=2, steps=1, lr=1e-1,
                fault=None):
    """``steps`` steps on the (2, 4) mesh; per rank: its losses, its own
    replicated leaves, its full parameters (``gather_params``) as numpy
    leaves, and whether the step left its input stage as it was."""
    cfg = tfm.config_from_jax(JCFG._asdict())
    full = tfm.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               device="cpu")

    def body(comm):
        dp, pp = comm.sub("dp"), comm.sub("pp")
        params = ppt.shard_params(full, pp)
        before = [t.clone() for t in tfm._leaves(params)]
        step = ppt.make_global_train_step(dp, pp, cfg, n_micro, lr=lr,
                                          schedule=schedule, device="cpu")
        first = params
        losses = []
        for _ in range(steps):
            params, loss = step(params, batch)
            losses.append(float(loss[0]))
        kept = all(torch.equal(a, b) for a, b in zip(tfm._leaves(first),
                                                     before))
        own = {name: getattr(params, name).clone() for name in REPLICATED}
        gathered = tfm._leaves(tfm.params_to_numpy(
            ppt.gather_params(params, pp)))
        return losses, own, gathered, kept

    with fault or contextlib.nullcontext():
        return _on_mesh(body)


@pytest.fixture(scope="module")
def runs():
    """Per schedule: the JAX step on the (2, 4) mesh, the oracle, and
    the port's step on every rank, from the same weights and batch."""
    mesh = jax.make_mesh((DP, PP), ("dp", "pp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    world = mj.MeshComm.from_mesh(mesh)
    jparams = jppt.init_params(jax.random.PRNGKey(1), JCFG)
    batch = _batch()
    ref_loss, ref_new = _oracle(jparams, batch)
    out = {}
    for schedule in ("gpipe", "1f1b"):
        step = jppt.make_global_train_step(
            mesh, world.sub("dp"), world.sub("pp"), JCFG, n_micro=2,
            lr=1e-1, schedule=schedule)
        new, loss = step(jparams, tuple(jnp.asarray(t) for t in batch))
        out[schedule] = dict(
            jax_loss=float(np.asarray(loss)[0]),
            jax_new=[np.asarray(t) for t in jax.tree.leaves(new)],
            ref_loss=ref_loss, ref_new=ref_new,
            port=_port_steps(jparams, batch, schedule))
    return out


@pytest.mark.parametrize("against", ["mesh_step", "oracle"])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_train_step_matches_jax(runs, schedule, against):
    run = runs[schedule]
    key = "jax" if against == "mesh_step" else "ref"
    want_loss, want_new = run[f"{key}_loss"], run[f"{key}_new"]
    for rank, (losses, _, leaves, _) in enumerate(run["port"]):
        np.testing.assert_allclose(losses[0], want_loss, rtol=LOSS_TOL,
                                   atol=LOSS_TOL, err_msg=f"rank {rank}")
        for name, got, want in zip(NAMES, leaves, want_new):
            np.testing.assert_allclose(got, want, rtol=PARAM_TOL,
                                       atol=PARAM_TOL,
                                       err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_replicated_leaves_are_the_same_on_every_rank(runs, schedule):
    # embed's gradient is stage 0's, ln_f's and head's the last stage's:
    # summed over pp, every rank takes the same step
    run = runs[schedule]
    lead = run["port"][0][1]
    for rank, (_, own, _, kept) in enumerate(run["port"]):
        assert kept, f"rank {rank}: the step changed its input parameters"
        for name in REPLICATED:
            assert torch.equal(own[name], lead[name]), (rank, name)
            np.testing.assert_allclose(
                own[name].numpy(), run["ref_new"][NAMES.index(name)],
                rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("n_micro", [1, 4])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_microbatch_count_invariance(schedule, n_micro):
    # the bubble pattern must not change the math
    jparams = jppt.init_params(jax.random.PRNGKey(2), JCFG)
    batch = _batch(seed=3)
    ref = float(jppt.reference_loss(jparams, *batch, JCFG))
    for losses, *_ in _port_steps(jparams, batch, schedule, n_micro):
        np.testing.assert_allclose(losses[0], ref, rtol=LOSS_TOL)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_loss_decreases(schedule):
    jparams = jppt.init_params(jax.random.PRNGKey(4), JCFG)
    res = _port_steps(jparams, _batch(seed=5), schedule, steps=8, lr=3e-1)
    losses = res[0][0]
    assert all(r[0] == losses for r in res)  # the same on every rank
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses


def test_pp_step_refusals():
    cfg = tfm.config_from_jax(JCFG._asdict())

    def body(comm):
        dp, pp = comm.sub("dp"), comm.sub("pp")
        with pytest.raises(ValueError, match="divisible by the pipeline"):
            ppt.make_global_train_step(dp, pp, cfg._replace(layers=3), 2,
                                       device="cpu")
        with pytest.raises(ValueError, match="schedule must be"):
            ppt.make_global_train_step(dp, pp, cfg, 2, schedule="zb",
                                       device="cpu")
        step = ppt.make_global_train_step(dp, pp, cfg, 3, device="cpu")
        params = ppt.shard_params(tfm.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
            pp)
        with pytest.raises(ValueError, match="per-dp-group batch 4 must be "
                           "divisible by n_micro=3"):
            step(params, _batch())
        return True

    assert all(_on_mesh(body))


def test_specs_and_shards():
    # the block leaves cut over pp on the layer axis, the rest whole;
    # shard and gather round-trip; the dense model's pieces are reused
    specs = ppt.param_specs("pp")
    assert all(spec[0] == "pp" and set(spec[1:]) == {None}
               for spec in specs.blocks)
    assert specs.embed == (None, None) and specs.head == (None, None)
    assert ppt.TransformerConfig is tfm.TransformerConfig
    assert ppt.reference_loss is tfm.reference_loss
    cfg = tfm.config_from_jax(JCFG._asdict())
    full = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")

    def body(comm):
        pp = comm.sub("pp")
        shard = ppt.shard_params(full, pp)
        back = ppt.gather_params(shard, pp)
        r = pp.rank()
        return (torch.equal(shard.blocks.wq, full.blocks.wq[r:r + 1])
                and shard.embed.data_ptr() != full.embed.data_ptr()
                and all(torch.equal(a, b) for a, b in
                        zip(tfm._leaves(back), tfm._leaves(full))))

    assert all(_on_mesh(body))


# -- the bench's pp mode ----------------------------------------------------


TINY = dict(batch=2, seq=16, layers=2, d_model=16, heads=4, kv_heads=2,
            d_ff=32, vocab=32, batches=1, device="cpu")


def test_bench_pp_record():
    rec = transformer_train.run(mode="pp", **TINY)
    assert rec["metric"] == "transformer_pp_train_tokens_per_sec"
    assert rec["n_micro"] == 2  # min(4, batch)
    assert "remat" not in rec and rec["attn_impl"] == "xla"
    assert rec["mesh"] == [1, 1] and rec["layers"] == 2
    assert rec["params_active_m"] == rec["params_m"]
    assert rec["value"] > 0 and np.isfinite(rec["loss"])
    rec = transformer_train.run(mode="pp", micro=1, **TINY)
    assert rec["n_micro"] == 1


def test_bench_pp_refusals():
    with pytest.raises(ValueError, match=r"--batch 2 must be divisible by "
                       r"the microbatch count 4 \(pass --micro\)"):
        transformer_train.run(mode="pp", micro=4, **TINY)
    with pytest.raises(ValueError, match="ce_chunk is dense-mode only"):
        transformer_train.run(mode="pp", ce_chunk=8, **TINY)
    with pytest.raises(ValueError, match="the pp step's stages attend whole "
                       "sequences"):
        transformer_train.run(mode="pp", sequence="ulysses", **TINY)


def test_bench_pp_cli(capsys):
    rec = transformer_train.main([
        "--mode", "pp", "--micro", "2", "--device", "cpu", "--batch", "2",
        "--seq", "16", "--layers", "2", "--d-model", "16", "--heads", "4",
        "--kv-heads", "2", "--d-ff", "32", "--vocab", "32", "--batches",
        "1", "--attn-impl", "autotune"])
    assert rec["metric"] == "transformer_pp_train_tokens_per_sec"
    assert rec["n_micro"] == 2 and rec["attn_impl"] == "xla"
    assert '"transformer_pp_train_tokens_per_sec"' in capsys.readouterr().out


def test_bench_pp_across_a_local_world(capfd):
    # four ranks: the JAX bench's (1, 4) mesh, 2 layers rounded up to one
    # a stage (4), every rank the same record
    recs = local_world(4, lambda comm: transformer_train.run(
        mode="pp", comm=comm, **TINY), timeout=TIMEOUT)
    assert "[transformer-bench] pp: layers 2 -> 4 (multiple of 4 stages)" \
        in capfd.readouterr().err
    assert all(r == recs[0] for r in recs[1:])
    assert recs[0]["mesh"] == [1, 4] and recs[0]["layers"] == 4
    assert recs[0]["devices"] == 4 and recs[0]["n_micro"] == 2
