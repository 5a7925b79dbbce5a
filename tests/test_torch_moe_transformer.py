"""The port's MoE transformer against the JAX package's, and the dense
step's ``donate``.

``tests/parallel/test_moe_transformer.py``'s configuration (vocab 32,
d_model 16, 2 layers, 4 heads over 2 kv heads of 8, 4 experts of d_ff
32; batch 4, sequence 16), weights from the JAX ``init_params`` carried
across with ``params_from_jax``, tokens from ``jax.random`` handed over
as numpy.  The port's step runs on one rank and on eight thread ranks of
a local world (gloo) on the ``(dp, tp, sp)`` mesh ``(2, 2, 2)``, for
both routings; before any value is compared, the expert each rank's
router chose for every slot of every layer must equal the JAX oracle's
routing of the same block, so that a flipped near-tie reads as a flip.
Then the loss is held to the JAX step on the same mesh shape (the
virtual CPU mesh) and to ``jax.grad`` of ``reference_loss`` at rtol
2e-5, the updated parameters (gathered with ``gather_params``) at 3e-4:
the JAX test's tolerances.  A planted fault, a gradient sync that sums
the expert leaves over sp as it sums the dense ones, must fail that
comparison.  Remat equals no remat (rtol 1e-5, atol 1e-6, the JAX
test's) and runs the layer's two alltoalls again in its recompute
(counted).  The auxiliary losses, ``routing_report``, the
divisibility and capacity errors and the bench's moe mode follow their
JAX counterparts.
"""

import collections
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import moe_transformer as jmt
from mpi4jax_tpu.models import transformer as jtfm

from mpi4jax_tpu_torch.examples import transformer_train
from mpi4jax_tpu_torch.models import moe_transformer as pmt
from mpi4jax_tpu_torch.models import transformer as tfm
from mpi4jax_tpu_torch.ops import collectives
from mpi4jax_tpu_torch.parallel.comm import MeshComm, SelfComm
from mpi4jax_tpu_torch.parallel.distributed import local_world

torch.set_num_threads(1)

JCFG = jmt.MoEConfig(vocab=32, d_model=16, layers=2, heads=4, kv_heads=2,
                     head_dim=8, experts=4, d_ff=32)
B, S = 4, 16
MESHES = {"one": (1, 1, 1), "dp2tp2sp2": (2, 2, 2)}
LOSS_RTOL = 2e-5
PARAM_TOL = 3e-4
REMAT_RTOL, REMAT_ATOL = 1e-5, 1e-6
TIMEOUT = 60.0
NAMES = ["embed", "ln1", "wq", "wk", "wv", "wo", "ln2", "wr", "w1e", "w2e",
         "ln_f", "head"]
ROUTINGS = ("expert_choice", "topk")


def _batch(seed=0):
    tokens = jax.random.randint(jax.random.PRNGKey(seed), (B, S), 0,
                                JCFG.vocab)
    return np.array(tokens), np.array(jnp.roll(tokens, -1, axis=1))


def _jax_mesh(shape):
    return jax.make_mesh(shape, ("dp", "tp", "sp"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)


def _jax_comms(mesh):
    world = mj.MeshComm.from_mesh(mesh)
    return world.sub("dp"), world.sub("tp"), world.sub("sp")


def _arrays(jparams):
    return jax.tree.map(np.asarray, jparams)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_routes(jparams, tokens, cfg, dp, sp):
    """The JAX oracle's routing: per layer, each (dp, sp) block's
    ``(E, cap)`` source-token indices (``reference_loss``'s path)."""
    x = jparams.embed[tokens]
    b, s = tokens.shape
    routes = []
    for li in range(cfg.layers):
        bp = jax.tree.map(lambda a: a[li], jparams.blocks)
        x = jtfm._attn_residual(x, bp, cfg)
        h2 = jtfm._rmsnorm(x, bp.ln2, cfg.eps)
        blocks = h2.reshape(dp, b // dp, sp, s // sp, cfg.d_model).transpose(
            0, 2, 1, 3, 4).reshape(dp * sp, -1, cfg.d_model)
        outs, layer = [], []
        for xt in blocks:
            gates, idx, buckets, _ = jmt._route(xt, bp.wr, cfg)
            vals = jmt._expert_ffn(buckets[None], bp.w1e, bp.w2e)[0]
            outs.append(jnp.zeros_like(xt).at[idx.reshape(-1)].add(
                (gates[..., None] * vals).reshape(-1, cfg.d_model)))
            layer.append(idx)
        routes.append(layer)
        m = jnp.stack(outs).reshape(dp, sp, b // dp, s // sp, cfg.d_model)
        x = x + m.transpose(0, 2, 1, 3, 4).reshape(b, s, cfg.d_model)
    return routes


_where = threading.local()


@pytest.fixture
def routes(monkeypatch):
    """The port's routing as the step runs it: per (dp, sp, tp) rank,
    the ``(E, cap)`` indices of each call of ``_route`` in order."""
    seen = collections.defaultdict(list)
    lock = threading.Lock()
    route = pmt._route

    def recording(xt, wr, cfg):
        out = route(xt, wr, cfg)
        with lock:
            seen[getattr(_where, "rank", (0, 0, 0))].append(
                out[1].detach().numpy().copy())
        return out

    monkeypatch.setattr(pmt, "_route", recording)
    return seen


def expert_sum_over_sp_step(comm_dp, comm_tp, comm_sp, cfg, lr, **kw):
    """A planted fault: the MoE step whose gradient sync takes the
    expert leaves for replicated ones and sums them over sp too."""
    specs = pmt.param_specs("tp", "sp")
    blocks = specs.blocks._replace(w1e=tfm.P(None, None, None, None),
                                   w2e=tfm.P(None, None, None, None))
    return tfm.make_global_train_step(
        comm_dp, comm_tp, comm_sp, cfg, lr, mlp=pmt._moe_mlp,
        specs=specs._replace(blocks=blocks), **kw)


def _port_run(jcfg, jparams, batch, shape, steps=1, lr=1e-1,
              make_step=None, **kw):
    """``steps`` steps of the port's MoE step on the ``shape`` mesh:
    every rank's losses and its gathered full parameters as numpy."""
    cfg = pmt.config_from_jax(jcfg._asdict())
    arrays = _arrays(jparams)
    make_step = make_step or pmt.make_global_train_step

    def body(comm):
        dp, tp, sp = comm.sub("dp"), comm.sub("tp"), comm.sub("sp")
        _where.rank = (dp.rank(), sp.rank(), tp.rank())
        params = pmt.params_from_jax(arrays, cfg, device="cpu", comm_tp=tp,
                                     comm_sp=sp)
        step = make_step(dp, tp, sp, cfg, lr=lr, **kw)
        losses = []
        for _ in range(steps):
            params, loss = step(params, batch)
            losses.append(float(loss[0]))
        full = pmt.gather_params(params, tp, sp)
        return losses, tfm._leaves(pmt.params_to_numpy(full))

    kw.setdefault("device", "cpu")
    if shape == (1, 1, 1):
        return [body(MeshComm(axes=("dp", "tp", "sp"), axis_sizes=shape))]
    return local_world(int(np.prod(shape)), body,
                       axes=(("dp", "tp", "sp"), shape), timeout=TIMEOUT)


def _jax_run(jcfg, jparams, batch, shape, lr=1e-1):
    """The JAX step on the ``shape`` mesh and the oracle's SGD step."""
    mesh = _jax_mesh(shape)
    step = jmt.make_global_train_step(mesh, *_jax_comms(mesh), jcfg, lr=lr)
    new, loss = step(jparams, tuple(jnp.asarray(t) for t in batch))
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jmt.reference_loss(p, *batch, jcfg, shape[0], shape[2])
    ))(jparams)
    ref_new = jax.tree.map(lambda p, g: p - lr * g, jparams, ref_grads)
    return dict(loss=float(loss[0]),
                new=[np.asarray(t) for t in jax.tree.leaves(new)],
                ref_loss=float(ref_loss),
                ref_new=[np.asarray(t) for t in jax.tree.leaves(ref_new)],
                ref_grads=ref_grads)


@pytest.fixture(scope="module")
def jax_runs():
    """Per (mesh, routing): the weights, batch, the JAX step's and the
    oracle's results, and the oracle's routes."""
    runs = {}
    for mesh_id, shape in MESHES.items():
        for routing in ROUTINGS:
            jcfg = JCFG._replace(routing=routing)
            jparams = jmt.init_params(jax.random.PRNGKey(1), jcfg)
            batch = _batch()
            runs[mesh_id, routing] = dict(
                jcfg=jcfg, jparams=jparams, batch=batch,
                routes=jax.tree.map(np.asarray, _jax_routes(
                    jparams, batch[0], jcfg, shape[0], shape[2])),
                **_jax_run(jcfg, jparams, batch, shape))
    return runs


def _hold_routes(seen, want, shape):
    dp, tp, sp = shape
    assert len(seen) == dp * tp * sp
    for (d, s, t), calls in seen.items():
        assert len(calls) == JCFG.layers, (d, s, t)
        for li, got in enumerate(calls):
            np.testing.assert_array_equal(
                got, want[li][d * sp + s],
                err_msg=f"rank (dp {d}, sp {s}, tp {t}) layer {li}: the "
                "router chose other tokens than JAX's")


def _hold(got, want_loss, want_new, loss_rtol=LOSS_RTOL, tol=PARAM_TOL):
    for rank, (losses, leaves) in enumerate(got):
        np.testing.assert_allclose(losses[0], want_loss, rtol=loss_rtol,
                                   err_msg=f"rank {rank}")
        for name, a, b in zip(NAMES, leaves, want_new, strict=True):
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("against", ["mesh_step", "oracle"])
@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_moe_step_matches_jax(jax_runs, routes, mesh_id, routing, against):
    run = jax_runs[mesh_id, routing]
    got = _port_run(run["jcfg"], run["jparams"], run["batch"],
                    MESHES[mesh_id])
    _hold_routes(routes, run["routes"], MESHES[mesh_id])
    if against == "mesh_step":
        _hold(got, run["loss"], run["new"])
    else:
        _hold(got, run["ref_loss"], run["ref_new"])


@pytest.mark.parametrize("routing", ROUTINGS)
def test_planted_expert_sum_over_sp_fails_parity(jax_runs, routing):
    # the dense rule on the expert leaves adds the other sp rank's
    # experts' gradients into this rank's: the one-rank tests cannot
    # see it; the (2, 2, 2) parity test must
    run = jax_runs["dp2tp2sp2", routing]
    got = _port_run(run["jcfg"], run["jparams"], run["batch"], (2, 2, 2),
                    make_step=expert_sum_over_sp_step)
    with pytest.raises(AssertionError, match="w1e"):
        _hold(got, run["ref_loss"], run["ref_new"])
    # the loss is untouched (the fault is in the update), the dense
    # leaves too; the expert leaves miss by the size of their update
    start = [np.asarray(t) for t in jax.tree.leaves(run["jparams"])]
    for name, a, b, p0 in zip(NAMES, got[0][1], run["ref_new"], start):
        miss = np.abs(a - b).max() / np.abs(b - p0).max()
        if name in ("w1e", "w2e"):
            assert miss > 0.1, (name, miss)
        else:
            np.testing.assert_allclose(a, b, rtol=PARAM_TOL, atol=PARAM_TOL)


@pytest.mark.parametrize("routing", ROUTINGS)
def test_moe_remat_matches_plain(jax_runs, routing):
    run = jax_runs["dp2tp2sp2", routing]
    args = (run["jcfg"], run["jparams"], run["batch"], (2, 2, 2))
    plain = _port_run(*args)
    remat = _port_run(*args, remat=True)
    for (l1, p1), (l2, p2) in zip(plain, remat, strict=True):
        np.testing.assert_allclose(l1, l2, rtol=REMAT_RTOL)
        for a, b in zip(p1, p2, strict=True):
            np.testing.assert_allclose(a, b, rtol=REMAT_RTOL,
                                       atol=REMAT_ATOL)
    _hold(remat, run["loss"], run["new"])


@pytest.fixture
def sp_alltoalls(monkeypatch):
    """The alltoalls each rank makes over its sp comm."""
    counts = collections.Counter()
    lock = threading.Lock()
    forward = collectives._AlltoallFn.forward

    def counting(x, comm):
        if comm.axes == ("sp",):
            with lock:
                counts[threading.current_thread().name] += 1
        return forward(x, comm)

    monkeypatch.setattr(collectives._AlltoallFn, "forward",
                        staticmethod(counting))
    return counts


@pytest.mark.parametrize("remat, per_layer", [(False, 4), (True, 6)])
def test_remat_runs_the_alltoalls_again(sp_alltoalls, remat, per_layer):
    # per layer and step: the dispatch and the combine, and their two
    # transposes in the backward; remat's recompute runs both again
    jparams = jmt.init_params(jax.random.PRNGKey(1), JCFG)
    _port_run(JCFG, jparams, _batch(), (2, 2, 2), remat=remat)
    assert len(sp_alltoalls) == 8
    assert set(sp_alltoalls.values()) == {per_layer * JCFG.layers}


def test_moe_aux_losses_match_jax():
    jcfg = JCFG._replace(routing="topk", aux_weight=0.02, z_weight=1e-3)
    jparams = jmt.init_params(jax.random.PRNGKey(21), jcfg)
    batch = _batch(22)
    run = _jax_run(jcfg, jparams, batch, (2, 2, 2))
    got = _port_run(jcfg, jparams, batch, (2, 2, 2))
    _hold(got, run["loss"], run["new"])
    _hold(got, run["ref_loss"], run["ref_new"])
    # the aux terms contribute: without them the loss differs
    cfg = pmt.config_from_jax(jcfg._asdict())
    params = pmt.params_from_jax(_arrays(jparams), cfg, device="cpu")
    with_aux = pmt.reference_loss(params, *batch, cfg, 2, 2)
    plain = pmt.reference_loss(
        params, *batch, cfg._replace(aux_weight=0.0, z_weight=0.0), 2, 2)
    np.testing.assert_allclose(float(with_aux), run["ref_loss"],
                               rtol=LOSS_RTOL)
    assert abs(float(with_aux) - float(plain)) > 1e-6


@pytest.mark.parametrize("routing", ROUTINGS)
def test_reference_loss_and_grad_match_jax(jax_runs, routing):
    run = jax_runs["dp2tp2sp2", routing]
    cfg = pmt.config_from_jax(run["jcfg"]._asdict())
    params = pmt.params_from_jax(_arrays(run["jparams"]), cfg, device="cpu")
    leaves = tfm._leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = pmt.reference_loss(params, *run["batch"], cfg, 2, 2)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), run["ref_loss"],
                               rtol=LOSS_RTOL)
    for name, g, want in zip(NAMES, grads,
                             jax.tree.leaves(run["ref_grads"]), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=name)


def test_moe_loss_decreases():
    jparams = jmt.init_params(jax.random.PRNGKey(2), JCFG)
    got = _port_run(JCFG, jparams, _batch(3), (2, 2, 2), steps=8, lr=3e-1)
    losses = got[0][0]
    assert all(r[0] == losses for r in got)  # the same on every rank
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses


def _skewed(seed=31):
    jcfg = JCFG._replace(routing="topk", router_k=2)
    jparams = jmt.init_params(jax.random.PRNGKey(seed), jcfg)
    jparams = jparams._replace(
        blocks=jparams.blocks._replace(wr=jparams.blocks.wr * 8.0))
    return jcfg, jparams


@pytest.mark.parametrize("dp, sp", [(1, 1), (2, 2)])
def test_routing_report_matches_jax(dp, sp):
    jcfg, jparams = _skewed()
    tokens = _batch(32)[0]
    want = jmt.routing_report(jparams, tokens, jcfg, dp, sp)
    cfg = pmt.config_from_jax(jcfg._asdict())
    got = pmt.routing_report(
        pmt.params_from_jax(_arrays(jparams), cfg, device="cpu"), tokens,
        cfg, dp, sp)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["load"].numpy(), np.asarray(want["load"]),
                               rtol=1e-6, atol=1e-7)
    for key in ("balance_loss", "z_loss", "dropped_fraction"):
        assert isinstance(got[key], float)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
    assert got["balance_loss"] > 1.3 and got["dropped_fraction"] > 0.2


def test_routing_report_refuses_expert_choice():
    cfg = pmt.config_from_jax(JCFG._asdict())
    params = pmt.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="balanced by construction"):
        pmt.routing_report(params, _batch()[0], cfg, 2, 2)
    with pytest.raises(ValueError, match="balanced by construction"):
        jmt.routing_report(jmt.init_params(jax.random.PRNGKey(41), JCFG),
                           _batch()[0], JCFG, 2, 2)


def test_experts_divisibility():
    cfg = pmt.config_from_jax(JCFG._replace(experts=3)._asdict())
    mesh = _jax_mesh((2, 2, 2))
    with pytest.raises(ValueError, match="divisible by the expert"):
        jmt.make_global_train_step(mesh, *_jax_comms(mesh),
                                   JCFG._replace(experts=3))

    def body(comm):
        with pytest.raises(ValueError, match="divisible by the expert"):
            pmt.make_global_train_step(comm.sub("dp"), comm.sub("tp"),
                                       comm.sub("sp"), cfg, device="cpu")
        return True

    assert all(local_world(2, body, axes=(("dp", "tp", "sp"), (1, 1, 2)),
                           timeout=TIMEOUT))


def test_token_capacity_check():
    # 64 tokens on one rank do not split over 6 experts (capacity-1
    # expert choice): both steps refuse at the step
    jcfg = JCFG._replace(experts=6)
    mesh = _jax_mesh((1, 1, 1))
    jstep = jmt.make_global_train_step(mesh, *_jax_comms(mesh), jcfg)
    with pytest.raises(ValueError, match="divisible by experts"):
        jstep(jmt.init_params(jax.random.PRNGKey(0), jcfg),
              tuple(map(jnp.asarray, _batch())))
    cfg = pmt.config_from_jax(jcfg._asdict())
    one = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    step = pmt.make_global_train_step(one.sub("dp"), one.sub("tp"),
                                      one.sub("sp"), cfg, device="cpu")
    params = pmt.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="divisible by experts"):
        step(params, _batch())
    with pytest.raises(ValueError, match="cfg.routing must be"):
        pmt._route(torch.zeros(8, JCFG.d_model), params.blocks.wr[0],
                   cfg._replace(routing="sinkhorn"))


@pytest.mark.parametrize("ties", [False, True])
def test_route_local_equals_jax(ties):
    xt = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (8, 4)))
    wr = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (4, 2)))
    logits = xt @ wr
    if ties:
        logits[4:] = logits[:4]  # every probability twice
    jgates, jidx = jmt._route_local(jnp.asarray(logits), 2)
    gates, idx = pmt._route_local(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=1e-6)
    with pytest.raises(ValueError, match="divisible by experts=3"):
        pmt._route_local(torch.from_numpy(logits), 3)


def test_moe_ffn_equals_jax_on_one_rank():
    # the combine through the real dispatch path on one rank (the JAX
    # test's inputs): a token picked by several experts gets the sum of
    # their gate-weighted outputs
    jcfg = jmt.MoEConfig(d_model=4, experts=2, d_ff=8)
    keys = [jax.random.PRNGKey(i) for i in (7, 8, 9, 10)]
    h = jax.random.normal(keys[0], (1, 8, 4))
    wr = jax.random.normal(keys[1], (4, 2))
    w1e = jax.random.normal(keys[2], (2, 4, 8))
    w2e = jax.random.normal(keys[3], (2, 8, 4))
    want, _ = jmt._moe_ffn(h, wr, w1e, w2e, jcfg, mj.SelfComm(), None)
    cfg = pmt.config_from_jax(jcfg._asdict())
    got, token = pmt._moe_ffn(*(torch.from_numpy(np.array(a))
                                for a in (h, wr, w1e, w2e)),
                              cfg, SelfComm(), None)
    assert token is not None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_shard_and_gather_params_round_trip():
    cfg = pmt.config_from_jax(JCFG._asdict())
    full = pmt.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")

    def body(comm):
        tp, sp = comm.sub("tp"), comm.sub("sp")
        shards = pmt.shard_params(full, tp, sp)
        back = pmt.gather_params(shards, tp, sp)
        return tp.rank(), sp.rank(), shards, back

    for t, s, shards, back in local_world(
            8, body, axes=(("dp", "tp", "sp"), (2, 2, 2)), timeout=TIMEOUT):
        assert all(torch.equal(a, b) for a, b in
                   zip(tfm._leaves(back), tfm._leaves(full)))
        # the experts over sp (dimension 1), whole over tp
        assert torch.equal(shards.blocks.w1e, full.blocks.w1e[:, 2 * s:
                                                             2 * s + 2])
        assert torch.equal(shards.blocks.w2e, full.blocks.w2e[:, 2 * s:
                                                             2 * s + 2])
        assert torch.equal(shards.blocks.wr, full.blocks.wr)
        assert torch.equal(shards.blocks.wq, full.blocks.wq[..., 16 * t:
                                                            16 * t + 16])


def test_carried_params_and_config():
    jparams = jmt.init_params(jax.random.PRNGKey(1), JCFG)
    cfg = pmt.config_from_jax(JCFG._asdict())
    assert cfg == pmt.MoEConfig(*JCFG)
    arrays = _arrays(jparams)
    params = pmt.params_from_jax(arrays, cfg, device="cpu")
    for a, b in zip(tfm._leaves(pmt.params_to_numpy(params)),
                    jax.tree.leaves(arrays), strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown MoEConfig fields"):
        pmt.config_from_jax({**JCFG._asdict(), "attn_impl": "flash"})
    with pytest.raises(ValueError, match="blocks.wr has shape"):
        pmt.params_from_jax(arrays, cfg._replace(experts=2), device="cpu")
    with pytest.raises(ValueError, match="both comm_tp and comm_sp"):
        pmt.params_from_jax(arrays, cfg, device="cpu",
                            comm_tp=MeshComm(axes=("tp",), axis_sizes=(1,)))
    # the layout as the JAX package's param_specs gives it
    want = jax.tree.leaves(jmt.param_specs("tp", "sp"),
                           is_leaf=lambda x: isinstance(x, jax.P))
    got = tfm._leaves(pmt.param_specs("tp", "sp"))
    assert [tuple(s) for s in got] == [tuple(s) for s in want]


def test_init_params_shapes():
    cfg = pmt.config_from_jax(JCFG._asdict())
    params = pmt.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             dtype=torch.bfloat16, device="cpu")
    jparams = jmt.init_params(jax.random.PRNGKey(0), JCFG)
    for a, b in zip(tfm._leaves(params), jax.tree.leaves(jparams),
                    strict=True):
        assert tuple(a.shape) == b.shape and a.dtype == torch.bfloat16


# -- the dense step's donate ------------------------------------------------


def _dense():
    jcfg = jtfm.TransformerConfig(vocab=32, d_model=16, layers=2, heads=4,
                                  kv_heads=2, head_dim=8, d_ff=32)
    cfg = tfm.config_from_jax(jcfg._asdict())
    params = tfm.params_from_jax(
        _arrays(jtfm.init_params(jax.random.PRNGKey(1), jcfg)), cfg,
        device="cpu")
    one = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    return cfg, params, (one.sub("dp"), one.sub("tp"), one.sub("sp"))


def test_step_without_donate_leaves_the_params():
    cfg, params, comms = _dense()
    saved = [t.clone() for t in tfm._leaves(params)]
    new, _ = tfm.make_global_train_step(*comms, cfg, device="cpu")(
        params, _batch())
    for name, a, b, c in zip(tfm.TransformerParams._fields[:1] + tuple(
            tfm.BlockParams._fields) + ("ln_f", "head"), tfm._leaves(params),
            saved, tfm._leaves(new)):
        assert torch.equal(a, b), name
        assert not a.requires_grad, name
        assert a.data_ptr() != c.data_ptr(), name
    assert any(not torch.equal(a, c) for a, c in
               zip(saved, tfm._leaves(new)))


def test_donate_gives_the_same_params_in_place():
    cfg, params, comms = _dense()
    batch = _batch()
    kept, l1 = tfm.make_global_train_step(*comms, cfg, device="cpu")(
        params, batch)
    ptrs = [t.data_ptr() for t in tfm._leaves(params)]
    donated, l2 = tfm.make_global_train_step(*comms, cfg, donate=True,
                                             device="cpu")(params, batch)
    assert torch.equal(l1, l2)
    for a, b, p in zip(tfm._leaves(kept), tfm._leaves(donated), ptrs):
        assert torch.equal(a, b)
        assert b.data_ptr() == p  # the caller's tensors, overwritten
    assert torch.equal(tfm._leaves(params)[0], tfm._leaves(donated)[0])


def test_moe_step_leaves_the_params():
    cfg = pmt.config_from_jax(JCFG._asdict())
    params = pmt.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    saved = [t.clone() for t in tfm._leaves(params)]
    one = MeshComm(axes=("dp", "tp", "sp"), axis_sizes=(1, 1, 1))
    new, loss = pmt.make_global_train_step(
        one.sub("dp"), one.sub("tp"), one.sub("sp"), cfg, device="cpu")(
        params, _batch())
    assert type(new) is pmt.MoEParams and torch.isfinite(loss).all()
    assert all(torch.equal(a, b) for a, b in zip(tfm._leaves(params),
                                                 saved))
    assert not torch.equal(new.blocks.w1e, params.blocks.w1e)


def test_specs_naming_another_axis_are_refused():
    cfg, _, comms = _dense()
    specs = tfm.param_specs("tp")
    specs = specs._replace(embed=tfm.P("ep", None))
    with pytest.raises(ValueError, match=r"specs cut a leaf over \['ep'\]"):
        tfm.make_global_train_step(*comms, cfg, specs=specs, device="cpu")


# -- the bench's moe mode ---------------------------------------------------


TINY = dict(batch=2, seq=16, layers=2, d_model=16, heads=4, kv_heads=2,
            d_ff=32, vocab=32, batches=1, device="cpu")


def test_bench_moe_record():
    rec = transformer_train.run(mode="moe", **TINY)
    assert rec["metric"] == "transformer_moe_train_tokens_per_sec"
    assert "remat" not in rec and rec["attn_impl"] == "auto"
    assert rec["value"] > 0 and rec["mesh"] == [1, 1, 1]
    cfg = pmt.MoEConfig(vocab=32, d_model=16, layers=2, heads=4,
                        kv_heads=2, head_dim=4, experts=4, d_ff=32)
    jparams = jmt.init_params(jax.random.PRNGKey(0), jmt.MoEConfig(
        **cfg._asdict()))
    n = sum(x.size for x in jax.tree.leaves(jparams))
    expert = jparams.blocks.w1e.size + jparams.blocks.w2e.size
    assert rec["params_m"] == n / 1e6
    assert rec["params_active_m"] == (n - expert + expert // 4) / 1e6
    tokens = 2 * 16
    np.testing.assert_allclose(
        rec["model_tflops_per_sec"],
        6.0 * rec["params_active_m"] * 1e6 * tokens / rec["step_ms"] * 1e3
        / 1e12, rtol=1e-9)
    dense = transformer_train.run(**TINY)
    assert dense["params_active_m"] == dense["params_m"]
    assert dense["remat"] is False


def test_bench_moe_refusals():
    with pytest.raises(ValueError, match="ce_chunk is dense-mode only"):
        transformer_train.run(mode="moe", ce_chunk=8, **TINY)
    with pytest.raises(ValueError, match="the MoE step's attention is the "
                       "ring"):
        transformer_train.run(mode="moe", sequence="ulysses", **TINY)
    with pytest.raises(ValueError, match="mode must be"):
        transformer_train.run(mode="ep", **TINY)


def test_bench_moe_cli(capsys):
    rec = transformer_train.main([
        "--mode", "moe", "--device", "cpu", "--batch", "2", "--seq", "16",
        "--layers", "2", "--d-model", "16", "--heads", "4", "--kv-heads",
        "2", "--d-ff", "32", "--vocab", "32", "--batches", "1",
        "--attn-impl", "autotune"])
    assert rec["metric"] == "transformer_moe_train_tokens_per_sec"
    assert '"transformer_moe_train_tokens_per_sec"' in capsys.readouterr().out
