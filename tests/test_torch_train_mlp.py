"""The port's MLP training steps across a (dp, tp) mesh of ranks
(``models/train.py``), against the JAX package's on its 8-device virtual
CPU mesh.

``tests/parallel/test_zero.py``'s setup: dp 2, tp 4, ``d_in`` 8,
``d_hidden`` 32, ``d_out`` 4, global batch 16, the JAX ``init_params``
weights (each rank takes its tp shards, ``params_from_jax(comm_tp=)``)
and one global batch.  Eight thread ranks of a local world (gloo) run
``make_train_step`` (each rank on its dp rows), ``make_global_train_step``
and ``make_global_zero_train_step`` for 3 steps; the tp shards, joined,
equal the JAX steps' parameters within 1e-5 relative (float32 products
summed in other orders), every dp replica holds the same, and each rank's
loss is its row of the JAX step's loss.  The ZeRO step with momentum 0
equals the plain step, with momentum 0.9 it follows JAX's dense
momentum-SGD oracle over 3 steps, its momentum is 1/dp of each
parameter a rank, and it learns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import train as jtrain

from mpi4jax_tpu_torch.models import train as ttrain
from mpi4jax_tpu_torch.parallel.distributed import local_world

torch.set_num_threads(1)

DP, TP = 2, 4
D_IN, D_HID, D_OUT, BATCH = 8, 32, 4, 16
LR, MU = 5e-2, 0.9
STEPS = 3
LEARN_STEPS = 40
RTOL = 1e-5
FIELDS = jtrain.MLPParams._fields


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _setup():
    params = jtrain.init_params(jax.random.PRNGKey(0), D_IN, D_HID, D_OUT,
                                tp_size=TP)
    x = jax.random.normal(jax.random.PRNGKey(1), (BATCH, D_IN))
    t = x @ jax.random.normal(jax.random.PRNGKey(2), (D_IN, D_OUT))
    return params, (x, t)


_cache = {}


def jax_runs():
    """The JAX steps on the (2, 4) virtual mesh: ``{run: (params,
    losses)}``, and the dense oracle's parameters."""
    if "jax" not in _cache:
        mesh = jax.make_mesh((DP, TP), ("dp", "tp"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        comm = mj.MeshComm.from_mesh(mesh)
        dp, tp = comm.sub("dp"), comm.sub("tp")
        params, batch = _setup()
        spec = jtrain.MLPParams(jax.P(None, "tp"), jax.P("tp"),
                                jax.P("tp", None), jax.P(None))
        # the per-rank step inside shard_map, with no automatic sum over
        # dp (check_vma=False): its own allreduces are the sync
        train = jax.jit(jax.shard_map(
            jtrain.make_train_step(dp, tp, lr=LR), mesh=mesh,
            in_specs=(spec, (jax.P("dp", None), jax.P("dp", None))),
            out_specs=(spec, jax.P()), check_vma=False))
        plain = jtrain.make_global_train_step(mesh, dp, tp, lr=LR)
        runs = {}
        for name, fn in (("train", train), ("global", plain)):
            p, losses = params, []
            for _ in range(STEPS):
                p, loss = fn(p, batch)
                losses.append(np.asarray(loss))
            runs[name] = (p, losses)
        for name, mu in (("zero0", 0.0), ("zero9", MU)):
            step, init = jtrain.make_global_zero_train_step(
                mesh, dp, tp, lr=LR, momentum=mu)
            p, state, losses = params, init(params), []
            for _ in range(STEPS):
                p, state, loss = step(p, state, batch)
                losses.append(np.asarray(loss))
            runs[name] = (p, losses)

        # the dense momentum-SGD oracle (tests/parallel/test_zero.py)
        def loss_fn(p):
            x, t = batch
            y = jax.nn.relu(x @ p.w1 + p.b1) @ p.w2 + p.b2
            return jnp.mean((y - t) ** 2)

        ref, v = params, jax.tree.map(jnp.zeros_like, params)
        for _ in range(STEPS):
            g = jax.grad(loss_fn)(ref)
            v = jax.tree.map(lambda vi, gi: MU * vi + gi, v, g)
            ref = jax.tree.map(lambda pi, vi: pi - LR * vi, ref, v)
        _cache["jax"] = (runs, ref)
    return _cache["jax"]


def port_runs():
    """The port's steps on eight thread ranks: ``{rank: {run: (shards,
    losses)}}``, with each rank's ZeRO momentum shapes and its loss at
    the first and the last of ``LEARN_STEPS`` ZeRO steps."""
    if "port" not in _cache:
        params, (x, t) = _setup()
        arrays = jax.tree.map(np.asarray, params)
        xb, tb = np.array(x), np.array(t)

        def body(comm):
            cdp, ctp = comm.sub("dp"), comm.sub("tp")
            p0 = ttrain.params_from_jax(arrays, device="cpu", comm_tp=ctp)
            rows = BATCH // DP
            mine = slice(cdp.rank() * rows, (cdp.rank() + 1) * rows)
            batch = (torch.from_numpy(xb), torch.from_numpy(tb))
            local = (batch[0][mine], batch[1][mine])
            out = {}
            for name, fn, data in (
                    ("train", ttrain.make_train_step(cdp, ctp, lr=LR), local),
                    ("global", ttrain.make_global_train_step(cdp, ctp, lr=LR),
                     batch)):
                p, losses = p0, []
                for _ in range(STEPS):
                    p, loss = fn(p, data)
                    losses.append(loss.numpy())
                out[name] = ([a.numpy() for a in p], losses)
            for name, mu in (("zero0", 0.0), ("zero9", MU)):
                step, init = ttrain.make_global_zero_train_step(
                    cdp, ctp, lr=LR, momentum=mu)
                p, v, losses = p0, init(p0), []
                shapes = [tuple(a.shape) for a in v]
                for _ in range(STEPS):
                    p, v, loss = step(p, v, batch)
                    losses.append(loss.numpy())
                out[name] = ([a.numpy() for a in p], losses)
            out["zero_state"] = shapes
            step, init = ttrain.make_global_zero_train_step(cdp, ctp, lr=LR)
            p, v = p0, init(p0)
            learn = []
            for _ in range(LEARN_STEPS):
                p, v, loss = step(p, v, batch)
                learn.append(float(loss[0]))
            out["learn"] = (learn[0], learn[-1])
            # the caller's shards are left as they were
            out["untouched"] = all(torch.equal(a, b) for a, b in zip(
                p0, ttrain.params_from_jax(arrays, device="cpu",
                                           comm_tp=ctp)))
            return out

        _cache["port"] = dict(enumerate(local_world(
            DP * TP, body, axes=(("dp", "tp"), (DP, TP)), timeout=60)))
    return _cache["port"]


def _joined(run, dp_rank=0):
    """The full parameters from the tp shards of one dp row."""
    shards = [port_runs()[dp_rank * TP + j][run][0] for j in range(TP)]
    return [np.concatenate([s[0] for s in shards], 1),
            np.concatenate([s[1] for s in shards], 0),
            np.concatenate([s[2] for s in shards], 0),
            shards[0][3]]


@pytest.mark.parametrize("run", ["train", "global", "zero0", "zero9"])
def test_step_matches_jax(run):
    jparams, jlosses = jax_runs()[0][run]
    for name, want, got in zip(FIELDS, jparams, _joined(run)):
        assert _rel(want, got) < RTOL, (run, name)
    for r in range(DP * TP):
        # every dp replica holds its tp rank's shards, and every rank b2
        shards = port_runs()[r][run][0]
        for a, b in zip(shards, port_runs()[r % TP][run][0]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(shards[3], port_runs()[0][run][0][3])
        for step, (want, got) in enumerate(zip(jlosses,
                                               port_runs()[r][run][1])):
            want = np.asarray(want).reshape(-1)
            # the global steps: this rank's row; the per-rank step: the
            # dp mean, the same on every rank
            want = want if want.size == 1 else want[r:r + 1]
            assert got.reshape(-1).shape == want.shape
            assert _rel(want, got.reshape(-1)) < RTOL, (run, r, step)
        assert port_runs()[r]["untouched"]


def test_zero_momentum0_equals_the_plain_step():
    for want, got in zip(_joined("global"), _joined("zero0")):
        assert _rel(want, got) < RTOL


def test_zero_momentum_follows_the_dense_oracle():
    _, ref = jax_runs()
    for name, want, got in zip(FIELDS, ref, _joined("zero9")):
        assert _rel(want, got) < RTOL, name


def test_zero_state_is_sharded_and_learns():
    for r in range(DP * TP):
        local = [D_IN * D_HID // TP, D_HID // TP, D_HID * D_OUT // TP, D_OUT]
        assert port_runs()[r]["zero_state"] == [(1, -(-n // DP))
                                                for n in local]
        first, last = port_runs()[r]["learn"]
        assert last < 0.3 * first


def test_shard_params_and_params_from_jax():
    params, _ = _setup()
    arrays = jax.tree.map(np.asarray, params)
    full = ttrain.params_from_jax(arrays, device="cpu")
    assert all(a.dtype == torch.float32 for a in full)

    def body(comm):
        return [a.numpy() for a in ttrain.shard_params(full, comm)]

    shards = local_world(TP, body, timeout=30)
    np.testing.assert_array_equal(
        np.concatenate([s[0] for s in shards], 1), arrays.w1)
    np.testing.assert_array_equal(
        np.concatenate([s[2] for s in shards], 0), arrays.w2)
    assert all(np.array_equal(s[3], arrays.b2) for s in shards)
    stack = jtrain.init_stack_params(jax.random.PRNGKey(3), 2, 16, 4)
    tstack = ttrain.params_from_jax(jax.tree.map(np.asarray, stack),
                                    device="cpu")
    assert isinstance(tstack, ttrain.StackParams) and len(tstack.layers) == 2
    np.testing.assert_array_equal(tstack.w_out.numpy(),
                                  np.asarray(stack.w_out))
    # a local world re-raises a rank's ValueError, naming the rank
    with pytest.raises(RuntimeError, match="ValueError: StackParams are "
                       "not split over tp"):
        local_world(2, lambda c: ttrain.params_from_jax(
            jax.tree.map(np.asarray, stack), device="cpu", comm_tp=c),
            timeout=30)
