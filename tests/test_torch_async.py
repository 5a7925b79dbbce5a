"""The port's nonblocking requests, bucketed gradient sync, data-parallel
step and step markers in one process, against the JAX package's.

* On a self comm every request completes at submit: each op's result
  equals its blocking op's bit for bit, ``test`` does not consume, a
  second wait raises, and the drained check passes.  ``isend`` and
  ``irecv`` there, and the four submits on a mesh comm of two thread
  ranks, raise ``NotImplementedError`` with the JAX package's message.
* ``BucketedGradSync._buckets`` gives the JAX package's bucket layout
  (the same leaf indices) for mixed dtypes and sizes, and the sync
  returns the JAX package's tree.
* ``make_dp_train_step`` on a self comm against the JAX package's on
  its ``SelfComm``: ``StackParams`` (4 layers of width 64, batch 16)
  and ``MLPParams`` (32 -> 64 -> 8), 3 steps, overlap on and off; the
  port's two arms equal bit for bit, each within 1e-5 relative of JAX's
  (float32 products summed in other orders).
* The step markers' indices, nesting and auto-close against the JAX
  module on the same call sequence, and ``bucket_bytes`` parsing
  against the JAX package's.

The proc tier's requests run in ``tests/test_torch_proc.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import train as jtrain
from mpi4jax_tpu.ops import step as jstep
from mpi4jax_tpu.ops.allreduce import BucketedGradSync as JSync
from mpi4jax_tpu.utils import config as jconfig

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.models import train as ttrain
from mpi4jax_tpu_torch.ops import step as tstep
from mpi4jax_tpu_torch.ops.allreduce import BucketedGradSync, tree_flatten
from mpi4jax_tpu_torch.parallel.distributed import local_world
from mpi4jax_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

RTOL = 1e-5  # float32 products summed in other orders than XLA's
STEPS = 3


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.max(np.abs(want - got)) / max(np.max(np.abs(want)),
                                                  1e-30))


# -- the requests on a self comm ----------------------------------------------


def _data(seed, shape=(5, 7), dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("op", ["sum", "max", "prod", "min"])
def test_self_iallreduce_equals_blocking(op):
    x = torch.from_numpy(_data(1))
    req, tok = mt.iallreduce(x, getattr(mt, op.upper()),
                             comm=mt.SelfComm())
    assert isinstance(req, mt.Request) and isinstance(tok, mt.Token)
    got, _ = mt.wait(req)
    want, _ = mt.allreduce(x, getattr(mt, op.upper()), comm=mt.SelfComm())
    assert torch.equal(got, want) and got.dtype == want.dtype
    # the request carries its own value, not the caller's tensor
    assert got.data_ptr() != x.data_ptr()


def test_self_ireduce_scatter_and_waitall():
    x = torch.from_numpy(_data(2, (1, 33)))
    r1, tok = mt.ireduce_scatter(x, comm=mt.SelfComm())
    r2, tok = mt.iallreduce(x[0], comm=mt.SelfComm(), token=tok)
    vals, tok = mt.waitall(r for r in (r1, r2))
    want, _ = mt.reduce_scatter(x, comm=mt.SelfComm())
    assert torch.equal(vals[0], want) and torch.equal(vals[1], x[0])
    with pytest.raises(ValueError, match=r"shape \(comm.size, \.\.\.\)"):
        mt.ireduce_scatter(torch.zeros(3, 2), comm=mt.SelfComm())


def test_request_discipline_on_a_self_comm():
    x = torch.arange(6.0)
    req, _ = mt.iallreduce(x, comm=mt.SelfComm())
    for _ in range(3):  # test never consumes
        done, _ = mt.test(req)
        assert done.dtype == torch.bool and done.shape == () and bool(done)
    got, _ = mt.wait(req)
    assert torch.equal(got, x)
    with pytest.raises(RuntimeError, match="already-consumed"):
        mt.wait(req)
    with pytest.raises(RuntimeError, match="already-consumed"):
        mt.waitall([req])
    with pytest.raises(TypeError, match="expects a Request"):
        mt.wait(x)
    with pytest.raises(TypeError, match="expects a Request"):
        mt.test(x)
    mt.assert_requests_drained()  # no bridge here: nothing pending


def test_async_ops_have_no_gradient():
    x = torch.arange(4.0, requires_grad=True)
    got, _ = mt.wait(mt.iallreduce(x * 2, comm=mt.SelfComm())[0])
    assert not got.requires_grad and got.grad_fn is None


def _jax_message(fn, *args, **kw):
    with pytest.raises(NotImplementedError) as info:
        fn(*args, **kw)
    return str(info.value)


def test_self_isend_irecv_raise_as_jax():
    x = np.zeros(3, np.float32)
    for name, args in (("isend", (0,)), ("irecv", ())):
        want = _jax_message(getattr(mj, name), jnp.asarray(x), *args,
                            comm=mj.SelfComm())
        with pytest.raises(NotImplementedError) as info:
            getattr(mt, name)(torch.from_numpy(x), *args,
                              comm=mt.SelfComm())
        assert str(info.value) == want


def test_mesh_comm_submits_raise_as_jax():
    x = np.zeros((2, 3), np.float32)
    jcomm = mj.MeshComm.from_mesh(jax.make_mesh(
        (2,), ("i",), axis_types=(jax.sharding.AxisType.Auto,)))
    calls = (("iallreduce", ()), ("ireduce_scatter", ()), ("isend", (1,)),
             ("irecv", ()))
    want = {name: _jax_message(getattr(mj, name), jnp.asarray(x), *args,
                               comm=jcomm) for name, args in calls}

    def body(comm):
        got = {}
        for name, args in calls:
            with pytest.raises(NotImplementedError) as info:
                getattr(mt, name)(torch.from_numpy(x), *args, comm=comm)
            got[name] = str(info.value)
        return got

    for got in local_world(2, body, timeout=30):
        assert got == want


# -- BucketedGradSync ------------------------------------------------------------

LEAF_SPECS = ((np.float32, (3, 5)), (np.float16, (40,)), (np.float32, (64,)),
              (np.int32, (7,)), (np.float32, (2, 2)), (np.float16, (3, 3)),
              (np.float32, (300,)), (np.int32, (1,)), (np.float32, ()))


def _mixed_leaves(seed=0):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.standard_normal(shape) * 4).astype(dt)
            for dt, shape in LEAF_SPECS]


@pytest.mark.parametrize("bucket_bytes", [1, 64, 200, 1 << 10, 1 << 20])
@pytest.mark.parametrize("reverse", [True, False])
def test_bucket_layout_matches_jax(bucket_bytes, reverse):
    leaves = _mixed_leaves()
    jb = JSync(mj.SelfComm(), bucket_bytes=bucket_bytes,
               reverse=reverse)._buckets([jnp.asarray(a) for a in leaves])
    tb = BucketedGradSync(mt.SelfComm(), bucket_bytes=bucket_bytes,
                          reverse=reverse)._buckets(
        [torch.from_numpy(a) for a in leaves])
    assert [b["idx"] for b in tb] == [b["idx"] for b in jb]
    assert [b["bytes"] for b in tb] == [b["bytes"] for b in jb]


def test_tree_order_and_sync_match_jax():
    leaves = _mixed_leaves(1)
    tree = {"b": [leaves[0], (leaves[1], None)], "a": leaves[2],
            "c": jtrain.MLPParams(*leaves[3:7]), "d": leaves[7]}
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = {"b": [torch.from_numpy(leaves[0]),
                   (torch.from_numpy(leaves[1]), None)],
             "a": torch.from_numpy(leaves[2]),
             "c": ttrain.MLPParams(*map(torch.from_numpy, leaves[3:7])),
             "d": torch.from_numpy(leaves[7])}
    flat, unflatten = tree_flatten(ttree)
    for want, got in zip(jax.tree_util.tree_leaves(jtree), flat, strict=True):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    for average in (True, False):
        jsynced, _ = JSync(mj.SelfComm(), bucket_bytes=100,
                           average=average)(jtree)
        tsynced, tok = BucketedGradSync(mt.SelfComm(), bucket_bytes=100,
                                        average=average)(ttree)
        assert isinstance(tok, mt.Token)
        assert list(tsynced) == ["a", "b", "c", "d"]
        assert tsynced["b"][1][1] is None
        assert isinstance(tsynced["c"], ttrain.MLPParams)
        for want, got in zip(jax.tree_util.tree_leaves(jsynced),
                             tree_flatten(tsynced)[0], strict=True):
            assert np.asarray(want).dtype == got.numpy().dtype
            np.testing.assert_array_equal(np.asarray(want), got.numpy())
    rebuilt = unflatten(flat)
    assert torch.equal(rebuilt["c"].w2, ttree["c"].w2)


def test_sync_with_residuals_off_the_proc_tier():
    # no proc comm, no wire dtype: nothing is quantised, no stamp
    grads = [torch.from_numpy(a) for a in _mixed_leaves(2)[:3]]
    jgrads = [jnp.asarray(g.numpy()) for g in grads]
    synced, _, res = BucketedGradSync(mt.SelfComm(), bucket_bytes=64)(
        grads, residuals={})
    jsynced, _, jres = JSync(mj.SelfComm(), bucket_bytes=64)(
        jgrads, residuals={})
    assert res == {} and jres == {}
    for want, got in zip(jsynced, synced):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    empty, _, res = BucketedGradSync(mt.SelfComm())([], residuals={})
    assert empty == [] and res == {}
    empty, _ = BucketedGradSync(mt.SelfComm())({})
    assert empty == {}


def test_mesh_comm_takes_the_blocking_arm():
    def body(comm):
        sync = BucketedGradSync(comm, bucket_bytes=16)
        assert not sync.overlap
        g = torch.full((6,), float(comm.rank() + 1))
        synced, _ = sync([g, g[:2].clone()])
        return [s.tolist() for s in synced]

    for got in local_world(2, body, timeout=30):
        assert got == [[1.5] * 6, [1.5] * 2]


# -- make_dp_train_step ------------------------------------------------------------


def _stack_inputs(seed=0):
    jp = jtrain.init_stack_params(jax.random.PRNGKey(seed), 4, 64)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    t = (rng.standard_normal((16, 64)) * 0.1).astype(np.float32)
    return jp, x, t, 1 << 14


def _mlp_inputs(seed=0):
    jp = jtrain.init_params(jax.random.PRNGKey(seed + 2), 32, 64, 8,
                            tp_size=1)
    jp = jp._replace(b1=jnp.full((64,), 0.05), b2=jnp.full((8,), -0.1))
    rng = np.random.default_rng(seed + 10)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    t = rng.standard_normal((4, 8)).astype(np.float32)
    return jp, x, t, 1 << 12


@pytest.mark.parametrize("kind", ["stack", "mlp"])
def test_dp_step_matches_jax_on_a_self_comm(kind):
    jp, x, t, bucket = (_stack_inputs if kind == "stack" else _mlp_inputs)()
    tp0 = ttrain.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    arms = {}
    for overlap in (True, False):
        jstep_fn = jtrain.make_dp_train_step(mj.SelfComm(), overlap=overlap,
                                             bucket_bytes=bucket)
        tstep_fn = ttrain.make_dp_train_step(mt.SelfComm(), overlap=overlap,
                                             bucket_bytes=bucket)
        pj, pt = jp, tp0
        for _ in range(STEPS):
            pj, lj = jstep_fn(pj, (jnp.asarray(x), jnp.asarray(t)))
            pt, lt = tstep_fn(pt, (torch.from_numpy(x), torch.from_numpy(t)))
        assert type(pt) is (ttrain.StackParams if kind == "stack"
                            else ttrain.MLPParams)
        leaves = tree_flatten(pt)[0]
        for want, got in zip(jax.tree_util.tree_leaves(pj), leaves,
                             strict=True):
            assert _rel(want, got.numpy()) < RTOL
        assert lt.shape == () and abs(float(lt) - float(lj)) <= RTOL * abs(
            float(lj))
        arms[overlap] = leaves + [lt]
    assert all(torch.equal(a, b) for a, b in zip(arms[True], arms[False]))
    # the caller's parameters are left as they were
    for a, b in zip(tree_flatten(tp0)[0], tree_flatten(
            ttrain.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu"))[0]):
        assert torch.equal(a, b)


def test_dp_step_refuses_other_trees():
    step = ttrain.make_dp_train_step(mt.SelfComm())
    with pytest.raises(TypeError, match="StackParams/MLPParams"):
        step({"w": torch.zeros(2)}, (torch.zeros(1), torch.zeros(1)))


def test_init_params_shapes_and_devices():
    g = torch.Generator().manual_seed(0)
    p = ttrain.init_params(8, 32, 4, tp_size=4, generator=g, device="cpu")
    assert [tuple(a.shape) for a in p] == [(8, 32), (32,), (32, 4), (4,)]
    assert not p.b1.any() and not p.b2.any()
    s = ttrain.init_stack_params(3, 16, 8, generator=g, device="cpu")
    assert len(s.layers) == 3 and tuple(s.w_out.shape) == (16, 8)
    with pytest.raises(ValueError, match="divisible by tp_size"):
        ttrain.init_params(8, 30, 4, tp_size=4, generator=g, device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.init_params(8, 32, 4, generator=g)  # the card by default


# -- the step markers -----------------------------------------------------------


def _marker_trace(mod):
    """The same call sequence on a step module; its observable states."""
    mod._reset()
    seen = [mod.current_step()]
    seen.append(mod.annotate_step("a"))
    seen.append(mod.annotate_step())
    seen.append(mod.current_step())
    mod.end_step()
    seen.append(mod.current_step())
    mod.end_step()  # nothing open: a no-op
    with mod.step_scope("outer") as i:
        seen.append((i, mod.current_step()))
        with mod.step_scope("inner") as j:  # closes the outer one
            seen.append((j, mod.current_step()))
        seen.append(mod.current_step())
    seen.append(mod.current_step())
    with mod.step_scope("s") as k:
        seen.append(k)
        seen.append(mod.annotate_step("x"))  # auto-closes the scope's
    seen.append(mod.current_step())
    mod._reset()
    seen.append(mod.annotate_step("after reset"))
    mod._reset()
    return seen


def test_step_markers_match_jax():
    assert _marker_trace(tstep) == _marker_trace(jstep)
    assert mt.annotate_step is tstep.annotate_step
    assert mt.step_scope is tstep.step_scope
    assert mt.current_step is tstep.current_step
    assert mt.end_step is tstep.end_step


# -- the bucket size knob -----------------------------------------------------------


@pytest.mark.parametrize("value", [None, "", "1", "4096", "4K", "2m", " 3M ",
                                   "0", "-1", "abc", "1.5M", "8G", "1g"])
def test_bucket_bytes_parses_as_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("T4J_BUCKET_BYTES", raising=False)
    else:
        monkeypatch.setenv("T4J_BUCKET_BYTES", value)
    try:
        want = jconfig.bucket_bytes()
    except ValueError as e:
        with pytest.raises(ValueError) as info:
            tconfig.bucket_bytes()
        assert str(info.value) == str(e)
        return
    assert tconfig.bucket_bytes() == want
    assert BucketedGradSync(mt.SelfComm()).bucket_bytes == want
