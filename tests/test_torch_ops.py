"""Parity of the PyTorch port's communication core with the JAX package
on a one-rank ("y", "x") grid: tokens, reduction operators, allreduce
(with its gradient rule), scan, allgather and sendrecv.

The same seeded numpy inputs go through the JAX op under ``shard_map``
on a 1x1 mesh and through the port's op on CPU tensors.  Integers must
agree exactly, float32 to 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.ops import reductions as jred

import mpi4jax_tpu_torch as mt
from mpi4jax_tpu_torch.ops import reductions as tred
from mpi4jax_tpu_torch.utils import validation

torch.set_num_threads(1)

OP_NAMES = ["sum", "prod", "min", "max", "land", "lor", "lxor", "band",
            "bor", "bxor"]


def _jax_comm():
    mesh = jax.make_mesh(
        (1, 1), ("y", "x"), axis_types=(jax.sharding.AxisType.Auto,) * 2
    )
    return mj.MeshComm.from_mesh(mesh)


def _run_jax(fn, *arrays):
    """Run ``fn`` under shard_map on the 1x1 mesh; numpy results."""
    comm = _jax_comm()
    spec = jax.P()
    f = jax.jit(
        jax.shard_map(
            lambda *a: fn(comm, *a), mesh=comm.mesh,
            in_specs=(spec,) * len(arrays), out_specs=spec, check_vma=False,
        )
    )
    return jax.tree.map(np.asarray, f(*arrays))


def _inputs(dtype, seed=0, shape=(3, 5)):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype == "int32":
        return rng.integers(-50, 50, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _assert_same(expected, actual):
    expected = np.asarray(expected)
    actual = actual.numpy() if isinstance(actual, torch.Tensor) else actual
    assert actual.shape == expected.shape
    assert actual.dtype == expected.dtype
    if expected.dtype.kind == "f":
        scale = max(float(np.abs(expected).max()), 1e-30)
        np.testing.assert_allclose(actual, expected, rtol=1e-6,
                                   atol=1e-6 * scale)
    else:
        np.testing.assert_array_equal(actual, expected)


def _dtypes_for(name):
    if name in ("land", "lor", "lxor"):
        return ["bool"]
    if name in ("band", "bor", "bxor"):
        return ["int32"]
    return ["int32", "float32"]


OP_CASES = [(n, d) for n in OP_NAMES for d in _dtypes_for(n)]


def test_tokens_pass_through():
    tok = mt.create_token()
    assert isinstance(tok, mt.Token)
    assert mt.as_token(tok) is tok
    assert isinstance(mt.as_token(None), mt.Token)
    with pytest.raises(TypeError):
        mt.as_token(torch.zeros(()))
    x = torch.ones(3)
    y, tok2 = mt.allreduce(x, mt.SUM, comm=mt.MeshComm(), token=tok)
    assert isinstance(tok2, mt.Token)
    # the JAX package returns its own token type from the same call
    _, jtok = mj.allreduce(jnp.ones(3), mj.SUM, comm=mj.SelfComm())
    assert isinstance(jtok, mj.Token)


@pytest.mark.parametrize("name", OP_NAMES)
def test_named_ops_and_identities(name):
    op = tred.named_op(name.upper())
    jop = jred.named_op(name)
    assert op.name == jop.name
    for dt in _dtypes_for(name):
        np_dt = np.dtype(dt)
        np.testing.assert_array_equal(op.identity(np_dt), jop.identity(np_dt))


@pytest.mark.parametrize("name,dtype", OP_CASES)
def test_rank_ordered_fold_matches_jax(name, dtype):
    rows = np.stack([_inputs(dtype, seed=s) for s in range(4)])
    for upto in (None, 0, 2):
        expected = jred.rank_ordered_fold(
            jnp.asarray(rows), jred.named_op(name), upto=upto
        )
        actual = tred.rank_ordered_fold(
            torch.from_numpy(rows), tred.named_op(name), upto=upto
        )
        _assert_same(expected, actual)


def test_user_op_fold_is_rank_ordered():
    # a non-commutative combine: the fold must apply ranks in order
    rows = np.stack([_inputs("float32", seed=s) for s in range(3)])
    jop = jred.Op.create(lambda a, b: 2.0 * a + b, commute=False)
    top = tred.Op.create(lambda a, b: 2.0 * a + b, commute=False)
    _assert_same(
        jred.rank_ordered_fold(jnp.asarray(rows), jop),
        tred.rank_ordered_fold(torch.from_numpy(rows), top),
    )
    with pytest.raises(ValueError, match="shape-preserving"):
        tred.rank_ordered_fold(
            torch.from_numpy(rows), tred.Op.create(lambda a, b: a.sum())
        )


@pytest.mark.parametrize("name,dtype", OP_CASES)
def test_allreduce_matches_jax(name, dtype):
    x = _inputs(dtype)
    expected = _run_jax(
        lambda comm, a: mj.allreduce(a, jred.named_op(name), comm=comm)[0], x
    )
    actual, _ = mt.allreduce(torch.from_numpy(x), name, comm=mt.MeshComm())
    _assert_same(expected, actual)


def test_allreduce_gradient_is_identity():
    x = _inputs("float32")
    w = _inputs("float32", seed=1)
    comm = _jax_comm()

    def loss(a):
        y, _ = mj.allreduce(a, mj.SUM, comm=comm)
        return (y * w).sum()

    g = jax.jit(
        jax.shard_map(jax.grad(loss), mesh=comm.mesh, in_specs=(jax.P(),),
                      out_specs=jax.P(), check_vma=False)
    )(x)
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = mt.allreduce(xt, mt.SUM, comm=mt.MeshComm())
    (y * torch.from_numpy(w)).sum().backward()
    _assert_same(np.asarray(g), xt.grad)

    xt = torch.from_numpy(x).requires_grad_()
    y, _ = mt.allreduce(xt, mt.MAX, comm=mt.MeshComm())
    with pytest.raises(NotImplementedError, match="op=SUM"):
        y.sum().backward()


@pytest.mark.parametrize("name,dtype", [("sum", "float32"), ("max", "int32"),
                                        ("lor", "bool")])
def test_scan_matches_jax(name, dtype):
    x = _inputs(dtype)
    expected = _run_jax(
        lambda comm, a: mj.scan(a, jred.named_op(name), comm=comm.sub("y"))[0],
        x,
    )
    actual, _ = mt.scan(torch.from_numpy(x), name,
                        comm=mt.MeshComm().sub("y"))
    _assert_same(expected, actual)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_allgather_matches_jax(dtype):
    x = _inputs(dtype)
    expected = _run_jax(lambda comm, a: mj.allgather(a, comm=comm)[0], x)
    actual, _ = mt.allgather(torch.from_numpy(x), comm=mt.MeshComm())
    _assert_same(expected, actual)


@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("periodic", [True, False])
def test_sendrecv_shift_matches_jax(axis, periodic):
    # periodic: the self-pair [(0, 0)]; non-periodic: no pairs, so the
    # recv buffer comes back unchanged (MPI_PROC_NULL)
    send = _inputs("float32", seed=2)
    recv = _inputs("float32", seed=3)

    def jfn(comm, s, r):
        sub = comm.sub(axis)
        pairs = sub.shift_perm(axis, 1, periodic=periodic)
        return mj.sendrecv(s, r, source=pairs, dest=pairs, comm=sub)[0]

    expected = _run_jax(jfn, send, recv)
    sub = mt.MeshComm().sub(axis)
    pairs = sub.shift_perm(axis, 1, periodic=periodic)
    assert pairs == _jax_comm().sub(axis).shift_perm(axis, 1, periodic=periodic)
    status = mt.Status()
    actual, _ = mt.sendrecv(torch.from_numpy(send), torch.from_numpy(recv),
                            source=pairs, dest=pairs, comm=sub, status=status)
    _assert_same(expected, actual)
    assert status.Get_source() == (0 if periodic else mt.ANY_SOURCE)


def test_sendrecv_patterns_and_errors():
    comm = mt.MeshComm()
    s, r = torch.arange(4.0), torch.zeros(4)
    out, _ = mt.sendrecv(s, r, source=lambda q: q, dest=lambda q: q, comm=comm)
    assert torch.equal(out, s)
    out, _ = mt.sendrecv(s, r, source=0, dest=0, comm=comm)
    assert torch.equal(out, s) and out.data_ptr() != s.data_ptr()
    out, _ = mt.sendrecv(s, r, source=mt.ANY_SOURCE, dest=[(0, 0)], comm=comm)
    assert torch.equal(out, s)
    with pytest.raises(ValueError, match="out of range"):
        mt.sendrecv(s, r, source=1, dest=1, comm=comm)
    with pytest.raises(ValueError, match="disagree"):
        mt.sendrecv(s, r, source=[], dest=[(0, 0)], comm=comm)
    with pytest.raises(ValueError, match="uniform"):
        mt.sendrecv(s, torch.zeros(5), source=0, dest=0, comm=comm)
    with pytest.raises(TypeError, match="Python integer"):
        mt.sendrecv(s, r, source=0, dest=0, sendtag=torch.tensor(1),
                    comm=comm)
    # SelfComm: like the JAX package's self backend, a copy of sendbuf
    out, _ = mt.sendrecv(s, torch.zeros(2), source=0, dest=0,
                         comm=mt.SelfComm())
    assert torch.equal(out, s)


def test_comm_surface_matches_jax():
    jcomm = _jax_comm()
    comm = mt.MeshComm()
    assert comm.size == jcomm.size == 1
    assert comm.axes == jcomm.axes and comm.axis_sizes == jcomm.axis_sizes
    np.testing.assert_array_equal(comm.rank_grid(), jcomm.rank_grid())
    for axis in ("y", "x"):
        sub, jsub = comm.sub(axis), jcomm.sub(axis)
        assert (sub.axes, sub.axis_sizes) == (jsub.axes, jsub.axis_sizes)
        for disp in (1, -1):
            for per in (True, False):
                assert comm.shift_perm(axis, disp, per) == jcomm.shift_perm(
                    axis, disp, per
                )
    assert comm.clone() != comm and comm.clone().sub("x").context != 0
    assert mt.get_default_comm() == mt.SelfComm()
    with mt.default_comm(comm):
        assert mt.get_default_comm() is comm
    # a grid of several ranks lives in a world of ranks
    # (tests/test_torch_multirank_*.py run them)
    with pytest.raises(ValueError, match="needs a world of ranks"):
        mt.MeshComm(axis_sizes=(2, 4))
    with pytest.raises(ValueError, match="not in"):
        comm.sub("z")


def test_validation_checks():
    assert validation.check_static_int(np.int64(3), "tag") == 3
    with pytest.raises(TypeError, match="bool"):
        validation.check_static_int(True, "root")
    with pytest.raises(TypeError, match="communicator"):
        validation.check_comm("world")
    with pytest.raises(ValueError, match="unknown reduction op"):
        validation.check_op("mean")
    assert validation.check_op("Sum") is mt.SUM
    fields = {"a": torch.zeros(4, 4), "b": torch.zeros(4, 4)}
    assert validation.check_kernel_fields("k", fields, device_type="cpu") is (
        fields["a"]
    )
    bad = [
        ({"a": torch.zeros(4, 4), "b": torch.zeros(4, 4, dtype=torch.float64)},
         TypeError),
        ({"a": torch.zeros(4, 4), "b": torch.zeros(4, 5)}, ValueError),
        ({"a": torch.zeros(4, 4), "b": torch.zeros(4, 8)[:, ::2]}, ValueError),
    ]
    for fields, exc in bad:
        with pytest.raises(exc):
            validation.check_kernel_fields("k", fields, device_type="cpu")
    with pytest.raises(ValueError, match="cuda"):
        validation.check_kernel_fields("k", {"a": torch.zeros(4, 4)},
                                       device_type="cuda")


def test_runtime_helpers_match_jax():
    from mpi4jax_tpu.utils import runtime as jrt

    from mpi4jax_tpu_torch.utils import runtime as trt

    for n in range(1, 17):
        assert trt.best_mesh_shape(n) == jrt.best_mesh_shape(n)
    x = np.arange(6, dtype=np.float32).reshape(2, 3) + 7
    assert trt.drain(torch.from_numpy(x)) == jrt.drain(jnp.asarray(x)) == 7
    assert trt.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        trt.resolve_device("meta")


# -- the public surface -------------------------------------------------------

# names of the JAX package's surface the port has not ported yet, by the
# ROADMAP.md Queue 1 item that ports them
NOT_PORTED = {}


def test_public_names_match_jax():
    missing = set(mj.__all__) - set(mt.__all__)
    assert missing == set().union(*NOT_PORTED.values())
    for name in mt.__all__:
        assert getattr(mt, name) is not None, name
    # the port's top level also carries the halo exchange and the
    # attention schemes, which the JAX package keeps in its submodules
    from mpi4jax_tpu.parallel import halo as jhalo

    for name in set(mt.__all__) - set(mj.__all__):
        assert hasattr(mj.parallel, name) or hasattr(jhalo, name), name


def test_capability_probes_and_version():
    # this torch has no CUDA; no torch drives a TPU
    assert mt.has_cuda_support() is False
    assert mt.has_tpu_support() is False
    # the same lookup on the same checkout: the JAX package's version
    assert mt.__version__ == mj.__version__
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        mt.nope  # noqa: B018


def test_token_array_matches_jax():
    want = np.asarray(mj.token_array(mj.create_token()))
    got = mt.token_array(mt.create_token())
    assert got.dtype == torch.float32 and got.shape == want.shape == ()
    assert got.item() == want.item()
    assert mt.token_array(None).item() == 0.0
    with pytest.raises(TypeError, match="token"):
        mt.token_array("token")


def test_expand_perm_matches_jax(comm1d):
    from mpi4jax_tpu_torch.parallel.distributed import local_world

    pairs = [(0, 1), (1, 2), (3, 0)]
    splits = {"none": lambda c: c,
              "halves": lambda c: c.split(lambda r: r // 4),
              "parity_reversed": lambda c: c.split(lambda r: r % 2,
                                                   key=lambda r: -r)}
    got = local_world(8, lambda c: {k: f(c).expand_perm(pairs)
                                    for k, f in splits.items()},
                      axes=(("i",), (8,)), timeout=20.0)
    for k, f in splits.items():
        want = f(comm1d).expand_perm(pairs)
        assert all(g[k] == want for g in got), k
