"""The port's pipeline schedules (``models/pipeline.py``) against the JAX
package's, on the same inputs.

``tests/parallel/test_pipeline.py``'s setup: S = 8 stages, M = 5
microbatches of MB = 3 rows of D = 4, ``tanh(a @ w + b)`` stages, the
weights drawn with ``jax.random`` and handed over as numpy.  The JAX
side runs under ``shard_map`` on the virtual 8-device mesh, the port on
eight thread ranks of a local world (gloo).  GPipe: the last rank's
outputs equal JAX's and the sequential oracle (rtol 1e-5, atol 1e-6),
zeros on the others, and the gradient through autograd equals
``jax.grad`` of the same pipeline (rtol 2e-5, atol 1e-5).  1F1B at M in
{1, 2, 5} (the JAX test's) and 17 (past the ring stash's 2S - 1
slots): the loss and every gradient equal JAX's ``pipeline_train`` and
the sequential oracle (rtol 1e-4, atol 1e-6), with JAX's placement.

Every rank must make every tick's exchange, in the forward and in the
backward, or a neighbour waits in one it never joins: the exchanges
are counted per rank and phase for M below, at and above S.  1F1B's
reason to exist is its memory: on the JAX test's model at M = 16 its
peak of tensors saved for backward stays under a third of GPipe's.
"""

import collections
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi4jax_tpu as mj
from mpi4jax_tpu.models import pipeline as jpipe

from mpi4jax_tpu_torch.models import pipeline as pipe
from mpi4jax_tpu_torch.models import pp_transformer as ppt
from mpi4jax_tpu_torch.ops import p2p
from mpi4jax_tpu_torch.parallel.comm import MeshComm
from mpi4jax_tpu_torch.parallel.distributed import local_world

torch.set_num_threads(1)

S, M, MB, D = 8, 5, 3, 4
TIMEOUT = 60.0


def _setup(n_micro=M):
    ws = jax.random.normal(jax.random.PRNGKey(0), (S, D, D)) * 0.3
    bs = jax.random.normal(jax.random.PRNGKey(1), (S, D)) * 0.1
    xs = jax.random.normal(jax.random.PRNGKey(2), (n_micro, MB, D))
    return np.asarray(ws), np.asarray(bs), np.asarray(xs)


def _jstage(params, a):
    w, b = params
    return jnp.tanh(a @ w + b)


def _stage(params, a):
    w, b = params
    return torch.tanh(a @ w + b)


def _head(hp, a, t):
    """The loss head of JAX's test, for jax and torch arrays alike."""
    return (((a @ hp) - t) ** 2).mean()


def _sequential(ws, bs, xs):
    out = xs
    for s in range(S):
        out = jnp.tanh(out @ ws[s] + bs[s])
    return out


def _jax_mesh():
    mesh = jax.make_mesh((S,), ("pp",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    return mesh, mj.MeshComm.from_mesh(mesh)


def _jax_pipeline(ws, bs, xs):
    mesh, comm = _jax_mesh()

    def local(w, b, xs):
        outputs, _ = jpipe.pipeline_apply(_jstage, (w[0], b[0]), xs, comm)
        return outputs[None]

    return jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(jax.P("pp"), jax.P("pp"), jax.P()),
        out_specs=jax.P("pp")))(ws, bs, xs)


def _on_pp(fn, n=S):
    return local_world(n, fn, axes=(("pp",), (n,)), timeout=TIMEOUT)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.fixture(scope="module")
def gpipe_runs():
    """The JAX pipeline's outputs and ``jax.grad`` of its last rank's
    ``sum(out²)``; the port's per rank: its outputs and the gradients
    of the same loss for its stage and the microbatches."""
    ws, bs, xs = _setup()
    jout = np.asarray(_jax_pipeline(ws, bs, xs))
    jgrads = jax.grad(lambda w, b: (_jax_pipeline(w, b, xs)[-1] ** 2).sum(),
                      argnums=(0, 1))(ws, bs)
    sgrads = jax.grad(lambda w, b: (_sequential(w, b, xs) ** 2).sum(),
                      argnums=(0, 1))(ws, bs)

    def body(comm):
        r = comm.rank()
        w, b, x = (_t(a).requires_grad_(True) for a in (ws[r], bs[r], xs))
        out, _ = pipe.pipeline_apply(_stage, (w, b), x, comm)
        grads = torch.autograd.grad((out ** 2).sum(), (w, b, x),
                                    allow_unused=True,
                                    materialize_grads=True)
        return [out.detach().numpy()] + [g.numpy() for g in grads]

    return dict(ws=ws, bs=bs, xs=xs, jout=jout,
                jgrads=[np.asarray(g) for g in jgrads],
                sgrads=[np.asarray(g) for g in sgrads],
                seq=np.asarray(_sequential(ws, bs, xs)),
                port=_on_pp(body))


@pytest.mark.parametrize("against", ["jax", "sequential"])
def test_pipeline_apply_matches(gpipe_runs, against):
    want = (gpipe_runs["jout"][-1] if against == "jax"
            else gpipe_runs["seq"])
    port = gpipe_runs["port"]
    np.testing.assert_allclose(port[-1][0], want, rtol=1e-5, atol=1e-6)
    # the other stages bank nothing
    for r in range(S - 1):
        assert not port[r][0].any(), r
    assert not gpipe_runs["jout"][:-1].any()


@pytest.mark.parametrize("against", ["jax", "sequential"])
def test_gpipe_grad_matches(gpipe_runs, against):
    gw, gb = gpipe_runs["jgrads" if against == "jax" else "sgrads"]
    for r, (_, dw, db, dx) in enumerate(gpipe_runs["port"]):
        np.testing.assert_allclose(dw, gw[r], rtol=2e-5, atol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(db, gb[r], rtol=2e-5, atol=1e-5,
                                   err_msg=f"rank {r}")
        # the microbatches' gradient lives on stage 0 only
        if r:
            assert not dx.any(), r
    xs = gpipe_runs["xs"]
    gx = jax.grad(lambda x: (_sequential(gpipe_runs["ws"], gpipe_runs["bs"],
                                         x) ** 2).sum())(xs)
    np.testing.assert_allclose(gpipe_runs["port"][0][3], np.asarray(gx),
                               rtol=2e-5, atol=1e-5)


def _1f1b_inputs(n_micro):
    ws, bs, _ = _setup()
    xs = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                      (n_micro, MB, D)))
    hw = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (D,)) * 0.5)
    tg = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (n_micro, MB)))
    return ws, bs, hw, xs, tg


def _jax_1f1b(ws, bs, hw, xs, tg):
    mesh, comm = _jax_mesh()

    def local(w, b, hw, xs, tg):
        loss, (dw, db), dhw, dxs, _ = jpipe.pipeline_train(
            _jstage, (w[0], b[0]), _head, hw, xs, tg, comm)
        return loss[None], dw[None], db[None], dhw[None], dxs[None]

    f = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(jax.P("pp"), jax.P("pp"), jax.P(), jax.P(), jax.P()),
        out_specs=tuple(jax.P("pp") for _ in range(5))))
    return [np.asarray(a) for a in f(ws, bs, hw, xs, tg)]


def _port_1f1b(ws, bs, hw, xs, tg):
    """Per rank: ``(loss, dw, db, dhw, dxs)`` as numpy."""

    def body(comm):
        r = comm.rank()
        loss, (dw, db), dhw, dxs, _ = pipe.pipeline_train(
            _stage, (_t(ws[r]), _t(bs[r])), _head, _t(hw), _t(xs), _t(tg),
            comm)
        return [t.numpy() for t in (loss, dw, db, dhw, dxs)]

    return _on_pp(body)


@pytest.mark.parametrize("n_micro", [1, 2, 5, 17])
def test_1f1b_matches_jax_and_sequential(n_micro):
    # M below S (1, 2, 5 < 8): most ticks are bubbles that must still run
    # both wires, and the drain's invalid forward slots must leave the
    # stash entries the pending backwards read; M = 17 > 2S - 1 wraps
    # the ring stash
    ws, bs, hw, xs, tg = _1f1b_inputs(n_micro)
    jloss, jdw, jdb, jdhw, jdxs = _jax_1f1b(ws, bs, hw, xs, tg)
    port = _port_1f1b(ws, bs, hw, xs, tg)

    def seq_loss(ws, bs, hw, xs):
        out = _sequential(ws, bs, xs)
        return sum(_head(hw, out[i], tg[i]) for i in range(n_micro))

    ref = [np.asarray(g) for g in jax.grad(seq_loss, argnums=(0, 1, 2, 3))(
        ws, bs, hw, xs)]
    rloss = float(seq_loss(ws, bs, hw, xs))
    tol = dict(rtol=1e-4, atol=1e-6)
    for r, (loss, dw, db, dhw, dxs) in enumerate(port):
        for want_dw, want_db in ((jdw[r], jdb[r]), (ref[0][r], ref[1][r])):
            np.testing.assert_allclose(dw, want_dw, **tol, err_msg=f"{r}")
            np.testing.assert_allclose(db, want_db, **tol, err_msg=f"{r}")
        if r == S - 1:
            for want in (jloss[r], rloss):
                np.testing.assert_allclose(loss, want, rtol=1e-5)
            for want in (jdhw[r], ref[2]):
                np.testing.assert_allclose(dhw, want, **tol)
        else:  # JAX's placement: loss and head gradient on the last stage
            assert loss == 0 and not dhw.any() and not jdhw[r].any(), r
        if r == 0:
            for want in (jdxs[0], ref[3]):
                np.testing.assert_allclose(dxs, want, **tol)
        else:  # the microbatches' gradient on stage 0
            assert not dxs.any() and not jdxs[r].any(), r


_phase = threading.local()


@pytest.fixture
def exchanges(monkeypatch):
    """Per (rank, phase): the exchanges each rank makes, the phase the
    one its thread set in ``_phase``."""
    counts = collections.Counter()
    lock = threading.Lock()
    move = p2p.move

    def counting(comm, *args, **kwargs):
        with lock:
            counts[comm.rank(), getattr(_phase, "name", None)] += 1
        return move(comm, *args, **kwargs)

    monkeypatch.setattr(p2p, "move", counting)
    return counts


@pytest.mark.parametrize("n_micro", [3, 8, 11])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_every_rank_makes_every_exchange(exchanges, schedule, n_micro):
    # GPipe: one handoff a tick forward, its transpose a tick backward;
    # 1F1B: two plain exchanges a tick, none in a backward.  The same on
    # every rank, bubbles and the ignored receives included, for M
    # below, at and above S
    ws, bs, hw, xs, tg = _1f1b_inputs(n_micro)

    def body(comm):
        r = comm.rank()
        w, b = _t(ws[r]).requires_grad_(True), _t(bs[r]).requires_grad_(True)
        _phase.name = "forward"
        if schedule == "1f1b":
            pipe.pipeline_train(_stage, (w, b), _head, _t(hw), _t(xs),
                                _t(tg), comm)
            return
        out, _ = pipe.pipeline_apply(_stage, (w, b), _t(xs), comm)
        _phase.name = "backward"
        torch.autograd.grad((out ** 2).sum(), (w, b))

    _on_pp(body)
    ticks = n_micro + S - 1
    want = ({"forward": ticks, "backward": ticks} if schedule == "gpipe"
            else {"forward": 2 * (n_micro + 2 * (S - 1))})
    for r in range(S):
        got = {phase: n for (rank, phase), n in exchanges.items()
               if rank == r}
        assert got == want, (r, got)


def test_pipeline_refuses_bad_stage_and_comm():
    # a stage that changes the activation's shape or dtype, and a comm
    # of two axes, are refused before any exchange
    def body(comm):
        pp = comm.sub("pp")
        x, w = torch.zeros((2, 3, D)), torch.zeros((D, 5))
        with pytest.raises(ValueError, match="shape/dtype-preserving"):
            pipe.pipeline_apply(lambda p, a: a @ p, w, x, pp)
        with pytest.raises(ValueError, match="shape/dtype-preserving"):
            pipe.pipeline_train(lambda p, a: a.double(), w, _head,
                                torch.zeros(D), x, torch.zeros((2, 3)), pp)
        with pytest.raises(ValueError, match="single-axis"):
            pipe.pipeline_apply(_stage, (w, w), x, comm)
        with pytest.raises(ValueError, match="single-axis"):
            pipe.pipeline_train(_stage, (w, w), _head, w, x, x, comm)
        return True

    assert all(local_world(4, body, axes=(("dp", "pp"), (2, 2)),
                           timeout=TIMEOUT))


# -- 1F1B's activation memory ----------------------------------------------


class SavedBytes:
    """Bytes of the distinct storages autograd holds for backward,
    counted through ``torch.autograd.graph.saved_tensors_hooks``: a
    storage counts once however many saved tensors view it (the
    parameters every microbatch saves, a residual saved by two nodes),
    from the first save until the last saved tensor on it is freed with
    its graph.  ``peak`` is the most held at once.  1F1B's stash of
    ``min(M, 2S-1)`` microbatch inputs is held outside autograd and
    added by the caller."""

    def __init__(self):
        self.live = {}
        self.held = self.peak = 0
        self.lock = threading.Lock()

    def pack(self, t):
        storage = t.untyped_storage()
        key, nbytes = storage.data_ptr(), storage.nbytes()
        with self.lock:
            refs = self.live.get(key, 0)
            if not refs:
                self.held += nbytes
                self.peak = max(self.peak, self.held)
            self.live[key] = refs + 1
        return _Held(self, t, key, nbytes)

    def release(self, key, nbytes):
        with self.lock:
            self.live[key] -= 1
            if not self.live[key]:
                del self.live[key]
                self.held -= nbytes

    @staticmethod
    def unpack(held):
        return held.tensor


class _Held:
    """A saved tensor as autograd holds it; dropped with its graph."""

    def __init__(self, counter, tensor, key, nbytes):
        self.counter, self.tensor = counter, tensor
        self.key, self.nbytes = key, nbytes

    def __del__(self):
        self.counter.release(self.key, self.nbytes)


def test_1f1b_bounds_activation_memory():
    # the JAX test's model and batch on (dp, pp) = (1, 4), M = 16 >> S:
    # GPipe's graph holds all 16 microbatches' residuals at once, 1F1B
    # one microbatch's recompute plus its stash
    cfg = ppt.TransformerConfig(vocab=256, d_model=128, layers=4, heads=8,
                                kv_heads=8, head_dim=16, d_ff=512)
    n_micro, stages = 16, 4
    gen = torch.Generator().manual_seed(1)
    params = ppt.init_params(cfg, generator=gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (64, 128), generator=gen)
    batch = (tokens, torch.roll(tokens, -1, dims=1))
    mb_bytes = 64 // n_micro * 128 * cfg.d_model * 4
    stash = min(n_micro, 2 * stages - 1) * mb_bytes

    def body(comm):
        dp, pp = comm.sub("dp"), comm.sub("pp")
        shard = ppt.shard_params(params, pp)
        peaks = {}
        for schedule in ppt.SCHEDULES:
            step = ppt.make_global_train_step(dp, pp, cfg, n_micro, lr=1e-2,
                                              schedule=schedule,
                                              device="cpu")
            saved = SavedBytes()
            with torch.autograd.graph.saved_tensors_hooks(saved.pack,
                                                          saved.unpack):
                step(shard, batch)
            peaks[schedule] = saved.peak
        return peaks

    for rank, peaks in enumerate(local_world(
            stages, body, axes=(("dp", "pp"), (1, stages)),
            timeout=TIMEOUT)):
        assert (peaks["1f1b"] + stash) * 3 < peaks["gpipe"], (rank, peaks,
                                                              stash)


def test_one_stage_runs_without_exchanges(exchanges):
    # a one-rank pp comm: no wire, the schedules reduce to a loop over
    # the microbatches (the bench's pp mode on one card)
    ws, bs, hw, xs, tg = _1f1b_inputs(4)
    comm = MeshComm(axes=("pp",), axis_sizes=(1,))
    w, b = _t(ws[0]).requires_grad_(True), _t(bs[0])
    out, _ = pipe.pipeline_apply(_stage, (w, b), _t(xs), comm)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.tanh(xs @ ws[0] + bs[0]), rtol=1e-6)
    loss, (dw, _), dhw, dxs, _ = pipe.pipeline_train(
        _stage, (w, b), _head, _t(hw), _t(xs), _t(tg), comm)
    wt = _t(ws[0]).requires_grad_(True)
    ht = _t(hw).requires_grad_(True)
    xt = _t(xs).requires_grad_(True)
    ref = sum(_head(ht, _stage((wt, _t(bs[0])), xt[i]), _t(tg[i]))
              for i in range(4))
    gw, gh, gx = torch.autograd.grad(ref, (wt, ht, xt))
    torch.testing.assert_close(loss, ref.detach(), rtol=1e-6, atol=1e-7)
    for got, want in ((dw, gw), (dhw, gh), (dxs, gx)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    assert not exchanges
