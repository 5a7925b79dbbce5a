"""The multi-process (MPMD) backend: the ops over the native DCN bridge.

The port's counterpart of ``mpi4jax_tpu/ops/_proc.py``.  A
:class:`ProcTransport` is a ProcComm's handle on the bridge, with the
interface of the ``torch.distributed`` ``Transport``
(``parallel/distributed.py``: ``native_op``, ``allreduce``,
``allgather``, ``alltoall``, ``reduce_scatter``, ``broadcast``,
``reduce``, ``gather``, ``scatter``, ``barrier``, ``exchange``,
``post``, ``take``) plus ``scan``, so the ops' autograd Functions run
across processes unchanged.

Where the JAX proc backend calls a native collective, this one calls the
same native function (``native_op`` gives every built-in operator its
wire code), so float results are the JAX proc job's bit for bit: the
same ``dcn.cc`` adds in the same order.  User operators travel through
the native allgather (or gather, or alltoall) and fold in rank order, as
``_user_fold`` does there.

Staging (the reference's COPY_TO_HOST mode): a CPU tensor goes to the
bridge as it is.  A CUDA tensor is copied into a pinned host buffer
(PyTorch's caching host allocator keeps them, by size), its stream is
synchronised, the native call runs, and the result is copied back to
the card on the same stream, on any thread (autograd's device thread
included).  ``check_health`` runs before every op, so a faulted bridge
raises at once.
"""

import torch

from mpi4jax_tpu_torch.native import runtime
from mpi4jax_tpu_torch.ops._core import ANY_SOURCE, ANY_TAG

__all__ = ["OP_CODES", "ProcTransport", "transport_of", "proc_topology"]

# the bridge's operator codes (mpi4jax_tpu/ops/_proc.py:30)
OP_CODES = {
    "sum": 0,
    "prod": 1,
    "min": 2,
    "max": 3,
    "land": 4,
    "lor": 5,
    "lxor": 6,
    "band": 7,
    "bor": 8,
    "bxor": 9,
}

_transports = {}  # (ranks, context) -> ProcTransport


class _Staging:
    """One op's host side: inputs staged in, output buffers to receive
    into, results copied back.  ``device`` is the op's (a CUDA device or
    the CPU, where nothing is copied).  Host buffers are pinned, from
    PyTorch's caching host allocator: it reuses a block by size, and not
    before the asynchronous copies recorded on it have finished."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.pending = False

    def inp(self, x):
        x = x.detach()
        if not self.cuda:
            return x.contiguous()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        self.pending = True
        return host

    def out(self, shape, dtype):
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=self.cuda)

    def ready(self):
        """Wait for the copies to host memory (before the native call)."""
        if self.pending:
            torch.cuda.current_stream(self.device).synchronize()
            self.pending = False

    def back(self, host):
        """``host`` (a result) on the op's device."""
        if not self.cuda:
            return host
        return host.to(self.device, non_blocking=True)


class ProcTransport:
    """One process's handle on a ProcComm's native communicator.

    ``rank`` and ``size`` are the comm's; ``last_status`` holds the
    ``(source, tag)`` the wire gave the last receive of an exchange
    (``(-1, -1)`` when it received nothing)."""

    backend = "proc"
    has_scan = True

    def __init__(self, comm):
        self.comm = comm
        self.rank = comm.rank()
        self.size = comm.size
        self.last_status = (ANY_SOURCE, ANY_TAG)

    def _handle(self):
        if not runtime.ensure_initialized():
            raise RuntimeError(
                "a ProcComm needs the native bridge: run the program "
                "under python -m mpi4jax_tpu_torch.launch -np N")
        runtime.check_health()
        return runtime.comm_handle(self.comm)

    # -- collectives -------------------------------------------------------

    def native_op(self, op, dtype):
        """The bridge's code of a built-in operator (every dtype), None
        for a user operator (gathered and folded in rank order)."""
        if op.is_user:
            return None
        return OP_CODES[op.name]

    def _unary(self, x, call, shape=None):
        h = self._handle()
        st = _Staging(x.device)
        host = st.inp(x)
        out = st.out(x.shape if shape is None else shape, x.dtype)
        st.ready()
        call(h, host, out)
        return st.back(out)

    def allreduce(self, x, code):
        return self._unary(
            x, lambda h, a, o: runtime.host_allreduce(h, a, code, out=o))

    def scan(self, x, code):
        return self._unary(
            x, lambda h, a, o: runtime.host_scan(h, a, code, out=o))

    def allgather(self, x):
        """``(size, *x.shape)``, row ``r`` from comm rank ``r``."""
        return self._unary(x, lambda h, a, o: runtime.host_allgather(
            h, a, out=o), (self.size, *x.shape))

    def alltoall(self, x):
        return self._unary(
            x, lambda h, a, o: runtime.host_alltoall(h, a, out=o))

    def reduce_scatter(self, x, code):
        if x.dtype == torch.bool:
            # as the JAX proc backend does: bool travels as int8, and the
            # result is its nonzero cells
            return self.reduce_scatter(x.to(torch.int8), code).bool()
        return self._unary(x, lambda h, a, o: runtime.host_reduce_scatter(
            h, a, code, out=o), x.shape[1:])

    def broadcast(self, x, root):
        return self._unary(
            x, lambda h, a, o: runtime.host_bcast(h, a, root, out=o))

    def reduce(self, x, code, root):
        """The reduction on ``root``; None elsewhere."""
        y = self._unary(
            x, lambda h, a, o: runtime.host_reduce(h, a, code, root, out=o))
        return y if self.rank == root else None

    def gather(self, x, root):
        """``(size, *x.shape)`` on ``root``; None elsewhere."""
        y = self._unary(x, lambda h, a, o: runtime.host_gather(
            h, a, root, out=o), (self.size, *x.shape))
        return y if self.rank == root else None

    def scatter(self, x, root, shape, dtype, device):
        """Row ``p`` of the root's ``x`` to comm rank ``p``; ``x`` is
        read on the root alone."""
        h = self._handle()
        st = _Staging(device)
        out = st.out(shape, dtype)
        host = st.inp(x) if self.rank == root else out
        st.ready()
        runtime.host_scatter(h, host, root, out=out)
        return st.back(out)

    def alltoall_fused(self, parts):
        """One frame per peer with its slice of every part; the same as
        one :meth:`alltoall` a part."""
        h = self._handle()
        st = _Staging(parts[0].device)
        hosts = [st.inp(p) for p in parts]
        outs = [st.out(p.shape, p.dtype) for p in parts]
        st.ready()
        runtime.host_alltoall_fused(h, hosts, outs)
        return [st.back(o) for o in outs]

    def barrier(self):
        runtime.host_barrier(self._handle())

    # -- point to point ----------------------------------------------------

    def exchange(self, sends, recvs, tag=None, *, sendtag=0,
                 recvtag=ANY_TAG, multi=False, coalesce=None):
        """This rank's side of one pattern: ``sends`` ``[(comm_rank,
        tensor)]`` all to one peer, ``recvs`` ``[(comm_rank, template)]``
        all from one peer.  Returns the received tensors.

        ``multi=False`` (``sendrecv``): at most one of each, one native
        sendrecv (or its one-sided send or recv).  ``multi=True``
        (``sendrecv_multi``): fusion is decided per wire direction, by
        ``coalesce`` or else ``coalesce_eligible`` on that direction's
        parts, as both ends decide it alike: a fused direction is one
        frame, an unfused one a send (or a receive) a part, the sends
        first."""
        del tag
        if not sends and not recvs:
            return []
        h = self._handle()
        device = (sends or recvs)[0][1].device
        st = _Staging(device)
        dst = sends[0][0] if sends else -1
        src = recvs[0][0] if recvs else -1
        hosts = [st.inp(t) for _, t in sends]
        outs = [st.out(t.shape, t.dtype) for _, t in recvs]
        st.ready()
        self.last_status = (ANY_SOURCE, ANY_TAG)
        if not multi:
            if hosts and outs:
                _, s, t = runtime.host_sendrecv(h, hosts[0], outs[0], src,
                                                dst, sendtag, recvtag)
                self.last_status = (s, t)
            elif hosts:
                runtime.host_send(h, hosts[0], dst, sendtag)
            else:
                _, s, t = runtime.host_recv(h, outs[0], src, recvtag)
                self.last_status = (s, t)
        else:
            fuse_send = bool(hosts) and _eligible(hosts, coalesce)
            fuse_recv = bool(outs) and _eligible(outs, coalesce)
            if fuse_send and fuse_recv:
                _, s, t = runtime.host_sendrecv_fused(
                    h, hosts, outs, src, dst, sendtag, recvtag)
                self.last_status = (s, t)
            else:
                if fuse_send:
                    runtime.host_sendrecv_fused(h, hosts, [], -1, dst,
                                                sendtag, recvtag)
                else:
                    for a in hosts:
                        runtime.host_send(h, a, dst, sendtag)
                if fuse_recv:
                    _, s, t = runtime.host_sendrecv_fused(
                        h, [], outs, src, -1, sendtag, recvtag)
                    self.last_status = (s, t)
                else:
                    for o in outs:
                        _, s, t = runtime.host_recv(h, o, src, recvtag)
                        self.last_status = (s, t)
        return [st.back(o) for o in outs]

    def post(self, peer, x, tag):
        """Send ``x`` to comm rank ``peer`` with ``tag`` (the bridge's
        send returns once the payload is on its way)."""
        h = self._handle()
        st = _Staging(x.device)
        host = st.inp(x)
        st.ready()
        runtime.host_send(h, host, peer, tag)

    def take(self, source, tag, like):
        """The earliest message from ``source`` (or ANY_SOURCE) with
        ``tag`` (or ANY_TAG), shaped like the template ``like``, as
        ``(source, tag, tensor)``."""
        h = self._handle()
        st = _Staging(like.device)
        out = st.out(like.shape, like.dtype)
        _, s, t = runtime.host_recv(h, out, source, tag)
        return s, t, st.back(out)


def _eligible(bufs, coalesce):
    """One direction's fusion decision (``mpi4jax_tpu/ops/p2p.py:
    sendrecv_multi``)."""
    if isinstance(coalesce, bool):
        return coalesce and len(bufs) >= 1
    from mpi4jax_tpu_torch import tuning

    total = sum(b.numel() * b.element_size() for b in bufs)
    return tuning.coalesce_eligible(total, len(bufs))


def transport_of(comm):
    """The :class:`ProcTransport` of a ProcComm (one per group and
    context in this process)."""
    key = (comm.ranks, comm.context)
    t = _transports.get(key)
    if t is None:
        t = _transports[key] = ProcTransport(comm)
    return t


def proc_topology(comm):
    """``{"host_id", "local_rank", "local_size", "leader_rank",
    "n_hosts"}`` of a comm: the bridge's bootstrap topology for a proc
    comm, the one-host map otherwise."""
    if getattr(comm, "backend", None) == "proc":
        runtime.ensure_initialized()
        topo = runtime.topology()
        if topo is not None:
            return topo
    return {"host_id": 0, "local_rank": int(comm.rank()),
            "local_size": int(comm.size), "leader_rank": 0, "n_hosts": 1}
