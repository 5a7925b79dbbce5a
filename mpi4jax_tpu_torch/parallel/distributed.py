"""Worlds of ranks: the port's counterpart of
``mpi4jax_tpu/parallel/distributed.py``.

The JAX package joins a job through ``jax.distributed`` and makes every
device of it a member of one mesh.  PyTorch runs one rank per process,
so a world here is a set of ``torch.distributed`` process groups:

    from mpi4jax_tpu_torch.parallel import distributed

    distributed.initialize()      # under torchrun: NCCL on the cards
    comm = distributed.world_comm((("y", "x"), (2, 2)))
    ...                           # the ops and the solver as usual

:func:`initialize` reads the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
joins the job: NCCL when the device is CUDA, one card per rank, and gloo
when the caller asks for the CPU.  :func:`world_comm` is the
``COMM_WORLD`` analog.

:func:`local_world` runs N ranks as N threads of this process, each with
its own gloo process group over one in-memory store, bound to loopback.
It is the counterpart of the JAX package's one-process virtual mesh
(``tests/conftest.py``, ``benchmarks/collectives.py --cpu-mesh``): the
port's tests run their multi-rank cases in one, and ``chip_smoke.py``
runs a grid of ranks on one card in one.  Gloo moves CPU tensors only,
so a gloo transport stages CUDA tensors through host memory, always and
by its backend alone (the reference's COPY_TO_HOST mode).

A :class:`Transport` is one rank's handle on one group: the process
group, its rank, and a mailbox for tagged point-to-point messages.  The
mailbox (``send``/``recv``) runs over gloo in every world, through host
memory: NCCL has no tags and no receive from any source, and its sends
wait for their receives, where MPI's ``send`` returns once its buffer
may be reused.  An NCCL world therefore gives each of its groups a gloo
twin of the same members for the mailbox (made beside the NCCL group,
as group creation is collective); collectives and ``sendrecv`` stay on
NCCL.
"""

import datetime
import itertools
import os
import threading
import time

import torch
import torch.distributed as dist

from mpi4jax_tpu_torch.ops._core import ANY_SOURCE, pop_match
from mpi4jax_tpu_torch.parallel.comm import MeshComm, default_comm, set_default_comm
from mpi4jax_tpu_torch.utils.runtime import release_graphs

__all__ = [
    "Transport",
    "initialize",
    "world_comm",
    "local_world",
    "finalize",
    "DEFAULT_TIMEOUT_S",
]

DEFAULT_TIMEOUT_S = 60.0  # every group's wait limit (gloo's default: 30 min)

# gloo tags: the sendrecv patterns, the halo shifts and the mailbox keep
# their messages apart (NCCL ignores tags and matches in program order)
EXCHANGE_TAG = 1
MAIL_TAG = 2  # envelopes; payloads follow on MAIL_TAG + 1 (gloo only)
MAX_DIMS = 8
_HEADER = 3 + MAX_DIMS  # tag, dtype code, ndim, shape

_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
           torch.bool, torch.complex64, torch.complex128)

# reduction operators the backends compute natively; every other
# (operator, dtype) moves the rows (allgather, gather or alltoall) and
# folds them in rank order (rank_ordered_fold)
_NATIVE = {"sum": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
           "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
           "band": dist.ReduceOp.BAND, "bor": dist.ReduceOp.BOR,
           "bxor": dist.ReduceOp.BXOR}
_NATIVE_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)
_BITWISE = ("band", "bor", "bxor")
# what travels in place of the dtypes the backends do not carry (complex
# travels as pairs of its real dtype, ``torch.view_as_real``)
_AS_SIGNED = {torch.bool: torch.uint8, torch.uint16: torch.int16,
              torch.uint32: torch.int32, torch.uint64: torch.int64}


class Transport:
    """One rank's handle on the process group of one comm group.

    ``members`` are the group's world ranks in comm-rank order and
    ``rank`` this rank's position among them.  ``pg`` is None for a
    group of one.  ``mail_pg`` is the gloo group of the mailbox: ``pg``
    itself in a gloo world, a twin of the same members (the same ranks
    in the same order) in an NCCL world.  Every method takes and returns
    tensors on the caller's device: a gloo group's tensors are copied to
    host memory and back around each call.
    """

    has_scan = False  # scan gathers the rows and folds them in rank order

    def __init__(self, world, members, pg, pg_ranks, mail_pg=None):
        self.world = world
        self.members = members
        self.rank = members.index(world.rank)
        self.size = len(members)
        self.pg = pg
        self.mail_pg = pg if mail_pg is None else mail_pg
        self.pg_ranks = pg_ranks  # comm rank -> the process group's rank
        identity = list(pg_ranks) == list(range(self.size))
        self._to_comm = None if identity else list(pg_ranks)
        self._to_pg = None if identity else [
            pg_ranks.index(p) for p in range(self.size)]
        self.backend = world.backend
        self.pending = []  # sends in flight: (works, buffers kept alive)
        self.stash = []  # received messages no recv has taken yet

    # -- staging: what a tensor looks like on the wire --------------------

    def _wire(self, t, private=False, host=None):
        """``t`` as the backend moves it: contiguous, in a dtype the
        backends carry (bool as uint8, complex as pairs of reals,
        unsigned as signed of the same width), and in
        host memory for gloo (or with ``host``, as the mailbox needs);
        with ``private``, never ``t``'s own memory."""
        host = self.backend == "gloo" if host is None else host
        w = t.detach().contiguous()
        if w.is_complex():
            w = torch.view_as_real(w)
        elif w.dtype in _AS_SIGNED:
            w = w.view(_AS_SIGNED[w.dtype])
        if host and w.is_cuda:
            w = w.cpu()
        if private and w.data_ptr() == t.data_ptr():
            w = w.clone()
        return w

    def _wire_empty(self, shape, dtype, device, host=None):
        if dtype.is_complex:
            shape, dtype = (*shape, 2), dtype.to_real()
        if self.backend == "gloo" if host is None else host:
            device = torch.device("cpu")
        return torch.empty(shape, dtype=_AS_SIGNED.get(dtype, dtype),
                           device=device)

    @staticmethod
    def _unwire(w, dtype, device):
        if dtype.is_complex:
            w = torch.view_as_complex(w.contiguous())
        elif dtype in _AS_SIGNED:
            w = w.view(dtype)
        return w.to(device)

    def _pg_order(self, rows):
        """Rows in comm-rank order -> in the process group's rank order
        (a ``new_group`` numbers its members by world rank, a split
        comm by (key, rank))."""
        return rows if self._to_pg is None else rows[self._to_pg]

    def _comm_order(self, rows):
        """Rows in the process group's rank order -> comm-rank order."""
        return rows if self._to_comm is None else rows[self._to_comm]

    # -- collectives -------------------------------------------------------

    def native_op(self, op, dtype):
        """The backend's ``ReduceOp`` for ``op`` on ``dtype``, or None."""
        if op.is_user or op.name not in _NATIVE or dtype not in _NATIVE_DTYPES:
            return None
        if op.name in _BITWISE and (self.backend == "nccl"
                                    or dtype.is_floating_point):
            return None
        return _NATIVE[op.name]

    def allreduce(self, x, reduce_op):
        w = self._wire(x, private=True)
        opts = dist.AllreduceOptions()
        opts.reduceOp = reduce_op
        self.pg.allreduce([w], opts).wait()
        return self._unwire(w, x.dtype, x.device)

    def allgather(self, x):
        """``(size, *x.shape)``, row ``r`` from comm rank ``r``."""
        w = self._wire(x)
        rows = w.new_empty((self.size, *w.shape))
        self.pg.allgather([list(rows.unbind(0))], [w]).wait()
        return self._unwire(self._comm_order(rows), x.dtype, x.device)

    def alltoall(self, x):
        """``x`` is ``(size, *rest)``: row ``p`` goes to comm rank
        ``p``; row ``p`` of the result came from comm rank ``p``."""
        w = self._pg_order(self._wire(x))
        rows = torch.empty_like(w)
        self.pg.alltoall_base(rows, w, [], [], dist.AllToAllOptions()).wait()
        return self._unwire(self._comm_order(rows), x.dtype, x.device)

    def reduce_scatter(self, x, reduce_op):
        """``x`` is ``(size, *rest)``: comm rank ``p`` gets row ``p``
        reduced over the ranks."""
        w = self._pg_order(self._wire(x))
        out = w.new_empty(w.shape[1:])
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = reduce_op
        self.pg.reduce_scatter([out], [list(w.unbind(0))], opts).wait()
        return self._unwire(out, x.dtype, x.device)

    # rooted collectives: ``root`` is a comm rank; the backend's calls
    # take the process group's

    def broadcast(self, x, root):
        w = self._wire(x, private=True)
        opts = dist.BroadcastOptions()
        opts.rootRank, opts.rootTensor = self.pg_ranks[root], 0
        self.pg.broadcast([w], opts).wait()
        return self._unwire(w, x.dtype, x.device)

    def reduce(self, x, reduce_op, root):
        """The reduction on ``root``; None elsewhere."""
        w = self._wire(x, private=True)
        opts = dist.ReduceOptions()
        opts.reduceOp, opts.rootRank, opts.rootTensor = (
            reduce_op, self.pg_ranks[root], 0)
        self.pg.reduce([w], opts).wait()
        return self._unwire(w, x.dtype, x.device) if self.rank == root else None

    def gather(self, x, root):
        """``(size, *x.shape)`` on ``root``, in comm-rank order; None
        elsewhere."""
        w = self._wire(x)
        rows = w.new_empty((self.size, *w.shape)) if self.rank == root else None
        opts = dist.GatherOptions()
        opts.rootRank = self.pg_ranks[root]
        self.pg.gather([] if rows is None else [list(rows.unbind(0))], [w],
                       opts).wait()
        if rows is None:
            return None
        return self._unwire(self._comm_order(rows), x.dtype, x.device)

    def scatter(self, x, root, shape, dtype, device):
        """Row ``p`` of the root's ``x`` (``(size, *shape)``) to comm
        rank ``p``; ``x`` is read on the root alone."""
        out = self._wire_empty(shape, dtype, device)
        opts = dist.ScatterOptions()
        opts.rootRank = self.pg_ranks[root]
        rows = ([list(self._pg_order(self._wire(x)).unbind(0))]
                if self.rank == root else [])
        self.pg.scatter([out], rows, opts).wait()
        return self._unwire(out, dtype, device)

    def barrier(self):
        if self.backend == "gloo":
            self.pg.barrier().wait()
            return
        z = torch.zeros(1, dtype=torch.int32, device=self.world.device)
        self.pg.allreduce([z]).wait()

    # -- point to point ----------------------------------------------------

    def exchange(self, sends, recvs, tag=EXCHANGE_TAG):
        """Post ``sends`` ``[(comm_rank, tensor)]`` and ``recvs``
        ``[(comm_rank, template)]`` as one batch and wait for all; returns
        the received tensors (new, shaped like the templates)."""
        wires = [(p, self._wire(t)) for p, t in sends]
        bufs = [(p, self._wire_empty(t.shape, t.dtype, t.device))
                for p, t in recvs]
        if self.world.registered:
            ops = [dist.P2POp(dist.isend, w, self.members[p], group=self.pg,
                              tag=tag) for p, w in wires]
            ops += [dist.P2POp(dist.irecv, b, self.members[p], group=self.pg,
                               tag=tag) for p, b in bufs]
            works = dist.batch_isend_irecv(ops)
        else:
            works = [self.pg.send([w], self.pg_ranks[p], tag) for p, w in wires]
            works += [self.pg.recv([b], self.pg_ranks[p], tag) for p, b in bufs]
        for work in works:
            work.wait()
        return [self._unwire(b, t.dtype, t.device)
                for (_, b), (_, t) in zip(bufs, recvs)]

    def post(self, peer, x, tag):
        """Send ``x`` to comm rank ``peer`` with ``tag`` over the gloo
        mailbox group (MPI_Send's buffer semantics: ``x`` may be changed
        as soon as this returns).  An envelope (tag, dtype, shape) goes
        ahead of the payload."""
        if x.dim() > MAX_DIMS:
            raise ValueError(f"send takes at most {MAX_DIMS} dimensions")
        header = torch.zeros(_HEADER, dtype=torch.int64)
        header[:3] = torch.tensor([tag, _DTYPES.index(x.dtype), x.dim()])
        header[3:3 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
        payload = self._wire(x, private=True, host=True)
        dst = self.pg_ranks[peer]
        works = [self.mail_pg.send([header], dst, MAIL_TAG),
                 self.mail_pg.send([payload], dst, MAIL_TAG + 1)]
        self.pending.append((works, header, payload))
        self.pending = [p for p in self.pending
                        if not all(w.is_completed() for w in p[0])]

    def take(self, source, tag, like):
        """The earliest message from ``source`` (a comm rank or
        ANY_SOURCE) with ``tag`` (or ANY_TAG) as ``(source, tag,
        tensor)`` on the device of the template ``like``: from the
        messages already here (this rank's own sends to itself among
        them), else from the wire, keeping the ones that do not match.
        None when only this rank could send it and it has not."""
        device = like.device
        found = pop_match(self.stash, source, tag)
        if found is not None or source == self.rank:
            return found
        while True:
            msg = self._receive(source, device)
            if pop_match([msg], source, tag) is not None:
                return msg
            self.stash.append(msg)

    def _receive(self, source, device):
        header = torch.empty(_HEADER, dtype=torch.int64)
        if source == ANY_SOURCE:
            work = self.mail_pg.recv_anysource([header], MAIL_TAG)
            work.wait()
            src = self.pg_ranks.index(work._source_rank())
        else:
            self.mail_pg.recv([header], self.pg_ranks[source], MAIL_TAG).wait()
            src = source
        t, code, ndim, *shape = header.tolist()
        dtype = _DTYPES[code]
        buf = self._wire_empty(tuple(shape[:ndim]), dtype, device, host=True)
        self.mail_pg.recv([buf], self.pg_ranks[src], MAIL_TAG + 1).wait()
        return src, t, self._unwire(buf, dtype, device)


class World:
    """One rank's membership of a world of ranks: its rank, the backend,
    its device, and the process groups of the comms built on it, one per
    (context, members), created the first time a comm needs it."""

    registered = False  # groups of torch.distributed's default world

    def __init__(self, rank, size, backend, device):
        self.rank = rank
        self.size = size
        self.backend = backend
        self.device = torch.device(device)
        self._transports = {}
        self._contexts = itertools.count(1)

    def next_context(self):
        return next(self._contexts)

    def comm(self, axes=None):
        """A :class:`MeshComm` over the whole world: ``axes`` is
        ``(names, shape)``, one flat ``("world", size)`` axis by default."""
        names, shape = axes if axes is not None else (("world",), (self.size,))
        return MeshComm(axes=tuple(names), axis_sizes=tuple(shape), world=self)

    def transport(self, partition, context):
        """The :class:`Transport` of this rank's group in ``partition``
        (tuples of world ranks, one per group, in comm-rank order)."""
        mine = next(g for g in partition if self.rank in g)
        key = (context, mine)
        if key not in self._transports:
            self._make(partition, context)
        return self._transports[key]

    def _make(self, partition, context):
        raise NotImplementedError

    def release(self):
        """Complete the sends in flight and drop this rank's process
        groups (a local world's rank does so in its own thread as it
        ends: a gloo group's teardown takes some 50 ms, which the ranks
        then spend side by side)."""
        for t in self._transports.values():
            if t is not None:
                for works, *_ in t.pending:
                    for w in works:
                        w.wait()
                t.pending, t.pg, t.mail_pg = [], None, None
        self._transports.clear()


class _StoreWorld(World):
    """A local world's rank: gloo groups built on one shared store, each
    by its members alone.  A group numbers its members by world rank,
    as ``new_group`` does, so the comm-rank mapping (``pg_ranks``) of a
    split comm's groups runs here as it does under torchrun."""

    def __init__(self, store, prefix, rank, size, timeout):
        super().__init__(rank, size, "gloo", "cpu")
        self.store = store
        self.prefix = prefix
        self.timeout = datetime.timedelta(seconds=timeout)

    def _make(self, partition, context):
        mine = next(g for g in partition if self.rank in g)
        by_rank = sorted(mine)
        pg = None
        if len(mine) > 1:
            opts = dist.ProcessGroupGloo._Options()
            opts._timeout = self.timeout
            # the ranks share this process: loopback reaches all of them,
            # whatever the host's name resolves to
            opts._devices = [dist.ProcessGroupGloo.create_device(
                interface="lo")]
            name = f"{self.prefix}/{context}/{'.'.join(map(str, mine))}"
            pg = dist.ProcessGroupGloo(
                dist.PrefixStore(name, self.store), by_rank.index(self.rank),
                len(mine), opts)
        self._transports[(context, mine)] = Transport(
            self, mine, pg, [by_rank.index(m) for m in mine])


class _DistWorld(World):
    """A rank of ``torch.distributed``'s default world: every rank
    creates every group of a partition, in order (``new_group`` is
    collective over the world), and keeps its own.  Over NCCL each
    group has a gloo twin for the mailbox, made right after it."""

    registered = True

    def __init__(self, rank, size, backend, device, timeout):
        super().__init__(rank, size, backend, device)
        self.timeout = datetime.timedelta(seconds=timeout)

    def _make(self, partition, context):
        for g in partition:
            key = (context, g)
            if key in self._transports:
                continue
            pg = mail_pg = None
            if len(g) > 1:
                if context == 0 and sorted(g) == list(range(self.size)):
                    pg = dist.group.WORLD
                else:
                    pg = dist.new_group(list(g), timeout=self.timeout)
                mail_pg = (dist.new_group(list(g), timeout=self.timeout,
                                          backend="gloo")
                           if self.backend == "nccl" else pg)
            if self.rank in g:
                # the twin, made from the same ranks, numbers them alike
                pg_ranks = ([0] if pg is None else
                            [dist.get_group_rank(pg, m) for m in g])
                self._transports[key] = Transport(self, g, pg, pg_ranks,
                                                  mail_pg)
            else:
                self._transports[key] = None


_dist_world = None


def initialize(device="cuda", *, timeout=DEFAULT_TIMEOUT_S):
    """Join the ``torchrun`` job of this process (idempotent); returns
    this rank's ``torch.device``.

    ``device="cuda"``: NCCL, this rank on card ``LOCAL_RANK``, which must
    exist.  ``device="cpu"``: gloo.  Without a torchrun environment it
    raises: a single process needs no world (``MeshComm()``)."""
    global _dist_world
    device = torch.device(device)
    if _dist_world is not None:
        return _dist_world.device
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"initialize() reads the torchrun environment; {missing} not "
            "set (launch with torchrun --nproc-per-node N)"
        )
    rank = int(os.environ["RANK"])
    size = int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RuntimeError(
                f"rank {rank} needs card {local}, but this host has {have} "
                "CUDA device(s); pass device='cpu' for a gloo world"
            )
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout),
    )
    _dist_world = _DistWorld(rank, size, backend, device, timeout)
    return device


def world_comm(axes=None, *, set_default=False):
    """MeshComm spanning the whole ``initialize``d job (COMM_WORLD
    analog); ``axes`` is ``(names, shape)`` as in the JAX package.  With
    ``set_default=True`` it also becomes the ambient communicator."""
    if _dist_world is None:
        raise RuntimeError("world_comm() needs initialize() first")
    comm = _dist_world.comm(axes)
    if set_default:
        set_default_comm(comm)
    return comm


def finalize(world=None):
    """End this rank's part of a world, on every rank after its last op:

    1. wait for the device;
    2. reset the CUDA graphs still alive (``utils/runtime.py:
       release_graphs``): an NCCL chunk's graph holds NCCL work, and
       destroying the groups under it hung;
    3. a host barrier on the world's gloo group (the NCCL world's twin),
       so that no rank tears down a group a peer still uses;
    4. complete the sends in flight and drop the process groups (and
       ``torch.distributed``'s default group).

    ``world`` is the ``initialize``d job by default (steps 2 and 4 end
    it; ``initialize`` may then join a new one); a local world's rank
    passes ``comm.world`` (its graphs are not touched: the process goes
    on)."""
    global _dist_world
    own = world is None or world is _dist_world
    world = _dist_world if world is None else world
    if world is None:
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if own:
        release_graphs()
    if world.size > 1:
        world.comm().transport().mail_pg.barrier().wait()
    world.release()
    if own:
        dist.destroy_process_group()
        _dist_world = None


_local_worlds = itertools.count()


def local_world(n, fn, *, axes=None, timeout=DEFAULT_TIMEOUT_S,
                deadline=None):
    """Run ``fn(comm)`` on ``n`` ranks, as ``n`` threads of this process;
    returns the results in rank order.

    ``comm`` is a :class:`MeshComm` over the world (``axes`` as in
    :func:`world_comm`), also the thread's default comm.  Every group
    waits at most ``timeout`` seconds for a peer; the threads are joined
    within ``deadline`` seconds (``timeout`` + 10 s by default).  If a
    rank raises, the first to fail is re-raised, naming its rank, once
    the others have ended (those waiting on it end at their timeout).

    Forward-mode AD has one dual level per process: enter
    ``torch.autograd.forward_ad.dual_level()`` around the call, not in
    the ranks (``torch.func.jvp`` enters its own, so it runs in a world
    of processes, or on one rank, but not in several thread ranks at
    once).
    """
    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=timeout))
    prefix = f"local{next(_local_worlds)}"
    results = [None] * n
    failures = []
    lock = threading.Lock()

    def body(rank):
        world = _StoreWorld(store, prefix, rank, n, timeout)
        try:
            comm = world.comm(axes)
            # autograd runs a CUDA tensor's backward on one thread per
            # card, which the ranks would share: their backward
            # collectives would wait there for each other until the
            # timeout; each rank runs its own backward instead
            with default_comm(comm), \
                    torch.autograd.set_multithreading_enabled(False):
                results[rank] = fn(comm)
            world.release()
        except Exception as exc:  # noqa: BLE001 (re-raised below)
            with lock:
                failures.append((rank, exc))

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"local-world-rank-{r}")
               for r in range(n)]
    end = time.monotonic() + (timeout + 10.0 if deadline is None
                              else deadline)
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    if failures:
        rank, exc = failures[0]
        raise RuntimeError(
            f"rank {rank} of a {n}-rank local world failed: "
            f"{type(exc).__name__}: {exc}"
        ) from exc
    alive = [r for r, t in enumerate(threads) if t.is_alive()]
    if alive:
        raise TimeoutError(
            f"ranks {alive} of a {n}-rank local world were still running "
            f"after the deadline"
        )
    return results
