"""Point-to-point ops: sendrecv, sendrecv_multi, send and recv (+ Status).

Counterpart of ``mpi4jax_tpu/ops/p2p.py``.

``sendrecv`` and ``sendrecv_multi`` take a pattern, as on the JAX mesh
backend: ``dest`` / ``source`` are a callable ``rank -> partner``
(``None`` to sit out, the MPI_PROC_NULL analog) or an explicit list of
``(source_rank, dest_rank)`` pairs (``comm.shift_perm`` makes them), and
the two views must describe one permutation.  Each rank posts its one
send and its one receive of the pattern as a single batch.  A rank with
no inbound message gets its recv buffer back unchanged.  The gradient
of a sendrecv is the sendrecv of the cotangent along the reversed
pattern (the JAX transpose rule), and a rank with no inbound message
passes its cotangent to its recv buffer.  Its tangent travels the same
pattern after the primal (``torch.autograd.forward_ad``,
``torch.func.jvp``), and ``torch.func.vmap`` exchanges the whole
batched buffers at once.  As with every collective, each rank must
take its backward through the same exchanges in the same order.

``send`` and ``recv`` follow the JAX package's multi-process backend
(MPMD, one rank per process): an int partner is this rank's own
partner, and a pattern is resolved against ``comm.rank()`` (a rank with
no partner in it drops out).  Messages carry an envelope (tag, dtype,
shape) ahead of the payload; ``recv`` takes the earliest matching
message from its source, keeping the others for later receives, so
tags, ``ANY_TAG`` and ``ANY_SOURCE`` match as MPI matches them, first
in first out.  Messages travel over gloo through host memory in every
world, an NCCL world included (``parallel/distributed.py``: NCCL has
neither tags nor a receive from any source), and a send returns once
its payload is copied, as ``MPI_Send`` may.

On a proc comm (``parallel/proc.py``, the native bridge) ``sendrecv`` and
``sendrecv_multi`` also take this rank's own int partners, as the JAX
proc backend does; ``sendrecv`` is one native sendrecv, and each wire
direction of ``sendrecv_multi`` one fused frame or one frame a part
(``coalesce``); ``status`` holds the source and tag the wire gave.
"""

import threading

import numpy as np
import torch

from mpi4jax_tpu_torch.ops._core import (
    ANY_SOURCE,
    ANY_TAG,
    as_token,
    pop_match,
    publishes_token,
)
from mpi4jax_tpu_torch.utils.validation import (
    check_comm,
    check_rank_range,
    check_same_layout,
    check_static_int,
)

__all__ = ["sendrecv", "sendrecv_multi", "send", "recv", "Status",
           "ANY_SOURCE", "ANY_TAG"]


class Status:
    """Output status for sendrecv and recv (MPI.Status analog), with the
    mpi4py accessor methods for call-compatibility."""

    def __init__(self):
        self.source = None
        self.tag = None

    def Get_source(self):
        return self.source

    def Get_tag(self):
        return self.tag

    def Get_error(self):
        return 0


def _is_rank_int(spec):
    return isinstance(spec, (int, np.integer)) and not isinstance(
        spec, (bool, np.bool_))


def _resolve_pairs(spec, size, role):
    """Normalise a p2p partner spec into (source, dest) pairs.

    ``role`` is "dest" (spec maps rank -> where its data goes) or
    "source" (spec maps rank -> where its data comes from).
    """
    if callable(spec):
        pairs = []
        for r in range(size):
            p = spec(r)
            if p is None:
                continue
            p = int(p)
            if not 0 <= p < size:
                raise ValueError(
                    f"{role} callable returned rank {p} for rank {r}, out "
                    f"of range for communicator of size {size}. Wrap "
                    f"explicitly (e.g. (r + 1) % size) for periodic "
                    f"patterns, or return None to sit out."
                )
            pairs.append((r, p) if role == "dest" else (p, r))
        return pairs
    if isinstance(spec, (list, tuple)) and all(
        isinstance(e, (list, tuple)) and len(e) == 2 for e in spec
    ):
        return [(int(s), int(d)) for s, d in spec]
    value = check_static_int(spec, role)
    if size == 1:
        if value != 0:
            raise ValueError(
                f"{role}={value} out of range for communicator of size 1"
            )
        return [(0, 0)]
    raise ValueError(
        f"{role}={value!r}: sendrecv takes a pattern, not one rank: pass a "
        f"callable rank->partner (e.g. lambda r: (r + 1) % size), an "
        f"explicit list of (source, dest) pairs, or comm.shift_perm(axis, "
        f"disp). Per-rank integer addressing, as in MPI, is what send and "
        f"recv take."
    )


def _validate_perm(pairs, size, what):
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"{what} pattern is not a permutation: {pairs}")
    for s, d in pairs:
        if not (0 <= s < size and 0 <= d < size):
            raise ValueError(f"{what} pattern rank out of range: {pairs}")
    return pairs


def partners(pairs, rank):
    """``(source, dest)`` of ``rank`` in a permutation's pairs, each None
    where the rank has no partner."""
    src = [s for s, d in pairs if d == rank]
    dst = [d for s, d in pairs if s == rank]
    return (src[0] if src else None), (dst[0] if dst else None)


def _pattern_partners(source, dest, comm, what):
    size = comm.size
    dpairs = _validate_perm(
        _resolve_pairs(dest, size, "dest"), size, f"{what} dest"
    )
    if not (_is_rank_int(source) and int(source) == ANY_SOURCE):
        spairs = _resolve_pairs(source, size, "source")
        if frozenset(spairs) != frozenset(dpairs):
            raise ValueError(
                f"{what} source and dest views disagree: "
                f"dest implies {sorted(dpairs)}, source implies "
                f"{sorted(spairs)}. They must describe one global "
                "permutation."
            )
    return partners(dpairs, comm.rank())


def move(comm, sendbufs, recvbufs, src, dst, wire=None):
    """This rank's side of one pattern: ``sendbufs`` go to ``dst``, and
    from ``src`` come tensors shaped like ``recvbufs`` (one batch).
    Returns the received tensors, or None without a source.  A self pair
    (``src == dst == rank``, a periodic shift along a size-1 axis) is a
    copy.  ``wire`` holds a proc comm's tags and framing
    (``ProcTransport.exchange``)."""
    if src is None and dst is None:
        return None
    me = comm.rank()
    if src == me and dst == me:
        return [b.clone() for b in sendbufs]
    transport = comm.transport()
    got = transport.exchange(
        [(dst, b) for b in sendbufs] if dst is not None else [],
        [(src, b) for b in recvbufs] if src is not None else [],
        **(wire or {}),
    )
    return got if src is not None else None


class _SendrecvFn(torch.autograd.Function):
    """The exchange with its transpose (the cotangents travel back
    along the reversed pattern), its tangent rule (the tangents travel
    the same pattern, after the primals) and its batching rule (one
    exchange of the whole batched buffers)."""

    @staticmethod
    def forward(comm, src, dst, n, wire, *bufs):
        got = move(comm, bufs[:n], bufs[n:], src, dst, wire)
        if got is None:
            return tuple(b.clone() for b in bufs[n:])
        return tuple(got)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.comm, ctx.src, ctx.dst, ctx.n, ctx.wire, *bufs = inputs
        ctx.send_layout = [(b.shape, b.dtype) for b in bufs[:ctx.n]]

    @staticmethod
    def backward(ctx, *grads):
        templates = [torch.empty(s, dtype=d, device=grads[0].device)
                     for s, d in ctx.send_layout]
        back = move(ctx.comm, grads, templates, ctx.dst, ctx.src, ctx.wire)
        if back is None:
            back = [torch.zeros_like(t) for t in templates]
        to_recv = (list(grads) if ctx.src is None
                   else [torch.zeros_like(g) for g in grads])
        return (None, None, None, None, None, *back, *to_recv)

    @staticmethod
    def jvp(ctx, _comm, _src, _dst, _n, _wire, *tangents):
        return _SendrecvFn.apply(ctx.comm, ctx.src, ctx.dst, ctx.n,
                                 ctx.wire, *tangents)

    @staticmethod
    def vmap(info, in_dims, comm, src, dst, n, wire, *bufs):
        bufs = [b.movedim(d, 0) if d is not None
                else b.expand(info.batch_size, *b.shape)
                for b, d in zip(bufs, in_dims[5:])]
        out = _SendrecvFn.apply(comm, src, dst, n, wire, *bufs)
        return out, (0,) * len(out)


@publishes_token
def sendrecv(
    sendbuf,
    recvbuf,
    source,
    dest,
    sendtag=0,
    recvtag=ANY_TAG,
    *,
    comm=None,
    token=None,
    status=None,
):
    """Combined send + receive.

    ``dest`` gives where each rank's ``sendbuf`` goes, ``source`` where
    its ``recvbuf`` comes from.  Returns ``(received, token)``; a rank
    with no inbound message gets ``recvbuf`` back unchanged.
    """
    comm = check_comm(comm)
    token = as_token(token)
    check_static_int(sendtag, "sendtag")
    check_static_int(recvtag, "recvtag")
    sendbuf = torch.as_tensor(sendbuf)
    recvbuf = torch.as_tensor(recvbuf)
    if comm.backend == "self":
        if status is not None:
            status.source, status.tag = 0, sendtag
        return sendbuf.clone(), token
    if comm.backend == "proc":
        src = _own_partner(source, comm, "source")
        dst = _own_partner(dest, comm, "dest")
        wire = dict(sendtag=sendtag, recvtag=recvtag)
        (y,) = _SendrecvFn.apply(comm, src, dst, 1, wire, sendbuf, recvbuf)
        _wire_status(status, comm, src, dst, sendtag)
        return y, token
    check_same_layout(sendbuf, recvbuf, "sendrecv on a grid communicator")
    src, dst = _pattern_partners(source, dest, comm, "sendrecv")
    if status is not None:
        status.source = ANY_SOURCE if src is None else src
        status.tag = sendtag
    (y,) = _SendrecvFn.apply(comm, src, dst, 1, None, sendbuf, recvbuf)
    return y, token


@publishes_token
def sendrecv_multi(
    sendbufs,
    recvbufs,
    source,
    dest,
    sendtag=0,
    recvtag=ANY_TAG,
    *,
    comm=None,
    token=None,
    status=None,
    coalesce=None,
):
    """Exchange several same-pattern messages at once: the same results
    as one :func:`sendrecv` per ``(sendbufs[i], recvbufs[i])`` pair, all
    parts posted in one batch.  On a proc comm each wire direction is
    one fused frame when ``coalesce`` is True, or, with ``coalesce``
    unset, when ``coalesce_eligible`` says so for that direction's
    parts (``T4J_COALESCE_BYTES``); otherwise one frame a part, the
    sends first.  Other backends take ``coalesce`` for
    call-compatibility.  Returns ``(outs, token)``; ranks without an
    inbound partner keep their recv buffers."""
    comm = check_comm(comm)
    token = as_token(token)
    check_static_int(sendtag, "sendtag")
    check_static_int(recvtag, "recvtag")
    sendbufs = [torch.as_tensor(b) for b in sendbufs]
    recvbufs = [torch.as_tensor(b) for b in recvbufs]
    if len(sendbufs) != len(recvbufs):
        raise ValueError(
            f"sendrecv_multi pairs each send with a receive, got "
            f"{len(sendbufs)} sends and {len(recvbufs)} receives"
        )
    if comm.backend == "self":
        if status is not None:
            status.source, status.tag = 0, sendtag
        return [b.clone() for b in sendbufs], token
    if comm.backend == "proc":
        src = _own_partner(source, comm, "source")
        dst = _own_partner(dest, comm, "dest")
        wire = dict(sendtag=sendtag, recvtag=recvtag, multi=True,
                    coalesce=coalesce)
        outs = _SendrecvFn.apply(comm, src, dst, len(sendbufs), wire,
                                 *sendbufs, *recvbufs)
        _wire_status(status, comm, src, dst, sendtag)
        return list(outs), token
    for sb, rb in zip(sendbufs, recvbufs):
        check_same_layout(sb, rb, "sendrecv_multi on a grid communicator")
    src, dst = _pattern_partners(source, dest, comm, "sendrecv_multi")
    if status is not None:
        status.source = ANY_SOURCE if src is None else src
        status.tag = sendtag
    return list(_SendrecvFn.apply(comm, src, dst, len(sendbufs), None,
                                  *sendbufs, *recvbufs)), token


# -- send / recv ----------------------------------------------------------


def _own_partner(spec, comm, role):
    """This rank's partner: an int as given (range-checked); a callable
    or pair list resolved against ``comm.rank()``, None where the rank
    has no partner in it."""
    if _is_rank_int(spec):
        return check_rank_range(spec, role, comm.size)
    pairs = _resolve_pairs(spec, comm.size, role)
    me = comm.rank()
    mine = ([d for s, d in pairs if s == me] if role == "dest"
            else [s for s, d in pairs if d == me])
    if not mine:
        return None
    if len(mine) > 1:
        raise ValueError(
            f"{role} pattern gives rank {me} {len(mine)} partners "
            f"({mine}); a p2p op takes exactly one — split the pattern "
            "into separate calls"
        )
    return mine[0]


def _wire_status(status, comm, src, dst, sendtag):
    """A proc comm's status: the source and tag the wire gave the
    receive, (-1, -1) where this rank received nothing."""
    if status is None:
        return
    if src is None:
        status.source, status.tag = ANY_SOURCE, ANY_TAG
    elif src == dst == comm.rank():
        status.source, status.tag = src, sendtag
    else:
        status.source, status.tag = comm.transport().last_status


class _OneRankMail(threading.local):
    """Messages a one-rank communicator sent itself, per comm, per
    thread."""

    def __init__(self):
        self.boxes = {}


_one_rank_mail = _OneRankMail()


@publishes_token
def send(x, dest, tag=0, *, comm=None, token=None):
    """Send ``x`` to ``dest`` with ``tag``; returns a token.  The
    payload is copied, so ``x`` may change once this returns."""
    comm = check_comm(comm)
    token = as_token(token)
    tag = check_static_int(tag, "tag")
    x = torch.as_tensor(x)
    peer = _own_partner(dest, comm, "dest")
    if peer is None:
        return token
    transport = comm.transport()
    me = comm.rank()
    if transport is None or (peer == me and transport.backend != "proc"):
        box = (_one_rank_mail.boxes.setdefault(comm, [])
               if transport is None else transport.stash)
        box.append((me, tag, x.detach().clone()))
    else:
        transport.post(peer, x, tag)
    return token


@publishes_token
def recv(x, source=ANY_SOURCE, tag=ANY_TAG, *, comm=None, token=None,
         status=None):
    """Receive a message shaped like the template ``x`` from ``source``
    (or ``ANY_SOURCE``) with ``tag`` (or ``ANY_TAG``); returns
    ``(received, token)``.  A rank with no partner in a pattern gets
    ``x`` back (MPI_PROC_NULL)."""
    comm = check_comm(comm)
    token = as_token(token)
    tag = check_static_int(tag, "tag")
    x = torch.as_tensor(x)
    if _is_rank_int(source) and int(source) == ANY_SOURCE:
        source = ANY_SOURCE
    else:
        source = _own_partner(source, comm, "source")
    if source is None:
        if status is not None:
            status.source, status.tag = ANY_SOURCE, ANY_TAG
        return x, token
    transport = comm.transport()
    if transport is None:
        found = pop_match(_one_rank_mail.boxes.setdefault(comm, []), source,
                          tag)
    else:
        found = transport.take(source, tag, x)
    if found is None:
        raise RuntimeError(
            f"recv of rank {comm.rank()} from itself with tag "
            f"{'ANY' if tag == ANY_TAG else tag} found no matching send"
        )
    src, t, y = found
    y = y.to(x.device)
    if tuple(y.shape) != tuple(x.shape) or y.dtype != x.dtype:
        raise ValueError(
            f"recv template shape/dtype {tuple(x.shape)}/{x.dtype} does "
            f"not match the message {tuple(y.shape)}/{y.dtype}"
        )
    if status is not None:
        status.source, status.tag = src, t
    return y, token
