"""Point-to-point ops: sendrecv (+ Status).

Counterpart of ``sendrecv`` in ``mpi4jax_tpu/ops/p2p.py``, with the same
way of naming a pattern: ``dest`` / ``source`` are a callable
``rank -> partner`` (``None`` to sit out, the MPI_PROC_NULL analog), an
explicit list of ``(source_rank, dest_rank)`` pairs, or a plain int on a
size-1 communicator.  The two views must describe one permutation.

On the one-rank communicators of this slice a pattern is either the
self-pair ``[(0, 0)]`` — a periodic shift along a size-1 axis, which
delivers a copy of the send buffer — or empty — a non-periodic shift,
which leaves the recv buffer as it is (MPI_PROC_NULL).  Gradients flow
through both cases by autograd: the self-pair's transpose is itself.
"""

import numpy as np
import torch

from mpi4jax_tpu_torch.ops._core import (
    ANY_SOURCE,
    ANY_TAG,
    as_token,
    publishes_token,
)
from mpi4jax_tpu_torch.utils.validation import (
    check_comm,
    check_same_layout,
    check_static_int,
)

__all__ = ["sendrecv", "Status", "ANY_SOURCE", "ANY_TAG"]


class Status:
    """Output status for sendrecv (MPI.Status analog), with the mpi4py
    accessor methods for call-compatibility."""

    def __init__(self):
        self.source = None
        self.tag = None

    def Get_source(self):
        return self.source

    def Get_tag(self):
        return self.tag

    def Get_error(self):
        return 0


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
    if value != 0:
        raise ValueError(
            f"{role}={value} out of range for communicator of size {size}"
        )
    return [(0, 0)]


def _validate_perm(pairs, size, what):
    srcs = [s for s, _ in pairs]
    dsts = [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"{what} pattern is not a permutation: {pairs}")
    for s, d in pairs:
        if not (0 <= s < size and 0 <= d < size):
            raise ValueError(f"{what} pattern rank out of range: {pairs}")
    return pairs


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
    check_same_layout(sendbuf, recvbuf, "sendrecv on a grid communicator")
    size = comm.size
    dpairs = _validate_perm(
        _resolve_pairs(dest, size, "dest"), size, "sendrecv dest"
    )
    source_is_any = (
        isinstance(source, (int, np.integer)) and int(source) == ANY_SOURCE
    )
    if not source_is_any:
        spairs = _resolve_pairs(source, size, "source")
        if frozenset(spairs) != frozenset(dpairs):
            raise ValueError(
                "sendrecv source and dest views disagree: "
                f"dest implies {sorted(dpairs)}, source implies "
                f"{sorted(spairs)}. They must describe one global "
                "permutation."
            )
    rank = comm.rank()
    inbound = [s for s, d in dpairs if d == rank]
    if status is not None:
        status.source = inbound[0] if inbound else ANY_SOURCE
        status.tag = sendtag
    if not inbound:
        return recvbuf, token
    # one rank: the only inbound message is this rank's own send
    return sendbuf.clone(), token
