"""Nonblocking collectives and point to point: request futures over the
native bridge's progress engine.

Counterpart of ``mpi4jax_tpu/ops/async_.py``.
:func:`iallreduce`, :func:`ireduce_scatter`, :func:`isend` and
:func:`irecv` submit and return a :class:`Request` at once; the bridge's
progress thread runs the wire phase while the program computes, and
:func:`wait`, :func:`waitall` and :func:`test` complete the request.
The results equal the blocking ops' bit for bit: the engine runs the
same native op bodies.

Request discipline (MPI's): every request is consumed by
``wait``/``waitall`` exactly once (a second wait raises
``RuntimeError``), ``test`` never consumes one, and requests never
waited are reported on stderr when the bridge finalizes
(:func:`assert_requests_drained` raises on them before that).  Ordering
is program order: each rank submits its collectives in the order it
calls them, and every rank must call them in the same order.  Tokens
stay in every signature and carry nothing.  The async ops have no
gradient, and take built-in operators only.

Backends:

* ``proc`` submits to the engine (``native/runtime.py`` ``host_i*``).
  The request holds its operand and its result buffer until the wait.
  A CUDA tensor is staged: copied into pinned host memory and its
  stream synchronised before the submit; the wait copies the result
  back to the operand's device (an ``irecv``'s: its template's) on the
  current stream after the native wait returns.
* ``self`` completes at submit: the request carries the value.  An
  ``isend`` or ``irecv`` there has no peer and raises.
* ``mesh`` raises ``NotImplementedError``, as the JAX package's mesh
  backend does: a mesh comm has no requests.
"""

import torch

from mpi4jax_tpu_torch.ops import reductions
from mpi4jax_tpu_torch.ops._core import (
    ANY_SOURCE,
    ANY_TAG,
    as_token,
    publishes_token,
)
from mpi4jax_tpu_torch.utils.validation import (
    check_comm,
    check_op,
    check_rank_range,
)

__all__ = [
    "Request",
    "iallreduce",
    "ireduce_scatter",
    "isend",
    "irecv",
    "wait",
    "waitall",
    "test",
    "assert_requests_drained",
]


class Request:
    """Handle of an in-flight nonblocking op; consume it with
    :func:`wait` or :func:`waitall` exactly once.

    ``kind`` is the op ("iallreduce", "ireduce_scatter", "isend",
    "irecv"), ``backend`` the comm's ("proc" or "self"); ``payload`` is
    the engine's request id on a proc comm, the finished value on a self
    comm; ``staging`` (proc) holds the op's host buffers and the device
    its result goes back to."""

    def __init__(self, kind, backend, payload, staging=None):
        self.kind = kind
        self.backend = backend
        self.payload = payload
        self.staging = staging
        self._consumed = False

    def __repr__(self):
        return f"Request({self.kind}, backend={self.backend})"


def _mark_consumed(req, what):
    if req._consumed:
        raise RuntimeError(
            f"{what} on an already-consumed request ({req.kind}): a "
            "request may be waited exactly once"
        )
    req._consumed = True


def _check_async_backend(comm, opname):
    if comm.backend == "mesh":
        raise NotImplementedError(
            f"{opname} is not defined on the mesh backend: inside one "
            "XLA program the compiler already overlaps collectives; "
            "nonblocking requests are a proc-tier (multi-process) "
            "concept (docs/async.md)"
        )


def _submit(comm, device, x, out_shape, dtype, call):
    """Stage ``x`` (None for an irecv) and an output of ``out_shape``
    (None for an isend) on the host for ``device``, run ``call(handle,
    host_x, host_out)`` (the request id), and return it with the
    staging, which keeps the buffers and the device."""
    from mpi4jax_tpu_torch.ops._proc import _Staging, transport_of

    h = transport_of(comm)._handle()
    st = _Staging(device)
    host = None if x is None else st.inp(x)
    out = None if out_shape is None else st.out(out_shape, dtype)
    st.ready()
    return call(h, host, out), st


# ---------------------------------------------------------------- submits


@publishes_token
def iallreduce(x, op=reductions.SUM, *, comm=None, token=None):
    """Nonblocking all-reduce: ``(request, token)`` at once; :func:`wait`
    returns the reduced tensor.  Built-in operators only."""
    op = check_op(op)
    comm = check_comm(comm)
    _check_async_backend(comm, "iallreduce")
    token = as_token(token)
    x = torch.as_tensor(x).detach()
    if comm.backend == "self":
        return Request("iallreduce", "self", x.clone()), token
    if op.is_user:
        raise NotImplementedError(
            "iallreduce supports builtin reduction ops only; route "
            "user-defined ops through the blocking allreduce"
        )
    from mpi4jax_tpu_torch.native import runtime
    from mpi4jax_tpu_torch.ops._proc import OP_CODES

    code = OP_CODES[op.name]
    rid, st = _submit(comm, x.device, x, x.shape, x.dtype, lambda h, a, o:
                      runtime.host_iallreduce(h, a, code, out=o))
    return Request("iallreduce", "proc", rid, st), token


@publishes_token
def ireduce_scatter(x, op=reductions.SUM, *, comm=None, token=None):
    """Nonblocking ``MPI_Reduce_scatter_block``: ``x`` is ``(comm.size,
    *rest)``; :func:`wait` returns row ``rank`` reduced, of shape
    ``rest``.  Built-in operators only."""
    op = check_op(op)
    comm = check_comm(comm)
    _check_async_backend(comm, "ireduce_scatter")
    token = as_token(token)
    x = torch.as_tensor(x).detach()
    shape = tuple(x.shape)
    if not shape or shape[0] != comm.size:
        raise ValueError(
            f"ireduce_scatter input must have shape (comm.size, ...) = "
            f"({comm.size}, ...), got {shape}"
        )
    if comm.backend == "self":
        return Request("ireduce_scatter", "self", x[0].clone()), token
    if op.is_user:
        raise NotImplementedError(
            "ireduce_scatter supports builtin reduction ops only"
        )
    from mpi4jax_tpu_torch.native import runtime
    from mpi4jax_tpu_torch.ops._proc import OP_CODES

    code = OP_CODES[op.name]
    rid, st = _submit(comm, x.device, x, shape[1:], x.dtype, lambda h, a, o:
                      runtime.host_ireduce_scatter(h, a, code, out=o))
    return Request("ireduce_scatter", "proc", rid, st), token


@publishes_token
def isend(x, dest, tag=0, *, comm=None, token=None):
    """Nonblocking send: ``(request, token)`` at once.  The wait returns
    None, once the payload has left this rank's send path."""
    comm = check_comm(comm)
    _check_async_backend(comm, "isend")
    token = as_token(token)
    x = torch.as_tensor(x).detach()
    dest = check_rank_range(dest, "dest", comm.size)
    tag = int(tag)
    if comm.backend == "self":
        raise NotImplementedError(
            "isend on the self backend has no peer to receive; use the "
            "proc backend (a launched multi-process job)"
        )
    from mpi4jax_tpu_torch.native import runtime

    rid, st = _submit(comm, x.device, x, None, None, lambda h, a, o:
                      runtime.host_isend(h, a, dest, tag))
    return Request("isend", "proc", rid, st), token


@publishes_token
def irecv(x, source=ANY_SOURCE, tag=ANY_TAG, *, comm=None, token=None):
    """Nonblocking receive into the shape and dtype of the template
    ``x``; the result lands on ``x``'s device.  The request parks in the
    engine until a matching message comes, so collectives submitted
    after it still progress.  :func:`wait` returns the tensor."""
    comm = check_comm(comm)
    _check_async_backend(comm, "irecv")
    token = as_token(token)
    x = torch.as_tensor(x)
    if source != ANY_SOURCE:
        source = check_rank_range(source, "source", comm.size)
    tag = int(tag)
    if comm.backend == "self":
        raise NotImplementedError(
            "irecv on the self backend has no peer to receive from; use "
            "the proc backend (a launched multi-process job)"
        )
    from mpi4jax_tpu_torch.native import runtime

    rid, st = _submit(comm, x.device, None, x.shape, x.dtype,
                      lambda h, a, o: runtime.host_irecv(h, o, source, tag))
    return Request("irecv", "proc", rid, st), token


# ---------------------------------------------------------------- waits


@publishes_token
def wait(req, *, token=None, status=None):
    """Complete a request: ``(result, token)``.

    ``result`` is the reduced tensor (iallreduce), the row block
    (ireduce_scatter), the received tensor (irecv), or None (isend).
    For an irecv, ``status`` (a :class:`~mpi4jax_tpu_torch.ops.p2p.
    Status`) receives the matched source and tag.  A request may be
    waited exactly once."""
    if not isinstance(req, Request):
        raise TypeError(f"wait expects a Request, got {type(req)}")
    _mark_consumed(req, "wait")
    token = as_token(token)
    if req.backend == "self":
        return req.payload, token
    from mpi4jax_tpu_torch.native import runtime

    out, src, tag = runtime.host_wait(req.payload)
    st, req.staging = req.staging, None
    if status is not None and req.kind == "irecv":
        status.source, status.tag = src, tag
    if req.kind == "isend":
        return None, token
    return st.back(out), token


def waitall(reqs, *, token=None):
    """Complete requests in order: ``(results, token)``, one result per
    request (None for an isend).  ``reqs`` may be any iterable."""
    token = as_token(token)
    results = []
    for req in tuple(reqs):
        value, token = wait(req, token=token)
        results.append(value)
    return results, token


@publishes_token
def test(req, *, token=None):
    """Nonblocking completion probe: ``(done, token)``, ``done`` a 0-d
    bool tensor.  The request is not consumed: :func:`wait` fetches the
    result (at once, once ``done`` is true)."""
    if not isinstance(req, Request):
        raise TypeError(f"test expects a Request, got {type(req)}")
    token = as_token(token)
    if req.backend == "self":
        return torch.tensor(True), token
    from mpi4jax_tpu_torch.native import runtime

    return torch.tensor(runtime.host_test(req.payload)), token


def assert_requests_drained():
    """Raise if this process holds requests that were submitted and
    never waited."""
    from mpi4jax_tpu_torch.native import runtime

    runtime.async_assert_drained()
