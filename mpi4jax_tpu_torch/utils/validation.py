"""Argument validation for the public ops and the kernel launchers.

Counterpart of ``mpi4jax_tpu/utils/validation.py``.  PyTorch runs
eagerly, so there are no traced values to reject; the check that takes
their place is the one against a tensor passed where a Python integer
(a rank, a tag, a root) is expected.  The tensor checks at the end are
the dtype, device and shape contracts that the ops and the hand-written
kernels rely on.
"""

import numpy as np
import torch

__all__ = [
    "check_static_int",
    "check_comm",
    "check_op",
    "check_same_layout",
    "check_kernel_fields",
]


def check_static_int(value, name, allow_none=False):
    """Validate an integer parameter (root, tag, source, dest...)."""
    if value is None and allow_none:
        return None
    if isinstance(value, torch.Tensor):
        raise TypeError(
            f"{name} must be a Python integer, got a tensor; call .item() "
            "if the value really is known on the host"
        )
    if isinstance(value, (bool, np.bool_)):
        raise TypeError(f"{name} must be an integer, got bool")
    if isinstance(value, (int, np.integer)):
        return int(value)
    raise TypeError(f"{name} must be an integer, got {type(value).__name__}")


def check_comm(comm):
    from mpi4jax_tpu_torch.parallel.comm import Comm, get_default_comm

    if comm is None:
        return get_default_comm()
    if not isinstance(comm, Comm):
        raise TypeError(
            f"comm must be an mpi4jax_tpu_torch communicator "
            f"(MeshComm / SelfComm), got {type(comm).__name__}"
        )
    return comm


def check_op(op):
    from mpi4jax_tpu_torch.ops.reductions import Op, named_op

    if isinstance(op, Op):
        return op
    if isinstance(op, str):
        return named_op(op)
    raise TypeError(
        f"op must be an mpi4jax_tpu_torch Op (e.g. reductions.SUM) or an op "
        f"name, got {type(op).__name__}"
    )


def check_same_layout(a, b, what):
    """Two buffers that must agree in shape and dtype (a sendrecv on a
    grid communicator moves one uniform buffer per rank)."""
    if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
        raise ValueError(
            f"{what} requires uniform send/recv shapes and dtypes, got "
            f"{tuple(a.shape)}/{a.dtype} vs {tuple(b.shape)}/{b.dtype}"
        )


def check_kernel_fields(name, fields, *, device_type):
    """The contract of a hand-written kernel's launcher: every field is
    a contiguous float32 tensor of one shape on one device of
    ``device_type``.  Raises with the offending field's name."""
    first = next(iter(fields.values()))
    for fname, t in fields.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {fname} must be a tensor")
        if t.device.type != device_type or t.device != first.device:
            raise ValueError(
                f"{name}: {fname} is on {t.device}, expected every field "
                f"on one {device_type} device ({first.device})"
            )
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {fname} must be float32, got {t.dtype}")
        if t.dim() != 2 or tuple(t.shape) != tuple(first.shape):
            raise ValueError(
                f"{name}: {fname} has shape {tuple(t.shape)}, expected "
                f"{tuple(first.shape)} like the other fields"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {fname} must be contiguous")
    return first
