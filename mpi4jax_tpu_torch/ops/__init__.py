"""Communication ops of the PyTorch port (counterparts of
``mpi4jax_tpu.ops``)."""

from mpi4jax_tpu_torch.ops._core import (
    ANY_SOURCE,
    ANY_TAG,
    Token,
    as_token,
    create_token,
)
from mpi4jax_tpu_torch.ops.allreduce import allreduce
from mpi4jax_tpu_torch.ops.collectives import allgather, scan
from mpi4jax_tpu_torch.ops.p2p import Status, sendrecv
from mpi4jax_tpu_torch.ops.reductions import (
    BAND,
    BOR,
    BXOR,
    LAND,
    LOR,
    LXOR,
    MAX,
    MIN,
    PROD,
    SUM,
    Op,
)

__all__ = [
    "ANY_SOURCE",
    "ANY_TAG",
    "Token",
    "as_token",
    "create_token",
    "allreduce",
    "allgather",
    "scan",
    "Status",
    "sendrecv",
    "Op",
    "SUM",
    "PROD",
    "MIN",
    "MAX",
    "LAND",
    "LOR",
    "LXOR",
    "BAND",
    "BOR",
    "BXOR",
]
