"""Communicators and halo exchange of the PyTorch port (counterparts of
``mpi4jax_tpu.parallel``)."""

from mpi4jax_tpu_torch.parallel.comm import (
    Comm,
    MeshComm,
    SelfComm,
    default_comm,
    get_default_comm,
    set_default_comm,
)
from mpi4jax_tpu_torch.parallel.halo import (
    halo_exchange_2d,
    halo_exchange_2d_batch,
)
from mpi4jax_tpu_torch.parallel.longseq import local_attention

__all__ = [
    "Comm",
    "MeshComm",
    "SelfComm",
    "default_comm",
    "get_default_comm",
    "set_default_comm",
    "halo_exchange_2d",
    "halo_exchange_2d_batch",
    "local_attention",
]
