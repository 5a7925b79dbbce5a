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
from mpi4jax_tpu_torch.parallel.proc import ProcComm, ProcGridComm, grid_comm
from mpi4jax_tpu_torch.parallel import moe
from mpi4jax_tpu_torch.parallel.moe import (
    expert_combine,
    expert_dispatch,
    topk_moe,
    topk_route,
)
from mpi4jax_tpu_torch.parallel.longseq import (
    local_attention,
    ring_attention,
    ulysses_attention,
    zigzag_indices,
    zigzag_shard,
    zigzag_unshard,
)

__all__ = [
    "moe",
    "Comm",
    "MeshComm",
    "SelfComm",
    "default_comm",
    "get_default_comm",
    "set_default_comm",
    "halo_exchange_2d",
    "halo_exchange_2d_batch",
    "ProcComm",
    "ProcGridComm",
    "grid_comm",
    "local_attention",
    "ring_attention",
    "ulysses_attention",
    "zigzag_indices",
    "zigzag_shard",
    "zigzag_unshard",
    "expert_dispatch",
    "expert_combine",
    "topk_moe",
    "topk_route",
]
