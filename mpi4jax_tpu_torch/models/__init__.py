"""Workloads of the PyTorch port (counterparts of
``mpi4jax_tpu.models``)."""

from mpi4jax_tpu_torch.models import moe_transformer

__all__ = ["moe_transformer"]
