"""Workloads of the PyTorch port (counterparts of
``mpi4jax_tpu.models``)."""
