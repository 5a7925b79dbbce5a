"""Runnable examples (``python -m mpi4jax_tpu_torch.examples.<name>``)."""
