"""mpi4jax_tpu_torch — the PyTorch and CUDA port of ``mpi4jax_tpu``.

A second package beside the JAX one, for NVIDIA Hopper cards: MPI-style
communication ops on torch tensors with the JAX package's call surface
(tokens included), the shallow-water flagship solver whose step runs
through hand-written CUDA kernels (``kernels/csrc/sw_step.cu``), and
greedy decoding of the transformer whose long-prompt prefill runs a
hand-written CUDA flash-attention kernel (``kernels/csrc/flash_fwd.cu``).
It never imports JAX or the JAX package.

Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``, where the plain PyTorch versions of the kernels
run instead.  This slice runs one rank; see ROADMAP.md for what is
still to be ported.
"""

from mpi4jax_tpu_torch.ops import *  # noqa: F401,F403
from mpi4jax_tpu_torch.ops import __all__ as _ops_all
from mpi4jax_tpu_torch.parallel import *  # noqa: F401,F403
from mpi4jax_tpu_torch.parallel import __all__ as _parallel_all

__all__ = [*_ops_all, *_parallel_all]
