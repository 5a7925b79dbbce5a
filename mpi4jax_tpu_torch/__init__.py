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
run instead.  A grid of ranks runs over ``torch.distributed``
(``parallel/distributed.py``: NCCL across the cards of a host under
torchrun, gloo on the CPU or in a local world of thread ranks), or as
the OS processes of a launcher job over the native DCN bridge
(``python -m mpi4jax_tpu_torch.launch -np N prog.py``: ``ProcComm``,
the proc tier, CUDA tensors staged through host memory), where the
nonblocking requests (``iallreduce``, ``isend``, ``wait`` ...) and the
bucketed gradient sync (``BucketedGradSync``) overlap communication with
the program's compute, and where ``serving/`` runs the continuous-
batching inference engine tensor-parallel across the ranks; see
ROADMAP.md for what is still to be ported.
"""

import torch as _torch

from mpi4jax_tpu_torch.native.runtime import WorldResized
from mpi4jax_tpu_torch.ops import *  # noqa: F401,F403
from mpi4jax_tpu_torch.ops import __all__ as _ops_all
from mpi4jax_tpu_torch.parallel import *  # noqa: F401,F403
from mpi4jax_tpu_torch.parallel import __all__ as _parallel_all

__all__ = [*_ops_all, *_parallel_all, "WorldResized", "has_cuda_support",
           "has_tpu_support"]


def __getattr__(name):
    # lazy: the version may come from git, which the import should not wait on
    if name == "__version__":
        from mpi4jax_tpu_torch._version import get_version

        version = get_version()
        globals()["__version__"] = version
        return version
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def has_cuda_support():
    """True if a CUDA card is live (the reference mpi4jax's capability
    probe: the ops take CUDA tensors, over NCCL across cards)."""
    return _torch.cuda.is_available() and _torch.cuda.device_count() > 0


def has_tpu_support():
    """Always False: the port runs on PyTorch, which drives no TPU.  Kept
    for call-compatibility with the JAX package's probe."""
    return False
