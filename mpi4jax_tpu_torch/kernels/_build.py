"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes plain ``extern "C"`` launchers (raw
pointers, sizes, scalars and a ``cudaStream_t``; they return the
``cudaError_t`` of the launch).  It is compiled at first use with
``nvcc -shared`` for ``sm_90a`` and loaded with ``ctypes``: no PyTorch
headers are compiled, so a build takes seconds, and no ``ninja`` is
needed.

Builds go to ``mpi4jax_tpu_torch/_build/<key>/`` where the key hashes
the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  A file lock serialises concurrent builds across processes, a thread
lock across the threads of one.
A failed build raises with nvcc's output.
"""

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["NVCC_FLAGS", "load_library", "library_dir", "build_seconds"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "_build"

# No --use_fast_math: the kernels divide (potential vorticity) and their
# tolerances against the plain versions assume IEEE division.  No FMA
# contraction either (-fmad=false): the plain versions round every
# product and sum on its own, and the y-momentum tendency is a small
# difference of large terms (geostrophic balance), where one ulp of a
# term is more than 1e-6 of the updated v.  The kernels are bound by
# memory, so the extra instructions cost nothing measurable.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3",
    "-fmad=false",
    "-std=c++17",
    "-Xptxas", "-v",
    "-shared",
    "-Xcompiler", "-fPIC",
)

_loaded = {}
_build_seconds = {}
_locks = {}
_locks_lock = threading.Lock()


def _nvcc():
    """Path of nvcc: on PATH, else under CUDA_HOME as PyTorch finds it."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        candidate = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels are "
        "built from source at first use and need the CUDA toolkit"
    )


def _key(source):
    h = hashlib.sha256()
    h.update(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_seconds(name):
    """Wall seconds this process spent building ``name`` (0.0 when the
    library was already built by an earlier process)."""
    return _build_seconds.get(name, 0.0)


def library_dir(name):
    """Build directory of ``csrc/<name>.cu``; holds ``build.log``, with
    ptxas's register and spill report, once it is built."""
    return BUILD_ROOT / _key(CSRC / f"{name}.cu")


def load_library(name):
    """Build (if needed) and load ``csrc/<name>.cu``; returns the
    ``ctypes.CDLL``.  Threads of one process that ask for one library at
    once (the ranks of a local world) wait for one build and share it;
    different libraries build side by side."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        return _load(name)


def _load(name):
    if name in _loaded:
        return _loaded[name]
    source = CSRC / f"{name}.cu"
    out_dir = library_dir(name)
    lib_path = out_dir / f"lib{name}.so"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib_path.exists():
                _compile(name, source, out_dir, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    lib = ctypes.CDLL(str(lib_path))
    _loaded[name] = lib
    return lib


def _compile(name, source, out_dir, lib_path):
    tmp = out_dir / f"lib{name}.so.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    _build_seconds[name] = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source.name} (exit {proc.returncode}):\n"
            f"{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, lib_path)
