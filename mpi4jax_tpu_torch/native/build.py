"""Build the native DCN bridge for the PyTorch port.

    python -m mpi4jax_tpu_torch.native.build

The port's library holds the bridge's two XLA-free sources, compiled
where they stand (``mpi4jax_tpu/native/src/dcn.cc`` and ``shm.cc``), and
the port's own C shim (``csrc/t4j_capi.cc``: the plain-C API of
``ffi.cc`` without its XLA handlers), so it needs g++ and nothing of
jaxlib.  It never loads the JAX package's ``_t4j_dcn.so``.

The flags are ``-O3 -fPIC -shared -std=c++17`` with ``-march=native``
tried first and dropped where the compiler refuses it (as
``mpi4jax_tpu/native/build.py`` does); ``$CXX`` overrides ``g++``.  The
library goes to ``mpi4jax_tpu_torch/_build/<key>/`` where the key hashes
the sources, the bridge's headers, the flags and this machine's CPU
flags (``-march=native`` code is this machine's).  A file lock
serialises builds across processes (the ranks of a launcher job, xdist
workers) and a thread lock across the threads of one.  A failed build
raises with the compiler's output.  The first build takes about 30 s.
"""

import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading
import time

__all__ = ["SOURCES", "FLAGS", "ensure_built", "build_seconds",
           "library_dir"]

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
BRIDGE_SRC = PACKAGE.parent / "mpi4jax_tpu" / "native" / "src"
SHIM = pathlib.Path(__file__).resolve().parent / "csrc" / "t4j_capi.cc"
SOURCES = (BRIDGE_SRC / "dcn.cc", BRIDGE_SRC / "shm.cc", SHIM)
HEADERS = tuple(BRIDGE_SRC / h for h in ("dcn.h", "shm.h", "telemetry.h"))
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-lpthread", "-lrt")
BUILD_ROOT = PACKAGE / "_build"
LIB_NAME = "libt4j_bridge.so"

_lock = threading.Lock()
_state = {"path": None, "seconds": 0.0}


def _cxx():
    return os.environ.get("CXX") or "g++"


def _cpu_flags():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    import platform

    return platform.machine()


def library_dir():
    """``_build/<key>/``: the key hashes the sources, the headers, the
    compiler, the flags and the CPU flags."""
    h = hashlib.sha256()
    for path in (*SOURCES, *HEADERS):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join((_cxx(), *FLAGS, "-march=native", *LIBS)).encode())
    h.update(_cpu_flags().encode())
    return BUILD_ROOT / f"t4j_{h.hexdigest()[:16]}"


def build_seconds():
    """Wall seconds this process spent compiling the bridge (0.0 when an
    earlier process had built it)."""
    return _state["seconds"]


def _compile(out_dir, lib_path):
    tmp = out_dir / f"{LIB_NAME}.tmp{os.getpid()}"
    proc = None
    t0 = time.perf_counter()
    for extra in (("-march=native",), ()):
        cmd = [_cxx(), *FLAGS[:1], *extra, *FLAGS[1:],
               f"-I{BRIDGE_SRC}", *map(str, SOURCES), "-o", str(tmp), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode == 0:
            break
    _state["seconds"] = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the native bridge failed to build ({_cxx()} exit "
            f"{proc.returncode}):\n{proc.stderr[-6000:]}{proc.stdout[-2000:]}"
        )
    os.replace(tmp, lib_path)


def ensure_built():
    """Path of the bridge library, built first if this tree has none."""
    with _lock:
        if _state["path"] is not None:
            return _state["path"]
        out_dir = library_dir()
        lib_path = out_dir / LIB_NAME
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not lib_path.exists():
                    _compile(out_dir, lib_path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
        _state["path"] = lib_path
        return lib_path


if __name__ == "__main__":
    path = ensure_built()
    print(f"built {path} in {build_seconds():.1f} s")
