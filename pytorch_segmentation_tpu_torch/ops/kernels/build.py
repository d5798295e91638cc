"""Build a kernel source under `csrc/` with nvcc and load it with ctypes.

Each `.cu` file exposes a plain C interface (no PyTorch headers), so one
nvcc call builds it in seconds. The shared library goes to `build/kernels/`
at the root of the checkout (listed in `.gitignore`), under a name that
carries a hash of the source and the flags: an edited source is rebuilt and
never confused with an old library. Building happens at the first call of a
kernel's wrapper, never at import, so the CPU-only test run imports this
module without a CUDA toolkit. Different sources build side by side: each
has its own lock, so threads that ask for different kernels run their nvcc
processes together: a run that builds every kernel at its start (the smoke
run, whose time is limited while the number of kernels grows with the port)
then waits for the slowest source, not for the sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_kernel_library", "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS",
           "LINK_FLAGS", "BUILD_LOGS"]

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# after the source on the link line: libcuda, for
# cuTensorMapEncodeTiled (the TMA descriptors of fused_matmul_bn.cu)
LINK_FLAGS = ("-lcuda",)
# name -> what nvcc printed when this process built the source (ptxas -v:
# registers, shared memory and spills of each kernel); absent for a library
# that was already on disk
BUILD_LOGS: dict[str, str] = {}

_registry_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    toolkit = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(toolkit, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` (once per source and flag set) and return
    the loaded library. Raises if the build fails."""
    with _registry_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS + LINK_FLAGS).encode()
                                ).hexdigest()[:16]
        lib_path = BUILD_DIR / f"{name}-{digest}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src), *LINK_FLAGS]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {src.name} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
            BUILD_LOGS[name] = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(lib_path))
        _loaded[name] = lib
        return lib
