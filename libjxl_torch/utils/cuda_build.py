"""Build and load the port's CUDA kernels (``libjxl_torch/csrc/*.cu``).

Each source compiles with nvcc for Hopper (``sm_90a``) into a shared
library with a plain C interface, bound with ``ctypes``. Builds happen at
first use, into ``libjxl_torch/build/`` (not committed), keyed by a hash
of the source and the flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{cuda_home}/bin): the CUDA kernels cannot be built")


def build(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists.
    Returns (shared library path, nvcc's -Xptxas -v report)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                             ).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"{name}_{key}.so")
    log_path = so_path + ".log"
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        with open(log_path, "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, so_path)
    with open(log_path) as f:
        return so_path, f.read()


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built on first call."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build(name)[0])
        return lib
