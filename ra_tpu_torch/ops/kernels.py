"""Build and load the package's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``ra_tpu_torch/csrc/`` with a
plain C entry point. At first use it is compiled with ``nvcc`` for
``sm_90a`` into ``ra_tpu_torch/_build/`` (listed in ``.gitignore``),
keyed on a hash of the source, and loaded with ``ctypes``. Nothing is
built at import time, and a failed build raises: no caller falls back
to a plain version because a kernel is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> seconds the nvcc build took in this process (0.0 when cached)
BUILD_SECONDS: Dict[str, float] = {}
# name -> what nvcc/ptxas printed (registers, spills) for the build
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into a shared library (once per source
    hash) and return its path."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(ARCH_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        BUILD_SECONDS.setdefault(name, 0.0)
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial .so
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOG[name] = (proc.stdout + proc.stderr).strip()
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
