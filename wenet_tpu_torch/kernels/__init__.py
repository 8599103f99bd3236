"""Hand-written CUDA kernels for Hopper, built at first use.

Each kernel's CUDA source lives in `wenet_tpu_torch/csrc/`.  It is compiled
with nvcc for sm_90a into a shared library with a plain C interface, keyed by
a hash of the source, under `build/wenet_tpu_torch/` at the repository root,
and bound with ctypes.  Nothing is compiled or loaded when a module is
imported, so the package imports on a machine without CUDA or nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "wenet_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str | None:
    """nvcc on PATH, under CUDA_HOME, or at /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def available() -> bool:
    """True where the kernels can be built and launched: a CUDA device and
    nvcc."""
    return torch.cuda.is_available() and nvcc_path() is not None


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; raises on failure."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha1(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
        if not os.path.exists(out):
            nvcc = nvcc_path()
            if nvcc is None:
                raise RuntimeError(f"cannot build {name}: nvcc not found")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _libs[name] = lib
        return lib
