"""Hand-written CUDA kernels for Hopper, built at first use.

Each kernel's CUDA source lives in `wenet_tpu_torch/csrc/`.  It is compiled
with nvcc for sm_90a into a shared library with a plain C interface, keyed by
a hash of the source, under `build/wenet_tpu_torch/` at the repository root,
and bound with ctypes.  `build` starts one nvcc per missing library, all at
once.  Nothing is compiled or loaded when a module is imported, so the
package imports on a machine without CUDA or nvcc.
"""
from __future__ import annotations

import contextlib
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
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # nvcc's output (ptxas registers, spills)


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


def build(*names: str) -> list[ctypes.CDLL]:
    """Build (where needed) and load `csrc/<name>.cu` for each name, with
    one nvcc process per missing library, all started together; raises if
    any build fails."""
    with _lock:
        jobs = []
        for name in names:
            if name in _libs:
                continue
            src = os.path.join(CSRC, f"{name}.cu")
            with open(src, "rb") as f:
                digest = hashlib.sha1(
                    f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
            proc = tmp = None
            if not os.path.exists(out):
                nvcc = nvcc_path()
                if nvcc is None:
                    raise RuntimeError(f"cannot build {name}: nvcc not found")
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, src, out, tmp, proc))
        failed = []
        for name, src, out, tmp, proc in jobs:
            if proc is not None:
                log = proc.communicate()[0]
                build_logs[name] = log
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {src}:\n{log}")
                    continue
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, _, out, _, _ in jobs:
            _libs[name] = ctypes.CDLL(out)
        return [_libs[name] for name in names]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; raises on failure."""
    return build(name)[0]


def launch_context(device: torch.device):
    """(context, raw stream pointer) for a launch on `device`: the device
    made current only where it is not already, and its current stream as
    an integer, without building a Stream object."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    ctx = (contextlib.nullcontext() if index == current
           else torch.cuda.device(index))
    return ctx, torch._C._cuda_getCurrentRawStream(index)
