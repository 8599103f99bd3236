"""Host runtime in C (counterpart of wenet_tpu/native): the UW acquisition
FSM `uw_detect` and the sample conversions `cu8_to_c64` and `cs16_to_c64`
of `csrc/deframe_fsm.c`.

The library is built at first use with the host C compiler (`cc`, else
`gcc`; `-O3 -shared -fPIC`) into `build/wenet_tpu_torch/` beside the CUDA
kernels (`kernels.BUILD_DIR`), keyed by a hash of the source and the
flags, written to a per-process temporary file and renamed into place, so
that processes building at once never load a half-written library; it is
bound with ctypes.  Importing this module compiles nothing.  There is no
fallback: a missing compiler or a failed build raises with the compiler's
output.  `available()` only tells whether a C compiler is on PATH.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

from ..kernels import BUILD_DIR, CSRC

SOURCE = os.path.join(CSRC, "deframe_fsm.c")
CFLAGS = ["-O3", "-shared", "-fPIC"]
MAX_UW = 64                   # uw_detect's bit buffer

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # the last build's compile time, if any


def compiler() -> str | None:
    """The host C compiler: `cc`, else `gcc`, on PATH."""
    return shutil.which("cc") or shutil.which("gcc")


def available() -> bool:
    """True where the library can be built: a C compiler is on PATH."""
    return compiler() is not None


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(
            f.read() + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libdeframe_fsm_{digest}.so")


def load() -> ctypes.CDLL:
    """Build (where needed) and load the library; raises if the compiler
    is missing or the build fails."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not os.path.exists(out):
            cc = compiler()
            if cc is None:
                raise RuntimeError(f"cannot build {SOURCE}: no C compiler "
                                   "(cc or gcc) on PATH")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([cc, *CFLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cc} failed for {SOURCE}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(out)
        from numpy.ctypeslib import ndpointer
        lib.uw_detect.restype = ctypes.c_long
        lib.uw_detect.argtypes = [
            ndpointer(ctypes.c_uint8, flags="C_CONTIGUOUS"), ctypes.c_long,
            ndpointer(ctypes.c_uint8, flags="C_CONTIGUOUS"), ctypes.c_int,
            ctypes.c_int, ctypes.c_long,
            ndpointer(ctypes.c_int8, flags="C_CONTIGUOUS"),
            ndpointer(ctypes.c_int64, flags="C_CONTIGUOUS"), ctypes.c_long,
            ndpointer(ctypes.c_int8, flags="C_CONTIGUOUS")]
        for name, ctype in (("cu8_to_c64", ctypes.c_uint8),
                            ("cs16_to_c64", ctypes.c_int16)):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ndpointer(ctype, flags="C_CONTIGUOUS"),
                           ctypes.c_long,
                           ndpointer(ctypes.c_float, flags="C_CONTIGUOUS")]
        _lib = lib
        return lib


def uw_detect(bits: np.ndarray, uw: np.ndarray, allowed: int, syms: int,
              init_buffer: np.ndarray):
    """The C acquisition FSM over the hard decisions `bits` (0 or 1, one
    byte each) -> (positions int64[], final_buffer int8[]): UW-end
    indices, and the bit buffer after the last detection (at the stream's
    end where there was none)."""
    lib = load()
    bits = np.ascontiguousarray(bits).view(np.uint8)
    uw = np.ascontiguousarray(uw, np.uint8)
    init = np.ascontiguousarray(init_buffer, np.int8)
    if not 0 < len(uw) <= MAX_UW or len(init) != len(uw):
        raise ValueError(f"uw of 1..{MAX_UW} bits and an init buffer of "
                         f"its length (got {len(uw)}, {len(init)})")
    # a detection and its packet take syms + 1 symbols
    max_out = max(len(bits) // (syms + 1) + 2, 16)
    out = np.zeros(max_out, np.int64)
    final = np.zeros(len(uw), np.int8)
    n = lib.uw_detect(bits, len(bits), uw, len(uw), allowed, syms, init,
                      out, max_out, final)
    return out[:n].copy(), final


def cu8_to_c64(raw: np.ndarray) -> np.ndarray:
    """Interleaved cu8 IQ bytes -> complex64, (x - 127) / 128."""
    lib = load()
    raw = np.ascontiguousarray(raw, np.uint8)
    out = np.empty(len(raw) // 2 * 2, np.float32)
    lib.cu8_to_c64(raw, len(raw) // 2, out)
    return out.view(np.complex64)


def cs16_to_c64(raw: np.ndarray) -> np.ndarray:
    """Interleaved cs16 IQ -> complex64, / 825 (FDMDV_SCALE)."""
    lib = load()
    raw = np.ascontiguousarray(raw, np.int16)
    out = np.empty(len(raw) // 2 * 2, np.float32)
    lib.cs16_to_c64(raw, len(raw) // 2, out)
    return out.view(np.complex64)
