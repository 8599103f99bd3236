"""Wrapper of the persistent demod frame-loop kernel (`csrc/fsk_demod.cu`).

The kernel replaces the scan body of `wenet_tpu/ops/fsk.py::demod_stream`
(an XLA `lax.scan` on the TPU); its plain version is
`wenet_tpu_torch.ops.fsk.demod_stream_reference` (and
`demod_lanes_reference` over lanes).  `ops.fsk.demod_raw` takes the plain
version for CPU tensors; `demod` here takes CUDA tensors only and launches
the kernel or raises.

One block per lane walks the lane's frames with the demod state in shared
memory.  The lanes read one raw buffer (cu8 or cs16 pairs, or float32
pairs) at their own start offsets, so a fused slab's chunks need no copy.
The kernel reads the plain version's own tables (Hann window, the float64
-built DFT matrix, the timing spin) from `ops.fsk._constants` and
`utils.compat._dft_matrix`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import fsk
from ..utils import compat
from . import load

FORMATS = {"c64": 0, "cu8": 1, "cs16": 2}
RAW_DTYPES = {"c64": torch.float32, "cu8": torch.uint8, "cs16": torch.int16}

launches = 0          # kernel launches, counted where the launch succeeds

_INT_FIELDS = ("lanes", "num_frames", "fmt", "Ts", "P", "S", "M", "Nsym",
               "Nmem", "N", "Ndft", "half", "NP", "Nbits", "f_min_bin",
               "f_max_bin", "f_zero_bins")
_FLOAT_FIELDS = ("tc", "one_m_tc", "bin_hz", "inv_fs", "two_pi", "two_pi_fs",
                 "cs16_scale", "half_pi", "pi")
_STATE_IN = ("pos_in", "nin_in", "fft_in", "fest_in", "phi_in", "norm_in",
             "ppm_in", "ebno_in", "snr_in")
_STATE_OUT = tuple(f.replace("_in", "_out") for f in _STATE_IN)
_FRAME_OUT = ("soft", "bits", "valid", "o_fest", "o_ebno", "o_norm", "o_ppm",
              "o_nin")


class Geom(ctypes.Structure):
    """`DemodGeom` of csrc/fsk_demod.cu."""
    _fields_ = ([("n_total", ctypes.c_longlong)]
                + [(f, ctypes.c_int) for f in _INT_FIELDS]
                + [(f, ctypes.c_float) for f in _FLOAT_FIELDS]
                + [("atan_c", ctypes.c_float * 9)])


class Ptrs(ctypes.Structure):
    """`DemodPtrs` of csrc/fsk_demod.cu."""
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "data", "starts", "n_valid", "hann", "dft", "spin_re", "spin_im",
        *_STATE_IN, *_STATE_OUT, *_FRAME_OUT)]


@functools.lru_cache(maxsize=1)
def _lib():
    lib = load("fsk_demod")
    P = ctypes.c_void_p
    lib.fsk_demod_launch.restype = ctypes.c_int
    lib.fsk_demod_launch.argtypes = [ctypes.POINTER(Geom),
                                     ctypes.POINTER(Ptrs), P]
    lib.fsk_demod_smem_bytes.restype = ctypes.c_int
    lib.fsk_demod_smem_bytes.argtypes = [ctypes.POINTER(Geom)]
    return lib


def build():
    """Build and load the kernel now (it is otherwise built at first use)."""
    _lib()


def geometry(cfg: fsk.FSKConfig, fmt: str, lanes: int, num_frames: int,
             n_total: int) -> Geom:
    """The kernel's geometry and float32 constants, each formed as the
    plain version forms it (numpy float32 scalars)."""
    two_pi = np.float32(fsk.TWO_PI)
    inv_fs = np.float32(1.0 / cfg.Fs)
    tc = np.float32(cfg.ema_tc)
    ints = dict(lanes=lanes, num_frames=num_frames, fmt=FORMATS[fmt],
                Ts=cfg.Ts, P=cfg.P, S=cfg.Ts // cfg.P, M=cfg.M,
                Nsym=cfg.Nsym, Nmem=cfg.Nmem, N=cfg.N, Ndft=cfg.Ndft,
                half=cfg.Ndft // 2, NP=(cfg.Nsym + 1) * cfg.P,
                Nbits=cfg.Nbits, f_min_bin=cfg.f_min_bin,
                f_max_bin=cfg.f_max_bin, f_zero_bins=cfg.f_zero_bins)
    floats = dict(tc=tc, one_m_tc=np.float32(1) - tc,
                  bin_hz=np.float32(cfg.Fs / cfg.Ndft), inv_fs=inv_fs,
                  two_pi=two_pi, two_pi_fs=two_pi * inv_fs,
                  cs16_scale=np.float32(1.0 / fsk.FDMDV_SCALE),
                  half_pi=np.float32(np.pi / 2), pi=np.float32(np.pi))
    g = Geom(n_total=n_total, **ints,
             **{k: float(v) for k, v in floats.items()})
    g.atan_c[:] = [float(np.float32(c)) for c in compat._atan_coeffs()]
    return g


def smem_bytes(geom: Geom) -> int:
    """Dynamic shared memory of one block (asks the built kernel)."""
    return _lib().fsk_demod_smem_bytes(ctypes.byref(geom))


def _tables(cfg: fsk.FSKConfig, device: torch.device):
    consts = fsk._constants(cfg, device)
    dft = compat._dft_matrix(cfg.Ndft, cfg.Ndft // 2, device)
    return consts["hann"], dft, consts["spin_re"], consts["spin_im"]


def _check(t: torch.Tensor, name: str, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"fsk_demod: {name} needs a CUDA tensor, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"fsk_demod: {name} needs {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fsk_demod: {name} needs shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fsk_demod: {name} needs a contiguous tensor")


def demod(cfg: fsk.FSKConfig, data: torch.Tensor, fmt: str, num_frames: int,
          starts: torch.Tensor, n_valid: torch.Tensor,
          state: fsk.DemodState | None = None):
    """Launch the frame loop on L lanes of one raw buffer.

    data: (n, 2) contiguous CUDA tensor of raw pairs (uint8 for cu8, int16
    for cs16, float32 for c64).  starts, n_valid: (L,) int64 on the same
    device: lane l reads data[starts[l] + i], zero outside [0, n_valid[l])
    and past the buffer, and its frames are valid while pos + nin <=
    n_valid[l].  state: lane-stacked DemodState, or None for the initial
    one.  Returns (final DemodState, FrameOut) with a leading lane axis;
    frames past a lane's end are invalid with zeroed fields.
    """
    global launches
    if fmt not in FORMATS:
        raise ValueError(f"fsk_demod: unknown sample format {fmt!r}")
    if data.dim() != 2:
        raise ValueError("fsk_demod: data needs shape (n, 2)")
    dev = data.device
    _check(data, "data", RAW_DTYPES[fmt], (data.shape[0], 2))
    L = starts.shape[0]
    _check(starts, "starts", torch.int64, (L,))
    _check(n_valid, "n_valid", torch.int64, (L,))
    M, half, nbits = cfg.M, cfg.Ndft // 2, cfg.Nbits
    if state is None:
        state = fsk.lane_state(fsk.demod_init(cfg, dev), L)
    shapes = {"pos": (L,), "nin": (L,), "fft_est": (L, half), "f_est": (L, M),
              "phi": (L, M)}
    state_in = []
    for name, t in zip(fsk.DemodState._fields, state):
        dtype = torch.int32 if name in ("pos", "nin") else torch.float32
        t = t.contiguous()
        _check(t, f"state.{name}", dtype, shapes.get(name, (L,)))
        state_in.append(t)
    final = fsk.DemodState(*(torch.empty_like(t) for t in state_in))

    def new(*shape, dtype=torch.float32):
        return torch.empty((L, num_frames, *shape), dtype=dtype, device=dev)
    outs = fsk.FrameOut(
        soft=new(nbits), bits=new(nbits, dtype=torch.uint8),
        valid=new(dtype=torch.bool), f_est=new(M), ebno_db=new(),
        norm_rx_timing=new(), ppm=new(), nin=new(dtype=torch.int32))

    geom = geometry(cfg, fmt, L, num_frames, data.shape[0])
    tables = _tables(cfg, dev)
    ptrs = Ptrs(*(t.data_ptr() for t in (
        data, starts, n_valid, *tables, *state_in, *final,
        outs.soft, outs.bits, outs.valid, outs.f_est, outs.ebno_db,
        outs.norm_rx_timing, outs.ppm, outs.nin)))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fsk_demod_launch(ctypes.byref(geom), ctypes.byref(ptrs),
                                  stream)
    if rc != 0:
        raise RuntimeError(f"fsk_demod launch failed ({L} lanes, "
                           f"{num_frames} frames): cudaError_t {rc}")
    launches += L > 0
    return final, outs
