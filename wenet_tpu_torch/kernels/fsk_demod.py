"""Wrapper of the persistent demod frame-loop kernel (`csrc/fsk_demod.cu`).

The kernel replaces the scan body of `wenet_tpu/ops/fsk.py::demod_stream`
(an XLA `lax.scan` on the TPU); its plain version is
`wenet_tpu_torch.ops.fsk.demod_stream_reference` (and
`demod_lanes_reference` over lanes).  `ops.fsk.demod_raw` takes the plain
version for CPU tensors; `demod` here takes CUDA tensors only and launches
the kernel or raises.

Two paths compute the same outputs, bit for bit.  The lane path: one
block per lane walks the lane's frames with the demod state in shared
memory.  The frame-parallel path: a cooperative launch guesses that every
frame after a window's first keeps nin = N, demodulates the window's
frames at once across the card, keeps the frames up to the first whose
timing chose another nin and goes on from there; a lane whose guesses keep
failing (noise) is left to the lane path, which always runs after it from
the frame it reached.  The lanes read one raw buffer (cu8 or cs16 pairs,
or float32 pairs) at their own start offsets, so a fused slab's chunks
need no copy.

The shape rule (`frame_parallel`): the frame-parallel path runs when a
call has one lane (SPEC_MAX_LANES), at least SPEC_MIN_FRAMES frames, and
no probe traces; otherwise the lane path runs alone.  Set from
`chip_profile.py --kernel fsk_demod --lanes 1,8,16,32,64,131,132 --frames
1024,4000` (H100, 700 W; CUDA events, frame-parallel against lane path).
Lanes that all keep their guesses: 0.06 at one lane of 4,000 frames,
0.15 of 1,024; 0.22-0.31 at 8 lanes, 0.34-0.48 at 16, 0.75-0.95 at 64
(v1 at 15 dB).  Lanes of which some fall back (a lane whose timing sits
on a nin threshold, or noise): 1.03-1.10 at one lane, 1.13-1.18 at 8,
1.21-1.34 at 16, 1.32-1.50 at 32, 1.5-1.84 at 64 and 2.0-2.2 at 131
(v2, the lanes' timing offsets spread over a symbol): the lanes that keep
their guesses finish first, then the lane path takes the rest from
where it fell back.  So one lane that falls back makes a multi-lane call
slower than the lane path, and multi-lane calls are where that is
common: 2 of 8 v2 lanes with spread timing offsets sat on a threshold, a
wideband station's idle channels are noise, and a capture's dead air
makes noise chunks (a 16-chunk fused decode with a quarter of dead air at
each end: 23.4-24.1 ms against the lane path's 18.9-20.2).  Where all of
them keep their guesses, the eight-lane wideband receiver's demod leaves
the card idle and its pace follows the host's (2-s pushes of an
all-busy band: 709-1305 Msamples/s over 15 runs, against 615-641 with
the lane path).  A single lane that falls back costs 3-10 %, and a
2-s push (4,000 or 4,800 frames) of a flight receiver runs 16 times
faster when it does not.  At 132 lanes and more the lane path fills the
card a block a lane.
The kernel reads the plain version's Hann window and timing spin
(`ops.fsk._constants`) and rebuilds the float64-built DFT matrix of
`utils.compat._dft_matrix` bit for bit from small tables
(`twiddle_tables`, laid out for shared memory by `dft_tables`).
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

launches = 0          # lane-path launches (one a call), counted where the
#                       launch succeeds
spec_launches = 0     # cooperative launches of the frame-parallel path,
#                       each in front of a lane-path launch
probe_launches = 0    # launches of the PROBE variant (with_probe), counted
#                       apart from `launches`

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
_EYE_OUT = ("eye_re", "eye_im", "eye_high", "eye_ok")
_TRACE_OUT = ("tr_fint", "tr_fft", "tr_rx", "tr_high")
_EXTRA_FIELDS = ("ring", "ahead", "max_blocks", "n_tab", "idx_smem",
                 "fs_common", "span_common", "tail_len", "spec_cap")
SMEM_LIMIT = 232448                   # a block's shared memory on Hopper
SAMPLE_BYTES = {"c64": 8, "cu8": 2, "cs16": 4}
SAMPLE_BYTES_BY_FMT = {FORMATS[f]: b for f, b in SAMPLE_BYTES.items()}
THREADS = 512                          # csrc/fsk_demod.cu
DFT_THREADS = 384
# the frame-parallel path: a lane's window holds at most SPEC_WINDOW frames
# (a 2-s push of either flight mode in one), the windows of a call at most
# SPEC_FRAMES together (their scratch: about 1 kB a frame at Ndft = 256)
SPEC_WINDOW = 4096
SPEC_FRAMES = 32768
SPEC_MIN_FRAMES = 1024
SPEC_MAX_LANES = 1
# the schedule (csrc/fsk_demod.cu's #defines): a launch's first window, the
# smallest after a miss; a lane whose rounds miss before keeping
# SPEC_MIN_WINDOW frames SPEC_MAX_POOR times in a row is left to the lane
# path
SPEC_FIRST_WINDOW = 2048
SPEC_MIN_WINDOW = 32
SPEC_MAX_POOR = 16
COUNTERS = ("spec_frames", "rounds", "lane_frames", "fallbacks")


class Geom(ctypes.Structure):
    """`DemodGeom` of csrc/fsk_demod.cu."""
    _fields_ = ([("n_total", ctypes.c_longlong)]
                + [(f, ctypes.c_int) for f in _INT_FIELDS]
                + [(f, ctypes.c_float) for f in _FLOAT_FIELDS]
                + [("atan_c", ctypes.c_float * 9)]
                + [(f, ctypes.c_int) for f in _EXTRA_FIELDS])


class Ptrs(ctypes.Structure):
    """`DemodPtrs` of csrc/fsk_demod.cu."""
    _fields_ = [(f, ctypes.c_void_p) for f in (
        "data", "starts", "n_valid", "hann", "tw_tab", "tw_idx", "spin_re",
        "spin_im", *_STATE_IN, *_STATE_OUT, *_FRAME_OUT, *_EYE_OUT,
        *_TRACE_OUT, "first", "spec_f", "spec_i", "counters")]


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built csrc/fsk_demod.cu."""
    G, P = ctypes.POINTER(Geom), ctypes.c_void_p
    lib.fsk_demod_launch.restype = ctypes.c_int
    lib.fsk_demod_launch.argtypes = [G, ctypes.POINTER(Ptrs), P]
    lib.fsk_demod_smem_bytes.restype = ctypes.c_int
    lib.fsk_demod_smem_bytes.argtypes = [G]
    lib.fsk_demod_spec_scratch.restype = None
    lib.fsk_demod_spec_scratch.argtypes = [
        G, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong)]
    lib.fsk_demod_spec_blocks.restype = ctypes.c_int
    lib.fsk_demod_spec_blocks.argtypes = [G, ctypes.POINTER(ctypes.c_int)]
    return lib


@functools.lru_cache(maxsize=1)
def _lib():
    return bind(load("fsk_demod"))


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
    nin_max = cfg.N + cfg.Ts // 2
    ahead = 2 * nin_max                   # the ring runs two frames ahead
    ring = 1 << int(cfg.Nmem + ahead + 2 * 8 - 1).bit_length()
    g = Geom(n_total=n_total, **ints,
             **{k: float(v) for k, v in floats.items()}, ring=ring,
             ahead=ahead, max_blocks=cfg.max_fft_blocks,
             n_tab=len(dft_tables(cfg.Ndft)[0]), idx_smem=1,
             fs_common=fs_common(cfg), span_common=span_common(cfg),
             tail_len=tail_len(cfg))
    g.atan_c[:] = [float(np.float32(c)) for c in compat._atan_coeffs()]
    # the index table goes to shared memory where it fits (Ndft <= 256),
    # else the kernel reads it from global memory
    g.idx_smem = int(smem_layout_bytes(g) <= SMEM_LIMIT)
    return g


def fs_common(cfg: fsk.FSKConfig) -> int:
    """Samples of a frame's first estimator block that are windowed
    whatever the frame's nin (a multiple of 4): the kernel sums their DFT
    during the frame before."""
    return min(max(min(cfg.nin_choices) - cfg.Ndft, 0), cfg.Ndft) // 4 * 4


def tail_len(cfg: fsk.FSKConfig) -> int:
    """Samples from fs_common to the largest fs, rounded up to a multiple
    of 4: the length of each of the three tails the kernel sums."""
    fs_max = min(max(max(cfg.nin_choices) - cfg.Ndft, 0), cfg.Ndft)
    return (fs_max - fs_common(cfg) + 3) // 4 * 4


def span_common(cfg: fsk.FSKConfig) -> int:
    """Samples of each of the common part's sample groups (a multiple of
    4)."""
    half = cfg.Ndft // 2
    groups = 1 if half >= DFT_THREADS else DFT_THREADS // half
    return (-(-fs_common(cfg) // groups) + 3) // 4 * 4


def smem_layout_bytes(g: Geom) -> int:
    """Dynamic shared memory of one block (`layout` of csrc/fsk_demod.cu,
    mirrored so that the geometry can be sized without the card)."""
    at = 0

    def take(nbytes):
        nonlocal at
        at = (at + nbytes + 15) // 16 * 16
    G = 1 if g.half >= THREADS else THREADS // g.half
    Gc = 1 if g.half >= DFT_THREADS else DFT_THREADS // g.half
    later = g.max_blocks > 1           # blocks after the first
    for nbytes in (2 * (THREADS // 32) * 8, g.ring * SAMPLE_BYTES_BY_FMT[g.fmt],
                   g.n_tab * 8,
                   (g.Ndft // 4 + 1) * g.half * 8 if g.idx_smem else 0,
                   g.Ndft * 4, 2 * g.NP * 4,
                   (g.Ndft + 4) * 8 if later else 0, g.Ndft * 8,
                   3 * g.tail_len * 8, g.M * g.Nmem * 8, 2 * g.M * g.NP * 8,
                   g.half * 4, 2 * 3 * g.half * 4,
                   2 * G * g.half * 4 if later else 0, 2 * Gc * g.half * 4,
                   3 * 2 * g.half * 4):
        take(nbytes)
    return at


def n_copies(n: int) -> int:
    """Rotated copies of the base twiddle table the kernel keeps, log2(n)
    - 3: copy a serves the samples with a trailing zero bits (the last
    copy those with more), so that a half-warp's bins read distinct
    banks."""
    return max(1, n.bit_length() - 4)


def n_exceptions(n: int) -> int:
    """Entries of the exception table: every product m = i k (i < n + 4:
    the samples of the matrix and the kernel's zero padding, k < n/2) with
    m mod (n/4) == 0, indexed by m / (n/4)."""
    return (n + 3) * (n // 2 - 1) // (n // 4) + 1


@functools.lru_cache(maxsize=8)
def twiddle_tables(n: int):
    """The two tables the kernel rebuilds `compat._dft_matrix(n, n/2)`'s
    cos/sin rows from, bit for bit: base (n, 2) float32, (cos, sin) of
    (-2 pi / n) m for m < n, and exc (n_exceptions(n), 2) float32, the same
    at m = e n/4.  Entry (i, k) is exc[i k / (n/4)] where (i k) mod (n/4)
    == 0 and base[(i k) mod n] elsewhere: only where the exact value is 0
    does the float64 angle of i k round to another float32 than the angle
    of (i k) mod n."""
    q = n // 4
    step = -2.0 * np.pi / n

    def table(m):
        ang = step * m.astype(np.float64)
        return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return (table(np.arange(n)),
            table(np.arange(n_exceptions(n), dtype=np.int64) * q))


def copy_slot(n: int, m: np.ndarray, a: int) -> np.ndarray:
    """Slot of (i k) mod n = m in twiddle copy a (m rotated right by a bits
    within log2 n bits)."""
    b = n.bit_length() - 1
    m = np.asarray(m, np.int64) % n
    return ((m >> a) | (m << (b - a))) & (n - 1)


@functools.lru_cache(maxsize=8)
def dft_tables(n: int):
    """What the kernel's DFT reads: tab (n_copies(n) n + n_exceptions(n),
    2) float32, the rotated copies of the base table and then the
    exception table; idx (n/4 + 1, n/2, 4) uint16, the entry of tab for
    sample i = 4 r + j (i < n + 4) and bin k at idx[r, k, j].  Sample i
    reads copy a = min(ctz(i), copies - 1) at slot copy_slot(n, i k, a):
    the 16 bins of a half-warp then read 16 distinct 8-byte banks."""
    base, exc = twiddle_tables(n)
    copies = n_copies(n)
    tab = np.concatenate([base[np.argsort(copy_slot(n, np.arange(n), a))]
                          for a in range(copies)] + [exc])
    i = np.arange(n + 4, dtype=np.int64)[:, None]
    k = np.arange(n // 2, dtype=np.int64)[None, :]
    m = i * k
    a = np.minimum(np.log2(np.maximum(i & -i, 1)), copies - 1).astype(
        np.int64)
    idx = np.where(m % (n // 4) == 0, copies * n + m // (n // 4),
                   a * n + copy_slot(n, m, a))
    idx = idx.reshape(n // 4 + 1, 4, n // 2).transpose(0, 2, 1)
    return tab, np.ascontiguousarray(idx.astype(np.uint16))


def twiddle(n: int, i: np.ndarray, k: np.ndarray) -> np.ndarray:
    """(..., 2) float32 (cos, sin) of samples i and bins k as the kernel
    reads them, tab[idx] of `dft_tables(n)` (numpy emulation)."""
    tab, idx = dft_tables(n)
    i, k = np.broadcast_arrays(np.asarray(i), np.asarray(k))
    return tab[idx[i // 4, k, i % 4].astype(np.int64)]


def smem_bytes(geom: Geom) -> int:
    """Dynamic shared memory of one block (asks the built kernel)."""
    return _lib().fsk_demod_smem_bytes(ctypes.byref(geom))


def _counters(device: torch.device) -> torch.Tensor:
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return _counters_on(index)


@functools.lru_cache(maxsize=None)
def _counters_on(index: int) -> torch.Tensor:
    return torch.zeros(len(COUNTERS), dtype=torch.int64,
                       device=torch.device("cuda", index))


def spec_stats(device="cuda") -> dict:
    """The frame-parallel path's work counts on `device` since the process
    began (they wait for the device): frames it kept, its rounds (one a
    window of a lane), frames the lane path demodulated after it, and lanes
    it left to the lane path.  The kernel adds them without a sync; tests
    and chip_profile.py read them."""
    t = _counters(torch.device(device))
    return dict(zip(COUNTERS, (int(v) for v in t.cpu())))


@functools.lru_cache(maxsize=64)
def _spec_fits(cfg: fsk.FSKConfig, fmt: str, lanes: int,
               device: torch.device) -> bool:
    """Whether the frame-parallel path's blocks (one a lane at least) fit
    on the card at once."""
    g = geometry(cfg, fmt, lanes, 1, 1)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _lib().fsk_demod_spec_blocks(ctypes.byref(g),
                                          ctypes.byref(blocks))
    return rc == 0 and blocks.value >= lanes


def frame_parallel(cfg: fsk.FSKConfig, fmt: str, lanes: int,
                   num_frames: int, device: torch.device) -> int:
    """The shape rule: the window (frames a lane) of the frame-parallel
    path for this call, 0 where the lane path runs alone.  At most
    SPEC_MAX_LANES lanes (one: a lane that falls back would hold the
    others back), and at least SPEC_MIN_FRAMES frames a lane."""
    if not 0 < lanes <= SPEC_MAX_LANES or num_frames < SPEC_MIN_FRAMES:
        return 0
    if not _spec_fits(cfg, fmt, lanes, device):
        return 0
    return min(SPEC_WINDOW, SPEC_FRAMES // lanes, num_frames)


@functools.lru_cache(maxsize=16)
def _tables(cfg: fsk.FSKConfig, device: torch.device):
    consts = fsk._constants(cfg, device)
    tab, idx = (torch.as_tensor(t, device=device)
                for t in dft_tables(cfg.Ndft))
    return consts["hann"], tab, idx, consts["spin_re"], consts["spin_im"]


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
          state: fsk.DemodState | None = None, with_eye: bool = False,
          with_probe: bool = False):
    """Launch the frame loop on L lanes of one raw buffer, on the path the
    shape rule (`frame_parallel`) picks.

    data: (n, 2) contiguous CUDA tensor of raw pairs (uint8 for cu8, int16
    for cs16, float32 for c64; copied once if it does not start on 16
    bytes, which the kernel's cp.async reads need).  starts, n_valid: (L,)
    int64 on the same device: lane l reads data[starts[l] + i], zero
    outside [0, n_valid[l]) and past the buffer, and its frames are valid
    while pos + nin <= n_valid[l].  state: lane-stacked DemodState, or None
    for the initial one.  Returns (final DemodState, FrameOut) with a
    leading lane axis, with_eye an `ops.fsk.EyeProbe` per lane, and
    with_probe an `ops.fsk.ProbeTrace` per lane after it (the kernel's
    PROBE variant, which writes each frame's integrators, EMA, timing and
    high sample; the trace buffers are allocated only then); frames past a
    lane's end are invalid with zeroed fields (the trace's EMA: the final
    one).
    """
    return _demod(cfg, data, fmt, num_frames, starts, n_valid, state,
                  with_eye, with_probe)


def _demod(cfg, data, fmt, num_frames, starts, n_valid, state=None,
           with_eye=False, with_probe=False, spec=None):
    """`demod`; spec True or False takes the frame-parallel path (with
    the lane path after it) or the lane path alone whatever the shape rule
    says (the tests and chip_profile.py hold the two paths equal)."""
    global launches, spec_launches, probe_launches
    if fmt not in FORMATS:
        raise ValueError(f"fsk_demod: unknown sample format {fmt!r}")
    if data.dim() != 2:
        raise ValueError("fsk_demod: data needs shape (n, 2)")
    dev = data.device
    _check(data, "data", RAW_DTYPES[fmt], (data.shape[0], 2))
    if data.data_ptr() % 16:
        data = data.clone()
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

    NP = (cfg.Nsym + 1) * cfg.P
    eye = ((torch.empty((L, M, NP), dtype=torch.float32, device=dev),
            torch.empty((L, M, NP), dtype=torch.float32, device=dev),
            torch.empty((L,), dtype=torch.int32, device=dev),
            torch.empty((L,), dtype=torch.bool, device=dev))
           if with_eye else None)

    trace = (fsk.ProbeTrace(
        f_int=new(M, NP, dtype=torch.complex64), fft_est=new(half),
        rx_timing=new(), high_sample=new(dtype=torch.int32))
        if with_probe else None)

    geom = geometry(cfg, fmt, L, num_frames, data.shape[0])
    if spec is None:
        cap = 0 if with_probe else frame_parallel(cfg, fmt, L, num_frames,
                                                  dev)
    elif spec:
        if with_probe:
            raise ValueError("fsk_demod: the probe traces take the lane path")
        cap = max(1, min(SPEC_WINDOW, SPEC_FRAMES // max(L, 1), num_frames))
    else:
        cap = 0
    scratch = ()
    if cap and L:
        geom.spec_cap = cap
        floats, ints = ctypes.c_longlong(0), ctypes.c_longlong(0)
        _lib().fsk_demod_spec_scratch(ctypes.byref(geom),
                                      ctypes.byref(floats), ctypes.byref(ints))
        scratch = (torch.empty(floats.value, dtype=torch.float32, device=dev),
                   torch.empty(ints.value, dtype=torch.int32, device=dev),
                   _counters(dev))
    tables = _tables(cfg, dev)
    ptrs = Ptrs(*(t.data_ptr() for t in (
        data, starts, n_valid, *tables, *state_in, *final,
        outs.soft, outs.bits, outs.valid, outs.f_est, outs.ebno_db,
        outs.norm_rx_timing, outs.ppm, outs.nin)))
    for name, t in zip(_EYE_OUT, eye or ()):
        setattr(ptrs, name, t.data_ptr())
    for name, t in zip(_TRACE_OUT, trace or ()):
        setattr(ptrs, name, t.data_ptr())
    for name, t in zip(("spec_f", "spec_i", "counters"), scratch):
        setattr(ptrs, name, t.data_ptr())
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fsk_demod_launch(ctypes.byref(geom), ctypes.byref(ptrs),
                                  stream)
    if rc != 0:
        raise RuntimeError(f"fsk_demod launch failed ({L} lanes, "
                           f"{num_frames} frames): cudaError_t {rc}")
    if with_probe:
        probe_launches += L > 0
    else:
        launches += L > 0
        spec_launches += bool(scratch)
    res = (final, outs)
    if with_eye:
        res += (fsk.EyeProbe(torch.complex(eye[0], eye[1]), eye[2], eye[3]),)
    return res + ((trace,) if with_probe else ())
