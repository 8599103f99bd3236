"""Streaming RX pipeline: IQ samples -> CRC-verified 256-byte packets
(counterpart of the streaming half of wenet_tpu/rx/pipeline.py).

`Receiver.push` moves the raw chunk (cu8/cs16 bytes or complex64 pairs) to
the device, converts it there, runs the frame-loop demod with the carried
`DemodState`, and fetches the soft bits, validity and last-frame stats as
one packed array.  The host then runs the UW FSM and sends the candidate
windows as one batch through the device decoder (`ops.deframe`).  Chunked
pushes equal one-shot decoding, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import framing
from ..device import resolve_device
from ..ops import deframe, fsk
from ..parallel.mesh import Mesh, mesh_device, shard_rows
from .stats import receiver_stats_record  # noqa: F401  (its home is rx.stats)

MODE_CONFIGS = {
    "v1": fsk.V1_CONFIG,     # 115177 baud RS232 framing
    "v2": fsk.V2_CONFIG,     # 96000 baud raw+scrambled
}

INPUT_CONVERTERS = {
    "cu8": (fsk.iq_from_cu8, np.uint8, 2),
    "cs16": (fsk.iq_from_cs16, np.int16, 2),
    "s16": (fsk.iq_from_s16_real, np.int16, 1),    # host-side, pushes c64
    "c64": (lambda raw: np.asarray(raw, np.complex64), np.complex64, 1),
}

# what a Receiver takes (s16 is converted on the host first, as in JAX)
_RAW_DTYPES = {fmt: INPUT_CONVERTERS[fmt][1] for fmt in ("cu8", "cs16",
                                                          "c64")}
_TORCH_DTYPES = {np.uint8: torch.uint8, np.int16: torch.int16,
                 np.float32: torch.float32}


@dataclasses.dataclass
class RxStats:
    frames: int = 0
    samples: int = 0
    detections: int = 0
    crc_ok: int = 0
    ebno_db: float = 0.0
    f_est: tuple = (0.0, 0.0)
    ppm: float = 0.0

    @property
    def per(self) -> float:
        return (self.detections - self.crc_ok) / max(self.detections, 1)


def stream_step(cfg: fsk.FSKConfig, data: torch.Tensor, state: fsk.DemodState,
                n_valid: int, fmt: str, nf: int, with_eye: bool = False):
    """One push on the device: ingest conversion + demod of `nf` frames.

    data: (n, 2) raw pairs (uint8 cu8, int16 cs16 or float32 re/im).
    Returns (final state, packed) where packed is one float32 vector
    [soft (nf*Nbits) | valid (nf) | ebno, ppm, n_valid_frames, last, f_est]
    — the host needs exactly one copy of it.  with_eye appends the last
    valid frame's eye probe: [f_int re (M*NP) | f_int im | high_sample].
    """
    dev = data.device
    res = fsk._drop(fsk.demod_raw(
        cfg, data, fmt, nf, torch.zeros(1, dtype=torch.int64, device=dev),
        torch.full((1,), n_valid, dtype=torch.int64, device=dev),
        fsk.lane_state(state, 1), with_eye))
    final, outs = res[:2]
    vidx = torch.arange(nf, device=dev)
    last = torch.max(torch.where(outs.valid, vidx, -1))
    li = torch.clamp(last, min=0)
    stats = torch.cat([
        torch.stack([outs.ebno_db[li], outs.ppm[li],
                     outs.valid.float().sum(), last.float()]),
        outs.f_est[li].float()])
    parts = [outs.soft.reshape(-1), outs.valid.float(), stats]
    if with_eye:
        eye = res[2]
        parts += [eye.f_int.real.reshape(-1), eye.f_int.imag.reshape(-1),
                  eye.high_sample.float().reshape(1)]
    return final, torch.cat(parts)


class Receiver:
    """Streaming Wenet receiver (one logical channel).

    Args:
      mode: 'v1' or 'v2' (modem geometry and deframer variant)
      cfg:  optional FSKConfig override (e.g. scaled rates for tests)
      estimator_limits: optional (min_hz, max_hz) like fsk_demod -b/-u
      max_iter: BP iterations
      pipelined: each push first retires the in-flight chunk's carry,
        queues the new chunk's demod, and only then does the host-side
        deframe of the previous chunk.  Payloads arrive one push late;
        call flush() at the end.  Output equals the serial path.
      input_format: 'c64' (complex64 samples), 'cu8' (raw rtl_sdr bytes) or
        'cs16' (raw s16 IQ pairs); raw formats convert on the device
      with_eye: also fetch each push's last valid frame's integrator
        outputs (`last_eye`, kept from an earlier push when a push has no
        valid frame) for the eye diagram of `receiver_stats_record`
      device: 'cuda' (default) or 'cpu'; CUDA without a card raises

    `seconds` accumulates host wall time in the demod (dispatch + carry
    retire, which waits for the device) and in the deframe (UW FSM + batch
    decode + CRC).
    """

    def __init__(self, mode: str = "v2", cfg: fsk.FSKConfig | None = None,
                 estimator_limits: tuple | None = None, max_iter: int = 10,
                 pipelined: bool = False, input_format: str = "c64",
                 with_eye: bool = False, device="cuda"):
        if input_format not in _RAW_DTYPES:
            raise ValueError("input_format must be 'c64', 'cu8' or 'cs16'")
        self.device = resolve_device(device)
        self.mode = mode
        self.with_eye = with_eye
        self.last_eye = None      # (f_int (M, (Nsym+1)P) complex64, high)
        self.input_format = input_format
        base = MODE_CONFIGS[mode] if cfg is None else cfg
        if estimator_limits is not None:
            base = dataclasses.replace(
                base, est_min=estimator_limits[0], est_max=estimator_limits[1])
        self.cfg = base
        self.deframer = deframe.StreamDeframer(mode, max_iter=max_iter,
                                               device=self.device)
        self.state = None            # DemodState on the device, lazily
        self._pos = 0                # host copies of state.pos / state.nin
        self._nin = self.cfg.N
        self._width = 2 if input_format in ("cu8", "cs16") else 1
        self._history = np.zeros(0, _RAW_DTYPES[input_format])
        self.stats = RxStats()
        self.pipelined = pipelined
        self._pending = None
        self.seconds = {"demod": 0.0, "deframe": 0.0}

    # ------------------------------------------------------------- one-shot

    def decode_iq(self, iq: np.ndarray) -> list:
        """Decode a whole capture; returns the CRC-valid payloads in order."""
        payloads = self.push(iq)
        payloads += self.flush()
        return payloads

    def decode_file(self, path: str, fmt: str = "cu8") -> list:
        conv, dtype, _ = INPUT_CONVERTERS[fmt]
        raw = np.fromfile(path, dtype=dtype)
        if fmt == self.input_format and fmt in ("cu8", "cs16"):
            return self.decode_iq(raw)          # device-side conversion
        return self.decode_iq(conv(raw))

    # ------------------------------------------------------------ streaming

    def _dispatch(self, chunk: np.ndarray):
        """Queue the demod of a chunk on the device; returns the in-flight
        tuple, or None if not enough samples are buffered yet."""
        t0 = time.perf_counter()
        cfg, w = self.cfg, self._width
        chunk = np.asarray(chunk, _RAW_DTYPES[self.input_format])
        if w == 2:
            chunk = chunk[: 2 * (len(chunk) // 2)]
        buf = np.concatenate([self._history, chunk])
        n_samples = len(buf) // w
        if self.state is None:
            self.state = fsk.demod_init(cfg, self.device)
        nf = cfg.num_frames(max(n_samples - self._pos, 0))
        if nf <= 0 or n_samples < self._nin:
            self._history = buf
            return None
        if self.input_format == "c64":
            data = buf.view(np.float32).reshape(-1, 2)
        else:
            data = buf.reshape(-1, 2)
        data_t = torch.from_numpy(data).to(self.device)
        final, packed = stream_step(cfg, data_t, self.state, n_samples,
                                    self.input_format, nf, self.with_eye)
        self.seconds["demod"] += time.perf_counter() - t0
        return final, packed, nf, buf, len(chunk) // w

    def _retire_state(self, final: fsk.DemodState, buf: np.ndarray):
        """Fold the in-flight chunk's carry back: pos and nin cross to the
        host (one small copy); the rest of the state stays on the device."""
        t0 = time.perf_counter()
        end_pos, nin = (int(v) for v in
                        torch.stack([final.pos, final.nin]).cpu())
        keep = min(end_pos, self.cfg.Nmem)
        self._history = buf[(end_pos - keep) * self._width:]
        self.state = final._replace(pos=torch.tensor(
            keep, dtype=torch.int32, device=self.device))
        self._pos, self._nin = keep, nin
        self.seconds["demod"] += time.perf_counter() - t0

    def _complete(self, packed: torch.Tensor, nf: int, n_new: int) -> list:
        """Host-side half: one copy of the packed array, then deframe,
        batch decode and CRC."""
        t0 = time.perf_counter()
        p = packed.cpu().numpy()
        nbits = self.cfg.Nbits
        soft = p[: nf * nbits].reshape(nf, nbits)
        valid = p[nf * nbits: nf * (nbits + 1)] > 0.5
        cfg = self.cfg
        stats = p[nf * (nbits + 1): nf * (nbits + 1) + 4 + cfg.M]
        soft = soft[valid].reshape(-1)
        nframes = int(stats[2])
        if nframes and self.with_eye:     # the last valid frame's probe
            eye = p[nf * (nbits + 1) + 4 + cfg.M:]
            n_int = cfg.M * (cfg.Nsym + 1) * cfg.P
            f_int = (eye[:n_int] + 1j * eye[n_int: 2 * n_int]).astype(
                np.complex64).reshape(cfg.M, -1)
            self.last_eye = (f_int, int(eye[2 * n_int]))

        self.stats.frames += nframes
        self.stats.samples += n_new
        if nframes:
            self.stats.ebno_db = float(stats[0])
            self.stats.ppm = float(stats[1])
            self.stats.f_est = tuple(float(x) for x in stats[4:])

        payloads = self.deframer.push(soft)
        self.stats.detections = self.deframer.n_detections
        self.stats.crc_ok = self.deframer.n_crc_ok
        self.seconds["deframe"] += time.perf_counter() - t0
        return payloads

    def push(self, chunk: np.ndarray) -> list:
        """Feed samples (complex64, or raw u8/s16 IQ for cu8/cs16
        receivers); returns newly completed CRC-valid payloads (from the
        previous chunk when pipelined)."""
        if not self.pipelined:
            inflight = self._dispatch(chunk)
            if inflight is None:
                return []
            final, packed, nf, buf, n_new = inflight
            self._retire_state(final, buf)
            return self._complete(packed, nf, n_new)

        payloads = []
        if self._pending is not None:
            final, packed, nf, buf, n_prev = self._pending
            self._pending = None
            self._retire_state(final, buf)
            self._pending = self._dispatch(chunk)
            payloads = self._complete(packed, nf, n_prev)
        else:
            self._pending = self._dispatch(chunk)
        return payloads

    def flush(self) -> list:
        """Drain the in-flight chunk (pipelined mode); serial mode no-op."""
        if self._pending is None:
            return []
        final, packed, nf, buf, n_new = self._pending
        self._pending = None
        self._retire_state(final, buf)
        return self._complete(packed, nf, n_new)


# ------------------------------------------------------ whole-capture paths


def _syms_per_packet(mode: str) -> int:
    return (framing.V2_SYMBOLS_PER_PACKET if mode == "v2"
            else framing.V1_SYMBOLS_PER_PACKET)


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor of a numpy array, copied only if it is read-only."""
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


def decode_iq_parallel(iq: np.ndarray, mode: str = "v2",
                       cfg: fsk.FSKConfig | None = None, n_chunks: int = 8,
                       warmup_frames: int = 8, max_iter: int = 10,
                       mesh: Mesh | None = None, input_format: str = "c64",
                       device=None):
    """Overlap-save capture decode: the capture is cut into `n_chunks`
    chunks, each with a halo of `warmup_frames` estimator frames and one
    packet length before it and a flush tail after it, demodulated as
    lanes of one demod call; the host finds every UW correlation hit of
    every chunk and decodes all their windows as one batch on `device`
    (CUDA, or the mesh rank's, unless the caller names another; raises
    without a card); duplicates from the overlaps are dropped by (content,
    global bit position).  As `wenet_tpu/rx/pipeline.py::decode_iq_parallel`.

    mesh: the chunk lanes split over the mesh's first axis (n_chunks must
    divide by its size; call SPMD, in every rank): each rank demodulates
    its lanes, the soft bits and validity are gathered in rank order, and
    the acquisition and the decode batch run in every rank, which all
    return the unsharded call's list.
    """
    device = mesh_device(device, mesh)
    cfg = MODE_CONFIGS[mode] if cfg is None else cfg
    if input_format == "cu8":
        raw = np.asarray(iq, np.uint8)
        n = len(raw) // 2
    else:
        iq = np.asarray(iq, np.complex64)
        n = len(iq)
    syms_pp, chunk_len, starts, _ = _fused_geometry(cfg, mode, n, n_chunks,
                                                    warmup_frames)
    nf = cfg.num_frames(chunk_len)
    if input_format == "cu8":
        # pad with zero BYTES, as the JAX path pads the raw capture
        pairs = np.concatenate([raw[: 2 * n], np.zeros(2 * chunk_len,
                                                       np.uint8)])
        pairs, fmt = pairs.reshape(-1, 2), "cu8"
    else:
        buf = np.zeros(n + chunk_len, np.complex64)
        buf[:n] = iq
        pairs, fmt = buf.view(np.float32).reshape(-1, 2), "c64"
    axis = None if mesh is None else mesh.axis_names[0]
    mine = shard_rows(n_chunks, mesh, axis)
    _, outs = fsk.demod_raw(
        cfg, torch.from_numpy(pairs).to(device), fmt, nf,
        torch.as_tensor(starts[mine], dtype=torch.int64, device=device),
        torch.full((len(starts[mine]),), chunk_len, dtype=torch.int64,
                   device=device))
    soft_all, valid_all = outs.soft, outs.valid
    if mesh is not None:
        soft_all = mesh.gather(soft_all, axis)
        valid_all = mesh.gather(valid_all.to(torch.uint8), axis).bool()
    soft_all, valid_all = soft_all.cpu().numpy(), valid_all.cpu().numpy()

    all_windows, metas = [], []
    for k in range(n_chunks):
        skip = warmup_frames if starts[k] > 0 else 0   # drop halo warmup
        soft = soft_all[k][valid_all[k]][skip:].reshape(-1)
        pos = deframe.correlation_candidates((soft < 0).astype(np.uint8),
                                             mode)
        if len(pos) == 0:
            continue
        idx = pos[:, None] + 1 + np.arange(syms_pp)[None, :]
        all_windows.append(soft[idx])
        base_bit = starts[k] // cfg.Ts + skip * cfg.Nsym
        metas.extend((k, int(t), base_bit + int(t)) for t in pos)

    results = []
    if metas:
        pkts, ok, _ = deframe.decode_windows(np.concatenate(all_windows),
                                             mode, max_iter, device)
        last_end = {}                      # per-chunk greedy overlap resolve
        for i, (k, t, gpos) in enumerate(metas):
            if ok[i] and t > last_end.get(k, -1):
                last_end[k] = t + syms_pp
                results.append((gpos, pkts[i, :256].tobytes()))
    return _dedup_payloads(results, syms_pp)


def _halo(cfg: fsk.FSKConfig, mode: str, warmup_frames: int) -> int:
    """Samples a chunk or slab reaches back: the estimator warmup and one
    packet length, so every packet lies wholly inside some chunk."""
    return (warmup_frames + _syms_per_packet(mode) // cfg.Nsym + 2) * cfg.N


def _flush(cfg: fsk.FSKConfig) -> int:
    """Samples a chunk or slab reaches past its core: the demod's lookahead,
    so a packet ending at the capture's end still demodulates."""
    return 8 * cfg.N


def _fused_geometry(cfg: fsk.FSKConfig, mode: str, n: int, n_chunks: int,
                    warmup_frames: int):
    """Overlap-save geometry of the fused paths: (symbols per packet,
    chunk length, chunk starts, warmup frames to skip per chunk)."""
    syms_pp = _syms_per_packet(mode)
    halo = _halo(cfg, mode, warmup_frames)
    core = -(-n // n_chunks)
    chunk_len = core + halo + _flush(cfg)
    starts = np.maximum(np.arange(n_chunks) * core - halo, 0).astype(np.int32)
    skips = np.where(starts > 0, warmup_frames, 0).astype(np.int32)
    return syms_pp, chunk_len, starts, skips


def _normalize_fused_input(raw, input_format: str):
    """Raw input -> ((n, 2) zero-copy pairs view, n samples, canonical
    format)."""
    if input_format in ("cu8", "cs16"):
        raw = np.asarray(raw, _RAW_DTYPES[input_format])
        n = len(raw) // 2
        return raw[: 2 * n].reshape(-1, 2), n, input_format
    if input_format == "c64":
        iq = np.asarray(raw, np.complex64)
    else:
        conv, dtype, _ = INPUT_CONVERTERS[input_format]
        iq = conv(np.asarray(raw, dtype))
    return iq.view(np.float32).reshape(-1, 2), len(iq), "c64"


def _unpack_fused(packed: np.ndarray, starts, cfg, base_bit: int = 0):
    """The fused step's packed result -> (global bit position, payload)
    tuples of the CRC-valid picks."""
    pb, ok, pos = deframe.unpack_decode_results(packed)
    results = []
    for c in range(packed.shape[0]):
        cb = base_bit + int(starts[c]) // cfg.Ts
        for i in range(packed.shape[1]):
            if ok[c, i] and pos[c, i] >= 0:
                results.append((cb + int(pos[c, i]), pb[c, i, :256].tobytes()))
    return results


def _dedup_payloads(results, syms_pp: int):
    """Drop duplicates: same content within one packet length of global bit
    position (chunk and slab halos decode boundary packets more than
    once)."""
    results.sort(key=lambda x: x[0])
    payloads, last_pos = [], {}
    for p, payload in results:
        if payload in last_pos and p - last_pos[payload] < syms_pp:
            last_pos[payload] = p
            continue
        last_pos[payload] = p
        payloads.append(payload)
    return payloads


class _FusedStep:
    """The fused receive step of one chunk geometry on one device: the
    chunks of a raw buffer demodulated as lanes of one frame-loop call
    (each lane reads its chunk in place; samples past the buffer read as
    0.0, the JAX program's padding), halo-warmup and past-end frames
    blanked to +1.0 (hard bit 0, never a UW hit), `deframe_topk` on all
    chunks, and the results packed into one uint8 tensor on the device."""

    def __init__(self, cfg: fsk.FSKConfig, mode: str, fmt: str,
                 chunk_len: int, starts: np.ndarray, k: int, max_iter: int,
                 device: torch.device):
        self.cfg, self.mode, self.fmt = cfg, mode, fmt
        self.k, self.max_iter, self.device = k, max_iter, device
        self.nf = cfg.num_frames(chunk_len)
        self.starts = self.lanes(starts)
        self.n_valid = torch.full((len(starts),), chunk_len,
                                  dtype=torch.int64, device=device)
        self._frame = torch.arange(self.nf, device=device)

    def lanes(self, values) -> torch.Tensor:
        """Per-chunk int64 values on the device."""
        return torch.as_tensor(np.asarray(values), dtype=torch.int64,
                               device=self.device)

    def __call__(self, data: torch.Tensor, skips: torch.Tensor):
        """data: (n, 2) raw pairs on the device; skips: (C,) warmup frames
        to blank per chunk.  Returns (C, k, 263) uint8 on the device."""
        _, outs = fsk.demod_raw(self.cfg, data, self.fmt, self.nf,
                                self.starts, self.n_valid)
        keep = outs.valid & (self._frame[None] >= skips[:, None])
        soft = torch.where(keep[..., None], outs.soft, 1.0)
        return deframe.deframe_topk(soft.reshape(soft.shape[0], -1),
                                    self.mode, self.k, self.max_iter,
                                    packed=True)


class _SlabPipe:
    """Fused steps of slabs kept in flight.  On a CUDA device each slab gets
    its own stream: its raw bytes go from pinned host memory to the device
    without blocking, the fused step runs, its packed result comes back into
    pinned memory without blocking, and an event marks the end; `drain`
    waits for the oldest slab's event.  On the CPU a slab runs when it is
    submitted."""

    def __init__(self, step: _FusedStep):
        self.step = step
        self.inflight = []           # (meta, packed, event, keep-alive)

    def __len__(self):
        return len(self.inflight)

    def submit(self, data: np.ndarray, skips: torch.Tensor, meta):
        dev = self.step.device
        if dev.type != "cuda":
            packed = self.step(_host_tensor(data).to(dev), skips)
            self.inflight.append((meta, packed, None, None))
            return
        host = torch.empty(data.shape, dtype=_TORCH_DTYPES[data.dtype.type],
                           pin_memory=True)
        host.numpy()[...] = data
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            on_dev = host.to(dev, non_blocking=True)
            packed = self.step(on_dev, skips)
            out = torch.empty(packed.shape, dtype=torch.uint8,
                              pin_memory=True)
            out.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        self.inflight.append((meta, out, done, (host, on_dev, packed)))

    def drain(self):
        """(meta, packed numpy) of the oldest slab in flight."""
        meta, out, done, _ = self.inflight.pop(0)
        if done is not None:
            done.synchronize()
        return meta, out.numpy()


def _k_default(chunk_len: int, cfg: fsk.FSKConfig, syms_pp: int) -> int:
    """Picks per chunk: enough for a back-to-back packet stream, plus 2."""
    return int(np.ceil(chunk_len / cfg.Ts / syms_pp)) + 2


def decode_iq_fused(raw: np.ndarray, mode: str = "v2",
                    cfg: fsk.FSKConfig | None = None, n_chunks: int = 16,
                    warmup_frames: int = 8, max_iter: int = 10,
                    input_format: str = "cu8", k_per_chunk: int | None = None,
                    mesh: Mesh | None = None, device=None):
    """Whole-capture decode in one device step: raw samples -> CRC-valid
    payloads, as `wenet_tpu/rx/pipeline.py::decode_iq_fused`.

    One host-to-device copy of the raw bytes; the chunks demodulate as
    lanes of the frame-loop kernel straight out of that buffer, deframe
    on the device (`deframe.deframe_topk`: top-k UW picks per chunk, one
    BP batch, CRC), and one device-to-host copy of the packed results;
    the host only dedups by (content, global bit position).  device: CUDA
    (the mesh rank's, with a mesh) unless the caller names another; raises
    without a card.

    mesh: the chunks split over the mesh's first axis (n_chunks must
    divide by its size; call SPMD, in every rank, with the same bytes):
    each rank runs the fused step on its chunks over the whole capture,
    the packed results are gathered in rank order (a rank that found no
    packet still sends its fixed-shape rows), and every rank returns the
    unsharded call's list.
    """
    device = mesh_device(device, mesh)
    cfg = MODE_CONFIGS[mode] if cfg is None else cfg
    data, n, fmt = _normalize_fused_input(raw, input_format)
    syms_pp, chunk_len, starts, skips = _fused_geometry(
        cfg, mode, n, n_chunks, warmup_frames)
    k = k_per_chunk or _k_default(chunk_len, cfg, syms_pp)
    axis = None if mesh is None else mesh.axis_names[0]
    mine = shard_rows(n_chunks, mesh, axis)
    step = _FusedStep(cfg, mode, fmt, chunk_len, starts[mine], k, max_iter,
                      device)
    packed = step(_host_tensor(data).to(device), step.lanes(skips[mine]))
    if mesh is not None:
        packed = mesh.gather(packed, axis)
    return _dedup_payloads(_unpack_fused(packed.cpu().numpy(), starts, cfg),
                           syms_pp)


def decode_iq_fused_overlap(raw: np.ndarray, mode: str = "v2",
                            cfg: fsk.FSKConfig | None = None,
                            n_slabs: int = 4, chunks_per_slab: int = 4,
                            warmup_frames: int = 8, max_iter: int = 10,
                            input_format: str = "cu8",
                            k_per_chunk: int | None = None, depth: int = 2,
                            device="cuda"):
    """Slab-pipelined fused decode: the capture is cut into `n_slabs`
    slabs that overlap by one halo, each run through the fused step with
    `depth` slabs in flight (`_SlabPipe`: the copy of slab s+1 overlaps the
    work of slab s).  Output equals `decode_iq_fused`'s, as in
    `wenet_tpu/rx/pipeline.py::decode_iq_fused_overlap`."""
    device = resolve_device(device)
    cfg = MODE_CONFIGS[mode] if cfg is None else cfg
    data, n, fmt = _normalize_fused_input(raw, input_format)
    syms_pp = _syms_per_packet(mode)
    halo = _halo(cfg, mode, warmup_frames)
    score = -(-n // n_slabs)                       # samples per slab core
    slab_nsamp = score + halo + _flush(cfg)
    slab_begins = np.maximum(np.arange(n_slabs) * score - halo, 0)
    # chunk geometry within a slab, the same for every slab
    _, chunk_len, starts, skips = _fused_geometry(
        cfg, mode, slab_nsamp, chunks_per_slab, warmup_frames)
    k = k_per_chunk or _k_default(chunk_len, cfg, syms_pp)
    step = _FusedStep(cfg, mode, fmt, chunk_len, starts, k, max_iter, device)
    # a slab that starts mid-capture has cold estimators in its first
    # chunk too: blank that chunk's warmup as well
    skips_of = {False: step.lanes(skips),
                True: step.lanes(np.where(starts > 0, skips, warmup_frames))}
    pipe, results = _SlabPipe(step), []

    def drain():
        begin, packed = pipe.drain()
        results.extend(_unpack_fused(packed, starts, cfg,
                                     base_bit=begin // cfg.Ts))

    for begin in (int(b) for b in slab_begins):
        pipe.submit(data[begin: begin + slab_nsamp], skips_of[begin > 0],
                    begin)
        if len(pipe) > depth:
            drain()
    while len(pipe):
        drain()
    return _dedup_payloads(results, syms_pp)


class FusedReceiver:
    """Chunk-parallel streaming receiver, the throughput live path
    (`wenet_tpu/rx/pipeline.py::FusedReceiver`).

    Fixed-size slabs of the incoming stream (`push_samples` new samples
    plus the halo and the flush tail) each go through the fused step;
    estimator state is recomputed from the halo rather than carried, so
    a slab's chunks demodulate in parallel.  Up to `depth` slabs stay in
    flight (`_SlabPipe`), so payloads arrive up to `depth` pushes late;
    call flush() at the end of the stream.  The payload output equals
    `decode_iq_fused` of the concatenated stream (duplicates across slab
    halos dedup by content and global bit position).  The dedup map keeps
    only entries that a later slab's result could still match: no result
    of a slab lies before its first bit, so entries more than one packet
    length behind the newest drained slab's first bit are dropped.

    device: CUDA unless the caller asks for another; raises without a card.
    """

    def __init__(self, mode: str = "v2", cfg: fsk.FSKConfig | None = None,
                 push_samples: int | None = None, n_chunks: int = 8,
                 warmup_frames: int = 8, max_iter: int = 10,
                 input_format: str = "cu8", depth: int = 2,
                 k_per_chunk: int | None = None, device="cuda"):
        if input_format not in _RAW_DTYPES:
            raise ValueError("input_format must be 'c64', 'cu8' or 'cs16'")
        self.device = resolve_device(device)
        self.mode = mode
        self.cfg = cfg = MODE_CONFIGS[mode] if cfg is None else cfg
        self.input_format = input_format
        self._dtype = _RAW_DTYPES[input_format]
        self._width = 2 if input_format in ("cu8", "cs16") else 1
        self.push_samples = int(push_samples or 4 * cfg.Fs)
        self._syms_pp = syms_pp = _syms_per_packet(mode)
        self._slab_nsamp = (self.push_samples + _flush(cfg)
                            + _halo(cfg, mode, warmup_frames))
        _, chunk_len, starts, skips = _fused_geometry(
            cfg, mode, self._slab_nsamp, n_chunks, warmup_frames)
        self._starts = starts
        k = k_per_chunk or _k_default(chunk_len, cfg, syms_pp)
        step = _FusedStep(cfg, mode, input_format, chunk_len, starts, k,
                          max_iter, self.device)
        self._skips_first = step.lanes(skips)
        self._skips_mid = step.lanes(np.where(starts > 0, skips,
                                              warmup_frames))
        self._pipe = _SlabPipe(step)
        self.depth = depth
        self._buf = np.zeros(0, self._dtype)   # raw units from sample _base
        self._base = 0                         # global sample index of buf[0]
        self._next = 0                         # next slab's first sample
        self._received = 0                     # samples pushed in all
        self._results = []                     # drained, not yet deduped
        self._emitted = {}                     # payload -> last bit position
        self._floor = 0                        # first bit of the last drain
        self.n_crc_ok = 0

    def _normalize(self, chunk):
        chunk = np.asarray(chunk, self._dtype)
        if self._width == 2:
            chunk = chunk[: 2 * (len(chunk) // 2)]
        return chunk

    def _dispatch_slab(self, begin: int):
        w = self._width
        lo = (begin - self._base) * w
        slab = self._buf[lo: lo + self._slab_nsamp * w]  # a short tail slab
        #   reads 0.0 past its end, as the JAX path's silence padding
        if self.input_format == "c64":
            data = slab.view(np.float32).reshape(-1, 2)
        else:
            data = slab.reshape(-1, 2)
        self._pipe.submit(data, self._skips_first if begin == 0
                          else self._skips_mid, begin)

    def _drain_one(self):
        begin, packed = self._pipe.drain()
        self._results.extend(_unpack_fused(packed, self._starts, self.cfg,
                                           base_bit=begin // self.cfg.Ts))
        self._floor = begin // self.cfg.Ts

    def _emit_ready(self) -> list:
        """Dedup the drained results (content + global bit position, as the
        batch paths do) and release them; then drop the dedup entries no
        later result can match."""
        self._results.sort(key=lambda x: x[0])
        out = []
        for p, payload in self._results:
            last = self._emitted.get(payload)
            self._emitted[payload] = p
            if last is None or p - last >= self._syms_pp:
                out.append(payload)
        self._results = []
        self.n_crc_ok += len(out)
        stale = self._floor - self._syms_pp
        self._emitted = {k: v for k, v in self._emitted.items() if v > stale}
        return out

    def push(self, chunk) -> list:
        """Feed samples; returns newly completed CRC-valid payloads (up to
        `depth` slabs late)."""
        chunk = self._normalize(chunk)
        self._buf = np.concatenate([self._buf, chunk])
        self._received += len(chunk) // self._width
        while self._received - self._next >= self._slab_nsamp:
            self._dispatch_slab(self._next)
            self._next += self.push_samples
            # later slabs begin at >= _next: nothing before it is read again
            if self._next > self._base:
                self._buf = self._buf[(self._next - self._base)
                                      * self._width:]
                self._base = self._next
        while len(self._pipe) > self.depth:
            self._drain_one()
        return self._emit_ready() if self._results else []

    def flush(self) -> list:
        """End of stream: process the tail and drain everything.  A later
        push() starts a fresh stream segment at the current sample count."""
        while self._next < self._received:
            self._dispatch_slab(self._next)
            self._next += self.push_samples
        while len(self._pipe):
            self._drain_one()
        self._buf = np.zeros(0, self._dtype)
        self._base = self._next = self._received
        return self._emit_ready()

