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

from ..device import resolve_device
from ..ops import deframe, fsk

MODE_CONFIGS = {
    "v1": fsk.V1_CONFIG,     # 115177 baud RS232 framing
    "v2": fsk.V2_CONFIG,     # 96000 baud raw+scrambled
}

INPUT_CONVERTERS = {
    "cu8": (fsk.iq_from_cu8, np.uint8, 2),
    "cs16": (fsk.iq_from_cs16, np.int16, 2),
    "c64": (lambda raw: np.asarray(raw, np.complex64), np.complex64, 1),
}

_RAW_DTYPES = {fmt: dtype for fmt, (_, dtype, _) in INPUT_CONVERTERS.items()}


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
                n_valid: int, fmt: str, nf: int):
    """One push on the device: ingest conversion + demod of `nf` frames.

    data: (n, 2) raw pairs (uint8 cu8, int16 cs16 or float32 re/im).
    Returns (final state, packed) where packed is one float32 vector
    [soft (nf*Nbits) | valid (nf) | ebno, ppm, n_valid_frames, last, f_est]
    — the host needs exactly one copy of it.
    """
    if fmt == "cu8":
        x = (data.float() - 127.0) * (1.0 / 128.0)
    elif fmt == "cs16":
        x = data.float() * np.float32(1.0 / fsk.FDMDV_SCALE)
    else:
        x = data
    iq = torch.complex(x[:, 0].contiguous(), x[:, 1].contiguous())
    final, outs = fsk.demod_stream(cfg, iq, nf, state, n_valid=n_valid)
    vidx = torch.arange(nf, device=data.device)
    last = torch.max(torch.where(outs.valid, vidx, -1))
    li = torch.clamp(last, min=0)
    stats = torch.cat([
        torch.stack([outs.ebno_db[li], outs.ppm[li],
                     outs.valid.float().sum(), last.float()]),
        outs.f_est[li].float()])
    packed = torch.cat([outs.soft.reshape(-1), outs.valid.float(), stats])
    return final, packed


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
      device: 'cuda' (default) or 'cpu'; CUDA without a card raises

    `seconds` accumulates host wall time in the demod (dispatch + carry
    retire, which waits for the device) and in the deframe (UW FSM + batch
    decode + CRC).
    """

    def __init__(self, mode: str = "v2", cfg: fsk.FSKConfig | None = None,
                 estimator_limits: tuple | None = None, max_iter: int = 10,
                 pipelined: bool = False, input_format: str = "c64",
                 device="cuda"):
        if input_format not in _RAW_DTYPES:
            raise ValueError("input_format must be 'c64', 'cu8' or 'cs16'")
        self.device = resolve_device(device)
        self.mode = mode
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
                                    self.input_format, nf)
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
        stats = p[nf * (nbits + 1):]
        soft = soft[valid].reshape(-1)
        nframes = int(stats[2])

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


def receiver_stats_record(rx: Receiver) -> dict:
    """fsk_demod-style stats record (`--stats` JSON fields) from a live
    Receiver, for `rx.stats.FSKDemodStats`; the state tensors are
    copied to the host here.  No eye diagram."""
    st = rx.state
    if st is None:
        return {}
    f_est = st.f_est.cpu().numpy()
    return {
        "secs": int(time.time()),
        "EbNodB": float(st.ebno_db),
        "ppm": int(float(st.ppm)),
        "f1_est": float(f_est[0]),
        "f2_est": float(f_est[1]),
        "samp_fft": [float(x) for x in st.fft_est.cpu().numpy()],
    }
