"""Streaming RX pipeline: IQ samples -> CRC-verified 256-byte packets
(counterpart of the streaming half of wenet_tpu/rx/pipeline.py).

Both streaming receivers are fronts of one core (`_Stages`): a push's new
samples go to the device without blocking, each lane's carried samples
and `DemodState` stay there, one frame-loop demod call runs over all
lanes, and the soft bits, validity and last-frame stats come back as one
packed array; the host then runs a UW FSM a lane and sends the candidate
windows of all lanes as one batch through the device decoder
(`ops.deframe`).  `Receiver` is its one-lane case: the raw chunk (cu8/cs16
bytes or complex64 pairs) converted in the demod.  `WidebandReceiver` is
its case of N lanes: a band's channels, made as it streams in by the
streaming channelizer (`ops.channelizer`).  Chunked pushes equal one-shot
decoding, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..core import framing
from ..device import resolve_device
from ..ops import deframe, fsk
from ..parallel.mesh import Mesh, mesh_device, shard_rows
from ..utils.spans import span
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

# pushes of up to this many bytes are staged by one host thread: torch's
# copy splits a copy over its intra-op threads, which left stalls of 10-25
# ms in the slowest 5 % of a flight push's stages (a 3.8-MB push; H100
# host, 8 cores); a band's 30.7-MB push needs those threads to keep pace
_STAGE_ONE_THREAD = 1 << 23

# the Receiver's stage clocks (`utils.spans`), in the order a chunk meets
# them, and the totals they add to
DEMOD_STAGES = ("rx.buffer", "rx.copy_in", "rx.launch", "rx.wait",
                "rx.retire")
DEFRAME_STAGES = ("rx.fetch",) + deframe.STAGES
# the wideband receiver's: the band history and the channelizer after the
# copy in
WIDEBAND_DEMOD_STAGES = ("rx.buffer", "rx.copy_in", "rx.channelize",
                         "rx.launch", "rx.wait", "rx.retire")


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


def stream_step_lanes(cfg: fsk.FSKConfig, data: torch.Tensor,
                      state: fsk.DemodState, starts: torch.Tensor,
                      n_valid: torch.Tensor, fmt: str, nf: int,
                      with_eye: bool = False):
    """One push on the device: the demod of `nf` frames on L lanes of one
    raw buffer (`ops.fsk.demod_raw`'s data, starts, n_valid and
    lane-stacked state) -> (final lane-stacked state, packed), packed
    being one float32 vector [soft (L, nf, Nbits) | valid (L, nf) | the L
    lanes' stats rows (ebno, ppm, n_valid_frames, last, f_est) | with_eye
    f_int re (L, M, NP) | f_int im | high_sample (L)], read by `_unpack`:
    the host needs exactly one copy of it.

    Nothing here waits for the device: the last valid frame's stats are
    taken with device-side gathers, so on a card the call only queues work.
    """
    dev = data.device
    res = fsk.demod_raw(cfg, data, fmt, nf, starts, n_valid, state, with_eye)
    final, outs = res[:2]
    L = starts.shape[0]
    vidx = torch.arange(nf, device=dev)
    last = torch.amax(torch.where(outs.valid, vidx, -1), dim=1)
    li = torch.clamp(last, min=0)[:, None]
    stats = torch.cat([outs.ebno_db.gather(1, li), outs.ppm.gather(1, li),
                       outs.valid.float().sum(1, keepdim=True),
                       last.float()[:, None],
                       outs.f_est.gather(1, li[:, :, None].expand(
                           L, 1, cfg.M)).reshape(L, cfg.M).float()], dim=1)
    parts = [outs.soft.reshape(-1), outs.valid.float().reshape(-1),
             stats.reshape(-1)]
    if with_eye:
        eye = res[2]
        parts += [eye.f_int.real.reshape(-1), eye.f_int.imag.reshape(-1),
                  eye.high_sample.float().reshape(-1)]
    return final, torch.cat(parts)


def _unpack(p: np.ndarray, cfg: fsk.FSKConfig, L: int, nf: int,
            with_eye: bool):
    """`stream_step_lanes`' packed vector on the host -> (soft (L, nf,
    Nbits), valid (L, nf) bool, stats rows (L, 4 + M), and with_eye the
    eye probes (f_int (L, M, NP) complex64, high_sample (L,)) else
    None)."""
    nbits, o = cfg.Nbits, L * nf * cfg.Nbits
    soft = p[:o].reshape(L, nf, nbits)
    valid = p[o: o + L * nf].reshape(L, nf) > 0.5
    o += L * nf
    stats = p[o: o + L * (4 + cfg.M)].reshape(L, 4 + cfg.M)
    if not with_eye:
        return soft, valid, stats, None
    o += L * (4 + cfg.M)
    n_int = L * cfg.M * (cfg.Nsym + 1) * cfg.P
    f_int = (p[o: o + n_int] + 1j * p[o + n_int: o + 2 * n_int]).astype(
        np.complex64).reshape(L, cfg.M, -1)
    return soft, valid, stats, (f_int, p[o + 2 * n_int:].astype(np.int64))


def _count(st: RxStats, row: np.ndarray, n_new: int) -> int:
    """Fold one lane's stats row of a push into its RxStats -> the push's
    valid frames."""
    nframes = int(row[2])
    st.frames += nframes
    st.samples += n_new
    if nframes:
        st.ebno_db = float(row[0])
        st.ppm = float(row[1])
        st.f_est = tuple(float(x) for x in row[4:])
    return nframes


class _InFlight(NamedTuple):
    """A push whose demod is queued: the carry on the device, the packed
    vector and the lanes' pos (on a card, pinned host copies that are
    whole once `done` has fired), the frame count, the lane buffer the
    demod read and the new samples a lane it holds."""
    final: fsk.DemodState
    packed: torch.Tensor
    pos: torch.Tensor
    done: torch.cuda.Event | None
    nf: int
    buf: torch.Tensor
    n_new: int


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """A pinned host tensor that `t` is copied into without blocking."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class _Stages:
    """The streaming core of both receivers: L lanes, each a stream of
    samples demodulated as it arrives, with a `StreamDeframer` a lane.

    A push: the chunk as the input format's raw units (`rx.buffer`),
    staged through a pinned buffer kept across pushes and copied to the
    card without blocking (`rx.copy_in`), the front's new samples a lane
    (`_new_samples`), then the lane buffer, one `stream_step_lanes` call
    over all lanes with the lane-stacked `DemodState`, and non-blocking
    copies of its packed result and of the lanes' pos behind it
    (`rx.launch`); the wait for those copies (`rx.wait`) and the carry's
    retire (`rx.retire`); then the host half: the packed vector unpacked
    into each lane's `RxStats`, eye probe and valid soft bits
    (`rx.fetch`), each lane's UW FSM and the candidates of all lanes in
    one decode batch (`ops.deframe`).  Serial, a push does all of it;
    pipelined, it retires the push in flight, queues its own device work
    and then does the retired push's host half while the device works
    (`flush` does the last one's).  On a card the device work goes on the
    receiver's own CUDA stream, so a decode on the current stream runs
    beside it.  Each stage is clocked in `seconds` (`utils.spans`).

    A lane's carry is its last Nmem samples before its next fresh sample
    and the samples it has not consumed, right-aligned in a (L, C, 2)
    device tensor of the demod's input pairs, C the longest lane's (at
    most Nmem + N + Ts / 2: the demod takes every frame that fits).  The
    lane buffer is each lane's carry followed by its F new samples, so
    lane l starts at l * (C + F) + C - c and holds c + F valid samples, c
    being its carry's length; its `DemodState.pos` counts from that
    start.
    """

    def __init__(self, mode: str, cfg: fsk.FSKConfig, lanes: int,
                 input_format: str, demod_format: str, max_iter: int,
                 with_eye: bool, pipelined: bool, device, stages: tuple):
        if input_format not in _RAW_DTYPES:
            raise ValueError("input_format must be 'c64', 'cu8' or 'cs16'")
        self.device = resolve_device(device)
        self.mode, self.cfg = mode, cfg
        self.input_format = input_format
        self._fmt = demod_format
        self.with_eye = with_eye
        self.pipelined = pipelined
        self.seconds = dict.fromkeys(("demod", "deframe") + stages, 0.0)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._pending = None         # the push in flight, when pipelined
        self.deframers = [deframe.StreamDeframer(mode, max_iter=max_iter,
                                                 device=self.device,
                                                 clocks=self.seconds)
                          for _ in range(lanes)]
        self.bp_windows = [0] * lanes
        self._stats = [RxStats() for _ in range(lanes)]
        self._eyes = [None] * lanes  # (f_int (M, (Nsym+1)P) complex64, high)
        self._state = None           # lane-stacked DemodState, lazily
        self._carry = None           # (L, C, 2) on the device, lazily
        self._c = np.zeros(lanes, np.int64)      # samples a lane carries
        self._pos = np.zeros(lanes, np.int64)    # its next fresh sample there
        self._pinned = None          # the pushes' host staging buffer

    def _on_stream(self):
        """The context in which this receiver's device work is queued: its
        own stream on a card, nothing on the CPU."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def push(self, chunk) -> list:
        """Feed samples -> the results of the push whose host half this
        push did: its own, or, pipelined, the previous push's."""
        if not self.pipelined:
            inflight = self._dispatch(chunk)
            self._retire_state(inflight)
            return self._complete(inflight)
        prev, self._pending = self._pending, None
        if prev is not None:
            self._retire_state(prev)
        self._pending = self._dispatch(chunk)
        return [] if prev is None else self._complete(prev)

    def flush(self) -> list:
        """End of stream: the results of the push in flight, if any."""
        prev, self._pending = self._pending, None
        if prev is None:
            return []
        self._retire_state(prev)
        return self._complete(prev)

    def _dispatch(self, chunk) -> _InFlight:
        """Queue a push's device work: the copy in, the front's new
        samples, the demod of every lane's carry and new samples, and the
        copies of the packed result and of the lanes' pos to the host."""
        cfg, clocks, L = self.cfg, self.seconds, len(self.deframers)
        with span("rx.buffer", clocks, "demod"):
            data = np.ascontiguousarray(chunk, _RAW_DTYPES[self.input_format])
            if self.input_format == "c64":
                data = data.view(np.float32).reshape(-1, 2)
            else:                               # whole samples only
                data = data[: 2 * (len(data) // 2)]
        with span("rx.copy_in", clocks, "demod"), self._on_stream():
            x = self._staged(data)
        new = self._new_samples(x)
        with span("rx.launch", clocks, "demod"), self._on_stream():
            if self._state is None:
                self._state = fsk.lane_state(fsk.demod_init(cfg, self.device),
                                             L)
                self._carry = new.new_zeros((L, 0, 2))
            C, F = self._carry.shape[1], new.shape[1]
            lanes = torch.cat([self._carry, new], dim=1)
            n_valid = self._c + F
            args = torch.as_tensor(
                np.stack([np.arange(L) * (C + F) + C - self._c, n_valid]),
                dtype=torch.int64, device=self.device)
            nf = cfg.num_frames(int((n_valid - self._pos).max()))
            final, packed = stream_step_lanes(
                cfg, lanes.reshape(-1, 2), self._state, args[0], args[1],
                self._fmt, nf, self.with_eye)
            if self._stream is None:
                pos, done = final.pos, None
            else:
                packed, pos = _to_host_async(packed), _to_host_async(final.pos)
                done = torch.cuda.Event()
                done.record(self._stream)
        return _InFlight(final, packed, pos, done, nf, lanes, F)

    def _staged(self, data: np.ndarray) -> torch.Tensor:
        """The push's samples on the device.  On a card they go through a
        pinned buffer kept across pushes (filled by one host thread up to
        `_STAGE_ONE_THREAD` bytes, else by torch's threads), and the copy
        to the card is queued without blocking: the next push refills the
        buffer only after this one's wait, which follows the copy on the
        stream."""
        with warnings.catch_warnings():    # read-only input bytes:
            warnings.simplefilter("ignore", UserWarning)  # only read
            src = torch.from_numpy(data)
        if self._stream is None:
            return src.to(self.device)
        n = src.numel()
        if self._pinned is None or self._pinned.numel() < n:
            self._pinned = torch.empty(n, dtype=src.dtype, pin_memory=True)
        staged = self._pinned[:n].view(src.shape)
        if data.nbytes <= _STAGE_ONE_THREAD:
            staged.numpy()[...] = data
        else:
            staged.copy_(src)
        return staged.to(self.device, non_blocking=True)

    def _retire_state(self, inflight: _InFlight):
        """Wait for the push's copies; each lane keeps its last Nmem
        samples before its next fresh sample and those not consumed."""
        with span("rx.wait", self.seconds, "demod"):
            if inflight.done is not None:
                inflight.done.synchronize()
        with span("rx.retire", self.seconds, "demod"):
            end = np.asarray(inflight.pos, np.int64)
            keep = np.minimum(end, self.cfg.Nmem)
            self._c = keep + self._c + inflight.n_new - end
            self._pos = keep
            width = inflight.buf.shape[1]
            with self._on_stream():
                self._carry = inflight.buf[
                    :, width - int(self._c.max()):].clone()
                self._state = inflight.final._replace(pos=torch.as_tensor(
                    keep, dtype=torch.int32, device=self.device))

    def _complete(self, inflight: _InFlight) -> list:
        """The host half of a retired push: each lane's soft bits through
        its UW FSM, the candidates of all lanes through one decode batch
        -> the front's results."""
        clocks = self.seconds
        with span("rx.fetch", clocks, "deframe"):
            softs = self._fetch(inflight)
        found = [d.detect(s) for d, s in zip(self.deframers, softs)]
        if len(self.deframers) == 1:
            decoded = [self.deframers[0].decode(found[0][1])]
        else:
            decoded = deframe.decode_streams(self.deframers,
                                             [f[1] for f in found])
        with span("deframe.consume", clocks, "deframe"):
            got = []
            for i, (d, (hard, pos, stale), (pkts, ok)) in enumerate(
                    zip(self.deframers, found, decoded)):
                self.bp_windows[i] += len(pos)
                got.append(d.consume(hard, pos, stale, pkts, ok))
                self._stats[i].detections = d.n_detections
                self._stats[i].crc_ok = d.n_crc_ok
            return self._results(got)

    def _fetch(self, inflight: _InFlight) -> list:
        """The packed array on the host -> each lane's valid frames' soft
        bits, with its stats and eye probe taken in (a push without a
        valid frame keeps the lane's earlier probe)."""
        L = len(self.deframers)
        soft, valid, stats, eye = _unpack(inflight.packed.cpu().numpy(),
                                          self.cfg, L, inflight.nf,
                                          self.with_eye)
        for i in range(L):
            if _count(self._stats[i], stats[i], inflight.n_new) \
                    and eye is not None:
                self._eyes[i] = (eye[0][i], int(eye[1][i]))
        return [soft[i][valid[i]].reshape(-1) for i in range(L)]


class Receiver(_Stages):
    """Streaming Wenet receiver (one logical channel): the core's one-lane
    case, whose new samples are the pushed chunk itself, handed to the
    demod in the input format (raw formats convert on the device).

    Args:
      mode: 'v1' or 'v2' (modem geometry and deframer variant)
      cfg:  optional FSKConfig override (e.g. scaled rates for tests)
      estimator_limits: optional (min_hz, max_hz) like fsk_demod -b/-u
      max_iter: BP iterations
      pipelined: each push first retires the in-flight chunk's carry,
        queues the new chunk's demod, and only then does the host-side
        deframe of the previous chunk.  On a card the demod and the
        copies of its results go on the receiver's own stream, so that
        deframe's decode on the current stream runs beside it.  Payloads
        arrive one push late; call flush() at the end.  Output equals the
        serial path.
      input_format: 'c64' (complex64 samples), 'cu8' (raw rtl_sdr bytes) or
        'cs16' (raw s16 IQ pairs); raw formats convert on the device
      with_eye: also fetch each push's last valid frame's integrator
        outputs (`last_eye`, kept from an earlier push when a push has no
        valid frame) for the eye diagram of `receiver_stats_record`
      device: 'cuda' (default) or 'cpu'; CUDA without a card raises

    `push` feeds samples (complex64, or raw u8/s16 IQ for cu8/cs16
    receivers) and returns the newly completed CRC-valid payloads (from
    the previous chunk when pipelined).  `state` is the carried
    `DemodState` (None before the first push), `stats` an `RxStats`.

    `seconds` accumulates host wall time a stage (`DEMOD_STAGES`,
    `DEFRAME_STAGES`) and their sums: "demod" (buffer, copy in, launch,
    the wait for the device, carry retire) and "deframe" (fetch, UW FSM,
    batch decode + CRC, consume).  While a torch profiler records, each
    stage is also a profiler span of its name (`utils.spans`).
    """

    def __init__(self, mode: str = "v2", cfg: fsk.FSKConfig | None = None,
                 estimator_limits: tuple | None = None, max_iter: int = 10,
                 pipelined: bool = False, input_format: str = "c64",
                 with_eye: bool = False, device="cuda"):
        base = MODE_CONFIGS[mode] if cfg is None else cfg
        if estimator_limits is not None:
            base = dataclasses.replace(
                base, est_min=estimator_limits[0], est_max=estimator_limits[1])
        super().__init__(mode, base, 1, input_format, input_format, max_iter,
                         with_eye, pipelined, device,
                         DEMOD_STAGES + DEFRAME_STAGES)

    @property
    def deframer(self) -> deframe.StreamDeframer:
        return self.deframers[0]

    @property
    def stats(self) -> RxStats:
        return self._stats[0]

    @property
    def last_eye(self):
        """(f_int (M, (Nsym+1)P) complex64, high_sample) of the last valid
        frame, or None."""
        return self._eyes[0]

    @property
    def state(self) -> fsk.DemodState | None:
        """The carried DemodState on the device (unbatched)."""
        if self._state is None:
            return None
        return fsk.DemodState(*(t[0] for t in self._state))

    def _new_samples(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(1, x.numel() // 2, 2)

    def _results(self, got: list) -> list:
        return got[0]

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


class WidebandReceiver(_Stages):
    """Streaming wideband receiver: one band of n_channels channels of the
    mode's rate (channel k centred at k * Fs, negative ks wrapped, as
    `ops.channelizer.channel_centres`), each channel a Wenet stream.

    A push takes the band's raw samples (cu8 bytes, converted in the
    channelizer kernel, or complex64) and returns the (channel, payload)
    pairs that the previous push completed, in channel order and each
    channel's in stream order; `flush` returns the last push's.  The
    receiver is pipelined, as `Receiver(pipelined=True)`, so the card is
    not left idle through the host deframe.  It is the core's L-lane case
    (L the selected channels): a push's new samples a lane are the
    channels that the streaming channelizer
    (`ops.channelizer.StreamingChannelizer`, with its band history on the
    device) makes of it, as float32 pairs; each lane's valid soft bits go
    to its own `StreamDeframer` (the C UW FSM on a card) and the
    candidates of all lanes through one decode batch
    (`ops.deframe.decode_streams`).  Each lane's frames equal a `Receiver`
    (c64) fed that channel's samples in the same pushes, and the payloads
    those of `ops.channelizer.demod_multichannel` on the whole capture.

    Args: mode, n_channels, channels (indices in [-N, N), negative ones
    counted from the end; the pairs carry them as given; default all),
    input_format ('cu8' or 'c64'), max_iter, with_eye (each lane's last
    valid frame's eye probe in `last_eye`), cfg (the channels' FSKConfig;
    default the mode's), device (CUDA unless the caller asks for another;
    raises without a card).

    `seconds` holds the stage clocks (`WIDEBAND_DEMOD_STAGES`,
    `DEFRAME_STAGES`, the deframe stages summed over the lanes) and their
    sums "demod" and "deframe"; `stats` an `RxStats` a lane, `bp_windows`
    the UW candidates a lane sent to BP, `state` the lane-stacked
    `DemodState`.
    """

    def __init__(self, mode: str = "v2", n_channels: int = 8, channels=None,
                 input_format: str = "cu8", max_iter: int = 10,
                 with_eye: bool = False, cfg: fsk.FSKConfig | None = None,
                 device="cuda"):
        if input_format not in ("cu8", "c64"):
            raise ValueError("input_format must be 'cu8' or 'c64'")
        from ..ops import channelizer
        self.n_channels = int(n_channels)
        self.channels = (list(range(self.n_channels)) if channels is None
                         else [int(k) for k in channels])
        L = len(self.channels)
        super().__init__(mode, MODE_CONFIGS[mode] if cfg is None else cfg, L,
                         input_format, "c64", max_iter, with_eye, True,
                         device, WIDEBAND_DEMOD_STAGES + DEFRAME_STAGES)
        self.channelizer = channelizer.StreamingChannelizer(
            self.n_channels, self.channels, input_format)
        self._order = sorted(range(L), key=lambda i: self.channels[i])

    @property
    def stats(self) -> list:
        return self._stats

    @property
    def last_eye(self) -> list:
        return self._eyes

    @property
    def state(self) -> fsk.DemodState | None:
        return self._state

    def _new_samples(self, x: torch.Tensor) -> torch.Tensor:
        with span("rx.channelize", self.seconds, "demod"), self._on_stream():
            return self.channelizer.push(x)

    def _results(self, got: list) -> list:
        return [(self.channels[i], p) for i in self._order for p in got[i]]


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
        return self.topk(self.soft(data, skips))

    def soft(self, data: torch.Tensor, skips: torch.Tensor) -> torch.Tensor:
        """The demod half: (C, nf * Nbits) soft bits, invalid and warmup
        frames blanked."""
        _, outs = fsk.demod_raw(self.cfg, data, self.fmt, self.nf,
                                self.starts, self.n_valid)
        keep = outs.valid & (self._frame[None] >= skips[:, None])
        soft = torch.where(keep[..., None], outs.soft, 1.0)
        return soft.reshape(soft.shape[0], -1)

    def topk(self, soft: torch.Tensor) -> torch.Tensor:
        """The deframe half: top-k acquisition, one BP batch and the CRC
        -> (C, k, 263) uint8 packed rows."""
        return deframe.deframe_topk(soft, self.mode, self.k, self.max_iter,
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

