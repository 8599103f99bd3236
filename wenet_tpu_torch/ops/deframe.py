"""Deframing: UW acquisition + packet extraction + LDPC decode + CRC gate
(counterpart of wenet_tpu/ops/deframe.py).

UW acquisition is the numpy emulation of the reference's C FSM
(`wenet_ldpc.c` / `drs232_ldpc.c`) on the host.  The candidate windows then
decode as one batch on the device: descramble or RS232 strip on the host,
then `sd_to_llr`, the BP decode (the CUDA kernel on a CUDA device), the CRC
gate and byte packing on the device, with one device-to-host copy of the
packed result.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import framing
from ..core import ldpc_tables as T
from . import crc as dcrc
from . import ldpc


@dataclasses.dataclass
class DeframeResult:
    payloads: list            # CRC-valid 256-byte payloads (bytes), in order
    n_detections: int         # UW detections == attempted packets
    n_crc_ok: int
    iters: np.ndarray         # (n_detections,) LDPC iterations
    positions: np.ndarray     # (n_detections,) UW-end symbol index
    crc_ok: np.ndarray        # (n_detections,) bool
    packets_raw: np.ndarray   # (n_detections, 258) uint8 payload+crc bytes

    @property
    def per(self) -> float:
        return (self.n_detections - self.n_crc_ok) / max(self.n_detections, 1)


def _mode_params(mode: str):
    if mode == "v2":
        return (framing.UW_BITS_V2.astype(np.int8), framing.V2_UW_ALLOWED_ERRORS,
                framing.V2_SYMBOLS_PER_PACKET)
    if mode == "v1":
        return (framing.UW_BITS_V1.astype(np.int8), framing.V1_UW_ALLOWED_ERRORS,
                framing.V1_SYMBOLS_PER_PACKET)
    raise ValueError("mode must be 'v1' or 'v2'")


def uw_detect_positions(hard_bits: np.ndarray, mode: str = "v2",
                        init_buffer: np.ndarray | None = None):
    """Exact emulation of the C acquisition gating.

    hard_bits: (n,) uint8 stream (bit = soft < 0).
    init_buffer: (nuw,) prior bit_buffer contents (zeros at stream start).
    Returns (positions, final_buffer): UW-end positions t — collection covers
    symbols [t+1, t+SYMS] — and the buffer state after the last detection.
    """
    uw, allowed, syms_per_packet = _mode_params(mode)
    nuw = len(uw)
    thresh = nuw - allowed
    n = len(hard_bits)
    hard_bits = np.asarray(hard_bits, np.int8)
    if init_buffer is None:
        init_buffer = np.zeros(nuw, np.int8)
    if n < 1:
        return np.zeros(0, np.int64), init_buffer

    # scores[t] = matching bits of the window ending at t, with the buffer
    # preloaded with init_buffer: one +/-1 correlation
    ext = np.concatenate([init_buffer[1:].astype(np.int8), hard_bits])
    pm = 1 - 2 * ext.astype(np.int32)
    uw_pm = 1 - 2 * uw.astype(np.int32)
    corr = np.correlate(pm, uw_pm, mode="valid")
    scores = (corr + nuw) // 2

    detections = []
    t = 0                      # next window-end position to examine
    stale = init_buffer        # buffer content frozen during COLLECT
    fresh = 0                  # positions >= fresh follow the correlation
    hit_idx = np.flatnonzero(scores >= thresh)

    def window_at(t):
        lo = t - nuw + 1
        if lo >= 0:
            return hard_bits[lo:t + 1]
        return np.concatenate([stale[lo:], hard_bits[:t + 1]])

    while t < n:
        if t < fresh:
            # windows right after a packet mix the frozen detection bits
            # with post-packet bits: emulate the shift register
            buf = stale.copy()
            found = -1
            for u in range(t, min(fresh, n)):
                buf = np.roll(buf, -1)
                buf[-1] = hard_bits[u]
                if int(np.sum(buf == uw)) >= thresh:
                    found = u
                    break
            if found < 0:
                t = fresh
                continue
            t = found
            trigger_buf = buf
        else:
            k = np.searchsorted(hit_idx, t)
            if k >= len(hit_idx):
                break
            t = int(hit_idx[k])
            trigger_buf = None
        if t + syms_per_packet >= n:   # collection would pass the stream end
            break
        detections.append(t)
        stale = np.array(trigger_buf if trigger_buf is not None
                         else window_at(t), np.int8)
        t = t + syms_per_packet + 1
        fresh = t + nuw - 1
    return np.asarray(detections, np.int64), stale


def decode_windows(windows: np.ndarray, mode: str = "v2",
                   max_iter: int = T.MAX_ITER, device="cpu"):
    """Decode pre-gathered (B, syms) soft windows in ONE device batch.

    Returns (packets_raw (B, 258) uint8, crc_ok (B,) bool, iters (B,) int32).
    """
    B = len(windows)
    if B == 0:
        return (np.zeros((0, 258), np.uint8), np.zeros(0, bool),
                np.zeros(0, np.int32))
    windows = np.asarray(windows, np.float64)
    if mode == "v2":
        sd = framing.rx_descramble_soft(windows)[:, : T.CODE_LEN]
    else:
        sd = framing.rs232_strip_soft(windows)[:, : T.CODE_LEN]

    # bucket the batch to a power of two >= 4, padding with the last row
    Bp = 1 << max(int(np.ceil(np.log2(B))), 2)
    sd = np.asarray(sd, np.float32)
    if Bp != B:
        sd = np.concatenate([sd, np.tile(sd[-1:], (Bp - B, 1))], axis=0)
    sd_t = torch.from_numpy(sd).to(device)
    llr = ldpc.sd_to_llr(sd_t)
    bits, iters, _ = ldpc.decode(llr, max_iter=max_iter)
    ok = dcrc.packet_crc_ok(bits)
    pbytes = dcrc.bits_to_bytes(bits[:, : 258 * 8]).to(torch.uint8)
    packed = torch.cat([pbytes, ok[:, None].to(torch.uint8),
                        torch.clamp(iters, 0, 255)[:, None].to(torch.uint8)],
                       dim=1).cpu().numpy()[:B]
    return (packed[:, :258].copy(), packed[:, 258].astype(bool),
            packed[:, 259].astype(np.int32))


def decode_candidates(soft: np.ndarray, positions: np.ndarray,
                      mode: str = "v2", max_iter: int = T.MAX_ITER,
                      device="cpu"):
    """Batch-decode the candidate windows at `positions` (UW-end indices)."""
    _, _, syms = _mode_params(mode)
    if len(positions) == 0:
        return decode_windows(np.zeros((0, syms)), mode, max_iter, device)
    idx = positions[:, None] + 1 + np.arange(syms)[None, :]
    return decode_windows(soft[idx].astype(np.float64), mode, max_iter,
                          device)


class StreamDeframer:
    """Stateful chunked deframer for live streams: `push(chunk)` yields
    exactly the packets `deframe_soft` would produce on the concatenated
    stream, carrying the post-detection bit_buffer state across chunks."""

    def __init__(self, mode: str = "v2", max_iter: int = T.MAX_ITER,
                 device="cpu"):
        self.mode = mode
        self.max_iter = max_iter
        self.device = device
        uw, _, self._syms = _mode_params(mode)
        self._nuw = len(uw)
        self._buf = np.zeros(0, np.float32)
        self._state = np.zeros(self._nuw, np.int8)   # bit_buffer at _buf[0]
        self.n_detections = 0
        self.n_crc_ok = 0

    def push(self, soft_chunk: np.ndarray) -> list:
        self._buf = np.concatenate(
            [self._buf, np.asarray(soft_chunk, np.float32)])
        hard = (self._buf < 0).astype(np.uint8)
        positions, stale = uw_detect_positions(hard, self.mode, self._state)
        pkts, ok, _ = decode_candidates(self._buf, positions, self.mode,
                                        self.max_iter, self.device)
        out = [pkts[i, :256].tobytes() for i in range(len(positions)) if ok[i]]
        self.n_detections += len(positions)
        self.n_crc_ok += int(ok.sum())
        if len(positions):
            # consume through the last packet
            cut = int(positions[-1]) + self._syms + 1
            self._buf = self._buf[cut:]
            self._state = stale
        elif len(self._buf) > self._syms + self._nuw:
            # no detection can complete before the kept tail: windows that
            # matter end at >= n - syms and need nuw - 1 bits of history
            cut = len(self._buf) - self._syms - self._nuw
            self._state = hard[cut - self._nuw:cut].astype(np.int8) \
                if cut >= self._nuw else np.concatenate(
                    [self._state[cut - self._nuw:], hard[:cut]]).astype(np.int8)
            self._buf = self._buf[cut:]
        return out


def correlation_candidates(hard_bits: np.ndarray, mode: str = "v2"
                           ) -> np.ndarray:
    """ALL in-stream UW correlation hits whose packet window fits."""
    uw, allowed, syms = _mode_params(mode)
    nuw = len(uw)
    n = len(hard_bits)
    pm = 1 - 2 * np.asarray(hard_bits, np.int32)
    uw_pm = 1 - 2 * np.asarray(uw, np.int32)
    corr = np.correlate(pm, uw_pm, mode="valid")
    scores = (corr + nuw) // 2
    t = np.flatnonzero(scores >= nuw - allowed) + nuw - 1
    return t[t + syms < n].astype(np.int64)


def deframe_soft(soft: np.ndarray, mode: str = "v2",
                 max_iter: int = T.MAX_ITER, acquisition: str = "fsm",
                 device="cpu") -> DeframeResult:
    """Full deframe of a soft-decision stream -> CRC-valid payloads.

    acquisition="fsm" reproduces the reference deframer exactly;
    acquisition="all" decodes EVERY correlation hit and resolves
    overlapping CRC-valid windows greedily in stream order."""
    soft = np.asarray(soft, np.float32)
    hard = (soft < 0).astype(np.uint8)
    if acquisition == "all":
        _, _, syms = _mode_params(mode)
        positions = correlation_candidates(hard, mode)
        pkts, ok, iters = decode_candidates(soft, positions, mode, max_iter,
                                            device)
        keep = np.zeros(len(positions), bool)
        last_end = -1
        for i, t in enumerate(positions):
            if ok[i] and t > last_end:
                keep[i] = True
                last_end = t + syms
        positions, pkts = positions[keep], pkts[keep]
        ok, iters = ok[keep], iters[keep]
    else:
        positions, _ = uw_detect_positions(hard, mode)
        pkts, ok, iters = decode_candidates(soft, positions, mode, max_iter,
                                            device)
    payloads = [pkts[i, :256].tobytes() for i in range(len(positions)) if ok[i]]
    return DeframeResult(
        payloads=payloads, n_detections=len(positions), n_crc_ok=int(ok.sum()),
        iters=iters, positions=positions, crc_ok=ok, packets_raw=pkts)
