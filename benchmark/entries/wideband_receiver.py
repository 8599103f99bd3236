"""The streaming wideband receiver:
`wenet_tpu_torch.rx.pipeline.WidebandReceiver` as the `rx` CLI builds it
for `--format cu8 --mode <mode> --channels <n>`, fed pushes of raw cu8
bytes of one band recording (`traffic_wideband.make_band`) replayed end to
end in a loop; the next push is handed over when the last one returns.

Configuration keys beyond the deployment's: channels, band_Fs (channels x
Fs), taps_per_phase.  Traffic keys: recording_s, ebno_db (each channel's),
push_s (band samples a push), warm_pushes (set-up), check: block_pushes,
block_start_max (as the receiver cells: the warm pushes from the initial
state, and block_pushes consecutive pushes from a window push drawn from
the seed below block_start_max) and lanes (the channels, drawn from the
seed, whose samples and frames are compared on those pushes),
post_pushes (pushes after the window that bring out the packets due).

What decides `correct`: every channel's packets due in the window
delivered once, in order, with their bytes (`failed`); the program's
channel samples of the sampled pushes and lanes (its new frames, taken
at `ops.channelizer.channelize_pairs`) against `reference_wideband`'s
channelizer in float64 on the recording's samples (`chan_gap`: the widest
gap over the reference's rms); the lanes' demod frames (taken at
`ops.fsk.demod_raw`) against `reference.demodulate` on the program's
channel samples (`frames_differ`, `soft_gap`, `blocks_missing`).  The
control puts the reference channelizer at float16 samples and taps in
the program's place.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import judge, reference, reference_wideband, traffic_wideband
from wenet_tpu_torch.rx.pipeline import WidebandReceiver

SPANS = ("wenet_tpu_torch.ops.channelizer:channelize_pairs",
         "wenet_tpu_torch.ops.fsk:demod_raw",
         "wenet_tpu_torch.ops.deframe:uw_detect_positions",
         "wenet_tpu_torch.ops.deframe:decode_candidates_lanes")


class Entry:
    def __init__(self, ctx):
        self.ctx, self.dep, t, c = ctx, ctx.dep, ctx.traffic, ctx.config
        self.N, self.T = int(c["channels"]), int(c["taps_per_phase"])
        if int(c["band_Fs"]) != self.N * self.dep.Fs:
            raise ValueError("band_Fs must be channels x Fs")
        if self.T != 12:
            raise ValueError("taps_per_phase must be 12, the streaming "
                             "channelizer's")
        self.push_samples = int(round(t["push_s"] * int(c["band_Fs"])))
        self.warm = int(t["warm_pushes"])
        chk = t["check"]
        rng = np.random.default_rng([ctx.seed % 2 ** 63, 101])
        self.block = int(chk["block_pushes"])
        self.block_start = self.warm + int(rng.integers(
            0, int(chk["block_start_max"])))
        self.lanes = sorted(int(k) for k in rng.choice(
            self.N, size=int(chk["lanes"]), replace=False))
        self.blocks = [range(0, self.warm),
                       range(self.block_start, self.block_start + self.block)]
        self.sampled = {k for b in self.blocks for k in b}
        self.k = 0                  # pushes handed over so far
        self.window = None          # [first, end) push index of the window
        self.delivered = [[] for _ in range(self.N)]
        self.push_ms = []           # the window's pushes, host clock
        self.chan = {}              # push index -> channelize_pairs' output
        self.demod = {}             # push index -> demod_raw's call

    def setup(self):
        t, dep = self.ctx.traffic, self.dep
        self.rec = traffic_wideband.make_band(
            dep, self.N, t["recording_s"], t["ebno_db"], self.ctx.seed,
            self.ctx.device)
        raw = self.rec.raw
        self.loop = np.concatenate([raw, np.resize(raw,
                                                   2 * self.push_samples)])
        self.ctx.traffic_made()
        self.rx = WidebandReceiver(mode=dep.mode, n_channels=self.N,
                                   input_format="cu8", max_iter=dep.max_iter,
                                   device=self.ctx.device)
        taps = self.ctx.taps
        taps.listen("wenet_tpu_torch.ops.channelizer:channelize_pairs",
                    self._take_chan)
        taps.listen("wenet_tpu_torch.ops.fsk:demod_raw", self._take_demod)
        for _ in range(self.warm):
            self._push()

    def _chunk(self, k: int) -> np.ndarray:
        a = (k * self.push_samples) % self.rec.n_samples
        return self.loop[2 * a: 2 * (a + self.push_samples)]

    def _take_chan(self, args, kwargs, result):
        if self.k in self.sampled:
            self.chan[self.k] = result

    def _take_demod(self, args, kwargs, result):
        if self.k in self.sampled:
            self.demod[self.k] = {"data": args[1], "starts": args[4],
                                  "n_valid": args[5], "state": args[6],
                                  "outs": result[1]}

    def _push(self):
        for ch, p in self.rx.push(self._chunk(self.k)):
            self.delivered[ch].append(p)
        self.k += 1

    def step(self) -> int:
        if self.window is None:
            self.window = [self.k, self.k]
        a = time.perf_counter()
        self._push()
        self.push_ms.append((time.perf_counter() - a) * 1e3)
        self.window[1] = self.k
        return self.push_samples

    def counters(self) -> dict:
        s = self.rx.seconds
        return {"seconds.demod": s["demod"], "seconds.deframe": s["deframe"],
                "pushes": self.k}

    def finish(self):
        last = max(self.window[1] + int(self.ctx.traffic["post_pushes"]),
                   self.block_start + self.block)
        while self.k < last:
            self._push()
        for ch, p in self.rx.flush():
            self.delivered[ch].append(p)
        lanes = torch.as_tensor(self.lanes)
        for k, out in self.chan.items():
            out = out.reshape(self.N, -1, 2)
            self.chan[k] = out[lanes.to(out.device)].cpu().numpy()
        for k, d in self.demod.items():
            self.demod[k] = _to_host(d, self.lanes)

    def release(self):
        self.rx = None

    # ----------------------------------------------------------- judgement

    def judge(self, control: bool = False) -> dict:
        rec, P = self.rec, self.push_samples
        lo, hi = self.window[0] * P, self.window[1] * P
        attempted = failed = spurious = 0
        lost = []
        for ch in range(self.N):
            m = judge.match_stream(rec.payloads[ch], rec.ends[ch],
                                   rec.n_samples, self.delivered[ch], lo, hi)
            attempted += m["attempted"]
            failed += m["failed"]
            spurious += m["spurious"]
            lost += [(ch, i) for i in m["lost"][:10]]
        chan_gap, compared = self._chan_gap(
            "float16" if control else "float64")
        geo = reference.Geometry(self.dep.Fs, self.dep.Rs, self.dep.M,
                                 int(self.ctx.config["P"]), self.dep.Nsym)
        lanes, got, missing = [], [], 0
        for pushes in self.blocks:
            if not (all(k in self.demod for k in pushes)
                    and all(k in self.chan for k in pushes[1:])):
                missing += 1
                continue
            for i in range(len(self.lanes)):
                lanes.append(self._lane(pushes, i, geo.Nmem))
                got.append([judge.valid_frames(self.demod[k]["outs"], i)
                            for k in pushes])
        frames = judge.compare_lanes(geo, lanes, got, False)
        ms = np.asarray(self.push_ms)
        return {"attempted": attempted, "failed": failed,
                "checks": {"failed": failed, "blocks_missing": missing,
                           "chan_gap": chan_gap, **frames},
                "detail": {"attempted": attempted, "failed": failed,
                           "lost": lost[:50], "spurious": spurious,
                           "block_start": self.block_start,
                           "lanes": self.lanes,
                           "chan_samples_compared": compared,
                           "push_ms_median": float(np.median(ms)),
                           "push_ms_p95": float(np.percentile(ms, 95)),
                           "pushes": len(ms)}}

    def _new_frames(self, k: int) -> int:
        """Frames a channel that push k added to the stream."""
        return ((k + 1) * self.push_samples // self.N
                - k * self.push_samples // self.N)

    def _chan_gap(self, precision: str) -> tuple:
        """The widest gap between the program's new frames of the sampled
        pushes and lanes and the reference channelizer's on the
        recording, over the reference's rms."""
        worst = total = 0.0
        count = 0
        NT = self.N * self.T
        for k, out in sorted(self.chan.items()):
            F = self._new_frames(k)
            if F == 0:
                continue
            m0 = (k * self.push_samples) // self.N     # first new frame
            x = torch.from_numpy(judge.looped_samples(
                self.rec, m0 * self.N, (m0 + F) * self.N))
            hist = torch.from_numpy(judge.looped_samples(
                self.rec, m0 * self.N - NT, m0 * self.N))
            ref = reference_wideband.channelize(x, self.N, self.T,
                                                self.lanes, hist, precision)
            out = out[:, -F:]
            got = torch.from_numpy(out[..., 0] + 1j * out[..., 1].astype(
                np.float64))
            worst = max(worst, float((got - ref).abs().max()))
            total += float((ref.abs() ** 2).sum())
            count += ref.numel()
        if not count:
            return float("inf"), 0
        return worst / np.sqrt(total / count), count

    def _lane(self, pushes, i: int, Nmem: int) -> dict:
        """The reference's lane i over consecutive pushes: Nmem zeros (the
        demod reads samples before a lane's start as 0.0; the reference
        would repeat its first sample), the program's lane samples of the
        first push (its carry and new frames) from the state it started
        that push in, then the program's new frames of each later push
        (its channelizer's output)."""
        first = self.demod[pushes[0]]
        X = [np.zeros(Nmem), first["X"][i]]
        for k in pushes[1:]:
            F = self._new_frames(k)
            out = self.chan[k][i, -F:] if F else np.zeros((0, 2))
            X.append(out[:, 0] + 1j * out[:, 1].astype(np.float64))
        horizons = Nmem + np.cumsum([len(first["X"][i])]
                                    + [self._new_frames(k)
                                       for k in pushes[1:]])
        st = first["state"]
        state = {"nin": st["nin"][i:i + 1].astype(np.int64),
                 "fft_est": st["fft_est"][i:i + 1],
                 "f_est": st["f_est"][i:i + 1], "phi": st["phi"][i:i + 1],
                 "norm": st["norm_rx_timing"][i:i + 1],
                 "ppm": st["ppm"][i:i + 1]}
        return {"X": np.concatenate(X), "pos": Nmem + int(st["pos"][i]),
                "state": state, "horizons": [int(h) for h in horizons]}


def _to_host(d: dict, lanes: list) -> dict:
    """A demod call's sampled lanes on the host: each lane's samples (from
    its start, n_valid of them), its state, its frame outputs."""
    starts = d["starts"].cpu().numpy()
    n_valid = d["n_valid"].cpu().numpy()
    data = d["data"]
    X = []
    for lane in lanes:
        a, n = int(starts[lane]), int(n_valid[lane])
        pairs = data[a: a + n].double().cpu().numpy()
        X.append(pairs[:, 0] + 1j * pairs[:, 1])
    outs = d["outs"]
    return {"X": X,
            "state": {k: v[lanes].cpu().numpy()
                      for k, v in d["state"]._asdict().items()},
            "outs": {k: getattr(outs, k)[lanes].cpu().numpy()
                     for k in ("soft", "valid", "nin", "f_est")}}
