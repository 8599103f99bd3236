"""The streaming receiver: `wenet_tpu_torch.rx.pipeline.Receiver` as the
`rx` CLI builds it for `--format cu8 --mode <mode>` (serial, the eye probe
on, since the deploy script sends modem statistics), fed pushes of raw cu8
bytes from one recording replayed end to end in a loop; the next push is
handed over when the last one returns.

Traffic keys: recording_s, ebno_db, gap_bits, lead_bits (the recording;
without a lead-in and gaps, its frames run on unbroken across the loop),
push_s (the samples of a push), warm_pushes (set-up), check: block_pushes
and block_start_max (the pushes whose demod outputs are compared: the
warm pushes, from the receiver's initial state, and block_pushes
consecutive pushes starting at a window push drawn from the seed below
block_start_max, from the receiver's own state there), post_pushes (pushes
after the window that bring out the packets still due).
"""
from __future__ import annotations

import numpy as np

from benchmark import judge, reference, traffic

SPANS = ("wenet_tpu_torch.ops.fsk:demod_raw",
         "wenet_tpu_torch.ops.deframe:uw_detect_positions",
         "wenet_tpu_torch.ops.deframe:decode_candidates")


class Entry:
    def __init__(self, ctx):
        self.ctx, self.dep, t = ctx, ctx.dep, ctx.traffic
        self.push_samples = int(round(t["push_s"] * self.dep.Fs))
        self.warm = int(t["warm_pushes"])
        chk = t["check"]
        rng = np.random.default_rng([ctx.seed % 2 ** 63, 101])
        self.block = int(chk["block_pushes"])
        self.block_start = self.warm + int(rng.integers(
            0, int(chk["block_start_max"])))
        self.sampled = set(range(self.warm)) | set(
            range(self.block_start, self.block_start + self.block))
        self.k = 0                  # pushes handed over so far
        self.window = None          # [first, end) push index of the window
        self.delivered = []         # (push index, payload)
        self.taken = {}             # push index -> the demod call's values

    def setup(self):
        t, dep = self.ctx.traffic, self.dep
        self.rec = traffic.make_recording(
            dep, t["recording_s"], t["ebno_db"], self.ctx.seed, 0,
            t["gap_bits"], t["lead_bits"], self.ctx.device)
        raw = self.rec.raw
        self.loop = np.concatenate([raw, np.resize(raw,
                                                   2 * self.push_samples)])
        self.ctx.traffic_made()
        from wenet_tpu_torch.rx.pipeline import Receiver
        self.rx = Receiver(mode=dep.mode, input_format="cu8", with_eye=True,
                           max_iter=dep.max_iter, device=self.ctx.device)
        self.ctx.taps.listen("wenet_tpu_torch.ops.fsk:demod_raw", self._take)
        for _ in range(self.warm):
            self._push()

    def _chunk(self, k: int) -> np.ndarray:
        """Push k's cu8 bytes: the recording's samples from k * push, in a
        loop (a view of the recording followed by its first push)."""
        a = (k * self.push_samples) % self.rec.n_samples
        return self.loop[2 * a: 2 * (a + self.push_samples)]

    def _take(self, args, kwargs, result):
        if self.k in self.sampled:
            self.taken[self.k] = {"n_valid": args[5], "state": args[6],
                                  "outs": result[1]}

    def _push(self) -> int:
        out = self.rx.push(self._chunk(self.k))
        self.delivered.extend((self.k, p) for p in out)
        self.k += 1
        return self.push_samples

    def step(self) -> int:
        if self.window is None:
            self.window = [self.k, self.k]
        n = self._push()
        self.window[1] = self.k
        return n

    def counters(self) -> dict:
        s = self.rx.seconds
        return {"seconds.demod": s["demod"], "seconds.deframe": s["deframe"],
                "pushes": self.k}

    def finish(self):
        """Pushes after the window: the packets due by its end, and the rest
        of the sampled block if the window ended inside it."""
        last = max(self.window[1] + int(self.ctx.traffic["post_pushes"]),
                   self.block_start + self.block)
        while self.k < last:
            self._push()
        self.rx.flush()
        self.taken = {k: _to_host(v) for k, v in self.taken.items()}

    def release(self):
        self.rx = None

    # ----------------------------------------------------------- judgement

    def judge(self, control: bool = False) -> dict:
        rec, P = self.rec, self.push_samples
        lo, hi = self.window[0] * P, self.window[1] * P
        payloads = judge.match_stream(rec.payloads, rec.ends, rec.n_samples,
                                      [p for _, p in self.delivered],
                                      lo, hi)
        geo = reference.Geometry(self.dep.Fs, self.dep.Rs, self.dep.M,
                                 int(self.ctx.config["P"]), self.dep.Nsym)
        blocks = [range(0, self.warm),
                  range(self.block_start, self.block_start + self.block)]
        lanes, got, missing = [], [], 0
        for pushes in blocks:
            if not all(k in self.taken for k in pushes):
                missing += 1
                continue
            lanes.append(self._lane(geo, pushes))
            got.append([judge.valid_frames(self.taken[k]["outs"], 0)
                        for k in pushes])
        frames = judge.compare_lanes(geo, lanes, got, control)
        return {"attempted": payloads["attempted"],
                "failed": payloads["failed"],
                "checks": {"failed": payloads["failed"],
                           "blocks_missing": missing, **frames},
                "detail": {**payloads, "block_start": self.block_start}}

    def _lane(self, geo, pushes) -> dict:
        """The reference's lane for consecutive pushes: the samples from
        Nmem before the first push's next fresh sample to the end of the
        last push, and the state to start from (the initial state at the
        stream's start; else the receiver's state taken at the block's
        first push: its carry, and where in the push's buffer the next
        fresh sample lies)."""
        P, k0 = self.push_samples, pushes[0]
        first = self.taken[k0]
        if k0 == 0:
            gpos, state = 0, reference.initial_state(geo, 1)
        else:
            st = first["state"]
            history = int(first["n_valid"][0]) - P
            gpos = k0 * P - history + int(st["pos"][0])
            state = {"nin": st["nin"].astype(np.int64),
                     "fft_est": st["fft_est"], "f_est": st["f_est"],
                     "phi": st["phi"], "norm": st["norm_rx_timing"],
                     "ppm": st["ppm"]}
        origin = gpos - geo.Nmem
        end = (pushes[-1] + 1) * P
        X = judge.looped_samples(self.rec, origin, end)
        return {"X": X, "pos": geo.Nmem, "state": state,
                "horizons": [(k + 1) * P - origin for k in pushes]}


def _to_host(taken: dict) -> dict:
    outs, state = taken["outs"], taken["state"]
    return {"n_valid": taken["n_valid"].cpu().numpy(),
            "state": {k: v.cpu().numpy() for k, v in state._asdict().items()},
            "outs": {k: getattr(outs, k).cpu().numpy()
                     for k in ("soft", "valid", "nin", "f_est")}}
