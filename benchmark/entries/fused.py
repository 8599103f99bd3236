"""The whole-capture fused path: `wenet_tpu_torch.rx.pipeline.
decode_iq_fused(raw, mode, n_chunks=C, input_format="cu8")`, as the `rx`
CLI runs it with `--parallel C`: each call decodes one recording's raw cu8
bytes in pageable host memory, and the next call starts when it returns.
Several recordings are cycled, so that no call sees the bytes of the one
before it.

Traffic keys: recording_s, ebno_db, gap_bits, lead_bits, recordings,
n_chunks, warm_calls; check: call_max (the window call whose demod
outputs are compared is drawn from the seed below it) and lanes (how many
of its chunks are compared: the first, the last and others drawn from the
seed).
"""
from __future__ import annotations

import numpy as np

from benchmark import judge, reference, traffic

SPANS = ("wenet_tpu_torch.ops.fsk:demod_raw",
         "wenet_tpu_torch.ops.deframe:deframe_topk")
WARMUP_FRAMES = 8         # decode_iq_fused's default estimator warm-up
FLUSH_FRAMES = 8          # its lookahead past a chunk's core, in frames
FRAME_BYTES = 256 + 2 + 65      # what the deframer collects after the UW


class Entry:
    def __init__(self, ctx):
        self.ctx, self.dep, t = ctx, ctx.dep, ctx.traffic
        self.chunks = int(t["n_chunks"])
        chk = t["check"]
        rng = np.random.default_rng([ctx.seed % 2 ** 63, 202])
        self.warm = int(t["warm_calls"])
        self.sample_call = self.warm + int(rng.integers(0, chk["call_max"]))
        others = rng.permutation(np.arange(1, self.chunks - 1))
        self.lanes = sorted({0, self.chunks - 1, *others[
            : max(int(chk["lanes"]) - 2, 0)].tolist()})
        self.calls = 0
        self.window = None          # [first, end) call index of the window
        self.results = []           # (recording index, payloads) per call
        self.taken = None

    def setup(self):
        t = self.ctx.traffic
        self.recs = [traffic.make_recording(
            self.dep, t["recording_s"], t["ebno_db"], self.ctx.seed, r,
            t["gap_bits"], t["lead_bits"], self.ctx.device)
            for r in range(int(t["recordings"]))]
        self.ctx.traffic_made()
        from wenet_tpu_torch.rx import pipeline
        self.decode = pipeline.decode_iq_fused
        self.ctx.taps.listen("wenet_tpu_torch.ops.fsk:demod_raw", self._take)
        for _ in range(self.warm):
            self._call()

    def _take(self, args, kwargs, result):
        if self.calls == self.sample_call:
            self.taken = result[1]

    def _call(self) -> int:
        r = self.calls % len(self.recs)
        rec = self.recs[r]
        out = self.decode(rec.raw, self.dep.mode, n_chunks=self.chunks,
                          max_iter=self.dep.max_iter, input_format="cu8",
                          device=self.ctx.device)
        self.results.append((r, out))
        self.calls += 1
        return rec.n_samples

    def step(self) -> int:
        if self.window is None:
            self.window = [self.calls, self.calls]
        n = self._call()
        self.window[1] = self.calls
        return n

    def counters(self) -> dict:
        return {"calls": self.calls}

    def finish(self):
        while self.calls <= self.sample_call:
            self._call()
        outs = self.taken
        self.taken = {k: getattr(outs, k)[self.lanes].cpu().numpy()
                      for k in ("soft", "valid", "nin", "f_est")}

    def release(self):
        self.decode = None

    def geometry(self, n: int):
        """The overlap-save chunks of an n-sample capture, worked out
        again: (chunk length, chunk starts)."""
        dep = self.dep
        N = dep.Ts * dep.Nsym
        syms_pp = FRAME_BYTES * (8 if dep.mode == "v2" else 10)
        halo = (WARMUP_FRAMES + syms_pp // dep.Nsym + 2) * N
        core = -(-n // self.chunks)
        chunk_len = core + halo + FLUSH_FRAMES * N
        starts = np.maximum(np.arange(self.chunks) * core - halo, 0)
        return chunk_len, starts

    def judge(self, control: bool = False) -> dict:
        attempted = failed = lost = spurious = 0
        for r, out in self.results[self.window[0]: self.window[1]]:
            miss, extra = judge.match_list(self.recs[r].payloads, out)
            attempted += len(self.recs[r].payloads)
            lost, spurious = lost + miss, spurious + extra
        failed = lost + spurious
        geo = reference.Geometry(self.dep.Fs, self.dep.Rs, self.dep.M,
                                 int(self.ctx.config["P"]), self.dep.Nsym)
        rec = self.recs[self.sample_call % len(self.recs)]
        chunk_len, starts = self.geometry(rec.n_samples)
        lanes, got = [], []
        for i, c in enumerate(self.lanes):
            X = np.zeros(geo.Nmem + chunk_len, np.complex128)
            part = traffic.cu8_to_complex(
                rec.raw[2 * starts[c]: 2 * (starts[c] + chunk_len)])
            X[geo.Nmem: geo.Nmem + len(part)] = part
            lanes.append({"X": X, "pos": geo.Nmem,
                          "state": reference.initial_state(geo, 1),
                          "horizons": [geo.Nmem + chunk_len]})
            got.append([judge.valid_frames(self.taken, i)])
        frames = judge.compare_lanes(geo, lanes, got, control)
        return {"attempted": attempted, "failed": failed,
                "checks": {"failed": failed, **frames},
                "detail": {"lost": lost, "spurious": spurious,
                           "sample_call": self.sample_call,
                           "lanes": self.lanes}}
