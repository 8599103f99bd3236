"""One run of one cell of BENCHMARK.json.

Everything particular to a cell is found by name: the configuration file
that BENCHMARK.json names, `workloads/<traffic>.json` (its traffic, its
entry and the limits of its checks), `entries/<entry>.py` (the code that drives
the program's entry point), `metrics/<metric>.py` (one reader a metric)
and `kernels/<kernel>.py` (a kernel's work and the device names it owns).

A run: set-up (the entry makes its traffic, builds the program and warms
it), the measured window (closed loop: the next call when the last one
returns, for `seconds`), then, outside the window, the answers still due,
the peak memory, the program's state freed, and the judgement of what the
timed path produced against the plain reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "wenet_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module."""
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def for_cell(entries: list, cell: str) -> list:
    """The entries of a metric list that the cell reports."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list


def resolve(bench: dict, name: str, overrides: dict | None = None) -> Cell:
    """The cell `name` with its files; overrides replace traffic keys (the
    tests run cells at small sizes)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    if not NAME.match(w["traffic"]):
        raise ValueError(f"bad traffic name {w['traffic']!r}")
    traffic = load_json(os.path.join(BENCH_DIR, "workloads",
                                     f"{w['traffic']}.json"))
    traffic.update(overrides or {})
    return Cell(name, config, traffic, int(w["chips"]),
                for_cell(bench["end_to_end"], name),
                for_cell(bench["per_layer"], name))


class Context:
    """What an entry gets: its configuration, traffic, seed and device, the
    taps on the program, and the peak-memory reset after its traffic."""

    def __init__(self, cell: Cell, seed: int, device: str, taps):
        from .traffic import Deployment
        self.cell, self.seed, self.device, self.taps = cell, seed, device, taps
        self.config, self.traffic = cell.config, cell.traffic
        self.dep = Deployment.from_file(cell.config)

    def traffic_made(self):
        """Called once the traffic is on the host and the generator's
        device memory is free: the peak is the program's from here on."""
        import torch
        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()


class Run:
    """What the metric readers read."""

    def __init__(self, cell: Cell, seconds: float):
        self.cell, self.seconds = cell, seconds
        self.calls = []            # (start s, end s, samples) per timed call
        self.setup_s = None
        self.counters = {}         # "before" / "after": the entry's counters
        self.trace = None          # devtrace.Trace of the window (--trace 1)
        self.kernel_calls = {}     # kernel -> [(record, host histogram)]
        self.peaks = None          # the card's row of peaks.json
        self.notes = []            # earlier lines of the output
        self.spans = []            # the program's functions traced
        self.recording = False     # inside the window: kernel calls count

    @property
    def window_s(self) -> float:
        return self.calls[-1][1] - self.calls[0][0]

    def note(self, what: str, **kv):
        self.notes.append({"info": what, **kv})


def _launch_counts() -> dict:
    """Every `*launches` counter of the program's loaded kernel wrappers."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("wenet_tpu_torch.kernels.") and mod is not None:
            for attr, v in vars(mod).items():
                if attr.endswith("launches") and isinstance(v, int):
                    out[f"{name.rsplit('.', 1)[1]}.{attr}"] = v
    return out


def _smi() -> dict | None:
    fields = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    first = out.strip().splitlines()[0].split(", ")
    return dict(zip(fields.split(","), first))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             t_start: float | None = None, control: bool = False,
             bench: dict | None = None) -> dict:
    """One run.  Returns {"result": the last line's object, "notes": the
    earlier lines, "checks": [(name, value, limit)], "verdict": the
    judgement, "program": the judgement of the program}; with control, the
    result is the judgement of the reference at the control's precision in
    the program's place, on the same run.  bench: BENCHMARK.json's
    object, read from the checkout when None."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from .taps import Taps
    from .devtrace import CALL_SPAN, WINDOW_SPAN, Trace
    bench = spec() if bench is None else bench
    cell = resolve(bench, name, overrides)
    entry_mod = load_module("entries", cell.traffic["entry"])
    wanted = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: load_module("metrics", m["name"]) for m in wanted}
    run = Run(cell, seconds)
    peaks = load_json(os.path.join(BENCH_DIR, "peaks.json"))
    taps = Taps()
    try:
        ctx = Context(cell, seed, device, taps)
        entry = entry_mod.Entry(ctx)
        entry.setup()
        kernels = {}
        if trace:
            for target in getattr(entry_mod, "SPANS", ()):
                taps.span(target)
                run.spans.append(Taps.span_name(target))
            for reader in readers.values():
                k = getattr(reader, "KERNEL", None)
                if k and k not in kernels:
                    kernels[k] = load_module("kernels", k)
            for k, kmod in kernels.items():
                run.kernel_calls[k] = []
                taps.listen(kmod.OP, _recorder(run, k, kmod))
        on_card = device != "cpu"
        if on_card:
            torch.cuda.synchronize()
        prof = span = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.__enter__()
            span = torch.profiler.record_function(WINDOW_SPAN)
            span.__enter__()
        run.counters["before"] = entry.counters()
        launches0 = _launch_counts()
        run.recording = True
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        call_span = (lambda: torch.profiler.record_function(CALL_SPAN)) \
            if trace else contextlib.nullcontext
        while True:
            a = time.perf_counter()
            with call_span():
                n = entry.step()
            b = time.perf_counter()
            run.calls.append((a, b, n))
            if b - t0 >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        run.recording = False
        ms = sorted((b - a) * 1e3 for a, b, _ in run.calls)
        run.note("window", calls=len(ms), seconds=run.window_s,
                 call_ms_min=ms[0], call_ms_q1=ms[len(ms) // 4],
                 call_ms_median=ms[len(ms) // 2],
                 call_ms_q3=ms[3 * len(ms) // 4], call_ms_max=ms[-1])
        run.counters["after"] = entry.counters()
        launches = {k: v - launches0.get(k, 0)
                    for k, v in _launch_counts().items()}
        if trace:
            span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            run.trace = Trace.from_profile(prof)
            del prof
            run.note("kernel_launches", window=launches)
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
        if on_card:
            kind = torch.cuda.get_device_name(0)
            dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
            run.peaks = peaks.get(kind)
            run.note("card", devices=torch.cuda.device_count(),
                     smi=_smi())
        if trace:
            dev["busy_s"] = run.trace.busy_s()
            dev["window_s"] = run.trace.window_s
        for k, recs in run.kernel_calls.items():
            run.kernel_calls[k] = [(r, r.pop("hist").cpu().tolist())
                                   for r in recs]
        entry.finish()
        entry.release()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        verdict = entry.judge()
        run.note("judge", **verdict["detail"])
        program = verdict
        if control:
            verdict = entry.judge(control=True)
    finally:
        taps.close()
    limits = cell.traffic["limits"]
    checks = [(k, float(verdict["checks"][k]), float(limits[k]))
              for k in limits]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(verdict["attempted"]),
              "failed": int(verdict["failed"]), "metrics": metrics,
              "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_by_host(
                                   run.spans)}
        run.note("traced_msps", value=load_module("metrics", "msps").read(run))
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return {"result": result, "notes": run.notes, "checks": checks,
            "verdict": verdict, "program": program}


def _recorder(run: Run, kernel: str, kmod):
    def listen(args, kwargs, result):
        if run.recording:
            run.kernel_calls[kernel].append(kmod.record(args, kwargs, result))
    return listen


def emit(out: dict):
    """The earlier lines, the checks on standard error, and the result as
    the last line of standard output."""
    for note in out["notes"]:
        print(json.dumps(note), flush=True)
    for k, v, lim in out["checks"]:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(out["result"]), flush=True)
