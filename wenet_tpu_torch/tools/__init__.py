"""Regression tables and measurement tools of the port at the flight rates.

`per_table` and `robustness_table` are jax-free copies of the capture
functions and sweeps of tools/per_table.py and tools/robustness_table.py,
held to the JAX package's committed goldens (tests/golden/).  The
measurement tools (`chain_scaling`, `loss_census`, `minsum_scaling`,
`wideband_scaling`, `wideband_where`, `fused_where`, `fused_profile`,
`pp_breakdown`, `stream_tune`) keep the names, flags, record keys and
defaults of their tools/ counterparts; each runs on the card unless the
caller asks for the CPU, prints one JSON record a line, and with `--out
PATH` appends the records to that file.  `captures` holds the capture
builders they share.  `corpus_e2e` runs an image corpus through SSDV,
the modem and the receiver and back (tools/corpus_e2e.py's counterpart).
"""
import json
import os
import time

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")


def load_golden(name: str) -> dict:
    """tests/golden/<name>.json (a table the JAX package committed)."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)


def platform(device) -> str:
    """The name a record gives its device: the card's, or 'cpu'."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def fetch(t):
    """End a timed region: wait for the device, then copy one element of
    `t` (a tensor) to the host."""
    import torch
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return t.reshape(-1)[:1].cpu()


def time_call(fn, reps: int):
    """(first call's s, s a call over `reps` more, last result) of fn(),
    each timed region ended by `fetch` of the result (a tensor, or a
    tuple whose first item is one)."""
    def call():
        r = fn()
        fetch(r[0] if isinstance(r, tuple) else r)
        return r
    t0 = time.perf_counter()
    r = call()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn()
    fetch(r[0] if isinstance(r, tuple) else r)
    return first, (time.perf_counter() - t0) / reps, r


def emitter(device, out=None, log=print):
    """A function that stamps a record with the time and the device's
    name, prints it as one JSON line, and appends it to `out` if given."""
    name = platform(device)

    def emit(rec: dict) -> dict:
        rec["t"] = round(time.time(), 0)
        rec["platform"] = name
        line = json.dumps(rec)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")
        log(line)
        return rec
    return emit
