"""The port's host runtime in C (wenet_tpu_torch.native, csrc/deframe_fsm.c)
against its numpy FSM and both of the JAX package's UW FSMs (its numpy
emulation and its own C library): positions and final bit buffers exact on
every stream; the sample conversions bit for bit equal to the JAX
library's and the port's host converters; and no quiet fallback where the
library cannot be built."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wenet_tpu import native as jnative
from wenet_tpu.core import framing as jframing
from wenet_tpu.ops import deframe as jdeframe
from wenet_tpu.ops import ldpc as jldpc
from wenet_tpu_torch import native
from wenet_tpu_torch.ops import deframe, fsk

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C compiler available")

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> uw_detect_positions(hard, mode, init) of one implementation
_port_fsm = deframe.uw_detect_positions
FSMS = {
    "port_c": lambda h, m, i: _port_fsm(h, m, i),
    "port_numpy": lambda h, m, i: _port_fsm(h, m, i, force_numpy=True),
    "jax_numpy": lambda h, m, i: jdeframe.uw_detect_positions(
        h, m, i, force_numpy=True),
    "jax_c": lambda h, m, i: jdeframe.uw_detect_positions(h, m, i),
}


def _nuw(mode):
    return len(deframe._mode_params(mode)[0])


def _packet_train(mode, n_packets, seed, sigma=0.4):
    """Noise, then n_packets framed random payloads (frame_packet with
    encode_bytes) each followed by noise, as soft symbols."""
    rng = np.random.default_rng(seed)
    parts = [rng.normal(0, 1, 777).astype(np.float32)]
    for _ in range(n_packets):
        frame = jframing.frame_packet(
            rng.integers(0, 256, 256, dtype=np.uint8).tobytes(),
            jldpc.encode_bytes, mode=mode)
        bits = jframing.frame_to_bits(frame, mode)
        parts.append((1.0 - 2.0 * bits
                      + rng.normal(0, sigma, len(bits))).astype(np.float32))
        parts.append(rng.normal(0, 1, 333).astype(np.float32))
    return np.concatenate(parts)


def _stream(case, mode):
    """(hard bits, init buffer or None, minimum detections) of a case."""
    if case.startswith("noise"):
        rng = np.random.default_rng(int(case[-1]))
        soft = rng.normal(0, 1, 80_000).astype(np.float32)
        return (soft < 0).astype(np.uint8), None, 0
    if case == "packets":
        return (_packet_train(mode, 5, 3) < 0).astype(np.uint8), None, 5
    if case == "init_buffer":
        rng = np.random.default_rng(4)
        hard = (_packet_train(mode, 3, 5, sigma=0.5) < 0).astype(np.uint8)
        return hard, rng.integers(0, 2, _nuw(mode)).astype(np.int8), 3
    if case == "cut_packet":
        # the last packet's UW is in the stream, its body cut short: the
        # FSM finds the UW but stops, as the reference runs out of input
        soft = _packet_train(mode, 2, 6)
        _, _, syms = deframe._mode_params(mode)
        return (soft[:-333 - syms // 2] < 0).astype(np.uint8), None, 1
    if case == "empty":
        return np.zeros(0, np.uint8), None, 0
    raise ValueError(case)


CASES = ["noise0", "noise1", "noise2", "packets", "init_buffer",
         "cut_packet", "empty"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_fsm_matches_every_implementation(mode, case):
    """The port's C FSM, its numpy FSM and both JAX FSMs: the same
    positions and final buffer."""
    assert jnative.available()           # JAX's C path really runs
    hard, init, least = _stream(case, mode)
    want_p, want_f = FSMS["port_c"](hard, mode, init)
    assert want_p.dtype == np.int64 and want_f.dtype == np.int8
    assert len(want_f) == _nuw(mode)
    assert len(want_p) >= least
    for name, fsm in FSMS.items():
        p, f = fsm(hard, mode, init)
        np.testing.assert_array_equal(p, want_p, err_msg=name)
        np.testing.assert_array_equal(f, want_f, err_msg=name)
    if case == "cut_packet":
        # UW hits past the last detection's packet, none of whose windows
        # fits before the end
        uw, allowed, syms = deframe._mode_params(mode)
        corr = np.correlate(1 - 2 * hard.astype(np.int32),
                            1 - 2 * uw.astype(np.int32), mode="valid")
        hits = np.flatnonzero((corr + len(uw)) // 2 >= len(uw) - allowed)
        later = hits[hits + len(uw) - 1 > want_p[-1] + syms] + len(uw) - 1
        assert len(want_p) == 1 and len(later)
        assert (later + syms >= len(hard)).all()
    if case == "empty":
        assert len(want_p) == 0 and not want_f.any()


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_chunked_resumption(mode, monkeypatch):
    """StreamDeframer.push carries the final buffer push after push: with
    each FSM in its place, every call gives the same positions and final
    buffer, and the payloads equal the whole stream's."""
    soft = _packet_train(mode, 6, 7 + len(mode), sigma=0.45)
    whole = deframe.deframe_soft(soft, mode, device="cpu").payloads
    assert len(whole) == 6
    calls = {}
    for name, fsm in FSMS.items():
        log = calls[name] = []

        def record(hard, m, init=None, force_numpy=False, fsm=fsm, log=log):
            out = fsm(hard, m, init)
            log.append((len(hard), *(a.tolist() for a in out)))
            return out
        monkeypatch.setattr(deframe, "uw_detect_positions", record)
        d = deframe.StreamDeframer(mode, device="cpu")
        got = []
        for i in range(0, len(soft), 2311):
            got += d.push(soft[i:i + 2311])
        assert got == whole, name
    assert len(calls["port_c"]) > 6
    for name, log in calls.items():
        assert log == calls["port_c"], name


def _shift_buffer_fsm(bits, uw, allowed, syms, init):
    """The acquisition FSM as the reference writes it: a byte a buffered
    bit, shifted each symbol and compared bit by bit."""
    buf, nuw = [int(b) for b in init], len(uw)
    pos, final, t, n = [], None, 0, len(bits)
    while t < n:
        buf = buf[1:] + [int(bits[t])]
        if sum(b == int(u) for b, u in zip(buf, uw)) >= nuw - allowed:
            if t + syms >= n:
                break
            pos.append(t)
            final = list(buf)
            t += syms
        t += 1
    return pos, buf if final is None else final


@pytest.mark.parametrize("nuw,allowed", [(1, 0), (13, 2), (63, 5),
                                         (64, 6)])
def test_fsm_register_holds_any_uw_width(nuw, allowed):
    """The C FSM keeps its bit buffer in one 64-bit register: for every
    width up to MAX_UW, with planted words (some with `allowed` errors)
    and an init buffer, the shift-buffer FSM's positions and final
    buffer."""
    rng = np.random.default_rng(nuw)
    uw = rng.integers(0, 2, nuw).astype(np.uint8)
    bits = rng.integers(0, 2, 6000).astype(np.uint8)
    for at in range(200, 5800, 700):
        word = uw.copy()
        word[rng.choice(nuw, min(allowed, nuw), replace=False)] ^= 1
        bits[at - nuw + 1: at + 1] = word
    init = rng.integers(0, 2, nuw).astype(np.int8)
    syms = 97
    want_p, want_f = _shift_buffer_fsm(bits, uw, allowed, syms, init)
    assert len(want_p) >= 8
    got_p, got_f = native.uw_detect(bits, uw, allowed, syms, init)
    assert got_p.tolist() == want_p
    assert got_f.tolist() == want_f
    # bool hard decisions are read as the same bytes
    got_p, _ = native.uw_detect(bits.astype(bool), uw, allowed, syms, init)
    assert got_p.tolist() == want_p


@pytest.mark.parametrize("fmt", ["cu8", "cs16"])
def test_sample_conversion_bit_exact(fmt):
    """cu8_to_c64 / cs16_to_c64 over every input value and a random
    stream: bit for bit the JAX library's and the port's host converters."""
    rng = np.random.default_rng(5)
    if fmt == "cu8":
        every = np.arange(256, dtype=np.uint8)
        raw = np.concatenate([every, every[::-1],
                              rng.integers(0, 256, 20000, dtype=np.uint8)])
        got, jax_c, host = (native.cu8_to_c64(raw), jnative.cu8_to_c64(raw),
                            fsk.iq_from_cu8(raw))
    else:
        every = np.arange(-32768, 32768, dtype=np.int16)
        raw = np.concatenate([every, every[::-1],
                              rng.integers(-32768, 32768, 20000
                                           ).astype(np.int16)])
        got, jax_c, host = (native.cs16_to_c64(raw),
                            jnative.cs16_to_c64(raw), fsk.iq_from_cs16(raw))
    assert got.dtype == np.complex64 and len(got) == len(raw) // 2
    for other in (jax_c, host):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      other.view(np.uint32))


@pytest.mark.parametrize("fault", ["no_compiler", "build_fails"])
def test_no_quiet_fallback(fault, tmp_path, monkeypatch):
    """With the compiler hidden, or a source that does not compile, and a
    fresh build directory, the C path raises (with the compiler's output
    where it ran) instead of returning numpy's answer; the CPU's callers
    still take the numpy FSM."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    if fault == "no_compiler":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        match = "no C compiler"
    else:
        bad = tmp_path / "deframe_fsm.c"
        bad.write_text("long uw_detect(void) { return }\n")
        monkeypatch.setattr(native, "SOURCE", str(bad))
        match = "error"
    soft = _packet_train("v2", 5, 3)
    hard = (soft < 0).astype(np.uint8)
    with pytest.raises(RuntimeError, match=match):
        deframe.uw_detect_positions(hard, "v2")
    with pytest.raises(RuntimeError, match=match):
        native.cu8_to_c64(np.zeros(4, np.uint8))
    assert not list((tmp_path / "build").glob("*.so"))
    p, _ = deframe.uw_detect_positions(hard, "v2", force_numpy=True)
    assert len(p) == 5
    assert len(deframe.deframe_soft(soft, "v2", device="cpu").payloads) == 5


def test_concurrent_first_use(tmp_path):
    """Four processes that build into one fresh directory at once all load
    a whole library and agree; one library is left, no temporary file."""
    build = tmp_path / "build"
    code = ("import sys, numpy as np\n"
            "from wenet_tpu_torch import native\n"
            f"native.BUILD_DIR = {str(build)!r}\n"
            "from wenet_tpu_torch.ops import deframe\n"
            "rng = np.random.default_rng(0)\n"
            "hard = (rng.normal(0, 1, 80000) < 0).astype(np.uint8)\n"
            "p, f = deframe.uw_detect_positions(hard, 'v2')\n"
            "print(p.tolist(), f.tolist())\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert len({out for out, _ in outs}) == 1
    assert [f.name for f in build.iterdir()] == [
        os.path.basename(native.library_path())]
