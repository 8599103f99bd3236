"""The port's modem tools and the helpers they need against the JAX package
on the same inputs (CPU): the wire-format and code-table namespaces,
`ops/ldpc.decode_np`, `core/tuning`, `rx/selftest`, the testframe BER tool
(`cli/ber`), the PER sweep (`cli/bench_demod`) and the dispatcher.

Exact throughout: names and values of the namespaces, decode_np's bits,
iterations and parity on the same float32 LLRs, the BER counts, the sweep's
decoded bytes at each level.
"""
import importlib
import inspect
import sys

import numpy as np
import pytest
import torch

from wenet_tpu.cli import bench_demod as jbench
from wenet_tpu.cli import ber as jber
from wenet_tpu.core import framing as jframing
from wenet_tpu.core import ldpc_tables as jtables
from wenet_tpu.core import tuning as jtuning
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.ops import ldpc as jldpc
from wenet_tpu_torch import __main__ as dispatcher
from wenet_tpu_torch.cli import bench_demod as tbench
from wenet_tpu_torch.cli import ber as tber
from wenet_tpu_torch.core import framing, ldpc_tables, tuning
from wenet_tpu_torch.ops import fsk as tfsk
from wenet_tpu_torch.ops import ldpc as tldpc
from wenet_tpu_torch.rx import selftest

torch.set_num_threads(1)

GEOM = dict(Fs=96000, Rs=9600)


def _public(module):
    """The module's own public names: no modules, nothing imported."""
    return {k: v for k, v in vars(module).items()
            if not k.startswith("_") and not isinstance(v, type(sys))
            and k != "annotations"
            and getattr(v, "__module__", module.__name__) == module.__name__}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


# modules whose functions of no argument are called (pure); the others
# start servers and loops, and are held by name and signature
CALLED = ("core.framing", "core.ldpc_tables", "core.tuning")
# the port's own names for what the JAX module has, and signatures that
# differ by what is not ported (the native FSM's force_numpy)
NOT_PORTED = {"ops.deframe": {"pack_decode_results"}}
NAME_ONLY = ("ops.deframe",)
NAMESPACES = CALLED + (
    "rx.stats", "ops.deframe", "rx.router", "core.packets", "ssdv.codec",
    "ssdv.external", "tx.packet_tx", "tx.radios", "tx.sx127x",
    "rx.selftest", "cli.tx", "cli.ber", "cli.bench_demod", "cli.ssdv_cli",
    # the ground-station apps, the examples and the flight side
    "rx.telemetry_console", "rx.uploader", "rx.web", "rx.gui",
    "examples.link_emulation", "examples.rx_tester",
    "examples.sec_payload_rx", "tx.gps", "tx.ubx", "tx.pi_utils",
    "tx.camera", "cli.flight",
    # the scale-out layer
    "parallel.mesh", "parallel.sharded_ldpc")
# the functions that take a mesh, and the JAX parameters they do not take
# (the PRNG keys and XLA knobs of the TPU build)
MESH_FUNCTIONS = ("parallel.sweep.ldpc_ber_sweep",
                  "parallel.sweep.chain_per_sweep",
                  "parallel.sweep.acquisition_search",
                  "rx.pipeline.decode_iq_parallel",
                  "rx.pipeline.decode_iq_fused")
NOT_PORTED_PARAMS = {"key", "scan_unroll", "frames_per_step"}


def _params(fn):
    """[(name, default)] of fn's parameters, or None where it has no
    signature."""
    try:
        return [(n, p.default)
                for n, p in inspect.signature(fn).parameters.items()]
    except (TypeError, ValueError):
        return None


def _same_signature(jfn, tfn):
    """The port's parameters begin with the JAX function's, with equal
    defaults (the port may add parameters, e.g. `device`)."""
    a, b = _params(jfn), _params(tfn)
    return a is None or b[:len(a)] == a


@pytest.mark.parametrize("name", NAMESPACES, ids=[
    n.split(".")[-1] if n in CALLED else n for n in NAMESPACES])
def test_namespaces_are_supersets_with_equal_values(name):
    """Every public name of the JAX module is in the port's copy, but for
    the stated exceptions.  Functions, classes and their public methods
    take the JAX parameters first, with equal defaults (but in NAME_ONLY).
    In the pure modules (CALLED) the constants and tables are equal, and
    the functions of no argument give equal results."""
    jmod = importlib.import_module("wenet_tpu." + name)
    tmod = importlib.import_module("wenet_tpu_torch." + name)
    want, got = _public(jmod), _public(tmod)
    missing = set(want) - set(got)
    assert missing == NOT_PORTED.get(name, set()), sorted(missing)
    if name not in NAME_ONLY:
        for key, value in want.items():
            if not callable(value) or key in missing:
                continue
            assert _same_signature(value, got[key]), key
            if isinstance(value, type):
                for meth, fn in vars(value).items():
                    if callable(fn) and not meth.startswith("_"):
                        assert _same_signature(
                            fn, getattr(got[key], meth)), f"{key}.{meth}"
    if name not in CALLED:
        return
    for key, value in want.items():
        other = got[key]
        if callable(value):
            try:
                a = value()
            except TypeError:           # needs arguments: checked below
                continue
            b = other()
            pairs = zip(a, b, strict=True) if isinstance(a, tuple) \
                else [(a, b)]
            for x, y in pairs:
                assert _same(x, y), key
        else:
            assert _same(value, other), key


@pytest.mark.parametrize("name", MESH_FUNCTIONS,
                         ids=[n.split(".")[-1] for n in MESH_FUNCTIONS])
def test_mesh_functions_keep_the_jax_parameters(name):
    """The JAX parameters that the port takes come in JAX's order with
    JAX's defaults, `mesh=None` among them, and the port's `device=`
    after `mesh`."""
    module, fn = name.rsplit(".", 1)
    jfn = getattr(importlib.import_module("wenet_tpu." + module), fn)
    tfn = getattr(importlib.import_module("wenet_tpu_torch." + module), fn)
    want = [(n, d) for n, d in _params(jfn) if n not in NOT_PORTED_PARAMS]
    got = _params(tfn)
    assert [(n, d) for n, d in got if n in dict(want)] == want
    names = [n for n, _ in got]
    assert dict(got)["mesh"] is None
    assert names.index("device") > names.index("mesh")


def test_framing_and_table_helpers_match():
    rng = np.random.default_rng(7)
    pk = rng.integers(0, 256, (9, 258), dtype=np.uint8)
    crc = framing.crc16_ccitt_batch(pk)
    assert crc.dtype == np.uint16
    np.testing.assert_array_equal(crc, jframing.crc16_ccitt_batch(pk))
    assert [int(c) for c in crc] == [framing.crc16_ccitt(p.tobytes())
                                     for p in pk]
    bits = rng.integers(0, 2, 8 * 37).astype(np.uint8)
    assert framing.bits_to_bytes_msb(bits) == jframing.bits_to_bytes_msb(bits)
    for a, b in zip(framing.load_scramble_tables(),
                    jframing.load_scramble_tables(), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ldpc_tables.sanity_check() is True
    for a, b in zip(ldpc_tables.edges_flat(), jtables.edges_flat(),
                    strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for baud, over in ((9600, 10), (96000, 10), (115177, 8)):
        for fn in ("sdr_rate", "tuning_offset", "expected_tones"):
            assert getattr(tuning, fn)(baud, over) == \
                getattr(jtuning, fn)(baud, over)
        assert tuning.sdr_centre(443.5e6, baud, over) == \
            jtuning.sdr_centre(443.5e6, baud, over)


@pytest.mark.parametrize("snr_db", [1.5, 2.5, 4.0])
def test_decode_np_matches_jax(snr_db):
    """Bits, iterations and parity exact on the same float32 LLRs (some
    codewords converge, some exhaust max_iter at 1.5 dB); a 1-D LLR gets a
    batch dimension; max_iter is honoured."""
    rng = np.random.default_rng(int(snr_db * 10))
    ib = np.unpackbits(rng.integers(0, 256, (6, 258), dtype=np.uint8), axis=1)
    cw = np.concatenate([ib, tldpc.encode_bits_np(ib)], axis=1)
    esn0 = 10 ** (snr_db / 10) * 0.8
    sd = (1 - 2.0 * cw) + rng.normal(0, np.sqrt(1 / (2 * esn0)), cw.shape)
    llr = tldpc.sd_to_llr(torch.as_tensor(sd, dtype=torch.float32)).numpy()
    for max_iter in (10, 3):
        got = tldpc.decode_np(llr, max_iter, device="cpu")
        want = jldpc.decode_np(llr, max_iter)
        for a, b in zip(got, want, strict=True):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
        assert int(got[1].max()) <= max_iter
    one = tldpc.decode_np(llr[0], device="cpu")
    assert one[0].shape == (1, 2580)
    np.testing.assert_array_equal(one[0][0], tldpc.decode_np(
        llr, device="cpu")[0][0])


def test_selftest_passes_on_the_cpu(capsys):
    assert selftest.run(verbose=True, device="cpu") == 0
    err = capsys.readouterr().err
    assert "device: cpu" in err and "PASS" in err
    assert selftest.main(["--device", "cpu"]) == 0


def test_glibc_rand_bits_match():
    for seed, n in ((158324, 100), (1, 257)):
        np.testing.assert_array_equal(tber.glibc_rand_bits(seed, n),
                                      jber.glibc_rand_bits(seed, n))
    rx = np.random.default_rng(0).integers(0, 2, 900).astype(np.uint8)
    frame = jber.glibc_rand_bits(158324, 100)
    rx[300:400] = frame
    assert tber.sliding_testframe_ber(rx, frame) == \
        jber.sliding_testframe_ber(rx, frame)


@pytest.mark.parametrize("ebno_db", [5.0, 9.0])
def test_run_ber_matches_jax(ebno_db):
    """The same capture (make_testframe_capture from the same seed) gives
    the same bits, errors and sync through both demods."""
    iq_t, frame_t = tber.make_testframe_capture(tfsk.FSKConfig(**GEOM),
                                                ebno_db, 0.5)
    iq_j, frame_j = jber.make_testframe_capture(jfsk.FSKConfig(**GEOM),
                                                ebno_db, 0.5)
    np.testing.assert_array_equal(iq_t, iq_j)
    np.testing.assert_array_equal(frame_t, frame_j)
    got = tber.run_ber(tfsk.FSKConfig(**GEOM), ebno_db, 0.5, device="cpu")
    want = jber.run_ber(jfsk.FSKConfig(**GEOM), ebno_db, 0.5)
    assert got == want
    assert got["sync_found"] and got["bits"] > 0


def test_run_sweep_matches_jax():
    """A 3-point sweep of 4 packets: the same decoded bytes at each level,
    and the same table less its runtimes."""
    levels = [5.0, 7.0, 12.0]
    lt, lj = [], []
    got = tbench.run_sweep("v2", 4, levels, cfg=tfsk.FSKConfig(**GEOM),
                           log=lt.append, device="cpu")
    want = jbench.run_sweep("v2", 4, levels, cfg=jfsk.FSKConfig(**GEOM),
                            log=lj.append)
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert got[-1][1] == 4 * 256
    assert [ln.rsplit("|", 1)[0] for ln in lt] == \
        [ln.rsplit("|", 1)[0] for ln in lj]


COMMANDS = ("rx", "tx", "flight", "ber", "bench", "ssdv", "web", "console",
            "gui", "telemetrygui")


@pytest.mark.parametrize("argv,rc", [
    (["ber", "--device", "cpu", "--fs", "96000", "--rs", "9600",
      "--ebno", "10", "--seconds", "0.3"], 0),
    (["bench", "--device", "cpu", "--fs", "96000", "--rs", "9600",
      "--packets", "2", "--ebno-start", "12", "--ebno-stop", "13",
      "--ebno-step", "1"], 0),
    (["nosuchcommand"], 1),
    (["--help"], 0),
    (["flight", "--help"], 0),
    (["web", "--port", "0", "--callsign", "VK5QI"], 0),
    (["console"], 0),
    (["gui"], 0),
    (["telemetrygui"], 0),
], ids=["ber", "bench", "unknown", "help", "flight", "web", "console",
        "gui", "telemetrygui"])
def test_dispatcher(argv, rc, monkeypatch, capsys):
    """Each command reaches its entry point with the JAX dispatcher's
    arguments.  The apps listen on ports the OS picks (UDP port 0) and
    stop at once: the web server at the first sleep of its loop (as at
    Ctrl-C), the console after no packet, the terminal GUIs after one
    status line."""
    import time

    from wenet_tpu_torch.rx import gui, telemetry_console, web
    made = []

    class Web(web.WenetWebServer):
        def __init__(self, **kw):
            made.append(kw)
            super().__init__(**dict(kw, host="127.0.0.1", udp_port=0))

    def interrupt(_):
        raise KeyboardInterrupt

    listen, image_gui, telemetry_gui = (telemetry_console.listen,
                                        gui.run_image_gui,
                                        gui.run_telemetry_gui)
    monkeypatch.setattr(web, "WenetWebServer", Web)
    monkeypatch.setattr(telemetry_console, "listen",
                        lambda: listen(port=0, max_packets=0))
    monkeypatch.setattr(gui, "run_image_gui",
                        lambda: image_gui(port=0, refresh_s=0, iterations=1))
    monkeypatch.setattr(gui, "run_telemetry_gui", lambda: telemetry_gui(
        port=0, refresh_s=0, iterations=1))
    if argv[0] == "web":
        monkeypatch.setattr(time, "sleep", interrupt)
    monkeypatch.setattr(sys, "argv", ["wenet_tpu_torch", *argv])
    try:
        got = dispatcher.main()
    except SystemExit as e:            # argparse's --help
        got = e.code
    assert got == rc
    out = capsys.readouterr()
    if argv[0] == "flight":
        assert "--images-dir" in out.out and "--set-system-clock" in out.out
    if argv[0] == "web":
        assert made == [dict(host="0.0.0.0", port=0,
                             image_dir="./rx_images", my_callsign="VK5QI",
                             horus_udp_port=0)]
        assert out.out.startswith("web GUI on :")
    if argv[0] == "gui":
        assert out.out == "[rx_gui] (no image yet) |  | upload q=0 ok=0 " \
            "drop=0\n"
    if argv[0] == "telemetrygui":
        assert out.out == "[telemetry] packets=0 (no GPS fix yet)\n"
    if argv[0] == "ber":
        assert "BER" in out.out and len(out.out.strip().splitlines()) == 2
    if argv[0] == "bench":
        assert out.out.strip().splitlines()[-1].split("|")[1].strip() == "512"
    if argv[0] == "--help":
        for cmd in COMMANDS:
            assert f"  {cmd} " in out.out
        assert "{" + ",".join(COMMANDS) + "}" in out.out
