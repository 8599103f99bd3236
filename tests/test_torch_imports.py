"""The PyTorch port imports no JAX, mirrors the JAX package's host-side
helpers exactly, and never runs a CUDA request on the CPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from wenet_tpu.core import framing as jframing
from wenet_tpu.core import ldpc_tables as jtables
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu_torch.core import framing
from wenet_tpu_torch.core import ldpc_tables as tables
from wenet_tpu_torch.device import resolve_device
from wenet_tpu_torch.ops import fsk as tfsk
from wenet_tpu_torch.ops import ldpc, ldpc_onehot
from wenet_tpu_torch.parallel import sweep
from wenet_tpu_torch.rx.pipeline import Receiver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "wenet_tpu_torch")
# the decoder and Monte-Carlo path: LDPC variants, sweeps, acquisition
NEW_MODULES = ("wenet_tpu_torch.ops.ldpc_onehot, wenet_tpu_torch.ops.channel, "
               "wenet_tpu_torch.kernels.bp_onehot, "
               "wenet_tpu_torch.parallel.sweep, "
               # the fused receiver and the demod frame-loop kernel
               "wenet_tpu_torch.kernels.fsk_demod, "
               # the wideband path, the CRC and top-k acquisition kernels
               "wenet_tpu_torch.ops.channelizer, "
               "wenet_tpu_torch.kernels.channelize, "
               "wenet_tpu_torch.kernels.crc_pack, "
               "wenet_tpu_torch.kernels.deframe_topk, "
               # the modem tools, the transmit side and their helpers
               "wenet_tpu_torch.core.tuning, wenet_tpu_torch.utils.probe, "
               "wenet_tpu_torch.rx.selftest, wenet_tpu_torch.cli.ber, "
               "wenet_tpu_torch.cli.bench_demod, wenet_tpu_torch.cli.tx, "
               "wenet_tpu_torch.cli.ssdv_cli, wenet_tpu_torch.tx, "
               "wenet_tpu_torch.tx.packet_tx, wenet_tpu_torch.tx.radios, "
               "wenet_tpu_torch.tx.sx127x, wenet_tpu_torch.ssdv.external, "
               "wenet_tpu_torch.__main__, "
               # the ground-station apps, the examples and the flight side
               "wenet_tpu_torch.rx.telemetry_console, "
               "wenet_tpu_torch.rx.uploader, wenet_tpu_torch.rx.web, "
               "wenet_tpu_torch.rx.gui, wenet_tpu_torch.examples, "
               "wenet_tpu_torch.examples.link_emulation, "
               "wenet_tpu_torch.examples.rx_tester, "
               "wenet_tpu_torch.examples.sec_payload_rx, "
               "wenet_tpu_torch.tx.gps, wenet_tpu_torch.tx.ubx, "
               "wenet_tpu_torch.tx.pi_utils, wenet_tpu_torch.tx.camera, "
               "wenet_tpu_torch.cli.flight, "
               # the scale-out layer
               "wenet_tpu_torch.parallel.mesh, "
               "wenet_tpu_torch.parallel.sharded_ldpc, "
               "wenet_tpu_torch.parallel.dryrun, "
               # the host runtime in C
               "wenet_tpu_torch.native, "
               # the measurement tools
               "wenet_tpu_torch.tools.captures, "
               "wenet_tpu_torch.tools.chain_scaling, "
               "wenet_tpu_torch.tools.loss_census, "
               "wenet_tpu_torch.tools.minsum_scaling, "
               "wenet_tpu_torch.tools.wideband_scaling, "
               "wenet_tpu_torch.tools.wideband_where, "
               "wenet_tpu_torch.tools.fused_where, "
               "wenet_tpu_torch.tools.fused_profile, "
               "wenet_tpu_torch.tools.pp_breakdown, "
               "wenet_tpu_torch.tools.stream_tune, "
               # the benchmark and the corpus tool
               "wenet_tpu_torch.bench, wenet_tpu_torch.tools.corpus_e2e")


def test_port_imports_no_jax():
    code = ("import sys, wenet_tpu_torch, wenet_tpu_torch.rx.pipeline, "
            "wenet_tpu_torch.cli.rx, wenet_tpu_torch.kernels.bp_decode, "
            "wenet_tpu_torch.ops.deframe, wenet_tpu_torch.rx.router, "
            "wenet_tpu_torch.rx.stats, wenet_tpu_torch.ssdv, "
            + NEW_MODULES + "; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_receive_path_imports_nothing_of_the_jax_package(tmp_path):
    """No module of `wenet_tpu_torch`, and not chip_smoke.py, loads a module
    of `wenet_tpu` or `jax`: every module of the package is imported, then
    the CLI runs to its end on an empty capture (its payload sink is
    imported inside `main`)."""
    empty = tmp_path / "empty.cu8"
    empty.write_bytes(b"")
    code = (
        "import pkgutil, sys, wenet_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(wenet_tpu_torch.__path__, "
        "'wenet_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "from wenet_tpu_torch.cli import rx\n"
        f"assert rx.main([{str(empty)!r}, '--device', 'cpu', '--no-udp', "
        f"'--image-dir', {str(tmp_path / 'img')!r}]) == 0\n"
        "assert 'wenet_tpu_torch.rx.router' in sys.modules\n"
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('wenet_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    pat = re.compile(r"^\s*(from|import) (jax|wenet_tpu)\b", re.M)
    sources = [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                                "chip_profile.py")]
    for dirpath, _, files in os.walk(PKG):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    for path in sources:
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_tools_import_nothing_of_bench_jax_or_the_jax_package():
    """The measurement tools carry their own copies of bench.py's capture
    builders: importing every one of them loads no module of `bench`,
    `jax` or `wenet_tpu`, and no source of the port imports `bench`."""
    code = ("import pkgutil, sys, wenet_tpu_torch.tools as t\n"
            "for m in pkgutil.iter_modules(t.__path__, t.__name__ + '.'):\n"
            "    __import__(m.name)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('bench', 'jax', 'wenet_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    pat = re.compile(r"^\s*(from|import) bench\b", re.M)
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_flight_side_imports_without_pillow_or_requests():
    """`tx.camera` and `cli.flight` (and the apps that post with
    `requests`) import where Pillow and `requests` are absent, as on the
    machine with the card; the flight CLI's --help runs there."""
    code = ("import sys\n"
            "sys.modules['PIL'] = sys.modules['PIL.Image'] = None\n"
            "sys.modules['requests'] = None\n"
            "import wenet_tpu_torch.tx.camera, wenet_tpu_torch.cli.flight\n"
            "import wenet_tpu_torch.rx.uploader, wenet_tpu_torch.rx.web\n"
            "from wenet_tpu_torch.cli.flight import main\n"
            "try:\n"
            "    main(['--help'])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('PIL', 'requests', 'jax')\n"
            "             and sys.modules[m] is not None))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_bench_and_corpus_import_without_pillow():
    """The benchmark and the corpus tool import where Pillow is absent
    (the corpus tool reads and compares images with it only when it runs),
    and load no module of `bench`, `jax` or `wenet_tpu`."""
    code = ("import sys\n"
            "sys.modules['PIL'] = sys.modules['PIL.Image'] = None\n"
            "import wenet_tpu_torch.bench, wenet_tpu_torch.tools.corpus_e2e\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('PIL', 'bench', 'jax',\n"
            "                                    'wenet_tpu', 'tools')\n"
            "             and sys.modules[m] is not None))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_native_imports_no_jax_and_compiles_nothing():
    """`wenet_tpu_torch.native` and the deframer that calls it import no
    module of `jax` or `wenet_tpu`, and importing them starts no compiler
    and loads no library: the C FSM is built at its first call."""
    code = ("import subprocess, sys\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError(f'started {a!r}')\n"
            "subprocess.run = subprocess.Popen = refuse\n"
            "import wenet_tpu_torch.native as native\n"
            "import wenet_tpu_torch.ops.deframe\n"
            "assert native._lib is None and native.build_seconds is None\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('wenet_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f


CFG_KW = [dict(Fs=921416, Rs=115177), dict(Fs=960000, Rs=96000),
          dict(Fs=96000, Rs=9600), dict(Fs=92000, Rs=11500),
          dict(Fs=48000, Rs=9600), dict(Fs=96000, Rs=9600, M=4),
          dict(Fs=96000, Rs=9600, est_min=1000, est_max=40000)]
PROPS = ["Fs", "Rs", "M", "P", "Nsym", "est_min", "est_max", "Ts", "N",
         "Nmem", "nstash", "Ndft", "est_space", "Nbits", "f_min_bin",
         "f_max_bin", "f_zero_bins", "ema_tc", "max_fft_blocks", "nin_choices"]


@pytest.mark.parametrize("kw", CFG_KW, ids=lambda kw: f"{kw['Fs']}_{kw['Rs']}"
                         f"_{kw.get('M', 2)}_{kw.get('est_min', '')}")
def test_fsk_config_matches(kw):
    j, t = jfsk.FSKConfig(**kw), tfsk.FSKConfig(**kw)
    for p in PROPS:
        assert getattr(t, p) == getattr(j, p), p
    assert t.num_frames(123457) == j.num_frames(123457)


def test_standard_configs_match():
    for a, b in ((tfsk.V1_CONFIG, jfsk.V1_CONFIG),
                 (tfsk.V2_CONFIG, jfsk.V2_CONFIG)):
        assert [getattr(a, p) for p in PROPS] == [getattr(b, p) for p in PROPS]


def test_host_helpers_match():
    cfg_kw = dict(Fs=96000, Rs=9600, M=4)
    j, t = jfsk.FSKConfig(**cfg_kw), tfsk.FSKConfig(**cfg_kw)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 192).astype(np.uint8)
    sj, pj = jfsk.fsk_mod_np(j, bits, 19200, 9600, phase_acc=7)
    st, pt = tfsk.fsk_mod_np(t, bits, 19200, 9600, phase_acc=7)
    np.testing.assert_array_equal(st, sj)
    assert pt == pj
    np.testing.assert_array_equal(tfsk.hann_window(256), jfsk.hann_window(256))
    raw8 = rng.integers(0, 256, 64, dtype=np.uint8)
    np.testing.assert_array_equal(tfsk.iq_from_cu8(raw8), jfsk.iq_from_cu8(raw8))
    raw16 = rng.integers(-3000, 3000, 64).astype(np.int16)
    np.testing.assert_array_equal(tfsk.iq_from_cs16(raw16),
                                  jfsk.iq_from_cs16(raw16))
    np.testing.assert_array_equal(tfsk.iq_to_cu8(sj / 2), jfsk.iq_to_cu8(sj / 2))


def test_core_tables_match():
    """The port's copies of the code tables equal the JAX package's."""
    for name in ("N_PARITY", "N_DATA", "CODE_LEN", "MAX_COL_W", "MAX_ITER",
                 "MAX_CHECK_DEG"):
        assert getattr(tables, name) == getattr(jtables, name), name
    pairs = [(tables.encoder_taps(), jtables.encoder_taps())]
    for fn in ("check_edges", "var_edges"):
        pairs += zip(getattr(tables, fn)(), getattr(jtables, fn)(), strict=True)
    for a, b in pairs:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(framing.CRC16_TABLE, jframing._CRC16_TABLE)
    np.testing.assert_array_equal(framing.SCRAMBLE_PM1, jframing.SCRAMBLE_PM1)
    np.testing.assert_array_equal(framing.TX_XOR, jframing.TX_XOR)


@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_core_framing_matches(mode):
    """The port's framing copy frames, strips and descrambles exactly as the
    JAX package's does."""
    for name in ("V1_UW_ALLOWED_ERRORS", "V1_SYMBOLS_PER_PACKET",
                 "V2_UW_ALLOWED_ERRORS", "V2_SYMBOLS_PER_PACKET"):
        assert getattr(framing, name) == getattr(jframing, name), name
    np.testing.assert_array_equal(framing.UW_BITS_V1, jframing.UW_BITS_V1)
    np.testing.assert_array_equal(framing.UW_BITS_V2, jframing.UW_BITS_V2)
    rng = np.random.default_rng(4)
    for n in (0, 17, 256, 300):
        p = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert framing.pad_payload(p) == jframing.pad_payload(p)
        assert framing.crc16_ccitt(p) == jframing.crc16_ccitt(p)
        f = framing.frame_packet(p, ldpc.encode_bytes, mode)
        assert f == jframing.frame_packet(p, ldpc.encode_bytes, mode)
        np.testing.assert_array_equal(framing.frame_to_bits(f, mode),
                                      jframing.frame_to_bits(f, mode))
    soft = rng.normal(0, 1, (3, 3230)).astype(np.float32)
    np.testing.assert_array_equal(framing.rs232_strip_soft(soft),
                                  jframing.rs232_strip_soft(soft))
    np.testing.assert_array_equal(framing.rx_descramble_soft(soft),
                                  jframing.rx_descramble_soft(soft))


def test_cuda_requests_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Receiver(mode="v2")                  # device defaults to cuda
    with pytest.raises(ValueError):
        ldpc.decode(torch.zeros(1, 2580, device="meta"))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        sweep.ldpc_ber_sweep([3.0], 4)           # device defaults to cuda
    with pytest.raises(RuntimeError):
        sweep.acquisition_search(tfsk.FSKConfig(Fs=96000, Rs=9600),
                                 np.zeros(4096, np.complex64), [0.0])
    with pytest.raises(ValueError):
        ldpc_onehot.decode_onehot(torch.zeros(1, 2580, device="meta"))


@pytest.mark.parametrize("name", ["demod_init", "state_from_numpy",
                                  "decode_windows", "decode_candidates",
                                  "StreamDeframer", "deframe_soft",
                                  "deframe_topk", "decode_iq_fused",
                                  "decode_iq_fused_overlap", "FusedReceiver",
                                  "decode_iq_parallel", "channelize",
                                  "demod_multichannel", "demod_iq_np",
                                  "decode_np", "probe_demod", "selftest",
                                  "run_ber", "run_sweep", "LinkEmulator",
                                  "chain_lanes", "chain_scaling",
                                  "loss_census", "minsum_scaling",
                                  "wideband_scaling", "wideband_where",
                                  "fused_where", "fused_profile",
                                  "pp_breakdown", "stream_tune",
                                  "bench", "corpus_e2e"])
def test_public_functions_default_to_the_card(name, monkeypatch):
    """Called without a device, the port's public demod and deframe entry
    points ask for CUDA, and without a card they raise instead of running
    on the CPU."""
    from wenet_tpu_torch import bench
    from wenet_tpu_torch.cli import bench_demod, ber
    from wenet_tpu_torch.examples.link_emulation import LinkEmulator
    from wenet_tpu_torch.ops import channelizer, deframe
    from wenet_tpu_torch.rx import pipeline, selftest
    from wenet_tpu_torch.tools import chain_scaling, fused_profile
    from wenet_tpu_torch.tools import fused_where, loss_census
    from wenet_tpu_torch.tools import minsum_scaling, pp_breakdown
    from wenet_tpu_torch.tools import corpus_e2e, stream_tune
    from wenet_tpu_torch.tools import wideband_scaling, wideband_where
    from wenet_tpu_torch.utils import probe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tfsk.FSKConfig(Fs=96000, Rs=9600)
    syms = framing.V2_SYMBOLS_PER_PACKET
    calls = {
        "demod_init": lambda: tfsk.demod_init(cfg),
        "state_from_numpy": lambda: tfsk.state_from_numpy(
            tfsk.state_to_numpy(tfsk.demod_init(cfg, "cpu"))),
        "decode_windows": lambda: deframe.decode_windows(
            np.zeros((1, syms))),
        "decode_candidates": lambda: deframe.decode_candidates(
            np.zeros(2 * syms, np.float32), np.array([3])),
        "StreamDeframer": lambda: deframe.StreamDeframer("v2"),
        "deframe_soft": lambda: deframe.deframe_soft(
            np.zeros(100, np.float32)),
        "deframe_topk": lambda: deframe.deframe_topk(
            np.zeros(2 * syms, np.float32)),
        "decode_iq_fused": lambda: pipeline.decode_iq_fused(
            np.zeros(2000, np.uint8), cfg=cfg),
        "decode_iq_fused_overlap": lambda: pipeline.decode_iq_fused_overlap(
            np.zeros(2000, np.uint8), cfg=cfg),
        "FusedReceiver": lambda: pipeline.FusedReceiver(cfg=cfg),
        "decode_iq_parallel": lambda: pipeline.decode_iq_parallel(
            np.zeros(1000, np.complex64), cfg=cfg),
        "channelize": lambda: channelizer.channelize(
            np.zeros(64, np.complex64), 8),
        "demod_multichannel": lambda: channelizer.demod_multichannel(
            np.zeros(8 * 4000, np.complex64), 8 * cfg.Fs, 8, cfg),
        "demod_iq_np": lambda: tfsk.demod_iq_np(
            cfg, np.zeros(4000, np.complex64)),
        "decode_np": lambda: ldpc.decode_np(np.zeros((1, 2580), np.float32)),
        "probe_demod": lambda: probe.probe_demod(
            cfg, np.zeros(4000, np.complex64)),
        "selftest": lambda: selftest.run(verbose=False),
        "run_ber": lambda: ber.run_ber(cfg, 10.0, 0.1),
        "run_sweep": lambda: bench_demod.run_sweep(
            "v2", 1, [10.0], cfg=cfg, log=lambda *a: None),
        "LinkEmulator": lambda: LinkEmulator(tx_port=None, telemetry_port=0,
                                             through_modem=True, cfg=cfg),
        # the measurement tools: their functions and their CLIs
        "chain_lanes": lambda: chain_scaling.chain_lanes(
            cfg, np.zeros(4000, np.complex64), [10.0], 1),
        "chain_scaling": lambda: chain_scaling.main(["1"]),
        "loss_census": lambda: loss_census.run(1, 1, cfg=cfg),
        "minsum_scaling": lambda: minsum_scaling.main(["--batches", "1"]),
        "wideband_scaling": lambda: wideband_scaling.measure(2),
        "wideband_where": lambda: wideband_where.main(["2"]),
        "fused_where": lambda: fused_where.run(4, secs=0.5),
        "fused_profile": lambda: fused_profile.main(["--secs", "0.5"]),
        "pp_breakdown": lambda: pp_breakdown.run("v2", 1.0, cfg=cfg),
        "stream_tune": lambda: stream_tune.main(["--secs", "0.5"]),
        # the benchmark and the corpus tool
        "bench": lambda: bench.main([]),
        "corpus_e2e": lambda: corpus_e2e.main(["--images", "none"]),
    }
    with pytest.raises(RuntimeError, match="is_available"):
        calls[name]()
