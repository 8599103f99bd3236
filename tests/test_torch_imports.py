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
from wenet_tpu_torch.ops import ldpc
from wenet_tpu_torch.rx.pipeline import Receiver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "wenet_tpu_torch")


def test_port_imports_no_jax():
    code = ("import sys, wenet_tpu_torch, wenet_tpu_torch.rx.pipeline, "
            "wenet_tpu_torch.cli.rx, wenet_tpu_torch.kernels.bp_decode, "
            "wenet_tpu_torch.ops.deframe; "
            "print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_receive_path_imports_nothing_of_the_jax_package():
    """The receive path and chip_smoke.py's own imports load no module of
    `wenet_tpu`; only the CLI's payload sink (its router) is shared."""
    code = ("import sys, wenet_tpu_torch.rx.pipeline, wenet_tpu_torch.cli.rx, "
            "wenet_tpu_torch.ops.deframe, chip_smoke; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('wenet_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        assert not re.search(r"^\s*(from|import) (jax|wenet_tpu)\b",
                             fh.read(), re.M)


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
