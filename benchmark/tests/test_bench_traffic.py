"""The frozen generator starts equal to the port's capture functions, and
the generator and the reference load nothing of the program."""
import subprocess
import sys

import numpy as np
import torch

from benchmark import traffic
from benchmark.tests.conftest import ROOT

V2 = traffic.Deployment("v2_flight", "v2", 960000, 96000, 2, 48,
                        (192000, 288000), 10)
V1 = traffic.Deployment("v1_classic", "v1", 921416, 115177, 2, 48,
                        (230354, 345531), 10)


def test_bits_equal_the_ports_capture_function():
    from wenet_tpu_torch.ops import fsk
    from wenet_tpu_torch.tools import captures
    for dep, cfg in ((V2, fsk.V2_CONFIG), (V1, fsk.V1_CONFIG)):
        for gap, lead in ((512, 2048), (0, 0)):
            bits, payloads = traffic.packet_bits(
                dep, 3, np.random.default_rng(2 ** 31 + 9), gap, lead)
            want = captures.make_packet_bits(
                cfg, 3, np.random.default_rng(2 ** 31 + 9), gap_bits=gap,
                lead_bits=lead, mode=dep.mode)
            assert np.array_equal(bits, want[: len(bits)])
            assert not want[len(bits):].any()      # the port pads with 0s
            assert [p.tobytes() for p in payloads] == captures.packet_payloads(
                3, np.random.default_rng(2 ** 31 + 9), gap, lead)


def test_modulator_and_quantiser_equal_the_ports():
    from wenet_tpu_torch.ops import fsk
    bits = np.random.default_rng(3).integers(0, 2, 480).astype(np.uint8)
    for dep, cfg in ((V2, fsk.V2_CONFIG), (V1, fsk.V1_CONFIG)):
        want, _ = fsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
        got = traffic.modulate(dep, torch.from_numpy(bits)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
        iq = (want / np.abs(want).max() * 0.9).astype(np.complex64)
        assert np.array_equal(traffic.to_cu8(torch.from_numpy(iq)).numpy(),
                              fsk.iq_to_cu8(iq))


def test_recording_is_whole_frames_and_repeats_from_its_seed():
    rec = traffic.make_recording(V2, 0.1, 12.0, 2 ** 33 + 1, 0, 0, 0, "cpu")
    assert len(rec.payloads) == 9600 // V2.frame_bits
    assert rec.n_samples == len(rec.payloads) * V2.frame_bits * V2.Ts
    assert rec.ends[-1] == rec.n_samples
    assert len(rec.raw) == 2 * rec.n_samples
    again = traffic.make_recording(V2, 0.1, 12.0, 2 ** 33 + 1, 0, 0, 0,
                                   "cpu")
    assert np.array_equal(rec.raw, again.raw)
    other = traffic.make_recording(V2, 0.1, 12.0, 2 ** 33 + 1, 1, 0, 0,
                                   "cpu")
    assert rec.payloads != other.payloads
    lead = traffic.make_recording(V1, 0.1, 12.0, 7, 0, 0, 2048, "cpu")
    assert lead.ends[0] == (2048 + V1.frame_bits) * V1.Ts


def test_generator_and_reference_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.traffic, benchmark.reference, benchmark.judge;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'wenet_tpu_torch', 'wenet_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code, ROOT], check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"
