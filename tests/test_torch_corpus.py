"""The port's corpus tool (wenet_tpu_torch/tools/corpus_e2e.py) on the CPU
at the scaled v2 geometry (Fs=96000, Rs=9600), on small JPEGs made with
Pillow in a temporary directory:

- an image's capture is byte-equal to what tools/corpus_e2e.py's steps
  make with the JAX package from the same SSDV packets and seed;
- the port's Receiver gives JAX's Receiver's payloads on those cu8 bytes
  (the JAX tool's call: the bytes converted to complex64 on the host),
  every packet sent, and the reassembled JPEG equals `ssdv.decode` of the
  packets sent; the fused decoders give the same list;
- main() with --images over two images (rows, summary, exit 0), exit 1
  when nothing matches; the images' order and ids.
"""
import numpy as np
import pytest
import torch
from PIL import Image

from wenet_tpu import ssdv as jssdv
from wenet_tpu.core import framing as jframing
from wenet_tpu.ops import channel as jchannel
from wenet_tpu.ops import fsk as jfsk
from wenet_tpu.ops import ldpc as jldpc
from wenet_tpu.rx.pipeline import Receiver as JaxReceiver
from wenet_tpu_torch import ssdv
from wenet_tpu_torch.ops import fsk
from wenet_tpu_torch.rx import pipeline
from wenet_tpu_torch.tools import corpus_e2e

torch.set_num_threads(1)

TCFG = fsk.FSKConfig(Fs=96000, Rs=9600)
JCFG = jfsk.FSKConfig(Fs=96000, Rs=9600)
SIZE = (48, 32)          # the images' width and height here
PAD = 100_000            # samples the captures are padded to


def _jpeg(path, seed):
    """A small RGB gradient with noise on it (3 SSDV packets), saved as
    JPEG."""
    y, x = np.mgrid[0:SIZE[1], 0:SIZE[0]]
    noise = np.random.default_rng(seed).integers(0, 80, (*y.shape, 3))
    rgb = np.stack([x * 5 + 20, y * 7, (x + y) * 3], -1) + noise
    Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).save(path, "JPEG")
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    return d, [_jpeg(d / "7.jpg", 0), _jpeg(d / "12.jpg", 1)]


def _jax_capture(pkts, name):
    """tools/corpus_e2e.py's steps with the JAX package, its seed the
    port's (crc32 of the name)."""
    rng = np.random.default_rng(corpus_e2e.seed(name))
    bits = [rng.integers(0, 2, JCFG.Nbits * 4).astype(np.uint8)]
    for p in pkts:
        frame = jframing.frame_packet(p, jldpc.encode_bytes, "v2")
        bits.append(jframing.frame_to_bits(frame, "v2"))
    stream = np.concatenate(bits)
    stream = np.concatenate(
        [stream, np.zeros((-len(stream)) % JCFG.Nbits, np.uint8)])
    sig, _ = jfsk.fsk_mod_np(JCFG, stream, 2 * JCFG.Rs, JCFG.Rs)
    iq = jchannel.add_awgn(sig.astype(np.complex64), 12.0, JCFG.Fs, JCFG.Rs,
                           rng=rng)
    iq = np.concatenate([iq, np.zeros(PAD - len(iq), np.complex64)])
    return jfsk.iq_to_cu8(iq)


def test_capture_is_byte_equal_and_the_receiver_matches_jax(corpus):
    _, paths = corpus
    jpg = corpus_e2e.load_jpeg(paths[0], SIZE)
    pkts = ssdv.encode(jpg, corpus_e2e.CALLSIGN, 7)
    assert pkts == jssdv.encode(jpg, "VK5QI", 7) and len(pkts) >= 3
    raw, n_signal = corpus_e2e.capture(
        pkts, TCFG, "v2", 12.0, np.random.default_rng(corpus_e2e.seed(
            "7.jpg")), PAD)
    want_raw = _jax_capture(pkts, "7.jpg")
    assert raw.dtype == want_raw.dtype == np.uint8
    assert raw.tobytes() == want_raw.tobytes() and n_signal < PAD
    got = corpus_e2e.decode(raw, "v2", TCFG, device="cpu")
    want = JaxReceiver(mode="v2", cfg=JCFG).decode_iq(jfsk.iq_from_cu8(raw))
    assert got == want == pkts
    assert ssdv.decode(got) == ssdv.decode(pkts) == jssdv.decode(want)
    for fused, slabs in ((2, 0), (4, 2)):
        assert corpus_e2e.decode(raw, "v2", TCFG, fused, slabs,
                                 "cpu") == pkts


def test_run_image_row(corpus):
    _, paths = corpus
    row = corpus_e2e.run_image(paths[1], 12, TCFG, device="cpu",
                               resolution=SIZE, pad_len=PAD)
    assert row["name"] == "12.jpg" and row["jpeg_equal"]
    assert row["decoded"] == row["packets"] >= 3
    jpg = corpus_e2e.load_jpeg(paths[1], SIZE)
    assert row["pixdiff"] == corpus_e2e.pixel_diff(
        jpg, ssdv.decode(ssdv.encode(jpg, "VK5QI", 12))) >= 0.0
    assert row["samples"] < PAD
    assert row["seconds"] > 0


def test_main_over_the_corpus(corpus, monkeypatch, capsys):
    d, _ = corpus
    monkeypatch.setattr(corpus_e2e, "RESOLUTION", SIZE)
    monkeypatch.setattr(corpus_e2e, "PAD_SAMPLES", PAD)
    monkeypatch.setitem(pipeline.MODE_CONFIGS, "v2", TCFG)
    assert corpus_e2e.main(["--images", str(d / "*.jpg"), "--device",
                            "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].split()[0] == "7.jpg" and out[1].split()[0] == "12.jpg"
    assert all("jpeg_equal= True" in ln for ln in out[:2])
    assert out[-1].startswith("Total: 2 images") and "2/2 images" in out[-1]
    assert corpus_e2e.main(["--images", str(d / "*.jpg"), "--limit", "1",
                            "--device", "cpu"]) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 3


def test_no_image_exits_nonzero(tmp_path, capsys):
    assert corpus_e2e.main(["--images", str(tmp_path / "*.jpg"),
                            "--device", "cpu"]) == 1
    assert "no image matches" in capsys.readouterr().err


def test_image_order_and_ids(tmp_path):
    for name in ("10.jpg", "2.jpg", "b.jpg", "a.jpg", "300.jpg"):
        (tmp_path / name).write_bytes(b"")
    got = [(p.rsplit("/", 1)[1], i)
           for p, i in corpus_e2e.images(str(tmp_path / "*.jpg"))]
    assert got == [("2.jpg", 2), ("10.jpg", 10), ("300.jpg", 44),
                   ("a.jpg", 3), ("b.jpg", 4)]
    assert corpus_e2e.seed("7.jpg") == corpus_e2e.seed("7.jpg") != \
        corpus_e2e.seed("8.jpg")
