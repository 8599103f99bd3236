"""The port's transmit side and host apps against the JAX package's, byte
for byte (CPU): the SX127x register driver, the radios' byte streams, the
packet engine's frames, `python -m wenet_tpu_torch tx` against
`python -m wenet_tpu tx` on the same arguments (c64, .bits), the port's
receiver on the port's own transmission, the `ssdv` CLI and the external
ssdv adapter.  The JPEGs are made with Pillow, which this machine has."""
import glob
import io
import json
import os

import numpy as np
import pytest

from wenet_tpu.cli.ssdv_cli import main as jax_ssdv_main
from wenet_tpu.cli.tx import main as jax_tx_main
from wenet_tpu.ssdv import external as jexternal
from wenet_tpu.tx import PacketTX as JPacketTX
from wenet_tpu.tx import radios as jradios
from wenet_tpu.tx import sx127x as jsx
from wenet_tpu_torch.cli.rx import main as rx_main
from wenet_tpu_torch.cli.ssdv_cli import main as ssdv_main
from wenet_tpu_torch.cli.tx import main as tx_main
from wenet_tpu_torch.ops import fsk as tfsk
from wenet_tpu_torch.ssdv import external
from wenet_tpu_torch.tx import PacketTX
from wenet_tpu_torch.tx import radios, sx127x

PIL = pytest.importorskip("PIL.Image")

GEOM = ["--fs", "96000", "--rs", "9600"]


def make_jpeg(w=160, h=128, seed=0, quality=80):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h // 16, w // 16, 3), dtype=np.uint8)
    arr = np.kron(base, np.ones((16, 16, 1), np.uint8))
    buf = io.BytesIO()
    PIL.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


class Recorder:
    """An SPI transport that logs every transaction into a RegisterFile."""

    def __init__(self, rf):
        self.rf, self.log = rf, []

    def xfer(self, frame):
        self.log.append(list(frame))
        return self.rf.xfer(frame)

    def teardown(self):
        self.log.append("teardown")


class Sink:
    """In-memory stand-in for a pyserial Serial / alsaaudio PCM."""

    def __init__(self):
        self.data = b""
        self.period_sizes = []
        self.closed = False

    def write(self, b):
        self.data += bytes(b)

    def setperiodsize(self, n):
        self.period_sizes.append(n)
        return n

    def close(self):
        self.closed = True


def _drive_radio(sx, kw):
    rec = Recorder(sx.RegisterFile(temperature_c=kw.pop("temp", 21.0)))
    radio = sx.RFM98W(transport=rec, reinit_count=3, **kw)
    ok = radio.start()
    for _ in range(7):
        radio.on_packet_transmitted()
    temp = radio.get_temperature()
    radio.shutdown()
    return (ok, rec.log, bytes(rec.rf.regs), rec.rf.mode_trace, temp,
            radio.reinit_events, rec.rf.carrier_hz(), rec.rf.deviation_hz(),
            rec.rf.power_dbm())


@pytest.mark.parametrize("kw", [
    dict(frequency_hz=443.5e6, baudrate=96000, tx_power_dbm=10),
    dict(frequency_hz=441.2e6, baudrate=115177, tx_power_dbm=17, temp=-70),
    dict(frequency_hz=434.65e6, baudrate=9600, tx_power_dbm=99, temp=5)],
    ids=["v2", "v1", "odd"])
def test_sx127x_register_sequences_match(kw):
    """The same SPI transactions, register file, mode trace, temperature
    and re-inits through both drivers; the tables and quantizers equal."""
    assert _drive_radio(sx127x, dict(kw)) == _drive_radio(jsx, dict(kw))
    assert sx127x.TX_POWER_LUT == jsx.TX_POWER_LUT
    for baud in (4800, 9600, 96000, 115177, 115200, 1234567):
        assert sx127x.deviation_for_baud(baud) == jsx.deviation_for_baud(baud)
    dead = sx127x.RegisterFile()
    dead.regs[sx127x.REG_VERSION] = 0
    assert not sx127x.RFM98W(transport=dead).start()


def _frames(mod, tx_cls):
    """Frames of every packet kind the engine makes, v2 and v1."""
    out = []
    for mode in ("v2", "v1"):
        sink = []
        radio = mod.BinaryDebugRadio(os.devnull, mode=mode)
        tx = tx_cls(radio, callsign="VK5QI")
        tx.transmit_text_message("hello port", repeats=2)
        tx.transmit_secondary_payload_packet(3, [1, 2, 3])
        tx.queue_image_packet(bytes(range(256)))
        while not tx.telemetry_queue_empty():
            sink.append(tx.telemetry_queue.get_nowait())
        while not tx.image_queue_empty():
            sink.append(tx.ssdv_queue.get_nowait())
        out += [tx.idle_message, tx.frame_packet(b"\x01\x02")] + sink
        radio.shutdown()
    return out


def test_packet_engine_frames_match():
    assert _frames(radios, PacketTX) == _frames(jradios, JPacketTX)


def test_radio_byte_streams_match(tmp_path):
    """I2S parameters and expansion, the UART (v1) and I2S (v2) streams
    with their period sizes, the RS232 debug file, BinaryDebugRadio's bit
    files and IQRadio's waveform (continuous phase across packets) equal
    the JAX package's."""
    for baud in (4800, 9600, 96000):
        assert radios.i2s_audio_params(baud) == jradios.i2s_audio_params(baud)
    for baud in (96001, 115200):
        with pytest.raises(ValueError):
            radios.i2s_audio_params(baud)
    data = bytes(range(256))
    assert radios.i2s_expand(data, 2) == jradios.i2s_expand(data, 2)
    np.testing.assert_array_equal(
        radios.i2s_line_bits(radios.i2s_expand(data, 3), 3),
        jradios.i2s_line_bits(jradios.i2s_expand(data, 3), 3))
    rng = np.random.default_rng(5)
    payloads = [rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
                for _ in range(3)]
    streams = []
    for mod, tx_cls in ((radios, PacketTX), (jradios, JPacketTX)):
        uart, pcm = Sink(), Sink()
        serial = mod.RFM98W_Serial(transport=uart, baudrate=115200)
        i2s = mod.RFM98W_I2S(pcm=pcm, baudrate=96000)
        chunks = []
        cfg = mod.fsk.FSKConfig(Fs=96000, Rs=9600)
        iq = mod.IQRadio(chunks.append, cfg=cfg, mode="v2")
        iq_regs = mod.RFM98W_IQ(chunks.append, mode="v1",
                                cfg=mod.fsk.FSKConfig(Fs=92000, Rs=11500))
        name = str(tmp_path / f"{mod.__name__}.bits")
        bits = mod.BinaryDebugRadio(name, mode="v1")
        cwd = os.getcwd()
        os.chdir(tmp_path)               # the RS232 debug file's default
        try:
            rs232 = mod.RFM98W_Serial(baudrate=115200)
        finally:
            os.chdir(cwd)
        for radio in (serial, i2s, iq, iq_regs, bits, rs232):
            tx = tx_cls(radio, callsign="VK5QI")
            for p in payloads:
                radio.transmit_packet(tx.frame_packet(p))
            radio.shutdown()
        with open(name, "rb") as f:
            bit_file = f.read()
        with open(tmp_path / "binary_debug.bin", "rb") as f:
            rs232_file = f.read()
        streams.append((uart.data, uart.closed, pcm.data, pcm.period_sizes,
                        np.concatenate(chunks).tobytes(), iq_regs.shift,
                        bit_file, rs232_file, i2s.audio_rate,
                        i2s.bytes_per_bit))
    assert streams[0] == streams[1]
    assert len(streams[0][0]) == 3 * 343 and streams[0][1]


def _text_log(log_dir):
    texts = []
    for path in glob.glob(os.path.join(log_dir, "*_text.log")):
        with open(path) as f:
            texts += [json.loads(line)["text"] for line in f]
    return texts


@pytest.mark.parametrize("mode", ["v2", "v1"])
def test_tx_cli_matches_jax_and_decodes(mode, tmp_path, capsys):
    """`tx` with text, a pre-encoded SSDV file and a Pillow-made JPEG gives
    a c64 capture and a .bits file byte-equal to the JAX CLI's; the port's
    receiver (`rx --format c64 --device cpu`) recovers every text and the
    image from the port's capture."""
    jpg = tmp_path / "in.jpg"
    jpg.write_bytes(make_jpeg(seed=3))
    ssdv_file = tmp_path / "pre.ssdv"
    assert ssdv_main(["-e", "-n", "-q", "6", "-c", "VK5QI", "-i", "9",
                      str(make_jpeg_file(tmp_path, 4)), str(ssdv_file)]) == 0
    texts = ["hello from the port", "second message"]
    geom = GEOM if mode == "v2" else ["--fs", "92000", "--rs", "11500"]
    args = ["--mode", mode, "--callsign", "VK5QI", "--text", *texts,
            "--images", str(jpg), "--ssdv", str(ssdv_file), *geom]
    out = {}
    for name, main in (("port", tx_main), ("jax", jax_tx_main)):
        for ext in ("c64", "bits"):
            path = tmp_path / f"{name}.{ext}"
            assert main(["--out", str(path), *args]) == 0
            out[name, ext] = path.read_bytes()
    for ext in ("c64", "bits"):
        assert out["port", ext] == out["jax", ext], ext
    assert len(out["port", "c64"]) > 0
    capsys.readouterr()
    log_dir, img_dir = tmp_path / "logs", tmp_path / "img"
    assert rx_main([str(tmp_path / "port.c64"), "--format", "c64", "--mode",
                    mode, *geom, "--device", "cpu", "--no-udp",
                    "--image-dir", str(img_dir), "--log-dir",
                    str(log_dir)]) == 0
    line = capsys.readouterr().err.strip().splitlines()[-1]
    assert " images=2" in line, line
    assert sorted(_text_log(log_dir)) == sorted(texts)


def make_jpeg_file(tmp_path, seed):
    path = tmp_path / f"img{seed}.jpg"
    path.write_bytes(make_jpeg(seed=seed))
    return path


@pytest.mark.parametrize("flags", [["-e", "-n", "-q", "6", "-c", "VK5QI",
                                    "-i", "7"],
                                   ["-e", "-c", "N0CALL", "-i", "2"]],
                         ids=["nofec", "fec"])
def test_ssdv_cli_matches_jax(flags, tmp_path):
    """-e and -d outputs byte-equal to the JAX CLI's (the decoder resyncing
    past leading garbage); bad arguments return 1 in both."""
    jpg = make_jpeg_file(tmp_path, 1)
    out = {}
    for name, main in (("port", ssdv_main), ("jax", jax_ssdv_main)):
        binf, dec = tmp_path / f"{name}.bin", tmp_path / f"{name}.jpg"
        assert main([*flags, str(jpg), str(binf)]) == 0
        binf.write_bytes(b"\x00junk\x55" + binf.read_bytes())
        assert main(["-d", str(binf), str(dec)]) == 0
        out[name] = (binf.read_bytes(), dec.read_bytes())
        assert main(["-e", "-l", "128", str(jpg), "-"]) == 1
        assert main(["-e", "-q", "9", str(jpg), "-"]) == 1
    assert out["port"] == out["jax"]


def test_external_ssdv_adapter_matches(tmp_path):
    """Where the `ssdv` binary is absent both adapters report so and fail
    their calls alike."""
    assert external.binary_path() == jexternal.binary_path()
    assert external.available() == jexternal.available()
    if not external.available():
        args = (str(tmp_path / "x.bin"), str(tmp_path / "x.jpg"))
        assert external.decode_file(*args) is False
        assert external.encode_file(*args[::-1]) is False


def test_iq_radio_waveform_is_the_modulator():
    """IQRadio's samples are 0.5 x fsk_mod_np of the frame's bits, phase
    carried from packet to packet."""
    cfg = tfsk.FSKConfig(Fs=96000, Rs=9600)
    chunks = []
    radio = radios.IQRadio(chunks.append, cfg=cfg, mode="v2")
    tx = PacketTX(radio)
    frames = [tx.frame_packet(b"a"), tx.frame_packet(b"b")]
    for f in frames:
        radio.transmit_packet(f)
    bits = np.concatenate([radios.framing.frame_to_bits(f, "v2")
                           for f in frames])
    sig, _ = tfsk.fsk_mod_np(cfg, bits, 2 * cfg.Rs, cfg.Rs)
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  (0.5 * sig).astype(np.complex64))
