"""Zero-RF link emulation for secondary-payload integration testing
(tx/examples/wenet_link_emulation.py + sec_payload_{tx,rx}_example.py).

A secondary payload sends WENET_TX_SEC_PAYLOAD JSON commands to the TX UDP
port; the emulated link frames them exactly as the flight stack would and
"receives" them immediately, rebroadcasting telemetry JSON on the RX
broadcast port — so payload producers and consumers can be developed end to
end with no radio and no modem.

    emu = LinkEmulator()            # listens on 55674, emits on 55672
    ... send commands / receive broadcasts ...
    emu.close()

Optionally `through_modem=True` routes every frame through the full
IQ modulate -> AWGN -> demod -> deframe chain for a bit-true emulation,
the port's `rx.pipeline.Receiver` on `device` (the card by default; it
raises without one).  A copy of wenet_tpu/examples/link_emulation.py.
"""
from __future__ import annotations

import numpy as np

from ..core import packets as wp
from ..ops import fsk
from ..rx.router import UDPEmitter
from ..tx import PacketTX


class _LoopbackRadio:
    """Radio that hands every framed packet straight to a receive hook."""
    mode = "v2"

    def __init__(self, on_frame):
        self.on_frame = on_frame

    def scramble(self, body: bytes) -> bytes:
        from ..core import framing
        return framing.tx_scramble(body)

    def transmit_packet(self, frame: bytes) -> None:
        self.on_frame(frame)

    def shutdown(self) -> None:
        pass


class LinkEmulator:
    def __init__(self, tx_port: int = wp.WENET_TX_UDP_PORT,
                 telemetry_port: int = wp.WENET_TELEMETRY_UDP_PORT,
                 callsign: str = "EMULATE", through_modem: bool = False,
                 cfg: fsk.FSKConfig | None = None, ebno_db: float = 20.0,
                 device="cuda"):
        self.emitter = UDPEmitter(telemetry_port=telemetry_port)
        self.through_modem = through_modem
        self.cfg = cfg or fsk.FSKConfig(Fs=96000, Rs=9600)
        self.ebno_db = ebno_db
        self.packets_received = []
        if through_modem:
            from ..rx.pipeline import Receiver
            self._rx = Receiver(mode="v2", cfg=self.cfg, device=device)
            self._rng = np.random.default_rng(0)
        radio = _LoopbackRadio(self._on_frame)
        self.tx = PacketTX(radio, callsign=callsign, udp_listener=tx_port)
        if through_modem:
            # warm the demod estimators, as the real idle stream would
            radio.transmit_packet(self.tx.idle_message)
            radio.transmit_packet(self.tx.idle_message)

    def _on_frame(self, frame: bytes):
        if not self.through_modem:
            # strip preamble/UW, descramble, drop CRC+parity: ideal link
            from ..core import framing
            body = framing.tx_scramble(frame[20:])   # XOR is its own inverse
            payload = body[: framing.PAYLOAD_BYTES]
            self._deliver(payload)
            return
        from ..ops import channel
        from ..core import framing
        bits = framing.frame_to_bits(frame, "v2")
        pad = (-len(bits)) % self.cfg.Nbits
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
        sig, _ = fsk.fsk_mod_np(self.cfg, bits, 2 * self.cfg.Rs, self.cfg.Rs)
        iq = channel.add_awgn(sig.astype(np.complex64), self.ebno_db,
                              self.cfg.Fs, self.cfg.Rs, rng=self._rng)
        for payload in self._rx.push(iq):
            self._deliver(payload)

    def _deliver(self, payload: bytes):
        ptype = wp.decode_packet_type(payload)
        if ptype == wp.PacketType.IDLE:
            return
        self.packets_received.append(payload)
        self.emitter.broadcast_telemetry(payload)

    def drain(self):
        """Transmit everything queued (synchronous pump)."""
        tx = self.tx
        while not (tx.telemetry_queue_empty() and tx.image_queue_empty()):
            q = (tx.telemetry_queue if tx.telemetry_queue.qsize()
                 else tx.ssdv_queue)
            tx.radio.transmit_packet(q.get_nowait())

    def close(self):
        self.tx.close()
