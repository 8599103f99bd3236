"""Flight transmitter entry: camera + GPS + packet TX wired together
(tx/tx_picamera2_gps.py equivalent), with software substitutes for the
flight hardware: FileCamera/SimulatedGPS by default, IQ/UDP radio sinks.
A copy of wenet_tpu/cli/flight.py, host code throughout (Pillow is needed
only once the camera draws).

Run: python -m wenet_tpu_torch.cli.flight --images-dir DIR --out flight.c64
"""
from __future__ import annotations

import argparse
import sys
import time


class SystemClockSetter:
    """Set the host clock from the first 3D GPS fix, once — the guarded
    flight-ops behavior of tx_picamera2_gps.py:133-151 (timedatectl
    set-time from the fix, then re-enable NTP sync), with the outcome
    downlinked as debug text.  `runner` is os.system-compatible and
    injectable for tests."""

    def __init__(self, debug_ptr=None, runner=None):
        import os
        self.debug_ptr = debug_ptr or (lambda msg: None)
        self.runner = runner or os.system
        self.done = False

    def on_fix(self, state):
        if self.done or state.get("gpsFix") != 3:
            return
        self.done = True        # one attempt only, like the reference
        try:
            # state carries GPS week/iTOW/leapS; derive UTC like the
            # reference's gps_data['datetime'] (ublox.py weeksecondstoutc)
            from ..core.packets import gps_weeksecondstoutc_dt
            dt = gps_weeksecondstoutc_dt(state["week"], state["iTOW"],
                                         state["leapS"])
            new_time = dt.strftime("%Y-%m-%d %H:%M:%S")
            if self.runner(f'timedatectl set-time "{new_time}"') == 0:
                self.debug_ptr(
                    f"GPS Debug: System clock set to GPS time {new_time}")
            else:
                self.debug_ptr(
                    "GPS Debug: Attempt to set system clock failed!")
            if self.runner("timedatectl set-ntp 1") == 0:
                self.debug_ptr("GPS Debug: Re-enabled NTP sync.")
            else:
                self.debug_ptr("GPS Debug: Could not enable NTP sync.")
        except Exception:
            self.debug_ptr("GPS Debug: Attempt to set system clock failed!")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--callsign", default="N0CALL")
    ap.add_argument("--mode", choices=["v1", "v2"], default="v2")
    ap.add_argument("--images-dir", required=True,
                    help="directory of JPEGs for the FileCamera")
    ap.add_argument("--out", required=True,
                    help="IQ .c64 file, udp:host:port sink, "
                         "serial:/dev/ttyAMA0 (v1 UART modulation), or "
                         "alsa:hw:CARD=i2smaster,DEV=0 (v2 I2S modulation)")
    ap.add_argument("--fs", type=int, default=None)
    ap.add_argument("--rs", type=int, default=None)
    ap.add_argument("--duration", type=float, default=30.0,
                    help="seconds of flight to run; 0 = run until killed "
                         "(the reference's supervised-forever mode)")
    ap.add_argument("--gps-rate", type=float, default=1.0)
    ap.add_argument("--gps-port", default=None,
                    help="serial device of a real u-blox GPS (UBX protocol "
                         "via tx/ubx.py); default: simulated trajectory")
    ap.add_argument("--tx-resolution", default="800x608")
    ap.add_argument("--set-system-clock", action="store_true",
                    help="set the host clock from the first 3D GPS fix "
                         "(timedatectl; tx_picamera2_gps.py:133-151) — "
                         "opt-in: it mutates host state")
    ap.add_argument("--ntpd-update", action="store_true",
                    help="push whole-second GPS time into ntpd via the "
                         "SHM refclock (requires ntpdshm; ublox.py:963+)")
    args = ap.parse_args(argv)

    from ..ops import fsk
    from ..tx import IQRadio, PacketTX, UDPRadio
    from ..tx.camera import FileCamera, SSDVCamera
    from ..tx.gps import SimulatedGPS

    cfg = fsk.V2_CONFIG if args.mode == "v2" else fsk.V1_CONFIG
    if args.fs or args.rs:
        cfg = fsk.FSKConfig(Fs=args.fs or cfg.Fs, Rs=args.rs or cfg.Rs)

    # hardware transports have a fixed on-air framing mode (UART = v1 RS232
    # expansion, I2S = v2 scrambled); a mismatched --mode would transmit an
    # undecodable hybrid, so fail loudly before touching hardware
    fixed = {"serial:": "v1", "alsa:": "v2"}
    for prefix, m in fixed.items():
        if args.out.startswith(prefix) and args.mode != m:
            ap.error(f"--mode {args.mode} conflicts with the {prefix} "
                     f"transport's fixed framing mode {m}")

    fout = None
    if args.out.startswith("udp:"):
        _, host, port = args.out.split(":")
        radio = UDPRadio(host, int(port), mode=args.mode)
    elif args.out.startswith("serial:"):   # pragma: no cover - hardware only
        from ..tx import RFM98W_Serial
        radio = RFM98W_Serial(serial_port=args.out[len("serial:"):],
                              baudrate=cfg.Rs)
    elif args.out.startswith("alsa:"):     # pragma: no cover - hardware only
        from ..tx import RFM98W_I2S
        radio = RFM98W_I2S(audio_device=args.out[len("alsa:"):],
                           baudrate=cfg.Rs)
    else:
        fout = open(args.out, "wb")
        radio = IQRadio(lambda iq: fout.write(iq.tobytes()), cfg=cfg,
                        mode=args.mode)

    tx = PacketTX(radio, callsign=args.callsign, udp_listener=55674)
    tx.start_tx()

    # camera first: the GPS callback reads its metadata, so it must exist
    # before the first fix can arrive (tx_picamera2_gps.py wires the same
    # order, :94-247)
    w, h = (int(v) for v in args.tx_resolution.split("x"))
    cam = SSDVCamera(FileCamera(args.images_dir), callsign=args.callsign,
                     tx_resolution=(w, h))

    # GPS telemetry per fix (tx_picamera2_gps.handle_gps_data, :114-152)
    clock = (SystemClockSetter(debug_ptr=tx.transmit_text_message)
             if args.set_system_clock else None)

    def on_fix(state):
        tx.transmit_gps_telemetry(state, cam.camera.get_metadata())
        if clock is not None:
            clock.on_fix(state)

    if args.gps_port:
        from ..tx.ubx import UBloxGPS
        gps = UBloxGPS(port=args.gps_port, callback=on_fix,
                       update_rate_ms=int(1000 / max(args.gps_rate, 0.1)),
                       debug_ptr=tx.transmit_text_message,
                       ntpd_update=args.ntpd_update)
    else:
        gps = SimulatedGPS(callback=on_fix, rate=args.gps_rate)
    gps.start()
    cam.run("./tx_images", tx)

    try:
        t0 = time.time()
        while args.duration <= 0 or time.time() - t0 < args.duration:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        cam.stop()
        gps.close()
        tx.close()
        if fout:
            fout.close()
    print(f"flight run done: {tx.packets_transmitted} packets transmitted",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
