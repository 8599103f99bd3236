"""Payload-board housekeeping utilities (reference: tx/kill_leds.py).

Some Wenet payload daughterboards carry a PCA9685 LED controller whose 9 LEDs
power up lit; in flight they waste power and light the enclosure.  The
reference ships a boot script that turns them off over I2C — same here,
import-gated on the adafruit library so the module is importable (and the
no-hardware path testable) everywhere.

Run on boot (rc.local / systemd oneshot):  python3 -m wenet_tpu_torch.tx.pi_utils
(a copy of wenet_tpu/tx/pi_utils.py)
"""
from __future__ import annotations

import sys

PCA9685_ADDRESS = 0x55
LED_CHANNELS = range(9)          # LEDs on PCA9685 pins 0-8
LED_OFF = 0xFFFF                 # full duty on the sink side = LED off


def kill_payload_leds(address: int = PCA9685_ADDRESS,
                      channels=LED_CHANNELS, pca=None) -> bool:
    """Turn off the payload LEDs.  Returns True if hardware was driven.

    `pca` may be injected (any object with .channels[i].duty_cycle and
    .frequency) for tests; otherwise the adafruit PCA9685 library is used
    and absence of the hardware stack is reported as False, not an error.
    """
    if pca is None:              # pragma: no cover - hardware only
        try:
            import busio
            from adafruit_pca9685 import PCA9685
            from board import SCL, SDA
            pca = PCA9685(busio.I2C(SCL, SDA), address=address)
        except Exception as e:
            print(f"kill_leds: no PCA9685 hardware stack ({e})",
                  file=sys.stderr)
            return False
    pca.frequency = 60
    for ch in channels:
        pca.channels[ch].duty_cycle = LED_OFF
    return True


if __name__ == "__main__":       # pragma: no cover - hardware entrypoint
    sys.exit(0 if kill_payload_leds() else 1)
