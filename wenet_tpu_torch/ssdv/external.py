"""External `ssdv` binary adapter — the reference's exact integration mode
(rx/rx_ssdv.py:243 shells `ssdv -d`, tx/WenetPiCamera2.py:420-432 shells
`ssdv -e -n -q 6`).  Drop-in for the router's `ssdv_decoder` injection
point and the camera's encoder, for operators who want fsphil's binary as
the codec of record; the native `wenet_tpu_torch.ssdv` codec remains the
default (and the only option when the binary isn't installed).

    router = PacketRouter(ssdv_decoder=external.decode_file)
"""
from __future__ import annotations

import shutil
import subprocess


def binary_path() -> str | None:
    """Path of the `ssdv` binary, or None if not installed."""
    return shutil.which("ssdv")


def available() -> bool:
    return binary_path() is not None


def decode_file(bin_path: str, jpg_path: str, timeout: float = 30.0) -> bool:
    """`ssdv -d packets.bin out.jpg` (rx_ssdv.py:243)."""
    exe = binary_path()
    if exe is None:
        return False
    try:
        r = subprocess.run([exe, "-d", bin_path, jpg_path],
                           capture_output=True, timeout=timeout)
        return r.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False


def encode_file(jpg_path: str, bin_path: str, callsign: str = "N0CALL",
                image_id: int = 0, quality: int = 6,
                timeout: float = 30.0) -> bool:
    """`ssdv -e -n -q Q -c CALL -i ID in.jpg out.bin`
    (WenetPiCamera2.py:420-432)."""
    exe = binary_path()
    if exe is None:
        return False
    try:
        r = subprocess.run(
            [exe, "-e", "-n", "-q", str(quality), "-c", callsign,
             "-i", str(image_id), jpg_path, bin_path],
            capture_output=True, timeout=timeout)
        return r.returncode == 0
    except (OSError, subprocess.TimeoutExpired):
        return False
