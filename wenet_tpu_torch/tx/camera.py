"""Camera capture -> SSDV pipeline (tx/WenetPiCamera2.py equivalent).

The reference captures with picamera2, picks the best of N shots by JPEG
file size or autofocus FoM, resizes with ImageMagick `convert`, and SSDV-
encodes with the external `ssdv` binary (WenetPiCamera2.py:275-432).  Here:

  * `FileCamera` — replays images from a directory (the test_images corpus
    role, and any tethered-camera drop-folder workflow)
  * `PiCamera2` hardware capture is import-gated (not present off-Pi)
  * resize/overlay via PIL, SSDV via the port's native ssdv codec
  * same auto_capture loop contract: capture -> best-pick -> resize ->
    ssdv -> wait for TX queue -> queue file, with error-reset behavior

A copy of wenet_tpu/tx/camera.py that imports Pillow where it draws
(`FileCamera.capture`, `SSDVCamera.ssdvify`), so the module loads where
Pillow is absent.
"""
from __future__ import annotations

import glob
import logging
import os
import threading
import time

from .. import ssdv

logger = logging.getLogger("wenet_tpu_torch.tx.camera")


class FileCamera:
    """Image source that cycles through files in a directory."""

    def __init__(self, src_dir: str, pattern: str = "*.jpg", loop: bool = True):
        self.files = sorted(glob.glob(os.path.join(src_dir, pattern)))
        if not self.files:
            raise FileNotFoundError(f"no {pattern} in {src_dir}")
        self.idx = 0
        self.loop = loop

    def capture(self, dest: str) -> bool:
        if self.idx >= len(self.files):
            if not self.loop:
                return False
            self.idx = 0
        from PIL import Image
        img = Image.open(self.files[self.idx])
        img.save(dest, "JPEG", quality=90)
        self.idx += 1
        return True

    def get_metadata(self) -> dict:
        return {}


class SSDVCamera:
    """Capture -> best-pick -> resize -> SSDV -> transmit loop.

    camera: any object with capture(dest_path)->bool and get_metadata().
    """

    def __init__(self, camera, callsign: str = "N0CALL",
                 tx_resolution=(800, 608), num_images: int = 1,
                 temp_filename_prefix: str = "picam_temp",
                 quality: int = 6, overlay_fn=None, telemetry_cb=None):
        """telemetry_cb(image_id): invoked as each image is queued — the
        hook tx_picamera2_gps uses to send 0x54 image-telemetry packets."""
        self.telemetry_cb = telemetry_cb
        self.camera = camera
        self.callsign = callsign
        self.tx_resolution = tx_resolution
        self.num_images = num_images
        self.temp_prefix = temp_filename_prefix
        self.quality = quality
        self.overlay_fn = overlay_fn
        self.image_id = 0
        self.auto_capture_running = False
        self._thread = None

    # ------------------------------------------------------------- capture

    def capture_best(self, dest: str) -> bool:
        """Take num_images shots, keep the biggest JPEG
        (WenetPiCamera2.capture, :275-388 — file size proxies detail/focus)."""
        best_size, best = -1, None
        for i in range(self.num_images):
            tmp = f"{self.temp_prefix}_{i}.jpg"
            if not self.camera.capture(tmp):
                return False
            size = os.path.getsize(tmp)
            if size > best_size:
                best_size, best = size, tmp
        if best is None:
            return False
        os.replace(best, dest)
        return True

    def ssdvify(self, filename: str) -> str | None:
        """Resize to tx_resolution and SSDV-encode
        (WenetPiCamera2.ssdvify, :392-432)."""
        try:
            from PIL import Image
            img = Image.open(filename).convert("RGB")
            img = img.resize(self.tx_resolution)
            if self.overlay_fn:
                img = self.overlay_fn(img)
            resized = filename + ".resized.jpg"
            img.save(resized, "JPEG", quality=90)
            out = filename + ".ssdv"
            ok = ssdv.encode_file(resized, out, self.callsign,
                                  self.image_id, self.quality)
            if not ok:
                return None
            self.image_id = (self.image_id + 1) % 256
            return out
        except Exception:
            logger.exception("ssdvify failed")
            return None

    # ------------------------------------------------------- capture loop

    def auto_capture(self, destination_directory: str, tx,
                     post_process_ptr=None, delay: float = 0,
                     start_id: int = 0):
        """Continuous capture loop (WenetPiCamera2.auto_capture, :435-539)."""
        self.image_id = start_id
        while self.auto_capture_running:
            cap = os.path.join(
                destination_directory,
                f"{time.strftime('%Y%m%d-%H%M%S')}_{self.image_id}.jpg")
            if not self.capture_best(cap):
                logger.error("capture failed; resetting camera")
                time.sleep(1)
                continue
            if post_process_ptr:
                try:
                    post_process_ptr(cap)
                except Exception:
                    logger.exception("post-process failed")
            ssdv_file = self.ssdvify(cap)
            if ssdv_file is None:
                continue
            # wait for the previous image to finish transmitting
            while not tx.image_queue_empty() and self.auto_capture_running:
                time.sleep(0.1)
            tx.queue_image_file(ssdv_file)
            if self.telemetry_cb:
                try:
                    self.telemetry_cb((self.image_id - 1) % 256)
                except Exception:
                    logger.exception("image telemetry callback failed")
            if delay:
                time.sleep(delay)

    def run(self, destination_directory: str, tx, post_process_ptr=None,
            delay: float = 0, start_id: int = 0):
        os.makedirs(destination_directory, exist_ok=True)
        self.auto_capture_running = True
        self._thread = threading.Thread(
            target=self.auto_capture,
            args=(destination_directory, tx, post_process_ptr, delay, start_id),
            daemon=True)
        self._thread.start()

    def stop(self):
        self.auto_capture_running = False
        if self._thread:
            self._thread.join(timeout=10)


def open_picamera2(**kwargs):  # pragma: no cover - hardware only
    """Hardware capture via picamera2 when present (flight configuration)."""
    try:
        from picamera2 import Picamera2  # noqa
    except ImportError as e:
        raise RuntimeError(
            "picamera2 not available on this platform; use FileCamera") from e
    raise NotImplementedError(
        "hardware capture must be wired on a Pi; see WenetPiCamera2.py")
