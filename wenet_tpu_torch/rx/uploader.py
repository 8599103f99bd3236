"""Queued SSDV imagery uploader (rx/ssdvuploader.py equivalent).

Same behavioral contract: a bounded queue drained in base64-JSON blocks to
the SSDV API with timeout retries and bounded discard, an *.bin file
watcher that enqueues only new packets per file, and status heartbeats on
the GUI UDP bus (ssdvuploader.py:36-343).  The endpoint is configurable so
tests (and egress-restricted deployments) can point it at a local sink.
A copy of wenet_tpu/rx/uploader.py; `requests` is imported only to post.
"""
from __future__ import annotations

import datetime
import glob
import json
import logging
import os
import queue as _queue
import socket
import threading
import time
from base64 import b64encode

from ..core.packets import WENET_IMAGE_UDP_PORT

logger = logging.getLogger("wenet_tpu_torch.rx.uploader")

DEFAULT_SSDV_URL = "http://ssdv.habhub.org/api/v0/packets"


class SSDVUploader:
    def __init__(self, uploader_callsign: str = "N0CALL",
                 ssdv_url: str = DEFAULT_SSDV_URL,
                 enable_file_watch: bool = True,
                 watch_directory: str = "./rx_images/",
                 file_mask: str = "*.bin", watch_time: float = 5,
                 queue_size: int = 8192, upload_block_size: int = 256,
                 upload_timeout: float = 20, upload_retries: int = 3,
                 upload_anyway: float = 10,
                 status_port: int = WENET_IMAGE_UDP_PORT):
        self.uploader_callsign = uploader_callsign
        self.ssdv_url = ssdv_url
        self.upload_block_size = upload_block_size
        self.upload_timeout = upload_timeout
        self.upload_retries = upload_retries
        self.upload_anyway = upload_anyway
        self.watch_time = watch_time
        self.status_port = status_port
        self.search_mask = os.path.join(watch_directory, file_mask)

        self.upload_queue = _queue.Queue(queue_size)
        self.upload_count = 0
        self.discard_count = 0
        self._seen = {}          # filename -> packets already queued

        self.uploader_running = True
        self._upl_thread = threading.Thread(target=self.uploader_loop,
                                            daemon=True)
        self._upl_thread.start()
        self._watch_thread = None
        if enable_file_watch:
            self._watch_thread = threading.Thread(target=self.file_watch_loop,
                                                  daemon=True)
            self._watch_thread.start()

    # ----------------------------------------------------------- uploading

    def ssdv_encode_packet(self, packet: bytes) -> dict:
        return {
            "type": "packet",
            "packet": b64encode(packet).decode("ascii"),
            "encoding": "base64",
            "received": datetime.datetime.now(datetime.timezone.utc).strftime(
                "%Y-%m-%dT%H:%M:%SZ"),
            "receiver": self.uploader_callsign,
        }

    def _post(self, payload: dict) -> bool:
        import requests
        attempts = 1
        while attempts <= self.upload_retries:
            try:
                requests.post(self.ssdv_url, json=payload,
                              timeout=self.upload_timeout)
                return True
            except requests.exceptions.Timeout:
                attempts += 1
                continue
            except Exception as e:
                logger.error("Uploader - Error when uploading: %s", e)
                return False
        logger.error("Uploader - Upload timed out after %d attempts", attempts)
        return False

    def ssdv_upload_multiple(self, count: int) -> bool:
        count = min(count, self.upload_queue.qsize())
        block = [self.ssdv_encode_packet(self.upload_queue.get())
                 for _ in range(count)]
        ok = self._post({"type": "packets", "packets": block})
        if ok:
            self.upload_count += count
        else:
            self.discard_count += count
        return ok

    def uploader_loop(self):
        last_upload = time.time()
        while self.uploader_running:
            qs = self.upload_queue.qsize()
            if qs >= self.upload_block_size or (
                    qs > 0 and time.time() - last_upload > self.upload_anyway):
                self.ssdv_upload_multiple(self.upload_block_size)
                last_upload = time.time()
                self.send_status()
            else:
                time.sleep(0.5)

    # --------------------------------------------------------- file watch

    def add_packet(self, packet: bytes) -> bool:
        """Queue one 256-byte SSDV packet; drop when full (bounded-queue
        discard policy, ssdvuploader.py:275-291)."""
        try:
            self.upload_queue.put_nowait(bytes(packet))
            return True
        except _queue.Full:
            self.discard_count += 1
            return False

    def add_file(self, filename: str) -> int:
        """Queue any packets in `filename` not previously queued."""
        start = self._seen.get(filename, 0)
        try:
            with open(filename, "rb") as f:
                data = f.read()
        except OSError:
            return 0
        n = len(data) // 256
        added = 0
        for i in range(start, n):
            if self.add_packet(data[i * 256:(i + 1) * 256]):
                added += 1
        self._seen[filename] = n
        return added

    def file_watch_loop(self):
        # skip pre-existing files (only upload new imagery)
        for f in glob.glob(self.search_mask):
            self._seen[f] = os.path.getsize(f) // 256
        while self.uploader_running:
            for f in sorted(glob.glob(self.search_mask)):
                if self._seen.get(f, 0) * 256 < os.path.getsize(f):
                    self.add_file(f)
            time.sleep(self.watch_time)

    # -------------------------------------------------------------- status

    def send_status(self):
        msg = {"type": "UPLOADER_STATS",
               "queued": self.upload_queue.qsize(),
               "uploaded": self.upload_count,
               "discarded": self.discard_count}
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.sendto(json.dumps(msg).encode("ascii"),
                     ("127.0.0.1", self.status_port))
            s.close()
        except OSError:
            pass

    def close(self):
        self.uploader_running = False
        self._upl_thread.join(timeout=5)
        if self._watch_thread:
            self._watch_thread.join(timeout=self.watch_time + 2)
