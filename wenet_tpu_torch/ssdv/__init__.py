"""Native SSDV codec (JPEG packetiser) — replaces the external `ssdv`
binary dependency of the reference (see codec.py for the format)."""
from .codec import (  # noqa: F401
    PACKET_LEN, decode, decode_file, encode, encode_file, packet_info)
