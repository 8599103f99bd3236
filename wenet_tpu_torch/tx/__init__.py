"""Transmit-side application layer: packet framing/queues/telemetry
generators over pluggable radio backends — the counterpart of the reference
tx/ stack (PacketTX.py + radio_wrappers.py), with an IQ-synthesis radio
replacing the RFM98W hardware for fully-simulated links."""
from .packet_tx import PacketTX  # noqa: F401
from .radios import (BinaryDebugRadio, IQRadio, RFM98W_I2S,  # noqa: F401
                     RFM98W_Serial, UDPRadio)
