"""Register-level SX127x / RFM98W driver.

The reference vendors pySX127x (tx/SX127x/, ~1700 LoC) and layers RFM98W
setup on top (tx/radio_wrappers.py:85-212): direct-async FSK mode,
frequency, deviation-by-baud table, power LUT, temperature read, and a
periodic full re-init.  This module provides the same register-level
surface, designed around a pluggable SPI transport:

  * `SpidevTransport`  — real hardware via /dev/spidev (import-gated)
  * `RegisterFile`     — a software model of the RFM98W register map with
                         the datasheet's read/write + mode semantics

With the `RegisterFile`, the *registers are the source of truth* for the
software transmitter: `carrier_hz()` / `deviation_hz()` are derived from
the bytes actually written, so the config path exercised in tests and in
the IQ transmitter is the identical path a real radio would see.

Register addresses/semantics are from the public SX1276/77/78/79
datasheet (Semtech DS.SX1276-7-8-9.W.APP); reference behaviors cited by
file:line.
"""
from __future__ import annotations

import logging

logger = logging.getLogger("sx127x")

# SX127x common register addresses (FSK/OOK mode map, datasheet table 41)
REG_FIFO = 0x00
REG_OP_MODE = 0x01
REG_FDEV_MSB = 0x04
REG_FDEV_LSB = 0x05
REG_FRF_MSB = 0x06
REG_FRF_MID = 0x07
REG_FRF_LSB = 0x08
REG_PA_CONFIG = 0x09
REG_OCP = 0x0B
REG_LNA = 0x0C
REG_PACKET_CONFIG_2 = 0x31   # DataMode bit6: 0 = continuous (radio_wrappers.py:107)
REG_TEMP = 0x3C
REG_DIO_MAPPING_1 = 0x40
REG_DIO_MAPPING_2 = 0x41
REG_VERSION = 0x42

# RegOpMode[2:0] device modes (datasheet 6.2; radio_wrappers.py:107-135)
MODE_SLEEP = 0x00
MODE_STDBY = 0x01
MODE_FSTX = 0x02
MODE_TX = 0x03
MODE_FSRX = 0x04
MODE_RX = 0x05

FSTEP_HZ = 32e6 / (1 << 19)      # 61.035 Hz synthesizer step (FXOSC/2^19)
WRITE_BIT = 0x80                 # SPI address MSB set = write access

# TX power (dBm) -> RegPaConfig byte, RFO pin (radio_wrappers.py:124)
TX_POWER_LUT = {d: 0x80 + max(0, d - 2) for d in range(18)}


class RegisterFile:
    """Software model of the RFM98W register map.

    Implements the SPI transaction format (`xfer([addr|W, b0, b1, ...])`),
    auto-increment addressing, the version ID, an emulated temperature
    register, and mode bookkeeping, so the full driver stack runs — and is
    testable — with no hardware attached.
    """

    def __init__(self, temperature_c: float = 21.0):
        self.regs = bytearray(128)
        self.regs[REG_OP_MODE] = 0x01          # POR default: FSK standby
        self.regs[REG_PA_CONFIG] = 0x4F
        self.regs[REG_OCP] = 0x2B
        self.regs[REG_PACKET_CONFIG_2] = 0x40  # POR default: packet mode
        self.regs[REG_VERSION] = 0x12
        # RegTemp counts down with temperature (datasheet 5.5.7); encode so
        # the reference's decode (negate, +255 below -63 —
        # radio_wrappers.py:202-211) recovers temperature_c exactly
        t = int(temperature_c)
        self.regs[REG_TEMP] = (255 - t) if t >= 0 else -t
        self.mode_trace: list[int] = []        # every RegOpMode write, in order

    def xfer(self, frame):
        addr = frame[0]
        write = bool(addr & WRITE_BIT)
        addr &= 0x7F
        out = [0]
        for i, b in enumerate(frame[1:]):
            a = (addr + i) & 0x7F
            out.append(self.regs[a])
            if write:
                self.regs[a] = b & 0xFF
                if a == REG_OP_MODE:
                    self.mode_trace.append(b & 0x07)
        return out

    def teardown(self) -> None:
        pass

    # ---- derived RF truth (what the silicon would synthesize) ----
    def carrier_hz(self) -> float:
        frf = (self.regs[REG_FRF_MSB] << 16 |
               self.regs[REG_FRF_MID] << 8 | self.regs[REG_FRF_LSB])
        return frf * FSTEP_HZ

    def deviation_hz(self) -> float:
        fdev = ((self.regs[REG_FDEV_MSB] & 0x3F) << 8) | self.regs[REG_FDEV_LSB]
        return fdev * FSTEP_HZ

    def power_dbm(self) -> int:
        v = self.regs[REG_PA_CONFIG]
        return (v & 0x0F) + 2 if v & 0x80 else (v & 0x0F) - 1

    def mode(self) -> int:
        return self.regs[REG_OP_MODE] & 0x07

    def continuous_mode(self) -> bool:
        return not (self.regs[REG_PACKET_CONFIG_2] & 0x40)


class SpidevTransport:  # pragma: no cover - hardware only
    """Real SPI via the Linux spidev interface (import-gated)."""

    def __init__(self, bus: int = 0, device: int = 0, speed_hz: int = 488000):
        import spidev
        self.spi = spidev.SpiDev()
        self.spi.open(bus, device)
        self.spi.max_speed_hz = speed_hz

    def xfer(self, frame):
        return self.spi.xfer(list(frame))

    def teardown(self) -> None:
        self.spi.close()


class SX127x:
    """Register-level driver: the pySX127x API subset Wenet actually uses
    (get/set register, set_freq, version — LoRa.py:204-345)."""

    def __init__(self, transport=None):
        self.spi = transport if transport is not None else RegisterFile()

    def get_register(self, addr: int) -> int:
        return self.spi.xfer([addr & 0x7F, 0])[1]

    def set_register(self, addr: int, value: int) -> int:
        return self.spi.xfer([addr | WRITE_BIT, value & 0xFF])[1]

    def get_version(self) -> int:
        return self.get_register(REG_VERSION)

    def set_freq_hz(self, freq_hz: float) -> None:
        """Program RegFrf. The reference floors f_MHz*2^14 (LoRa.py:267-282
        with Fstep folded as /16384 MHz); identical quantization here."""
        frf = int(freq_hz / FSTEP_HZ)
        self.set_register(REG_FRF_MSB, (frf >> 16) & 0xFF)
        self.set_register(REG_FRF_MID, (frf >> 8) & 0xFF)
        self.set_register(REG_FRF_LSB, frf & 0xFF)

    def get_freq_hz(self) -> float:
        frf = (self.get_register(REG_FRF_MSB) << 16 |
               self.get_register(REG_FRF_MID) << 8 |
               self.get_register(REG_FRF_LSB))
        return frf * FSTEP_HZ

    def set_deviation_hz(self, deviation_hz: float) -> None:
        """Program RegFdev with the reference's exact /61.03 quantization
        (radio_wrappers.py:118-122)."""
        lsbs = int(deviation_hz / 61.03)
        self.set_register(REG_FDEV_MSB, (lsbs >> 8) & 0x3F)
        self.set_register(REG_FDEV_LSB, lsbs & 0xFF)

    def set_mode(self, mode: int) -> None:
        op = self.get_register(REG_OP_MODE)
        self.set_register(REG_OP_MODE, (op & ~0x07) | (mode & 0x07))

    def get_mode(self) -> int:
        return self.get_register(REG_OP_MODE) & 0x07


def deviation_for_baud(baudrate: int) -> int:
    """Deviation selection table (radio_wrappers.py:95-104)."""
    if baudrate == 9600:
        return 4800
    if baudrate == 4800:
        return 2400
    if baudrate in (115177, 115200):
        return 71797      # historical default for 115200 baud
    return baudrate // 2


class RFM98W:
    """RFM98W lifecycle on top of the register driver: the setup sequence,
    comms check, temperature, periodic re-init, and shutdown of
    radio_wrappers.py:50-211 — against real SPI or the register model."""

    def __init__(self, frequency_hz: float = 443.5e6, baudrate: int = 96000,
                 tx_power_dbm: int = 10, reinit_count: int = 5000,
                 transport=None):
        self.frequency_hz = frequency_hz
        self.baudrate = baudrate
        self.tx_power_dbm = tx_power_dbm
        self.reinit_count = reinit_count
        self.tx_packet_count = 0
        self.reinit_events = 0
        self.lora = SX127x(transport)
        self.temperature = None

    def comms_ok(self) -> bool:
        try:
            ver = self.lora.get_version()
        except Exception:
            return False
        return ver not in (0x00, 0xFF, None)

    def get_temperature(self) -> int:
        """Uncalibrated IC temperature (radio_wrappers.py:202-211)."""
        t = -self.lora.get_register(REG_TEMP)
        if t < -63:
            t += 255
        self.temperature = t
        return t

    def start(self) -> bool:
        """Full FSK direct-async setup (radio_wrappers.py:107-139):
        sleep -> continuous mode -> freq -> deviation -> power -> FSTX -> TX."""
        if not self.comms_ok():
            logger.critical("no communication with RFM98W IC")
            return False
        self.lora.set_register(REG_OP_MODE, MODE_SLEEP)
        self.lora.set_register(REG_PACKET_CONFIG_2, 0x00)  # continuous TX
        self.get_temperature()
        self.lora.set_freq_hz(self.frequency_hz)
        self.lora.set_deviation_hz(deviation_for_baud(self.baudrate))
        self.lora.set_register(
            REG_PA_CONFIG, TX_POWER_LUT.get(self.tx_power_dbm, 0x80))
        # TX frequency latches during the FSTX transition
        self.lora.set_register(REG_OP_MODE, MODE_FSTX)
        self.lora.set_register(REG_OP_MODE, MODE_TX)
        ok = self.lora.get_mode() == MODE_TX
        if not ok:
            logger.critical("TX mode not set correctly")
        return ok

    def on_packet_transmitted(self) -> None:
        """Reference reinitialises the radio every reinit_count packets
        (radio_wrappers.py:196-200)."""
        self.tx_packet_count += 1
        if self.reinit_count and self.tx_packet_count % self.reinit_count == 0:
            logger.info("reinitialising radio at %d packets",
                        self.tx_packet_count)
            self.reinit_events += 1
            self.start()

    def shutdown(self) -> None:
        try:
            self.lora.set_register(REG_OP_MODE, MODE_SLEEP)
            self.lora.spi.teardown()
        except Exception:
            pass
