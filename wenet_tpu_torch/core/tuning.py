"""SDR tuning arithmetic (start_rx.sh:95-108).

The transmitter is centred at `centre_hz`; the SDR must be tuned low so the
two FSK tones land inside the demod's estimator band:

    offset = -(Rs * (Os/4 - 0.25))        # start_rx.sh:105-108
    sdr_freq = centre + offset

which puts the lower tone at Rs*(Os/4 - 0.25) - Rs/2 above DC and keeps
the pair clear of both DC and the estimator limits est_min=Rs/4.
"""
from __future__ import annotations


def sdr_rate(baud: int, oversampling: int) -> int:
    """SDR sample rate (start_rx.sh: SDR_RATE=BAUD*OVER)."""
    return baud * oversampling


def tuning_offset(baud: int, oversampling: int) -> float:
    """Frequency offset applied to the SDR centre (negative: tune low)."""
    return -(baud * (oversampling / 4.0 - 0.25))


def sdr_centre(tx_centre_hz: float, baud: int, oversampling: int) -> float:
    return tx_centre_hz + tuning_offset(baud, oversampling)


def expected_tones(baud: int, oversampling: int) -> tuple:
    """Tone frequencies within the SDR passband after the offset: the TX
    tones sit at centre ± baud/2 (deviation = baud/2,
    radio_wrappers.py:95-104)."""
    shift = -tuning_offset(baud, oversampling)
    return (shift - baud / 2.0, shift + baud / 2.0)
