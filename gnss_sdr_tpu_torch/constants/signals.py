"""Per-signal parameter registry.

One :class:`SignalDef` per supported GNSS signal, keyed by the reference's
two-character signal suffix convention ("1C" = GPS L1 C/A, "1B" = Galileo E1,
...; see gnss-sdr/src/core/receiver/gnss_flowgraph.cc:2156 and
gnss_block_factory.cc:183-210). Numeric values are ICD constants mirrored
from gnss-sdr/src/core/system_parameters/{GPS_L1_CA,GPS_L2C,GPS_L5,
Galileo_E1,Galileo_E5a,Galileo_E5b,Galileo_E6,GLONASS_L1_L2_CA,Beidou_B1I,
Beidou_B3I}.h and the tracking-engine constructor
(src/algorithms/tracking/gnuradio_blocks/dll_pll_veml_tracking.cc:155-456).

Copied from ``gnss_sdr_tpu/constants/signals.py``; only the import paths differ.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SignalDef:
    """Static description of one GNSS signal component."""

    system: str              # "GPS", "Galileo", "GLONASS", "BeiDou", "SBAS"
    name: str                # human-readable, e.g. "GPS L1 C/A"
    suffix: str              # reference 2-char signal id, e.g. "1C"
    carrier_hz: float        # nominal carrier frequency [Hz]
    chip_rate_cps: float     # primary code chipping rate [chips/s]
    code_length_chips: int   # primary code length [chips]
    code_period_ms: float    # primary code period [ms]
    symbols_per_bit: int     # nav symbols per data bit (after secondary sync)
    secondary_code: str | None = None        # pilot/data secondary code ("01..")
    secondary_code_data: str | None = None   # secondary code on the data component
    has_pilot: bool = False  # pilot component available for pure-PLL tracking
    veml: bool = False       # needs Very-Early/Very-Late taps (BOC signals)
    opt_acq_fs_sps: float | None = None  # SNR-optimal acquisition sample rate
    fdma_slot_step_hz: float = 0.0       # GLONASS FDMA inter-slot frequency step

    @property
    def codes_per_ms(self) -> float:
        return 1.0 / self.code_period_ms

    def samples_per_code(self, fs: float) -> int:
        """Samples per primary-code period, rounded like the reference.

        Mirrors ``static_cast<int>(fs / (chip_rate / code_length))``
        (gps_sdr_signal_replica.cc:142).
        """
        return int(fs / (self.chip_rate_cps / self.code_length_chips))


# BeiDou D1 Neumann-Hoffman secondary code (Beidou_B1I.h:44-48)
BEIDOU_NH20 = "00000100110101001110"
# GPS L5 Neumann-Hoffman codes (GPS_L5.h:33-39)
GPS_L5I_NH10 = "0000110101"
GPS_L5Q_NH20 = "00000100110101001110"

SIGNALS: dict[str, SignalDef] = {
    "1C": SignalDef(
        system="GPS", name="GPS L1 C/A", suffix="1C",
        carrier_hz=1575.42e6, chip_rate_cps=1.023e6,
        code_length_chips=1023, code_period_ms=1.0, symbols_per_bit=20,
        opt_acq_fs_sps=2.0e6,
    ),
    "2S": SignalDef(
        system="GPS", name="GPS L2C (M)", suffix="2S",
        carrier_hz=1227.60e6, chip_rate_cps=0.5115e6,
        code_length_chips=10230, code_period_ms=20.0, symbols_per_bit=1,
        opt_acq_fs_sps=1.0e6,
    ),
    "L5": SignalDef(
        system="GPS", name="GPS L5", suffix="L5",
        carrier_hz=1176.45e6, chip_rate_cps=10.23e6,
        code_length_chips=10230, code_period_ms=1.0, symbols_per_bit=10,
        secondary_code=GPS_L5Q_NH20, secondary_code_data=GPS_L5I_NH10,
        has_pilot=True, opt_acq_fs_sps=12.5e6,
    ),
    "1B": SignalDef(
        system="Galileo", name="Galileo E1 b/c", suffix="1B",
        carrier_hz=1575.42e6, chip_rate_cps=1.023e6,
        code_length_chips=4092, code_period_ms=4.0, symbols_per_bit=1,
        secondary_code="0011100000001010110110010",  # E1-C 25-chip (Galileo_E1.h)
        has_pilot=True, veml=True, opt_acq_fs_sps=4.0e6,
    ),
    "5X": SignalDef(
        system="Galileo", name="Galileo E5a", suffix="5X",
        carrier_hz=1176.45e6, chip_rate_cps=10.23e6,
        code_length_chips=10230, code_period_ms=1.0, symbols_per_bit=20,
        secondary_code=None,  # per-PRN 100-chip CS100 provided by codes.galileo_e5a
        has_pilot=True, opt_acq_fs_sps=12.5e6,
    ),
    "7X": SignalDef(
        system="Galileo", name="Galileo E5b", suffix="7X",
        carrier_hz=1207.14e6, chip_rate_cps=10.23e6,
        code_length_chips=10230, code_period_ms=1.0, symbols_per_bit=4,
        has_pilot=True, opt_acq_fs_sps=12.5e6,
    ),
    "E6": SignalDef(
        system="Galileo", name="Galileo E6 B/C", suffix="E6",
        carrier_hz=1278.75e6, chip_rate_cps=5.115e6,
        code_length_chips=5115, code_period_ms=1.0, symbols_per_bit=1,
        has_pilot=True, opt_acq_fs_sps=10.0e6,
    ),
    "1G": SignalDef(
        system="GLONASS", name="GLONASS L1 C/A", suffix="1G",
        carrier_hz=1602.0e6, chip_rate_cps=0.511e6,
        code_length_chips=511, code_period_ms=1.0, symbols_per_bit=10,
        fdma_slot_step_hz=562_500.0,
    ),
    "2G": SignalDef(
        system="GLONASS", name="GLONASS L2 C/A", suffix="2G",
        carrier_hz=1246.0e6, chip_rate_cps=0.511e6,
        code_length_chips=511, code_period_ms=1.0, symbols_per_bit=10,
        fdma_slot_step_hz=437_500.0,
    ),
    "B1": SignalDef(
        system="BeiDou", name="BeiDou B1I", suffix="B1",
        carrier_hz=1561.098e6, chip_rate_cps=2.046e6,
        code_length_chips=2046, code_period_ms=1.0, symbols_per_bit=20,
        secondary_code=BEIDOU_NH20,
    ),
    "B3": SignalDef(
        system="BeiDou", name="BeiDou B3I", suffix="B3",
        carrier_hz=1268.52e6, chip_rate_cps=10.23e6,
        code_length_chips=10230, code_period_ms=1.0, symbols_per_bit=20,
        secondary_code=BEIDOU_NH20,
    ),
}


def get_signal(suffix: str) -> SignalDef:
    try:
        return SIGNALS[suffix]
    except KeyError:
        raise KeyError(
            f"Unknown signal suffix {suffix!r}; known: {sorted(SIGNALS)}"
        ) from None
