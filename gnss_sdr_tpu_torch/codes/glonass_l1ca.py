"""GLONASS L1/L2 C/A standard-accuracy code (ICD section 3.3.2.2).

Counterpart of gnss-sdr/src/algorithms/libs/
glonass_l1_signal_replica.cc: a single 511-chip m-sequence shared by all
satellites (FDMA separates them by carrier slot), generator x^9 + x^5 + 1
with the output taken from stage 7.

Copied from ``gnss_sdr_tpu/codes/glonass_l1ca.py``; unchanged.
"""

from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 511
CHIP_RATE = 0.511e6


@functools.lru_cache(maxsize=None)
def glonass_l1ca_code() -> np.ndarray:
    """511-chip m-sequence as float32 +-1 (same for every satellite)."""
    reg = np.ones(9, dtype=np.uint8)
    out = np.empty(CODE_LENGTH, dtype=np.uint8)
    for i in range(CODE_LENGTH):
        out[i] = reg[6]  # output from stage 7 (ICD)
        fb = reg[8] ^ reg[4]  # x^9 + x^5 + 1
        reg[1:] = reg[:-1]
        reg[0] = fb
    return np.where(out == 1, 1.0, -1.0).astype(np.float32)


def glonass_slot_frequency(slot: int, band: str = "L1") -> float:
    """Carrier frequency for FDMA frequency slot k in -7..6
    (GLONASS_L1_L2_CA.h:76-79)."""
    if band == "L1":
        return 1602.0e6 + slot * 562_500.0
    return 1246.0e6 + slot * 437_500.0
