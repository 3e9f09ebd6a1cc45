"""BeiDou B1I ranging code (BDS-SIS-ICD 5.2.2/5.2.3).

Counterpart of gnss-sdr/src/algorithms/libs/beidou_b1i_signal_
replica.cc: 2046-chip truncated Gold code from two 11-stage LFSRs.
G1: 1+x+x^7+x^8+x^9+x^10+x^11, G2: 1+x+x^2+x^3+x^4+x^5+x^8+x^9+x^11,
G2 output = XOR of two phase taps selected per PRN; both registers
initialized to 01010101010; sequence truncated to 2046 chips (1 ms).

Copied from ``gnss_sdr_tpu/codes/beidou_b1i.py``; unchanged.
"""

from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 2046
CHIP_RATE = 2.046e6

# per-PRN G2 phase-tap pairs (1-based register stages), BDS ICD table 5-2
_PHASE_TAPS = {
    1: (1, 3), 2: (1, 4), 3: (1, 5), 4: (1, 6), 5: (1, 8), 6: (1, 9),
    7: (1, 10), 8: (1, 11), 9: (2, 7), 10: (3, 4), 11: (3, 5), 12: (3, 6),
    13: (3, 8), 14: (3, 9), 15: (3, 10), 16: (3, 11), 17: (4, 5), 18: (4, 6),
    19: (4, 8), 20: (4, 9), 21: (4, 10), 22: (4, 11), 23: (5, 6), 24: (5, 8),
    25: (5, 9), 26: (5, 10), 27: (5, 11), 28: (6, 8), 29: (6, 9), 30: (6, 10),
    31: (6, 11), 32: (8, 9), 33: (8, 10), 34: (8, 11), 35: (9, 10),
    36: (9, 11), 37: (10, 11),
}


@functools.lru_cache(maxsize=None)
def beidou_b1i_code(prn: int) -> np.ndarray:
    """2046-chip B1I code for PRN 1..37 as float32 +-1."""
    if prn not in _PHASE_TAPS:
        raise ValueError(f"BeiDou B1I PRN must be 1..37, got {prn}")
    t1, t2 = _PHASE_TAPS[prn]
    # registers indexed [stage1..stage11] -> array idx 0..10
    g1 = np.array([0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0], dtype=np.uint8)
    g2 = g1.copy()
    out = np.empty(CODE_LENGTH, dtype=np.uint8)
    for i in range(CODE_LENGTH):
        g2_out = g2[t1 - 1] ^ g2[t2 - 1]
        out[i] = g1[10] ^ g2_out
        fb1 = g1[0] ^ g1[6] ^ g1[7] ^ g1[8] ^ g1[9] ^ g1[10]
        fb2 = g2[0] ^ g2[1] ^ g2[2] ^ g2[3] ^ g2[4] ^ g2[7] ^ g2[8] ^ g2[10]
        g1[1:] = g1[:-1]
        g1[0] = fb1
        g2[1:] = g2[:-1]
        g2[0] = fb2
    return np.where(out == 1, 1.0, -1.0).astype(np.float32)
