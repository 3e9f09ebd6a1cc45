"""GPS L5 I/Q code generation (IS-GPS-705, 3.3.2.2).

Counterpart of gnss-sdr/src/algorithms/libs/
gps_l5_signal_replica.cc: chip = XA XOR XB(advance + n), where XA is the
13-stage sequence with taps (13,12,10,9) short-cycled by restarting at
state 1111111111101, XB the 13-stage sequence with taps
(13,12,8,7,6,4,3,1), both all-ones seeded; per-PRN XB advance offsets.
Chip mapping 1 -> -1, 0 -> +1 like the reference.

Copied from ``gnss_sdr_tpu/codes/gps_l5.py``; only the import
paths differ.
"""

from __future__ import annotations

import functools

import numpy as np

from gnss_sdr_tpu_torch.codes._gps_l2l5_data import L5I_XB_ADVANCE, L5Q_XB_ADVANCE

CODE_LENGTH = 10230
CHIP_RATE = 10.23e6
NH10 = "0000110101"   # L5I Neumann-Hoffman (GPS_L5.h)
NH20 = "00000100110101001110"  # L5Q


@functools.lru_cache(maxsize=None)
def _xa_sequence() -> np.ndarray:
    # xa[0] is the newest bit (deque front); output = xa[12]
    xa = [1] * 13
    restart = [1] * 11 + [0, 1]
    out = np.empty(CODE_LENGTH, dtype=np.int64)
    for i in range(CODE_LENGTH):
        out[i] = xa[12]
        if xa == restart:
            xa = [1] * 13
        else:
            fb = xa[12] ^ xa[11] ^ xa[9] ^ xa[8]
            xa = [fb] + xa[:-1]
    return out


@functools.lru_cache(maxsize=None)
def _xb_sequence() -> np.ndarray:
    xb = [1] * 13
    out = np.empty(CODE_LENGTH, dtype=np.int64)
    for i in range(CODE_LENGTH):
        out[i] = xb[12]
        fb = xb[12] ^ xb[11] ^ xb[7] ^ xb[6] ^ xb[5] ^ xb[3] ^ xb[2] ^ xb[0]
        xb = [fb] + xb[:-1]
    return out


def _code(prn: int, advance_table) -> np.ndarray:
    if not 1 <= prn <= len(advance_table):
        raise ValueError(f"L5 PRN out of range: {prn}")
    xa = _xa_sequence()
    xb = _xb_sequence()
    off = advance_table[prn - 1]
    n = np.arange(CODE_LENGTH)
    chips = xa ^ xb[(off + n) % CODE_LENGTH]
    return (1.0 - 2.0 * chips).astype(np.float32)


@functools.lru_cache(maxsize=None)
def gps_l5i_code(prn: int) -> np.ndarray:
    """10230-chip L5 data-component code, float32 +-1."""
    return _code(prn, L5I_XB_ADVANCE)


@functools.lru_cache(maxsize=None)
def gps_l5q_code(prn: int) -> np.ndarray:
    """10230-chip L5 pilot-component code, float32 +-1."""
    return _code(prn, L5Q_XB_ADVANCE)
