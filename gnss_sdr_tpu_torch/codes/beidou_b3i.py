"""BeiDou B3I ranging code (BDS-SIS-ICD B3I, 10230 chips at 10.23 Mcps).

Counterpart of gnss-sdr/src/algorithms/libs/
beidou_b3i_signal_replica.cc: two 13-stage LFSRs — G1 with taps
(1,4,11,13) truncated by a reset when its register hits the
all-ones-except-two state, G2 with taps (1,5,9,10,12,13,13...) per the
ICD — G2 seeded per PRN (_beidou_b3i_data).

Copied from ``gnss_sdr_tpu/codes/beidou_b3i.py``; only the import
paths differ.
"""

from __future__ import annotations

import functools

import numpy as np

from gnss_sdr_tpu_torch.codes._beidou_b3i_data import G2_INIT

CODE_LENGTH = 10230
CHIP_RATE = 10.23e6


def _seq(reg0: np.ndarray, taps: tuple[int, ...],
         reset_state: np.ndarray | None) -> np.ndarray:
    reg = reg0.copy()
    out = np.empty(CODE_LENGTH, dtype=np.uint8)
    for i in range(CODE_LENGTH):
        out[i] = reg[0]
        fb = 0
        for t in taps:
            fb ^= reg[t]
        reg[:-1] = reg[1:]
        reg[-1] = fb
        if reset_state is not None and np.array_equal(reg, reset_state):
            reg = np.ones(13, dtype=np.uint8)
    return out


@functools.lru_cache(maxsize=None)
def beidou_b3i_code(prn: int) -> np.ndarray:
    """10230-chip B3I code for PRN 1..63 as float32 +-1."""
    if not 1 <= prn <= len(G2_INIT):
        raise ValueError(f"BeiDou B3I PRN must be 1..{len(G2_INIT)}")
    g1_reset = np.ones(13, dtype=np.uint8)
    g1_reset[0] = 0
    g1_reset[1] = 0
    g1 = _seq(np.ones(13, dtype=np.uint8), (0, 9, 10, 12), g1_reset)
    # bitset-string convention: register bit i = string char (12 - i)
    g2_0 = np.array([int(G2_INIT[prn - 1][12 - i]) for i in range(13)],
                    dtype=np.uint8)
    g2 = _seq(g2_0, (0, 1, 3, 4, 6, 7, 8, 12), None)
    chips = g1 ^ g2
    return np.where(chips == 1, 1.0, -1.0).astype(np.float32)
