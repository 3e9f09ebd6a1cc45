"""GPS L2C CM code generation (IS-GPS-200, 3.3.2.2 L2 CM/CL).

Counterpart of gnss-sdr/src/algorithms/libs/
gps_l2c_signal_replica.cc: 27-bit modular LFSR
x <- (x >> 1) XOR ((x & 1) * 0o445112474), output = LSB, per-PRN initial
states, truncated at 10230 chips (CM; 20 ms at 511.5 kcps). Chip mapping
follows the reference: register bit 1 -> -1, 0 -> +1.

Copied from ``gnss_sdr_tpu/codes/gps_l2c.py``; only the import
paths differ.
"""

from __future__ import annotations

import functools

import numpy as np

from gnss_sdr_tpu_torch.codes._gps_l2l5_data import L2C_M_INIT_REG

CODE_LENGTH = 10230
CHIP_RATE = 511_500.0
_POLY = 0o445112474


@functools.lru_cache(maxsize=None)
def gps_l2cm_code(prn: int) -> np.ndarray:
    """10230-chip L2 CM code, float32 +-1 (PRN 1..63 and modernized slots)."""
    if not 1 <= prn <= len(L2C_M_INIT_REG):
        raise ValueError(f"L2C PRN out of range: {prn}")
    x = L2C_M_INIT_REG[prn - 1]
    out = np.empty(CODE_LENGTH, dtype=np.int64)
    for n in range(CODE_LENGTH):
        out[n] = x & 1
        x = (x >> 1) ^ ((x & 1) * _POLY)
    return (1.0 - 2.0 * out).astype(np.float32)
