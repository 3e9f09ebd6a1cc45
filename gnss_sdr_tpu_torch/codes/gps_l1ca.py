"""GPS L1 C/A (and SBAS L1) PRN code generation.

Gold-code construction per IS-GPS-200 (G1 = 1+x^3+x^10,
G2 = 1+x^2+x^3+x^6+x^8+x^9+x^10, per-PRN G2 delay). Behavior-compatible with
the reference generator (gnss-sdr/src/algorithms/libs/
gps_sdr_signal_replica.cc:25-100) including SBAS PRNs 120-138 and the
``chip_shift`` argument, but vectorized with NumPy instead of a chip-serial
shift-register loop.

Copied from ``gnss_sdr_tpu/codes/gps_l1ca.py``; only the import paths differ.
"""

from __future__ import annotations

import functools

import numpy as np

CODE_LENGTH = 1023

# G2 delays per PRN, IS-GPS-200 Table 3-Ia (PRNs 1-32) and SBAS PRNs 120-138
# (same table as gps_sdr_signal_replica.cc:41-45).
_G2_DELAYS = (
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251, 252, 254, 255, 256, 257, 258,
    469, 470, 471, 472, 473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862,                      # PRN 1..32
    145, 175, 52, 21, 237, 235, 886, 657, 634, 762,
    355, 1012, 176, 603, 130, 359, 595, 68, 386,   # SBAS PRN 120..138
)


def _delay_for_prn(prn: int) -> int:
    if 1 <= prn <= 32:
        return _G2_DELAYS[prn - 1]
    if 120 <= prn <= 138:
        return _G2_DELAYS[prn - 88]
    raise ValueError(f"GPS L1 C/A PRN must be in 1..32 or 120..138, got {prn}")


@functools.lru_cache(maxsize=None)
def _mls_sequences() -> tuple[np.ndarray, np.ndarray]:
    """Return the G1 and G2 maximum-length sequences as uint8 arrays (0/1)."""
    g1_reg = np.ones(10, dtype=np.uint8)
    g2_reg = np.ones(10, dtype=np.uint8)
    g1 = np.empty(CODE_LENGTH, dtype=np.uint8)
    g2 = np.empty(CODE_LENGTH, dtype=np.uint8)
    for i in range(CODE_LENGTH):
        g1[i] = g1_reg[9]
        g2[i] = g2_reg[9]
        fb1 = g1_reg[2] ^ g1_reg[9]
        fb2 = g2_reg[1] ^ g2_reg[2] ^ g2_reg[5] ^ g2_reg[7] ^ g2_reg[8] ^ g2_reg[9]
        g1_reg[1:] = g1_reg[:-1]
        g2_reg[1:] = g2_reg[:-1]
        g1_reg[0] = fb1
        g2_reg[0] = fb2
    return g1, g2


@functools.lru_cache(maxsize=None)
def gps_l1ca_code(prn: int, chip_shift: int = 0) -> np.ndarray:
    """1023-chip C/A code for ``prn`` as float32 in {-1, +1}.

    ``chip_shift`` rotates the code start as in the reference
    (gps_sdr_signal_replica.cc:25, ``chip_shift`` argument): chip i of the
    output is chip (i + chip_shift) mod 1023 of the unshifted code.
    """
    g1, g2 = _mls_sequences()
    delay = _delay_for_prn(prn)
    idx = (np.arange(CODE_LENGTH) + int(chip_shift)) % CODE_LENGTH
    chips = g1[idx] ^ g2[(idx - delay) % CODE_LENGTH]
    return np.where(chips == 1, 1.0, -1.0).astype(np.float32)


def first_10_chips_octal(prn: int) -> int:
    """First 10 chips as the ICD's octal check value (1 = +1 chip)."""
    code = gps_l1ca_code(prn)
    bits = (code[:10] > 0).astype(np.int64)
    value = 0
    for b in bits:
        value = (value << 1) | int(b)
    return int(oct(value)[2:])
