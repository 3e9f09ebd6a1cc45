"""Galileo E5b and E6 code generation.

Counterparts of the reference's galileo_e5_signal_replica.cc (E5b branch)
and galileo_e6_signal_replica.cc: 10230-chip E5b I/Q and 5115-chip E6 B/C
primary memory codes per PRN (ICD Annex C, hex tables), with the E5b-I
4-chip / E5b-Q 100-chip and E6-C 100-chip (hex-packed) secondary codes.

Copied from ``gnss_sdr_tpu/codes/galileo_e5b_e6.py``; only the import
paths differ.
"""

from __future__ import annotations

import functools

import numpy as np

from gnss_sdr_tpu_torch.codes._galileo_e5b_e6_data import (
    E5BI_HEX,
    E5BI_SECONDARY,
    E5BQ_HEX,
    E5BQ_SECONDARY,
    E6B_HEX,
    E6C_HEX,
    E6C_SECONDARY_HEX,
)

E5B_CODE_LENGTH = 10230
E6_CODE_LENGTH = 5115
E5B_CHIP_RATE = 10.23e6
E6_CHIP_RATE = 5.115e6


def _hex_to_chips(hex_str: str, length: int) -> np.ndarray:
    padded = hex_str + "0" if len(hex_str) % 2 else hex_str
    bits = np.frombuffer(bytes.fromhex(padded), dtype=np.uint8)
    unpacked = np.unpackbits(bits)[:length]
    return np.where(unpacked == 1, -1.0, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def galileo_e5b_code(prn: int, component: str = "I") -> np.ndarray:
    """10230-chip E5b primary code, +-1 float32 (PRN 1..50)."""
    if not 1 <= prn <= 50:
        raise ValueError(f"Galileo PRN must be 1..50, got {prn}")
    table = E5BI_HEX if component.upper() == "I" else E5BQ_HEX
    return _hex_to_chips(table[prn - 1], E5B_CODE_LENGTH)


@functools.lru_cache(maxsize=None)
def galileo_e6_code(prn: int, component: str = "B") -> np.ndarray:
    """5115-chip E6 primary code, +-1 float32 (PRN 1..50)."""
    if not 1 <= prn <= 50:
        raise ValueError(f"Galileo PRN must be 1..50, got {prn}")
    table = E6B_HEX if component.upper() == "B" else E6C_HEX
    return _hex_to_chips(table[prn - 1], E6_CODE_LENGTH)


def galileo_e5b_secondary(prn: int, component: str = "I") -> str:
    if component.upper() == "I":
        return E5BI_SECONDARY
    return E5BQ_SECONDARY[prn - 1]


def galileo_e6c_secondary(prn: int) -> str:
    """100-chip E6-C secondary code (stored hex-packed, 25 hex chars)."""
    hex_str = E6C_SECONDARY_HEX[prn - 1]
    bits = np.unpackbits(
        np.frombuffer(bytes.fromhex(hex_str + "0"), dtype=np.uint8))[:100]
    return "".join(str(int(b)) for b in bits)
