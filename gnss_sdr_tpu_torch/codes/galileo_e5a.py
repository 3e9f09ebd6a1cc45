"""Galileo E5a code generation (I data / Q pilot components).

Counterpart of gnss-sdr/src/algorithms/libs/
galileo_e5_signal_replica.cc: 10230-chip primary memory codes per PRN
(ICD Annex C, hex tables in _galileo_e5a_data), the 20-chip E5a-I and
per-PRN 100-chip E5a-Q secondary codes. The same hex-bit sign convention
as E1 (bit 1 -> chip -1).

Copied from ``gnss_sdr_tpu/codes/galileo_e5a.py``; only the import
paths differ.
"""

from __future__ import annotations

import functools

import numpy as np

from gnss_sdr_tpu_torch.codes._galileo_e5a_data import (
    E5AI_HEX,
    E5AI_SECONDARY,
    E5AQ_HEX,
    E5AQ_SECONDARY,
)

CODE_LENGTH = 10230
CHIP_RATE = 10.23e6


def _hex_to_chips(hex_str: str) -> np.ndarray:
    # 2558 hex chars = 10232 bits; keep the first 10230
    bits = np.frombuffer(bytes.fromhex(hex_str), dtype=np.uint8)
    unpacked = np.unpackbits(bits)[:CODE_LENGTH]
    return np.where(unpacked == 1, -1.0, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def galileo_e5a_code(prn: int, component: str = "I") -> np.ndarray:
    """10230-chip primary code, +-1 float32 (PRN 1..50)."""
    if not 1 <= prn <= 50:
        raise ValueError(f"Galileo PRN must be 1..50, got {prn}")
    table = E5AI_HEX if component.upper() == "I" else E5AQ_HEX
    return _hex_to_chips(table[prn - 1])


def galileo_e5a_secondary(prn: int, component: str = "I") -> str:
    """Secondary code string ('0'/'1'): 20 chips on I, 100 on Q."""
    if component.upper() == "I":
        return E5AI_SECONDARY
    if not 1 <= prn <= len(E5AQ_SECONDARY):
        raise ValueError(
            f"E5a-Q secondary defined for PRN 1..{len(E5AQ_SECONDARY)}")
    return E5AQ_SECONDARY[prn - 1]
