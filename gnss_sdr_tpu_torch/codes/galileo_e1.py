"""Galileo E1 OS code generation: primary memory codes + CBOC/sinBOC
modulated replicas.

Counterpart of gnss-sdr/src/algorithms/libs/
galileo_e1_signal_replica.cc: hex table decode (hex_to_binary semantics,
gnss_signal_replica.cc), sinBOC(1,1) / sinBOC(6,1) subcarriers and the
CBOC(6,1,1/11) combination with pilot sign inversion
(galileo_e1_signal_replica.cc:98-148), and fs-rate sampling.

Copied from ``gnss_sdr_tpu/codes/galileo_e1.py``; only the import
paths differ.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from gnss_sdr_tpu_torch.codes._galileo_e1_data import E1B_HEX, E1C_HEX

CODE_LENGTH = 4092
CHIP_RATE = 1.023e6
# CBOC(6,1,1/11) amplitude split (Galileo OS SIS ICD 2.3.3)
CBOC_ALPHA = math.sqrt(10.0 / 11.0)
CBOC_BETA = math.sqrt(1.0 / 11.0)
# E1-C 25-chip secondary code (Galileo_E1.h GALILEO_E1_C_SECONDARY_CODE)
E1C_SECONDARY = "0011100000001010110110010"


def _hex_to_chips(hex_str: str) -> np.ndarray:
    # 1023 hex chars = 4092 bits exactly; pad to an even byte count
    bits = np.frombuffer(bytes.fromhex(hex_str + "0"), dtype=np.uint8)
    unpacked = np.unpackbits(bits)[:CODE_LENGTH]
    # reference convention: hex bit 1 -> chip -1
    # (hex_to_binary_converter, gnss_signal_replica.cc:43-120)
    return np.where(unpacked == 1, -1.0, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def galileo_e1_code(prn: int, component: str = "B") -> np.ndarray:
    """4092-chip primary code for E1-B (data) or E1-C (pilot), +-1."""
    if not 1 <= prn <= 50:
        raise ValueError(f"Galileo PRN must be 1..50, got {prn}")
    table = E1B_HEX if component.upper() == "B" else E1C_HEX
    return _hex_to_chips(table[prn - 1])


@functools.lru_cache(maxsize=None)
def galileo_e1_subchips(prn: int, component: str = "B",
                        cboc: bool = True) -> np.ndarray:
    """Modulated code at sub-chip resolution (12 samples/chip).

    CBOC: data = alpha*sinBOC(1,1) + beta*sinBOC(6,1),
          pilot = alpha*sinBOC(1,1) - beta*sinBOC(6,1)
    (galileo_e1_signal_replica.cc:98-148). With ``cboc=False`` a plain
    sinBOC(1,1) replica at the same resolution (the reference's
    2-samples/chip option, upsampled to keep one table layout).
    """
    chips = galileo_e1_code(prn, component)
    boc11 = np.where(np.arange(12) < 6, 1.0, -1.0).astype(np.float32)
    if cboc:
        boc61 = np.where(np.arange(12) % 2 == 0, 1.0, -1.0).astype(np.float32)
        sign = 1.0 if component.upper() == "B" else -1.0
        sub = CBOC_ALPHA * boc11 + sign * CBOC_BETA * boc61
    else:
        sub = boc11
    return (chips[:, None] * sub[None, :]).reshape(-1).astype(np.float32)


def galileo_e1_sampled(
    prn: int, fs: float, component: str = "B", cboc: bool = True,
) -> np.ndarray:
    """One 4 ms code period sampled at ``fs`` (real-valued waveform).

    Nearest-subchip sampling of the 12-samples/chip table, the same
    digitization the reference applies after generating its oversampled
    replica.
    """
    sub = galileo_e1_subchips(prn, component, cboc)
    sub_rate = CHIP_RATE * 12.0
    n = int(round(fs * CODE_LENGTH / CHIP_RATE))
    idx = np.floor(np.arange(n) * (sub_rate / fs)).astype(np.int64)
    idx = np.minimum(idx, sub.shape[0] - 1)
    return sub[idx]
