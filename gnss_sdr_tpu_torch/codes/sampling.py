"""Code resampling to an arbitrary sampling rate.

Counterpart of the digitizing loops in the reference replica generators
(e.g. gps_l1_ca_code_gen_complex_sampled,
gnss-sdr/src/algorithms/libs/gps_sdr_signal_replica.cc:135-177),
reproducing their index arithmetic (ceil-minus-one with last-sample clamp)
so sampled replicas match the reference bit-for-bit.

Copied from ``gnss_sdr_tpu/codes/sampling.py``; only the import paths differ.
"""

from __future__ import annotations

import numpy as np


def samples_per_code(fs: float, chip_rate: float, code_length: int) -> int:
    """Samples in one code period: ``int(fs / (chip_rate / code_length))``."""
    return int(fs / (chip_rate / code_length))


def sample_code(code: np.ndarray, fs: float, chip_rate: float) -> np.ndarray:
    """Resample a +-1 chip sequence to ``fs`` over exactly one code period.

    Uses the reference's nearest-chip ("repeat the chip") digitization:
    ``index(i) = ceil(ts*(i+1)/tc) - 1`` with the final sample clamped to the
    last chip (gps_sdr_signal_replica.cc:159-176). The ceil is computed in
    float32 first, like the reference's ``AUX_CEIL`` on float, to preserve
    its rounding behavior at exact chip boundaries.
    """
    code = np.asarray(code)
    code_length = code.shape[0]
    n = samples_per_code(fs, chip_rate, code_length)
    ts = np.float32(1.0) / np.float32(fs)
    tc = np.float32(1.0) / np.float32(chip_rate)
    i = np.arange(n, dtype=np.float32)
    aux = (ts * (i + np.float32(1.0))) / tc
    # AUX_CEIL(x) = int(int64(x + 1)): truncation of x+1, not a true ceil for
    # exact integers -- reproduce it exactly.
    idx = (aux + np.float32(1.0)).astype(np.int64) - 1
    idx = np.clip(idx, 0, code_length - 1)
    idx[-1] = code_length - 1
    return code[idx]


def sample_code_floor(code: np.ndarray, fs: float,
                      chip_rate: float) -> np.ndarray:
    """Resample a +-1 chip sequence with the floor (chip-at-sample-start)
    convention — the same digitization as the incoming signal and the
    tracking resampler (volk_gnsssdr_32f_xn_resampler_32f_xn.h:62-80).

    Acquisition replicas use THIS convention so the measured delay is
    unbiased in the real-signal frame: the reference's AUX_CEIL replica
    (:func:`sample_code`) reads the chip at the END of each sample
    interval, which lands its correlation peak one sample late (the
    reference carries that bias into tracking and absorbs it in DLL
    pull-in — at ~1.17 samples/chip wide-band rates it exceeds half a
    chip, so we correct it at the source instead).
    """
    code = np.asarray(code)
    code_length = code.shape[0]
    n = samples_per_code(fs, chip_rate, code_length)
    idx = np.floor(np.arange(n) * (chip_rate / fs)).astype(np.int64)
    return code[np.minimum(idx, code_length - 1)]


def sampled_code_phase_indices(
    n: int, code_length: int, code_phase_step_chips: float,
    rem_code_phase_chips: float = 0.0, shift_chips: float = 0.0,
) -> np.ndarray:
    """Chip indices used by the tracking-style resampler (host reference).

    ``index(k) = floor(step*k + shift - rem) mod code_length`` -- the exact
    indexing of volk_gnsssdr_32f_xn_resampler_32f_xn
    (gnss-sdr/src/algorithms/libs/volk_gnsssdr_module/volk_gnsssdr/
    kernels/volk_gnsssdr/volk_gnsssdr_32f_xn_resampler_32f_xn.h:62-80).
    """
    k = np.arange(n, dtype=np.float64)
    idx = np.floor(code_phase_step_chips * k + shift_chips - rem_code_phase_chips)
    return (idx.astype(np.int64)) % code_length
