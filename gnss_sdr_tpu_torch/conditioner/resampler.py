"""Sample-rate conversion.

Port of ``gnss_sdr_tpu/conditioner/resampler.py`` (the reference's
Direct_Resampler, direct_resampler_conditioner_cc.cc:1-112, and
Mmse_Resampler). :func:`direct_resample_indices` is host numpy in
float64, copied as it is; both resamplers run as kernel K7d
(``kernels/conditioner.py::resample``), which computes the same indices
on the card.

One deliberate difference: :func:`mmse_resample` computes each output
position from its integer index in float64. The JAX function builds the
positions as ``arange(n_out, float32) * ratio``; past 2^24 outputs (4.19 s
at 4 Msps) float32 no longer holds the index, and consecutive outputs
repeat or skip samples.
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.kernels.conditioner import DIRECT, MMSE, resample


def direct_resample_indices(
    n_in: int, fs_in: float, fs_out: float
) -> np.ndarray:
    """Input indices selecting output samples at ``fs_out``.

    Reproduces the reference's phase-accumulator selection: the k-th output
    takes the input sample where the accumulated phase crosses, i.e.
    index floor(k * fs_in / fs_out).
    """
    n_out = int(np.floor(n_in * fs_out / fs_in))
    idx = np.floor(np.arange(n_out) * (fs_in / fs_out)).astype(np.int64)
    return np.minimum(idx, n_in - 1)


def mmse_resample(x, fs_in: float, fs_out: float):
    """Fractional-delay resampler (linear-interpolating polyphase).

    Counterpart of the reference's Mmse_Resampler adapter (GNU Radio
    mmse_resampler_cc): here a 2-tap linear interpolator on complex64
    samples — the standard quality/throughput point for downsampling GNSS
    IF streams to ``internal_fs_sps``.
    """
    return resample(x, fs_in, fs_out, MMSE)


def direct_resample(x, fs_in: float, fs_out: float):
    """``x[direct_resample_indices(len(x), fs_in, fs_out)]``."""
    return resample(x, fs_in, fs_out, DIRECT)
