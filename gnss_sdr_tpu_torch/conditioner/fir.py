"""Input filters: FIR low-pass and frequency-translating decimating FIR.

Port of ``gnss_sdr_tpu/conditioner/fir.py`` (the reference's
fir_filter.cc and freq_xlating_fir_filter.cc adapters): taps designed with
Parks-McClellan on the host (scipy ``remez``, copied as it is), filtering
on complex64 tensors through kernel K7a (``kernels/conditioner.py::
fir_decim``), which computes only the kept outputs of a decimating filter.

One deliberate difference: :func:`freq_xlating_fir_filter` takes the
translation phase in float64 on the absolute sample index, reduced
modulo 2 pi, as the JAX chain does (``chain.py:110-118``); the JAX
function of the same name builds it from a float32 index, which loses
integer precision past 2^24 samples.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal as sp_signal

from gnss_sdr_tpu_torch.kernels.conditioner import fir_decim


def design_lowpass_taps(
    fs: float, cutoff_hz: float, transition_hz: float, ntaps: int = 65,
) -> np.ndarray:
    """Parks-McClellan lowpass (fir_filter.cc band-spec semantics)."""
    edges = [0, cutoff_hz, cutoff_hz + transition_hz, fs / 2]
    taps = sp_signal.remez(ntaps, edges, [1, 0], fs=fs)
    return taps.astype(np.float32)


def fir_filter(x, taps, decimation: int = 1):
    """Causal FIR filter (real taps) on complex64 samples ``x`` [N].

    Output n = sum_k taps[k] * x[n - k]; optionally keep every
    ``decimation``-th output (gr FIR decimator semantics).
    """
    return fir_decim(x, taps, decimation)


def nco_step(center_freq_hz: float, fs: float) -> float:
    """Phase step of the translation NCO, rad per sample (float64)."""
    return -2.0 * math.pi * center_freq_hz / fs


def freq_xlating_fir_filter(x, taps, center_freq_hz: float, fs: float,
                            decimation: int = 1, n0: int = 0):
    """Frequency-translate (IF -> baseband) then decimating lowpass.

    Mirrors gr::filter::freq_xlating_fir_filter as used by the reference's
    Freq_Xlating_Fir_Filter adapter: x * e^{-j 2 pi f0 n / fs} -> FIR ->
    keep every D-th sample; ``n0`` is the absolute index of ``x[0]``.
    """
    return fir_decim(x, taps, decimation, nco_step(center_freq_hz, fs), n0)
