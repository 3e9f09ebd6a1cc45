"""Signal conditioner: DataTypeAdapter -> InputFilter -> Resampler.

Port of ``gnss_sdr_tpu/conditioner`` (gnss-sdr's signal_conditioner.cc
chain) on torch tensors. Type adaptation happens at ingest
(``gnss_sdr_tpu_torch.sources``); the filter and resampler stages run on
complex64 tensors through the K7 kernels (``kernels/conditioner.py``).
The antenna-array beamformer (``conditioner/beamformer.py``, K7e) is a
library entry point, as in the JAX package: no factory branch builds it.
"""

from gnss_sdr_tpu_torch.conditioner.beamformer import (BeamformerFilter,
                                                        array_response,
                                                        steering_weights)
from gnss_sdr_tpu_torch.conditioner.fir import (
    design_lowpass_taps,
    fir_filter,
    freq_xlating_fir_filter,
)
from gnss_sdr_tpu_torch.conditioner.resampler import (direct_resample_indices,
                                                      mmse_resample)

__all__ = [
    "BeamformerFilter",
    "array_response",
    "steering_weights",
    "design_lowpass_taps",
    "fir_filter",
    "freq_xlating_fir_filter",
    "direct_resample_indices",
    "mmse_resample",
]
