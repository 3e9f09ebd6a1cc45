"""Interference mitigation: pulse blanking and narrowband excision.

Port of ``gnss_sdr_tpu/conditioner/interference.py`` (the reference's
pulse_blanking_cc.cc and notch_cc.cc / notch_lite_cc.cc filters):

- :func:`pulse_blanking` zeroes samples whose instantaneous power exceeds
  a multiple of the block's mean power (kernel K7b);
- :func:`notch_filter_block` removes narrowband (CW) interference by
  frequency-domain excision: FFT the block, zero the bins whose magnitude
  exceeds ``k x median``, inverse FFT. The transforms are ``torch.fft``
  (cuFFT on the card) on complex64, the inverse divided by N as in the
  JAX package's ``ops/fft.py``; the mask between them is kernel K7c,
  in place.
"""

from __future__ import annotations

import torch

from gnss_sdr_tpu_torch.kernels.conditioner import notch_mask_, pulse_blank


def pulse_blanking(x, threshold_sigma: float = 4.0):
    """Zero samples with |x|^2 above (threshold_sigma^2 x mean power)."""
    return pulse_blank(x, threshold_sigma)


def notch_filter_block(x, excision_factor: float = 8.0):
    """Frequency-domain narrowband excision over one block of complex64
    samples: bins with magnitude > excision_factor x median magnitude are
    zeroed (CW interference concentrates in few bins; GNSS signal power
    is ~20 dB below the noise floor and untouched). The spectrum is this
    function's own, so the mask zeroes its excised bins in place."""
    spec = torch.fft.fft(x)
    return torch.fft.ifft(notch_mask_(spec, excision_factor))
