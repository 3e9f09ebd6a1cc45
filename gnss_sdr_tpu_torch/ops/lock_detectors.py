"""C/N0 estimators and carrier lock detector on torch tensors.

Port of ``gnss_sdr_tpu/ops/lock_detectors.py`` (gnss-sdr's
lock_detectors.cc), vectorized over prompt-sample buffers with any
leading batch dims; ``(p_re, p_im)`` hold the last N prompts on the last
axis.
"""

from __future__ import annotations

import torch

TINY = torch.finfo(torch.float32).tiny


def cn0_svn_estimator(p_re, p_im, coh_integration_time_s):
    """SNV C/N0 estimate [dB-Hz] (lock_detectors.cc:56-72)."""
    psig = torch.mean(torch.abs(p_re), dim=-1) ** 2
    ptot = torch.mean(p_re**2 + p_im**2, dim=-1)
    snr = psig / torch.clamp(ptot - psig, min=TINY)
    return 10.0 * torch.log10(torch.clamp(snr, min=TINY)) \
        - 10.0 * torch.log10(torch.as_tensor(coh_integration_time_s,
                                             dtype=torch.float32,
                                             device=p_re.device))


def cn0_m2m4_estimator(p_re, p_im, coh_integration_time_s):
    """Moments-method C/N0 estimate [dB-Hz] (lock_detectors.cc:75-115)."""
    psig = torch.mean(torch.abs(p_re), dim=-1) ** 2
    aux = p_re**2 + p_im**2
    m2 = torch.mean(aux, dim=-1)
    m4 = torch.mean(aux**2, dim=-1)
    arg = 2.0 * m2 * m2 - m4
    root = torch.sqrt(torch.clamp(arg, min=0.0))
    # the reference falls back to the SNV numerator when the sqrt is NaN
    num = torch.where(arg >= 0.0, root, psig)
    snr = num / torch.clamp(m2 - num, min=TINY)
    return 10.0 * torch.log10(torch.clamp(snr, min=TINY)) \
        - 10.0 * torch.log10(torch.as_tensor(coh_integration_time_s,
                                             dtype=torch.float32,
                                             device=p_re.device))


def carrier_lock_detector(p_re, p_im):
    """cos(2*phase_error) estimate via NBD/NBP (lock_detectors.cc:118-151)."""
    si = torch.sum(p_re, dim=-1)
    sq = torch.sum(p_im, dim=-1)
    nbp = si * si + sq * sq
    nbd = si * si - sq * sq
    return nbd / torch.clamp(nbp, min=TINY)
