"""Code and carrier tracking discriminators on torch tensors.

Port of ``gnss_sdr_tpu/ops/discriminators.py`` (formula for formula,
after gnss-sdr's tracking_discriminators.cc), vectorized over a channel
axis. Correlator values arrive as planar (re, im) float32 pairs.
"""

from __future__ import annotations

import math

import torch


def phase_unwrap(phase_rad):
    """Fold into (-pi/2, pi/2] (tracking_discriminators.cc:27-41)."""
    phase_rad = torch.where(phase_rad >= math.pi / 2, phase_rad - math.pi,
                            phase_rad)
    return torch.where(phase_rad <= -math.pi / 2, phase_rad + math.pi,
                       phase_rad)


def fll_four_quadrant_atan(p1_re, p1_im, p2_re, p2_im, t1, t2):
    """FLL atan2(cross, dot)/(t2-t1) [rad/s] (:46-57)."""
    dot = p1_re * p2_re + p1_im * p2_im
    cross = p1_re * p2_im - p2_re * p1_im
    return torch.atan2(cross, dot) / (t2 - t1)


def fll_diff_atan(p1_re, p1_im, p2_re, p2_im, t1, t2):
    """FLL differential atan discriminator [rad/s] (:60-75); NaNs from
    zero real parts collapse to 0 like the reference's isnan guard."""
    a2 = torch.atan(p2_im / p2_re)
    a1 = torch.atan(p1_im / p1_re)
    diff = a2 - a1
    diff = torch.where(torch.isnan(diff), torch.zeros_like(diff), diff)
    return phase_unwrap(diff) / (t2 - t1)


def pll_four_quadrant_atan(p_re, p_im):
    """PLL atan2(Q, I) [rad] (:78-87)."""
    return torch.atan2(p_im, p_re)


def pll_cloop_two_quadrant_atan(p_re, p_im):
    """Costas-loop atan(Q/I) [rad], 0 when I == 0 (:90-102)."""
    nz = p_re != 0.0
    ratio = torch.where(nz, p_im / torch.where(nz, p_re,
                                                torch.ones_like(p_re)),
                        torch.zeros_like(p_re))
    return torch.atan(ratio)


def dll_nc_e_minus_l_normalized(e_re, e_im, l_re, l_im,
                                spc=0.5, slope=1.0, y_intercept=1.0):
    """Normalized noncoherent E-L envelope discriminator [chips]
    (:105-124), with the BOC slope/intercept correction."""
    e = torch.sqrt(e_re * e_re + e_im * e_im)
    l = torch.sqrt(l_re * l_re + l_im * l_im)
    s = e + l
    pos = s > 0.0
    raw = torch.where(pos, (e - l) / torch.where(pos, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    return ((y_intercept - slope * spc) / slope) * raw


def dll_nc_vemlp_normalized(ve_re, ve_im, e_re, e_im,
                            l_re, l_im, vl_re, vl_im):
    """VEMLP discriminator for VEML (5-tap) tracking [chips] (:127-149)."""
    e = torch.sqrt(ve_re**2 + ve_im**2 + e_re**2 + e_im**2)
    l = torch.sqrt(l_re**2 + l_im**2 + vl_re**2 + vl_im**2)
    s = e + l
    pos = s > 0.0
    return torch.where(pos, (e - l) / torch.where(pos, s, torch.ones_like(s)),
                       torch.zeros_like(s))
