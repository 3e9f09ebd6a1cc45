"""Carrier-wipeoff multicorrelator on torch tensors (planar complex).

Exact port of ``gnss_sdr_tpu/ops/correlator.py::multicorrelate``, the
segmented-sum form of gnss-sdr's resampler + rotator-dot-product pair
(cpu_multicorrelator_real_codes.cc:72-126):

- code index per tap: floor(code_step*n + shift - rem_code) mod L, in
  code-table units (volk_gnsssdr_32f_xn_resampler_32f_xn.h:62-80);
- carrier wipe-off: x[n] * e^{-j(rem_carr + step*n + 0.5*rate*n^2)}.

With a code phase rate (high dynamics) the code index becomes quadratic
and :func:`multicorrelate_hd` gathers it per sample.

It is the oracle that the CPU tests hold against the JAX package and the
plain version that the K3 kernel (``kernels/csrc/multicorr.cu``, the
direct per-sample form) is held against on the card; its high-dynamics
branch (a code phase rate given) is the plain version of K3-hd
(``multicorr_hd_kernel``, launched by ``kernels/multicorr.py::multicorr``
with the rates).
"""

from __future__ import annotations

import math

import torch


def n_extra_bins(shifts) -> int:
    """Spill bins each side of the code: the widest tap shift, rounded up,
    plus one (computed on the host from the constant tap shifts)."""
    return int(math.ceil(float(max(abs(float(s)) for s in shifts)))) + 1


def fma_f32(a, b, c):
    """``a * b + c`` rounded once to float32, formed in float64 (the
    product of two float32 values is exact there): XLA's CPU backend fuses
    the high-dynamics branch's multiply-adds this way, which decides chip
    edges at E1's three table entries a sample."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def multicorrelate_hd(x_re, x_im, code_table, shifts, rem_code_phase,
                      code_phase_step, rem_carr_phase_rad,
                      carr_phase_step_rad, length, carr_phase_rate_step_rad,
                      code_phase_rate_step):
    """The high-dynamics branch (quadratic code phase): the direct
    per-sample gather, as the JAX package evaluates it on the CPU (its
    products and sums fused as XLA fuses them: ``fma(0.5 rate n, n,
    fma(step, n, -rem))`` for the code, ``fma(0.5 carr_rate n, n,
    fma(carr_step, n, rem_carr))`` for the carrier). The plain version of
    K3-hd (``multicorr_hd_kernel``)."""
    dev = x_re.device
    L = x_re.shape[-1]
    code_len = code_table.shape[-1]
    n = torch.arange(L, dtype=torch.float32, device=dev)
    valid = n < length[..., None].to(torch.float32)
    phase = fma_f32(carr_phase_step_rad[..., None], n,
                    rem_carr_phase_rad[..., None])
    if carr_phase_rate_step_rad is not None:
        phase = fma_f32(0.5 * carr_phase_rate_step_rad[..., None] * n, n,
                        phase)
    c = torch.cos(phase)
    s = torch.sin(phase)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rot_re = torch.where(valid, x_re * c + x_im * s, zero)
    rot_im = torch.where(valid, x_im * c - x_re * s, zero)
    base = fma_f32(code_phase_step[..., None], n, -rem_code_phase[..., None])
    base = fma_f32(0.5 * code_phase_rate_step[..., None] * n, n, base)
    idx = torch.floor(base[..., None, :] + shifts[:, None]).to(torch.int64)
    idx = torch.remainder(idx, code_len)
    table = code_table[..., None, :].expand(
        *code_table.shape[:-1], shifts.shape[0], code_len)
    codes = torch.gather(table, -1, idx)
    corr_re = torch.sum(codes * rot_re[..., None, :], dim=-1)
    corr_im = torch.sum(codes * rot_im[..., None, :], dim=-1)
    return corr_re, corr_im


def multicorrelate(
    x_re,                 # [..., L] float32 input samples (real part)
    x_im,                 # [..., L] float32 input samples (imag part)
    code_table,           # [..., code_len] float32 local code (+-1 chips)
    shifts,               # [T] float32 tap shifts in code-table units
    rem_code_phase,       # [...] float32, code-table units
    code_phase_step,      # [...] float32, code-table units per sample
    rem_carr_phase_rad,   # [...] float32
    carr_phase_step_rad,  # [...] float32
    length,               # [...] int32 valid samples this period
    carr_phase_rate_step_rad=None,   # [...] float32 (high-dyn) or None
    code_phase_rate_step=None,       # [...] float32 (high-dyn) or None
    n_extra: int | None = None,
):
    """Return correlator outputs ([..., T] re, [..., T] im).

    ``...`` is any batch shape (channels); L is the static max period
    length and ``length`` masks the live prefix. ``n_extra`` is
    :func:`n_extra_bins` of ``shifts``; pass it to keep the call free of
    a device-to-host read."""
    if code_phase_rate_step is not None:
        return multicorrelate_hd(
            x_re, x_im, code_table, shifts, rem_code_phase, code_phase_step,
            rem_carr_phase_rad, carr_phase_step_rad, length,
            carr_phase_rate_step_rad, code_phase_rate_step)
    dev = x_re.device
    L = x_re.shape[-1]
    code_len = code_table.shape[-1]
    n = torch.arange(L, dtype=torch.float32, device=dev)
    valid = n < length[..., None].to(torch.float32)

    phase = rem_carr_phase_rad[..., None] + carr_phase_step_rad[..., None] * n
    if carr_phase_rate_step_rad is not None:
        phase = phase + 0.5 * carr_phase_rate_step_rad[..., None] * n * n
    c = torch.cos(phase)
    s = torch.sin(phase)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rot_re = torch.where(valid, x_re * c + x_im * s, zero)
    rot_im = torch.where(valid, x_im * c - x_re * s, zero)
    n_taps = shifts.shape[0]

    # ---- segmented-sum evaluation (exact) -------------------------------
    zeros1 = torch.zeros(rot_re.shape[:-1] + (1,), dtype=torch.float32,
                         device=dev)
    p_re = torch.cat([zeros1, torch.cumsum(rot_re, dim=-1)], dim=-1)
    p_im = torch.cat([zeros1, torch.cumsum(rot_im, dim=-1)], dim=-1)

    if n_extra is None:
        n_extra = n_extra_bins(shifts.tolist())
    cc = torch.arange(-n_extra, code_len + n_extra + 1, dtype=torch.float32,
                      device=dev)
    a = torch.ceil((cc[None, :] + rem_code_phase[..., None, None]
                    - shifts[:, None])
                   / code_phase_step[..., None, None])     # [..., T, bins+1]
    a = torch.clamp(a, 0, L).to(torch.int64)
    batch = p_re.shape[:-1]
    pr = torch.gather(p_re[..., None, :].expand(*batch, n_taps, L + 1), -1, a)
    pi_ = torch.gather(p_im[..., None, :].expand(*batch, n_taps, L + 1), -1, a)
    seg_re = torch.diff(pr, dim=-1)                        # chips -ne..cl+ne-1
    seg_im = torch.diff(pi_, dim=-1)
    core_re = seg_re[..., n_extra:n_extra + code_len].clone()
    core_im = seg_im[..., n_extra:n_extra + code_len].clone()
    for j in range(n_extra):
        # chip -1-j wraps to code_len-1-j; chip code_len+j wraps to j
        core_re[..., code_len - 1 - j] += seg_re[..., n_extra - 1 - j]
        core_im[..., code_len - 1 - j] += seg_im[..., n_extra - 1 - j]
        core_re[..., j] += seg_re[..., n_extra + code_len + j]
        core_im[..., j] += seg_im[..., n_extra + code_len + j]

    corr_re = torch.sum(core_re * code_table[..., None, :], dim=-1)
    corr_im = torch.sum(core_im * code_table[..., None, :], dim=-1)
    return corr_re, corr_im
