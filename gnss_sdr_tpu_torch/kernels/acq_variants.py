"""K5 wrappers: the QuickSync and CCCWSR acquisition grids.

Two kernels of ``csrc/acq_variants.cu`` around ``torch.fft`` and the K2
kernels (``kernels/acq.py``):

- :func:`fold_wipeoff` (K5a): for every Doppler bin, the carrier wiped
  off at the absolute sample index and the S segments of the buffer
  summed, [D, N/S] (the prologue of QuickSync's ``_folded_grid``; the
  body of ``csrc/wipeoff.cuh``, whose S = 1 instance is K2's wipe-off);
- :func:`cccwsr_combine` (K5b): ``max(|yb + yc|^2, |yb - yc|^2)`` of the
  E1-B and E1-C correlation grids with each row's peak and first argmax
  (the epilogue of ``_cccwsr_grid``).

:func:`folded_grid` and :func:`cccwsr_grid` run a whole dwell. Each
kernel takes its ``*_plain`` PyTorch version for a CPU tensor and
launches its kernel for a CUDA tensor.
"""

from __future__ import annotations

import torch

from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb
from gnss_sdr_tpu_torch.kernels.acq import (acq_accum, acq_product,
                                            acq_wipeoff, wipeoff_inputs)


# ---- plain versions ----------------------------------------------------------

def fold_wipeoff_plain(x, dopplers, c0: float, s: int):
    nf = x.shape[0] // s
    w = (c0 * dopplers)[:, None]                                # [D, 1]
    acc_re = acc_im = None
    for k in range(s):
        n = torch.arange(k * nf, (k + 1) * nf, dtype=torch.float32,
                         device=x.device)
        ph = w * n[None, :]
        cs, sn = torch.cos(ph), torch.sin(ph)
        xr, xi = x.real[k * nf:(k + 1) * nf], x.imag[k * nf:(k + 1) * nf]
        re, im = xr * cs - xi * sn, xr * sn + xi * cs
        acc_re = re if acc_re is None else acc_re + re
        acc_im = im if acc_im is None else acc_im + im
    return torch.complex(acc_re, acc_im)


def cccwsr_combine_plain(yb, yc):
    def mag2(re, im):
        return re * re + im * im

    plus = mag2(yb.real + yc.real, yb.imag + yc.imag)
    minus = mag2(yb.real - yc.real, yb.imag - yc.imag)
    grid = torch.maximum(plus, minus)
    row_arg = torch.argmax(grid, dim=-1)
    row_max = torch.gather(grid, -1, row_arg[..., None])[..., 0]
    return grid, row_max, row_arg.to(torch.int32)


# ---- kernels -------------------------------------------------------------------

def fold_wipeoff(x, dopplers, c0: float, s: int):
    """[D, N/S] complex64: x [N] complex64 wiped off at every Doppler bin
    ``dopplers`` [D] float32 (phase ``c0 * f_d * n``) and folded over its
    ``s`` segments."""
    if x.is_cpu:
        return fold_wipeoff_plain(x, dopplers, c0, s)
    x, dopplers = wipeoff_inputs(x, dopplers, "fold_wipeoff")
    if s < 1 or x.shape[0] % s:
        raise ValueError("fold_wipeoff: the fold must divide the buffer")
    nf, d = x.shape[0] // s, dopplers.shape[0]
    out = x.new_empty((d, nf))
    fn = kb.function("acq_variants", "fold_wipeoff", [
        kb.VP, kb.VP, kb.F32, kb.I32, kb.I32, kb.I32, kb.VP, kb.VP])
    err = kb.launch(fn, x.device, x.data_ptr(), dopplers.data_ptr(), c0,
                    int(s), nf, d, out.data_ptr())
    kb.check(err, "fold_wipeoff")
    LAUNCHES["fold_wipeoff"] += 1
    return out


def cccwsr_combine(yb, yc):
    """(grid [P, D, N] float32, row_max [P, D], row_arg [P, D] int32) of
    the correlation grids ``yb``, ``yc`` [P, D, N] complex64."""
    if yb.device.type == "cpu":
        return cccwsr_combine_plain(yb, yc)
    if yb.device.type != "cuda":
        raise ValueError(f"cccwsr_combine: unsupported device {yb.device}")
    if yb.dtype != torch.complex64 or yc.dtype != torch.complex64 \
            or yb.shape != yc.shape or yb.dim() != 3:
        raise ValueError("cccwsr_combine: two complex64 [P, D, N] grids")
    yb, yc = yb.contiguous(), yc.contiguous()
    p, d, n = yb.shape
    grid = torch.empty((p, d, n), dtype=torch.float32, device=yb.device)
    row_max = torch.empty((p, d), dtype=torch.float32, device=yb.device)
    row_arg = torch.empty((p, d), dtype=torch.int32, device=yb.device)
    fn = kb.function("acq_variants", "cccwsr_combine", [
        kb.VP, kb.VP, kb.I32, kb.I32, kb.VP, kb.VP, kb.VP, kb.VP])
    err = kb.launch(fn, yb.device, yb.data_ptr(), yc.data_ptr(), p * d, n,
                    grid.data_ptr(), row_max.data_ptr(), row_arg.data_ptr())
    kb.check(err, "cccwsr_combine")
    LAUNCHES["cccwsr_combine"] += 1
    return grid, row_max, row_arg


# ---- one dwell -------------------------------------------------------------------

def folded_grid(x, code_fft, dopplers, c0: float, s: int):
    """QuickSync's |IFFT(FFT(fold(x . wipeoff)) . conj(FFT(folded code)))|^2
    [P, D, N/S] with its row peaks: K5a, cuFFT, K2's product, cuFFT and
    K2's |.|^2 (``code_fft`` holds the conjugated folded code spectra)."""
    spec = torch.fft.fft(fold_wipeoff(x, dopplers, c0, s), dim=-1)
    corr = torch.fft.ifft(acq_product(spec, code_fft), dim=-1)
    return acq_accum(corr, None, 0, corr.shape[-1])


def cccwsr_grid(x, cb_fft, cc_fft, dopplers, c0: float):
    """CCCWSR's max(|yB + yC|^2, |yB - yC|^2) [P, D, N] with its row peaks:
    K2's wipe-off, cuFFT, K2's product against the conjugated E1-B and
    E1-C spectra, two inverse cuFFTs and K5b."""
    spec = torch.fft.fft(acq_wipeoff(x, dopplers, c0), dim=-1)
    yb = torch.fft.ifft(acq_product(spec, cb_fft), dim=-1)
    yc = torch.fft.ifft(acq_product(spec, cc_fft), dim=-1)
    return cccwsr_combine(yb, yc)
