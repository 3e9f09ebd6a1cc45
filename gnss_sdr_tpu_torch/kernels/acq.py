"""K2 wrappers: the PCPS acquisition grid around ``torch.fft``.

Four kernels of ``csrc/acq.cu`` surround the two cuFFT transforms of one
dwell (see :func:`pcps_dwell`):

- :func:`acq_wipeoff`: x[n] e^{j c0 f_d n} for every Doppler bin, [D, N];
- :func:`acq_product`: spectrum x conj(code spectrum), [P, D, N];
- :func:`acq_accum`: |IFFT|^2 on [offset, offset + eff) added into the
  dwell sum, with each row's peak and first argmax;
- :func:`acq_stats`: per PRN the flat argmax and the CFAR or
  first-vs-second-peak statistic.

Each takes its ``*_plain`` PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb

TINY = torch.finfo(torch.float32).tiny


def wipeoff_scale(fs: float) -> float:
    """The f32 constant -2*pi/fs of the wipe-off phase (c0 * f_d * n)."""
    return float(np.float32(-2.0 * math.pi) / np.float32(fs))


# ---- plain versions --------------------------------------------------------

def acq_wipeoff_plain(x, dopplers, c0: float):
    n = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)
    phase = (c0 * dopplers[:, None]) * n[None, :]
    c, s = torch.cos(phase), torch.sin(phase)
    xr, xi = x.real[None, :], x.imag[None, :]
    return torch.complex(xr * c - xi * s, xr * s + xi * c)


def acq_product_plain(spec, code_fft):
    a = spec[None, :, :]
    b = code_fft[:, None, :]
    return torch.complex(a.real * b.real - a.imag * b.imag,
                         a.real * b.imag + a.imag * b.real)


def acq_accum_plain(corr, grid, offset: int, eff: int):
    cut = corr[..., offset:offset + eff]
    mag = cut.real * cut.real + cut.imag * cut.imag
    grid = mag if grid is None else grid + mag
    row_arg = torch.argmax(grid, dim=-1)
    row_max = torch.gather(grid, -1, row_arg[..., None])[..., 0]
    return grid, row_max, row_arg.to(torch.int32)


def cfar_statistics(grid, num_dwells: int):
    """Port of ``pcps.py::_cfar_statistics``: peak over the mean of the
    Doppler row opposite the peak row, halved and divided by the dwells."""
    p, d, eff = grid.shape
    flat = grid.reshape(p, -1)
    idx = torch.argmax(flat, dim=-1)
    index_doppler = idx // eff
    index_time = idx % eff
    peak = torch.gather(flat, -1, idx[:, None])[:, 0]
    opposite = (index_doppler + d // 2) % d
    row = torch.gather(grid, 1, opposite[:, None, None].expand(p, 1, eff))[:, 0]
    input_power = torch.mean(row, dim=-1) / 2.0 / num_dwells
    stat = peak / torch.clamp(input_power, min=TINY)
    return stat, index_doppler, index_time


def second_peak_statistics(grid, samples_per_chip: int):
    """Port of ``pcps.py::_second_peak_statistics``: peak over the largest
    value of the peak row outside a circular +-1 chip exclusion zone."""
    p, d, eff = grid.shape
    flat = grid.reshape(p, -1)
    idx = torch.argmax(flat, dim=-1)
    index_doppler = idx // eff
    index_time = idx % eff
    first = torch.gather(flat, -1, idx[:, None])[:, 0]
    row = torch.gather(grid, 1,
                       index_doppler[:, None, None].expand(p, 1, eff))[:, 0]
    pos = torch.arange(eff, device=grid.device)[None, :]
    dist = torch.abs(pos - index_time[:, None])
    dist = torch.minimum(dist, eff - dist)
    masked = torch.where(dist > samples_per_chip, row,
                         torch.zeros((), device=grid.device))
    second = torch.max(masked, dim=-1).values
    stat = first / torch.clamp(second, min=TINY)
    return stat, index_doppler, index_time


def acq_stats_plain(grid, row_max, row_arg, num_dwells: int,
                    samples_per_chip: int, use_cfar: bool):
    if use_cfar:
        stat, i_dop, i_time = cfar_statistics(grid, num_dwells)
    else:
        stat, i_dop, i_time = second_peak_statistics(grid, samples_per_chip)
    return stat, i_dop.to(torch.int32), i_time.to(torch.int32)


# ---- kernels ---------------------------------------------------------------

def _fn(name, argtypes):
    return kb.function("acq", name, argtypes)


def _cuda(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")


def acq_wipeoff(x, dopplers, c0: float):
    """[D, N] complex64 Doppler-wiped copies of x [N] complex64."""
    if x.device.type == "cpu":
        return acq_wipeoff_plain(x, dopplers, c0)
    _cuda(x, "acq_wipeoff")
    if x.dtype != torch.complex64 or dopplers.dtype != torch.float32:
        raise ValueError("acq_wipeoff: complex64 x and float32 dopplers")
    x = x.contiguous()
    dopplers = dopplers.contiguous()
    n, d = x.shape[0], dopplers.shape[0]
    out = torch.empty((d, n), dtype=torch.complex64, device=x.device)
    fn = _fn("acq_wipeoff", [kb.VP, kb.VP, kb.F32, kb.I32, kb.I32, kb.VP,
                           kb.VP])
    err = kb.launch(fn, x.device, x.data_ptr(), dopplers.data_ptr(), c0, n, d,
                    out.data_ptr())
    kb.check(err, "acq_wipeoff")
    LAUNCHES["acq_wipeoff"] += 1
    return out


def acq_product(spec, code_fft):
    """[P, D, N] complex64 products spec[d] * code_fft[p] (the code
    spectra are already conjugated)."""
    if spec.is_cpu:
        return acq_product_plain(spec, code_fft)
    if not spec.is_cuda:
        raise ValueError(f"acq_product: unsupported device {spec.device}")
    if spec.dtype != torch.complex64 or code_fft.dtype != torch.complex64 \
            or spec.dim() != 2 or code_fft.dim() != 2 \
            or code_fft.shape[1] != spec.shape[1] \
            or code_fft.get_device() != spec.get_device():
        raise ValueError("acq_product: complex64 spec [D, N] and code "
                         "spectra [P, N] on one card expected")
    spec = spec.contiguous()
    code_fft = code_fft.contiguous()
    d, n = spec.shape
    p = code_fft.shape[0]
    out = spec.new_empty((p, d, n))
    fn = _fn("acq_product", [kb.VP, kb.VP, kb.I32, kb.I32, kb.I32, kb.VP,
                           kb.VP])
    err = kb.launch(fn, spec.device, spec.data_ptr(), code_fft.data_ptr(), n,
                    d, p, out.data_ptr())
    kb.check(err, "acq_product")
    LAUNCHES["acq_product"] += 1
    return out


def acq_accum(corr, grid, offset: int, eff: int):
    """Add |corr[..., offset:offset+eff]|^2 into ``grid`` [P, D, eff]
    (``None`` on the first dwell). Returns (grid, row_max [P, D],
    row_arg [P, D] int32). On the card the sum is taken in place."""
    if corr.device.type == "cpu":
        return acq_accum_plain(corr, grid, offset, eff)
    _cuda(corr, "acq_accum")
    if corr.dtype != torch.complex64:
        raise ValueError("acq_accum: complex64 input expected")
    corr = corr.contiguous()
    p, d, n = corr.shape
    first = grid is None
    if first:
        grid = torch.empty((p, d, eff), dtype=torch.float32,
                           device=corr.device)
    elif grid.shape != (p, d, eff) or not grid.is_contiguous():
        raise ValueError("acq_accum: grid must be contiguous [P, D, eff]")
    row_max = torch.empty((p, d), dtype=torch.float32, device=corr.device)
    row_arg = torch.empty((p, d), dtype=torch.int32, device=corr.device)
    fn = _fn("acq_accum", [kb.VP, kb.I32, kb.I32, kb.I32, kb.I32, kb.I32,
                         kb.VP, kb.VP, kb.VP, kb.VP])
    err = kb.launch(fn, corr.device, corr.data_ptr(), p * d, n, int(offset),
                    int(eff), int(first), grid.data_ptr(), row_max.data_ptr(),
                    row_arg.data_ptr())
    kb.check(err, "acq_accum")
    LAUNCHES["acq_accum"] += 1
    return grid, row_max, row_arg


def acq_stats(grid, row_max, row_arg, num_dwells: int,
              samples_per_chip: int, use_cfar: bool):
    """Per-PRN (stat [P] f32, index_doppler [P] i32, index_time [P] i32)."""
    if grid.device.type == "cpu":
        return acq_stats_plain(grid, row_max, row_arg, num_dwells,
                               samples_per_chip, use_cfar)
    _cuda(grid, "acq_stats")
    p, d, eff = grid.shape
    stat = torch.empty((p,), dtype=torch.float32, device=grid.device)
    i_dop = torch.empty((p,), dtype=torch.int32, device=grid.device)
    i_time = torch.empty((p,), dtype=torch.int32, device=grid.device)
    fn = _fn("acq_stats", [kb.VP, kb.VP, kb.VP, kb.I32, kb.I32, kb.I32,
                         kb.F32, kb.I32, kb.I32, kb.VP, kb.VP, kb.VP,
                         kb.VP])
    err = kb.launch(fn, grid.device, grid.data_ptr(),
                    row_max.contiguous().data_ptr(),
                    row_arg.contiguous().data_ptr(), p, d, eff,
                    float(num_dwells), int(samples_per_chip),
                    int(bool(use_cfar)), stat.data_ptr(), i_dop.data_ptr(),
                    i_time.data_ptr())
    kb.check(err, "acq_stats")
    LAUNCHES["acq_stats"] += 1
    return stat, i_dop, i_time


def pcps_dwell(x, code_fft, dopplers, c0: float, offset: int, eff: int,
               grid=None):
    """One dwell of the PCPS grid: wipe-off, FFT, product, inverse FFT and
    |.|^2 accumulate. Returns (grid, row_max, row_arg)."""
    spec = torch.fft.fft(acq_wipeoff(x, dopplers, c0), dim=-1)
    corr = torch.fft.ifft(acq_product(spec, code_fft), dim=-1)
    return acq_accum(corr, grid, offset, eff)


def pcps_magnitude_grid(x, code_fft, dopplers, c0: float, offset: int,
                        eff: int):
    """|IFFT(FFT(x . wipeoff) . conj(FFT(code)))|^2 on [P, D, eff] (the
    counterpart of ``pcps.py::_pcps_magnitude_grid``)."""
    return pcps_dwell(x, code_fft, dopplers, c0, offset, eff)[0]
