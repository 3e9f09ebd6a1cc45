"""K7 wrappers: the signal conditioner's four device programs.

Each takes complex64 samples (1-D) and returns complex64:

- :func:`fir_decim` (K7a): causal real-tap FIR, keeping every D-th output,
  after the frequency translation x[n] e^{j phi(n0 + n)} with
  phi = mod(nco_step * (n0 + n), 2 pi) in float64 on the absolute index
  (none for ``nco_step == 0``)
  (``fir.py::fir_filter``, ``freq_xlating_fir_filter`` and the NCO of
  ``chain.py``);
- :func:`pulse_blank` (K7b): zero the samples with |x|^2 above
  sigma^2 x mean |x|^2 (``interference.py::pulse_blanking``);
- :func:`notch_mask` (K7c): zero the spectrum bins with |X| above
  factor x median |X|, the median being the midpoint of the two middle
  values as ``jnp.median`` takes it (``interference.py::
  notch_filter_block`` between its FFTs); :func:`notch_mask_` the same
  in place;
- :func:`resample` (K7d): the Mmse_Resampler's 2-tap linear interpolation
  at k * fs_in / fs_out or the Direct_Resampler's nearest-below sample,
  both with positions computed from the integer k in float64
  (``resampler.py::mmse_resample``, ``direct_resample_indices``);
- :func:`beamform` (K7e): float32 antenna channels [M, N] (two planes,
  or the two halves of one interleaved complex64 capture) times complex
  weights [M] summed over the antennas, (re, im) [N] out
  (``beamformer.py::beamform``); :func:`beamform_complex` the same on a
  complex64 capture [M, N], complex64 [N] out (``BeamformerFilter``'s
  combiner).

Each takes its ``*_plain`` PyTorch version for a CPU tensor and launches
its kernel in ``csrc/conditioner.cu`` for a CUDA tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb

TWO_PI = 2.0 * math.pi
MMSE, DIRECT = 0, 1


def fir_output_len(n_in: int, decimation: int) -> int:
    """Outputs of the decimating FIR: len(range(0, n_in, decimation))."""
    return (n_in + decimation - 1) // decimation


def mmse_output_len(n_in: int, fs_in: float, fs_out: float) -> int:
    return int(np.floor((n_in - 1) * fs_out / fs_in))


def direct_output_len(n_in: int, fs_in: float, fs_out: float) -> int:
    return int(np.floor(n_in * fs_out / fs_in))


def mmse_positions(k, fs_in: float, fs_out: float):
    """(floor index int64, fraction float32) of the Mmse_Resampler's
    output positions k * fs_in / fs_out, from the integer k (int64
    tensor) in float64: exact where JAX's float32 ``arange * ratio`` is,
    and still exact past k = 2^24, where float32 no longer holds k."""
    pos = k.to(torch.float64) * (fs_in / fs_out)
    fl = torch.floor(pos)
    return fl.to(torch.int64), (pos - fl).to(torch.float32)


# ---- plain versions --------------------------------------------------------

def translate_plain(x, nco_step: float, n0: int):
    """x[n] e^{j phi(n0 + n)}, phi = np.mod(nco_step * (n0 + n), 2 pi)."""
    n = torch.arange(x.shape[0], dtype=torch.float64, device=x.device) + n0
    ph = torch.fmod(nco_step * n, TWO_PI)
    ph = torch.where(ph < 0, ph + TWO_PI, ph)
    c = torch.cos(ph).to(torch.float32)
    s = torch.sin(ph).to(torch.float32)
    xr, xi = x.real, x.imag
    return torch.complex(xr * c - xi * s, xr * s + xi * c)


def fir_decim_plain(x, taps, decimation: int, nco_step: float = 0.0,
                    n0: int = 0):
    if nco_step:
        x = translate_plain(x, nco_step, n0)
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    nt = taps.shape[0]
    n_out = fir_output_len(x.shape[0], decimation)
    xp = torch.view_as_real(torch.cat([
        torch.zeros(nt - 1, dtype=torch.complex64, device=x.device), x]))
    span = (n_out - 1) * decimation + 1
    y = torch.zeros((n_out, 2), dtype=torch.float32, device=x.device)
    prod = torch.empty_like(y)
    for j in range(nt):
        lo = nt - 1 - j
        # product and sum rounded apart, in tap order (as the kernel does)
        y += torch.mul(xp[lo:lo + span:decimation], taps[j], out=prod)
    return torch.view_as_complex(y)


def _power(x):
    return x.real * x.real + x.imag * x.imag


def pulse_blank_plain(x, threshold_sigma: float):
    p = _power(x)
    mean = torch.mean(p, dtype=torch.float64).to(torch.float32)
    thr = mean * float(np.float32(threshold_sigma * threshold_sigma))
    return torch.where(p <= thr, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def median_ranks(n: int) -> tuple[int, int]:
    """0-based ranks of the two middle values (equal for odd n)."""
    return (n - 1) // 2, n // 2


def notch_mask_plain(spec, excision_factor: float):
    mag = torch.sqrt(_power(spec))
    lo, hi = median_ranks(mag.shape[0])
    srt = torch.sort(mag).values
    med = (srt[lo] + srt[hi]) * 0.5
    thr = med * float(np.float32(excision_factor))
    return torch.where(mag <= thr, spec, torch.zeros((), dtype=spec.dtype,
                                                     device=spec.device))


def resample_plain(x, fs_in: float, fs_out: float, mode: int):
    n_in = x.shape[0]
    if mode == DIRECT:
        from gnss_sdr_tpu_torch.conditioner.resampler import \
            direct_resample_indices

        idx = torch.as_tensor(direct_resample_indices(n_in, fs_in, fs_out),
                              device=x.device)
        return x[idx]
    k = torch.arange(mmse_output_len(n_in, fs_in, fs_out), dtype=torch.int64,
                     device=x.device)
    i0, frac = mmse_positions(k, fs_in, fs_out)
    i0 = torch.clamp(i0, max=n_in - 1)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    a = torch.view_as_real(x[i0])
    b = torch.view_as_real(x[i1])
    w0 = (1.0 - frac)[:, None]
    return torch.view_as_complex((a * w0 + b * frac[:, None]).contiguous())


def beamform_plain(x_re, x_im, w_re, w_im):
    """JAX's ``beamform``: four einsums over the antennas, then their
    difference and sum."""
    y_re = torch.einsum("mn,m->n", x_re, w_re) - torch.einsum(
        "mn,m->n", x_im, w_im)
    y_im = torch.einsum("mn,m->n", x_re, w_im) + torch.einsum(
        "mn,m->n", x_im, w_re)
    return y_re, y_im


# ---- kernels ---------------------------------------------------------------

def _fn(name, argtypes):
    return kb.function("conditioner", name, argtypes)


def _samples(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.complex64 or x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"{what}: non-empty 1-D complex64 samples expected")
    return x.contiguous()


def fir_decim(x, taps, decimation: int, nco_step: float = 0.0, n0: int = 0):
    """Every ``decimation``-th output of the causal FIR ``taps`` over x
    (translated first unless ``nco_step`` is 0); complex64 [ceil(N / D)]."""
    if x.device.type == "cpu":
        return fir_decim_plain(x, taps, decimation, nco_step, n0)
    x = _samples(x, "fir_decim")
    taps = torch.as_tensor(taps, dtype=torch.float32,
                           device=x.device).contiguous()
    if taps.dim() != 1 or decimation < 1:
        raise ValueError("fir_decim: 1-D taps and decimation >= 1 expected")
    n_out = fir_output_len(x.shape[0], decimation)
    y = torch.empty(n_out, dtype=torch.complex64, device=x.device)
    fn = _fn("fir_decim", [kb.VP, kb.I64, kb.VP, kb.I32, kb.I32, kb.I32,
                         kb.F64, kb.I64, kb.VP, kb.I64, kb.VP])
    err = kb.launch(fn, x.device, x.data_ptr(), x.shape[0], taps.data_ptr(),
                    taps.shape[0], int(decimation), int(nco_step != 0.0),
                    float(nco_step), int(n0), y.data_ptr(), n_out)
    kb.check(err, "fir_decim")
    LAUNCHES["fir_decim"] += 1
    return y


def fir_max_taps(decimation: int, device) -> int:
    """The largest tap count :func:`fir_decim` takes at ``decimation`` on
    card ``device`` (its tile at 32 threads a block within the card's
    opt-in shared memory a block)."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    taps = _fn("fir_decim_max_taps", [kb.I32, kb.I32])(int(decimation),
                                                       index)
    if taps < 1:
        raise RuntimeError("fir_max_taps: the card's shared memory limit "
                           "could not be read")
    return taps


def fir_occupancy(n_taps: int, decimation: int, translate: bool,
                  device) -> dict:
    """K7a's launch at these shapes on card ``device``: its threads a
    block and its blocks an SM at once."""
    import ctypes

    threads, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    fn = _fn("fir_decim_occupancy", [kb.I32, kb.I32, kb.I32, kb.VP, kb.VP])
    with torch.cuda.device(torch.device(device)):
        err = fn(int(n_taps), int(decimation), int(translate),
                 ctypes.addressof(threads), ctypes.addressof(per_sm))
    kb.check(err, "fir_decim_occupancy")
    return dict(threads=threads.value, blocks_per_sm=per_sm.value)


def blank_partials(n: int) -> int:
    """Blocks of the first K7b pass: a function of n only, so the order of
    the float64 power sum is the same on every run."""
    return max(1, min(1024, (n + 255) // 256))


def pulse_blank(x, threshold_sigma: float):
    """x with every sample of |x|^2 > sigma^2 * mean |x|^2 set to 0."""
    if x.device.type == "cpu":
        return pulse_blank_plain(x, threshold_sigma)
    x = _samples(x, "pulse_blank")
    n = x.shape[0]
    parts = blank_partials(n)
    partials = torch.empty(parts, dtype=torch.float64, device=x.device)
    thr = torch.empty(1, dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    fn = _fn("pulse_blank", [kb.VP, kb.I64, kb.F32, kb.VP, kb.I32, kb.VP,
                           kb.VP, kb.VP])
    err = kb.launch(fn, x.device, x.data_ptr(), n,
                    float(np.float32(threshold_sigma * threshold_sigma)),
                    partials.data_ptr(), parts, thr.data_ptr(), y.data_ptr())
    kb.check(err, "pulse_blank")
    LAUNCHES["pulse_blank"] += 1
    return y


def notch_candidates(n: int) -> int:
    """Keys K7c's candidate buffer holds: the bins strictly inside its
    sample's bracket of the median, a few percent of n (n / 16 + 65536,
    at most n); more send the select over all n bins."""
    return min(n, n // 16 + 65536)


#: the word of K7c's selection state that says how it selected: 0 among
#: the bracket's candidates, 1 over all n bins after a miss
NOTCH_ROUTE = 6


def _notch_launch(spec, excision_factor: float, out):
    """K7c on the card: ``out`` (``spec`` itself to mask in place) gets
    the masked spectrum. Returns the selection state (int32, on the
    card; ``NOTCH_ROUTE`` says which route selected)."""
    n = spec.shape[0]
    if n >= 1 << 32:
        raise ValueError("notch_mask: at most 2^32 - 1 bins")
    lo, hi = median_ranks(n)
    words = _fn("notch_sel_words", [])()
    sel = torch.empty(words, dtype=torch.int32, device=spec.device)
    cap = notch_candidates(n)
    cand = torch.empty(cap, dtype=torch.int32, device=spec.device)
    fn = _fn("notch_mask", [kb.VP, kb.I64, kb.F32, kb.VP, kb.VP, kb.U32,
                          kb.VP, kb.U32, kb.U32, kb.VP])
    err = kb.launch(fn, spec.device, spec.data_ptr(), n,
                    float(np.float32(excision_factor)), sel.data_ptr(),
                    cand.data_ptr(), cap, out.data_ptr(), lo, hi)
    kb.check(err, "notch_mask")
    LAUNCHES["notch_mask"] += 1
    return sel


def notch_mask(spec, excision_factor: float):
    """The spectrum with every bin of |X| > factor * median |X| set to 0,
    as a new tensor."""
    if spec.device.type == "cpu":
        return notch_mask_plain(spec, excision_factor)
    spec = _samples(spec, "notch_mask")
    out = torch.empty_like(spec)
    _notch_launch(spec, excision_factor, out)
    return out


def notch_mask_(spec, excision_factor: float):
    """:func:`notch_mask` in place: zeroes the excised bins of ``spec``
    (on the card only those are written) and returns it (a contiguous
    copy of a strided ``spec``)."""
    if spec.device.type == "cpu":
        return spec.copy_(notch_mask_plain(spec, excision_factor))
    spec = _samples(spec, "notch_mask")
    _notch_launch(spec, excision_factor, spec)
    return spec


def notch_sample_positions(n: int) -> torch.Tensor:
    """The bins K7c samples to bracket the median: s n / m for s < m,
    m = min(n, the kernel's sample size)."""
    m = min(n, _fn("notch_sample_size", [])())
    return torch.arange(m, dtype=torch.int64) * n // m


def resample(x, fs_in: float, fs_out: float, mode: int):
    """x at ``fs_in`` resampled to ``fs_out``: ``MMSE`` (linear
    interpolation, floor((N-1) fs_out / fs_in) outputs) or ``DIRECT``
    (nearest sample below, floor(N fs_out / fs_in) outputs)."""
    if x.device.type == "cpu":
        return resample_plain(x, fs_in, fs_out, mode)
    x = _samples(x, "resample")
    n_in = x.shape[0]
    n_out = (mmse_output_len if mode == MMSE else direct_output_len)(
        n_in, fs_in, fs_out)
    if n_out < 1:
        return torch.empty(0, dtype=torch.complex64, device=x.device)
    y = torch.empty(n_out, dtype=torch.complex64, device=x.device)
    fn = _fn("resample", [kb.VP, kb.I64, kb.F64, kb.I32, kb.VP, kb.I64,
                        kb.VP])
    err = kb.launch(fn, x.device, x.data_ptr(), n_in, float(fs_in / fs_out),
                    int(mode), y.data_ptr(), n_out)
    kb.check(err, "resample")
    LAUNCHES["resample"] += 1
    return y


def _beamform_launch(x_re, x_im, w_re, w_im):
    """K7e on the card: complex64 [N] of the float32 [M, N] channels
    ``x_re``, ``x_im`` (any strides, the same for both) and the weights
    ``w_re``, ``w_im`` [M]."""
    if x_re.device.type != "cuda":
        raise ValueError(f"beamform: unsupported device {x_re.device}")
    m = x_re.shape[0]
    for a, shape in ((x_re, x_re.shape), (x_im, x_re.shape), (w_re, (m,)),
                     (w_im, (m,))):
        if a.dtype != torch.float32 or a.device != x_re.device \
                or tuple(a.shape) != tuple(shape):
            raise ValueError("beamform: float32 [M, N] channels and [M] "
                             "weights on one device expected")
    if x_re.dim() != 2 or x_re.shape[1] < 1 \
            or x_re.stride() != x_im.stride() or min(x_re.stride()) < 1:
        raise ValueError("beamform: [M, N] antenna channels of one layout "
                         "expected")
    w_re, w_im = w_re.contiguous(), w_im.contiguous()
    n = x_re.shape[1]
    y = torch.empty(n, dtype=torch.complex64, device=x_re.device)
    fn = _fn("beamform", [kb.VP, kb.VP, kb.I64, kb.I64, kb.I32, kb.I64,
                        kb.VP, kb.VP, kb.VP, kb.VP])
    err = kb.launch(fn, x_re.device, x_re.data_ptr(), x_im.data_ptr(),
                    x_re.stride(1), x_re.stride(0), m, n, w_re.data_ptr(),
                    w_im.data_ptr(), y.data_ptr())
    kb.check(err, "beamform")
    LAUNCHES["beamform"] += 1
    return y


def beamform(x_re, x_im, w_re, w_im):
    """The beamformer's output (y_re, y_im), float32 [N] each, of the
    antenna channels ``x_re``, ``x_im`` float32 [M, N] (contiguous planes,
    or the two planes of one interleaved complex64 capture,
    ``torch.view_as_real(x).unbind(-1)``) and the complex weights
    ``w_re``, ``w_im`` float32 [M]. On the card the two are views of one
    complex64 output."""
    if x_re.device.type == "cpu":
        return beamform_plain(x_re, x_im, w_re, w_im)
    return torch.view_as_real(_beamform_launch(x_re, x_im, w_re,
                                               w_im)).unbind(-1)


def beamform_complex(x, w_re, w_im):
    """The beamformer's output, complex64 [N], of the complex64 capture
    ``x`` [M, N] and the weights ``w_re``, ``w_im`` float32 [M]; on the
    card K7e reads ``x`` as it lies, interleaved."""
    if x.dtype != torch.complex64:
        raise ValueError("beamform_complex: complex64 [M, N] expected")
    x_re, x_im = torch.view_as_real(x).unbind(-1)
    if x.device.type == "cpu":
        return torch.complex(*beamform_plain(x_re, x_im, w_re, w_im))
    return _beamform_launch(x_re, x_im, w_re, w_im)
