"""K3 wrapper: the scan engine's per-period multicorrelator.

:func:`multicorr` correlates every channel's window of a planar sample
source (the int8 ring or a float32 block) against its code table for all
taps. On the card it launches ``csrc/multicorr.cu``; on the CPU it runs
:func:`multicorr_plain`, the segmented-sum oracle
(``ops/correlator.py::multicorrelate``) on the same windows.
"""

from __future__ import annotations

import torch

from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb
from gnss_sdr_tpu_torch.ops.correlator import multicorrelate

_ARGTYPES = [kb.VP, kb.VP, kb.I64, kb.VP, kb.VP, kb.VP, kb.I32, kb.VP,
             kb.I32, kb.VP, kb.VP, kb.VP, kb.VP, kb.I32, kb.I32, kb.VP,
             kb.VP, kb.I32, kb.VP]


def windows(src_re, src_im, base: int, start, width: int):
    """[C, width] float32 windows of the planar source at base + start."""
    idx = (base + start.to(torch.int64))[:, None] \
        + torch.arange(width, device=start.device)
    return src_re[idx].to(torch.float32), src_im[idx].to(torch.float32)


def multicorr_plain(src_re, src_im, base, start, length, code_tables,
                    shifts, rem_code, code_step, rem_carr, carr_step,
                    max_period: int, n_extra: int):
    x_re, x_im = windows(src_re, src_im, base, start, max_period)
    return multicorrelate(x_re, x_im, code_tables, shifts, rem_code,
                          code_step, rem_carr, carr_step, length,
                          n_extra=n_extra)


def multicorr(src_re, src_im, base: int, start, length, code_tables, shifts,
              rem_code, code_step, rem_carr, carr_step, max_period: int,
              n_extra: int):
    """Correlations ``([C, T] re, [C, T] im)`` of the windows
    ``src[base + start[c] : + max_period]`` (valid prefix ``length[c]``).

    ``src_re``/``src_im`` are 1-D planes (int8 or float32); ``start`` and
    ``length`` int32 [C]; the loop quantities float32 [C]. Every window
    must lie inside the planes: ``0 <= start[c]`` and ``base + start[c] +
    max_period <= len``; the scan engine clamps its starts to that range
    (reading them here would cost a device-to-host copy per step). As in
    the segmented-sum oracle, samples past the chips ``-n_extra ..
    code_len + n_extra - 1`` of a tap count for nothing."""
    if src_re.device.type == "cpu":
        return multicorr_plain(src_re, src_im, base, start, length,
                               code_tables, shifts, rem_code, code_step,
                               rem_carr, carr_step, max_period, n_extra)
    if src_re.device.type != "cuda":
        raise ValueError(f"multicorr: unsupported device {src_re.device}")
    c, code_len = code_tables.shape
    t = shifts.shape[0]
    kb.check_planes(src_re, src_im, "multicorr")
    for a in (rem_code, code_step, rem_carr, carr_step, shifts, code_tables):
        if a.dtype != torch.float32 or not a.is_contiguous() \
                or a.device != src_re.device:
            raise ValueError("multicorr: float32 contiguous tensors on the "
                             "source's device expected")
    for a in (rem_code, code_step, rem_carr, carr_step):
        if a.shape != (c,):
            raise ValueError("multicorr: per-channel loop values must be [C]")
    for a in (start, length):
        if a.dtype != torch.int32 or a.shape != (c,) \
                or a.device != src_re.device:
            raise ValueError("multicorr: int32 [C] start/length expected")
    if base < 0 or base + max_period > src_re.shape[0]:
        raise ValueError("multicorr: window base outside the source")
    if src_re.dtype == torch.int8:
        fn = "multicorr_i8"
    elif src_re.dtype == torch.float32:
        fn = "multicorr_f32"
    else:
        raise ValueError(f"multicorr: unsupported sample type {src_re.dtype}")
    f = kb.function("multicorr", fn, _ARGTYPES)
    out_re = torch.empty((c, t), dtype=torch.float32, device=src_re.device)
    out_im = torch.empty_like(out_re)
    start = start.contiguous()
    length = length.contiguous()
    err = f(src_re.data_ptr(), src_im.data_ptr(), int(base),
            start.data_ptr(), length.data_ptr(), code_tables.data_ptr(),
            code_len, shifts.data_ptr(), t, rem_code.data_ptr(),
            code_step.data_ptr(), rem_carr.data_ptr(), carr_step.data_ptr(),
            int(max_period), int(n_extra), out_re.data_ptr(),
            out_im.data_ptr(), c,
            kb.stream_ptr())
    kb.check(err, fn)
    LAUNCHES["multicorr"] += 1
    return out_re, out_im
