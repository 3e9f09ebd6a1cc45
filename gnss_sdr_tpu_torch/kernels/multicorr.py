"""K3 wrapper: the scan engine's per-period multicorrelator, and K3-hd.

:func:`multicorr` correlates every channel's window of a planar sample
source (the int8 ring or a float32 block) against its code table for all
taps. On the card it launches ``csrc/multicorr.cu``; on the CPU it runs
:func:`multicorr_plain`, the segmented-sum oracle
(``ops/correlator.py::multicorrelate``) on the same windows. Given a code
phase rate (and optionally a carrier phase rate), it is K3-hd, the
high-dynamics form with quadratic code and carrier phases: on the card
``multicorr_hd_kernel``, on the CPU ``multicorrelate``'s direct-gather
branch (its plain version).
"""

from __future__ import annotations

import torch

from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb
from gnss_sdr_tpu_torch.ops.correlator import multicorrelate

_ARGTYPES = [kb.VP, kb.VP, kb.I64, kb.VP, kb.VP, kb.VP, kb.I32, kb.VP,
             kb.I32, kb.VP, kb.VP, kb.VP, kb.VP, kb.I32, kb.I32, kb.VP,
             kb.VP, kb.I32, kb.VP]
_HD_ARGTYPES = [kb.VP, kb.VP, kb.I64, kb.VP, kb.VP, kb.VP, kb.I32, kb.VP,
                kb.I32, kb.VP, kb.VP, kb.VP, kb.VP, kb.VP, kb.VP, kb.I32,
                kb.VP, kb.VP, kb.I32, kb.VP]


def windows(src_re, src_im, base: int, start, width: int):
    """[C, width] float32 windows of the planar source at base + start."""
    idx = (base + start.to(torch.int64))[:, None] \
        + torch.arange(width, device=start.device)
    return src_re[idx].to(torch.float32), src_im[idx].to(torch.float32)


def multicorr_plain(src_re, src_im, base, start, length, code_tables,
                    shifts, rem_code, code_step, rem_carr, carr_step,
                    max_period: int, n_extra: int, carr_rate=None,
                    code_rate=None):
    x_re, x_im = windows(src_re, src_im, base, start, max_period)
    return multicorrelate(x_re, x_im, code_tables, shifts, rem_code,
                          code_step, rem_carr, carr_step, length,
                          carr_rate, code_rate, n_extra=n_extra)


def multicorr(src_re, src_im, base: int, start, length, code_tables, shifts,
              rem_code, code_step, rem_carr, carr_step, max_period: int,
              n_extra: int, carr_rate=None, code_rate=None):
    """Correlations ``([C, T] re, [C, T] im)`` of the windows
    ``src[base + start[c] : + max_period]`` (valid prefix ``length[c]``).

    ``src_re``/``src_im`` are 1-D planes (int8 or float32); ``start`` and
    ``length`` int32 [C]; the loop quantities float32 [C]. Every window
    must lie inside the planes: ``0 <= start[c]`` and ``base + start[c] +
    max_period <= len``; the scan engine clamps its starts to that range
    (reading them here would cost a device-to-host copy per step). As in
    the segmented-sum oracle, samples past the chips ``-n_extra ..
    code_len + n_extra - 1`` of a tap count for nothing.

    ``code_rate`` (and ``carr_rate``), float32 [C] in code-table units and
    radians per sample squared, select K3-hd: the per-sample gather at
    the quadratic phases (``n_extra`` is then unused). On the card a
    carrier rate without a code rate is refused: that form (the segmented
    sum with a quadratic carrier) has no kernel."""
    if src_re.device.type == "cpu":
        return multicorr_plain(src_re, src_im, base, start, length,
                               code_tables, shifts, rem_code, code_step,
                               rem_carr, carr_step, max_period, n_extra,
                               carr_rate, code_rate)
    if src_re.device.type != "cuda":
        raise ValueError(f"multicorr: unsupported device {src_re.device}")
    hd = code_rate is not None
    if carr_rate is not None and not hd:
        raise ValueError("multicorr: a carrier rate needs a code rate on "
                         "the card (the high-dynamics form)")
    c, code_len = code_tables.shape
    t = shifts.shape[0]
    kb.check_planes(src_re, src_im, "multicorr")
    loop = [rem_code, code_step, rem_carr, carr_step] + [
        a for a in (carr_rate, code_rate) if a is not None]
    for a in loop + [shifts, code_tables]:
        if a.dtype != torch.float32 or not a.is_contiguous() \
                or a.device != src_re.device:
            raise ValueError("multicorr: float32 contiguous tensors on the "
                             "source's device expected")
    for a in loop:
        if a.shape != (c,):
            raise ValueError("multicorr: per-channel loop values must be [C]")
    for a in (start, length):
        if a.dtype != torch.int32 or a.shape != (c,) \
                or a.device != src_re.device:
            raise ValueError("multicorr: int32 [C] start/length expected")
    if base < 0 or base + max_period > src_re.shape[0]:
        raise ValueError("multicorr: window base outside the source")
    if src_re.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"multicorr: unsupported sample type {src_re.dtype}")
    fn = "multicorr_" + ("hd_" if hd else "") + (
        "i8" if src_re.dtype == torch.int8 else "f32")
    out_re = torch.empty((c, t), dtype=torch.float32, device=src_re.device)
    out_im = torch.empty_like(out_re)
    start = start.contiguous()
    length = length.contiguous()
    if hd:
        f = kb.function("multicorr", fn, _HD_ARGTYPES)
        err = kb.launch(f, src_re.device, src_re.data_ptr(), src_im.data_ptr(),
                        int(base), start.data_ptr(), length.data_ptr(),
                        code_tables.data_ptr(), code_len, shifts.data_ptr(), t,
                        rem_code.data_ptr(), code_step.data_ptr(),
                        code_rate.data_ptr(), rem_carr.data_ptr(),
                        carr_step.data_ptr(),
                        None if carr_rate is None else carr_rate.data_ptr(),
                        int(max_period), out_re.data_ptr(), out_im.data_ptr(),
                        c)
        kb.check(err, fn)
        LAUNCHES["multicorr_hd"] += 1
        return out_re, out_im
    f = kb.function("multicorr", fn, _ARGTYPES)
    err = kb.launch(f, src_re.device, src_re.data_ptr(), src_im.data_ptr(),
                    int(base), start.data_ptr(), length.data_ptr(),
                    code_tables.data_ptr(), code_len, shifts.data_ptr(), t,
                    rem_code.data_ptr(), code_step.data_ptr(),
                    rem_carr.data_ptr(), carr_step.data_ptr(), int(max_period),
                    int(n_extra), out_re.data_ptr(), out_im.data_ptr(), c)
    kb.check(err, fn)
    LAUNCHES["multicorr"] += 1
    return out_re, out_im


def cluster(n_taps: int, code_len: int, max_period: int, src_dtype,
            device) -> dict:
    """K3's cluster on card ``device`` for ``n_taps`` taps, tables of
    ``code_len`` entries and windows of ``max_period`` samples:
    ``cluster_size`` (the window's slices, one block each) and
    ``max_active_clusters`` (``kb.cluster_query``)."""
    return kb.cluster_query("multicorr", "multicorr_cluster", device, n_taps,
                            code_len, max_period, src_dtype == torch.int8)
