"""K1 wrapper: the fast engine's code-bank group correlator.

:func:`bank_corr` correlates each channel's K period windows of a planar
sample source against the two code-bank rows bracketing each period's
remnant code phase and interpolates between them. On the card it
launches ``csrc/bank_corr.cu``; on the CPU it runs
:func:`bank_corr_plain`, the same arithmetic in PyTorch (the bank branch
of ``gnss_sdr_tpu/tracking/fast_engine.py::group_body``, restricted to
the two rows it uses).
"""

from __future__ import annotations

import torch

from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb

_ARGTYPES = [kb.VP, kb.VP, kb.I64, kb.VP, kb.VP, kb.VP, kb.VP, kb.VP,
             kb.VP, kb.I32, kb.I32, kb.I32, kb.I32, kb.I32, kb.I32, kb.VP,
             kb.VP, kb.VP]


def bank_corr_plain(src_re, src_im, base, win_start, ph0, step, bank, j0, w,
                    n_eff: int):
    c, k = win_start.shape
    dev = src_re.device
    idx = (base + win_start.to(torch.int64))[..., None] \
        + torch.arange(n_eff, device=dev)                      # [C,K,n]
    x_re = src_re[idx].to(torch.float32)
    x_im = src_im[idx].to(torch.float32)
    n = torch.arange(n_eff, dtype=torch.float32, device=dev)
    phase = ph0[:, :, None] + step[:, None, None] * n[None, None]
    cs = torch.cos(phase)
    sn = torch.sin(phase)
    rot_re = x_re * cs + x_im * sn                             # [C,K,n]
    rot_im = x_im * cs - x_re * sn
    cc = torch.arange(c, device=dev)[:, None]
    j0l = j0.to(torch.int64)
    b0 = bank[cc, j0l][..., :n_eff]                            # [C,K,T,n]
    b1 = bank[cc, j0l + 1][..., :n_eff]

    def contract(b):
        return (torch.sum(rot_re[:, :, None, :] * b, dim=-1),
                torch.sum(rot_im[:, :, None, :] * b, dim=-1))

    a0r, a0i = contract(b0)
    a1r, a1i = contract(b1)
    wt = w[..., None]
    return (1.0 - wt) * a0r + wt * a1r, (1.0 - wt) * a0i + wt * a1i


def bank_corr(src_re, src_im, base: int, win_start, ph0, step, bank, j0, w,
              n_eff: int):
    """Interpolated correlations ``([C, K, T] re, [C, K, T] im)``.

    ``src_re``/``src_im``: 1-D planes (int8 ring or float32 block);
    ``win_start`` int32 [C, K] window starts relative to ``base``;
    ``ph0`` float32 [C, K] carrier phase at each window start; ``step``
    float32 [C]; ``bank`` float32 [C, P+1, T, W]; ``j0`` int32 [C, K] in
    [0, P-1] and ``w`` float32 [C, K] the interpolation row and weight;
    ``n_eff`` <= W the bank's support (columns past it are zero). Every
    window must lie inside the planes (``0 <= win_start`` and ``base +
    win_start + n_eff <= len``); the fast engine clamps its window starts
    to that range."""
    if src_re.device.type == "cpu":
        return bank_corr_plain(src_re, src_im, base, win_start, ph0, step,
                               bank, j0, w, n_eff)
    if src_re.device.type != "cuda":
        raise ValueError(f"bank_corr: unsupported device {src_re.device}")
    c, p1, t, width = bank.shape
    k = win_start.shape[1]
    if not 0 < n_eff <= width:
        raise ValueError("bank_corr: n_eff outside the bank width")
    kb.check_planes(src_re, src_im, "bank_corr")
    if base < 0 or base + n_eff > src_re.shape[0]:
        raise ValueError("bank_corr: window base outside the source")
    if step.shape != (c,) or ph0.shape != (c, k) or w.shape != (c, k):
        raise ValueError("bank_corr: step [C], ph0 and w [C, K] expected")
    for a in (ph0, step, bank, w):
        if a.dtype != torch.float32 or not a.is_contiguous() \
                or a.device != src_re.device:
            raise ValueError("bank_corr: contiguous float32 on the source's "
                             "device expected")
    for a in (win_start, j0):
        if a.dtype != torch.int32 or a.shape != (c, k) \
                or not a.is_contiguous() or a.device != src_re.device:
            raise ValueError("bank_corr: contiguous int32 [C, K] expected")
    if src_re.dtype == torch.int8:
        fn = "bank_corr_i8"
    elif src_re.dtype == torch.float32:
        fn = "bank_corr_f32"
    else:
        raise ValueError(f"bank_corr: unsupported sample type {src_re.dtype}")
    f = kb.function("bank_corr", fn, _ARGTYPES)
    out_re = torch.empty((c, k, t), dtype=torch.float32, device=src_re.device)
    out_im = torch.empty_like(out_re)
    err = kb.launch(f, src_re.device, src_re.data_ptr(), src_im.data_ptr(),
                    int(base), win_start.data_ptr(), ph0.data_ptr(),
                    step.data_ptr(), bank.data_ptr(), j0.data_ptr(),
                    w.data_ptr(), c, k, p1, t, width, int(n_eff),
                    out_re.data_ptr(), out_im.data_ptr())
    kb.check(err, fn)
    LAUNCHES["bank_corr"] += 1
    return out_re, out_im
