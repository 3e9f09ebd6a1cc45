"""K3-loop wrapper: the scan engine's whole tracking program in one launch.

:func:`scan_loop` runs ``n_blocks`` blocks of a planar sample source (the
int8 ring or float32 planes) through every scan step of every channel:
correlation, loops, locks, the packed per-period records and the block
rebase. On the card it launches ``csrc/scan_loop.cu`` once; on the CPU it
runs the kernel's plain version, the engine's per-step path
(``TrackingEngine._blocks_stepwise``: K3's plain correlation and the loop
body in PyTorch). The caller's state tensors are read and never written:
the kernel writes a fresh state.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb

F32 = np.float32


def f32(x) -> float:
    return float(F32(x))


def inv_f32(x) -> float:
    """float32(1) / float32(x): the factor PyTorch's CUDA division by a
    Python number multiplies with."""
    return float(F32(1.0) / F32(x))


_INTS = ("n_blocks", "n_steps", "block_samples", "block_stride", "total",
         "max_period", "code_len", "dcode_len", "n_extra", "n_extra_d",
         "cn0_samples", "k_ext", "pull_in_steps", "t_int", "pll_order", "veml",
         "carrier_aiding", "fll_pull_in", "fll_steady", "max_code_fail",
         "max_carr_fail")
_FLOATS = ("w_w0p", "w_w0p2", "w_w0p3", "w_w0f", "w_w0f2", "n_w0p", "n_w0p2",
           "n_w0p3", "n_w0f", "n_w0f2", "a2", "a3", "b3")
_FLOATS2 = ("dll_gain", "t_nominal", "t_nominal_k", "two_pi", "inv_two_pi",
            "inv_fs", "t_frac_nom", "t_nom_over_f0", "code_step_nom",
            "aiding", "cspc_over_fs", "chip_rate", "cspc", "cn0_a", "cn0_1ma",
            "lock_a", "lock_1ma", "carrier_lock_th", "cn0_min", "inv_n")


class ScanConsts(ctypes.Structure):
    """``struct ScanConsts`` of ``csrc/scan_loop.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in _INTS]
                + [("shifts", ctypes.c_float * 5)]
                + [(n, ctypes.c_float) for n in _FLOATS]
                + [("dll_ic", ctypes.c_float * 4),
                   ("dll_oc", ctypes.c_float * 3),
                   ("dll_ic_n", ctypes.c_float * 4),
                   ("dll_oc_n", ctypes.c_float * 3)]
                + [(n, ctypes.c_float) for n in _FLOATS2])


def scan_consts(eng) -> ScanConsts:
    """The launch constants of scan engine ``eng`` (``n_blocks`` and
    ``block_stride`` are set per call), float32 as the plain path forms
    them."""
    cfg, c = eng.cfg, eng._c
    g, gn = eng._gains, eng._gains_narrow
    k = ScanConsts()
    k.n_steps = eng.n_steps
    k.block_samples = eng.block_samples
    k.total = eng.block_samples + eng.overlap
    k.max_period = eng.max_period
    k.n_extra = eng._n_extra
    k.n_extra_d = eng._n_extra_data
    k.cn0_samples = cfg.cn0_samples
    k.k_ext = eng._k_ext
    k.pull_in_steps = eng._pull_in_steps
    k.t_int = c.t_int
    k.pll_order = g.order
    k.veml = int(cfg.veml)
    k.carrier_aiding = int(cfg.carrier_aiding)
    k.fll_pull_in = int(cfg.enable_fll_pull_in)
    k.fll_steady = int(cfg.enable_fll_steady_state)
    k.max_code_fail = cfg.max_code_lock_fail
    k.max_carr_fail = cfg.max_carrier_lock_fail
    taps = cfg.tap_shifts()
    k.shifts[:len(taps)] = [float(v) for v in taps]
    for pre, gg in (("w_", g), ("n_", gn)):
        for name in ("w0p", "w0p2", "w0p3", "w0f", "w0f2"):
            setattr(k, pre + name, f32(getattr(gg, "pll_" + name)))
    k.a2, k.a3, k.b3 = f32(g.pll_a2), f32(g.pll_a3), f32(g.pll_b3)
    k.dll_ic[:] = eng._dll_ic.cpu().tolist()
    k.dll_oc[:] = eng._dll_oc.cpu().tolist()
    k.dll_ic_n[:] = eng._dll_ic_narrow.cpu().tolist()
    k.dll_oc_n[:] = eng._dll_oc_narrow.cpu().tolist()
    k.dll_gain = f32((cfg.y_intercept - cfg.slope * cfg.spc) / cfg.slope)
    k.t_nominal, k.t_nominal_k = c.t_nominal, c.t_nominal_k
    k.two_pi = f32(2.0 * np.pi)
    k.inv_two_pi = inv_f32(2.0 * np.pi)
    k.inv_fs = inv_f32(c.fs)
    k.t_frac_nom, k.t_nom_over_f0 = c.t_frac_nom, c.t_nom_over_f0
    k.code_step_nom, k.aiding = c.code_step_nom, c.aiding
    k.cspc_over_fs, k.chip_rate, k.cspc = c.cspc_over_fs, c.chip_rate, c.cspc
    k.cn0_a, k.cn0_1ma, k.lock_a, k.lock_1ma = (c.cn0_a, c.cn0_1ma, c.lock_a,
                                                c.lock_1ma)
    k.carrier_lock_th = f32(cfg.carrier_lock_th)
    k.cn0_min = f32(cfg.cn0_min)
    k.inv_n = inv_f32(cfg.cn0_samples)
    return k


def state_spec(eng) -> dict:
    """Each ``TrackState`` field's (dtype, trailing shape) for ``eng``."""
    f, i, b = torch.float32, torch.int32, torch.bool
    t, n = eng.cfg.n_taps, eng.cfg.cn0_samples
    spec = dict.fromkeys(
        ("active", "offset", "cur_len", "rem_code_phase_samples",
         "rem_code_phase_chips", "rem_carr_phase_rad", "carrier_doppler_hz",
         "if_freq_hz", "code_doppler_chips", "carrier_phase_step_rad",
         "code_phase_step_chips", "carr_w", "carr_x", "code_x_hist",
         "code_y_hist", "p_old_re", "p_old_im", "prompt_buf_re",
         "prompt_buf_im", "prompt_count", "cn0_db_hz", "carrier_lock_test",
         "evm", "code_lock_fail", "carrier_lock_fail", "loss_of_lock",
         "step_count", "extended", "secondary_locked", "secondary_signs",
         "accu_count", "accu_re", "accu_im"), (f, ()))
    for name in ("active", "loss_of_lock", "extended", "secondary_locked"):
        spec[name] = (b, ())
    for name in ("offset", "cur_len", "prompt_count", "code_lock_fail",
                 "carrier_lock_fail", "step_count", "accu_count"):
        spec[name] = (i, ())
    spec.update(code_x_hist=(f, (4,)), code_y_hist=(f, (3,)),
                prompt_buf_re=(f, (n,)), prompt_buf_im=(f, (n,)),
                secondary_signs=(f, (eng._k_ext,)), accu_re=(f, (t,)),
                accu_im=(f, (t,)))
    return spec


def scan_loop(eng, state, src_re, src_im, base: int, block_stride: int,
              n_blocks: int, code_tables, data_code_tables=None):
    """(new state, packed [n_blocks, S, C, 15 + 2T]) after ``n_blocks``
    blocks of scan engine ``eng``; block b reads ``src[base + b *
    block_stride:][:block_samples + overlap]``. With ``cfg.track_pilot``
    ``data_code_tables`` [C, L] give the data-component prompt."""
    if src_re.device.type == "cpu":
        return eng._blocks_stepwise(state, src_re, src_im, base,
                                    block_stride, n_blocks, code_tables,
                                    data_code_tables)
    if src_re.device.type != "cuda":
        raise ValueError(f"scan_loop: unsupported device {src_re.device}")
    dev = src_re.device
    c, t = eng.n_channels, eng.cfg.n_taps
    kb.check_planes(src_re, src_im, "scan_loop")
    total = eng.block_samples + eng.overlap
    if base < 0 or n_blocks < 1 or block_stride < 0 \
            or base + (n_blocks - 1) * block_stride + total > src_re.shape[0]:
        raise ValueError("scan_loop: blocks outside the source")
    pilot = bool(eng.cfg.track_pilot)
    tables = [code_tables] + ([data_code_tables] if pilot else [])
    for tb in tables:
        if tb is None or tb.dtype != torch.float32 or tb.dim() != 2 \
                or tb.shape[0] != c or not tb.is_contiguous() \
                or tb.device != dev:
            raise ValueError("scan_loop: contiguous float32 [C, L] code "
                             "tables on the source's device expected")
    if src_re.dtype == torch.int8:
        fn = "scan_loop_i8"
    elif src_re.dtype == torch.float32:
        fn = "scan_loop_f32"
    else:
        raise ValueError(f"scan_loop: unsupported sample type {src_re.dtype}")
    spec = state_spec(eng)
    s_in, keep = kb.state_pointers(state, spec, c, dev, "scan_loop")
    new = type(state)(*(torch.empty_like(x) for x in keep))
    s_out, _ = kb.state_pointers(new, spec, c, dev, "scan_loop")
    k = getattr(eng, "_scan_consts", None)
    if k is None:
        k = eng._scan_consts = scan_consts(eng)
    k.n_blocks, k.block_stride = int(n_blocks), int(block_stride)
    k.code_len = code_tables.shape[1]
    k.dcode_len = data_code_tables.shape[1] if pilot else 0
    packed = torch.empty((n_blocks, eng.n_steps, c, 15 + 2 * t),
                         dtype=torch.float32, device=dev)
    pt = kb.pointer_struct(tuple(spec))
    f = kb.function("scan_loop", fn, [
        kb.VP, kb.VP, kb.I64, kb.VP, kb.VP, kb.I32, kb.I32, pt, pt,
        ScanConsts, kb.VP, kb.I32, kb.VP])
    err = kb.launch(f, dev, src_re.data_ptr(), src_im.data_ptr(), int(base),
                    code_tables.data_ptr(),
                    data_code_tables.data_ptr() if pilot else None, t,
                    int(pilot), s_in, s_out, k, packed.data_ptr(), c)
    kb.check(err, fn)
    LAUNCHES["scan_loop"] += 1
    return new, packed


def cluster(eng, code_len: int, src_dtype, device) -> dict:
    """K3-loop's cluster for scan engine ``eng`` on card ``device`` (code
    tables of ``code_len`` entries, samples of ``src_dtype``):
    ``cluster_size`` (K3's slices of a ``max_period`` window, one block
    each) and ``max_active_clusters`` (``kb.cluster_query``)."""
    return kb.cluster_query("scan_loop", "scan_loop_cluster", device,
                            eng.cfg.n_taps, eng.cfg.track_pilot,
                            src_dtype == torch.int8, code_len,
                            eng.max_period)
