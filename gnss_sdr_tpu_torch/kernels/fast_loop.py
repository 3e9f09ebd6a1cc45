"""K1-loop wrapper: the fast engine's whole tracking program in one launch.

:func:`fast_loop` runs ``n_blocks`` blocks of a planar sample source (the
int8 ring or float32 planes) through every K-period group of every
channel: the group prologue, the bank correlation (with the data tap of a
pilot-tracked channel; for a segsum engine the segmented-sum
correlation, K1-seg, against the raw code tables, with the data prompt
from the prompt tap's chip sums), the secondary wipe-off, the loop closure
(``fllpll``, or the KF / Gaussian steps of K6), C/N0, locks, the packed
per-group records and the block rebase. On the card it launches
``csrc/fast_loop.cu`` once (counted as ``fast_loop`` or, with the
segmented sum, ``fast_loop_seg``); on the CPU it runs the kernel's plain
version, the engine's per-group path
(``FastTrackingEngine._blocks_stepwise``).
The caller's state tensors are read and never written: the kernel writes a
fresh state.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb
from gnss_sdr_tpu_torch.kernels.loops import (GsParams, KfParams, gs_params,
                                              kf_params)
from gnss_sdr_tpu_torch.kernels.scan_loop import f32, inv_f32
from gnss_sdr_tpu_torch.ops.gaussian import step_params
from gnss_sdr_tpu_torch.ops.kalman import _matrices

LOOPS = {"fllpll": 0, "kf": 1, "gaussian": 2}

_INTS = ("n_blocks", "n_groups", "K", "block_samples", "block_stride",
         "total", "win_len", "n_eff", "P1", "W", "cn0_samples", "sec_max_len",
         "t_int", "k_t_int", "loop", "pll_order", "veml", "carrier_aiding",
         "max_code_fail", "max_carr_fail", "seg", "lg", "table_len")
_FLOATS = ("t_frac_nom", "t_nom_over_f0", "half_t_over_f0", "two_pi",
           "inv_two_pi", "inv_fs", "t_group", "k_f32", "k_t_int_f32",
           "fs_over_chip", "aiding", "dll_gain", "cn0_a", "cn0_1ma", "lock_a",
           "lock_1ma", "carrier_lock_th", "cn0_min", "inv_n", "bank_phases",
           "code_step_nom", "cspc_over_fs")
_GAINS = ("w0p2", "w0p3", "w0f", "w0f2", "a2w0f", "a3w0p2", "b3w0p", "a2w0p")


class FllPllGainsF(ctypes.Structure):
    """``struct FllPllGainsF`` of ``csrc/loop_common.cuh``."""

    _fields_ = [(n, ctypes.c_float) for n in _GAINS]


class FastConsts(ctypes.Structure):
    """``struct FastConsts`` of ``csrc/fast_loop.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS]
                + [("dll_ic", ctypes.c_float * 4),
                   ("dll_oc", ctypes.c_float * 3),
                   ("shifts", ctypes.c_float * 5),
                   ("g", FllPllGainsF), ("kf", KfParams), ("gs", GsParams)])


def fast_consts(eng) -> FastConsts:
    """The launch constants of fast engine ``eng`` (``n_blocks``,
    ``block_stride`` and the bank's ``W`` are set per call), float32 as
    the plain path forms them."""
    cfg = eng.cfg
    k = FastConsts()
    k.n_groups, k.K = eng.g, eng.k
    k.block_samples = eng.block_samples
    k.total = eng.block_samples + eng.overlap
    k.win_len, k.n_eff = eng.win_len, eng.n_eff
    k.P1 = eng.BANK_PHASES + 1
    k.cn0_samples = cfg.cn0_samples
    k.sec_max_len = eng.sec_max_len
    k.t_int = eng._t_int
    k.k_t_int = eng.k * eng._t_int
    k.loop = LOOPS[eng.loop]
    k.pll_order = eng._gains.order
    k.veml = int(cfg.veml)
    k.carrier_aiding = int(cfg.carrier_aiding)
    k.max_code_fail = cfg.max_code_lock_fail
    k.max_carr_fail = cfg.max_carrier_lock_fail
    k.t_frac_nom, k.t_nom_over_f0 = eng._t_frac_nom, eng._t_nom_over_f0
    k.half_t_over_f0 = eng._half_t_over_f0
    k.two_pi = f32(2.0 * np.pi)
    k.inv_two_pi = inv_f32(2.0 * np.pi)
    k.inv_fs = inv_f32(eng._fs)
    k.t_group, k.k_f32, k.k_t_int_f32 = eng._t_group, eng._k_f32, \
        eng._k_t_int_f32
    k.fs_over_chip, k.aiding = eng._fs_over_chip, eng._aiding
    k.dll_gain = f32((cfg.y_intercept - cfg.slope * cfg.spc) / cfg.slope)
    k.cn0_a, k.cn0_1ma = eng._cn0_a, eng._cn0_1ma
    k.lock_a, k.lock_1ma = eng._lock_a, eng._lock_1ma
    k.carrier_lock_th = f32(cfg.carrier_lock_th)
    k.cn0_min = f32(cfg.cn0_min)
    k.inv_n = inv_f32(cfg.cn0_samples)
    k.bank_phases = float(eng.BANK_PHASES)
    k.seg = int(eng.correlator == "segsum")
    k.lg, k.table_len = eng.lg, eng.table_len
    k.code_step_nom, k.cspc_over_fs = eng._code_step_nom, eng._cspc_over_fs
    k.dll_ic[:] = eng._dll_ic.cpu().tolist()
    k.dll_oc[:] = eng._dll_oc.cpu().tolist()
    k.shifts[:eng.n_taps] = [f32(v) for v in eng._shifts]
    # fll_pll_step with the gains as Python numbers: each product of two
    # gains is formed in double and rounded once
    g = eng._gains
    k.g = FllPllGainsF(
        f32(g.pll_w0p2), f32(g.pll_w0p3), f32(g.pll_w0f), f32(g.pll_w0f2),
        f32(g.pll_a2 * g.pll_w0f), f32(g.pll_a3 * g.pll_w0p2),
        f32(g.pll_b3 * g.pll_w0p), f32(g.pll_a2 * g.pll_w0p))
    if eng.loop == "kf":
        k.kf = kf_params(*_matrices(eng.kf_cfg, eng._t_loop))
    elif eng.loop == "gaussian":
        k.gs = gs_params(step_params(eng.gs_cfg, eng._t_loop),
                         eng.gs_cfg.order)
    return k


def state_spec(eng) -> dict:
    """Each ``FastState`` field's (dtype, trailing shape) for ``eng``."""
    f, i, b = torch.float32, torch.int32, torch.bool
    n = eng.cfg.cn0_samples
    spec = dict.fromkeys(
        ("active", "offset", "rem_code_phase_samples", "rem_carr_phase_rad",
         "carrier_doppler_hz", "if_freq_hz", "code_doppler_chips", "carr_w",
         "carr_x", "code_x_hist", "code_y_hist", "p_old_re", "p_old_im",
         "prompt_buf_re", "prompt_buf_im", "prompt_count", "cn0_db_hz",
         "carrier_lock_test", "code_lock_fail", "carrier_lock_fail",
         "loss_of_lock", "kf_x", "kf_p", "gs_niw", "sec_signs", "sec_len",
         "sec_phase", "secondary_locked"), (f, ()))
    for name in ("active", "loss_of_lock", "secondary_locked"):
        spec[name] = (b, ())
    for name in ("offset", "prompt_count", "code_lock_fail",
                 "carrier_lock_fail", "sec_len", "sec_phase"):
        spec[name] = (i, ())
    spec.update(code_x_hist=(f, (4,)), code_y_hist=(f, (3,)),
                prompt_buf_re=(f, (n,)), prompt_buf_im=(f, (n,)),
                kf_x=(f, (4,)), kf_p=(f, (4, 4)), gs_niw=(f, (4,)),
                sec_signs=(f, (eng.sec_max_len,)))
    return spec


def check_tables(eng, bank, dev) -> None:
    """Raise unless ``bank`` is what ``eng.get_bank`` gives on ``dev``:
    the code bank [C, P + 1, T (+ 1 data tap), W >= n_eff], or for the
    segmented sum the raw tables [C, 1 (+ 1 data code), table_len];
    contiguous float32."""
    c, t, pilot = eng.n_channels, eng.n_taps, int(eng.track_pilot)
    ok = bank.dtype == torch.float32 and bank.is_contiguous() \
        and bank.device == dev
    if eng.correlator == "segsum":
        if not (ok and tuple(bank.shape) == (c, 1 + pilot, eng.table_len)):
            raise ValueError("fast_loop: contiguous float32 code tables "
                             "[C, 1 (+1), table_len] from get_bank on the "
                             "source's device expected")
    elif not (ok and bank.dim() == 4
              and tuple(bank.shape[:3]) == (c, eng.BANK_PHASES + 1,
                                            t + pilot)
              and bank.shape[3] >= eng.n_eff):
        raise ValueError("fast_loop: contiguous float32 bank [C, P+1, T, W] "
                         "from get_bank on the source's device expected")


def fast_loop(eng, state, src_re, src_im, base: int, block_stride: int,
              n_blocks: int, bank):
    """(new state, packed [n_blocks, G, C, 5K + 4], prompt_re [n_blocks,
    G, C], prompt_im) after ``n_blocks`` blocks of fast engine ``eng``;
    block b reads ``src[base + b * block_stride:][:block_samples +
    overlap]``; ``bank`` from ``eng.get_bank``: the code bank [C, P + 1,
    T (+ 1 data tap), W], or a segsum engine's raw tables [C, 1 (+ 1),
    table_len]."""
    if src_re.device.type == "cpu":
        return eng._blocks_stepwise(state, src_re, src_im, base,
                                    block_stride, n_blocks, bank)
    if src_re.device.type != "cuda":
        raise ValueError(f"fast_loop: unsupported device {src_re.device}")
    dev = src_re.device
    c, t = eng.n_channels, eng.n_taps
    pilot = bool(eng.track_pilot)
    kb.check_planes(src_re, src_im, "fast_loop")
    total = eng.block_samples + eng.overlap
    if base < 0 or n_blocks < 1 or block_stride < 0 \
            or base + (n_blocks - 1) * block_stride + total > src_re.shape[0]:
        raise ValueError("fast_loop: blocks outside the source")
    check_tables(eng, bank, dev)
    if src_re.dtype == torch.int8:
        fn = "fast_loop_i8"
    elif src_re.dtype == torch.float32:
        fn = "fast_loop_f32"
    else:
        raise ValueError(f"fast_loop: unsupported sample type {src_re.dtype}")
    spec = state_spec(eng)
    s_in, keep = kb.state_pointers(state, spec, c, dev, "fast_loop")
    new = type(state)(*(torch.empty_like(x) for x in keep))
    s_out, _ = kb.state_pointers(new, spec, c, dev, "fast_loop")
    k = getattr(eng, "_fast_consts", None)
    if k is None:
        k = eng._fast_consts = fast_consts(eng)
    k.n_blocks, k.block_stride = int(n_blocks), int(block_stride)
    k.W = bank.shape[-1]
    packed = torch.empty((n_blocks, eng.g, c, 5 * eng.k + 4),
                         dtype=torch.float32, device=dev)
    prompt_re = torch.empty((n_blocks, eng.g, c), dtype=torch.float32,
                            device=dev)
    prompt_im = torch.empty_like(prompt_re)
    pt = kb.pointer_struct(tuple(spec))
    f = kb.function("fast_loop", fn, [
        kb.VP, kb.VP, kb.I64, kb.VP, kb.I32, kb.I32, pt, pt, FastConsts,
        kb.VP, kb.VP, kb.VP, kb.I32, kb.VP])
    err = kb.launch(f, dev, src_re.data_ptr(), src_im.data_ptr(), int(base),
                    bank.data_ptr(), t, int(pilot), s_in, s_out, k,
                    packed.data_ptr(), prompt_re.data_ptr(),
                    prompt_im.data_ptr(), c)
    kb.check(err, fn)
    LAUNCHES["fast_loop_seg" if k.seg else "fast_loop"] += 1
    return new, packed, prompt_re, prompt_im


def cluster(eng, src_dtype, device) -> dict:
    """K1-loop's cluster for fast engine ``eng`` on card ``device``
    (samples of ``src_dtype``): ``cluster_size`` (blocks a channel, each
    correlating whole periods of a group) and ``max_active_clusters``
    (``kb.cluster_query``)."""
    return kb.cluster_query("fast_loop", "fast_loop_cluster", device,
                            eng.n_taps, eng.track_pilot,
                            src_dtype == torch.int8,
                            eng.correlator == "segsum", eng.k, eng.table_len)
