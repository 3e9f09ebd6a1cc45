"""Multi-channel DLL/PLL/FLL tracking engine (the scan engine).

Port of ``gnss_sdr_tpu/tracking/engine.py``: all channels advance in
lockstep through the PRN periods of a fixed sample block, one scan step
per period, with per-channel period lengths handled by a static maximum
length and a valid-prefix mask; channels whose next period starts past
the block's main region idle and resume in the next overlapped block.

On the card every call of ``process_block``, ``superblock_step`` and
``superblock_ring_i8`` is one launch of K3-loop (``kernels/scan_loop.py``),
which walks all blocks and steps of the call with the loop state on the
card. Its plain version is :meth:`TrackingEngine._blocks_stepwise`, the
only path on the CPU and the kernel's oracle on the card (never a
fallback): each step is one K3 correlation (``kernels/multicorr.py``; the
segmented-sum oracle on the CPU), a second one at zero shift on the
data-component codes when the loops track a pilot (``track_pilot``), and
the loop body in PyTorch (:meth:`TrackingEngine._step`): extended
accumulation, FLL pull-in, wide and narrow gains, the DLL IIR, C/N0, lock
tests, EVM and the packed per-period record. Neither path makes a
device-to-host read; the host reads one packed record per call.

Absolute 64-bit sample and phase bookkeeping stays on the host
(:class:`TrackingChannels`); the device carries block-relative int32
offsets and per-period float32 increments.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import NamedTuple

import numpy as np
import torch

from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.kernels.multicorr import multicorr
from gnss_sdr_tpu_torch.kernels.scan_loop import scan_loop
from gnss_sdr_tpu_torch.ops import discriminators as disc
from gnss_sdr_tpu_torch.ops import lock_detectors as lockdet
from gnss_sdr_tpu_torch.ops import loop_filters as lf
from gnss_sdr_tpu_torch.ops.correlator import n_extra_bins

TWO_PI = 2.0 * math.pi
F32 = np.float32
#: 2*pi rounded to float32, as the JAX package's ``jnp.float32(TWO_PI)``
TWO_PI_F32 = float(F32(TWO_PI))
TINY = float(np.finfo(np.float32).tiny)


def f32(x) -> float:
    """``x`` rounded to float32 (a Python float holding an f32 value)."""
    return float(F32(x))


@dataclasses.dataclass
class TrackingConfig:
    """Tracking knobs + per-signal constants.

    Field-for-field analogue of ``Dll_Pll_Conf``
    (gnss-sdr/src/algorithms/tracking/libs/dll_pll_conf.h:40-83)
    plus the signal constants the reference engine pulls from its ctor.
    Defaults mirror the reference's (header initializers and gflags
    defaults, gnss_sdr_flags.cc:45-54).
    """

    fs: float = 2_000_000.0
    # signal constants
    code_length_chips: int = 1023
    chip_rate_cps: float = 1.023e6
    carrier_hz: float = 1575.42e6
    code_samples_per_chip: int = 1
    symbols_per_bit: int = 20
    # loop configuration
    pll_bw_hz: float = 35.0
    dll_bw_hz: float = 2.0
    fll_bw_hz: float = 35.0
    pll_filter_order: int = 3
    dll_filter_order: int = 2
    enable_fll_pull_in: bool = False
    enable_fll_steady_state: bool = False
    pull_in_time_s: float = 10.0
    early_late_space_chips: float = 0.25
    very_early_late_space_chips: float = 0.5
    veml: bool = False
    slope: float = 1.0
    spc: float = 0.5
    y_intercept: float = 1.0
    carrier_aiding: bool = True
    extend_correlation_symbols: int = 1
    # dual-component (pilot + data) signals: loops close on the pilot code
    # (the main code_tables); an extra prompt correlator runs against the
    # data component's code (the reference's d_correlator_data /
    # track_pilot path, dll_pll_veml_tracking.cc:211-246 and :1064-1090)
    track_pilot: bool = False
    pll_bw_narrow_hz: float = 5.0
    dll_bw_narrow_hz: float = 0.75
    # lock detection
    cn0_samples: int = 20
    cn0_min: float = 25.0
    max_code_lock_fail: int = 50
    max_carrier_lock_fail: int = 5000
    carrier_lock_th: float = 0.7
    cn0_smoother_alpha: float = 0.002
    carrier_lock_test_smoother_alpha: float = 0.002

    @property
    def samples_per_code(self) -> int:
        return int(round(self.fs * self.code_length_chips / self.chip_rate_cps))

    @property
    def code_period_s(self) -> float:
        return self.code_length_chips / self.chip_rate_cps

    @property
    def n_taps(self) -> int:
        return 5 if self.veml else 3

    def tap_shifts(self) -> np.ndarray:
        """Correlator tap shifts in code-table units, VE..VL order
        (dll_pll_veml_tracking.cc ctor, d_local_code_shift_chips)."""
        spc = self.early_late_space_chips * self.code_samples_per_chip
        if self.veml:
            vspc = self.very_early_late_space_chips * self.code_samples_per_chip
            return np.array([-vspc, -spc, 0.0, spc, vspc], dtype=np.float32)
        return np.array([-spc, 0.0, spc], dtype=np.float32)



class TrackState(NamedTuple):
    """Per-channel tracking carry; every field has leading dim [C].

    Fields, types and meanings as ``gnss_sdr_tpu.tracking.engine
    .TrackState``. Updates are functional: a step returns new tensors and
    never writes into a tensor the caller still holds."""

    active: torch.Tensor              # bool
    offset: torch.Tensor              # int32 block-relative next start
    cur_len: torch.Tensor             # int32 current period length
    rem_code_phase_samples: torch.Tensor
    rem_code_phase_chips: torch.Tensor
    rem_carr_phase_rad: torch.Tensor
    carrier_doppler_hz: torch.Tensor
    if_freq_hz: torch.Tensor
    code_doppler_chips: torch.Tensor  # code freq minus nominal chip rate
    carrier_phase_step_rad: torch.Tensor
    code_phase_step_chips: torch.Tensor
    carr_w: torch.Tensor
    carr_x: torch.Tensor
    code_x_hist: torch.Tensor         # [C, 4]
    code_y_hist: torch.Tensor         # [C, 3]
    p_old_re: torch.Tensor
    p_old_im: torch.Tensor
    prompt_buf_re: torch.Tensor       # [C, cn0_samples], newest first
    prompt_buf_im: torch.Tensor
    prompt_count: torch.Tensor        # int32
    cn0_db_hz: torch.Tensor
    carrier_lock_test: torch.Tensor
    evm: torch.Tensor
    code_lock_fail: torch.Tensor      # int32
    carrier_lock_fail: torch.Tensor   # int32
    loss_of_lock: torch.Tensor        # bool
    step_count: torch.Tensor          # int32
    extended: torch.Tensor            # bool
    secondary_locked: torch.Tensor    # bool
    secondary_signs: torch.Tensor     # f32 [C, K]
    accu_count: torch.Tensor          # int32
    accu_re: torch.Tensor             # f32 [C, T]
    accu_im: torch.Tensor             # f32 [C, T]


def set_channel(t: torch.Tensor, ch: int, value) -> torch.Tensor:
    """Copy of ``t`` with row ``ch`` set to ``value``."""
    out = t.clone()
    out[ch] = value
    return out


#: packed per-period record width for T taps (layout at ``_step``)
def packed_width(n_taps: int) -> int:
    return 15 + 2 * n_taps


class TrackingEngine:
    """Per-block tracking program over ``n_channels`` channels.

    ``block_samples`` is the stream advance per call; input blocks carry
    ``overlap`` extra trailing samples (>= max period length) so a period
    straddling the block edge is fully contained."""

    def __init__(self, cfg: TrackingConfig, n_channels: int,
                 block_samples: int, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_channels = n_channels
        self.block_samples = int(block_samples)
        spc = cfg.samples_per_code
        self.max_period = spc + 16
        self.overlap = self.max_period
        self.n_steps = self.block_samples // max(1, spc - 16) + 1
        dev = self.device
        taps = cfg.tap_shifts()
        self._shifts = torch.as_tensor(taps, device=dev)
        self._n_extra = n_extra_bins(taps.tolist())
        # the data-component prompt: one tap at zero shift
        self._zero_shift = torch.zeros((1,), dtype=torch.float32, device=dev)
        self._n_extra_data = n_extra_bins([0.0])
        self._gains = lf.FllPllGains.make(
            cfg.fll_bw_hz, cfg.pll_bw_hz, cfg.pll_filter_order)
        self._gains_narrow = lf.FllPllGains.make(
            cfg.fll_bw_hz, cfg.pll_bw_narrow_hz, cfg.pll_filter_order)
        ic, oc = lf.loop_filter_coefficients(
            cfg.code_period_s, cfg.dll_bw_hz, cfg.dll_filter_order,
            include_last_integrator=False)
        ic_n, oc_n = lf.loop_filter_coefficients(
            cfg.code_period_s * cfg.extend_correlation_symbols,
            cfg.dll_bw_narrow_hz, cfg.dll_filter_order,
            include_last_integrator=False)
        self._dll_ic = torch.as_tensor(ic, device=dev)
        self._dll_oc = torch.as_tensor(oc, device=dev)
        self._dll_ic_narrow = torch.as_tensor(ic_n, device=dev)
        self._dll_oc_narrow = torch.as_tensor(oc_n, device=dev)
        self._pull_in_steps = int(cfg.pull_in_time_s / cfg.code_period_s)
        self._k_ext = max(1, cfg.extend_correlation_symbols)
        # float32 constants exactly as the JAX program forms them
        t_nom_f64 = cfg.code_length_chips * cfg.fs / cfg.chip_rate_cps
        self._c = types.SimpleNamespace(
            fs=f32(cfg.fs),
            chip_rate=f32(cfg.chip_rate_cps),
            cspc=f32(cfg.code_samples_per_chip),
            t_nominal=f32(cfg.code_period_s),
            t_nominal_k=f32(F32(cfg.code_period_s) * F32(self._k_ext)),
            t_int=int(math.floor(t_nom_f64)),
            t_frac_nom=f32(t_nom_f64 - math.floor(t_nom_f64)),
            t_nom_over_f0=f32(t_nom_f64 / cfg.chip_rate_cps),
            code_step_nom=f32(cfg.chip_rate_cps / cfg.fs
                              * cfg.code_samples_per_chip),
            aiding=f32(F32(cfg.chip_rate_cps) / F32(cfg.carrier_hz)),
            cspc_over_fs=f32(F32(cfg.code_samples_per_chip) / F32(cfg.fs)),
            cn0_a=f32(cfg.cn0_smoother_alpha),
            cn0_1ma=f32(F32(1.0) - F32(cfg.cn0_smoother_alpha)),
            lock_a=f32(cfg.carrier_lock_test_smoother_alpha),
            lock_1ma=f32(F32(1.0) - F32(cfg.carrier_lock_test_smoother_alpha)),
        )

    # -- state construction ------------------------------------------------
    def init_state(self) -> TrackState:
        c, dev, cfg = self.n_channels, self.device, self.cfg

        def z(*shape, dtype=torch.float32):
            return torch.zeros((c,) + shape, dtype=dtype, device=dev)

        i32 = torch.int32
        return TrackState(
            active=z(dtype=torch.bool), offset=z(dtype=i32),
            cur_len=torch.full((c,), cfg.samples_per_code, dtype=i32,
                               device=dev),
            rem_code_phase_samples=z(), rem_code_phase_chips=z(),
            rem_carr_phase_rad=z(), carrier_doppler_hz=z(), if_freq_hz=z(),
            code_doppler_chips=z(), carrier_phase_step_rad=z(),
            code_phase_step_chips=torch.full(
                (c,), cfg.chip_rate_cps / cfg.fs * cfg.code_samples_per_chip,
                dtype=torch.float32, device=dev),
            carr_w=z(), carr_x=z(),
            code_x_hist=z(lf.HISTORY), code_y_hist=z(lf.HISTORY - 1),
            p_old_re=z(), p_old_im=z(),
            prompt_buf_re=z(cfg.cn0_samples), prompt_buf_im=z(cfg.cn0_samples),
            prompt_count=z(dtype=i32), cn0_db_hz=z(), carrier_lock_test=z(),
            evm=z(), code_lock_fail=z(dtype=i32),
            carrier_lock_fail=z(dtype=i32), loss_of_lock=z(dtype=torch.bool),
            step_count=z(dtype=i32), extended=z(dtype=torch.bool),
            secondary_locked=z(dtype=torch.bool),
            secondary_signs=torch.ones((c, self._k_ext), dtype=torch.float32,
                                       device=dev),
            accu_count=z(dtype=i32),
            accu_re=z(cfg.n_taps), accu_im=z(cfg.n_taps),
        )

    def start_channel(self, state: TrackState, ch: int, doppler_hz: float,
                      offset_samples: int, cur_len: int,
                      if_freq_hz: float = 0.0) -> TrackState:
        """Per-channel (re)start after acquisition handoff (gnss-sdr
        dll_pll_veml_tracking.cc:1813-1844): acquisition Doppler, nominal
        code frequency, zero remnant phases, loops initialized from the
        Doppler."""
        cfg = self.cfg
        d = f32(doppler_hz)
        if self._gains.order == 3:
            w0, x0 = 0.0, f32(2.0 * F32(d))
        else:
            w0, x0 = d, 0.0
        fs = self._c.fs
        step = f32(F32(TWO_PI) * (F32(d) + F32(if_freq_hz)) / F32(fs))
        s = state
        return s._replace(
            active=set_channel(s.active, ch, True),
            offset=set_channel(s.offset, ch, int(offset_samples)),
            cur_len=set_channel(s.cur_len, ch, int(cur_len)),
            rem_code_phase_samples=set_channel(s.rem_code_phase_samples, ch, 0.0),
            rem_code_phase_chips=set_channel(s.rem_code_phase_chips, ch, 0.0),
            rem_carr_phase_rad=set_channel(s.rem_carr_phase_rad, ch, 0.0),
            carrier_doppler_hz=set_channel(s.carrier_doppler_hz, ch, d),
            if_freq_hz=set_channel(s.if_freq_hz, ch, f32(if_freq_hz)),
            code_doppler_chips=set_channel(s.code_doppler_chips, ch, 0.0),
            carrier_phase_step_rad=set_channel(s.carrier_phase_step_rad, ch,
                                               step),
            code_phase_step_chips=set_channel(
                s.code_phase_step_chips, ch,
                f32(cfg.chip_rate_cps / cfg.fs * cfg.code_samples_per_chip)),
            carr_w=set_channel(s.carr_w, ch, w0),
            carr_x=set_channel(s.carr_x, ch, x0),
            code_x_hist=set_channel(s.code_x_hist, ch, 0.0),
            code_y_hist=set_channel(s.code_y_hist, ch, 0.0),
            p_old_re=set_channel(s.p_old_re, ch, 0.0),
            p_old_im=set_channel(s.p_old_im, ch, 0.0),
            prompt_buf_re=set_channel(s.prompt_buf_re, ch, 0.0),
            prompt_buf_im=set_channel(s.prompt_buf_im, ch, 0.0),
            prompt_count=set_channel(s.prompt_count, ch, 0),
            cn0_db_hz=set_channel(s.cn0_db_hz, ch, 0.0),
            carrier_lock_test=set_channel(s.carrier_lock_test, ch, 0.0),
            evm=set_channel(s.evm, ch, 0.0),
            code_lock_fail=set_channel(s.code_lock_fail, ch, 0),
            carrier_lock_fail=set_channel(s.carrier_lock_fail, ch, 0),
            loss_of_lock=set_channel(s.loss_of_lock, ch, False),
            step_count=set_channel(s.step_count, ch, 0),
            extended=set_channel(s.extended, ch, False),
            secondary_locked=set_channel(s.secondary_locked, ch, False),
            secondary_signs=set_channel(s.secondary_signs, ch, 1.0),
            accu_count=set_channel(s.accu_count, ch, 0),
            accu_re=set_channel(s.accu_re, ch, 0.0),
            accu_im=set_channel(s.accu_im, ch, 0.0),
        )

    def stop_channel(self, state: TrackState, ch: int) -> TrackState:
        return state._replace(active=set_channel(state.active, ch, False))

    def set_extended(self, state: TrackState, ch: int,
                     periods_into_group: int = 0,
                     secondary_code: str | None = None) -> TrackState:
        """Switch a channel into extended coherent integration (gnss-sdr
        state 2 -> 3, dll_pll_veml_tracking.cc:1845-2028). The carrier
        filter restarts from the current Doppler; ``secondary_code``
        ("0"/"1", length K) enables secondary wipe-off and the
        four-quadrant PLL."""
        doppler = state.carrier_doppler_hz[ch]
        if self._gains_narrow.order == 3:
            w0 = torch.zeros((), dtype=torch.float32, device=self.device)
            x0 = 2.0 * doppler
        else:
            w0 = doppler
            x0 = torch.zeros((), dtype=torch.float32, device=self.device)
        state = state._replace(
            extended=set_channel(state.extended, ch, True),
            accu_count=set_channel(state.accu_count, ch,
                                   int(periods_into_group)),
            accu_re=set_channel(state.accu_re, ch, 0.0),
            accu_im=set_channel(state.accu_im, ch, 0.0),
            carr_w=set_channel(state.carr_w, ch, w0),
            carr_x=set_channel(state.carr_x, ch, x0),
        )
        if secondary_code is not None:
            signs = np.asarray(
                [1.0 if c in "0+" else -1.0 for c in secondary_code],
                dtype=np.float32)
            k = state.secondary_signs.shape[1]
            if signs.shape[0] != k:
                raise ValueError(
                    f"secondary code length {signs.shape[0]} != K={k}")
            state = state._replace(
                secondary_signs=set_channel(
                    state.secondary_signs, ch,
                    torch.as_tensor(signs, device=self.device)),
                secondary_locked=set_channel(state.secondary_locked, ch,
                                             True),
            )
        return state

    # -- the per-period step ------------------------------------------------
    def window_start(self, s: TrackState):
        """int32 [C] block-relative start of each channel's K3 window."""
        total = self.block_samples + self.overlap
        return torch.clamp(s.offset, 0, total - self.max_period)

    def _step(self, s: TrackState, src_re, src_im, base: int, code_tables,
              data_code_tables=None):
        """One scan step: K3 correlation + loop body for all channels.
        Returns (new state, packed record [C, 15 + 2T])."""
        cfg, k = self.cfg, self._c
        k_ext = self._k_ext
        prompt_tap = cfg.n_taps // 2
        process = s.active & (s.offset < self.block_samples) & ~s.loss_of_lock
        start = self.window_start(s)
        corr_re, corr_im = multicorr(
            src_re, src_im, base, start, s.cur_len, code_tables,
            self._shifts, s.rem_code_phase_chips, s.code_phase_step_chips,
            s.rem_carr_phase_rad, s.carrier_phase_step_rad, self.max_period,
            self._n_extra)
        p_re = corr_re[:, prompt_tap]
        p_im = corr_im[:, prompt_tap]
        if cfg.track_pilot:
            # data-component prompt (d_correlator_data role): the same
            # windows and NCO trajectory, the data PRN code, one tap; a
            # second K3 launch, since the two sub-chip tables of E1 do not
            # fit one block's shared memory together
            dp_re, dp_im = multicorr(
                src_re, src_im, base, start, s.cur_len, data_code_tables,
                self._zero_shift, s.rem_code_phase_chips,
                s.code_phase_step_chips, s.rem_carr_phase_rad,
                s.carrier_phase_step_rad, self.max_period,
                self._n_extra_data)
            data_p_re, data_p_im = dp_re[:, 0], dp_im[:, 0]
        else:
            data_p_re, data_p_im = p_re, p_im

        # ---- extended coherent integration (states 3/4) ----------------
        sign = torch.gather(
            s.secondary_signs, 1,
            torch.clamp(s.accu_count, 0, k_ext - 1).to(torch.int64)[:, None]
        )[:, 0]
        accu_re = s.accu_re + sign[:, None] * corr_re
        accu_im = s.accu_im + sign[:, None] * corr_im
        accu_count = s.accu_count + 1
        run_loops = ~s.extended | (accu_count >= k_ext)
        ext = s.extended
        eff_re = torch.where(ext[:, None], accu_re, corr_re)
        eff_im = torch.where(ext[:, None], accu_im, corr_im)
        ep_re = eff_re[:, prompt_tap]
        ep_im = eff_im[:, prompt_tap]
        t_eff = torch.where(ext, k.t_nominal_k, k.t_nominal)

        # ---- run_dll_pll (dll_pll_veml_tracking.cc:1092-1213) ----------
        pll_costas = disc.pll_cloop_two_quadrant_atan(ep_re, ep_im)
        pll_4q = disc.pll_four_quadrant_atan(ep_re, ep_im)
        pll_disc_hz = torch.where(s.secondary_locked, pll_4q,
                                  pll_costas) / TWO_PI
        fll_disc_hz = disc.fll_diff_atan(
            s.p_old_re, s.p_old_im, ep_re, ep_im, 0.0, t_eff) / TWO_PI
        pull_in = s.step_count < self._pull_in_steps
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.enable_fll_pull_in or cfg.enable_fll_steady_state:
            use_fll = (pull_in & cfg.enable_fll_pull_in) \
                | cfg.enable_fll_steady_state
            fll_eff = torch.where(use_fll, fll_disc_hz, zero)
            pll_eff = torch.where(pull_in & cfg.enable_fll_pull_in, zero,
                                  pll_disc_hz)
        else:
            fll_eff = torch.zeros_like(fll_disc_hz)
            pll_eff = pll_disc_hz
        g, gn = self._gains, self._gains_narrow
        g_eff = types.SimpleNamespace(
            order=g.order,
            pll_w0p=torch.where(ext, gn.pll_w0p, g.pll_w0p),
            pll_w0p2=torch.where(ext, gn.pll_w0p2, g.pll_w0p2),
            pll_w0p3=torch.where(ext, gn.pll_w0p3, g.pll_w0p3),
            pll_w0f=torch.where(ext, gn.pll_w0f, g.pll_w0f),
            pll_w0f2=torch.where(ext, gn.pll_w0f2, g.pll_w0f2),
            pll_a2=g.pll_a2, pll_a3=g.pll_a3, pll_b3=g.pll_b3,
        )
        (carr_w_new, carr_x_new), carr_err_hz = lf.fll_pll_step(
            (s.carr_w, s.carr_x), fll_eff, pll_eff, t_eff, g_eff)
        carr_w = torch.where(run_loops, carr_w_new, s.carr_w)
        carr_x = torch.where(run_loops, carr_x_new, s.carr_x)
        carrier_doppler = torch.where(run_loops, carr_err_hz,
                                      s.carrier_doppler_hz)

        if cfg.veml:
            dll_disc = disc.dll_nc_vemlp_normalized(
                eff_re[:, 0], eff_im[:, 0], eff_re[:, 1], eff_im[:, 1],
                eff_re[:, 3], eff_im[:, 3], eff_re[:, 4], eff_im[:, 4])
        else:
            dll_disc = disc.dll_nc_e_minus_l_normalized(
                eff_re[:, 0], eff_im[:, 0], eff_re[:, 2], eff_im[:, 2],
                cfg.spc, cfg.slope, cfg.y_intercept)
        ic_eff = torch.where(ext[:, None], self._dll_ic_narrow, self._dll_ic)
        oc_eff = torch.where(ext[:, None], self._dll_oc_narrow, self._dll_oc)
        (code_x_new, code_y_new), code_err_filt = lf.iir_step(
            (s.code_x_hist, s.code_y_hist), dll_disc, ic_eff, oc_eff)
        code_x_hist = torch.where(run_loops[:, None], code_x_new,
                                  s.code_x_hist)
        code_y_hist = torch.where(run_loops[:, None], code_y_new,
                                  s.code_y_hist)
        code_dop_new = -code_err_filt
        if cfg.carrier_aiding:
            code_dop_new = code_dop_new + carrier_doppler * k.aiding
        code_dop = torch.where(run_loops, code_dop_new, s.code_doppler_chips)
        clear = run_loops & ext
        accu_re = torch.where(clear[:, None], zero, accu_re)
        accu_im = torch.where(clear[:, None], zero, accu_im)
        accu_count = torch.where(run_loops, torch.zeros_like(accu_count),
                                 accu_count)

        # ---- update_tracking_vars (:1216-1288), int + small fraction ---
        t_frac = k.t_frac_nom - code_dop * k.t_nom_over_f0
        kfrac = t_frac + s.rem_code_phase_samples
        dlen = torch.floor(kfrac)
        next_len = k.t_int + dlen.to(torch.int32)
        rem_code_samples = kfrac - dlen
        carr_step = TWO_PI_F32 * (carrier_doppler + s.if_freq_hz) / k.fs
        next_len_f = next_len.to(torch.float32)
        carr_incr = carr_step * next_len_f
        carr_incr_out = TWO_PI_F32 * carrier_doppler / k.fs * next_len_f
        rem_carr = torch.remainder(s.rem_carr_phase_rad + carr_incr,
                                   TWO_PI_F32)
        code_step = k.code_step_nom + code_dop * k.cspc_over_fs
        rem_code_chips = (k.chip_rate + code_dop) * rem_code_samples \
            / k.fs * k.cspc

        # ---- cn0_and_tracking_lock_status (:970-1062) ------------------
        rl = run_loops[:, None]
        prompt_buf_re = torch.where(
            rl, torch.cat([ep_re[:, None], s.prompt_buf_re[:, :-1]], 1),
            s.prompt_buf_re)
        prompt_buf_im = torch.where(
            rl, torch.cat([ep_im[:, None], s.prompt_buf_im[:, :-1]], 1),
            s.prompt_buf_im)
        count_pre = s.prompt_count
        have_cn0 = count_pre >= cfg.cn0_samples
        first_cn0 = count_pre == cfg.cn0_samples
        prompt_count = torch.clamp(count_pre + run_loops.to(torch.int32),
                                   max=cfg.cn0_samples + 1)
        cn0_raw = lockdet.cn0_m2m4_estimator(prompt_buf_re, prompt_buf_im,
                                             t_eff)
        upd = have_cn0 & run_loops
        cn0_s = torch.where(
            upd, torch.where(first_cn0, cn0_raw,
                             k.cn0_a * cn0_raw + k.cn0_1ma * s.cn0_db_hz),
            s.cn0_db_hz)
        lock_raw = lockdet.carrier_lock_detector(ep_re[:, None],
                                                 ep_im[:, None])
        lock_s = torch.where(
            upd, torch.where(first_cn0, lock_raw,
                             k.lock_a * lock_raw
                             + k.lock_1ma * s.carrier_lock_test),
            s.carrier_lock_test)
        count_locks = have_cn0 & ~pull_in & run_loops
        cl_i = count_locks.to(torch.int32)
        carrier_fail = torch.where(
            count_locks & (lock_s < cfg.carrier_lock_th),
            s.carrier_lock_fail + 1,
            torch.clamp(s.carrier_lock_fail - cl_i, min=0))
        code_fail = torch.where(
            count_locks & (cn0_s < cfg.cn0_min),
            s.code_lock_fail + 1,
            torch.clamp(s.code_lock_fail - cl_i, min=0))
        loss = (carrier_fail > cfg.max_carrier_lock_fail) \
            | (code_fail > cfg.max_code_lock_fail)
        carrier_fail = torch.where(loss, torch.zeros_like(carrier_fail),
                                   carrier_fail)
        code_fail = torch.where(loss, torch.zeros_like(code_fail), code_fail)

        # fork EVM indicator (:1030-1056)
        d = torch.sqrt(torch.mean(prompt_buf_re ** 2, dim=1))
        d = torch.clamp(d, min=TINY)
        evm_raw = torch.sqrt(torch.mean(
            (torch.abs(prompt_buf_re / d[:, None]) - 1.0) ** 2
            + (prompt_buf_im / d[:, None]) ** 2, dim=1))
        evm = torch.where(have_cn0, evm_raw, s.evm)

        # the stream advances with the freshly computed length, exactly
        # like the reference (consume_each after update_tracking_vars)
        new = TrackState(
            active=s.active, offset=s.offset + next_len, cur_len=next_len,
            rem_code_phase_samples=rem_code_samples,
            rem_code_phase_chips=rem_code_chips,
            rem_carr_phase_rad=rem_carr,
            carrier_doppler_hz=carrier_doppler,
            if_freq_hz=s.if_freq_hz, code_doppler_chips=code_dop,
            carrier_phase_step_rad=carr_step, code_phase_step_chips=code_step,
            carr_w=carr_w, carr_x=carr_x,
            code_x_hist=code_x_hist, code_y_hist=code_y_hist,
            p_old_re=torch.where(run_loops, ep_re, s.p_old_re),
            p_old_im=torch.where(run_loops, ep_im, s.p_old_im),
            prompt_buf_re=prompt_buf_re, prompt_buf_im=prompt_buf_im,
            prompt_count=prompt_count,
            cn0_db_hz=cn0_s, carrier_lock_test=lock_s, evm=evm,
            code_lock_fail=code_fail, carrier_lock_fail=carrier_fail,
            loss_of_lock=s.loss_of_lock | (loss & s.active),
            step_count=s.step_count + 1,
            extended=s.extended, secondary_locked=s.secondary_locked,
            secondary_signs=s.secondary_signs,
            accu_count=accu_count, accu_re=accu_re, accu_im=accu_im,
        )
        merged = TrackState(*(select(process, nf, of)
                              for nf, of in zip(new, s)))

        dopp_out = torch.where(process, carrier_doppler, s.carrier_doppler_hz)
        code_dop_out = torch.where(process, code_dop, s.code_doppler_chips)
        carr_incr_out_m = torch.where(process, carr_incr_out, zero)
        cn0_out = torch.where(process, cn0_s, s.cn0_db_hz)
        lock_out = torch.where(process, lock_s, s.carrier_lock_test)
        evm_out = torch.where(process, evm, s.evm)
        # one flat per-period record (TrackingChannels._emit):
        # [valid, start, length, rem, p_re, p_im, dp_re, dp_im, dopp,
        #  code_dop, carr_incr, cn0, lock, evm, loss, corr_re(T), corr_im(T)]
        packed = torch.cat([
            torch.stack([
                process.to(torch.float32), s.offset.to(torch.float32),
                s.cur_len.to(torch.float32), s.rem_code_phase_samples,
                p_re, p_im, data_p_re, data_p_im, dopp_out, code_dop_out,
                carr_incr_out_m, cn0_out, lock_out, evm_out,
                merged.loss_of_lock.to(torch.float32)], dim=1),
            corr_re, corr_im], dim=1)
        return merged, packed

    def _block(self, state: TrackState, src_re, src_im, base: int,
               code_tables, data_code_tables=None):
        """All scan steps of one block at ``base`` in the source planes;
        then rebase the offsets. Returns (state, packed [S, C, W])."""
        rows = []
        for _ in range(self.n_steps):
            state, packed = self._step(state, src_re, src_im, base,
                                       code_tables, data_code_tables)
            rows.append(packed)
        bs = self.block_samples
        state = state._replace(offset=torch.where(
            state.active, state.offset - bs, state.offset))
        return state, torch.stack(rows)

    def _blocks_stepwise(self, state: TrackState, src_re, src_im, base: int,
                         block_stride: int, n_blocks: int, code_tables,
                         data_code_tables=None):
        """The plain version of K3-loop: ``n_blocks`` blocks, block b at
        ``base + b * block_stride`` in the source planes, one :meth:`_step`
        a scan step. Returns (state, packed [n_blocks, S, C, W])."""
        out = []
        for b in range(int(n_blocks)):
            state, packed = self._block(
                state, src_re, src_im, int(base) + b * int(block_stride),
                code_tables, data_code_tables)
            out.append(packed)
        return state, torch.stack(out)

    # -- drivers -------------------------------------------------------------
    def _check_tables(self, data_code_tables) -> None:
        if self.cfg.track_pilot and data_code_tables is None:
            raise ValueError("track_pilot needs data_code_tables")

    def process_block(self, state: TrackState, block_re, block_im,
                      code_tables, data_code_tables=None):
        """Track one float32 planar block (``block_samples + overlap``
        samples); with ``cfg.track_pilot``, ``data_code_tables`` carries
        the data-component codes. Returns (state, {"packed": [S, C, W]})."""
        if block_re.shape[0] != self.block_samples + self.overlap:
            raise ValueError(
                f"block must have {self.block_samples + self.overlap} "
                f"samples (block_samples + overlap), got {block_re.shape[0]}")
        self._check_tables(data_code_tables)
        state, packed = scan_loop(self, state, block_re, block_im, 0, 0, 1,
                                  code_tables, data_code_tables)
        return state, {"packed": packed[0]}

    def superblock_step(self, state: TrackState, blocks_re, blocks_im,
                        code_tables, data_code_tables=None):
        """``n`` consecutive [n, block + overlap] float32 blocks. Returns
        (state, {"packed": [n, S, C, W]})."""
        n, width = blocks_re.shape
        if width != self.block_samples + self.overlap:
            raise ValueError(
                f"blocks must have {self.block_samples + self.overlap} "
                f"samples (block_samples + overlap), got {width}")
        self._check_tables(data_code_tables)
        state, packed = scan_loop(
            self, state, blocks_re.reshape(-1), blocks_im.reshape(-1), 0,
            width, n, code_tables, data_code_tables)
        return state, {"packed": packed}

    def superblock_ring_i8(self, state: TrackState, ring_i8, base: int,
                           n_blocks: int, code_tables, data_code_tables=None):
        """``n_blocks`` blocks read from the device-resident planar int8
        ring [2, L]; block b covers ring[:, base + b*block_samples:]
        [:block + overlap]. The widening to float happens inside the
        kernel's loads. Returns (state, {"packed": [n_blocks, S, C, W]})."""
        need = int(base) + int(n_blocks) * self.block_samples + self.overlap
        if need > ring_i8.shape[1]:
            raise ValueError("superblock reaches past the end of the ring")
        self._check_tables(data_code_tables)
        state, packed = scan_loop(self, state, ring_i8[0], ring_i8[1],
                                  int(base), self.block_samples,
                                  int(n_blocks), code_tables,
                                  data_code_tables)
        return state, {"packed": packed}


def select(mask, a_new, a_old):
    """``where(mask, new, old)`` with ``mask`` [C] broadcast over the
    trailing dims."""
    extra = a_new.dim() - mask.dim()
    if extra:
        mask = mask.reshape(mask.shape + (1,) * extra)
    return torch.where(mask, a_new, a_old)
