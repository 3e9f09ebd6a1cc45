"""Fast steady-state tracking engine: group-batched correlation.

Port of ``gnss_sdr_tpu/tracking/fast_engine.py`` with both correlators,
the code bank (``correlator="bank"``, the default) and the segmented sum
(``correlator="segsum"``: rotated prefix sums read at the chip
boundaries, contracted with the raw code tables), and its three loops:
the FLL/PLL loop (``loop="fllpll"``),
the 4-state code/carrier KF (``loop="kf"``, the K6a kernel) and the
Gaussian carrier KF with the DLL filter (``loop="gaussian"``, K6b). The
default serves the production steady state of GPS L1 C/A (K = 20)
and of Galileo E1, on its E1-C pilot with the CS25 secondary wiped off
(K = 25, VEML, the E1-B data bank) or on E1-B alone (K = 1, VEML). In
extended coherent integration the loops close once per K-period group,
so the NCO is constant inside a group and all K periods of all channels
correlate in one launch of the K1 kernel (``kernels/bank_corr.py``) at
closed-form period boundaries

    boundary_k = offset + rem0 + k * T_prn   (int + small-fraction form)

after which :meth:`FastTrackingEngine._close_loops` wipes off the
secondary code and runs the same loop arithmetic as the scan engine's
extended mode in PyTorch (the KF and Gaussian steps in their kernels).
The data-component code of a pilot-tracked channel rides in the same
launch as one more bank tap; with the segmented sum, its prompt comes
from the prompt tap's chip sums. That per-group path is
:meth:`FastTrackingEngine._blocks_stepwise`: the only path on the CPU and,
on the card, the oracle of K1-loop (``kernels/fast_loop.py``), never a
fallback. On the card every call of ``process_block`` and
``superblock_ring_i8`` is one launch of K1-loop, which walks all blocks
and groups of the call with the loop state on the card (with the
segmented sum as its correlation body, K1-seg, for a segsum engine).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.kernels.bank_corr import (bank_corr, on_device,
                                                  pack_indices, value_table)
from gnss_sdr_tpu_torch.kernels.fast_loop import fast_loop
from gnss_sdr_tpu_torch.ops import discriminators as disc
from gnss_sdr_tpu_torch.ops import lock_detectors as lockdet
from gnss_sdr_tpu_torch.ops import loop_filters as lf
from gnss_sdr_tpu_torch.ops.gaussian import (GaussianConfig, GaussState,
                                             _p_ini, gaussian_step,
                                             phase_detector_variance)
from gnss_sdr_tpu_torch.ops.kalman import KfConfig, KfState, kf_step
from gnss_sdr_tpu_torch.tracking.engine import (TWO_PI, TWO_PI_F32, F32,
                                                TrackingConfig, TrackState,
                                                f32, select, set_channel)


class FastState(NamedTuple):
    """Per-channel carry of the group engine ([C] leading dim), the
    fields of ``gnss_sdr_tpu.tracking.fast_engine.FastState``."""

    active: torch.Tensor
    offset: torch.Tensor              # int32 block-relative next group start
    rem_code_phase_samples: torch.Tensor
    rem_carr_phase_rad: torch.Tensor
    carrier_doppler_hz: torch.Tensor
    if_freq_hz: torch.Tensor
    code_doppler_chips: torch.Tensor  # code freq minus nominal chip rate
    carr_w: torch.Tensor
    carr_x: torch.Tensor
    code_x_hist: torch.Tensor
    code_y_hist: torch.Tensor
    p_old_re: torch.Tensor
    p_old_im: torch.Tensor
    prompt_buf_re: torch.Tensor
    prompt_buf_im: torch.Tensor
    prompt_count: torch.Tensor
    cn0_db_hz: torch.Tensor
    carrier_lock_test: torch.Tensor
    code_lock_fail: torch.Tensor
    carrier_lock_fail: torch.Tensor
    loss_of_lock: torch.Tensor
    kf_x: torch.Tensor                # [C, 4] KF state (loop="kf";
    #                                   loop="gaussian" uses [:, 1:1+order])
    kf_p: torch.Tensor                # [C, 4, 4]
    gs_niw: torch.Tensor              # [C, 4] (iter, n, mu, psi) NIW carry
    #                                   of loop="gaussian", float32
    # pilot secondary-code wipe-off (save_correlation_results,
    # dll_pll_veml_tracking.cc:1290): period j of a group is multiplied by
    # sec_signs[c, (sec_phase + j) % sec_len] before the group sum;
    # sec_len = 1 with sign +1 disables it (GPS L1 C/A)
    sec_signs: torch.Tensor           # f32 [C, sec_max_len]
    sec_len: torch.Tensor             # int32 [C]
    sec_phase: torch.Tensor           # int32 [C]: index of the next period
    secondary_locked: torch.Tensor    # bool [C]: four-quadrant PLL


class FastTrackingEngine:
    """K-period group tracking over blocks of G groups.

    ``block_samples`` covers G groups (G*K*T_prn); blocks overlap by
    ``overlap`` samples like the scan engine's."""

    #: sub-sample phases in the code bank
    BANK_PHASES = 16

    def __init__(self, cfg: TrackingConfig, n_channels: int,
                 groups_per_block: int = 5, correlator: str = "bank",
                 loop: str = "fllpll", kf_config=None, sec_max_len: int = 1,
                 device="cuda"):
        if cfg.extend_correlation_symbols < 1:
            raise ValueError("extend_correlation_symbols must be >= 1")
        if correlator not in ("bank", "segsum"):
            raise ValueError("correlator must be 'bank' or 'segsum'")
        if loop not in ("fllpll", "kf", "gaussian"):
            raise ValueError("loop must be 'fllpll', 'kf' or 'gaussian'")
        self.device = resolve_device(device)
        self._gs_psi0 = 0.0
        if loop == "kf":
            self.kf_cfg = kf_config or KfConfig(
                chip_rate_cps=cfg.chip_rate_cps, carrier_hz=cfg.carrier_hz)
        elif loop == "gaussian":
            self.gs_cfg = kf_config or GaussianConfig()
            t_g = cfg.code_period_s * cfg.extend_correlation_symbols
            r30 = float(phase_detector_variance(
                self.gs_cfg.init_cn0_db_hz, t_g))
            self._gs_psi0 = (float(self.gs_cfg.sigma2_phase) + r30) \
                * (self.gs_cfg.bce_nu + 2.0)
        self.cfg = cfg
        self.n_channels = n_channels
        self.correlator = correlator
        self.loop = loop
        self.k = cfg.extend_correlation_symbols
        self.g = groups_per_block
        spc = cfg.samples_per_code
        self.max_period = spc + 16
        self.block_samples = self.g * self.k * spc
        # per-period correlation window, as the JAX package sizes it
        self.win_len = int(math.ceil((self.max_period + 127) / 128)) * 128
        if correlator == "bank":
            self.overlap = self.k * spc + self.win_len + 32
        else:
            self.overlap = self.k * spc + self.max_period
        #: the segmented sum's group window [samples]
        self.lg = self.k * spc + 64
        #: code-table entries a period (the segmented sum's chip bins)
        self.table_len = cfg.code_length_chips * cfg.code_samples_per_chip
        self.n_taps = cfg.n_taps
        #: longest secondary code wiped off on the device (CS25 = 25);
        #: 1 = no wipe-off
        self.sec_max_len = int(sec_max_len)
        #: pilot-tracked: the data code's prompt rides as one more bank tap
        self.track_pilot = bool(cfg.track_pilot)
        t_nom_f64 = cfg.code_length_chips * cfg.fs / cfg.chip_rate_cps
        #: the bank's support: row 0 holds round(t_nom) samples and rows
        #: with a sub-sample start phase one more; the columns past it
        #: are zero, so K1 never reads them
        self.n_eff = min(self.win_len, int(round(t_nom_f64)) + 1)
        self._bank_cache = None
        taps = cfg.tap_shifts()
        self._shifts = np.asarray(taps, dtype=np.float64)
        self._gains = lf.FllPllGains.make(
            cfg.fll_bw_hz, cfg.pll_bw_narrow_hz, cfg.pll_filter_order)
        ic, oc = lf.loop_filter_coefficients(
            cfg.code_period_s * self.k, cfg.dll_bw_narrow_hz,
            cfg.dll_filter_order, include_last_integrator=False)
        self._dll_ic = torch.as_tensor(ic, device=self.device)
        self._dll_oc = torch.as_tensor(oc, device=self.device)
        self._fs = f32(cfg.fs)
        self._chip_rate = f32(cfg.chip_rate_cps)
        self._t_group = f32(cfg.code_period_s * self.k)
        #: the KF and Gaussian steps' group time, as the JAX engine passes
        #: it (float64, rounded into their matrices)
        self._t_loop = float(cfg.code_period_s * self.k)
        self._fs_over_chip = f32(F32(cfg.fs) / F32(cfg.chip_rate_cps))
        self._t_int = int(math.floor(t_nom_f64))
        self._t_frac_nom = f32(t_nom_f64 - math.floor(t_nom_f64))
        self._t_nom_over_f0 = f32(t_nom_f64 / cfg.chip_rate_cps)
        self._half_t_over_f0 = f32(0.5 * t_nom_f64 / cfg.chip_rate_cps)
        self._code_step_nom = f32(cfg.chip_rate_cps / cfg.fs
                                  * cfg.code_samples_per_chip)
        self._cspc_over_fs = f32(F32(cfg.code_samples_per_chip)
                                 / F32(cfg.fs))
        self._aiding = f32(F32(cfg.chip_rate_cps) / F32(cfg.carrier_hz))
        self._k_f32 = f32(self.k)
        self._k_t_int_f32 = f32(self.k * self._t_int)
        self._cn0_a = f32(cfg.cn0_smoother_alpha)
        self._cn0_1ma = f32(F32(1.0) - F32(cfg.cn0_smoother_alpha))
        self._lock_a = f32(cfg.carrier_lock_test_smoother_alpha)
        self._lock_1ma = f32(F32(1.0)
                             - F32(cfg.carrier_lock_test_smoother_alpha))

    # -- state ------------------------------------------------------------
    def _kf_p0(self) -> np.ndarray:
        """Initial 4x4 covariance slab; loop='gaussian' embeds the
        reference P_ini (phase/Doppler/rate) in the [1:, 1:] block."""
        if self.loop == "gaussian":
            p = np.eye(4, dtype=np.float32)
            sub = _p_ini(self.gs_cfg)
            n = sub.shape[0]
            p[1:1 + n, 1:1 + n] = sub
            return p
        return np.diag(np.asarray([1.0, 10.0, 100.0, 10.0], np.float32))

    def _loop_carries(self, doppler_hz) -> dict:
        """``kf_x`` (the Doppler in column 2), ``kf_p`` and ``gs_niw`` of
        channels starting at ``doppler_hz`` [C]."""
        c = doppler_hz.shape[0]
        kf_x = torch.zeros((c, 4), dtype=torch.float32,
                           device=doppler_hz.device)
        kf_x[:, 2] = doppler_hz
        niw = torch.zeros((c, 4), dtype=torch.float32,
                          device=doppler_hz.device)
        niw[:, 3] = self._gs_psi0
        p0 = torch.as_tensor(self._kf_p0(), device=doppler_hz.device)
        return dict(kf_x=kf_x, kf_p=p0.expand(c, 4, 4).clone(), gs_niw=niw)

    def init_state(self) -> FastState:
        c, dev, cfg = self.n_channels, self.device, self.cfg

        def z(*shape, dtype=torch.float32):
            return torch.zeros((c,) + shape, dtype=dtype, device=dev)

        i32 = torch.int32
        return FastState(
            active=z(dtype=torch.bool), offset=z(dtype=i32),
            rem_code_phase_samples=z(), rem_carr_phase_rad=z(),
            carrier_doppler_hz=z(), if_freq_hz=z(), code_doppler_chips=z(),
            carr_w=z(), carr_x=z(),
            code_x_hist=z(lf.HISTORY), code_y_hist=z(lf.HISTORY - 1),
            p_old_re=z(), p_old_im=z(),
            prompt_buf_re=z(cfg.cn0_samples), prompt_buf_im=z(cfg.cn0_samples),
            prompt_count=z(dtype=i32), cn0_db_hz=z(), carrier_lock_test=z(),
            code_lock_fail=z(dtype=i32), carrier_lock_fail=z(dtype=i32),
            loss_of_lock=z(dtype=torch.bool),
            **self._loop_carries(z()),
            sec_signs=torch.ones((c, self.sec_max_len), dtype=torch.float32,
                                 device=dev),
            sec_len=torch.ones((c,), dtype=i32, device=dev),
            sec_phase=z(dtype=i32), secondary_locked=z(dtype=torch.bool),
        )

    def from_track_state(self, ts: TrackState) -> FastState:
        """Adopt a scan-engine state (after pull-in and bit sync; channel
        offsets must already be group/bit aligned). New tensors only: the
        scan state stays untouched."""
        d = ts.carrier_doppler_hz
        if self._gains.order == 3:
            w0, x0 = torch.zeros_like(d), 2.0 * d
        else:
            w0, x0 = d.clone(), torch.zeros_like(d)
        c = d.shape[0]
        dev = d.device
        return FastState(
            active=ts.active.clone(), offset=ts.offset.clone(),
            rem_code_phase_samples=ts.rem_code_phase_samples.clone(),
            rem_carr_phase_rad=ts.rem_carr_phase_rad.clone(),
            carrier_doppler_hz=d.clone(), if_freq_hz=ts.if_freq_hz.clone(),
            code_doppler_chips=ts.code_doppler_chips.clone(),
            carr_w=w0, carr_x=x0,
            code_x_hist=ts.code_x_hist.clone(),
            code_y_hist=ts.code_y_hist.clone(),
            p_old_re=ts.p_old_re.clone(), p_old_im=ts.p_old_im.clone(),
            prompt_buf_re=ts.prompt_buf_re.clone(),
            prompt_buf_im=ts.prompt_buf_im.clone(),
            prompt_count=ts.prompt_count.clone(),
            cn0_db_hz=ts.cn0_db_hz.clone(),
            carrier_lock_test=ts.carrier_lock_test.clone(),
            code_lock_fail=ts.code_lock_fail.clone(),
            carrier_lock_fail=ts.carrier_lock_fail.clone(),
            loss_of_lock=ts.loss_of_lock.clone(),
            **self._loop_carries(d),
            sec_signs=torch.ones((c, self.sec_max_len), dtype=torch.float32,
                                 device=dev),
            sec_len=torch.ones((c,), dtype=torch.int32, device=dev),
            sec_phase=torch.zeros((c,), dtype=torch.int32, device=dev),
            secondary_locked=torch.zeros((c,), dtype=torch.bool, device=dev),
        )

    def start_channel(self, state: FastState, ch: int, doppler_hz: float,
                      offset_samples: int,
                      if_freq_hz: float = 0.0) -> FastState:
        d = f32(doppler_hz)
        if self._gains.order == 3:
            w0, x0 = 0.0, f32(2.0 * F32(d))
        else:
            w0, x0 = d, 0.0
        s = state
        carries = self._loop_carries(
            torch.full((1,), d, dtype=torch.float32, device=s.kf_x.device))
        return s._replace(
            active=set_channel(s.active, ch, True),
            offset=set_channel(s.offset, ch, int(offset_samples)),
            rem_code_phase_samples=set_channel(s.rem_code_phase_samples, ch,
                                               0.0),
            rem_carr_phase_rad=set_channel(s.rem_carr_phase_rad, ch, 0.0),
            carrier_doppler_hz=set_channel(s.carrier_doppler_hz, ch, d),
            if_freq_hz=set_channel(s.if_freq_hz, ch, f32(if_freq_hz)),
            code_doppler_chips=set_channel(s.code_doppler_chips, ch, 0.0),
            carr_w=set_channel(s.carr_w, ch, w0),
            carr_x=set_channel(s.carr_x, ch, x0),
            loss_of_lock=set_channel(s.loss_of_lock, ch, False),
            kf_x=set_channel(s.kf_x, ch, carries["kf_x"][0]),
            kf_p=set_channel(s.kf_p, ch, carries["kf_p"][0]),
            gs_niw=set_channel(s.gs_niw, ch, carries["gs_niw"][0]),
            sec_signs=set_channel(s.sec_signs, ch, 1.0),
            sec_len=set_channel(s.sec_len, ch, 1),
            sec_phase=set_channel(s.sec_phase, ch, 0),
            secondary_locked=set_channel(s.secondary_locked, ch, False),
        )

    def set_secondary(self, state: FastState, ch: int, code: str,
                      phase: int, pure_pilot: bool = True) -> FastState:
        """Enable secondary-code wipe-off for a channel: ``code`` is the
        "0"/"1" secondary sequence (CS25, ...), ``phase`` the secondary
        index of the channel's next period. ``pure_pilot=True`` (a
        dataless pilot drives the loops) also switches the PLL to the
        four-quadrant discriminator (d_cloop=false in run_dll_pll,
        dll_pll_veml_tracking.cc:1110)."""
        signs = np.asarray([1.0 if c in "0+" else -1.0 for c in code],
                           dtype=np.float32)
        if signs.shape[0] > self.sec_max_len:
            raise ValueError(
                f"secondary length {signs.shape[0]} > engine sec_max_len "
                f"{self.sec_max_len}")
        padded = np.ones((self.sec_max_len,), dtype=np.float32)
        padded[:signs.shape[0]] = signs
        s = state
        return s._replace(
            sec_signs=set_channel(s.sec_signs, ch, torch.as_tensor(
                padded, device=s.sec_signs.device)),
            sec_len=set_channel(s.sec_len, ch, int(signs.shape[0])),
            sec_phase=set_channel(s.sec_phase, ch,
                                  int(phase) % signs.shape[0]),
            secondary_locked=set_channel(s.secondary_locked, ch,
                                         bool(pure_pilot)),
        )

    # -- code bank ------------------------------------------------------------
    def get_bank(self, code_tables, data_code_tables=None) -> torch.Tensor:
        """What the correlator reads, on the device, cached by the
        identity of the tables (a held reference keeps their ids from
        being recycled). The bank correlator: the [C, P+1, T, win_len]
        resampled-code bank; a pilot-tracked engine appends the data
        code's single zero-shift bank (``_get_data_bank``'s role) as tap T,
        so K1 returns the data prompt beside the pilot taps. Its packed
        form, which the kernels read (:meth:`packed_bank`), is made with
        it from the same gathers: tables of more than 16 distinct values
        raise ``ValueError``. The segmented sum: the raw tables [C, 1,
        table_len], the data code's stacked as row 1 on a pilot-tracked
        engine (the JAX engine passes both as they are)."""
        if self.track_pilot and data_code_tables is None:
            raise ValueError("track_pilot engine needs data_code_tables")
        cache = self._bank_cache
        if cache is not None and cache[0] is code_tables \
                and cache[1] is data_code_tables:
            return cache[2]

        def host(a):
            return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

        if self.correlator == "segsum":
            rows = [host(code_tables)]
            if self.track_pilot:
                rows.append(host(data_code_tables))
            out = torch.as_tensor(np.stack(rows, axis=1).astype(np.float32),
                                  device=self.device)
            self._bank_cache = (code_tables, data_code_tables, out, None)
            return out
        tables = [np.asarray(host(code_tables), dtype=np.float32)]
        if self.track_pilot:
            tables.append(np.asarray(host(data_code_tables),
                                     dtype=np.float32))
        table = value_table(np.concatenate([np.ravel(a) for a in tables]))
        t = self.n_taps
        idx = np.empty((self.n_channels, self.BANK_PHASES + 1,
                        t + int(self.track_pilot), self.win_len), np.uint8)
        self.build_bank(tables[0], self._shifts, table, idx[:, :, :t])
        if self.track_pilot:
            self.build_bank(tables[1], np.zeros((1,)), table, idx[:, :, t:])
        bank = np.empty(idx.shape, np.float32)
        for c in range(idx.shape[0]):
            np.take(table.view(np.float32), idx[c], out=bank[c], mode="clip")
        out = torch.as_tensor(bank, device=self.device)
        packed = on_device(pack_indices(idx), table, self.device)
        self._bank_cache = (code_tables, data_code_tables, out, packed)
        return out

    def packed_bank(self, bank):
        """The packed form ``(words, values)`` of ``bank`` that K1 and
        K1-loop read on the card (``bank_corr.pack_indices``): the one
        :meth:`get_bank` made beside it or :meth:`set_bank` handed in;
        None for any other bank and for the segmented sum's tables."""
        cache = self._bank_cache
        return cache[3] if cache is not None and cache[2] is bank else None

    def set_bank(self, bank, packed) -> None:
        """Take ``bank`` and its packed form, made by another engine (a
        shard's piece of that engine's, ``parallel.engines``), as the bank
        :meth:`packed_bank` knows."""
        self._bank_cache = (None, None, bank, packed)

    def build_bank(self, code_tables, shifts: np.ndarray,
                   table: np.ndarray, out: np.ndarray) -> None:
        """The bank of ``FastTrackingEngine._build_bank`` as uint8 indices
        into ``table`` (``bank_corr.value_table`` of the code tables),
        written into ``out`` [C, P+1, T, W]: row p holds each tap's code
        resampled at the nominal code rate with sub-sample start phase
        p/P, the columns past the support the level's signed zero (the JAX
        bank's level times 0), so ``table.view(float32)[out]`` is that
        bank to the bit."""
        cfg = self.cfg
        tables = np.asarray(code_tables, dtype=np.float32)
        table_len = tables.shape[1]
        p_phases = self.BANK_PHASES
        n_taps = shifts.shape[0]
        t_nom = cfg.code_length_chips / (cfg.chip_rate_cps / cfg.fs)
        code_step_table = (cfg.chip_rate_cps / cfg.fs
                           * cfg.code_samples_per_chip)
        ll = np.arange(self.win_len, dtype=np.float64)
        # each table entry's index, and its signed zero's
        level = np.searchsorted(table, tables.view(np.int32)) \
            .astype(np.uint8)
        zero = np.searchsorted(table, (tables * np.float32(0.0))
                               .view(np.int32)).astype(np.uint8)
        for p in range(p_phases + 1):
            q = p / p_phases
            tail = np.flatnonzero(ll >= round(t_nom) + (1 if q > 0 else 0))
            for t in range(n_taps):
                idx = np.floor((ll - q) * code_step_table
                               + shifts[t]).astype(np.int64) % table_len
                np.take(level, idx, axis=1, out=out[:, p, t, :],
                        mode="clip")
                out[:, p, t, tail] = zero[:, idx[tail]]

    # -- one group ------------------------------------------------------------
    def group_inputs(self, s: FastState):
        """K1's per-group inputs from the carry: the closed-form period
        boundaries (exact int + small float fraction), the window starts,
        the carrier phase at each window start and the bank row and
        weight of each period. Returns a dict of [C] / [C, K] tensors."""
        k_ext = self.k
        total = self.block_samples + self.overlap
        dev = s.offset.device
        t_frac = self._t_frac_nom - s.code_doppler_chips * self._t_nom_over_f0
        kk = torch.arange(k_ext, dtype=torch.float32, device=dev)
        frac_k = s.rem_code_phase_samples[:, None] \
            + kk[None, :] * t_frac[:, None]                       # [C,K]
        fl_k = torch.floor(frac_k)
        starts = s.offset[:, None] \
            + torch.arange(k_ext, dtype=torch.int32, device=dev)[None, :] \
            * self._t_int + fl_k.to(torch.int32)                  # [C,K]
        rems = frac_k - fl_k
        win_start = torch.clamp(starts, 0, total - self.win_len)
        step = TWO_PI_F32 * (s.carrier_doppler_hz + s.if_freq_hz) / self._fs
        ph0 = s.rem_carr_phase_rad[:, None] + step[:, None] * (
            win_start - s.offset[:, None]).to(torch.float32)
        # mid-period code-Doppler drift correction of the bank phase
        pf_eff = torch.clamp(
            rems - (s.code_doppler_chips * self._half_t_over_f0)[:, None],
            0.0, 1.0)
        pf = pf_eff * float(self.BANK_PHASES)
        j0 = torch.clamp(torch.floor(pf).to(torch.int32), 0,
                         self.BANK_PHASES - 1)
        w = pf - j0.to(torch.float32)
        return dict(t_frac=t_frac, starts=starts, rems=rems,
                    win_start=win_start, step=step.contiguous(), ph0=ph0,
                    j0=j0, w=w)

    def _group(self, s: FastState, src_re, src_im, base: int, bank):
        """Correlate one K-period group (K1, or the segmented sum) and
        close the loops."""
        process = s.active & (s.offset < self.block_samples) & ~s.loss_of_lock
        q = self.group_inputs(s)
        if self.correlator == "segsum":
            corr_re, corr_im, data_re, data_im = self.segsum_corr(
                s, src_re, src_im, base, q["step"], bank)
            return self._close_loops(s, process, q["t_frac"], q["starts"],
                                     q["rems"], corr_re, corr_im, q["step"],
                                     data_re, data_im)
        corr_re, corr_im = bank_corr(src_re, src_im, base, q["win_start"],
                                     q["ph0"], q["step"], bank, q["j0"],
                                     q["w"], self.n_eff,
                                     self.packed_bank(bank))
        data_re = data_im = None
        if self.track_pilot:
            # tap T is the data code's prompt on the same rotated windows
            t = self.n_taps
            data_re, data_im = corr_re[:, :, t], corr_im[:, :, t]
            corr_re, corr_im = corr_re[:, :, :t], corr_im[:, :, :t]
        return self._close_loops(s, process, q["t_frac"], q["starts"],
                                 q["rems"], corr_re, corr_im, q["step"],
                                 data_re, data_im)

    def segsum_corr(self, s: FastState, src_re, src_im, base: int, step,
                    tables, dtype=torch.float32):
        """The segmented-sum correlation of one group, line for line the
        JAX engine's (``group_body`` after ``# ---- segmented-sum
        correlation``): the group's ``lg`` samples from ``clip(offset, 0,
        total - lg)`` rotated once, prefix sums with a leading zero read at
        each tap's chip boundaries ``clip(ceil(r0 + (cc - shift) /
        code_step), 0, lg)`` for cc = -1 .. n_chips + 1, the chip sums
        (their differences) with the two spill bins folded into the edge
        periods' wrap chips, contracted with the code table ``tables[:,
        0]``. A pilot-tracked engine's data prompt contracts the prompt
        tap's chip sums with the data code ``tables[:, 1]``. ``dtype``
        is the float32 of the JAX engine; float64 sums the same chips of
        the same float32 boundaries and phases without rounding error (a
        reference for the float32 prefix sums). Returns (corr_re, corr_im
        [C, K, T], data_re, data_im [C, K] or None)."""
        k_ext, lg, q_len = self.k, self.lg, self.table_len
        total = self.block_samples + self.overlap
        dev = s.offset.device
        group_start = torch.clamp(s.offset, 0, total - lg)            # [C]
        idx = (int(base) + group_start.to(torch.int64))[:, None] \
            + torch.arange(lg, device=dev)
        gw_re = src_re[idx].to(dtype)
        gw_im = src_im[idx].to(dtype)
        n = torch.arange(lg, dtype=torch.float32, device=dev)
        phase = (s.rem_carr_phase_rad[:, None]
                 + step[:, None] * n[None, :]).to(dtype)
        c_ = torch.cos(phase)
        s_ = torch.sin(phase)
        rot_re = gw_re * c_ + gw_im * s_
        rot_im = gw_im * c_ - gw_re * s_
        zeros1 = torch.zeros((rot_re.shape[0], 1), dtype=dtype, device=dev)
        p_re = torch.cat([zeros1, torch.cumsum(rot_re, dim=1)], dim=1)
        p_im = torch.cat([zeros1, torch.cumsum(rot_im, dim=1)], dim=1)

        # chip boundaries: chip cc of tap t starts at sample
        # ceil(r0 + (cc - shift_t) / code_step) of the group window
        code_step = self._code_step_nom \
            + s.code_doppler_chips * self._cspc_over_fs               # [C]
        n_chips = k_ext * q_len
        cc = torch.arange(-1, n_chips + 2, dtype=torch.float32, device=dev)
        shifts = torch.as_tensor(self._shifts, dtype=torch.float32,
                                 device=dev)
        r0 = s.rem_code_phase_samples
        a = torch.ceil(r0[:, None, None]
                       + (cc[None, None, :] - shifts[None, :, None])
                       / code_step[:, None, None])             # [C,T,Nb+1]
        a = torch.clamp(a, 0, lg).to(torch.int64)
        c, t = a.shape[0], a.shape[1]
        pr = torch.gather(p_re[:, None, :].expand(c, t, lg + 1), -1, a)
        pi_ = torch.gather(p_im[:, None, :].expand(c, t, lg + 1), -1, a)
        seg_re = torch.diff(pr, dim=-1)                           # [C,T,Nb]
        seg_im = torch.diff(pi_, dim=-1)
        # the spill bins fold into the edge periods' wrap chips: chip -1
        # onto table_len - 1, chip n_chips onto n_chips - table_len
        core_re = seg_re[..., 1:1 + n_chips].clone()
        core_im = seg_im[..., 1:1 + n_chips].clone()
        core_re[..., q_len - 1] += seg_re[..., 0]
        core_im[..., q_len - 1] += seg_im[..., 0]
        core_re[..., n_chips - q_len] += seg_re[..., n_chips + 1]
        core_im[..., n_chips - q_len] += seg_im[..., n_chips + 1]
        core_re = core_re.reshape(c, t, k_ext, q_len)
        core_im = core_im.reshape(c, t, k_ext, q_len)
        code = tables[:, 0].to(dtype)
        corr_re = torch.einsum("ctkq,cq->ckt", core_re, code)
        corr_im = torch.einsum("ctkq,cq->ckt", core_im, code)
        if not self.track_pilot:
            return corr_re, corr_im, None, None
        # the data prompt from the prompt tap's chip sums (same NCO, zero
        # shift) against the data code
        pt, dcode = self.n_taps // 2, tables[:, 1].to(dtype)
        return (corr_re, corr_im,
                torch.einsum("ckq,cq->ck", core_re[:, pt], dcode),
                torch.einsum("ckq,cq->ck", core_im[:, pt], dcode))

    def _close_loops(self, s: FastState, process, t_frac, starts, rems,
                     corr_re, corr_im, step, data_re=None, data_im=None):
        """Secondary wipe-off, group accumulation, DLL/PLL closure, carry,
        C/N0 and locks, and the packed [C, 5K+4] record. ``data_re/im``
        are the per-period data-component prompts [C, K] of a
        pilot-tracked channel, else None."""
        cfg = self.cfg
        k_ext = self.k
        prompt_tap = self.n_taps // 2
        if self.sec_max_len > 1:
            # period j's sign is sec_signs[(sec_phase + j) % sec_len]
            jj = torch.arange(k_ext, dtype=torch.int32, device=s.offset.device)
            sec_idx = torch.remainder(s.sec_phase[:, None] + jj[None, :],
                                      s.sec_len[:, None])          # [C,K]
            signs = torch.gather(s.sec_signs, 1, sec_idx.to(torch.int64))
            corr_re = corr_re * signs[:, :, None]
            corr_im = corr_im * signs[:, :, None]
            new_sec_phase = torch.remainder(s.sec_phase + k_ext, s.sec_len)
        else:
            new_sec_phase = s.sec_phase
        g_re = torch.sum(corr_re, dim=1)                          # [C,T]
        g_im = torch.sum(corr_im, dim=1)
        ep_re = g_re[:, prompt_tap]
        ep_im = g_im[:, prompt_tap]

        pll_rad = torch.where(
            s.secondary_locked, disc.pll_four_quadrant_atan(ep_re, ep_im),
            disc.pll_cloop_two_quadrant_atan(ep_re, ep_im))
        pll_hz = pll_rad / TWO_PI
        if cfg.veml:
            dll_d = disc.dll_nc_vemlp_normalized(
                g_re[:, 0], g_im[:, 0], g_re[:, 1], g_im[:, 1],
                g_re[:, 3], g_im[:, 3], g_re[:, 4], g_im[:, 4])
        else:
            dll_d = disc.dll_nc_e_minus_l_normalized(
                g_re[:, 0], g_im[:, 0], g_re[:, 2], g_im[:, 2],
                cfg.spc, cfg.slope, cfg.y_intercept)
        kf_x, kf_p, gs_niw = s.kf_x, s.kf_p, s.gs_niw
        carr_w, carr_x = s.carr_w, s.carr_x
        code_x_hist, code_y_hist = s.code_x_hist, s.code_y_hist
        #: the KF and Gaussian loops' code [chips] and carrier [rad] phase
        #: corrections, applied to the remnant carries (error-state reset)
        code_corr = carr_corr = None
        if self.loop == "kf":
            # 4-state code/carrier KF closure (kf_tracking role): the
            # discriminators are its measurements, the rates come from its
            # Doppler (+ rate) states with implicit carrier aiding
            kf_new, delta = kf_step(KfState(x=s.kf_x, p=s.kf_p), dll_d,
                                    pll_rad, self._t_loop, self.kf_cfg)
            kf_x, kf_p = kf_new.x, kf_new.p
            carrier_doppler = kf_x[:, 2]
            code_dop = carrier_doppler * self._aiding
            code_corr, carr_corr = delta[:, 0], delta[:, 1]
        elif self.loop == "gaussian":
            # Gaussian carrier-KF closure (gps_l1_ca_gaussian_tracking
            # role): the atan phase discriminator feeds the order-2/3
            # carrier KF with NIW-adaptive R; the code closes through the
            # DLL filter as a phase correction over the group, with full
            # carrier aiding of the code rate (:717-738)
            n = self.gs_cfg.order
            gst = GaussState(
                x=s.kf_x[:, 1:1 + n], p=s.kf_p[:, 1:1 + n, 1:1 + n],
                niw_iter=s.gs_niw[:, 0].to(torch.int32),
                niw_n=s.gs_niw[:, 1].to(torch.int32),
                niw_mu=s.gs_niw[:, 2], niw_psi=s.gs_niw[:, 3])
            gnew, ginfo = gaussian_step(gst, pll_rad, s.cn0_db_hz,
                                        self._t_loop, self.gs_cfg)
            carrier_doppler = ginfo["carrier_doppler_hz"]
            code_dop = carrier_doppler * self._aiding
            (code_x_hist, code_y_hist), code_err = lf.iir_step(
                (s.code_x_hist, s.code_y_hist), dll_d, self._dll_ic,
                self._dll_oc)
            code_corr = code_err * self._t_group
            carr_corr = ginfo["phase_corr_rad"]
            kf_x = s.kf_x.clone()
            kf_x[:, 1:1 + n] = gnew.x
            kf_p = s.kf_p.clone()
            kf_p[:, 1:1 + n, 1:1 + n] = gnew.p
            gs_niw = torch.stack([gnew.niw_iter.to(torch.float32),
                                  gnew.niw_n.to(torch.float32),
                                  gnew.niw_mu, gnew.niw_psi], dim=1)
        else:
            (carr_w, carr_x), carrier_doppler = lf.fll_pll_step(
                (s.carr_w, s.carr_x), torch.zeros_like(pll_hz), pll_hz,
                self._t_group, self._gains)
            (code_x_hist, code_y_hist), code_err = lf.iir_step(
                (s.code_x_hist, s.code_y_hist), dll_d, self._dll_ic,
                self._dll_oc)
            code_dop = -code_err
            if cfg.carrier_aiding:
                code_dop = code_dop + carrier_doppler * self._aiding

        # ---- carry to the next group (int + small fraction) ---------------
        frac_end = s.rem_code_phase_samples + self._k_f32 * t_frac
        group_len = self._k_t_int_f32 + self._k_f32 * t_frac
        if code_corr is not None:
            corr_samp = code_corr * self._fs_over_chip
            frac_end = frac_end + corr_samp
            group_len = group_len + corr_samp
        fl_end = torch.floor(frac_end)
        new_offset = s.offset + k_ext * self._t_int + fl_end.to(torch.int32)
        new_rem = frac_end - fl_end
        carr_incr = step * group_len
        if carr_corr is not None:
            carr_incr = carr_incr + carr_corr
        new_rem_carr = torch.remainder(s.rem_carr_phase_rad + carr_incr,
                                       TWO_PI_F32)

        # ---- C/N0 and locks (per group) -------------------------------------
        pb_re = torch.cat([ep_re[:, None], s.prompt_buf_re[:, :-1]], dim=1)
        pb_im = torch.cat([ep_im[:, None], s.prompt_buf_im[:, :-1]], dim=1)
        count_pre = s.prompt_count
        have = count_pre >= cfg.cn0_samples
        first = count_pre == cfg.cn0_samples
        pcount = torch.clamp(count_pre + 1, max=cfg.cn0_samples + 1)
        cn0_raw = lockdet.cn0_m2m4_estimator(pb_re, pb_im, self._t_group)
        cn0_s = torch.where(have, torch.where(
            first, cn0_raw, self._cn0_a * cn0_raw + self._cn0_1ma * s.cn0_db_hz),
            s.cn0_db_hz)
        lock_raw = lockdet.carrier_lock_detector(ep_re[:, None],
                                                 ep_im[:, None])
        lock_s = torch.where(have, torch.where(
            first, lock_raw,
            self._lock_a * lock_raw + self._lock_1ma * s.carrier_lock_test),
            s.carrier_lock_test)
        have_i = have.to(torch.int32)
        cfail = torch.where(have & (lock_s < cfg.carrier_lock_th),
                            s.carrier_lock_fail + 1,
                            torch.clamp(s.carrier_lock_fail - have_i, min=0))
        kfail = torch.where(have & (cn0_s < cfg.cn0_min),
                            s.code_lock_fail + 1,
                            torch.clamp(s.code_lock_fail - have_i, min=0))
        loss = (cfail > cfg.max_carrier_lock_fail) \
            | (kfail > cfg.max_code_lock_fail)

        new = FastState(
            active=s.active, offset=new_offset,
            rem_code_phase_samples=new_rem, rem_carr_phase_rad=new_rem_carr,
            carrier_doppler_hz=carrier_doppler, if_freq_hz=s.if_freq_hz,
            code_doppler_chips=code_dop, carr_w=carr_w, carr_x=carr_x,
            code_x_hist=code_x_hist, code_y_hist=code_y_hist,
            p_old_re=ep_re, p_old_im=ep_im,
            prompt_buf_re=pb_re, prompt_buf_im=pb_im,
            prompt_count=pcount, cn0_db_hz=cn0_s, carrier_lock_test=lock_s,
            code_lock_fail=torch.where(loss, torch.zeros_like(kfail), kfail),
            carrier_lock_fail=torch.where(loss, torch.zeros_like(cfail),
                                          cfail),
            loss_of_lock=s.loss_of_lock | (loss & s.active),
            kf_x=kf_x, kf_p=kf_p, gs_niw=gs_niw,
            sec_signs=s.sec_signs, sec_len=s.sec_len, sec_phase=new_sec_phase,
            secondary_locked=s.secondary_locked,
        )
        merged = FastState(*(select(process, nf, of)
                             for nf, of in zip(new, s)))
        dopp_out = torch.where(process, carrier_doppler, s.carrier_doppler_hz)
        cn0_out = torch.where(process, cn0_s, s.cn0_db_hz)
        p_re = corr_re[:, :, prompt_tap]
        # the decoder's symbol source: the data-component prompts on
        # pilot-tracked bands, the (wiped) prompts otherwise
        dp_re = p_re if data_re is None else data_re
        dp_im = corr_im[:, :, prompt_tap] if data_im is None else data_im
        # one flat per-group record [C, 5K+4]: starts | rems | prompts |
        # data_re | data_im | dopp cn0 valid loss; block-relative starts
        # stay < 2^24, exact in f32
        packed = torch.cat([
            starts.to(torch.float32), rems, p_re, dp_re, dp_im,
            torch.stack([dopp_out, cn0_out, process.to(torch.float32),
                         merged.loss_of_lock.to(torch.float32)], dim=1),
        ], dim=1)
        return merged, packed, ep_re, ep_im

    def _block(self, state: FastState, src_re, src_im, base: int, bank):
        rows, pre, pim = [], [], []
        for gi in range(self.g):
            state, packed, ep_re, ep_im = self._group(state, src_re, src_im,
                                                      base, bank)
            rows.append(packed)
            pre.append(ep_re)
            pim.append(ep_im)
        state = state._replace(offset=torch.where(
            state.active, state.offset - self.block_samples, state.offset))
        return state, torch.stack(rows), torch.stack(pre), torch.stack(pim)

    def _blocks_stepwise(self, state: FastState, src_re, src_im, base: int,
                         block_stride: int, n_blocks: int, bank):
        """The plain version of K1-loop: ``n_blocks`` blocks, block b at
        ``base + b * block_stride`` in the source planes, one :meth:`_group`
        a group. Returns (state, packed [n_blocks, G, C, 5K+4], prompt_re
        [n_blocks, G, C], prompt_im)."""
        out, pre, pim = [], [], []
        for b in range(int(n_blocks)):
            state, packed, p_re, p_im = self._block(
                state, src_re, src_im, int(base) + b * int(block_stride),
                bank)
            out.append(packed)
            pre.append(p_re)
            pim.append(p_im)
        return state, torch.stack(out), torch.stack(pre), torch.stack(pim)

    # -- drivers -----------------------------------------------------------------
    def process_block(self, state: FastState, block_re, block_im,
                      code_tables, data_code_tables=None):
        """One float32 planar block (``block_samples + overlap``). Returns
        (state, {"packed": [G, C, 5K+4], "prompt_re": [G, C],
        "prompt_im": [G, C]}); ``code_tables`` [C, L] (and, pilot-tracked,
        ``data_code_tables``) go through :meth:`get_bank` here."""
        if block_re.shape[0] != self.block_samples + self.overlap:
            raise ValueError(
                f"block must have {self.block_samples + self.overlap} "
                f"samples, got {block_re.shape[0]}")
        bank = self.get_bank(code_tables, data_code_tables)
        state, packed, pre, pim = fast_loop(self, state, block_re, block_im,
                                            0, 0, 1, bank)
        return state, {"packed": packed[0], "prompt_re": pre[0],
                       "prompt_im": pim[0]}

    def superblock_ring_i8(self, state: FastState, ring_i8, base: int,
                           n_blocks: int, bank):
        """``n_blocks`` blocks read from the device-resident planar int8
        ring [2, L] at ``base``; ``bank`` from :meth:`get_bank` (with the
        data tap when pilot-tracked). Returns
        (state, {"packed": [n_blocks, G, C, 5K+4]})."""
        need = int(base) + int(n_blocks) * self.block_samples + self.overlap
        if need > ring_i8.shape[1]:
            raise ValueError("superblock reaches past the end of the ring")
        state, packed, _, _ = fast_loop(self, state, ring_i8[0], ring_i8[1],
                                        int(base), self.block_samples,
                                        int(n_blocks), bank)
        return state, {"packed": packed}
