"""End-to-end GPS L1 C/A receiver.

The control-plane orchestration the reference spreads across
ControlThread::run / GNSSFlowgraph::acquisition_manager / apply_action
(gnss-sdr/src/core/receiver/control_thread.cc:339-448,
gnss_flowgraph.cc:1796-2005), restructured as a synchronous per-block
pipeline:

    block -> [batched acquisition for ALL searching satellites at once]
          -> [tracking block-step for all channels]
          -> [telemetry decode per channel, host]
          -> [observables epochs]
          -> [PVT solve]

One deliberate improvement over the reference: acquisition searches every
pending satellite in a single batched grid program instead of throttling
through ``Channels.in_acquisition`` sequential per-channel searches.

Port of ``gnss_sdr_tpu/receiver/receiver.py``: acquisition and tracking
run on ``device`` (the card by default); the control plane, telemetry,
observables and PVT stay on the host exactly as in the JAX package. The
float-block superblock path (``process_superblock``) is not ported: the
production receiver reads its superblocks from the device-resident int8
ring (:meth:`Receiver.process_superblock_ring`).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from gnss_sdr_tpu_torch.acquisition.adapters import make_gps_l1ca_acquisition
from gnss_sdr_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.observables import ObservablesEngine
from gnss_sdr_tpu_torch.pvt import GpsEphemeris, PvtSolution, solve_pvt
from gnss_sdr_tpu_torch.pvt.solver import Observation
from gnss_sdr_tpu_torch.receiver.fsm import ChannelFsm, ChannelState
from gnss_sdr_tpu_torch.telemetry.gps_lnav import GpsLnavDecoder
from gnss_sdr_tpu_torch.tracking.bit_sync import BitSync
from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig
from gnss_sdr_tpu_torch.tracking.channels import TrackingChannels


@dataclasses.dataclass
class ReceiverConfig:
    fs: float = 4e6
    n_channels: int = 8
    block_ms: int = 20
    # acquisition
    doppler_max: float = 5000.0
    doppler_step: float = 250.0
    acq_pfa: float = 0.001
    acq_dwells: int = 2
    # decimate the acquisition input to the SNR-optimal rate (2 Msps for
    # L1 C/A, GPS_L1_CA.h:53) and rescale delays back to fs — the
    # reference's GNSS-SDR.use_acquisition_resampler
    # (gnss_flowgraph.cc:1027-1117)
    use_acquisition_resampler: bool = False
    # tracking
    pll_bw_hz: float = 35.0
    dll_bw_hz: float = 2.0
    enable_fll_pull_in: bool = True
    fll_bw_hz: float = 35.0
    pull_in_time_s: float = 0.5
    early_late_space_chips: float = 0.5
    # >1 enables extended coherent integration after host bit-sync
    # (tracking states 3/4)
    extend_correlation_symbols: int = 1
    pll_bw_narrow_hz: float = 5.0
    dll_bw_narrow_hz: float = 0.75
    # observables / PVT
    interval_ms: int = 20
    output_rate_ms: int = 100
    apply_tropo: bool = False
    apply_iono: bool = True   # uses decoded subframe-4 Klobuchar terms
    enable_carrier_smoothing: bool = False
    smoothing_factor: int = 200


class Receiver:
    """GPS L1 C/A multi-channel software receiver."""

    def __init__(self, cfg: ReceiverConfig, satellites: list[int],
                 assisted_ephemeris: dict[int, GpsEphemeris] | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        fs = cfg.fs
        self.block_samples = int(round(fs * cfg.block_ms * 1e-3))
        self.sat_pool: collections.deque[int] = collections.deque(satellites)
        self.fsms = [ChannelFsm(i) for i in range(cfg.n_channels)]

        # per-band automatic acquisition resampler: largest integer
        # decimation that keeps the acquisition rate at or above the
        # SNR-optimal 2 Msps (GPS_L1_CA.h:53; gnss_flowgraph.cc:1027-1117)
        opt_fs = 2.0e6
        self._acq_decim = 1
        self._acq_fir: np.ndarray | None = None
        if cfg.use_acquisition_resampler and fs >= 2.0 * opt_fs:
            self._acq_decim = int(fs // opt_fs)
            while self._acq_decim > 1 and fs / self._acq_decim < opt_fs:
                self._acq_decim -= 1
        if self._acq_decim > 1:
            from scipy import signal as sp_signal

            self._acq_fir = sp_signal.firwin(
                8 * self._acq_decim + 1, 0.8 / self._acq_decim)
        self.acq = make_gps_l1ca_acquisition(
            sorted(satellites), fs / self._acq_decim,
            doppler_max=cfg.doppler_max, doppler_step=cfg.doppler_step,
            pfa=cfg.acq_pfa, max_dwells=cfg.acq_dwells, device=self.device,
        )
        trk_cfg = TrackingConfig(
            fs=fs, pll_bw_hz=cfg.pll_bw_hz, dll_bw_hz=cfg.dll_bw_hz,
            enable_fll_pull_in=cfg.enable_fll_pull_in,
            fll_bw_hz=cfg.fll_bw_hz, pull_in_time_s=cfg.pull_in_time_s,
            early_late_space_chips=cfg.early_late_space_chips,
            extend_correlation_symbols=cfg.extend_correlation_symbols,
            pll_bw_narrow_hz=cfg.pll_bw_narrow_hz,
            dll_bw_narrow_hz=cfg.dll_bw_narrow_hz,
        )
        self.tracking = TrackingChannels(trk_cfg, cfg.n_channels,
                                         self.block_samples,
                                         device=self.device)
        self.decoders = [GpsLnavDecoder() for _ in range(cfg.n_channels)]
        self._bit_sync = [BitSync() for _ in range(cfg.n_channels)]
        self._period_count = [0] * cfg.n_channels
        self._extended = [False] * cfg.n_channels
        self.observables = ObservablesEngine(
            fs, cfg.interval_ms, cfg.n_channels,
            enable_carrier_smoothing=cfg.enable_carrier_smoothing,
            smoothing_factor=cfg.smoothing_factor)
        self.iono: tuple | None = None  # (alpha, beta) from SF4 page 18
        self.ephemerides: dict[int, GpsEphemeris] = dict(
            assisted_ephemeris or {})
        self.solutions: list[PvtSolution] = []
        self._last_solve_tow_ms: float | None = None
        self._overlap = self.tracking.overlap

    # -- public API --------------------------------------------------------
    @property
    def overlap(self) -> int:
        return self._overlap

    def channel_states(self) -> list[ChannelState]:
        return [f.state for f in self.fsms]

    def run(self, samples: np.ndarray) -> list[PvtSolution]:
        """Process a whole capture; returns all PVT solutions."""
        n_blocks = (len(samples) - self._overlap) // self.block_samples
        for b in range(n_blocks):
            lo = b * self.block_samples
            self.process_block(
                samples[lo: lo + self.block_samples + self._overlap])
        return self.solutions

    # -- per-block pipeline ------------------------------------------------
    def process_block(self, block: np.ndarray) -> list[PvtSolution]:
        self._manage_acquisition(block)
        new_solutions = []
        per_channel = self.tracking.process_block(block)
        self._feed_decoders(per_channel)
        new_solutions.extend(self._run_observables_and_pvt())
        return new_solutions

    def process_superblock_ring(self, host_block: np.ndarray, ring,
                                base: int, n_blocks: int
                                ) -> list[PvtSolution]:
        """Like :meth:`process_superblock`, but tracking reads its samples
        from a device-resident int8 ring (``ring``, planar [2, L]) at ring
        offset ``base``; ``host_block`` is the matching host-side slice
        used only for acquisition searches."""
        self._manage_acquisition(host_block)
        per_channel = self.tracking.process_superblock_ring(
            ring, base, n_blocks)
        self._feed_decoders(per_channel)
        return self._run_observables_and_pvt()

    # -- receiver management (gnss_flowgraph.cc:1986-2005 standby,
    #    control_thread.cc apply_action cold/warm/hot start,
    #    tcp_cmd_interface.cc verb semantics) --------------------------------
    def apply_command(self, verb: str, args: list[str] | None = None) -> str:
        args = args or []
        verb = verb.lower()
        if verb == "status":
            lines = []
            for fsm in self.fsms:
                lines.append(
                    f"ch {fsm.channel_id}: {fsm.state.name} PRN {fsm.prn}")
            lines.append(f"pool: {list(self.sat_pool)}")
            lines.append(f"fixes: {len(self.solutions)}")
            return "; ".join(lines)
        if verb == "standby":
            self._stop_all_channels()
            return "OK standby"
        if verb == "coldstart":
            self._stop_all_channels()
            self.ephemerides.clear()
            self.observables = ObservablesEngine(
                self.cfg.fs, self.cfg.interval_ms, self.cfg.n_channels,
                enable_carrier_smoothing=self.cfg.enable_carrier_smoothing,
                smoothing_factor=self.cfg.smoothing_factor)
            self._last_solve_tow_ms = None
            return "OK coldstart"
        if verb == "warmstart":
            # keep assistance (ephemerides), restart signal processing
            self._stop_all_channels()
            self._last_solve_tow_ms = None
            return "OK warmstart"
        if verb == "hotstart":
            self._stop_all_channels()
            return "OK hotstart"
        if verb == "reset":
            # the reference restarts the whole process via exit code 42
            # (main.cc:66, gnss-sdr-harness.sh); callers observe this reply
            return "OK reset requested"
        if verb == "set_ch_satellite":
            ch, prn = int(args[0]), int(args[1])
            if not 0 <= ch < self.cfg.n_channels:
                return f"ERROR channel {ch} out of range"
            fsm = self.fsms[ch]
            old = fsm.stop()
            if old:
                self.sat_pool.append(old)
            self.tracking.stop_channel(ch)
            self.observables.reset_channel(ch)
            if prn in self.sat_pool:
                self.sat_pool.remove(prn)
            fsm.start_acquisition(prn)
            return f"OK ch {ch} -> PRN {prn}"
        return f"ERROR unknown command {verb}"

    def _stop_all_channels(self) -> None:
        for ch, fsm in enumerate(self.fsms):
            prn = fsm.stop()
            if prn:
                self.sat_pool.append(prn)
            self.tracking.stop_channel(ch)
            self.observables.reset_channel(ch)
            self.decoders[ch] = GpsLnavDecoder()

    # -- acquisition manager (gnss_flowgraph.cc:1796) ----------------------
    def _manage_acquisition(self, block: np.ndarray) -> None:
        # fill idle channels from the satellite pool
        for fsm in self.fsms:
            if fsm.state is ChannelState.STANDBY and self.sat_pool:
                fsm.start_acquisition(self.sat_pool.popleft())
            elif fsm.state is ChannelState.ACQUISITION and fsm.prn == 0 \
                    and self.sat_pool:
                fsm.prn = self.sat_pool.popleft()

        searching = {f.prn: f for f in self.fsms
                     if f.state is ChannelState.ACQUISITION and f.prn != 0}
        if not searching:
            return
        needed = self.acq.cfg.consumed_samples * self.acq.cfg.max_dwells
        stamp = self.tracking.abs_block_start
        seg = np.asarray(block[: needed * self._acq_decim])
        if self._acq_decim > 1:
            # anti-alias FIR + decimate to the acquisition rate
            seg = np.convolve(seg, self._acq_fir,
                              mode="same")[:: self._acq_decim][:needed]
        results = self.acq.search(seg, samplestamp=stamp)
        for prn, fsm in searching.items():
            res = results.get(prn)
            if res is None:
                continue
            if res.positive:
                fsm.valid_acquisition()
                code_table = np.asarray(gps_l1ca_code(prn), dtype=np.float32)
                self.tracking.start_channel(
                    fsm.channel_id, prn, code_table,
                    res.delay_samples * self._acq_to_trk_ratio(),
                    res.doppler_hz, res.samplestamp_samples)
                self.decoders[fsm.channel_id] = GpsLnavDecoder()
                self.observables.reset_channel(fsm.channel_id)
                self._bit_sync[fsm.channel_id] = BitSync()
                self._period_count[fsm.channel_id] = 0
                self._extended[fsm.channel_id] = False
            elif self.sat_pool:
                # negative: rotate the satellite back through the pool and
                # search the next one, so a channel never starves on a
                # non-visible SV (gnss_flowgraph.cc:1924-1940
                # push_back_signal + next assignment)
                self.sat_pool.append(prn)
                fsm.prn = self.sat_pool.popleft()

    def _acq_to_trk_ratio(self) -> float:
        """Acquisition delay is in acquisition-rate samples; tracking runs
        at fs = acq rate x decimation (gnss_flowgraph.cc:1093-1110 delay
        rescaling)."""
        return float(self._acq_decim)

    # -- telemetry + observables ------------------------------------------
    def _feed_decoders(self, per_channel) -> None:
        for ch, periods in enumerate(per_channel):
            fsm = self.fsms[ch]
            if fsm.state is not ChannelState.TRACKING:
                continue
            dec = self.decoders[ch]
            for p in periods:
                if p.loss_of_lock:
                    prn = fsm.loss_of_lock()
                    if prn:
                        self.sat_pool.append(prn)
                    self.tracking.stop_channel(ch)
                    self.observables.reset_channel(ch)
                    break
                dec.feed(p.prompt.real, p.sample_start + p.length)
                bs = self._bit_sync[ch]
                if not self._extended[ch]:
                    bs.feed(p.prompt.real)
                self._period_count[ch] += 1
                if dec.tow_at_last_symbol_ms is not None:
                    boundary = p.sample_start + p.rem_code_phase_samples
                    tow_at_boundary = dec.tow_at_last_symbol_ms - 1.0
                    self.observables.add_anchor(
                        ch, boundary, tow_at_boundary,
                        p.carrier_doppler_hz, p.acc_carrier_phase_rad,
                        p.cn0_db_hz)
            # telemetry watchdog: a channel tracking a false lock can hold
            # high C/N0 forever; no valid frame within the window forces
            # loss of lock (gps_l1_ca_telemetry_decoder_gs.cc:456-464)
            if getattr(dec, "telemetry_failed", False):
                prn = fsm.loss_of_lock()
                if prn:
                    self.sat_pool.append(prn)
                self.tracking.stop_channel(ch)
                self.observables.reset_channel(ch)
                self.decoders[ch] = GpsLnavDecoder()
                continue
            if dec.has_full_ephemeris() and fsm.prn not in self.ephemerides:
                self.ephemerides[fsm.prn] = GpsEphemeris.from_fields(
                    fsm.prn, dec.ephemeris_fields)
            if self.iono is None and "iono_alpha" in dec.utc_iono_fields \
                    and any(dec.utc_iono_fields["iono_alpha"]):
                # subframe 4 page 18 from any channel serves all of PVT
                # (rtklib_pvt uses the flowgraph-wide broadcast iono);
                # all-zero pages carry no model and are ignored
                self.iono = (dec.utc_iono_fields["iono_alpha"],
                             dec.utc_iono_fields["iono_beta"])
            # state 2 -> 3: extended coherent integration after bit sync
            if (self.cfg.extend_correlation_symbols > 1
                    and not self._extended[ch]
                    and self._bit_sync[ch].synced
                    and self._period_count[ch]
                    > self.cfg.pull_in_time_s * 1000 + 100):
                self.tracking.enable_extended(
                    ch, self._bit_sync[ch].periods_into_bit(
                        self._period_count[ch]))
                self._extended[ch] = True

    def _run_observables_and_pvt(self) -> list[PvtSolution]:
        limit = self.tracking.abs_block_start - 2 * self.tracking.engine.max_period
        new = []
        for rows in self.observables.epochs_until(limit):
            # attach PRNs
            for row in rows:
                row.prn = self.fsms[row.channel].prn
            rx_tow_ms = rows[0].rx_tow_ms
            if self._last_solve_tow_ms is not None and \
                    rx_tow_ms - self._last_solve_tow_ms < self.cfg.output_rate_ms:
                continue
            obs = [
                Observation(
                    prn=row.prn, pseudorange_m=row.pseudorange_m,
                    eph=self.ephemerides[row.prn],
                    doppler_hz=row.doppler_hz, cn0_db_hz=row.cn0_db_hz)
                for row in rows
                if row.prn in self.ephemerides and row.prn != 0
            ]
            if len(obs) < 4:
                continue
            iono = self.iono if self.cfg.apply_iono else None
            sol = solve_pvt(obs, rx_tow_ms * 1e-3,
                            apply_tropo=self.cfg.apply_tropo,
                            iono_alpha=iono[0] if iono else None,
                            iono_beta=iono[1] if iono else None)
            if sol.valid:
                self._last_solve_tow_ms = rx_tow_ms
                self.solutions.append(sol)
                new.append(sol)
        return new
