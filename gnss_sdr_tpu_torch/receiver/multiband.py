"""Multi-constellation (multi-band) receiver.

Port of ``MultiBandConfig`` and ``MultiBandReceiver`` of
``gnss_sdr_tpu/receiver/multiband.py``: the hybrid receiver of the
reference (GNSSFlowgraph wiring N channels of several signals into one
observables/PVT chain). Each band (``receiver/bands.py``) has its own
batched acquisition engine, tracking channels and telemetry decoders; one
common-reception-time observables engine and one PVT solver fuse all
bands' measurements. Each band may ride its own RF stream: pass
``run``/``process_block`` a ``{suffix: samples}`` dict, or one array
shared by all bands.

GST and GPS time are taken as aligned. The JAX receiver's cross-band
time transfer (``_share_coarse_time``) serves only decoders that take a
coarse TOW or a time aid (GLONASS GNAV, L5 CNAV); LNAV and I/NAV take
neither, so it comes with those bands. The port solves the ``Single``
positioning mode; the factory refuses the JAX receiver's PVT block (PPP,
RTK, SBAS corrections, the ionosphere-free combination, RINEX output,
the UDP monitors) and its telecommand verbs (``apply_command``) wait for
the telecommand server (ROADMAP steps 8g and 12).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.observables import ObservablesEngine
from gnss_sdr_tpu_torch.pvt import GpsEphemeris, PvtSolution, solve_pvt
from gnss_sdr_tpu_torch.pvt.solver import Observation
from gnss_sdr_tpu_torch.receiver.bands import Band, BandConfig
from gnss_sdr_tpu_torch.receiver.fsm import ChannelState

__all__ = ["BandConfig", "MultiBandConfig", "MultiBandReceiver"]


@dataclasses.dataclass
class MultiBandConfig:
    fs: float = 5.0e6
    block_ms: int = 20
    interval_ms: int = 20
    output_rate_ms: int = 100
    apply_tropo: bool = False
    enable_carrier_smoothing: bool = False
    smoothing_factor: int = 200


class MultiBandReceiver:
    def __init__(self, cfg: MultiBandConfig, bands: list[BandConfig],
                 assisted_ephemeris: dict[tuple[str, int], GpsEphemeris]
                 | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.block_samples = int(round(cfg.fs * cfg.block_ms * 1e-3))
        self.bands: list[Band] = []
        offset = 0
        for b in bands:
            band = Band(b, b.fs or cfg.fs, cfg.block_ms, offset,
                        device=self.device)
            self.bands.append(band)
            offset += b.n_channels
        self.total_channels = offset
        self.observables = ObservablesEngine(
            cfg.fs, cfg.interval_ms, self.total_channels,
            enable_carrier_smoothing=cfg.enable_carrier_smoothing,
            smoothing_factor=cfg.smoothing_factor)
        self.ephemerides: dict[tuple[str, int], GpsEphemeris] = dict(
            assisted_ephemeris or {})
        self.solutions: list[PvtSolution] = []
        self._last_solve_tow_ms: float | None = None
        self._chan_sat: dict[int, tuple[str, int]] = {}
        self._chan_band: dict[int, Band] = {
            band.ch_offset + i: band
            for band in self.bands for i in range(band.cfg.n_channels)}

    @property
    def overlap(self) -> int:
        """Overlap of the (common-rate) band with the largest carryover,
        in common-fs samples (run() slicing margin)."""
        return max(
            int(np.ceil(b.tracking.overlap * self.cfg.fs / b.fs))
            for b in self.bands)

    def channel_states(self):
        return [f.state for band in self.bands for f in band.fsms]

    def band_blocks(self, samples, k: int) -> dict:
        """Block ``k`` (its main region plus overlap) of every band from
        one shared array or a ``{suffix: array}`` dict."""
        blk = {}
        for b in self.bands:
            x = samples[b.cfg.suffix] if isinstance(samples, dict) \
                else samples
            lo = k * b.block_samples
            blk[b.cfg.suffix] = x[lo: lo + b.block_samples
                                  + b.tracking.overlap]
        return blk

    def n_blocks(self, samples) -> int:
        """Whole blocks every band can track in ``samples``."""
        return min(
            (len(samples[b.cfg.suffix] if isinstance(samples, dict)
                 else samples) - b.tracking.overlap) // b.block_samples
            for b in self.bands)

    def run(self, samples) -> list[PvtSolution]:
        """``samples``: one array shared by all bands (common fs), or a
        ``{band suffix: array}`` dict of per-RF-channel streams, each at
        its band's sample rate and starting at the same instant."""
        for k in range(self.n_blocks(samples)):
            self.process_block(self.band_blocks(samples, k))
        return self.solutions

    def process_block(self, block) -> list[PvtSolution]:
        for band in self.bands:
            b = block[band.cfg.suffix] if isinstance(block, dict) else block
            self._manage_acquisition(band, b)
            per_channel = band.tracking.process_block(
                b[: band.block_samples + band.tracking.overlap])
            self._feed_band(band, per_channel)
        return self._run_pvt()

    # -- per-band control (mirrors Receiver) ------------------------------
    def _manage_acquisition(self, band: Band, block: np.ndarray) -> None:
        for fsm in band.fsms:
            if fsm.state is ChannelState.STANDBY and band.sat_pool:
                fsm.start_acquisition(band.sat_pool.popleft())
            elif fsm.state is ChannelState.ACQUISITION and fsm.prn == 0 \
                    and band.sat_pool:
                fsm.prn = band.sat_pool.popleft()
        searching = {f.prn: f for f in band.fsms
                     if f.state is ChannelState.ACQUISITION and f.prn != 0}
        if not searching:
            return
        needed = band.acq.cfg.consumed_samples * band.acq.cfg.max_dwells
        stamp = band.tracking.abs_block_start
        results = band.acq.search(np.asarray(block[:needed]),
                                  samplestamp=stamp)
        for prn, fsm in searching.items():
            res = results.get(prn)
            if res is None:
                continue
            if res.positive:
                fsm.valid_acquisition()
                local_ch = fsm.channel_id - band.ch_offset
                band.tracking.start_channel(
                    local_ch, prn, band.code_table(prn),
                    res.delay_samples, res.doppler_hz,
                    res.samplestamp_samples,
                    data_code_table=(band.data_code_table(prn)
                                     if band.data_code_table else None))
                band.decoders[local_ch] = band.new_decoder()
                self.observables.reset_channel(fsm.channel_id)
                self.observables.set_channel_carrier(
                    fsm.channel_id, band.carrier_hz)
                self._chan_sat[fsm.channel_id] = (band.system, prn)
            elif band.sat_pool:
                # rotate the pool on a negative search (flowgraph
                # push_back_signal semantics, gnss_flowgraph.cc:1924-1940)
                band.sat_pool.append(prn)
                fsm.prn = band.sat_pool.popleft()

    def _drop_channel(self, band: Band, local_ch: int) -> None:
        """Loss of lock: the satellite back to the pool, the channel
        stopped and its observables reset."""
        fsm = band.fsms[local_ch]
        prn = fsm.loss_of_lock()
        if prn:
            band.sat_pool.append(prn)
        band.tracking.stop_channel(local_ch)
        self.observables.reset_channel(fsm.channel_id)
        self._chan_sat.pop(fsm.channel_id, None)

    def _feed_band(self, band: Band, per_channel) -> None:
        # anchors go to the observables engine in common-fs sample units
        scale = self.cfg.fs / band.fs
        for local_ch, periods in enumerate(per_channel):
            fsm = band.fsms[local_ch]
            if fsm.state is not ChannelState.TRACKING:
                continue
            gch = fsm.channel_id
            dec = band.decoders[local_ch]
            for p in periods:
                if p.loss_of_lock:
                    self._drop_channel(band, local_ch)
                    break
                # the data component's prompt (the prompt itself unless
                # the loops track a pilot)
                dec.feed(p.data_prompt.real, p.sample_start + p.length)
                if dec.tow_at_last_symbol_ms is not None:
                    boundary = p.sample_start + p.rem_code_phase_samples
                    tow = dec.tow_at_last_symbol_ms - band.period_ms
                    self.observables.add_anchor(
                        gch, boundary * scale, tow, p.carrier_doppler_hz,
                        p.acc_carrier_phase_rad, p.cn0_db_hz)
            # telemetry watchdog (gps_l1_ca_telemetry_decoder_gs.cc:459
            # parity): no valid frame in the window -> requeue the SV
            if getattr(dec, "telemetry_failed", False):
                self._drop_channel(band, local_ch)
                band.decoders[local_ch] = band.new_decoder()
                continue
            key = (band.system, fsm.prn)
            if dec.has_full_ephemeris() and key not in self.ephemerides:
                self.ephemerides[key] = band.make_ephemeris(fsm.prn, dec)

    def _run_pvt(self, limit: float | None = None) -> list[PvtSolution]:
        if limit is None:
            limit = min(
                (b.tracking.abs_block_start
                 - 2 * b.tracking.engine.max_period) * self.cfg.fs / b.fs
                for b in self.bands)
        new = []
        for rows in self.observables.epochs_until(limit):
            rx_tow_ms = rows[0].rx_tow_ms
            if self._last_solve_tow_ms is not None and \
                    rx_tow_ms - self._last_solve_tow_ms \
                    < self.cfg.output_rate_ms:
                continue
            obs = []
            for row in rows:
                key = self._chan_sat.get(row.channel)
                if key is None:
                    continue
                eph = self.ephemerides.get(key)
                if eph is None:
                    continue
                row.prn = key[1]
                band = self._chan_band[row.channel]
                obs.append(Observation(
                    prn=key[1], pseudorange_m=row.pseudorange_m,
                    eph=eph, doppler_hz=row.doppler_hz,
                    carrier_hz=band.carrier_hz,
                    cn0_db_hz=row.cn0_db_hz, system=key[0]))
            # dual-band rows duplicate satellites; the geometry needs >= 4
            # distinct satellites or the LS normal matrix is rank-deficient
            if len({(o.system, o.prn) for o in obs}) < 4:
                continue
            sol = solve_pvt(obs, rx_tow_ms * 1e-3,
                            apply_tropo=self.cfg.apply_tropo)
            if sol.valid:
                self._last_solve_tow_ms = rx_tow_ms
                self.solutions.append(sol)
                new.append(sol)
        return new
