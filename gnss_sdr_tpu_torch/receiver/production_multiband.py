"""Multi-band production receiver: scan-engine pull-in per band, then a
group-batched fast engine for every band in steady state.

Port of ``gnss_sdr_tpu/receiver/production_multiband.py`` for the bands
the port builds (``receiver/bands.py``):

============ ======== ===============================================
suffix       K        group alignment / secondary wipe-off
============ ======== ===============================================
1C           20       data-bit aligned (BitSync), Costas
1B           1        none (an E1-B symbol is one 4 ms period)
1B pilot     25       E1-C CS25 wiped off, four-quadrant PLL, the
                      I/NAV symbols from the E1-B data-code bank
============ ======== ===============================================

Deployment shape as the single-band production receiver: per-band
device-resident int8 ingest rings, ~100 ms fast blocks, superblocks of
``blocks_per_call`` blocks per dispatch, software pipelining (dispatch
window N+1, then consume window N's packed records on the host), bulk
observables anchors, one fused PVT.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from gnss_sdr_tpu_torch.native import complex_to_quantized_i8
from gnss_sdr_tpu_torch.receiver.bands import Band, BandConfig
from gnss_sdr_tpu_torch.receiver.fsm import ChannelState
from gnss_sdr_tpu_torch.receiver.multiband import (MultiBandConfig,
                                                   MultiBandReceiver)
from gnss_sdr_tpu_torch.tracking.bit_sync import BitSync, SecondaryCodeSync
from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

TWO_PI = 2.0 * math.pi

#: fast-engine group length per suffix (PRN periods per loop closure)
_K_BY_SUFFIX = {"1C": 20, "1B": 1}
#: common fast-block duration [s] across bands (block = g*K*T_prn)
_BLOCK_S = 0.1


def _pilot_secondary(band: Band) -> str | None:
    """Pilot-component secondary code of a pilot-tracked band."""
    if band.cfg.suffix == "1B" and band.tracking.cfg.track_pilot:
        from gnss_sdr_tpu_torch.codes.galileo_e1 import E1C_SECONDARY

        return E1C_SECONDARY
    return None


class _FastBandCtx:
    """Per-band fast-engine context built at handoff."""

    def __init__(self, band: Band, device):
        self.band = band
        self.k = _K_BY_SUFFIX[band.cfg.suffix]
        self.sec_len = 1
        extra = {}
        if band.cfg.suffix == "1B" and band.tracking.cfg.track_pilot:
            # E1-C pilot: extend coherent integration over the full CS25
            # secondary (100 ms loop closure), the reference's
            # post-secondary-sync extension
            # (dll_pll_veml_tracking.cc:1989-2028). At a 10 Hz loop
            # closure rate the bandwidths must keep B_L*T well under 0.5
            # or the loops go unstable.
            self.k = 25
            self.sec_len = 25
            extra = dict(pll_bw_narrow_hz=min(
                band.tracking.cfg.pll_bw_narrow_hz, 2.0))
        # the engine reads K from the config (the scan configs track
        # per period, extend_correlation_symbols=1)
        trk_cfg = dataclasses.replace(
            band.tracking.cfg, extend_correlation_symbols=self.k, **extra)
        # groups per block so every band's fast block spans _BLOCK_S
        t_group = trk_cfg.code_period_s * self.k
        self.g = max(1, int(round(_BLOCK_S / t_group)))
        self.fast = FastTrackingEngine(
            trk_cfg, band.cfg.n_channels, groups_per_block=self.g,
            sec_max_len=self.sec_len, device=device)
        self.state = None
        self.codes = band.tracking._code_tables_dev
        self.data_codes = band.tracking._data_code_tables_dev
        self.ring = None
        self.base = 0            # absolute (band-fs) sample of next block


class ProductionMultiBandReceiver:
    """Phase A on the scan engines, phase B on per-band fast engines."""

    def __init__(self, cfg: MultiBandConfig, bands: list[BandConfig],
                 assisted_ephemeris=None, blocks_per_call: int = 10,
                 device="cuda"):
        self.receiver = MultiBandReceiver(cfg, bands, assisted_ephemeris,
                                          device=device)
        self.device = self.receiver.device
        self.blocks_per_call = blocks_per_call
        self.solutions = self.receiver.solutions
        rec = self.receiver
        # per-channel sync trackers driven during phase A
        self._period_count = {b.cfg.suffix: [0] * b.cfg.n_channels
                              for b in rec.bands}
        self._bit_sync: dict[tuple[str, int], BitSync] = {}
        self._sec_sync: dict[tuple[str, int], SecondaryCodeSync] = {}
        self._ctx: dict[str, _FastBandCtx] | None = None
        self.handoff_sample: int | None = None   # common-fs units

    # -- phase A ----------------------------------------------------------
    def _reset_channel_sync(self, band: Band, local_ch: int) -> None:
        sx = band.cfg.suffix
        self._period_count[sx][local_ch] = 0
        key = (sx, local_ch)
        if sx == "1C":
            self._bit_sync[key] = BitSync(
                symbols_per_bit=band.tracking.cfg.symbols_per_bit)
        sec = _pilot_secondary(band)
        if sec is not None:
            self._sec_sync[key] = SecondaryCodeSync(sec)

    def _manage_acquisition(self, band: Band, block) -> None:
        """The receiver's acquisition manager; channels that start
        tracking get fresh sync trackers."""
        before = {f.channel_id: f.state for f in band.fsms}
        self.receiver._manage_acquisition(band, block)
        for f in band.fsms:
            if f.state is ChannelState.TRACKING \
                    and before.get(f.channel_id) is not ChannelState.TRACKING:
                self._reset_channel_sync(band, f.channel_id - band.ch_offset)

    def _observe_phase_a(self, band: Band, per_channel) -> None:
        sx = band.cfg.suffix
        for local_ch, periods in enumerate(per_channel):
            fsm = band.fsms[local_ch]
            if fsm.state is not ChannelState.TRACKING:
                continue
            key = (sx, local_ch)
            for p in periods:
                self._period_count[sx][local_ch] += 1
                bs = self._bit_sync.get(key)
                if bs is not None and not bs.synced:
                    bs.feed(p.prompt.real)
                ss = self._sec_sync.get(key)
                if ss is not None and not ss.synced:
                    ss.feed(p.prompt.real)

    def _channel_ready(self, band: Band, local_ch: int) -> bool:
        sx = band.cfg.suffix
        min_periods = (band.cfg.pull_in_time_s * 1000.0
                       / band.tracking.cfg.code_period_s / 1000.0) + 100
        if self._period_count[sx][local_ch] < min_periods:
            return False
        key = (sx, local_ch)
        bs = self._bit_sync.get(key)
        if bs is not None and not bs.synced:
            return False
        ss = self._sec_sync.get(key)
        return ss is None or ss.synced

    def _ready_for_handoff(self) -> bool:
        rec = self.receiver
        total_tracking = 0
        for band in rec.bands:
            for f in band.fsms:
                if f.state is not ChannelState.TRACKING:
                    continue
                total_tracking += 1
                if not self._channel_ready(band, f.channel_id
                                           - band.ch_offset):
                    return False
        return total_tracking >= min(
            4, sum(b.cfg.n_channels for b in rec.bands))

    def _handoff(self, streams) -> None:
        rec = self.receiver
        self._ctx = {}
        self.handoff_sample = int(
            rec.bands[0].tracking.abs_block_start
            * rec.cfg.fs / rec.bands[0].fs)
        for band in rec.bands:
            sx = band.cfg.suffix
            ctx = _FastBandCtx(band, self.device)
            trk_cfg = band.tracking.cfg
            state = ctx.fast.from_track_state(band.tracking.state)
            k = ctx.k
            offs = state.offset.cpu().numpy().copy()
            rems = state.rem_code_phase_samples.cpu().numpy().copy()
            rcarr = state.rem_carr_phase_rad.cpu().numpy().copy()
            steps = TWO_PI * (state.carrier_doppler_hz.cpu().numpy()
                              + state.if_freq_hz.cpu().numpy()) / trk_cfg.fs
            code_freq = trk_cfg.chip_rate_cps \
                + state.code_doppler_chips.cpu().numpy().astype(np.float64)
            for f in band.fsms:
                local_ch = f.channel_id - band.ch_offset
                if f.state is not ChannelState.TRACKING:
                    continue
                count = self._period_count[sx][local_ch]
                # data-bit alignment: skip to the next group boundary
                skip = 0
                if sx == "1C":
                    into = self._bit_sync[(sx, local_ch)].periods_into_bit(
                        count)
                    skip = (k - into) % k
                if skip:
                    t_prn = trk_cfg.fs * trk_cfg.code_length_chips \
                        / code_freq[local_ch]
                    old_b = offs[local_ch] + rems[local_ch]
                    new_b = old_b + skip * t_prn
                    offs[local_ch] = math.floor(new_b)
                    rems[local_ch] = new_b - offs[local_ch]
                    rcarr[local_ch] = math.fmod(
                        rcarr[local_ch] + steps[local_ch] * (new_b - old_b),
                        TWO_PI)
                    dec = band.decoders[local_ch]
                    if dec.history:
                        # LNAV counts every symbol: placeholder feeds with
                        # the current bit's sign (production.py rationale)
                        last = dec.history[-1]
                        stamp = dec.stamps[-1] if dec.stamps else 0
                        for j in range(1, skip + 1):
                            dec.feed(last, stamp + int(round(j * t_prn)))
                    self._period_count[sx][local_ch] = count + skip
            dev = self.device
            state = state._replace(
                offset=torch.as_tensor(offs.astype(np.int32), device=dev),
                rem_code_phase_samples=torch.as_tensor(
                    rems.astype(np.float32), device=dev),
                rem_carr_phase_rad=torch.as_tensor(
                    rcarr.astype(np.float32), device=dev),
            )
            # secondary wipe-off phases
            for f in band.fsms:
                local_ch = f.channel_id - band.ch_offset
                if f.state is not ChannelState.TRACKING:
                    continue
                ss = self._sec_sync.get((sx, local_ch))
                if ss is not None and ss.synced:
                    state = ctx.fast.set_secondary(
                        state, local_ch, "".join(
                            "0" if v > 0 else "1" for v in ss.signs),
                        ss.periods_into_code(
                            self._period_count[sx][local_ch]),
                        pure_pilot=True)
            ctx.state = state
            # band ingest ring (device-resident int8, uploaded once)
            x = streams[sx] if isinstance(streams, dict) else streams
            head = np.ascontiguousarray(x[:1 << 18].real, np.float32)
            rms = float(np.sqrt(np.mean(head * head))) * np.sqrt(2.0) or 1.0
            ctx.ring = complex_to_quantized_i8(x, 16.0 / rms, self.device)
            ctx.base = band.tracking.abs_block_start
            self._ctx[sx] = ctx

    # -- phase B ----------------------------------------------------------
    def _dispatch_band(self, ctx: _FastBandCtx, nb: int):
        """Enqueue ``nb`` fast blocks of one band (asynchronous on the
        card) and return their output tensors."""
        bank = ctx.fast.get_bank(ctx.codes, ctx.data_codes)
        ctx.state, out = ctx.fast.superblock_ring_i8(
            ctx.state, ctx.ring, int(ctx.base), int(nb), bank)
        return out

    def _consume_band(self, ctx: _FastBandCtx, out, base: int) -> None:
        rec = self.receiver
        band = ctx.band
        sx = band.cfg.suffix
        kk = ctx.fast.k
        fb = ctx.fast.block_samples
        scale = rec.cfg.fs / band.fs
        t_prn_s = band.tracking.cfg.code_period_s
        packed = out["packed"].cpu().numpy()   # one device->host copy
        bb, gg, n_ch, _ = packed.shape
        p2 = packed.reshape(bb * gg, n_ch, 5 * kk + 4)
        block_base = base + np.arange(bb, dtype=np.int64)[:, None] * fb
        flat_base = np.repeat(block_base.reshape(-1), gg)
        valid = p2[:, :, 5 * kk + 2] > 0.5
        dopp = p2[:, :, 5 * kk]
        cn0 = p2[:, :, 5 * kk + 1]
        loss_any = (p2[:, :, 5 * kk + 3] > 0.5).any(axis=0)
        # symbols: the data-component prompts (real part)
        symcol = (3 * kk, 4 * kk)

        for f in band.fsms:
            local_ch = f.channel_id - band.ch_offset
            if f.state is not ChannelState.TRACKING:
                continue
            gch = f.channel_id
            rows = np.nonzero(valid[:, local_ch])[0]
            if rows.size:
                starts = (flat_base[rows, None]
                          + p2[rows, local_ch, :kk].astype(np.int64)
                          ).reshape(-1)
                rems = p2[rows, local_ch, kk:2 * kk].reshape(-1)
                symbols = p2[rows, local_ch,
                             symcol[0]:symcol[1]].reshape(-1)
                ch_dopp = np.repeat(dopp[rows, local_ch], kk)
                ch_cn0 = np.repeat(cn0[rows, local_ch], kk)
                dec = band.decoders[local_ch]
                t_int = int(round(t_prn_s * band.fs))
                stamps = starts + t_int
                n_p = starts.size
                self._period_count[sx][local_ch] += n_p
                if hasattr(dec, "feed_array"):
                    tows = dec.feed_array(symbols, stamps)
                else:
                    tows = np.full(n_p, np.nan)
                    for j in range(n_p):
                        dec.feed(float(symbols[j]), int(stamps[j]))
                        if dec.tow_at_last_symbol_ms is not None:
                            tows[j] = dec.tow_at_last_symbol_ms
                acc0 = band.tracking.acc_carrier_phase_rad[local_ch]
                acc = acc0 - TWO_PI * t_prn_s * np.cumsum(ch_dopp)
                band.tracking.acc_carrier_phase_rad[local_ch] = acc[-1]
                known = ~np.isnan(tows)
                if known.any():
                    rec.observables.add_anchors(
                        gch, (starts[known] + rems[known]) * scale,
                        tows[known] - band.period_ms,
                        ch_dopp[known], acc[known], ch_cn0[known])
                key = (band.system, f.prn)
                if dec.has_full_ephemeris() \
                        and key not in rec.ephemerides:
                    rec.ephemerides[key] = band.make_ephemeris(f.prn, dec)
            if loss_any[local_ch]:
                prn = f.loss_of_lock()
                if prn:
                    band.sat_pool.append(prn)
                rec.observables.reset_channel(gch)
                rec._chan_sat.pop(gch, None)

    def _consume(self, pending) -> None:
        """Host pass over one dispatched window of every band, then the
        PVT epochs it completes (epochs advance only over consumed
        spans: an epoch index never moves backwards)."""
        rec = self.receiver
        for c, out, base, _ in pending:
            self._consume_band(c, out, base)
        rec._run_pvt(min(
            (base + nb * c.fast.block_samples - 2 * c.fast.max_period)
            * rec.cfg.fs / c.band.fs for c, _, base, nb in pending))

    # -- run ---------------------------------------------------------------
    def run(self, streams) -> list:
        rec = self.receiver
        t0 = time.perf_counter()
        n_blocks = rec.n_blocks(streams)

        # phase A: per-block scan pipeline with sync observation
        k = 0
        while self._ctx is None and k < n_blocks:
            blk = rec.band_blocks(streams, k)
            for band in rec.bands:
                bx = blk[band.cfg.suffix]
                self._manage_acquisition(band, bx)
                per_channel = band.tracking.process_block(
                    bx[: band.block_samples + band.tracking.overlap])
                self._observe_phase_a(band, per_channel)
                rec._feed_band(band, per_channel)
            rec._run_pvt()
            k += 1
            if self._ready_for_handoff():
                self._handoff(streams)
        t_split = time.perf_counter()

        # phase B: pipelined per-band ring superblocks
        phase_b_samples = 0
        if self._ctx is not None:
            ctxs = list(self._ctx.values())
            stream_len = {c.band.cfg.suffix: len(
                streams[c.band.cfg.suffix] if isinstance(streams, dict)
                else streams) for c in ctxs}
            pending = None
            while True:
                nb = None
                for c in ctxs:
                    avail = (stream_len[c.band.cfg.suffix]
                             - c.fast.overlap - c.base) \
                        // c.fast.block_samples
                    nbc = self.blocks_per_call \
                        if avail >= self.blocks_per_call \
                        else (5 if avail >= 5 else (1 if avail >= 1 else 0))
                    nb = nbc if nb is None else min(nb, nbc)
                if not nb:
                    break
                outs = []
                for c in ctxs:
                    outs.append((c, self._dispatch_band(c, nb), c.base, nb))
                    c.base += nb * c.fast.block_samples
                if pending is not None:
                    self._consume(pending)
                pending = outs
            if pending is not None:
                self._consume(pending)
            phase_b_samples = int(
                (ctxs[0].base - ctxs[0].band.tracking.abs_block_start)
                * rec.cfg.fs / ctxs[0].band.fs)
        t_end = time.perf_counter()
        self.timings = {
            "phase_a_s": t_split - t0,
            "phase_a_samples": int(self.handoff_sample or 0),
            "phase_b_s": t_end - t_split,
            "phase_b_samples": phase_b_samples,
        }
        return rec.solutions

    @property
    def in_fast_mode(self) -> bool:
        return self._ctx is not None

    def channel_states(self):
        return self.receiver.channel_states()

    @property
    def ephemerides(self):
        return self.receiver.ephemerides
