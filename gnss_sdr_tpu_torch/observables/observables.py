"""Common-reception-time observables.

Counterpart of the reference's ``hybrid_observables_gs``
(gnss-sdr/src/algorithms/observables/gnuradio_blocks/
hybrid_observables_gs.cc): a receiver-clock channel ticks every
``interval_ms`` (the reference's gnss_sdr_sample_counter wired at
gnss_flowgraph.cc:835); at each tick every channel's transmit TOW /
Doppler / carrier phase is linearly interpolated between the two adjacent
PRN-period boundaries (interp_trk_obs, :407-500) and the pseudorange is
formed against a common receiver TOW that starts at
ceil(max interpolated TOW) and advances with the sample clock
(update_TOW :512-548, pseudorange computation :560-575 with the
+-302400000 ms week-rollover guard).

Anchor model: tracking emits, per PRN period, the exact (fractional)
sample of a code-period boundary and the decoder's TOW at that boundary —
TOW spacing between anchors is exactly one code period of SV time, while
sample spacing varies with code Doppler.

Anchors are stored as per-channel column arrays (not per-anchor Python
objects): the production receiver delivers them in ~1000/s/channel bursts
via :meth:`add_anchors`, and per-object host overhead at that rate would
dominate the steady-state budget (the reference pays the same cost as
`Gnss_circular_deque` ring buffers, gnss_circular_deque.h).

Copied from ``gnss_sdr_tpu/observables/observables.py``; only the import paths differ.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from gnss_sdr_tpu_torch.constants.general import MS_PER_WEEK, SPEED_OF_LIGHT_M_MS


@dataclasses.dataclass
class ChannelEpoch:
    """Interpolated per-channel measurement at one RX epoch."""

    prn: int
    channel: int
    tow_ms: float                # interpolated transmit TOW [ms]
    pseudorange_m: float
    doppler_hz: float
    carrier_phase_rad: float
    cn0_db_hz: float
    rx_tow_ms: float             # common receiver TOW of this epoch [ms]
    sample: int                  # absolute RX sample of this epoch


L1_WAVELENGTH_M = 299_792_458.0 / 1575.42e6

_COLS = 5  # sample, tow_ms, doppler_hz, carrier_phase_rad, cn0_db_hz


class _AnchorBuf:
    """Per-channel anchor columns with amortized append and head trim."""

    def __init__(self, cap: int = 256):
        self._data = np.zeros((cap, _COLS), dtype=np.float64)
        self.lo = 0      # first valid row
        self.hi = 0      # one past last valid row

    def __len__(self) -> int:
        return self.hi - self.lo

    def clear(self) -> None:
        self.lo = self.hi = 0

    def append(self, rows: np.ndarray) -> None:
        n = rows.shape[0]
        if self.hi + n > self._data.shape[0]:
            live = self._data[self.lo:self.hi]
            need = live.shape[0] + n
            cap = max(self._data.shape[0], 256)
            while cap < 2 * need:
                cap *= 2
            newd = np.zeros((cap, _COLS), dtype=np.float64)
            newd[:live.shape[0]] = live
            self._data = newd
            self.hi -= self.lo
            self.lo = 0
        self._data[self.hi:self.hi + n] = rows
        self.hi += n

    def trim_below(self, sample: float) -> None:
        """Drop anchors strictly below ``sample``, keeping one (the
        bracketing 'lo' anchor future epochs still interpolate from)."""
        view = self._data[self.lo:self.hi, 0]
        k = int(np.searchsorted(view, sample, side="right"))
        if k > 1:
            self.lo += k - 1

    @property
    def samples(self) -> np.ndarray:
        return self._data[self.lo:self.hi, 0]

    def row(self, i: int) -> np.ndarray:
        return self._data[self.lo + i]


class ObservablesEngine:
    def __init__(self, fs: float, interval_ms: int = 20,
                 n_channels: int = 12, history: int = 64,
                 enable_carrier_smoothing: bool = False,
                 smoothing_factor: int = 200):
        self.fs = float(fs)
        self.interval_ms = int(interval_ms)
        self.interval_samples = self.fs * interval_ms * 1e-3
        self.n_channels = n_channels
        # Hatch-filter carrier smoothing (the reference's
        # Obs_Conf::enable_carrier_smoothing / smoothing_factor,
        # hybrid_observables_gs.cc smooth_pseudoranges)
        self.enable_carrier_smoothing = enable_carrier_smoothing
        self.smoothing_factor = smoothing_factor
        self._smooth: list[tuple[float, float, int] | None] = [
            None] * n_channels  # (smoothed_pr, phase_rad, count)
        # per-channel carrier wavelength for the phase->range conversion
        # (GLONASS FDMA slots and L5/E5a differ from L1 by percents —
        # enough to drift a Hatch filter by meters per smoothing window)
        self._wavelength = [L1_WAVELENGTH_M] * n_channels
        self._anchors = [_AnchorBuf() for _ in range(n_channels)]
        self._next_epoch_sample = 0.0
        self._epoch_index = 0
        self._fix_tow_ms: float | None = None   # rx TOW at epoch _fix_index
        self._fix_index = 0

    def reset_channel(self, ch: int) -> None:
        self._anchors[ch].clear()
        self._smooth[ch] = None

    def set_channel_carrier(self, ch: int, carrier_hz: float) -> None:
        """Set the channel's carrier (satellite assignment time) so the
        Hatch filter converts phase with the right wavelength."""
        self._wavelength[ch] = 299_792_458.0 / float(carrier_hz)

    def _smooth_pr(self, ch: int, pr: float, phase_rad: float) -> float:
        """Hatch filter: blend the code pseudorange with the carrier-phase
        range increment (range change = lambda/2pi * delta acc_phase, with
        our acc_carrier_phase convention acc -= 2*pi*f_d*T)."""
        prev = self._smooth[ch]
        if prev is None:
            self._smooth[ch] = (pr, phase_rad, 1)
            return pr
        pr_prev, phase_prev, count = prev
        pred = pr_prev + (phase_rad - phase_prev) * (
            self._wavelength[ch] / (2.0 * math.pi))
        alpha = 1.0 / min(count + 1, self.smoothing_factor)
        pr_s = alpha * pr + (1.0 - alpha) * pred
        self._smooth[ch] = (pr_s, phase_rad, count + 1)
        return pr_s

    def add_anchor(self, ch: int, sample: float, tow_ms: float,
                   doppler_hz: float, carrier_phase_rad: float,
                   cn0_db_hz: float) -> None:
        """Register a code-boundary anchor (one per tracked PRN period)."""
        self._anchors[ch].append(np.array(
            [[sample, tow_ms, doppler_hz, carrier_phase_rad, cn0_db_hz]],
            dtype=np.float64))

    def add_anchors(self, ch: int, samples, tow_ms, doppler_hz,
                    carrier_phase_rad, cn0_db_hz) -> None:
        """Bulk anchor registration (steady-state superblock path): all
        arguments are same-length 1-D arrays in time order."""
        rows = np.stack([
            np.asarray(samples, dtype=np.float64),
            np.asarray(tow_ms, dtype=np.float64),
            np.asarray(doppler_hz, dtype=np.float64),
            np.asarray(carrier_phase_rad, dtype=np.float64),
            np.asarray(cn0_db_hz, dtype=np.float64)], axis=1)
        self._anchors[ch].append(rows)

    # -- interpolation (interp_trk_obs equivalent) ------------------------
    def _interp(self, ch: int, sample: float) -> np.ndarray | None:
        """Interpolated [sample, tow, dopp, phase, cn0] row at ``sample``
        or None when not bracketed by anchors."""
        buf = self._anchors[ch]
        if len(buf) < 2:
            return None
        ss = buf.samples
        if not ss[0] <= sample <= ss[-1]:
            return None
        k = int(np.searchsorted(ss, sample, side="right"))
        if k == 0:
            return None
        if k >= len(buf):
            k = len(buf) - 1
        lo = buf.row(k - 1)
        hi = buf.row(k)
        f = (sample - lo[0]) / max(hi[0] - lo[0], 1e-9)
        out = lo + f * (hi - lo)
        out[0] = sample
        out[4] = lo[4]
        return out

    # -- epochs -----------------------------------------------------------
    def epochs_until(self, sample_limit: int) -> list[list[ChannelEpoch]]:
        """Produce all RX epochs whose tick sample is below the limit
        (i.e. fully covered by the data delivered so far)."""
        out = []
        while self._next_epoch_sample < sample_limit:
            s = self._next_epoch_sample
            epoch_idx = self._epoch_index
            self._next_epoch_sample += self.interval_samples
            self._epoch_index += 1
            interps = {}
            for ch in range(self.n_channels):
                a = self._interp(ch, s)
                if a is not None:
                    interps[ch] = a
            if not interps:
                continue
            if self._fix_tow_ms is None:
                # first fix of the receiver clock: round the latest channel
                # TOW up to the epoch grid (update_TOW :512); thereafter the
                # RX clock advances with the sample counter, even across
                # epochs with no valid channels
                max_tow = max(a[1] for a in interps.values())
                self._fix_tow_ms = (
                    (int(max_tow) // self.interval_ms + 1) * self.interval_ms)
                self._fix_index = epoch_idx
            rx_tow_ms = (self._fix_tow_ms
                         + (epoch_idx - self._fix_index) * self.interval_ms
                         ) % MS_PER_WEEK
            rows = []
            for ch, a in interps.items():
                dt_ms = rx_tow_ms - a[1]
                # week rollover guard (hybrid_observables_gs.cc:560-575)
                if dt_ms > MS_PER_WEEK / 2:
                    dt_ms -= MS_PER_WEEK
                elif dt_ms < -MS_PER_WEEK / 2:
                    dt_ms += MS_PER_WEEK
                pr = dt_ms * SPEED_OF_LIGHT_M_MS
                if self.enable_carrier_smoothing:
                    pr = self._smooth_pr(ch, pr, a[3])
                rows.append(ChannelEpoch(
                    prn=0, channel=ch, tow_ms=a[1],
                    pseudorange_m=pr,
                    doppler_hz=a[2],
                    carrier_phase_rad=a[3],
                    cn0_db_hz=a[4],
                    rx_tow_ms=rx_tow_ms, sample=int(s)))
            out.append(rows)
        # consumed anchors are dead weight: drop everything below the next
        # epoch tick (keeping the bracketing anchor)
        for buf in self._anchors:
            if len(buf) > 1:
                buf.trim_below(self._next_epoch_sample)
        return out
