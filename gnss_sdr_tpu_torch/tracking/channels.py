"""Host-side multi-channel tracking wrapper.

Port of ``gnss_sdr_tpu/tracking/channels.py``: owns the 64-bit absolute
bookkeeping the device program avoids (sample counters, accumulated
carrier phase) and the acquisition-to-tracking pull-in alignment
(gnss-sdr dll_pll_veml_tracking.cc:1813-1844), and expands the engine's
packed per-period record into ``Gnss_Synchro``-like rows. Each call
copies exactly one packed record from the device to the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig, TrackingEngine

TWO_PI = 2.0 * math.pi


@dataclasses.dataclass
class PeriodOutput:
    """One PRN period's tracking output (a Gnss_Synchro row)."""

    channel: int
    prn: int
    sample_start: int            # absolute sample index of period start
    length: int
    rem_code_phase_samples: float
    prompt: complex
    corr: np.ndarray             # all taps [T]
    carrier_doppler_hz: float
    code_freq_chips: float
    acc_carrier_phase_rad: float  # accumulated (64-bit, host)
    cn0_db_hz: float
    carrier_lock_test: float
    evm: float
    loss_of_lock: bool
    #: data-component prompt (== prompt unless cfg.track_pilot;
    #: dll_pll d_correlator_data role)
    data_prompt: complex = 0j


class TrackingChannels:
    """N tracking channels over a block-streamed sample source."""

    def __init__(self, cfg: TrackingConfig, n_channels: int,
                 block_samples: int, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine = TrackingEngine(cfg, n_channels, block_samples,
                                     device=self.device)
        self.state = self.engine.init_state()
        self.n_channels = n_channels
        self.block_samples = block_samples
        self.overlap = self.engine.overlap
        self.abs_block_start = 0  # absolute sample index of next block
        self._code_tables = np.zeros(
            (n_channels, cfg.code_length_chips * cfg.code_samples_per_chip),
            dtype=np.float32)
        self._code_tables_dev = torch.as_tensor(self._code_tables,
                                                device=self.device)
        if cfg.track_pilot:
            self._data_code_tables = np.zeros_like(self._code_tables)
            self._data_code_tables_dev = torch.as_tensor(
                self._data_code_tables, device=self.device)
        else:
            self._data_code_tables = None
            self._data_code_tables_dev = None
        self.prn = [0] * n_channels
        self.acc_carrier_phase_rad = np.zeros(n_channels, dtype=np.float64)

    # -- channel management ------------------------------------------------
    def start_channel(self, ch: int, prn: int, code_table: np.ndarray,
                      acq_delay_samples: float, acq_doppler_hz: float,
                      acq_samplestamp: int, if_freq_hz: float = 0.0,
                      data_code_table: np.ndarray | None = None) -> None:
        """Assign a satellite to channel ``ch`` after positive acquisition:
        skip to the first code-period boundary at or after the next block
        start. ``acq_delay_samples`` is the code phase at
        ``acq_samplestamp``; ``data_code_table`` is the data component's
        code of a pilot-tracked channel."""
        cfg = self.cfg
        t_prn_samples = cfg.fs * cfg.code_length_chips / cfg.chip_rate_cps
        delta = (self.abs_block_start - acq_samplestamp) - acq_delay_samples
        acq_code_phase = t_prn_samples - math.fmod(delta, t_prn_samples)
        if acq_code_phase >= t_prn_samples:
            acq_code_phase -= t_prn_samples
        offset = int(round(acq_code_phase))
        self._code_tables[ch] = code_table.astype(np.float32)
        self._code_tables_dev = torch.as_tensor(self._code_tables,
                                                device=self.device)
        if cfg.track_pilot:
            if data_code_table is None:
                raise ValueError("track_pilot channels need data_code_table")
            self._data_code_tables[ch] = data_code_table.astype(np.float32)
            self._data_code_tables_dev = torch.as_tensor(
                self._data_code_tables, device=self.device)
        self.state = self.engine.start_channel(
            self.state, ch, acq_doppler_hz, offset,
            int(round(t_prn_samples)), if_freq_hz=if_freq_hz)
        self.prn[ch] = prn
        self.acc_carrier_phase_rad[ch] = 0.0

    def stop_channel(self, ch: int) -> None:
        self.state = self.engine.stop_channel(self.state, ch)
        self.prn[ch] = 0

    def enable_extended(self, ch: int, periods_into_group: int = 0) -> None:
        """Enable extended coherent integration for a channel (host-side
        state-machine decision after bit sync)."""
        self.state = self.engine.set_extended(
            self.state, ch, periods_into_group)

    @property
    def active_mask(self) -> np.ndarray:
        return self.state.active.cpu().numpy()

    # -- streaming ---------------------------------------------------------
    def process_block(self, block: np.ndarray) -> list[list[PeriodOutput]]:
        """Track one block (block_samples + overlap input samples); per
        channel lists of period outputs with absolute sample stamps."""
        block_start = self.abs_block_start
        block = np.asarray(block)
        re = torch.as_tensor(np.ascontiguousarray(block.real, np.float32),
                             device=self.device)
        im = torch.as_tensor(np.ascontiguousarray(block.imag, np.float32),
                             device=self.device)
        self.state, out = self.engine.process_block(
            self.state, re, im, self._code_tables_dev,
            self._data_code_tables_dev)
        self.abs_block_start += self.block_samples
        return self._emit(out["packed"].cpu().numpy(), block_start)

    def process_superblock_ring(self, ring_dev, base: int, n_blocks: int
                                ) -> list[list[PeriodOutput]]:
        """Track ``n_blocks`` blocks read on the device from a resident
        planar int8 ring [2, L]; ``base`` is the ring index of the first
        block (the absolute sample index when the ring holds the whole
        capture)."""
        abs_base = self.abs_block_start
        bs = self.block_samples
        self.state, out = self.engine.superblock_ring_i8(
            self.state, ring_dev, int(base), int(n_blocks),
            self._code_tables_dev, self._data_code_tables_dev)
        self.abs_block_start += n_blocks * bs
        packed = out["packed"].cpu().numpy()   # ONE device->host copy
        results: list[list[PeriodOutput]] = [
            [] for _ in range(self.n_channels)]
        for b in range(n_blocks):
            for ch, lst in enumerate(self._emit(packed[b], abs_base + b * bs)):
                results[ch].extend(lst)
        return results

    def _emit(self, packed: np.ndarray,
              block_start: int) -> list[list[PeriodOutput]]:
        """Expand the engine's packed per-period record [S, C, W] into
        PeriodOutput rows (layout at ``TrackingEngine._step``)."""
        results: list[list[PeriodOutput]] = [[] for _ in range(self.n_channels)]
        n_taps = self.cfg.n_taps
        chip_rate = self.cfg.chip_rate_cps
        for step in range(packed.shape[0]):
            row = packed[step]
            for ch in np.nonzero(row[:, 0] > 0.5)[0]:
                r = row[ch]
                self.acc_carrier_phase_rad[ch] -= float(r[10])
                results[ch].append(PeriodOutput(
                    channel=int(ch),
                    prn=self.prn[ch],
                    sample_start=block_start + int(r[1]),
                    length=int(r[2]),
                    rem_code_phase_samples=float(r[3]),
                    prompt=complex(r[4], r[5]),
                    data_prompt=complex(r[6], r[7]),
                    corr=(r[15:15 + n_taps]
                          + 1j * r[15 + n_taps:15 + 2 * n_taps]),
                    carrier_doppler_hz=float(r[8]),
                    code_freq_chips=chip_rate + float(r[9]),
                    acc_carrier_phase_rad=float(
                        self.acc_carrier_phase_rad[ch]),
                    cn0_db_hz=float(r[11]),
                    carrier_lock_test=float(r[12]),
                    evm=float(r[13]),
                    loss_of_lock=bool(r[14] > 0.5),
                ))
        return results
