"""Tong sequential-detection acquisition.

Port of ``gnss_sdr_tpu/acquisition/tong.py`` (the reference's
pcps_tong_acquisition_cc.cc): per one-code-period dwell the PCPS
magnitude grid (K2) is divided by that dwell's input power (:283-286,
:312-317) and accumulated on the device; a counting detector per PRN
walks up on ``peak > threshold * dwell_count`` (+1, positive at
``tong_max_val``) or down (-1, negative at 0), with a ``tong_max_dwells``
cap forcing a negative (:352-371). All PRNs share one batched grid per
dwell; the counters are host state, and the host reads each PRN's peak
and its flat index once per dwell.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sdr_tpu_torch.acquisition.pcps import (AcqConfig, AcqResult,
                                                 PcpsAcquisition)
from gnss_sdr_tpu_torch.kernels.acq import TINY, pcps_magnitude_grid


class TongAcquisition:
    """Sequential (Tong) detector over the batched PCPS magnitude grid."""

    def __init__(self, cfg: AcqConfig, codes: dict[int, np.ndarray],
                 tong_init_val: int = 1, tong_max_val: int = 2,
                 tong_max_dwells: int | None = None,
                 threshold: float | None = None, device="cuda"):
        self._pcps = PcpsAcquisition(cfg, codes, device=device)
        self.cfg = cfg
        self.prns = self._pcps.prns
        self.tong_init_val = int(tong_init_val)
        self.tong_max_val = int(tong_max_val)
        self.tong_max_dwells = int(tong_max_dwells
                                   if tong_max_dwells is not None
                                   else tong_max_val + 1)
        # the reference Tong adapter takes an absolute threshold on the
        # power-normalized accumulated peak; the Pfa-derived per-cell
        # threshold when none is given
        self.threshold = float(threshold if threshold is not None
                               else cfg.calculate_threshold())
        self.reset()

    def reset(self) -> None:
        """set_state(1) semantics (:188-207): zero the accumulated grid
        and reinitialize every counter."""
        self._grid_acc = None
        self.dwell_count = 0
        self.tong_count = {p: self.tong_init_val for p in self.prns}
        self.decided: dict[int, AcqResult] = {}

    def process_dwell(self, samples: np.ndarray, samplestamp: int = 0
                      ) -> dict[int, AcqResult]:
        """Feed one ``consumed_samples`` dwell; returns the PRNs decided
        on this dwell (positive or negative). Undecided PRNs keep
        counting."""
        cfg = self.cfg
        eng = self._pcps
        x = eng._prepare_buffer(samples, 0)
        # input power = mean |x|^2 over the FFT buffer (:283-286)
        input_power = torch.mean(x.real * x.real + x.imag * x.imag)
        g = pcps_magnitude_grid(x, eng._code_fft, eng._dopplers, eng._c0,
                                eng._offset, eng._eff) \
            / torch.clamp(input_power, min=TINY)
        self._grid_acc = g if self._grid_acc is None else self._grid_acc + g
        self.dwell_count += 1

        p, d, eff = self._grid_acc.shape
        flat = self._grid_acc.reshape(p, -1)
        idx = torch.argmax(flat, dim=-1)
        peak = torch.gather(flat, -1, idx[:, None])[:, 0]
        both = torch.stack([peak.to(torch.float64),
                            idx.to(torch.float64)]).cpu().numpy()
        peak = both[0].astype(np.float32)
        idx = both[1].astype(np.int64)
        dopplers = eng._dopplers_np

        new: dict[int, AcqResult] = {}
        gate = self.threshold * self.dwell_count
        for row, prn in enumerate(self.prns):
            if prn in self.decided:
                continue
            if peak[row] > gate:
                self.tong_count[prn] += 1
                positive = self.tong_count[prn] >= self.tong_max_val
            else:
                self.tong_count[prn] -= 1
                positive = False
            negative = (self.tong_count[prn] <= 0
                        or self.dwell_count >= self.tong_max_dwells) \
                and not positive
            if positive or negative:
                res = eng._make_result(
                    prn, positive, peak[row], gate, idx[row] % eff,
                    dopplers[idx[row] // eff], cfg.doppler_step, samplestamp)
                self.decided[prn] = res
                new[prn] = res
        return new

    def search(self, samples: np.ndarray, samplestamp: int = 0
               ) -> dict[int, AcqResult]:
        """Feed consecutive dwells from a buffer until every PRN is
        decided or the samples run out."""
        n = self.cfg.consumed_samples
        pos = 0
        while len(self.decided) < len(self.prns) \
                and pos + n <= len(samples) \
                and self.dwell_count < self.tong_max_dwells:
            self.process_dwell(samples[pos: pos + n], samplestamp + pos)
            pos += n
        return dict(self.decided)
