"""Batched PCPS (Parallel Code Phase Search) acquisition.

Port of ``gnss_sdr_tpu/acquisition/pcps.py``: the whole (PRN x Doppler x
code-phase) grid of one dwell is one batched FFT circular correlation

    grid[p, d, :] = |IFFT( FFT(x * e^{-j 2 pi f_d n / fs}) * conj(FFT(c_p)) )|^2

accumulated non-coherently over dwells, with the CFAR or first-vs-second
peak statistic, the Pfa-to-threshold map, the bit-transition buffer
layout, the two-step fine-Doppler refinement and the repeat mode of
gnss-sdr's pcps_acquisition.cc. The transforms are ``torch.fft`` on
complex64 (cuFFT on the card); the parts around them are the K2 kernels
(``kernels/acq.py``). The host reads one small [3, P] record per dwell.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from scipy import special as sp_special

from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.kernels.acq import acq_stats, pcps_dwell, wipeoff_scale


@dataclasses.dataclass
class AcqConfig:
    """Acquisition parameters.

    Field-for-field analogue of ``Acq_Conf``
    (gnss-sdr/src/algorithms/acquisition/libs/acq_conf.h:33-81).
    """

    fs: float
    samples_per_code: int
    doppler_max: float = 5000.0
    doppler_step: float = 250.0
    doppler_center: float = 0.0      # assisted / FDMA-bias Doppler center [Hz]
    sampled_ms: int = 1              # coherent integration [ms]
    ms_per_code: int = 1
    max_dwells: int = 1              # non-coherent integrations
    pfa: float = 0.0                 # 0 => use explicit threshold
    threshold: float = 0.0
    bit_transition_flag: bool = False
    use_cfar: bool = True            # CFAR max/input-power vs first/second peak
    # two-step fine-Doppler search (Acq_Conf::make_2_steps)
    make_2_steps: bool = False
    doppler_step2: float = 125.0
    num_doppler_bins_step2: int = 4
    pfa2: float = 0.0
    # fork addition: re-run the narrow-grid step (Acq_Conf::make_repeat_steps,
    # acq_conf.h:74)
    repeat_steps: bool = False
    # automatic acquisition-rate resampler bookkeeping
    # (gnss_flowgraph.cc:1027-1117): delays/stamps are scaled back to the
    # pre-decimation stream.
    use_automatic_resampler: bool = False
    resampler_ratio: float = 1.0
    resampler_latency_samples: int = 0
    code_length_chips: int = 0       # for the second-peak 1-chip exclusion zone

    @property
    def samples_per_ms(self) -> int:
        return int(round(self.samples_per_code / self.ms_per_code))

    @property
    def coherent_samples(self) -> int:
        """Replica length: one coherent-integration interval."""
        return self.sampled_ms * self.samples_per_ms

    @property
    def consumed_samples(self) -> int:
        """Samples buffered per dwell (pcps_acquisition.cc:71): doubled in
        bit-transition mode so the correlation straddles one symbol edge."""
        return self.coherent_samples * (2 if self.bit_transition_flag else 1)

    @property
    def fft_size(self) -> int:
        # pcps_acquisition.cc:85-92
        if self.sampled_ms == self.ms_per_code:
            return self.consumed_samples
        return self.consumed_samples * 2

    @property
    def effective_fft_size(self) -> int:
        return self.fft_size // 2 if self.bit_transition_flag else self.fft_size

    @property
    def num_doppler_bins(self) -> int:
        # ceil(2*doppler_max / doppler_step), pcps_acquisition.cc:264
        return int(math.ceil(2.0 * self.doppler_max / self.doppler_step))

    @property
    def samples_per_chip(self) -> int:
        """Exclusion-zone width for the second-peak statistic [samples]."""
        if self.code_length_chips <= 0:
            return 1
        return max(1, int(round(self.samples_per_code / self.code_length_chips)))

    def doppler_grid(self) -> np.ndarray:
        """Coarse grid: -doppler_max + center + step*i (pcps_acquisition.cc:302)."""
        i = np.arange(self.num_doppler_bins)
        return (-self.doppler_max + self.doppler_center
                + self.doppler_step * i).astype(np.float32)

    def doppler_grid_step2(self, center: float) -> np.ndarray:
        """Narrow grid centered on the coarse estimate (:313, :500)."""
        i = np.arange(self.num_doppler_bins_step2)
        return (center + (i - math.floor(self.num_doppler_bins_step2 / 2.0))
                * self.doppler_step2).astype(np.float32)

    def calculate_threshold(self, step_two: bool = False) -> float:
        """Pfa -> detection threshold (pcps_acquisition.cc:894-910)."""
        pfa = self.pfa2 if step_two else self.pfa
        if pfa <= 0.0:
            return self.threshold
        nbins = (self.num_doppler_bins_step2 if step_two
                 else self.num_doppler_bins)
        num_cells = self.effective_fft_size * nbins
        dwells_eff = 1 if self.bit_transition_flag else self.max_dwells
        q = (1.0 - pfa) ** (1.0 / num_cells)
        return float(2.0 * sp_special.gammaincinv(2.0 * dwells_eff, q))


def host_stats(grid, row_max, row_arg, num_dwells: int,
               samples_per_chip: int, use_cfar: bool):
    """K2's per-PRN statistics of a [P, D, eff] grid and its row peaks,
    read to the host in one copy: (stat float32, index_doppler int64,
    index_time int64) numpy [P]."""
    stat, i_dop, i_time = acq_stats(grid, row_max, row_arg, num_dwells,
                                    samples_per_chip, use_cfar)
    both = torch.stack([stat.to(torch.float64), i_dop.to(torch.float64),
                        i_time.to(torch.float64)]).cpu().numpy()
    return (both[0].astype(np.float32), both[1].astype(np.int64),
            both[2].astype(np.int64))


@dataclasses.dataclass
class AcqResult:
    """Per-satellite acquisition verdict (fills GnssSynchro Acq_* fields)."""

    prn: int
    positive: bool
    test_statistic: float
    threshold: float
    delay_samples: float
    doppler_hz: float
    doppler_step: float
    samplestamp_samples: int
    grid: np.ndarray | None = None  # [D, eff] magnitude grid (dump)


class PcpsAcquisition:
    """Batched multi-satellite PCPS acquisition engine.

    ``codes`` maps PRN -> complex64 replica sampled at ``cfg.fs`` over one
    coherent-integration interval. conj(FFT) of each replica is computed
    once on the host in the reference's buffer layout (set_local_code,
    pcps_acquisition.cc:312-345)."""

    def __init__(self, cfg: AcqConfig, codes: dict[int, np.ndarray],
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.prns = sorted(codes)
        n = cfg.coherent_samples
        fft_size = cfg.fft_size
        layouts = np.zeros((len(self.prns), fft_size), dtype=np.complex64)
        for row, prn in enumerate(self.prns):
            code = np.asarray(codes[prn], dtype=np.complex64)
            if code.shape[0] != n:
                raise ValueError(
                    f"PRN {prn}: replica must have {n} samples, "
                    f"got {code.shape[0]}")
            if cfg.bit_transition_flag:
                layouts[row, fft_size // 2: fft_size // 2 + n] = code
            elif cfg.sampled_ms == cfg.ms_per_code:
                layouts[row, :] = code
            else:
                layouts[row, fft_size - n:] = code
        code_ffts = np.conj(np.fft.fft(layouts, axis=-1)).astype(np.complex64)
        self._code_fft = torch.as_tensor(code_ffts, device=self.device)
        self._dopplers_np = cfg.doppler_grid()
        self._dopplers = torch.as_tensor(self._dopplers_np,
                                         device=self.device)
        self._c0 = wipeoff_scale(cfg.fs)
        self._offset = cfg.effective_fft_size if cfg.bit_transition_flag \
            else 0
        self._eff = cfg.effective_fft_size
        self._samples_per_chip = cfg.samples_per_chip

    # -- internals --------------------------------------------------------
    def _prepare_buffer(self, samples: np.ndarray, dwell: int):
        cfg = self.cfg
        n = cfg.consumed_samples
        start = dwell * n
        seg = np.asarray(samples[start:start + n], dtype=np.complex64)
        if seg.shape[0] < cfg.fft_size:
            seg = np.pad(seg, (0, cfg.fft_size - seg.shape[0]))
        return torch.as_tensor(seg, device=self.device)

    def _stats(self, grid, row_max, row_arg, num_dwells: int):
        """(stat, index_doppler, index_time) on the host: one copy."""
        return host_stats(grid, row_max, row_arg, num_dwells,
                          self._samples_per_chip, self.cfg.use_cfar)

    def _make_result(self, prn, positive, stat, threshold, i_time,
                     doppler_hz, doppler_step, samplestamp,
                     grid=None) -> AcqResult:
        cfg = self.cfg
        # floor-convention replicas: the peak index IS the unbiased delay
        delay = float(np.fmod(np.float32(i_time),
                              np.float32(cfg.samples_per_code)))
        if cfg.use_automatic_resampler:
            delay = delay * cfg.resampler_ratio - cfg.resampler_latency_samples
            samplestamp = int(round(samplestamp * cfg.resampler_ratio))
        return AcqResult(
            prn=prn, positive=bool(positive), test_statistic=float(stat),
            threshold=float(threshold), delay_samples=delay,
            doppler_hz=float(doppler_hz), doppler_step=float(doppler_step),
            samplestamp_samples=int(samplestamp), grid=grid,
        )

    # -- public API -------------------------------------------------------
    def search(self, samples: np.ndarray, samplestamp: int = 0,
               dump_grids: bool = False) -> dict[int, AcqResult]:
        """Run a full acquisition (all dwells, optional two-step) on a
        buffer of at least ``max_dwells * consumed_samples`` samples
        (fewer reduce the dwell count). One AcqResult per PRN."""
        cfg = self.cfg
        threshold = cfg.calculate_threshold(step_two=False)
        avail_dwells = max(1, min(cfg.max_dwells,
                                  len(samples) // cfg.consumed_samples))
        dopplers = self._dopplers_np
        grid = None
        decided: dict[int, AcqResult] = {}
        pending = list(self.prns)
        for dwell in range(avail_dwells):
            x = self._prepare_buffer(samples, dwell)
            grid, row_max, row_arg = pcps_dwell(
                x, self._code_fft, self._dopplers, self._c0, self._offset,
                self._eff, grid)
            stat, i_dop, i_time = self._stats(grid, row_max, row_arg,
                                              dwell + 1)
            doppler_hz = dopplers[i_dop]
            last = dwell == avail_dwells - 1
            for row, prn in enumerate(self.prns):
                if prn not in pending:
                    continue
                if stat[row] > threshold or last:
                    positive = bool(stat[row] > threshold)
                    if positive:
                        pending.remove(prn)
                    decided[prn] = self._make_result(
                        prn, positive, stat[row], threshold, i_time[row],
                        doppler_hz[row], cfg.doppler_step, samplestamp,
                        grid=grid[row].cpu().numpy() if dump_grids else None)
        if cfg.make_2_steps:
            n_refines = 2 if cfg.repeat_steps else 1
            for prn in list(decided):
                res = decided[prn]
                if not res.positive:
                    continue
                for _ in range(n_refines):
                    res = self._refine(samples, res, samplestamp, dump_grids)
                decided[prn] = res
        return decided

    def _refine(self, samples: np.ndarray, coarse: AcqResult,
                samplestamp: int, dump_grids: bool) -> AcqResult:
        """Two-step narrow-grid Doppler refinement
        (pcps_acquisition.cc:717-771)."""
        cfg = self.cfg
        threshold2 = cfg.calculate_threshold(step_two=True)
        dopplers2 = cfg.doppler_grid_step2(coarse.doppler_hz)
        row = self.prns.index(coarse.prn)
        cf = self._code_fft[row:row + 1]
        d2 = torch.as_tensor(dopplers2, device=self.device)
        grid = None
        avail_dwells = max(1, min(cfg.max_dwells,
                                  len(samples) // cfg.consumed_samples))
        for dwell in range(avail_dwells):
            x = self._prepare_buffer(samples, dwell)
            grid, row_max, row_arg = pcps_dwell(
                x, cf, d2, self._c0, self._offset, self._eff, grid)
        stat, i_dop, i_time = self._stats(grid, row_max, row_arg,
                                          avail_dwells)
        stat = float(stat[0])
        doppler_hz = float(dopplers2[int(i_dop[0])])
        positive = stat > threshold2
        result = self._make_result(
            coarse.prn, positive, stat, threshold2, int(i_time[0]),
            doppler_hz if positive else coarse.doppler_hz,
            cfg.doppler_step2, samplestamp,
            grid=grid[0].cpu().numpy() if dump_grids else None)
        if not positive:
            # failed refinement falls back to the coarse verdict
            result = dataclasses.replace(coarse,
                                         doppler_step=cfg.doppler_step)
        return result
