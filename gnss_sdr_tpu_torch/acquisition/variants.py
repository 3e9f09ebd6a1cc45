"""Alternative acquisition search strategies: QuickSync, CCCWSR and the
Galileo E5a noncoherent I/Q search with the CAF Doppler filter.

Port of ``gnss_sdr_tpu/acquisition/variants.py`` (the reference's
pcps_quicksync_acquisition_cc.cc, pcps_cccwsr_acquisition_cc.cc and
galileo_e5a_noncoherent_iq_acquisition_caf_cc.cc). Each search is one
batched (PRN x Doppler x code-phase) grid of ``torch.fft`` transforms and
hand kernels (``kernels/acq_variants.py``: K5a's folding wipe-off for
QuickSync, K5b's sign-recovery combine for CCCWSR; K2 for the rest of
both and for the I/Q grids), whose per-PRN statistics come to the host in
one copy; QuickSync's delay disambiguation and the CAF refinement run on
the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sdr_tpu_torch.acquisition.pcps import (AcqConfig, AcqResult,
                                                 PcpsAcquisition, host_stats)
from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.kernels.acq import pcps_dwell, wipeoff_scale
from gnss_sdr_tpu_torch.kernels.acq_variants import cccwsr_grid, folded_grid


def _segment(samples: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` samples as complex64, zero-padded to ``n``."""
    seg = np.asarray(samples[:n], dtype=np.complex64)
    if seg.shape[0] < n:
        seg = np.pad(seg, (0, n - seg.shape[0]))
    return seg


class QuickSyncAcquisition:
    """S-fold PCPS: the FFT length drops from N to N/S at ~10 log10(S) dB
    sensitivity cost; the code phase comes out modulo N/S and is
    disambiguated by testing the S candidate delays with direct
    correlations against the unfolded replica on the host
    (pcps_quicksync_acquisition_cc 'folding_factor' semantics)."""

    def __init__(self, cfg: AcqConfig, codes: dict[int, np.ndarray],
                 folding_factor: int = 2, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.prns = sorted(codes)
        self.folding_factor = int(folding_factor)
        n = cfg.coherent_samples
        if n % self.folding_factor:
            raise ValueError("folding factor must divide the coherent length")
        self.n_folded = n // self.folding_factor
        folded = np.zeros((len(self.prns), self.n_folded), dtype=np.complex64)
        self._full_codes = {}
        for row, prn in enumerate(self.prns):
            code = np.asarray(codes[prn], dtype=np.complex64)
            if code.shape[0] != n:
                raise ValueError(f"PRN {prn}: replica must have {n} samples")
            folded[row] = code.reshape(self.folding_factor, -1).sum(axis=0)
            self._full_codes[prn] = code
        code_ffts = np.conj(np.fft.fft(folded, axis=-1)).astype(np.complex64)
        self._code_fft = torch.as_tensor(code_ffts, device=self.device)
        self._dopplers_np = cfg.doppler_grid()
        self._dopplers = torch.as_tensor(self._dopplers_np,
                                         device=self.device)
        self._c0 = wipeoff_scale(cfg.fs)

    def search(self, samples: np.ndarray, samplestamp: int = 0
               ) -> dict[int, AcqResult]:
        cfg = self.cfg
        n = cfg.coherent_samples
        seg = _segment(samples, n)
        grid, row_max, row_arg = folded_grid(
            torch.as_tensor(seg, device=self.device), self._code_fft,
            self._dopplers, self._c0, self.folding_factor)
        stat, i_dop, i_time = host_stats(grid, row_max, row_arg, 1,
                                         cfg.samples_per_chip, cfg.use_cfar)
        threshold = cfg.calculate_threshold()
        t = np.arange(n, dtype=np.float64)
        out: dict[int, AcqResult] = {}
        for row, prn in enumerate(self.prns):
            doppler = float(self._dopplers_np[i_dop[row]])
            # disambiguate the delay among the S candidates (S dots)
            wipe = seg * np.exp(-2j * np.pi * doppler / cfg.fs * t)
            best_mag, best_delay = -1.0, 0
            for k in range(self.folding_factor):
                delay = int(i_time[row]) + k * self.n_folded
                rolled = np.roll(self._full_codes[prn], delay)
                mag = abs(np.vdot(rolled, wipe))
                if mag > best_mag:
                    best_mag, best_delay = mag, delay
            out[prn] = AcqResult(
                prn=prn, positive=bool(stat[row] > threshold),
                test_statistic=float(stat[row]), threshold=float(threshold),
                delay_samples=float(best_delay % cfg.samples_per_code),
                doppler_hz=doppler, doppler_step=cfg.doppler_step,
                samplestamp_samples=int(samplestamp))
        return out


class CccwsrAcquisition:
    """Data + pilot coherent-combining acquisition (Galileo E1 B + C): the
    relative sign of the E1-B data chip and the E1-C secondary chip is
    unknown at acquisition, so both signs are tested and the larger
    magnitude kept (pcps_cccwsr_acquisition_cc.cc core idea)."""

    def __init__(self, cfg: AcqConfig, data_codes: dict[int, np.ndarray],
                 pilot_codes: dict[int, np.ndarray], device="cuda"):
        if sorted(data_codes) != sorted(pilot_codes):
            raise ValueError("data and pilot PRN sets must match")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.prns = sorted(data_codes)
        n = cfg.coherent_samples
        fb = np.zeros((len(self.prns), n), dtype=np.complex64)
        fc = np.zeros_like(fb)
        for row, prn in enumerate(self.prns):
            fb[row] = np.asarray(data_codes[prn], dtype=np.complex64)
            fc[row] = np.asarray(pilot_codes[prn], dtype=np.complex64)

        def spectra(codes):
            return torch.as_tensor(np.conj(np.fft.fft(codes, axis=-1))
                                   .astype(np.complex64), device=self.device)

        self._cb, self._cc = spectra(fb), spectra(fc)
        self._dopplers_np = cfg.doppler_grid()
        self._dopplers = torch.as_tensor(self._dopplers_np,
                                         device=self.device)
        self._c0 = wipeoff_scale(cfg.fs)

    def search(self, samples: np.ndarray, samplestamp: int = 0
               ) -> dict[int, AcqResult]:
        cfg = self.cfg
        seg = _segment(samples, cfg.coherent_samples)
        grid, row_max, row_arg = cccwsr_grid(
            torch.as_tensor(seg, device=self.device), self._cb, self._cc,
            self._dopplers, self._c0)
        stat, i_dop, i_time = host_stats(grid, row_max, row_arg, 1,
                                         cfg.samples_per_chip, cfg.use_cfar)
        threshold = cfg.calculate_threshold()
        return {
            prn: AcqResult(
                prn=prn, positive=bool(stat[row] > threshold),
                test_statistic=float(stat[row]), threshold=float(threshold),
                delay_samples=float(int(i_time[row]) % cfg.samples_per_code),
                doppler_hz=float(self._dopplers_np[i_dop[row]]),
                doppler_step=cfg.doppler_step,
                samplestamp_samples=int(samplestamp))
            for row, prn in enumerate(self.prns)
        }


class NoncoherentIQCafAcquisition:
    """Galileo E5a noncoherent I/Q acquisition with the CAF Doppler filter
    (galileo_e5a_noncoherent_iq_acquisition_caf_cc.cc): the E5a-I (data)
    and E5a-Q (pilot) codes are correlated separately (two K2 grids per
    dwell) and their magnitude grids summed noncoherently
    (``both_signal_components``, :117-138, :538-546); with
    ``caf_window_hz > 0`` the Doppler is refined on the host by smoothing
    each PRN's per-bin peak profile with the reference's triangular CAF
    window (weights 1 - 0.5|di|/half, edge-normalized, :599-661)."""

    def __init__(self, cfg: AcqConfig, data_codes: dict[int, np.ndarray],
                 pilot_codes: dict[int, np.ndarray],
                 both_signal_components: bool = True,
                 caf_window_hz: float = 0.0, device="cuda"):
        self.cfg = cfg
        self.prns = sorted(data_codes)
        self.both = both_signal_components
        self.caf_window_hz = float(caf_window_hz)
        self._eng_i = PcpsAcquisition(cfg, data_codes, device=device)
        self._eng_q = PcpsAcquisition(cfg, pilot_codes, device=device) \
            if both_signal_components else None

    def _caf_refine(self, prof: np.ndarray, dopplers: np.ndarray
                    ) -> np.ndarray:
        """Per-PRN refined Doppler from the triangular-weighted moving
        average of the per-bin peak magnitudes ``prof`` [P, D]."""
        half = int(self.caf_window_hz / (2.0 * self.cfg.doppler_step))
        if half < 1:
            return dopplers[np.argmax(prof, axis=-1)]
        w = 0.5 / half
        offs = np.arange(-half, half + 1)
        weights = 1.0 - w * np.abs(offs)
        smoothed = np.empty_like(prof)
        d_bins = prof.shape[1]
        for d in range(d_bins):
            lo = max(0, d - half)
            hi = min(d_bins, d + half + 1)
            ww = weights[(lo - d + half):(hi - d + half)]
            smoothed[:, d] = prof[:, lo:hi] @ ww / ww.sum()
        return dopplers[np.argmax(smoothed, axis=-1)]

    def search(self, samples: np.ndarray, samplestamp: int = 0
               ) -> dict[int, AcqResult]:
        cfg = self.cfg
        dwells = max(1, min(cfg.max_dwells,
                            len(samples) // cfg.consumed_samples))
        grid = None
        engines = [e for e in (self._eng_i, self._eng_q) if e is not None]
        for dwell in range(dwells):
            x = self._eng_i._prepare_buffer(samples, dwell)
            for eng in engines:
                grid, row_max, row_arg = pcps_dwell(
                    x, eng._code_fft, eng._dopplers, eng._c0, eng._offset,
                    eng._eff, grid)
        stat, i_dop, i_time = host_stats(grid, row_max, row_arg, dwells,
                                         cfg.samples_per_chip, cfg.use_cfar)
        dopplers = self._eng_i._dopplers_np
        dopp = dopplers[i_dop].astype(float)
        if self.caf_window_hz > 0:
            # the per-bin peak profile is K2's row peaks
            dopp = self._caf_refine(row_max.cpu().numpy(), dopplers)
        threshold = cfg.calculate_threshold()
        return {
            prn: AcqResult(
                prn=prn, positive=bool(stat[row] > threshold),
                test_statistic=float(stat[row]), threshold=float(threshold),
                delay_samples=float(int(i_time[row]) % cfg.samples_per_code),
                doppler_hz=float(np.atleast_1d(dopp)[row]),
                doppler_step=cfg.doppler_step,
                samplestamp_samples=int(samplestamp))
            for row, prn in enumerate(self.prns)
        }
