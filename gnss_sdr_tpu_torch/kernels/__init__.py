"""Hand-written Hopper kernels of the receiver's main path.

Each kernel has a CUDA C++ source in ``csrc/`` with a plain C launcher,
compiled by ``nvcc`` for ``sm_90a`` at first use into ``build/kernels/``
at the repository root (git-ignored) and loaded with ``ctypes``. Every
wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on the card; nothing falls back.

``LAUNCHES`` counts kernel launches per kernel name: a wrapper adds one
where it launches its kernel and nowhere else, so a run can show which
kernels the main path went through.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {
    "multicorr": 0,     # K3: scan-engine per-period correlator
    "multicorr_hd": 0,  # K3-hd: quadratic code / carrier phase correlator
    "bank_corr": 0,     # K1: fast-engine code-bank group correlator
    "acq_wipeoff": 0,   # K2 (a): Doppler wipe-off into the FFT input
    "acq_product": 0,   # K2 (b): spectrum x conj(code spectrum)
    "acq_accum": 0,     # K2 (c1): |IFFT|^2 dwell accumulate + row peaks
    "acq_stats": 0,     # K2 (c2): per-PRN argmax, CFAR / second peak
    "fir_decim": 0,     # K7a: translating decimating FIR (conditioner)
    "pulse_blank": 0,   # K7b: pulse blanking
    "notch_mask": 0,    # K7c: frequency-domain notch around the FFTs
    "resample": 0,      # K7d: Mmse / Direct resampler
    "beamform": 0,      # K7e: antenna-array beamformer
    "fold_wipeoff": 0,  # K5a: QuickSync wipe-off + S-fold into the FFT input
    "cccwsr_combine": 0,  # K5b: max(|yB+yC|^2, |yB-yC|^2) + row peaks
    "kf_step": 0,       # K6a: fast-engine KF loop step
    "gaussian_step": 0,  # K6b: fast-engine Gaussian loop step
    "scan_loop": 0,     # K3-loop: the scan engine's fused tracking program
    "fast_loop": 0,     # K1-loop: the fast engine's fused tracking program
    "fast_loop_seg": 0,  # K1-loop with the segmented-sum body (K1-seg)
}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
