"""Geometry-accurate multi-satellite IF scene synthesis.

Unlike :mod:`generator` (fixed delay/Doppler), this models the full
time-varying light-time per satellite — delay tau(t) from the ephemeris via
the light-time equation, satellite clock bias, carrier phase = -2*pi*fc*tau
— so pseudoranges, Doppler trajectories and nav-data timing are mutually
consistent and a full receiver run can be scored against the truth
position (the reference's position_test methodology,
src/tests/system-tests/position_test.cc).

Copied from ``gnss_sdr_tpu/simulate/rf_scene.py``; only the import paths differ, and only the GPS L1 C/A
``generate_scene`` is kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_tpu_torch.constants.general import SPEED_OF_LIGHT_M_S
from gnss_sdr_tpu_torch.pvt.ephemeris import GpsEphemeris
from gnss_sdr_tpu_torch.simulate.lnav import build_lnav_bits
from gnss_sdr_tpu_torch.simulate.scenario import true_range_and_rate

CHIP_RATE = 1.023e6
CODE_LEN = 1023
CARRIER_HZ = 1575.42e6
CHIPS_PER_BIT = CODE_LEN * 20


def generate_scene(
    ephs: dict[int, GpsEphemeris],
    prns: list[int],
    rx_ecef: np.ndarray,
    t_start: float,
    duration_s: float,
    fs: float,
    bits_start_tow_s: float,
    n_subframes: int = 5,
    cn0_db_hz: float = 48.0,
    seed: int = 0,
    tau_grid_hz: float = 10.0,
    bandlimit: bool = True,
) -> np.ndarray:
    """Received complex baseband at GPS times t_start .. t_start+duration.

    ``bits_start_tow_s`` must be a subframe boundary (multiple of 6 s);
    each satellite transmits its LNAV stream from that boundary. The
    receiver clock is ideal (sample n at GPS time t_start + n/fs).

    ``rx_ecef`` is a fixed [3] ECEF position, or a callable
    ``t_gps_s -> [3]`` for a moving receiver (dynamic scenarios — the
    reference's position_test with a Spirent motion file); the antenna
    position is evaluated at each *reception* time on the tau grid.
    """
    n = int(round(fs * duration_s))
    t_rel = np.arange(n) / fs
    out = None
    rng = np.random.default_rng(seed)
    rx_of = rx_ecef if callable(rx_ecef) else (lambda t: rx_ecef)

    # light-time grid (tau is smooth; quadratic error of linear interp over
    # 1/tau_grid_hz is sub-mm)
    n_grid = int(duration_s * tau_grid_hz) + 3
    t_grid = t_start + np.arange(n_grid) / tau_grid_hz

    for prn in prns:
        eph = ephs[prn]
        taus = np.empty(n_grid)
        for i, tg in enumerate(t_grid):
            rho, _, _ = true_range_and_rate(
                eph, np.asarray(rx_of(tg), dtype=float), tg)
            taus[i] = rho / SPEED_OF_LIGHT_M_S
        tau_t = np.interp(t_start + t_rel, t_grid, taus)
        # satellite clock (as observable on L1: clock minus TGD)
        t_tx0 = t_start - float(taus[0])
        dts = eph.clock_bias_s(t_tx0) - eph.tgd_s

        # transmit-time chip phase relative to the bit-stream origin
        chips = (t_start - bits_start_tow_s + t_rel - tau_t + dts) * CHIP_RATE
        chip_idx = np.floor(chips).astype(np.int64)
        code = gps_l1ca_code(prn).astype(np.float64)
        spread = code[chip_idx % CODE_LEN]
        bits = build_lnav_bits(eph, int(round(bits_start_tow_s / 6.0)),
                               n_subframes)
        bit_idx = np.clip(chip_idx // CHIPS_PER_BIT, 0, len(bits) - 1)
        spread = spread * bits[bit_idx]

        phase = -2.0 * np.pi * CARRIER_HZ * tau_t
        sig = spread * np.exp(1j * phase)
        out = sig if out is None else out + sig

    if bandlimit:
        # front-end anti-alias filter: ideal rectangular chips sampled
        # instantaneously bias the sampled E-L discriminator by a few
        # meters per satellite; a real RF front end bandlimits the chips
        # (smooth edges), which removes the quantization bias.
        from scipy import signal as sp_signal

        taps = sp_signal.firwin(65, 0.9)  # cutoff at 0.45*fs
        out = sp_signal.fftconvolve(out, taps, mode="same")

    sigma = np.sqrt(fs / (2.0 * 10.0 ** (cn0_db_hz / 10.0)))
    out = out + sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return out.astype(np.complex64)
