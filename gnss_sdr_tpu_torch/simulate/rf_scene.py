"""Geometry-accurate multi-satellite IF scene synthesis.

Unlike :mod:`generator` (fixed delay/Doppler), this models the full
time-varying light-time per satellite — delay tau(t) from the ephemeris via
the light-time equation, satellite clock bias, carrier phase = -2*pi*fc*tau
— so pseudoranges, Doppler trajectories and nav-data timing are mutually
consistent and a full receiver run can be scored against the truth
position (the reference's position_test methodology,
src/tests/system-tests/position_test.cc).

Copied from ``gnss_sdr_tpu/simulate/rf_scene.py``; only the import paths differ, and only the GPS L1 C/A
``generate_scene`` and the Galileo E1 ``generate_galileo_scene`` (with its
I/NAV symbol stream) are kept.
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


def _inav_symbol_stream(eph: GpsEphemeris, start_tow_s: float,
                        n_pages: int,
                        cycle=(5, 1, 5, 2, 5, 3, 5, 4)) -> np.ndarray:
    """+-1 I/NAV symbol stream at 250 sps cycling the given word types.

    Page pair k (2 s) starts at GST start_tow_s + 2k; its word-5 GST
    stamps the time at the end of the odd part (= start of the next even
    part), matching the decoder's TOW anchoring. The default cycle
    interleaves word 5 (GST time) so a receiver gets TOW within ~4 s.
    """
    from gnss_sdr_tpu_torch.telemetry.galileo_inav import (
        build_inav_word,
        build_page_pair,
        encode_page_part,
    )

    parts = []
    for k in range(n_pages):
        wtype = cycle[k % len(cycle)]
        fields = dict(word_type=wtype)
        if wtype == 1:
            fields.update(iod_nav=101, toe_s=eph.toe_s, m0_rad=eph.m0_rad,
                          ecc=eph.ecc, sqrt_a=eph.sqrt_a)
        elif wtype == 2:
            fields.update(iod_nav=101, omega0_rad=eph.omega0_rad,
                          i0_rad=eph.i0_rad, omega_rad=eph.omega_rad,
                          idot_rad_s=eph.idot_rad_s)
        elif wtype == 3:
            fields.update(iod_nav=101, omega_dot_rad_s=eph.omega_dot_rad_s,
                          delta_n_rad_s=eph.delta_n_rad_s,
                          cuc_rad=eph.cuc_rad, cus_rad=eph.cus_rad,
                          crc_m=eph.crc_m, crs_m=eph.crs_m)
        elif wtype == 4:
            fields.update(iod_nav=101, svid=eph.prn, cic_rad=eph.cic_rad,
                          cis_rad=eph.cis_rad, toc_s=eph.toc_s,
                          af0=eph.af0, af1=eph.af1, af2=eph.af2)
        elif wtype == 5:
            fields.update(week_number=eph.week_number,
                          tow_s=int(start_tow_s + 2 * k + 2),
                          bgd_e1e5b_s=eph.tgd_s)
        even, odd = build_page_pair(build_inav_word(fields))
        parts.append(encode_page_part(even))
        parts.append(encode_page_part(odd))
    return np.concatenate(parts)


def generate_galileo_scene(
    ephs: dict[int, GpsEphemeris],
    prns: list[int],
    rx_ecef: np.ndarray,
    t_start: float,
    duration_s: float,
    fs: float,
    bits_start_tow_s: float,
    cn0_db_hz: float = 48.0,
    seed: int = 1,
    tau_grid_hz: float = 10.0,
    noise: bool = True,
    bandlimit: bool = True,
    pilot: bool = False,
) -> np.ndarray:
    """Geometry-accurate Galileo E1-B scene with live I/NAV data.

    ``bits_start_tow_s`` must be even (a page boundary). Ephemerides use
    the same Kepler parameterization as GPS (GST time base == simulation
    time base; BGD carried in eph.tgd_s). With ``pilot=True`` the full
    composite e(t) = (e_B d_B - e_C c_CS25)/sqrt(2) is emitted (Galileo
    OS SIS ICD eq. 3; CS25 aligned to the 100 ms grid of the page
    structure) and ``cn0_db_hz`` refers to TOTAL power.
    """
    from gnss_sdr_tpu_torch.codes.galileo_e1 import (E1C_SECONDARY,
                                                     galileo_e1_subchips)

    e1_chip_rate = 1.023e6
    sub_per_code = 4092 * 12
    symbol_s = 0.004

    n = int(round(fs * duration_s))
    t_rel = np.arange(n) / fs
    out = None
    rng = np.random.default_rng(seed)
    n_grid = int(duration_s * tau_grid_hz) + 3
    t_grid = t_start + np.arange(n_grid) / tau_grid_hz

    n_pages = int(np.ceil((t_start + duration_s - bits_start_tow_s) / 2.0)) + 1
    for prn in prns:
        eph = ephs[prn]
        taus = np.empty(n_grid)
        for i, tg in enumerate(t_grid):
            rho, _, _ = true_range_and_rate(eph, rx_ecef, tg)
            taus[i] = rho / SPEED_OF_LIGHT_M_S
        tau_t = np.interp(t_start + t_rel, t_grid, taus)
        dts = eph.clock_bias_s(t_start - float(taus[0])) - eph.tgd_s

        t_tx = t_start - bits_start_tow_s + t_rel - tau_t + dts
        sub = galileo_e1_subchips(prn, "B", cboc=True).astype(np.float64)
        sub_idx = np.floor(t_tx * e1_chip_rate * 12.0).astype(np.int64)
        spread = sub[sub_idx % sub_per_code]
        symbols = _inav_symbol_stream(eph, bits_start_tow_s, n_pages)
        sym_idx = np.clip(np.floor(t_tx / symbol_s).astype(np.int64),
                          0, len(symbols) - 1)
        spread = spread * symbols[sym_idx]
        if pilot:
            sub_c = galileo_e1_subchips(prn, "C", cboc=True) \
                .astype(np.float64)
            cs25 = np.array([1.0 if c == "0" else -1.0
                             for c in E1C_SECONDARY])
            per_idx = np.floor(t_tx / symbol_s).astype(np.int64)
            pilot_spread = sub_c[sub_idx % sub_per_code] \
                * cs25[per_idx % 25]
            spread = (spread - pilot_spread) / np.sqrt(2.0)
        phase = -2.0 * np.pi * CARRIER_HZ * tau_t
        sig = spread * np.exp(1j * phase)
        out = sig if out is None else out + sig

    if bandlimit:
        # same front-end anti-alias smoothing rationale as generate_scene:
        # instantaneously-sampled rectangular (sub)chips bias the sampled
        # E-L discriminator by meters
        from scipy import signal as sp_signal

        taps = sp_signal.firwin(65, 0.9)
        out = sp_signal.fftconvolve(out, taps, mode="same")

    if noise:
        sigma = np.sqrt(fs / (2.0 * 10.0 ** (cn0_db_hz / 10.0)))
        out = out + sigma * (rng.standard_normal(n)
                             + 1j * rng.standard_normal(n))
    return out.astype(np.complex64)
