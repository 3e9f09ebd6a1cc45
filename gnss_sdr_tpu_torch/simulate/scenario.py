"""Constellation/geometry truth for end-to-end receiver tests.

Generates spread GPS constellations, solves the light-time equation for
true ranges, and converts geometry to the per-satellite signal parameters
(delay samples, Doppler) the IF generator consumes — the role the external
gnss-sim generator plays for the reference's position_test
(SURVEY.md section 4, fixture style 3).

Copied from ``gnss_sdr_tpu/simulate/scenario.py``; only the import paths differ.
"""

from __future__ import annotations

import math

import numpy as np

from gnss_sdr_tpu_torch.constants.general import OMEGA_EARTH_DOT, SPEED_OF_LIGHT_M_S
from gnss_sdr_tpu_torch.pvt.ephemeris import GpsEphemeris
from gnss_sdr_tpu_torch.pvt.geodesy import azimuth_elevation, geodetic_to_ecef

C = SPEED_OF_LIGHT_M_S


def make_constellation(
    prns, toe_s: float, week: int = 310, spread_seed: int = 1
) -> dict[int, GpsEphemeris]:
    """Healthy near-circular GPS orbits spread in RAAN/anomaly."""
    rng = np.random.default_rng(spread_seed)
    out = {}
    for k, prn in enumerate(prns):
        out[prn] = GpsEphemeris(
            prn=prn, week_number=week, iodc=100 + k, iode=(100 + k) % 256,
            toc_s=toe_s, toe_s=toe_s,
            af0=rng.uniform(-1e-4, 1e-4), af1=rng.uniform(-1e-11, 1e-11),
            tgd_s=rng.uniform(-5e-9, 5e-9),
            sqrt_a=5153.7 + rng.uniform(-0.5, 0.5),
            ecc=rng.uniform(0.001, 0.02),
            m0_rad=(2.0 * math.pi * k / len(prns)
                    + rng.uniform(-0.3, 0.3)) % (2 * math.pi) - math.pi,
            delta_n_rad_s=rng.uniform(-5e-9, 5e-9),
            omega0_rad=(2.0 * math.pi * ((k * 2) % 6) / 6.0
                        + rng.uniform(-0.2, 0.2)) % (2 * math.pi) - math.pi,
            i0_rad=0.9596 + rng.uniform(-0.02, 0.02),
            omega_rad=rng.uniform(-math.pi, math.pi),
            omega_dot_rad_s=rng.uniform(-9e-9, -7e-9),
            idot_rad_s=rng.uniform(-4e-10, 4e-10),
        )
    return out


def visible_sats(
    ephs: dict[int, GpsEphemeris], rx_ecef: np.ndarray, t: float,
    min_elevation_deg: float = 7.0,
) -> list[int]:
    vis = []
    for prn, eph in ephs.items():
        _, el = azimuth_elevation(rx_ecef, np.array(eph.sat_pos(t)))
        if math.degrees(el) >= min_elevation_deg:
            vis.append(prn)
    return vis


def true_range_and_rate(
    eph: GpsEphemeris, rx_ecef: np.ndarray, t_rx: float
) -> tuple[float, float, float]:
    """Solve the light-time equation; returns (geometric range m,
    range rate m/s, t_tx GPS seconds). Satellite position is rotated into
    the reception-time ECEF frame (Sagnac)."""
    rx = np.asarray(rx_ecef, dtype=float)
    tau = 0.07
    for _ in range(10):
        t_tx = t_rx - tau
        pos = np.array(eph.sat_pos(t_tx))
        theta = OMEGA_EARTH_DOT * tau
        c, s = math.cos(theta), math.sin(theta)
        rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        pos_rot = rot @ pos
        rho = float(np.linalg.norm(pos_rot - rx))
        new_tau = rho / C
        if abs(new_tau - tau) < 1e-12:
            tau = new_tau
            break
        tau = new_tau
    # range rate by differencing
    dt = 0.5
    r2, _, _ = _range_only(eph, rx, t_rx + dt)
    r1, _, _ = _range_only(eph, rx, t_rx - dt)
    rate = (r2 - r1) / (2 * dt)
    return rho, rate, t_rx - tau


def _range_only(eph, rx, t_rx):
    tau = 0.07
    for _ in range(8):
        pos = np.array(eph.sat_pos(t_rx - tau))
        theta = OMEGA_EARTH_DOT * tau
        c, s = math.cos(theta), math.sin(theta)
        rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        rho = float(np.linalg.norm(rot @ pos - rx))
        tau = rho / C
    return rho, None, t_rx - tau


def rx_position(lat_deg=41.275, lon_deg=1.9876, h_m=80.0) -> np.ndarray:
    """Default receiver location (CTTC-ish coordinates)."""
    return geodetic_to_ecef(math.radians(lat_deg), math.radians(lon_deg), h_m)
