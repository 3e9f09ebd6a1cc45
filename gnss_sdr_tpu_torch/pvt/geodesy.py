"""WGS-84 geodesy utilities.

Counterpart of gnss-sdr/src/algorithms/libs/geofunctions.cc and the
rtklib_rtkcmn.cc coordinate helpers (ecef2pos, ecef2enu, satazel).

Copied from ``gnss_sdr_tpu/pvt/geodesy.py``; only the import paths differ.
"""

from __future__ import annotations

import math

import numpy as np

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)


def ecef_to_geodetic(xyz) -> tuple[float, float, float]:
    """ECEF [m] -> (lat rad, lon rad, height m), iterative."""
    x, y, z = float(xyz[0]), float(xyz[1]), float(xyz[2])
    lon = math.atan2(y, x)
    p = math.hypot(x, y)
    lat = math.atan2(z, p * (1.0 - WGS84_E2))
    h = 0.0
    for _ in range(10):
        n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * math.sin(lat) ** 2)
        h = p / math.cos(lat) - n
        lat = math.atan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    return lat, lon, h


def geodetic_to_ecef(lat: float, lon: float, h: float) -> np.ndarray:
    n = WGS84_A / math.sqrt(1.0 - WGS84_E2 * math.sin(lat) ** 2)
    x = (n + h) * math.cos(lat) * math.cos(lon)
    y = (n + h) * math.cos(lat) * math.sin(lon)
    z = (n * (1.0 - WGS84_E2) + h) * math.sin(lat)
    return np.array([x, y, z])


def enu_matrix(lat: float, lon: float) -> np.ndarray:
    """Rows are the East, North, Up unit vectors in ECEF."""
    sl, cl = math.sin(lat), math.cos(lat)
    so, co = math.sin(lon), math.cos(lon)
    return np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])


def ecef_to_enu(d_ecef, lat: float, lon: float) -> np.ndarray:
    return enu_matrix(lat, lon) @ np.asarray(d_ecef, dtype=float)


def azimuth_elevation(rx_ecef, sat_ecef) -> tuple[float, float]:
    """(azimuth rad [0, 2pi), elevation rad) of sat seen from rx."""
    rx = np.asarray(rx_ecef, dtype=float)
    lat, lon, _ = ecef_to_geodetic(rx)
    enu = ecef_to_enu(np.asarray(sat_ecef, dtype=float) - rx, lat, lon)
    rng = np.linalg.norm(enu)
    if rng <= 0:
        return 0.0, math.pi / 2
    az = math.atan2(enu[0], enu[1]) % (2 * math.pi)
    el = math.asin(np.clip(enu[2] / rng, -1.0, 1.0))
    return az, el
