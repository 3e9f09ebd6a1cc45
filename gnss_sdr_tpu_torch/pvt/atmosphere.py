"""Ionosphere and troposphere delay models.

Counterparts of RTKLIB's ionmodel (Klobuchar) and tropmodel (Saastamoinen)
in gnss-sdr/src/algorithms/libs/rtklib/rtklib_rtkcmn.cc, as used by
the single-point solver (rtklib_pntpos.cc).

Copied from ``gnss_sdr_tpu/pvt/atmosphere.py``; only the import paths differ.
"""

from __future__ import annotations

import math

SPEED_OF_LIGHT = 299_792_458.0


def klobuchar_delay(
    t_gps_s: float, lat: float, lon: float, az: float, el: float,
    alpha: tuple[float, float, float, float],
    beta: tuple[float, float, float, float],
) -> float:
    """Klobuchar broadcast ionosphere delay on L1 [m].

    Angles in radians; returns 0-ish delay for default (zero) coefficients.
    Algorithm per IS-GPS-200 20.3.3.5.2.5 (rtklib ionmodel).
    """
    if el <= 0:
        return 0.0
    psi = 0.0137 / (el / math.pi + 0.11) - 0.022  # semicircles
    phi = lat / math.pi + psi * math.cos(az)
    phi = max(-0.416, min(0.416, phi))
    lam = lon / math.pi + psi * math.sin(az) / math.cos(phi * math.pi)
    phi_m = phi + 0.064 * math.cos((lam - 1.617) * math.pi)
    t = 43200.0 * lam + t_gps_s
    t = t % 86400.0
    f = 1.0 + 16.0 * (0.53 - el / math.pi) ** 3  # slant factor
    amp = sum(a * phi_m**i for i, a in enumerate(alpha))
    per = sum(b * phi_m**i for i, b in enumerate(beta))
    amp = max(amp, 0.0)
    per = max(per, 72000.0)
    x = 2.0 * math.pi * (t - 50400.0) / per
    if abs(x) < 1.57:
        delay = 5e-9 + amp * (1.0 - x * x / 2.0 + x**4 / 24.0)
    else:
        delay = 5e-9
    return SPEED_OF_LIGHT * f * delay


def saastamoinen_delay(
    lat: float, h: float, el: float, humidity: float = 0.7
) -> float:
    """Saastamoinen troposphere delay [m] with standard atmosphere
    (rtklib tropmodel)."""
    if el <= 0 or h < -100.0 or h > 1e4:
        return 0.0
    hgt = max(h, 0.0)
    pres = 1013.25 * (1.0 - 2.2557e-5 * hgt) ** 5.2568
    temp = 15.0 - 6.5e-3 * hgt + 273.16
    e = 6.108 * humidity * math.exp((17.15 * temp - 4684.0) / (temp - 38.45))
    z = math.pi / 2.0 - el
    trph = 0.0022768 * pres / (
        1.0 - 0.00266 * math.cos(2.0 * lat) - 0.00028 * hgt / 1e3) \
        / math.cos(z)
    trpw = 0.002277 * (1255.0 / temp + 0.05) * e / math.cos(z)
    return trph + trpw
