"""GPS broadcast ephemeris evaluation (IS-GPS-200 Table 20-IV algorithm).

Counterpart of the reference's eph2pos/eph2clk
(gnss-sdr/src/algorithms/libs/rtklib/rtklib_ephemeris.cc) and
Gps_Ephemeris (src/core/system_parameters/gps_ephemeris.h).

Copied from ``gnss_sdr_tpu/pvt/ephemeris.py``; only the import paths differ.
"""

from __future__ import annotations

import dataclasses
import math

from gnss_sdr_tpu_torch.constants.general import (
    F_REL,
    GM_EARTH,
    OMEGA_EARTH_DOT,
    SECONDS_PER_WEEK,
)


def time_diff(t: float, t_ref: float) -> float:
    """Week-crossover-safe time difference (IS-GPS-200 20.3.3.3.3.1)."""
    dt = t - t_ref
    if dt > SECONDS_PER_WEEK / 2:
        dt -= SECONDS_PER_WEEK
    elif dt < -SECONDS_PER_WEEK / 2:
        dt += SECONDS_PER_WEEK
    return dt


@dataclasses.dataclass
class GpsEphemeris:
    """Broadcast clock + Kepler orbit parameters (SI units, radians)."""

    prn: int = 0
    week_number: int = 0
    sv_health: int = 0
    iodc: int = 0
    iode: int = 0
    # clock (subframe 1)
    toc_s: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    tgd_s: float = 0.0
    # orbit (subframes 2/3)
    toe_s: float = 0.0
    sqrt_a: float = 5153.7        # ~26560 km orbit
    ecc: float = 0.0
    m0_rad: float = 0.0
    delta_n_rad_s: float = 0.0
    omega0_rad: float = 0.0
    i0_rad: float = 0.9596        # ~55 deg
    omega_rad: float = 0.0
    omega_dot_rad_s: float = 0.0
    idot_rad_s: float = 0.0
    cuc_rad: float = 0.0
    cus_rad: float = 0.0
    crc_m: float = 0.0
    crs_m: float = 0.0
    cic_rad: float = 0.0
    cis_rad: float = 0.0

    @classmethod
    def from_fields(cls, prn: int, fields: dict) -> "GpsEphemeris":
        """Build from the telemetry parser's merged subframe-1/2/3 dict."""
        return cls(
            prn=prn,
            week_number=fields.get("week_number", 0),
            sv_health=fields.get("sv_health", 0),
            iodc=fields.get("iodc", 0),
            iode=fields.get("iode", 0),
            toc_s=fields.get("toc_s", 0.0),
            af0=fields.get("af0", 0.0),
            af1=fields.get("af1", 0.0),
            af2=fields.get("af2", 0.0),
            tgd_s=fields.get("tgd_s", 0.0),
            toe_s=fields.get("toe_s", 0.0),
            sqrt_a=fields.get("sqrt_a", 0.0),
            ecc=fields.get("ecc", 0.0),
            m0_rad=fields.get("m0_rad", 0.0),
            delta_n_rad_s=fields.get("delta_n_rad_s", 0.0),
            omega0_rad=fields.get("omega0_rad", 0.0),
            i0_rad=fields.get("i0_rad", 0.0),
            omega_rad=fields.get("omega_rad", 0.0),
            omega_dot_rad_s=fields.get("omega_dot_rad_s", 0.0),
            idot_rad_s=fields.get("idot_rad_s", 0.0),
            cuc_rad=fields.get("cuc_rad", 0.0),
            cus_rad=fields.get("cus_rad", 0.0),
            crc_m=fields.get("crc_m", 0.0),
            crs_m=fields.get("crs_m", 0.0),
            cic_rad=fields.get("cic_rad", 0.0),
            cis_rad=fields.get("cis_rad", 0.0),
        )

    # -- clock ------------------------------------------------------------
    def clock_bias_s(self, t_sv: float) -> float:
        """SV clock correction at transmission time [s], incl. relativity,
        excl. TGD (applied per-frequency by the solver)."""
        dt = time_diff(t_sv, self.toc_s)
        bias = self.af0 + self.af1 * dt + self.af2 * dt * dt
        # relativistic correction needs eccentric anomaly
        ek = self._eccentric_anomaly(time_diff(t_sv, self.toe_s))
        bias += F_REL * self.ecc * self.sqrt_a * math.sin(ek)
        return bias

    # -- orbit ------------------------------------------------------------
    def _eccentric_anomaly(self, tk: float) -> float:
        a = self.sqrt_a * self.sqrt_a
        n = math.sqrt(GM_EARTH / (a**3)) + self.delta_n_rad_s
        mk = self.m0_rad + n * tk
        ek = mk
        for _ in range(20):
            delta = (ek - self.ecc * math.sin(ek) - mk) \
                / (1.0 - self.ecc * math.cos(ek))
            ek -= delta
            if abs(delta) < 1e-14:
                break
        return ek

    def sat_pos(self, t_sv: float) -> tuple[float, float, float]:
        """ECEF satellite antenna position at GPS system time t_sv [m]."""
        a = self.sqrt_a * self.sqrt_a
        tk = time_diff(t_sv, self.toe_s)
        ek = self._eccentric_anomaly(tk)
        sin_ek, cos_ek = math.sin(ek), math.cos(ek)
        # true anomaly and argument of latitude
        vk = math.atan2(math.sqrt(1.0 - self.ecc**2) * sin_ek,
                        cos_ek - self.ecc)
        phik = vk + self.omega_rad
        s2p, c2p = math.sin(2 * phik), math.cos(2 * phik)
        duk = self.cus_rad * s2p + self.cuc_rad * c2p
        drk = self.crs_m * s2p + self.crc_m * c2p
        dik = self.cis_rad * s2p + self.cic_rad * c2p
        uk = phik + duk
        rk = a * (1.0 - self.ecc * cos_ek) + drk
        ik = self.i0_rad + self.idot_rad_s * tk + dik
        xk_p = rk * math.cos(uk)
        yk_p = rk * math.sin(uk)
        omk = (self.omega0_rad
               + (self.omega_dot_rad_s - OMEGA_EARTH_DOT) * tk
               - OMEGA_EARTH_DOT * self.toe_s)
        so, co = math.sin(omk), math.cos(omk)
        si, ci = math.sin(ik), math.cos(ik)
        x = xk_p * co - yk_p * ci * so
        y = xk_p * so + yk_p * ci * co
        z = yk_p * si
        return (x, y, z)

    def sat_vel(self, t_sv: float, dt: float = 1e-3):
        """Numerical ECEF velocity (central difference)."""
        p1 = self.sat_pos(t_sv - dt)
        p2 = self.sat_pos(t_sv + dt)
        return tuple((b - a_) / (2 * dt) for a_, b in zip(p1, p2))
