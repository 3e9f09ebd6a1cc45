"""Single-point least-squares PVT solver.

Functional equivalent of the reference's single-point path: pntpos ->
estpos -> rescode iteration (gnss-sdr/src/algorithms/libs/rtklib/
rtklib_pntpos.cc:1073 and :490-700): iterative linearized least squares on
pseudoranges with satellite clock, earth-rotation (Sagnac), troposphere and
ionosphere corrections, plus DOP extraction. Velocity solving from
Doppler mirrors estvel/resdop.

Copied from ``gnss_sdr_tpu/pvt/solver.py``; only the import paths differ.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy import special as sp_special

from gnss_sdr_tpu_torch.constants.general import OMEGA_EARTH_DOT, SPEED_OF_LIGHT_M_S
from gnss_sdr_tpu_torch.pvt import atmosphere, geodesy
from gnss_sdr_tpu_torch.pvt.ephemeris import GpsEphemeris

C = SPEED_OF_LIGHT_M_S


@dataclasses.dataclass
class Observation:
    """One channel's measurement at a common reception epoch."""

    prn: int
    pseudorange_m: float
    eph: GpsEphemeris  # or GlonassEphemeris (same sat_pos/clock API)
    doppler_hz: float | None = None
    carrier_hz: float = 1575.42e6
    cn0_db_hz: float = 45.0
    system: str = "G"   # "R" adds the GLONASS inter-system time state


@dataclasses.dataclass
class PvtSolution:
    valid: bool
    pos_ecef: np.ndarray          # [3] m
    clock_bias_s: float
    vel_ecef: np.ndarray | None   # [3] m/s
    clock_drift_s_s: float | None
    gdop: float
    pdop: float
    hdop: float
    vdop: float
    n_sats: int
    residuals_m: np.ndarray
    lat_rad: float = 0.0
    lon_rad: float = 0.0
    height_m: float = 0.0
    rx_tow_s: float = 0.0         # receiver-clock TOW of the epoch


def _geodist(sat_pos: np.ndarray, rx_pos: np.ndarray) -> tuple[float, np.ndarray]:
    """Geometric distance with first-order Sagnac (earth-rotation) term and
    unit line-of-sight vector — rtklib geodist (rtklib_rtkcmn.cc).

    Using the closed-form correction OMGE*(xs*yr - ys*xr)/c instead of
    rotating by pseudorange/c matters with common-reception-time
    observables: their receiver clock offset (tens of ms) would corrupt a
    pr/c-based rotation by ~100 m of satellite position.
    """
    d = sat_pos - rx_pos
    r = float(np.linalg.norm(d))
    los = d / max(r, 1.0)
    sagnac = OMEGA_EARTH_DOT * (
        sat_pos[0] * rx_pos[1] - sat_pos[1] * rx_pos[0]) / C
    return r + sagnac, los


#: max acceptable GDOP (rtklib valsol max_gdop, rtklib_pntpos.cc)
MAX_GDOP = 30.0
#: a-priori pseudorange sigma for the chi-square residual test [m]
SIGMA_PR_M = 3.0


def solve_pvt(
    obs: list[Observation],
    t_rx_tow_s: float,
    x0: np.ndarray | None = None,
    iono_alpha: tuple | None = None,
    iono_beta: tuple | None = None,
    apply_tropo: bool = True,
    max_iter: int = 10,
    elevation_mask_rad: float = 0.0,
    validate: bool = True,
    corrections: dict | None = None,
) -> PvtSolution:
    """Iterative LS position + clock from pseudoranges at RX TOW [s]."""
    n = len(obs)
    invalid = PvtSolution(
        valid=False, pos_ecef=np.zeros(3), clock_bias_s=0.0, vel_ecef=None,
        clock_drift_s_s=None, gdop=0.0, pdop=0.0, hdop=0.0, vdop=0.0,
        n_sats=n, residuals_m=np.zeros(0),
    )
    # GLONASS observables add an inter-system time-offset unknown
    # (rtklib pntpos GLO ISB state, rtklib_pntpos.cc rescode) — only in
    # mixed-constellation solutions; GLO-only would make it collinear
    # with the clock state
    has_glo = any(o.system == "R" for o in obs) \
        and any(o.system != "R" for o in obs)
    nx = 5 if has_glo else 4
    if n < nx:
        return invalid

    x = np.zeros(nx) if x0 is None else np.concatenate(
        [np.asarray(x0, dtype=float), np.zeros(nx - 3)])

    sat_pos = np.zeros((n, 3))
    sat_clk = np.zeros(n)
    h = np.zeros((n, nx))
    resid = np.zeros(n)

    for it in range(max_iter):
        use_atmo = np.linalg.norm(x[:3]) > 1e6  # need a rough position first
        if use_atmo:
            lat, lon, hgt = geodesy.ecef_to_geodetic(x[:3])
        for i, o in enumerate(obs):
            # transmission time from pseudorange, then iterate sat clock
            t_tx = t_rx_tow_s - o.pseudorange_m / C
            dts = o.eph.clock_bias_s(t_tx)
            t_tx -= dts
            # L1 TGD applies (GLONASS state-vector eph has no TGD field)
            dts = o.eph.clock_bias_s(t_tx) - getattr(o.eph, "tgd_s", 0.0)
            pos = np.array(o.eph.sat_pos(t_tx))
            if corrections is not None:
                # HAS/SSR precise corrections on top of the broadcast
                # ephemeris (has_corrections.py; the reference's
                # rtklib_ppp/sbas satpos-with-corrections role)
                corr = corrections.get((o.system, o.prn))
                if corr is not None:
                    from gnss_sdr_tpu_torch.pvt.has_corrections import (
                        apply_correction)

                    vel = np.array(o.eph.sat_vel(t_tx))
                    pos, dclk_s = apply_correction(pos, vel, corr)
                    dts += dclk_s
            sat_pos[i] = pos
            sat_clk[i] = dts

            rho, los = _geodist(pos, x[:3])
            h[i, :3] = -los
            h[i, 3] = 1.0
            if has_glo:
                h[i, 4] = 1.0 if o.system == "R" else 0.0

            corr = 0.0
            if use_atmo:
                az, el = geodesy.azimuth_elevation(x[:3], pos)
                if apply_tropo:
                    corr += atmosphere.saastamoinen_delay(lat, hgt, el)
                if iono_alpha is not None and iono_beta is not None:
                    corr += atmosphere.klobuchar_delay(
                        t_rx_tow_s, lat, lon, az, el, iono_alpha, iono_beta)
            isb = x[4] if (has_glo and o.system == "R") else 0.0
            resid[i] = o.pseudorange_m - (rho + x[3] + isb - C * dts + corr)

        dx, *_ = np.linalg.lstsq(h, resid, rcond=None)
        x += dx
        if np.linalg.norm(dx) < 1e-4:
            break

    # final residuals and DOP
    try:
        q = np.linalg.inv(h.T @ h)
    except np.linalg.LinAlgError:
        return invalid
    gdop = math.sqrt(max(np.trace(q), 0.0))
    # solution validation (rtklib valsol, rtklib_pntpos.cc): chi-square
    # test on the sigma-normalized post-fit residuals plus a GDOP bound.
    # A single biased pseudorange (e.g. a one-sample anchor slip) passes
    # the LS fit but fails here and the epoch is flagged invalid.
    is_valid = True
    if validate:
        dof = n - nx
        if dof > 0:
            vv = float(np.sum((resid / SIGMA_PR_M) ** 2))
            # chi2 0.999 quantile (rtklib chisqr table role)
            is_valid = vv <= float(sp_special.chdtri(dof, 1e-3))
        if gdop <= 0.0 or gdop > MAX_GDOP:
            is_valid = False
    pdop = math.sqrt(max(q[0, 0] + q[1, 1] + q[2, 2], 0.0))
    lat, lon, hgt = geodesy.ecef_to_geodetic(x[:3])
    e_mat = geodesy.enu_matrix(lat, lon)
    q_enu = e_mat @ q[:3, :3] @ e_mat.T
    hdop = math.sqrt(max(q_enu[0, 0] + q_enu[1, 1], 0.0))
    vdop = math.sqrt(max(q_enu[2, 2], 0.0))

    # velocity from Doppler (rtklib estvel/resdop)
    vel = None
    drift = None
    dopplers = [o.doppler_hz for o in obs]
    if all(d is not None for d in dopplers):
        hv = np.zeros((n, 4))  # velocity: one common drift state
        rv = np.zeros(n)
        # rtklib resdop iterates the LSQ so the receiver-velocity Sagnac
        # cross terms (linear in the unknown velocity) can use the previous
        # iterate; two passes converge to sub-mm/s (the terms are
        # OMEGA_E/C ~ 2.4e-13 of the position-velocity products)
        v_est = np.zeros(3)
        for _ in range(2):
            for i, o in enumerate(obs):
                sat_vel = np.array(o.eph.sat_vel(
                    t_rx_tow_s - o.pseudorange_m / C))
                rho_vec = sat_pos[i] - x[:3]
                rho = np.linalg.norm(rho_vec)
                los = rho_vec / rho
                lam = C / o.carrier_hz
                # positive Doppler = closing range in our convention
                range_rate = -lam * o.doppler_hz
                # Sagnac rate correction (rtklib resdop)
                range_rate += OMEGA_EARTH_DOT / C * (
                    sat_vel[1] * x[0] + sat_pos[i][1] * v_est[0]
                    - sat_vel[0] * x[1] - sat_pos[i][0] * v_est[1])
                hv[i, :3] = -los
                hv[i, 3] = 1.0
                rv[i] = range_rate - np.dot(los, sat_vel)
            sol, *_ = np.linalg.lstsq(hv, rv, rcond=None)
            v_est = sol[:3]
        vel = sol[:3]
        drift = sol[3] / C

    return PvtSolution(
        valid=is_valid, pos_ecef=x[:3].copy(), clock_bias_s=x[3] / C,
        vel_ecef=vel, clock_drift_s_s=drift,
        gdop=gdop, pdop=pdop, hdop=hdop, vdop=vdop, n_sats=n,
        residuals_m=resid.copy(), lat_rad=lat, lon_rad=lon, height_m=hgt,
        rx_tow_s=t_rx_tow_s,
    )
