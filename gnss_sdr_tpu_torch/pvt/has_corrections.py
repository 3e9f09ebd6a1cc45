"""Applying Galileo HAS corrections to the PVT solution.

Closes the decoded-but-unused gap: :mod:`gnss_sdr_tpu_torch.telemetry.galileo_has`
recovers MT1 orbit/clock/bias corrections from E6-B pages (the reference's
galileo_e6_has_msg_receiver.cc); this module converts them into per-satellite
correction records and the single-point solver consumes them — the
reference's PPP/SSR role (rtklib_ppp.cc, rtklib_sbas.cc) at the scope our
north star needs (precise corrections on top of broadcast ephemerides).

Conventions (HAS SIS ICD v1.0, section 7.5):
- orbit deltas are in the satellite RAC frame (radial / along-track /
  cross-track) and are ADDED to the broadcast position:
      r_corrected = r_broadcast + [e_r e_a e_c] . [dR dA dC]
- the clock correction is ADDED to the broadcast clock bias:
      dt_corrected = dt_broadcast + dClock / c
- code biases are subtracted from the measured pseudorange per signal.
- corrections are only valid against the matching broadcast IOD.

Copied from ``gnss_sdr_tpu/pvt/has_corrections.py``; only the import paths differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sdr_tpu_torch.constants.general import SPEED_OF_LIGHT_M_S

#: HAS GNSS ID -> our system letters (HAS SIS ICD table: 0 GPS, 2 Galileo)
HAS_GNSS_SYSTEMS = {0: "G", 2: "E"}


@dataclasses.dataclass
class SatCorrection:
    """One satellite's SSR-style correction set."""

    iod: int                      # broadcast IOD the orbit delta refers to
    delta_radial_m: float = 0.0
    delta_in_track_m: float = 0.0
    delta_cross_track_m: float = 0.0
    delta_clock_m: float = 0.0
    code_bias_m: float = 0.0      # for the tracked signal


def corrections_from_has(has_data, signal_index: int = 0) -> dict:
    """{(system, prn): SatCorrection} from a decoded MT1 HasData."""
    out: dict[tuple[str, int], SatCorrection] = {}
    n = len(has_data.gnss_iod)
    dr = has_data.delta_radial_m()
    da = has_data.delta_in_track_m()
    dc = has_data.delta_cross_track_m()
    dclk = has_data.delta_clock_m() if has_data.header.clock_fullset_flag \
        else np.zeros(n)
    cb = has_data.code_bias_m() if has_data.code_bias is not None else None
    pairs = has_data.prns()
    for i in range(n):
        sysid, prn = pairs[i]
        system = HAS_GNSS_SYSTEMS.get(sysid)
        if system is None:
            continue
        out[(system, prn)] = SatCorrection(
            iod=int(has_data.gnss_iod[i]),
            delta_radial_m=float(dr[i]),
            delta_in_track_m=float(da[i]),
            delta_cross_track_m=float(dc[i]),
            delta_clock_m=float(dclk[i]) if i < len(dclk) else 0.0,
            code_bias_m=float(cb[i, signal_index]) if cb is not None else 0.0,
        )
    return out


def rac_frame(pos: np.ndarray, vel: np.ndarray) -> np.ndarray:
    """Columns [e_radial, e_along, e_cross] of the satellite RAC frame."""
    e_r = pos / np.linalg.norm(pos)
    c = np.cross(pos, vel)
    e_c = c / np.linalg.norm(c)
    e_a = np.cross(e_c, e_r)
    return np.column_stack([e_r, e_a, e_c])


def apply_correction(pos: np.ndarray, vel: np.ndarray,
                     corr: SatCorrection) -> tuple[np.ndarray, float]:
    """(corrected ECEF position, clock delta [s]) for one satellite."""
    m = rac_frame(np.asarray(pos, float), np.asarray(vel, float))
    delta = m @ np.array([corr.delta_radial_m, corr.delta_in_track_m,
                          corr.delta_cross_track_m])
    return pos + delta, corr.delta_clock_m / SPEED_OF_LIGHT_M_S


def correction_for_broadcast(eph_broadcast, eph_true, t_sv: float
                             ) -> SatCorrection:
    """Simulation-side inverse: the HAS record that maps a degraded
    broadcast ephemeris onto the true orbit/clock at ``t_sv`` (what a HAS
    provider computes from its precise products)."""
    pos_b = np.asarray(eph_broadcast.sat_pos(t_sv), float)
    vel_b = np.asarray(eph_broadcast.sat_vel(t_sv), float)
    pos_t = np.asarray(eph_true.sat_pos(t_sv), float)
    m = rac_frame(pos_b, vel_b)
    delta = m.T @ (pos_t - pos_b)
    dclk = (eph_true.clock_bias_s(t_sv)
            - eph_broadcast.clock_bias_s(t_sv)) * SPEED_OF_LIGHT_M_S
    return SatCorrection(
        iod=getattr(eph_broadcast, "iode", 0),
        delta_radial_m=float(delta[0]), delta_in_track_m=float(delta[1]),
        delta_cross_track_m=float(delta[2]), delta_clock_m=float(dclk))
