"""PVT math engine (reference layer L7).

Scope-controlled port of the reference's solver needs: Kepler ephemeris
evaluation + satellite clock (rtklib_ephemeris.cc eph2pos/eph2clk
equivalents), atmospheric corrections, and iterative least-squares
single-point positioning (rtklib_pntpos.cc:1073 scope) — deliberately NOT
the 28.6k-LoC RTK/PPP engine (SURVEY.md section 7 "hard parts").

Copied from ``gnss_sdr_tpu/pvt/__init__.py``; only the import paths differ.
"""

from gnss_sdr_tpu_torch.pvt.ephemeris import GpsEphemeris
from gnss_sdr_tpu_torch.pvt.solver import PvtSolution, solve_pvt

__all__ = ["GpsEphemeris", "PvtSolution", "solve_pvt"]
