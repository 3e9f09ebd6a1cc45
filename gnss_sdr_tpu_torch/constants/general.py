"""Universal physical and GNSS constants.

Reference: gnss-sdr/src/core/system_parameters/MATH_CONSTANTS.h and
gnss_frequencies.h.

Copied from ``gnss_sdr_tpu/constants/general.py``; only the import paths differ.
"""

import math

SPEED_OF_LIGHT_M_S = 299_792_458.0
SPEED_OF_LIGHT_M_MS = SPEED_OF_LIGHT_M_S * 1e-3
TWO_PI = 2.0 * math.pi
HALF_PI = 0.5 * math.pi

# WGS-84 / GPS system constants (IS-GPS-200)
GM_EARTH = 3.986005e14          # Earth gravitational constant [m^3/s^2]
OMEGA_EARTH_DOT = 7.2921151467e-5  # Earth rotation rate [rad/s]
F_REL = -4.442807633e-10        # Relativistic clock correction constant [s/m^0.5]

# Week / time constants
SECONDS_PER_WEEK = 604_800
MS_PER_WEEK = 604_800_000
