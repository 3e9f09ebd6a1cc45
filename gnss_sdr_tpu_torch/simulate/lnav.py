"""GPS LNAV message encoder (simulation truth source).

Inverse of :mod:`gnss_sdr_tpu_torch.telemetry.gps_lnav`: builds parity-valid
subframe streams from a :class:`GpsEphemeris` so the full
tracking -> telemetry -> PVT chain can be tested end-to-end against known
truth (the role the external signal generator plays for the reference's
system tests, SURVEY.md section 4 fixture style 3).

Copied from ``gnss_sdr_tpu/simulate/lnav.py``; only the import paths differ.
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.pvt.ephemeris import GpsEphemeris
from gnss_sdr_tpu_torch.telemetry.gps_lnav import (
    PREAMBLE_BITS,
    encode_word,
    solve_parity_bits,
)


def _u(value: float, nbits: int, scale: float = 1.0) -> np.ndarray:
    """Unsigned field -> bit array (MSB first)."""
    iv = int(round(value / scale))
    if not 0 <= iv < (1 << nbits):
        raise ValueError(f"unsigned field overflow: {iv} in {nbits} bits")
    return np.array([(iv >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                    dtype=np.int64)


def _s(value: float, nbits: int, scale: float = 1.0) -> np.ndarray:
    """Two's-complement field -> bit array (MSB first)."""
    iv = int(round(value / scale))
    lo, hi = -(1 << (nbits - 1)), (1 << (nbits - 1)) - 1
    if not lo <= iv <= hi:
        raise ValueError(f"signed field overflow: {iv} in {nbits} bits")
    if iv < 0:
        iv += 1 << nbits
    return np.array([(iv >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                    dtype=np.int64)


def _zeros(n: int) -> np.ndarray:
    return np.zeros(n, dtype=np.int64)


PI = np.pi


def _subframe_words(eph: GpsEphemeris, sf_id: int, tow_next_6s: int):
    """Ten 24-bit source-bit arrays (words 2 and 10 are 22 bits; the two
    trailing bits are parity-solved at serialization time)."""
    w1 = np.concatenate([PREAMBLE_BITS, _zeros(14), _zeros(2)])
    how = np.concatenate([
        _u(tow_next_6s % (1 << 17), 17), _zeros(1), _zeros(1),
        _u(sf_id, 3),
    ])  # 22 bits; t-bits solved later
    words: list[np.ndarray] = [w1, how]
    if sf_id == 1:
        words += [
            np.concatenate([_u(eph.week_number % 1024, 10), _zeros(2),
                            _zeros(4), _u(eph.sv_health, 6),
                            _u(eph.iodc >> 8, 2)]),
            _zeros(24), _zeros(24), _zeros(24),
            np.concatenate([_zeros(16), _s(eph.tgd_s, 8, 2.0**-31)]),
            np.concatenate([_u(eph.iodc & 0xFF, 8), _u(eph.toc_s, 16, 16.0)]),
            np.concatenate([_s(eph.af2, 8, 2.0**-55),
                            _s(eph.af1, 16, 2.0**-43)]),
            _s(eph.af0, 22, 2.0**-31),  # 22 bits + solved
        ]
    elif sf_id == 2:
        m0 = _s(eph.m0_rad / PI, 32, 2.0**-31)
        ecc = _u(eph.ecc, 32, 2.0**-33)
        sqrta = _u(eph.sqrt_a, 32, 2.0**-19)
        words += [
            np.concatenate([_u(eph.iode, 8), _s(eph.crs_m, 16, 2.0**-5)]),
            np.concatenate([_s(eph.delta_n_rad_s / PI, 16, 2.0**-43),
                            m0[:8]]),
            m0[8:],
            np.concatenate([_s(eph.cuc_rad, 16, 2.0**-29), ecc[:8]]),
            ecc[8:],
            np.concatenate([_s(eph.cus_rad, 16, 2.0**-29), sqrta[:8]]),
            sqrta[8:],
            np.concatenate([_u(eph.toe_s, 16, 16.0), _zeros(1), _zeros(5)]),
        ]
    elif sf_id == 3:
        om0 = _s(eph.omega0_rad / PI, 32, 2.0**-31)
        i0 = _s(eph.i0_rad / PI, 32, 2.0**-31)
        om = _s(eph.omega_rad / PI, 32, 2.0**-31)
        words += [
            np.concatenate([_s(eph.cic_rad, 16, 2.0**-29), om0[:8]]),
            om0[8:],
            np.concatenate([_s(eph.cis_rad, 16, 2.0**-29), i0[:8]]),
            i0[8:],
            np.concatenate([_s(eph.crc_m, 16, 2.0**-5), om[:8]]),
            om[8:],
            _s(eph.omega_dot_rad_s / PI, 24, 2.0**-43),
            np.concatenate([_u(eph.iode, 8),
                            _s(eph.idot_rad_s / PI, 14, 2.0**-43)]),
        ]
    elif sf_id == 4:
        # page 18 (sv_id 56): Klobuchar ionosphere + UTC parameters
        # (IS-GPS-200 20.3.3.5.1.7; attached to the eph as optional
        # `iono_alpha`/`iono_beta` 4-tuples, zeros otherwise).
        a = getattr(eph, "iono_alpha", (0.0, 0.0, 0.0, 0.0))
        b = getattr(eph, "iono_beta", (0.0, 0.0, 0.0, 0.0))
        words += [
            np.concatenate([_u(1, 2), _u(56, 6),
                            _s(a[0], 8, 2.0**-30), _s(a[1], 8, 2.0**-27)]),
            np.concatenate([_s(a[2], 8, 2.0**-24), _s(a[3], 8, 2.0**-24),
                            _s(b[0], 8, 2.0**11)]),
            np.concatenate([_s(b[1], 8, 2.0**14), _s(b[2], 8, 2.0**16),
                            _s(b[3], 8, 2.0**16)]),
            _zeros(24),                       # A1
            _zeros(24),                       # A0 MSBs
            _zeros(24),                       # A0 LSBs, t_ot, WN_t
            _zeros(24),                       # dt_LS, WN_LSF, DN
            _zeros(22),                       # dt_LSF + reserved
        ]
    else:
        # subframe 5 pages 1-24: almanac for this SV (coarse Kepler
        # subset, IS-GPS-200 20.3.3.5.1.2)
        m0 = _s(eph.m0_rad / PI, 24, 2.0**-23)
        om0 = _s(eph.omega0_rad / PI, 24, 2.0**-23)
        om = _s(eph.omega_rad / PI, 24, 2.0**-23)
        delta_i = (eph.i0_rad / PI) - 0.3  # relative to the 54 deg ref
        af0_bits = _s(eph.af0, 11, 2.0**-20)
        words += [
            np.concatenate([_u(1, 2), _u(max(1, eph.prn % 33), 6),
                            _u(eph.ecc, 16, 2.0**-21)]),
            np.concatenate([_u((eph.toe_s / 4096.0) % 256, 8, 1.0),
                            _s(delta_i, 16, 2.0**-19)]),
            np.concatenate([_s(eph.omega_dot_rad_s / PI, 16, 2.0**-38),
                            _u(eph.sv_health, 8)]),
            _u(eph.sqrt_a, 24, 2.0**-11),
            om0, om, m0,
            np.concatenate([af0_bits[:8], _s(eph.af1, 11, 2.0**-38),
                            af0_bits[8:]]),  # 22 bits + solved t-bits
        ]
    return words


def build_lnav_bits(
    eph: GpsEphemeris, start_tow_6s: int, n_subframes: int
) -> np.ndarray:
    """Transmitted LNAV bit stream as +-1 symbols at 50 bps.

    Subframe k (0-based) starts at GPS time (start_tow_6s + k) * 6 s; its
    HOW carries the truncated TOW of subframe k+1 (IS-GPS-200 20.3.3.2).
    Word-boundary parity chaining (D29*/D30*) runs across the whole stream;
    words 2 and 10 carry solved t-bits so D29=D30=0 at subframe edges.

    The subframe ID follows the broadcast convention (sf 1..5 cycling on
    the 30 s frame grid of GPS time, IS-GPS-200 20.3.2): a receiver
    starting mid-frame sees SF1/2/3 within at most one frame, like real
    signal — cold-start TTFF tests depend on this alignment.
    """
    d29s = d30s = 0
    bits: list[np.ndarray] = []
    for k in range(n_subframes):
        sf_id = ((start_tow_6s + k) % 5) + 1
        words = _subframe_words(eph, sf_id, start_tow_6s + k + 1)
        for w, source in enumerate(words):
            if source.shape[0] == 22:
                source = solve_parity_bits(source, d29s, d30s)
            elif source.shape[0] != 24:
                raise AssertionError(f"word {w} has {source.shape[0]} bits")
            tx = encode_word(source, d29s, d30s)
            d29s, d30s = int(tx[28]), int(tx[29])
            bits.append(tx)
    stream = np.concatenate(bits)
    return np.where(stream == 1, 1.0, -1.0)
