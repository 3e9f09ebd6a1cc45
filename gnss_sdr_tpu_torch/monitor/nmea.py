"""NMEA-0183 sentence generation (GGA / RMC).

Counterpart of gnss-sdr/src/algorithms/PVT/libs/nmea_printer.cc:
standard talker sentences with checksum, fed from PvtSolution.

Copied from ``gnss_sdr_tpu/monitor/nmea.py``; only the import paths differ.
"""

from __future__ import annotations

import datetime
import math


def nmea_sentence(body: str) -> str:
    """Wrap a sentence body with $, checksum and CRLF."""
    csum = 0
    for ch in body:
        csum ^= ord(ch)
    return f"${body}*{csum:02X}\r\n"


def _format_lat(lat_rad: float) -> tuple[str, str]:
    lat = math.degrees(lat_rad)
    hemi = "N" if lat >= 0 else "S"
    lat = abs(lat)
    deg = int(lat)
    minutes = (lat - deg) * 60.0
    return f"{deg:02d}{minutes:09.6f}", hemi


def _format_lon(lon_rad: float) -> tuple[str, str]:
    lon = math.degrees(lon_rad)
    hemi = "E" if lon >= 0 else "W"
    lon = abs(lon)
    deg = int(lon)
    minutes = (lon - deg) * 60.0
    return f"{deg:03d}{minutes:09.6f}", hemi


def nmea_gga(
    lat_rad: float, lon_rad: float, height_m: float, n_sats: int,
    hdop: float, utc: datetime.datetime | None = None, fix_quality: int = 1,
) -> str:
    utc = utc or datetime.datetime.now(datetime.timezone.utc)
    lat_s, ns = _format_lat(lat_rad)
    lon_s, ew = _format_lon(lon_rad)
    body = (f"GPGGA,{utc:%H%M%S}.00,{lat_s},{ns},{lon_s},{ew},"
            f"{fix_quality},{n_sats:02d},{hdop:.1f},{height_m:.1f},M,"
            f"0.0,M,,")
    return nmea_sentence(body)


def nmea_rmc(
    lat_rad: float, lon_rad: float, speed_mps: float = 0.0,
    course_deg: float = 0.0, utc: datetime.datetime | None = None,
) -> str:
    utc = utc or datetime.datetime.now(datetime.timezone.utc)
    lat_s, ns = _format_lat(lat_rad)
    lon_s, ew = _format_lon(lon_rad)
    knots = speed_mps * 1.9438445
    body = (f"GPRMC,{utc:%H%M%S}.00,A,{lat_s},{ns},{lon_s},{ew},"
            f"{knots:.2f},{course_deg:.2f},{utc:%d%m%y},,,A")
    return nmea_sentence(body)
