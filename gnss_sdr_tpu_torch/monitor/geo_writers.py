"""Position-track file writers: KML, GPX, GeoJSON.

Counterparts of gnss-sdr/src/algorithms/PVT/libs/
{kml_printer,gpx_printer,geojson_printer}.cc — streaming writers that
collect fixes and produce a track file.

Copied from ``gnss_sdr_tpu/monitor/geo_writers.py``; only the import paths differ, and only
:class:`KmlWriter` is kept.
"""

from __future__ import annotations

import math
import os


class _TrackWriter:
    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self.points: list[tuple[float, float, float]] = []  # lon, lat, h deg

    def add_fix(self, lat_rad: float, lon_rad: float, height_m: float) -> None:
        self.points.append(
            (math.degrees(lon_rad), math.degrees(lat_rad), height_m))

    def close(self) -> str:
        with open(self.path, "w", encoding="utf-8") as fh:
            fh.write(self.render())
        return self.path


class KmlWriter(_TrackWriter):
    def render(self) -> str:
        coords = "\n".join(f"{lon:.9f},{lat:.9f},{h:.3f}"
                           for lon, lat, h in self.points)
        return (
            '<?xml version="1.0" encoding="UTF-8"?>\n'
            '<kml xmlns="http://www.opengis.net/kml/2.2">\n'
            "<Document><name>GNSS-SDR-TPU track</name>\n"
            "<Placemark><name>track</name><LineString>\n"
            "<altitudeMode>absolute</altitudeMode>\n"
            f"<coordinates>\n{coords}\n</coordinates>\n"
            "</LineString></Placemark>\n</Document>\n</kml>\n"
        )
