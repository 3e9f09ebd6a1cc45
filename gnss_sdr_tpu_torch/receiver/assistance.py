"""Assistance data persistence (warm/hot start).

Counterpart of the reference's XML assistance store
(Gnss_Sdr_Supl_Client::{load,save}_*_xml via boost::serialization,
gnss-sdr/src/core/libs/gnss_sdr_supl_client.cc; default filenames
in control_thread.h:159-172; loaded by
ControlThread::read_assistance_from_XML). The receiver's persistent state
is the ephemeris/almanac/iono/UTC set; saving it at exit and reloading at
startup enables warm starts. Schema here is a plain XML mapping of the
GpsEphemeris fields (the reference's boost archive layout is
library-specific, so compatibility is at the semantic level).

Copied from ``gnss_sdr_tpu/receiver/assistance.py``; only the import paths differ.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

from gnss_sdr_tpu_torch.pvt.ephemeris import GpsEphemeris

DEFAULT_EPH_XML = "gps_ephemeris.xml"


def save_ephemeris_xml(
    ephemerides: dict[int, GpsEphemeris], path: str | os.PathLike
) -> str:
    root = ET.Element("GNSS-SDR-TPU-ephemeris-map")
    for prn in sorted(ephemerides):
        eph = ephemerides[prn]
        node = ET.SubElement(root, "ephemeris", PRN=str(prn))
        for field in dataclasses.fields(eph):
            value = getattr(eph, field.name)
            ET.SubElement(node, field.name).text = repr(value)
    tree = ET.ElementTree(root)
    ET.indent(tree)
    tree.write(path, encoding="unicode", xml_declaration=True)
    return str(path)


def load_ephemeris_xml(path: str | os.PathLike) -> dict[int, GpsEphemeris]:
    tree = ET.parse(path)
    out: dict[int, GpsEphemeris] = {}
    field_types = {f.name: f.type for f in dataclasses.fields(GpsEphemeris)}
    for node in tree.getroot().findall("ephemeris"):
        kwargs = {}
        for child in node:
            if child.tag not in field_types:
                continue
            text = child.text or "0"
            kwargs[child.tag] = (int(text) if field_types[child.tag] == "int"
                                 else float(text))
        eph = GpsEphemeris(**kwargs)
        out[int(node.get("PRN"))] = eph
    return out
