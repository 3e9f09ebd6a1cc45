"""Command-line receiver: ``python -m gnss_sdr_tpu_torch -c rx.conf``.

Port of the bounded-file path of ``gnss_sdr_tpu/__main__.py`` (gnss-sdr's
main.cc:66-204): loads an INI configuration, applies the gflags-style
overrides, assembles the receiver through the factory, runs the whole
capture on ``--device`` (the card by default) and prints the fixes as
NMEA GGA. Live sources and the telecommand server are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gnss_sdr_tpu_torch")
    p.add_argument("--config_file", "-c", required=True,
                   help="INI configuration (reference dialect)")
    p.add_argument("--signal_source", "-s", default=None,
                   help="override SignalSource.filename")
    p.add_argument("--doppler_max", type=float, default=None)
    p.add_argument("--doppler_step", type=float, default=None)
    p.add_argument("--pll_bw_hz", type=float, default=None)
    p.add_argument("--dll_bw_hz", type=float, default=None)
    p.add_argument("--kml", default=None, help="write KML track here")
    p.add_argument("--telecommand_port", type=int, default=0,
                   help="TCP telecommand server (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


#: last receiver built by :func:`main` (test/introspection hook)
last_receiver = None


def main(argv=None) -> int:
    global last_receiver
    args = build_parser().parse_args(argv)
    if args.telecommand_port:
        raise NotImplementedError(
            "the TCP telecommand server is not ported to gnss_sdr_tpu_torch "
            "yet (ROADMAP queue 1, step 12, control and live sources)")

    from gnss_sdr_tpu_torch.config import FileConfiguration
    from gnss_sdr_tpu_torch.monitor.geo_writers import KmlWriter
    from gnss_sdr_tpu_torch.monitor.nmea import nmea_gga
    from gnss_sdr_tpu_torch.receiver.factory import (make_receiver,
                                                     make_signal_conditioner,
                                                     make_signal_source)

    config = FileConfiguration(args.config_file)
    overrides = {
        "SignalSource.filename": args.signal_source,
        "Acquisition_1C.doppler_max": args.doppler_max,
        "Acquisition_1C.doppler_step": args.doppler_step,
        "Tracking_1C.pll_bw_hz": args.pll_bw_hz,
        "Tracking_1C.dll_bw_hz": args.dll_bw_hz,
    }
    config.apply_overrides(
        {k: str(v) for k, v in overrides.items() if v is not None})

    source = make_signal_source(config)
    if source is None:
        print("ERROR: SignalSource.implementation missing", file=sys.stderr)
        return 2
    make_signal_conditioner(config)
    receiver = make_receiver(config, device=args.device)
    last_receiver = receiver

    kml = KmlWriter(args.kml) if args.kml else None
    samples = source.read(0, source.n_samples)
    try:
        receiver.run(samples)
        for sol in receiver.solutions:
            print(nmea_gga(sol.lat_rad, sol.lon_rad, sol.height_m,
                           sol.n_sats, sol.hdop), end="")
            if kml:
                kml.add_fix(sol.lat_rad, sol.lon_rad, sol.height_m)
    finally:
        if kml:
            kml.close()
    fast = getattr(receiver, "in_fast_mode", None)
    engine = "scan" if fast is None else f"production fast_mode={fast}"
    print(f"processed {len(samples)} samples, {len(receiver.solutions)} "
          f"fixes [engine={engine}, device={args.device}]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
