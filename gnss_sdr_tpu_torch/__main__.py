"""Command-line receiver: ``python -m gnss_sdr_tpu_torch -c rx.conf``.

Port of ``gnss_sdr_tpu/__main__.py`` (gnss-sdr's main.cc:66-204): loads
an INI configuration, applies the gflags-style overrides to every
configured signal group, assembles the signal source, the signal
conditioner and the receiver through the factory on ``--device`` (the
card by default) and prints the fixes as NMEA GGA.

- A bounded source (a capture file) is read whole, conditioned in one
  call and run through the production receiver: the GPS L1 C/A receiver
  for a single ``Channels_1C`` group, the multi-band receiver for
  ``Channels_1C`` with ``Channels_1B`` (GPS L1 C/A + Galileo E1).
- A live source (FIFO, UDP) is read in raw chunks of about one second,
  each conditioned with the carried stream state
  (``SignalConditionerChain.apply_stream``) and consumed block by block
  by the scan receiver (:func:`stream`; the multi-band scan receiver for
  two groups), until the source ends or the user interrupts; then the
  source is closed.

The TCP telecommand server is not ported yet.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


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
    # accepted and, as in the JAX CLI, applied to nothing (ROADMAP §3,
    # faults of the reference that the port mirrors)
    p.add_argument("--cn0_min", type=float, default=None)
    p.add_argument("--max_lock_fail", type=int, default=None)
    p.add_argument("--kml", default=None, help="write KML track here")
    p.add_argument("--telecommand_port", type=int, default=0,
                   help="TCP telecommand server (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


#: last receiver built by :func:`main` (test/introspection hook)
last_receiver = None


def stream(source, conditioner, receiver, on_fix=None) -> int:
    """The streaming branch: raw chunks of about one second from
    ``source.read_block`` through ``conditioner.apply_stream`` (when there
    is one) into ``receiver.process_block``, one block plus overlap at a
    time, until the source raises ``EOFError``. Calls ``on_fix`` with
    every new fix; returns the number of samples processed."""
    block = receiver.block_samples
    overlap = receiver.overlap
    raw_chunk = int(getattr(source, "fs", 0) or 4e6)
    buf = np.zeros(0, dtype=np.complex64)
    pos = 0
    while True:
        while len(buf) < block + overlap:
            try:
                fresh = source.read_block(raw_chunk)
            except EOFError:
                return pos
            if conditioner is not None:
                fresh = conditioner.apply_stream(fresh)
            buf = np.concatenate([buf, fresh])
        for sol in receiver.process_block(buf[:block + overlap]):
            if on_fix is not None:
                on_fix(sol)
        buf = buf[block:]
        pos += block


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
    from gnss_sdr_tpu_torch.receiver.factory import (_configured_suffixes,
                                                     make_receiver,
                                                     make_signal_conditioner,
                                                     make_signal_source)

    config = FileConfiguration(args.config_file)
    # gflags-style overrides apply to EVERY configured signal group, as
    # the reference's flags do (gnss_sdr_flags.cc:25-66 are global knobs)
    overrides = {"SignalSource.filename": args.signal_source}
    for sx in _configured_suffixes(config) or ["1C"]:
        overrides.update({
            f"Acquisition_{sx}.doppler_max": args.doppler_max,
            f"Acquisition_{sx}.doppler_step": args.doppler_step,
            f"Tracking_{sx}.pll_bw_hz": args.pll_bw_hz,
            f"Tracking_{sx}.dll_bw_hz": args.dll_bw_hz,
        })
    config.apply_overrides(
        {k: str(v) for k, v in overrides.items() if v is not None})

    source = make_signal_source(config)
    if source is None:
        print("ERROR: SignalSource.implementation missing", file=sys.stderr)
        return 2
    conditioner = make_signal_conditioner(config, device=args.device)
    bounded = getattr(source, "n_samples", None)
    # live sources stream block by block through the scan receiver;
    # bounded captures run the production fast path end to end
    receiver = make_receiver(config, engine=None if bounded else "scan",
                             device=args.device)
    last_receiver = receiver

    kml = KmlWriter(args.kml) if args.kml else None

    def emit(sol):
        print(nmea_gga(sol.lat_rad, sol.lon_rad, sol.height_m, sol.n_sats,
                       sol.hdop), end="")
        if kml:
            kml.add_fix(sol.lat_rad, sol.lon_rad, sol.height_m)

    pos = 0
    try:
        if bounded:
            samples = source.read(0, bounded)
            if conditioner is not None:
                samples = conditioner.apply(samples)
            receiver.run(samples)
            pos = len(samples)
            for sol in receiver.solutions:
                emit(sol)
        else:
            pos = stream(source, conditioner, receiver, emit)
    except KeyboardInterrupt:
        pass
    finally:
        if kml:
            kml.close()
        close = getattr(source, "close", None)
        if close is not None:
            close()
    fast = getattr(receiver, "in_fast_mode", None)
    engine = "scan" if fast is None else f"production fast_mode={fast}"
    print(f"processed {pos} samples, {len(receiver.solutions)} fixes "
          f"[engine={engine}, device={args.device}]", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
