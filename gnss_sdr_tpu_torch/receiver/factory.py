"""Configuration-driven receiver assembly.

Port of ``gnss_sdr_tpu/receiver/factory.py`` (gnss-sdr's GNSSBlockFactory
+ flowgraph wiring, gnss_block_factory.cc:637-1330): a reference-style
INI names implementations per role and the factory builds the production
(fast-engine) receiver, or the scan receiver with
``GNSS-SDR.engine=scan``: the GPS L1 C/A receiver for a single
``Channels_1C`` group, the multi-band receiver for ``Channels_1C`` and
``Channels_1B`` groups together or ``Channels_1B`` alone; the signal
conditioner chain in front of it and every signal source of the JAX
package. Unknown names raise with the supported list. Every branch the
port does not have yet (the other channel groups, the PPP/RTK/RINEX/
monitor PVT block) raises ``NotImplementedError`` naming its ROADMAP
item.
"""

from __future__ import annotations

from gnss_sdr_tpu_torch.config import Configuration
from gnss_sdr_tpu_torch.receiver.bands import PORTED_SUFFIXES
from gnss_sdr_tpu_torch.receiver.receiver import Receiver, ReceiverConfig
from gnss_sdr_tpu_torch.sources.file_source import FileSignalSource

SUPPORTED_SOURCES = {
    "File_Signal_Source",
    "File_Timestamp_Signal_Source",
    "Fifo_Signal_Source",
    "Custom_UDP_Signal_Source",
    "Labsat_Signal_Source",
}
SUPPORTED_ACQ = {"GPS_L1_CA_PCPS_Acquisition",
                 "GPS_L1_CA_PCPS_Assisted_Acquisition",
                 "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler"}
SUPPORTED_ENGINES = {"production", "scan"}
SUPPORTED_TRK = {"GPS_L1_CA_DLL_PLL_Tracking"}
SUPPORTED_TLM = {"GPS_L1_CA_Telemetry_Decoder"}
SUPPORTED_OBS = {"Hybrid_Observables"}
SUPPORTED_PVT = {"RTKLIB_PVT"}

# Per-signal-suffix implementation names the multi-band receiver chain
# accepts (reference factory registry, gnss_block_factory.cc:637-1330):
# suffix -> (acquisition names, tracking names, telemetry names, default
# satellite list). The names are the JAX package's; as there, the KF and
# Gaussian tracking names and the E5a IQ-CAF acquisition name are
# accepted and then built as the DLL/PLL and PCPS blocks (ROADMAP §3).
_GLONASS_SATS = list(range(1, 25))
BAND_REGISTRY: dict[str, tuple[set, set, set, list[int]]] = {
    "1C": ({"GPS_L1_CA_PCPS_Acquisition",
            "GPS_L1_CA_PCPS_Assisted_Acquisition",
            "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler"},
           {"GPS_L1_CA_DLL_PLL_Tracking", "GPS_L1_CA_KF_Tracking",
            "GPS_L1_CA_Gaussian_Tracking"},
           {"GPS_L1_CA_Telemetry_Decoder"}, list(range(1, 33))),
    "2S": ({"GPS_L2_M_PCPS_Acquisition"},
           {"GPS_L2_M_DLL_PLL_Tracking"},
           {"GPS_L2C_Telemetry_Decoder"}, list(range(1, 33))),
    "L5": ({"GPS_L5i_PCPS_Acquisition"},
           {"GPS_L5_DLL_PLL_Tracking"},
           {"GPS_L5_Telemetry_Decoder"}, list(range(1, 33))),
    "1B": ({"Galileo_E1_PCPS_Ambiguous_Acquisition"},
           {"Galileo_E1_DLL_PLL_VEML_Tracking"},
           {"Galileo_E1B_Telemetry_Decoder"}, list(range(1, 37))),
    "5X": ({"Galileo_E5a_Pcps_Acquisition",
            "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF"},
           {"Galileo_E5a_DLL_PLL_Tracking"},
           {"Galileo_E5a_Telemetry_Decoder"}, list(range(1, 37))),
    "7X": ({"Galileo_E5b_PCPS_Acquisition"},
           {"Galileo_E5b_DLL_PLL_Tracking"},
           {"Galileo_E5b_Telemetry_Decoder"}, list(range(1, 37))),
    "E6": ({"Galileo_E6_PCPS_Acquisition"},
           {"Galileo_E6_DLL_PLL_Tracking"},
           {"Galileo_E6_Telemetry_Decoder"}, list(range(1, 37))),
    "1G": ({"GLONASS_L1_CA_PCPS_Acquisition"},
           {"GLONASS_L1_CA_DLL_PLL_Tracking",
            "GLONASS_L1_CA_DLL_PLL_C_Aid_Tracking"},
           {"GLONASS_L1_CA_Telemetry_Decoder"}, _GLONASS_SATS),
    "2G": ({"GLONASS_L2_CA_PCPS_Acquisition"},
           {"GLONASS_L2_CA_DLL_PLL_Tracking",
            "GLONASS_L2_CA_DLL_PLL_C_Aid_Tracking"},
           {"GLONASS_L2_CA_Telemetry_Decoder"}, _GLONASS_SATS),
    "B1": ({"BEIDOU_B1I_PCPS_Acquisition"},
           {"BEIDOU_B1I_DLL_PLL_Tracking"},
           {"BEIDOU_B1I_Telemetry_Decoder"}, list(range(1, 38))),
    "B3": ({"BEIDOU_B3I_PCPS_Acquisition"},
           {"BEIDOU_B3I_DLL_PLL_Tracking"},
           {"BEIDOU_B3I_Telemetry_Decoder"}, list(range(1, 38))),
    # SBAS corrections channels (PRN 120-138 on GPS-family C/A codes)
    "S1": ({"GPS_L1_CA_PCPS_Acquisition"},
           {"GPS_L1_CA_DLL_PLL_Tracking"},
           {"SBAS_L1_Telemetry_Decoder"}, list(range(120, 139))),
}


def _check(name: str, value: str, supported: set[str]) -> None:
    if value and value not in supported:
        raise ValueError(
            f"{name}.implementation={value!r} is not available; "
            f"supported: {sorted(supported)}")


def _todo(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to gnss_sdr_tpu_torch yet (ROADMAP queue 1, "
        f"{item})")


def make_signal_conditioner(config: Configuration, device="cuda"):
    """SignalConditioner / DataTypeAdapter / InputFilter / Resampler
    groups assembled into a :class:`SignalConditionerChain` on ``device``
    (signal_conditioner.cc:37-85); ``None`` when the conf runs the source
    straight into the receiver (Pass_Through)."""
    impl = config.property("SignalConditioner.implementation", "")
    if not impl or impl == "Pass_Through":
        return None
    if impl != "Signal_Conditioner":
        raise ValueError(
            f"SignalConditioner.implementation={impl!r} is not available; "
            f"supported: ['Pass_Through', 'Signal_Conditioner']")
    from gnss_sdr_tpu_torch.conditioner.chain import (SUPPORTED_ADAPTERS,
                                                      SignalConditionerChain)

    _check("DataTypeAdapter",
           config.property("DataTypeAdapter.implementation", ""),
           SUPPORTED_ADAPTERS)
    fs_in = float(config.property("SignalSource.sampling_frequency",
                                  4_000_000))
    fs_internal = float(config.property("GNSS-SDR.internal_fs_sps", fs_in))
    cutoff = config.property("InputFilter.cutoff_hz", None)
    trans = config.property("InputFilter.transition_hz", None)
    chain = SignalConditionerChain(
        fs_in=fs_in,
        input_filter=config.property("InputFilter.implementation",
                                     "Pass_Through") or "Pass_Through",
        if_freq_hz=float(config.property("InputFilter.IF", 0.0)),
        decimation=int(config.property("InputFilter.decimation_factor", 1)),
        ntaps=int(config.property("InputFilter.number_of_taps",
                                  config.property("InputFilter.taps", 65))),
        cutoff_hz=float(cutoff) if cutoff is not None else None,
        transition_hz=float(trans) if trans is not None else None,
        resampler=config.property("Resampler.implementation",
                                  "Pass_Through") or "Pass_Through",
        resample_fs_out=float(config.property("Resampler.sample_freq_out",
                                              fs_internal)),
        pb_threshold_sigma=float(config.property(
            "InputFilter.pb_threshold_sigma", 4.0)),
        device=device,
    )
    if abs(chain.fs_out - fs_internal) > 1.0:
        raise ValueError(
            f"conditioner output rate {chain.fs_out} sps does not match "
            f"GNSS-SDR.internal_fs_sps={fs_internal}; fix the "
            "InputFilter.decimation_factor / Resampler.sample_freq_out "
            "keys (the reference flowgraph has the same invariant)")
    return chain


def make_signal_source(config: Configuration):
    impl = config.property("SignalSource.implementation", "")
    if not impl:
        return None
    _check("SignalSource", impl, SUPPORTED_SOURCES)
    if config.property("SignalConditioner.implementation", "") \
            == "Signal_Conditioner":
        # with a conditioner configured the source runs at the raw
        # front-end rate; the chain delivers internal_fs_sps
        fs = float(config.property("SignalSource.sampling_frequency",
                                   4_000_000))
    else:
        fs = float(config.property(
            "GNSS-SDR.internal_fs_sps",
            config.property("SignalSource.sampling_frequency", 4_000_000)))
    item_type = config.property("SignalSource.item_type", "gr_complex")
    if impl == "Fifo_Signal_Source":
        from gnss_sdr_tpu_torch.sources import FifoSignalSource

        return FifoSignalSource(
            config.property("SignalSource.filename", ""), fs,
            item_type=config.property("SignalSource.sample_type", item_type))
    if impl == "Custom_UDP_Signal_Source":
        from gnss_sdr_tpu_torch.sources import UdpSignalSource

        return UdpSignalSource(
            port=config.property("SignalSource.port", 1234),
            sampling_frequency=fs,
            sample_type=config.property("SignalSource.sample_type", "cbyte"),
            iq_swap=config.property("SignalSource.IQ_swap", False),
            address=config.property("SignalSource.origin_address",
                                    "127.0.0.1"))
    if impl == "Labsat_Signal_Source":
        from gnss_sdr_tpu_torch.sources import LabsatSignalSource

        return LabsatSignalSource(
            config.property("SignalSource.filename", ""),
            sampling_frequency=fs)
    if impl == "File_Timestamp_Signal_Source":
        from gnss_sdr_tpu_torch.sources import FileTimestampSignalSource

        return FileTimestampSignalSource(
            config.property("SignalSource.filename", ""),
            config.property("SignalSource.timestamp_filename", ""),
            sampling_frequency=fs, item_type=item_type,
            timestamp_clock_offset_ms=config.property(
                "SignalSource.timestamp_clock_offset_ms", 0.0),
            samples=config.property("SignalSource.samples", 0))
    return FileSignalSource(
        config.property("SignalSource.filename", ""),
        sampling_frequency=fs,
        item_type=item_type,
        samples=config.property("SignalSource.samples", 0),
        repeat=config.property("SignalSource.repeat", False),
    )


def _configured_suffixes(config: Configuration) -> list[str]:
    """Signal suffixes with ``Channels_XX.count > 0`` (the reference's
    channel-group convention, gnss_block_factory.cc:183-210)."""
    return [sx for sx in BAND_REGISTRY
            if int(config.property(f"Channels_{sx}.count", 0)) > 0]


def make_band_config(config: Configuration, sx: str):
    """One band's :class:`BandConfig` from ``Acquisition_XX`` /
    ``Tracking_XX`` / ``Channels_XX`` keys."""
    from gnss_sdr_tpu_torch.receiver.bands import BandConfig, todo_band

    if sx not in PORTED_SUFFIXES:
        raise todo_band(sx)
    acqs, trks, tlms, default_sats = BAND_REGISTRY[sx]
    _check(f"Acquisition_{sx}",
           config.property(f"Acquisition_{sx}.implementation", ""), acqs)
    _check(f"Tracking_{sx}",
           config.property(f"Tracking_{sx}.implementation", ""), trks)
    _check(f"TelemetryDecoder_{sx}",
           config.property(f"TelemetryDecoder_{sx}.implementation", ""),
           tlms)
    sats_text = config.property(f"Channels_{sx}.satellites", "")
    satellites = ([int(s) for s in sats_text.replace(";", ",").split(",")]
                  if sats_text else list(default_sats))
    fs = config.property(f"SignalSource_{sx}.sampling_frequency", None)
    return BandConfig(
        suffix=sx,
        fs=float(fs) if fs is not None else None,
        satellites=satellites,
        n_channels=int(config.property(f"Channels_{sx}.count", 4)),
        doppler_max=float(config.property(
            f"Acquisition_{sx}.doppler_max", 5000)),
        doppler_step=float(config.property(
            f"Acquisition_{sx}.doppler_step", 250)),
        acq_pfa=config.property(f"Acquisition_{sx}.pfa", 0.001),
        acq_dwells=config.property(f"Acquisition_{sx}.max_dwells", 2),
        pll_bw_hz=config.property(f"Tracking_{sx}.pll_bw_hz", 35.0),
        dll_bw_hz=config.property(f"Tracking_{sx}.dll_bw_hz", 2.0),
        enable_fll_pull_in=config.property(
            f"Tracking_{sx}.enable_fll_pull_in", True),
        fll_bw_hz=config.property(f"Tracking_{sx}.fll_bw_hz", 35.0),
        pull_in_time_s=float(config.property(
            f"Tracking_{sx}.pull_in_time_s", 0.5)),
        early_late_space_chips=config.property(
            f"Tracking_{sx}.early_late_space_chips", 0.5),
        track_pilot=config.property(f"Tracking_{sx}.track_pilot", False),
    )


def make_multiband_receiver(config: Configuration, suffixes: list[str],
                            engine: str = "production", device="cuda"):
    """Assemble the multi-band receiver for the configured signal suffix
    groups (gnss_flowgraph.cc:2156 set_signals_list + the factory's
    channel loop): the fast-engine :class:`ProductionMultiBandReceiver`
    with ``engine="production"`` (default), the per-period
    :class:`MultiBandReceiver` with ``"scan"``."""
    from gnss_sdr_tpu_torch.receiver.multiband import (MultiBandConfig,
                                                       MultiBandReceiver)

    _check("Observables",
           config.property("Observables.implementation", ""), SUPPORTED_OBS)
    _check("PVT", config.property("PVT.implementation", ""), SUPPORTED_PVT)
    fs = float(config.property("GNSS-SDR.internal_fs_sps", 4_000_000))
    cfg = MultiBandConfig(
        fs=fs,
        interval_ms=config.property("GNSS-SDR.observable_interval_ms", 20),
        output_rate_ms=config.property("PVT.output_rate_ms", 100),
        enable_carrier_smoothing=config.property(
            "Observables.enable_carrier_smoothing", False),
        smoothing_factor=config.property(
            "Observables.smoothing_factor", 200),
    )
    bands = [make_band_config(config, sx) for sx in suffixes]
    agnss = _load_agnss(config)
    assisted = ({("G", p): e for p, e in agnss.items()} if agnss else None)
    if engine == "production":
        from gnss_sdr_tpu_torch.receiver.production_multiband import (
            ProductionMultiBandReceiver)

        return ProductionMultiBandReceiver(cfg, bands,
                                           assisted_ephemeris=assisted,
                                           device=device)
    return MultiBandReceiver(cfg, bands, assisted_ephemeris=assisted,
                             device=device)


def make_receiver(config: Configuration, satellites=None,
                  engine: str | None = None, device="cuda"):
    """Build a receiver from reference-style configuration keys.

    A single ``Channels_1C`` group (or none) builds the GPS L1 receiver;
    ``Channels_1C`` with ``Channels_1B``, or ``Channels_1B`` alone, the
    multi-band receiver over one common-rate stream. By default the
    production (fast-engine) receiver is returned, the scan receiver with
    ``GNSS-SDR.engine=scan`` or ``engine="scan"`` (the CLI's choice for
    unbounded live sources)."""
    if engine is None:
        engine = config.property("GNSS-SDR.engine", "production")
    _check("GNSS-SDR.engine", engine, SUPPORTED_ENGINES)
    suffixes = _configured_suffixes(config)
    for sx in suffixes:
        if sx not in PORTED_SUFFIXES:
            from gnss_sdr_tpu_torch.receiver.bands import todo_band

            raise todo_band(sx)
    # the JAX package routes these options through the multi-band
    # receiver's PVT block, which the port does not have yet
    if config.property("PVT.positioning_mode", "Single") != "Single":
        raise _todo("PVT.positioning_mode other than Single",
                    "step 8g, the multi-band PVT block (PPP/RTK)")
    if config.property("PVT.rinex_output_enabled", False):
        raise _todo("RINEX output", "step 8g, the multi-band PVT block")
    if config.property("PVT.iono_model", "") == "IFLC":
        raise _todo("the ionosphere-free combination (PVT.iono_model=IFLC)",
                    "step 8g, the multi-band PVT block")
    if any(config.property(k, False) for k in (
            "Monitor.enable_monitor", "TrackingMonitor.enable_monitor",
            "AcquisitionMonitor.enable_monitor",
            "NavDataMonitor.enable_monitor", "PVT.enable_monitor",
            "PVT.enable_monitor_ephemeris")):
        raise _todo("UDP monitors", "step 8g, the multi-band PVT block")
    if suffixes and suffixes != ["1C"]:
        return make_multiband_receiver(config, suffixes, engine, device)
    return _make_l1_receiver(config, satellites, engine, device)


def _load_agnss(config: Configuration):
    """Assisted GPS ephemerides from the AGNSS XML surface."""
    path = config.property("GNSS-SDR.AGNSS_gps_ephemeris_xml", "")
    if not path:
        return None
    from gnss_sdr_tpu_torch.receiver.assistance import load_ephemeris_xml

    return load_ephemeris_xml(path)


def _make_l1_receiver(config: Configuration, satellites=None,
                      engine: str = "production", device="cuda"):
    """Build a GPS L1 C/A receiver from reference-style configuration keys."""
    _check("Acquisition_1C",
           config.property("Acquisition_1C.implementation", ""),
           SUPPORTED_ACQ)
    _check("Tracking_1C",
           config.property("Tracking_1C.implementation", ""), SUPPORTED_TRK)
    _check("TelemetryDecoder_1C",
           config.property("TelemetryDecoder_1C.implementation", ""),
           SUPPORTED_TLM)
    _check("Observables",
           config.property("Observables.implementation", ""), SUPPORTED_OBS)
    _check("PVT", config.property("PVT.implementation", ""), SUPPORTED_PVT)

    fs = float(config.property("GNSS-SDR.internal_fs_sps", 4_000_000))
    # extended coherent integration after bit sync: the production engine
    # closes its loops once per K-symbol group; K=1 keeps the scan engine
    ext_k = int(config.property(
        "Tracking_1C.extend_correlation_symbols",
        20 if engine == "production" else 1))
    if ext_k <= 1:
        engine = "scan"
    cfg = ReceiverConfig(
        fs=fs,
        n_channels=config.property("Channels_1C.count", 8),
        extend_correlation_symbols=ext_k,
        pll_bw_narrow_hz=config.property("Tracking_1C.pll_bw_narrow_hz", 5.0),
        dll_bw_narrow_hz=config.property(
            "Tracking_1C.dll_bw_narrow_hz", 0.75),
        doppler_max=float(config.property("Acquisition_1C.doppler_max", 5000)),
        doppler_step=float(config.property("Acquisition_1C.doppler_step", 250)),
        acq_pfa=config.property("Acquisition_1C.pfa", 0.001),
        acq_dwells=config.property("Acquisition_1C.max_dwells", 2),
        pll_bw_hz=config.property("Tracking_1C.pll_bw_hz", 35.0),
        dll_bw_hz=config.property("Tracking_1C.dll_bw_hz", 2.0),
        enable_fll_pull_in=config.property(
            "Tracking_1C.enable_fll_pull_in", True),
        fll_bw_hz=config.property("Tracking_1C.fll_bw_hz", 35.0),
        pull_in_time_s=float(config.property(
            "Tracking_1C.pull_in_time_s", 0.5)),
        early_late_space_chips=config.property(
            "Tracking_1C.early_late_space_chips", 0.5),
        interval_ms=config.property("GNSS-SDR.observable_interval_ms", 20),
        output_rate_ms=config.property("PVT.output_rate_ms", 100),
        enable_carrier_smoothing=config.property(
            "Observables.enable_carrier_smoothing", False),
        smoothing_factor=config.property(
            "Observables.smoothing_factor", 200),
    )
    if satellites is None:
        sats_text = config.property("Channels_1C.satellites", "")
        satellites = ([int(s) for s in sats_text.replace(";", ",").split(",")]
                      if sats_text else list(range(1, 33)))
    agnss = _load_agnss(config)
    if engine == "production":
        from gnss_sdr_tpu_torch.receiver.production import ProductionReceiver

        return ProductionReceiver(cfg, satellites=satellites,
                                  assisted_ephemeris=agnss, device=device)
    return Receiver(cfg, satellites=satellites, assisted_ephemeris=agnss,
                    device=device)
