"""Per-signal acquisition factories.

Port of ``gnss_sdr_tpu/acquisition/adapters.py``: sampled PRN replicas
and the acquisition engines configured from a ``Configuration`` role
section (Acq_Conf::SetFromConfiguration semantics), the per-signal
replica catalogue and the implementation-name registry, whose every name
:func:`make_acquisition` builds: PCPS, Tong, QuickSync, CCCWSR and the
E5a noncoherent I/Q CAF engine. The receiver bands themselves exist for
``1C`` and ``1B`` only (``receiver/bands.py``).
"""

from __future__ import annotations

import numpy as np

from gnss_sdr_tpu_torch.acquisition.pcps import AcqConfig, PcpsAcquisition
from gnss_sdr_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_tpu_torch.codes.sampling import sample_code_floor
from gnss_sdr_tpu_torch.config import Configuration
from gnss_sdr_tpu_torch.constants import get_signal


def acq_config_from(config: Configuration, role: str, fs: float,
                    signal_suffix: str = "1C") -> AcqConfig:
    """Read ``role.*`` keys into an AcqConfig (acq_conf.cc defaults)."""
    sig = get_signal(signal_suffix)
    samples_per_code = sig.samples_per_code(fs)
    return AcqConfig(
        fs=fs,
        samples_per_code=samples_per_code,
        code_length_chips=sig.code_length_chips,
        ms_per_code=int(round(sig.code_period_ms)),
        doppler_max=float(config.property(f"{role}.doppler_max", 5000)),
        doppler_step=float(config.property(f"{role}.doppler_step", 500)),
        doppler_center=float(config.property(f"{role}.doppler_center", 0)),
        sampled_ms=config.property(
            f"{role}.coherent_integration_time_ms",
            int(round(sig.code_period_ms))),
        max_dwells=config.property(f"{role}.max_dwells", 1),
        pfa=config.property(f"{role}.pfa", 0.0),
        threshold=config.property(f"{role}.threshold", 0.0),
        bit_transition_flag=config.property(f"{role}.bit_transition_flag",
                                            False),
        use_cfar=config.property(f"{role}.use_CFAR_algorithm", True),
        make_2_steps=config.property(f"{role}.make_two_steps", False),
        doppler_step2=float(config.property(f"{role}.second_doppler_step",
                                            125)),
        num_doppler_bins_step2=config.property(f"{role}.second_nbins", 4),
        pfa2=config.property(f"{role}.pfa_second_step", 0.0),
        repeat_steps=config.property(f"{role}.make_repeat_steps", False),
    )


def gps_l1ca_replicas(prns, fs: float,
                      sampled_ms: int = 1) -> dict[int, np.ndarray]:
    """Sampled complex C/A replicas (floor-convention digitization, chips
    in the real part), tiled to the coherent length
    (gps_l1_ca_pcps_acquisition.cc:145-165)."""
    out = {}
    for prn in prns:
        one = sample_code_floor(
            gps_l1ca_code(prn), fs, 1.023e6).astype(np.complex64)
        out[prn] = np.tile(one, sampled_ms)
    return out


def galileo_e1_replicas(prns, fs: float, component: str = "B",
                        cboc: bool = True) -> dict[int, np.ndarray]:
    """Sampled CBOC/sinBOC E1 replicas over one 4 ms code period
    (Galileo_E1_PCPS_Ambiguous_Acquisition adapter semantics,
    galileo_e1_pcps_ambiguous_acquisition.cc)."""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1_sampled

    return {
        prn: galileo_e1_sampled(prn, fs, component, cboc).astype(np.complex64)
        for prn in prns
    }


def make_galileo_e1_acquisition(prns, fs: float,
                                config: Configuration | None = None,
                                role: str = "Acquisition_1B",
                                component: str = "B", cboc: bool = True,
                                device="cuda",
                                **overrides) -> PcpsAcquisition:
    """Galileo E1 PCPS acquisition (4 ms coherent by default).

    Two-step fine Doppler is on by default: with 4 ms coherent periods
    the pull-in FLL's unambiguous range is +-1/(4T) = +-62.5 Hz, exactly
    the worst-case error of a 125 Hz coarse grid; the +-15 Hz two-step
    residual is safely inside it (Acq_Conf::make_2_steps, acq_conf.h:74;
    pcps_acquisition.cc:697-771)."""
    if config is not None:
        cfg = acq_config_from(config, role, fs, "1B")
    else:
        sig = get_signal("1B")
        cfg = AcqConfig(
            fs=fs,
            samples_per_code=sig.samples_per_code(fs),
            code_length_chips=sig.code_length_chips,
            ms_per_code=4,
            sampled_ms=4,
            doppler_step=125.0,
            make_2_steps=True,
            doppler_step2=31.25,
            num_doppler_bins_step2=8,
        )
    for key, value in overrides.items():
        setattr(cfg, key, value)
    codes = galileo_e1_replicas(prns, fs, component, cboc)
    return PcpsAcquisition(cfg, codes, device=device)


def make_gps_l1ca_acquisition(prns, fs: float,
                              config: Configuration | None = None,
                              role: str = "Acquisition_1C", device="cuda",
                              **overrides) -> PcpsAcquisition:
    """GPS L1 C/A PCPS acquisition for a set of PRNs."""
    if config is not None:
        cfg = acq_config_from(config, role, fs, "1C")
    else:
        sig = get_signal("1C")
        cfg = AcqConfig(
            fs=fs,
            samples_per_code=sig.samples_per_code(fs),
            code_length_chips=sig.code_length_chips,
            ms_per_code=1,
        )
    for key, value in overrides.items():
        setattr(cfg, key, value)
    codes = gps_l1ca_replicas(prns, fs, cfg.sampled_ms)
    return PcpsAcquisition(cfg, codes, device=device)


def signal_replicas(suffix: str, prns, fs: float, sampled_ms: int = 0,
                    component: str | None = None) -> dict[int, np.ndarray]:
    """Sampled complex acquisition replicas for any supported signal,
    tiled to ``sampled_ms``; ``component`` picks the E1 B/C, the E5a,
    E5b and L5 I/Q and the E6 B/C codes.

    The per-signal chip sources mirror the reference adapters'
    *_code_gen_complex_sampled calls (src/algorithms/acquisition/
    adapters/). GLONASS FDMA slots all share the single m-sequence; the
    per-slot carrier offset is a Doppler center, not part of the code.
    """
    from gnss_sdr_tpu_torch.codes.beidou_b1i import beidou_b1i_code
    from gnss_sdr_tpu_torch.codes.beidou_b3i import beidou_b3i_code
    from gnss_sdr_tpu_torch.codes.galileo_e5a import galileo_e5a_code
    from gnss_sdr_tpu_torch.codes.galileo_e5b_e6 import (galileo_e5b_code,
                                                         galileo_e6_code)
    from gnss_sdr_tpu_torch.codes.glonass_l1ca import glonass_l1ca_code
    from gnss_sdr_tpu_torch.codes.gps_l2c import gps_l2cm_code
    from gnss_sdr_tpu_torch.codes.gps_l5 import gps_l5i_code, gps_l5q_code

    sig = get_signal(suffix)
    sampled_ms = sampled_ms or int(round(sig.code_period_ms))
    periods = max(1, int(round(sampled_ms / sig.code_period_ms)))

    def chips_for(prn: int) -> np.ndarray:
        if suffix == "1C":
            return gps_l1ca_code(prn)
        if suffix == "2S":
            return gps_l2cm_code(prn)
        if suffix == "L5":
            return (gps_l5q_code(prn) if component == "Q"
                    else gps_l5i_code(prn))
        if suffix == "5X":
            return galileo_e5a_code(prn, component or "I")
        if suffix == "7X":
            return galileo_e5b_code(prn, component or "I")
        if suffix == "E6":
            return galileo_e6_code(prn, component or "B")
        if suffix in ("1G", "2G"):
            return glonass_l1ca_code()
        if suffix == "B1":
            return beidou_b1i_code(prn)
        if suffix == "B3":
            return beidou_b3i_code(prn)
        raise ValueError(f"no acquisition replica source for {suffix!r}")

    if suffix == "1B":
        one = galileo_e1_replicas(prns, fs, component or "B", cboc=True)
        return {prn: np.tile(code, periods) for prn, code in one.items()}
    out = {}
    for prn in prns:
        one = sample_code_floor(chips_for(prn), fs,
                                sig.chip_rate_cps).astype(np.complex64)
        out[prn] = np.tile(one, periods)
    return out


def make_acquisition(implementation: str, prns, fs: float,
                     config: Configuration | None = None,
                     role: str | None = None, device="cuda", **overrides):
    """Instantiate an acquisition engine from a reference implementation
    name (GNSSBlockFactory::GetAcqBlock counterpart). Raises ValueError
    with the list of known names on an unknown implementation."""
    spec = ACQ_IMPLEMENTATIONS.get(implementation)
    if spec is None:
        raise ValueError(
            f"Unknown acquisition implementation {implementation!r}; "
            f"known: {sorted(ACQ_IMPLEMENTATIONS)}")
    suffix, variant, defaults = spec
    role = role or f"Acquisition_{suffix}"
    if config is not None:
        cfg = acq_config_from(config, role, fs, suffix)
    else:
        sig = get_signal(suffix)
        cfg = AcqConfig(
            fs=fs, samples_per_code=sig.samples_per_code(fs),
            code_length_chips=sig.code_length_chips,
            ms_per_code=int(round(sig.code_period_ms)),
            sampled_ms=int(round(sig.code_period_ms)),
        )
    merged = {**defaults, **overrides}
    caf_window_hz = merged.pop("caf_window_hz", 0.0)
    both_components = merged.pop("both_signal_components", True)
    for key, value in merged.items():
        setattr(cfg, key, value)
    if variant == "cccwsr":
        from gnss_sdr_tpu_torch.acquisition.variants import CccwsrAcquisition

        data = signal_replicas(suffix, prns, fs, cfg.sampled_ms, "B")
        pilot = signal_replicas(suffix, prns, fs, cfg.sampled_ms, "C")
        return CccwsrAcquisition(cfg, data, pilot, device=device)
    if variant == "nciq_caf":
        from gnss_sdr_tpu_torch.acquisition.variants import \
            NoncoherentIQCafAcquisition

        data = signal_replicas(suffix, prns, fs, cfg.sampled_ms, "I")
        pilot = signal_replicas(suffix, prns, fs, cfg.sampled_ms, "Q")
        return NoncoherentIQCafAcquisition(
            cfg, data, pilot, both_signal_components=bool(both_components),
            caf_window_hz=float(caf_window_hz), device=device)
    codes = signal_replicas(suffix, prns, fs, cfg.sampled_ms)
    if variant == "quicksync":
        from gnss_sdr_tpu_torch.acquisition.variants import \
            QuickSyncAcquisition

        folding = (config.property(f"{role}.folding_factor", 2)
                   if config is not None
                   else overrides.get("folding_factor", 2))
        return QuickSyncAcquisition(cfg, codes, folding_factor=int(folding),
                                    device=device)
    if variant == "tong":
        from gnss_sdr_tpu_torch.acquisition.tong import TongAcquisition

        return TongAcquisition(cfg, codes, device=device)
    return PcpsAcquisition(cfg, codes, device=device)


# implementation name -> (signal suffix, engine variant, AcqConfig overrides)
ACQ_IMPLEMENTATIONS: dict[str, tuple[str, str, dict]] = {
    "GPS_L1_CA_PCPS_Acquisition": ("1C", "pcps", {}),
    "GPS_L1_CA_PCPS_Assisted_Acquisition": ("1C", "pcps", {}),
    "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler": (
        "1C", "pcps", {"make_2_steps": True}),
    "GPS_L1_CA_PCPS_Tong_Acquisition": ("1C", "tong", {}),
    "GPS_L1_CA_PCPS_QuickSync_Acquisition": ("1C", "quicksync", {}),
    "GPS_L2_M_PCPS_Acquisition": ("2S", "pcps", {"sampled_ms": 20}),
    "GPS_L5i_PCPS_Acquisition": ("L5", "pcps", {}),
    "Galileo_E1_PCPS_Ambiguous_Acquisition": (
        "1B", "pcps", {"sampled_ms": 4}),
    "Galileo_E1_PCPS_8ms_Ambiguous_Acquisition": (
        "1B", "pcps", {"sampled_ms": 8}),
    "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition": (
        "1B", "cccwsr", {"sampled_ms": 4}),
    "Galileo_E1_PCPS_Tong_Ambiguous_Acquisition": (
        "1B", "tong", {"sampled_ms": 4}),
    "Galileo_E1_PCPS_QuickSync_Ambiguous_Acquisition": (
        "1B", "quicksync", {"sampled_ms": 4}),
    "Galileo_E5a_Pcps_Acquisition": ("5X", "pcps", {}),
    "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF": ("5X", "nciq_caf", {}),
    "Galileo_E5b_PCPS_Acquisition": ("7X", "pcps", {}),
    "Galileo_E6_PCPS_Acquisition": ("E6", "pcps", {}),
    "GLONASS_L1_CA_PCPS_Acquisition": ("1G", "pcps", {}),
    "GLONASS_L2_CA_PCPS_Acquisition": ("2G", "pcps", {}),
    "BEIDOU_B1I_PCPS_Acquisition": ("B1", "pcps", {}),
    "BEIDOU_B3I_PCPS_Acquisition": ("B3", "pcps", {}),
}
