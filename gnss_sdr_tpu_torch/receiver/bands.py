"""Band construction of the multi-band receiver.

Port of ``BandConfig`` and ``_Band`` of
``gnss_sdr_tpu/receiver/multiband.py``, kept apart from the receiver's
positioning-mode dispatch (``receiver/multiband.py``): one band is a
signal suffix with its acquisition engine, its tracking channels, its
per-channel telemetry decoders and the code tables its channels track.
The port builds GPS L1 C/A (``1C``) and Galileo E1 (``1B``, on E1-B or,
with ``track_pilot``, on the E1-C pilot with the E1-B data component);
every other suffix of the JAX package raises ``NotImplementedError``
naming its ROADMAP step.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from gnss_sdr_tpu_torch.acquisition.adapters import (
    make_galileo_e1_acquisition, make_gps_l1ca_acquisition)
from gnss_sdr_tpu_torch.codes import gps_l1ca_code
from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1_subchips
from gnss_sdr_tpu_torch.pvt import GpsEphemeris
from gnss_sdr_tpu_torch.receiver.fsm import ChannelFsm
from gnss_sdr_tpu_torch.telemetry.galileo_inav import (
    GalileoInavDecoder, galileo_ephemeris_from_inav)
from gnss_sdr_tpu_torch.telemetry.gps_lnav import GpsLnavDecoder
from gnss_sdr_tpu_torch.tracking.channels import TrackingChannels
from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig

#: the bands the port builds
PORTED_SUFFIXES = ("1C", "1B")
#: suffix -> the ROADMAP step that ports it
_TODO_BANDS = {
    "L5": "step 8b, the L5/E5a/E5b/E6 pilots",
    "5X": "step 8b, the L5/E5a/E5b/E6 pilots",
    "7X": "step 8b, the L5/E5a/E5b/E6 pilots",
    "E6": "step 8b, the L5/E5a/E5b/E6 pilots",
    "B1": "step 8c, BeiDou",
    "B3": "step 8c, BeiDou",
    "1G": "step 8d, GLONASS FDMA",
    "2G": "step 8d, GLONASS FDMA",
    "2S": "step 8e, GPS L2C",
    "S1": "step 8f, SBAS",
}


def todo_band(suffix: str) -> NotImplementedError:
    """The refusal of a band the port does not build yet."""
    step = _TODO_BANDS.get(suffix, "step 8, the multi-band path")
    return NotImplementedError(
        f"band {suffix!r} is not ported to gnss_sdr_tpu_torch yet "
        f"(ROADMAP queue 1, {step})")


@dataclasses.dataclass
class BandConfig:
    suffix: str                  # "1C" or "1B" (ROADMAP step 8: the rest)
    #: per-band sample rate (RF_channels may run different front-end
    #: rates); None inherits MultiBandConfig.fs. Anchors are rescaled to
    #: the common timebase before the observables engine.
    fs: float | None = None
    satellites: list[int] = dataclasses.field(default_factory=list)
    n_channels: int = 4
    doppler_max: float = 5000.0
    doppler_step: float = 250.0
    acq_pfa: float = 0.001
    acq_dwells: int = 2
    pll_bw_hz: float = 35.0
    dll_bw_hz: float = 2.0
    enable_fll_pull_in: bool = True
    fll_bw_hz: float = 35.0
    pull_in_time_s: float = 0.5
    early_late_space_chips: float = 0.5
    #: close the loops on the pilot component where the signal has one
    #: (Tracking_XX.track_pilot; E1-C CS25)
    track_pilot: bool = False


class Band:
    """One signal band: acquisition, tracking channels, decoders."""

    def __init__(self, cfg: BandConfig, fs: float, block_ms: int,
                 ch_offset: int, device="cuda"):
        self.cfg = cfg
        self.fs = fs
        self.block_samples = int(round(fs * block_ms * 1e-3))
        self.ch_offset = ch_offset
        self.sat_pool = collections.deque(cfg.satellites)
        self.fsms = [ChannelFsm(ch_offset + i) for i in range(cfg.n_channels)]
        self.data_code_table = None      # dual-component bands only
        sx = cfg.suffix
        if sx == "1C":
            self.system = "G"
            self.period_ms = 1.0
            self.acq = make_gps_l1ca_acquisition(
                sorted(cfg.satellites), fs, doppler_max=cfg.doppler_max,
                doppler_step=cfg.doppler_step, pfa=cfg.acq_pfa,
                max_dwells=cfg.acq_dwells, device=device)
            trk = TrackingConfig(
                fs=fs, pll_bw_hz=cfg.pll_bw_hz, dll_bw_hz=cfg.dll_bw_hz,
                enable_fll_pull_in=cfg.enable_fll_pull_in,
                fll_bw_hz=cfg.fll_bw_hz, pull_in_time_s=cfg.pull_in_time_s,
                early_late_space_chips=cfg.early_late_space_chips)
            self.code_table = lambda prn: np.asarray(
                gps_l1ca_code(prn), dtype=np.float32)
            self.new_decoder = GpsLnavDecoder
        elif sx == "1B":
            self.system = "E"
            self.period_ms = 4.0
            self.acq = make_galileo_e1_acquisition(
                sorted(cfg.satellites), fs, doppler_max=cfg.doppler_max,
                doppler_step=min(cfg.doppler_step, 125.0), pfa=cfg.acq_pfa,
                max_dwells=cfg.acq_dwells, device=device)
            trk = TrackingConfig(
                fs=fs, code_length_chips=4092, chip_rate_cps=1.023e6,
                code_samples_per_chip=12, veml=True, symbols_per_bit=1,
                pll_bw_hz=min(cfg.pll_bw_hz, 20.0), dll_bw_hz=cfg.dll_bw_hz,
                enable_fll_pull_in=cfg.enable_fll_pull_in,
                fll_bw_hz=cfg.fll_bw_hz, pull_in_time_s=cfg.pull_in_time_s,
                early_late_space_chips=0.15,
                very_early_late_space_chips=0.6,
                track_pilot=cfg.track_pilot)
            if cfg.track_pilot:
                # E1-C pilot tracking (Tracking_1B.track_pilot=true, the
                # reference's default E1 configuration,
                # dll_pll_veml_tracking.cc:211-246): loops close on the
                # CS25-wiped pilot, I/NAV symbols come from the E1-B
                # data-code correlation on the same phase (both
                # components ride the in-phase carrier)
                self.code_table = lambda prn: galileo_e1_subchips(
                    prn, "C", True)
                self.data_code_table = lambda prn: galileo_e1_subchips(
                    prn, "B", True)
            else:
                self.code_table = lambda prn: galileo_e1_subchips(
                    prn, "B", True)
            self.new_decoder = GalileoInavDecoder
        else:
            raise todo_band(sx)
        self.tracking = TrackingChannels(trk, cfg.n_channels,
                                         self.block_samples, device=device)
        self.decoders = [self.new_decoder() for _ in range(cfg.n_channels)]

    @property
    def carrier_hz(self) -> float:
        """The band's carrier (the CDMA bands the port builds have no
        per-satellite FDMA slot, ROADMAP step 8d)."""
        return self.tracking.cfg.carrier_hz

    def make_ephemeris(self, prn: int, decoder):
        if self.system == "G":
            return GpsEphemeris.from_fields(prn, decoder.ephemeris_fields)
        return galileo_ephemeris_from_inav(prn, decoder.ephemeris_fields)
