"""GPS L1 C/A acquisition factory.

Port of the GPS L1 C/A part of ``gnss_sdr_tpu/acquisition/adapters.py``:
sampled PRN replicas and the PCPS engine configured from a
``Configuration`` role section (Acq_Conf::SetFromConfiguration semantics).
The other signals' replicas and the implementation-name registry belong
to the multi-band path (ROADMAP).
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
    if signal_suffix != "1C":
        raise NotImplementedError(
            f"signal {signal_suffix!r}: only GPS L1 C/A (1C) is ported")
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
