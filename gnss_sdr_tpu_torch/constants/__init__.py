"""Signal and system constants (reference layer L6).

Mirrors the per-signal constant headers of the reference
(``src/core/system_parameters/GPS_L1_CA.h`` and siblings). Only constants —
all public ICD facts.

Copied from ``gnss_sdr_tpu/constants/__init__.py``; only the import paths differ.
"""

from gnss_sdr_tpu_torch.constants.general import SPEED_OF_LIGHT_M_S, SPEED_OF_LIGHT_M_MS, TWO_PI
from gnss_sdr_tpu_torch.constants.signals import SIGNALS, SignalDef, get_signal

__all__ = [
    "SPEED_OF_LIGHT_M_S",
    "SPEED_OF_LIGHT_M_MS",
    "TWO_PI",
    "SIGNALS",
    "SignalDef",
    "get_signal",
]
