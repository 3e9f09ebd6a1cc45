"""Observables computation (reference layer L4, observables role).

Copied from ``gnss_sdr_tpu/observables/__init__.py``; only the import paths differ.
"""

from gnss_sdr_tpu_torch.observables.observables import (
    ChannelEpoch,
    ObservablesEngine,
)

__all__ = ["ChannelEpoch", "ObservablesEngine"]
