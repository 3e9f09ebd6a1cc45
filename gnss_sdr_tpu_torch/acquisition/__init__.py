"""Acquisition engines (counterpart of ``gnss_sdr_tpu/acquisition``): the
batched PCPS engine, the Tong detector over it and, in
``acquisition/variants.py``, the QuickSync, CCCWSR and E5a I/Q searches."""

from gnss_sdr_tpu_torch.acquisition.pcps import (AcqConfig, AcqResult,
                                                 PcpsAcquisition)
from gnss_sdr_tpu_torch.acquisition.tong import TongAcquisition

__all__ = ["AcqConfig", "AcqResult", "PcpsAcquisition", "TongAcquisition"]
