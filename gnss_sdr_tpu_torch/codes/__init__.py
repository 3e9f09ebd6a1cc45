"""PRN replica generators (reference layer L5).

Host-side NumPy: codes are generated once per (signal, PRN) and cached; the
device kernels consume the resulting arrays. Counterpart of
gnss-sdr/src/algorithms/libs/{gps_sdr_signal_replica,
galileo_e1_signal_replica, ...}.cc.

Copied from ``gnss_sdr_tpu/codes/__init__.py``; only the import paths differ.
"""

from gnss_sdr_tpu_torch.codes.gps_l1ca import gps_l1ca_code
from gnss_sdr_tpu_torch.codes.sampling import sample_code, samples_per_code

__all__ = ["gps_l1ca_code", "sample_code", "samples_per_code"]
