"""Ingest quantizer of the production receiver, on the device.

Counterpart of ``gnss_sdr_tpu/native::complex_to_quantized_i8`` (the
native ``cfloat_quantize_i8`` pass): complex64 samples become a planar
int8 ring at a common scale ``q`` (scale, clip to +-127, truncate toward
zero). The tracking observables are scale-invariant ratios, so the
engines widen the ring to float inside their correlator loads.
"""

from __future__ import annotations

import numpy as np
import torch

#: samples converted per host-to-device copy (bounds the float staging)
CHUNK = 1 << 24


def complex_to_quantized_i8(samples: np.ndarray, q: float,
                            device="cuda") -> torch.Tensor:
    """[2, N] int8 ring (re plane, im plane) of ``samples`` on ``device``."""
    samples = np.ascontiguousarray(samples, dtype=np.complex64)
    n = samples.shape[0]
    out = torch.empty((2, n), dtype=torch.int8, device=device)
    flat = samples.view(np.float32).reshape(n, 2)
    for lo in range(0, n, CHUNK):
        x = torch.as_tensor(flat[lo:lo + CHUNK], device=device)
        x = torch.clamp(x * np.float32(q), -127.0, 127.0).to(torch.int8)
        out[:, lo:lo + x.shape[0]] = x.t()
    return out
