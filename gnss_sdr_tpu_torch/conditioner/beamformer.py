"""Antenna-array beamformer (weighted channel combiner).

Port of ``gnss_sdr_tpu/conditioner/beamformer.py``, the counterpart of
gnss-sdr's ``Beamformer_Filter`` (gnuradio_blocks/beamformer.cc:54-60:
per-sample sum of the 8 antenna channels times a complex weight vector),
plus the steering-vector helpers for a uniform linear array. The
combination is the K7e kernel (``kernels/conditioner.py::
beamform_complex``) on the card, reading the complex64 capture as it is
(JAX splits it into float32 planes on the host), and its plain version,
JAX's einsums, on the CPU.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from gnss_sdr_tpu_torch.device import resolve_device
from gnss_sdr_tpu_torch.kernels.conditioner import beamform_complex


def steering_weights(n_antennas: int, spacing_wavelengths: float,
                     steer_deg: float) -> np.ndarray:
    """Phase-steering weights for a uniform linear array: w_m =
    exp(-j 2 pi d m sin(theta)) / M (conventional beamformer); copied from
    ``gnss_sdr_tpu/conditioner/beamformer.py``."""
    m = np.arange(n_antennas)
    phase = -2.0 * math.pi * spacing_wavelengths * m * math.sin(
        math.radians(steer_deg))
    return np.exp(1j * phase) / n_antennas


def array_response(n_antennas: int, spacing_wavelengths: float,
                   doa_deg: float) -> np.ndarray:
    """Plane-wave array manifold vector for a ULA; copied from
    ``gnss_sdr_tpu/conditioner/beamformer.py``."""
    m = np.arange(n_antennas)
    phase = 2.0 * math.pi * spacing_wavelengths * m * math.sin(
        math.radians(doa_deg))
    return np.exp(1j * phase)


class BeamformerFilter:
    """Stateless M-channel -> 1-channel combiner (adapter role) on
    ``device``."""

    def __init__(self, weights: np.ndarray, device="cuda"):
        w = np.asarray(weights, dtype=np.complex64)
        self.device = resolve_device(device)
        self._w_re = torch.as_tensor(np.ascontiguousarray(w.real),
                                     device=self.device)
        self._w_im = torch.as_tensor(np.ascontiguousarray(w.imag),
                                     device=self.device)
        self.n_antennas = w.shape[0]
        #: wall seconds of the last ``apply``: host->device copy, device
        #: work, device->host copy
        self.timings: dict[str, float] = {}

    @classmethod
    def steered(cls, n_antennas: int = 8, spacing_wavelengths: float = 0.5,
                steer_deg: float = 0.0, device="cuda") -> "BeamformerFilter":
        return cls(steering_weights(n_antennas, spacing_wavelengths,
                                    steer_deg), device=device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def apply(self, x: np.ndarray) -> np.ndarray:
        """[M, N] complex -> [N] complex64. The capture goes to the device
        as one complex64 array and the output comes back as one."""
        x = np.asarray(x)
        if x.shape[0] != self.n_antennas:
            raise ValueError(
                f"expected {self.n_antennas} antenna channels, "
                f"got {x.shape[0]}")
        t0 = time.perf_counter()
        xd = torch.from_numpy(np.ascontiguousarray(x, np.complex64)).to(
            self.device)
        self._sync()
        t1 = time.perf_counter()
        y = beamform_complex(xd, self._w_re, self._w_im)
        self._sync()
        t2 = time.perf_counter()
        out = y.cpu().numpy()
        self.timings = {"h2d_s": t1 - t0, "device_s": t2 - t1,
                        "d2h_s": time.perf_counter() - t2}
        return out
