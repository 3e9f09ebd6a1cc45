"""Kalman-filter carrier/code tracking (KF variant) on torch tensors.

Port of ``gnss_sdr_tpu/ops/kalman.py`` (the reference's ``kf_tracking``
block, kf_tracking.cc run_Kf :1129-1166): a 4-state filter

    x = [code_phase_chips, carrier_phase_rad, carrier_doppler_hz,
         doppler_rate_hz_s]

propagated per integration interval T and corrected by the DLL/PLL
discriminator outputs. The transition and noise matrices are built on the
host in numpy, as in the JAX package; the step is the K6a kernel
(``kernels/loops.py``), its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from gnss_sdr_tpu_torch.kernels import loops

TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class KfConfig:
    chip_rate_cps: float = 1.023e6
    carrier_hz: float = 1575.42e6
    # process noise PSDs (reference kf_conf defaults' roles)
    q_code: float = 1e-4         # code phase random walk [chips^2/s]
    q_phase: float = 1e-2        # carrier phase [rad^2/s]
    q_doppler: float = 1.0       # Doppler random walk [Hz^2/s]
    q_doppler_rate: float = 1e-1  # Doppler-rate random walk [Hz^2/s^3]
    r_code: float = 1e-2         # code discriminator variance [chips^2]
    r_phase: float = 0.05        # phase discriminator variance [rad^2]


class KfState(NamedTuple):
    x: torch.Tensor   # [C, 4]
    p: torch.Tensor   # [C, 4, 4]


def kf_init(code_phase_chips, carrier_phase_rad, doppler_hz,
            p0=(1.0, 10.0, 100.0, 10.0), device="cpu") -> KfState:
    """Fresh state; the arguments are scalars or [C] arrays."""
    def col(v):
        return torch.as_tensor(np.array(v, np.float32), device=device)

    d = col(doppler_hz)
    x = torch.stack([col(code_phase_chips), col(carrier_phase_rad), d,
                     torch.zeros_like(d)], dim=-1)
    p = torch.diag(torch.as_tensor(np.asarray(p0, np.float32),
                                   device=device))
    return KfState(x=x, p=p.expand(x.shape[:-1] + (4, 4)).clone())


def _transition(cfg: KfConfig, t: float) -> np.ndarray:
    """F (4x4) with code-carrier coupling (Doppler drives both phases)."""
    beta = cfg.chip_rate_cps / cfg.carrier_hz  # chips per carrier cycle
    f = np.eye(4, dtype=np.float32)
    f[0, 2] = beta * t                 # code phase <- Doppler [Hz]*t cycles
    f[0, 3] = 0.5 * beta * t * t
    f[1, 2] = TWO_PI * t               # carrier phase <- Doppler
    f[1, 3] = np.pi * t * t
    f[2, 3] = t
    return f


def _process_noise(cfg: KfConfig, t: float) -> np.ndarray:
    return np.diag(np.asarray([
        cfg.q_code * t, cfg.q_phase * t, cfg.q_doppler * t,
        cfg.q_doppler_rate * t], dtype=np.float32))


@functools.lru_cache(maxsize=32)
def _matrices(cfg: KfConfig, t: float):
    r = np.asarray([cfg.r_code, cfg.r_phase], dtype=np.float32)
    return _transition(cfg, t), np.diag(_process_noise(cfg, t)).copy(), r


def kf_step(state: KfState, code_err_chips, phase_err_rad, t: float,
            cfg: KfConfig):
    """One predict + update for every channel; the measurements are the
    discriminator errors (innovations) relative to the propagated state.
    Returns ``(new_state, delta)``, ``delta`` [C, 4] the measurement
    correction; ``x`` holds the corrected absolute phases and Doppler."""
    f, q, r = _matrices(cfg, float(t))
    x, p = state.x, state.p
    batch = x.shape[:-1]
    x2, p2 = x.reshape(-1, 4), p.reshape(-1, 4, 4)

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=x.device).reshape(-1).expand(
                                   x2.shape[0])

    x_new, p_new, delta = loops.kf_step(x2, p2, col(code_err_chips),
                                        col(phase_err_rad), f, q, r)
    return (KfState(x=x_new.reshape(batch + (4,)),
                    p=p_new.reshape(batch + (4, 4))),
            delta.reshape(batch + (4,)))
