"""Gaussian carrier tracking: Kalman phase filter + Bayesian adaptive R.

Port of ``gnss_sdr_tpu/ops/gaussian.py`` (the reference's
``GPS_L1_CA_Gaussian_Tracking`` block, gps_l1_ca_gaussian_tracking_cc.cc:
652-760, with the normal-inverse-Wishart sequential estimation of the
measurement covariance, bayesian_estimation.cc:88-130). An error-state
filter: the phase state carries only the not-yet-applied correction,
which each step returns for the NCO remnant and resets to zero. The
matrices are built on the host in numpy, as in the JAX package; the step
is the K6b kernel (``kernels/loops.py``), its plain version on the CPU.
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
class GaussianConfig:
    """Knobs of the Gaussian tracking loop (reference ctor + adapter)."""

    order: int = 3                 # 2 = phase/Doppler, 3 = +Doppler rate
    # Bayesian covariance estimation (reference bce_* properties)
    bayes_run: bool = True
    p_transient: int = 20          # KF iterations before NIW updates start
    s_transient: int = 50          # further iterations before R_est is used
    bce_kappa: int = 0
    bce_nu: int = 0
    # initial-uncertainty priors (gps_l1_ca_gaussian_tracking_cc.cc:171-175)
    sigma2_phase: float = TWO_PI / 4.0        # [rad^2]
    sigma2_doppler: float = 450.0             # [Hz^2]
    sigma2_doppler_rate: float = (4.0 * TWO_PI) ** 2 / 12.0  # [Hz^2/s^2]
    init_cn0_db_hz: float = 30.0


class GaussState(NamedTuple):
    """Carrier-KF + NIW carry; every field has a leading channel axis."""

    x: torch.Tensor        # [C, order] (phase err [rad], Doppler [Hz], rate)
    p: torch.Tensor        # [C, order, order]
    niw_iter: torch.Tensor  # [C] int32 KF iterations since (re)init
    niw_n: torch.Tensor    # [C] int32 NIW observation count
    niw_mu: torch.Tensor   # [C] float32 posterior measurement mean
    niw_psi: torch.Tensor  # [C] float32 posterior scatter


def phase_detector_variance(cn0_db_hz, t: float):
    """sigma^2 of the atan phase detector [rad^2] at C/N0 and coherent T
    (gps_l1_ca_gaussian_tracking_cc.cc:675-677), float32."""
    cn0 = torch.as_tensor(cn0_db_hz, dtype=torch.float32)
    return loops.phase_detector_variance_plain(cn0, t)


def _p_ini(cfg: GaussianConfig) -> np.ndarray:
    d = [cfg.sigma2_phase, cfg.sigma2_doppler]
    if cfg.order == 3:
        d.append(cfg.sigma2_doppler_rate)
    return np.diag(np.asarray(d, dtype=np.float32))


def gaussian_init(doppler_hz, cfg: GaussianConfig, t: float,
                  device="cpu") -> GaussState:
    """Fresh per-channel state at tracking start; ``doppler_hz`` is a
    scalar or [C], ``t`` the coherent integration period [s]."""
    if cfg.order not in (2, 3):
        raise ValueError("order must be 2 or 3")
    dop = torch.as_tensor(np.array(doppler_hz, np.float32), device=device)
    zeros = torch.zeros_like(dop)
    cols = [zeros, dop] + ([zeros] if cfg.order == 3 else [])
    x = torch.stack(cols, dim=-1)
    p = torch.as_tensor(_p_ini(cfg), device=device).expand(
        x.shape[:-1] + (cfg.order, cfg.order)).clone()
    # Psi prior = (H P_ini H^T + R(30 dBHz)) * (nu + 2)  (ctor :228)
    r30 = float(phase_detector_variance(cfg.init_cn0_db_hz, t))
    psi0 = (float(cfg.sigma2_phase) + r30) * (cfg.bce_nu + 2.0)
    return GaussState(
        x=x, p=p,
        niw_iter=torch.zeros_like(dop, dtype=torch.int32),
        niw_n=torch.zeros_like(dop, dtype=torch.int32),
        niw_mu=zeros.clone(),
        niw_psi=torch.full_like(dop, psi0),
    )


def _transition(cfg: GaussianConfig, t: float) -> np.ndarray:
    """F per gps_l1_ca_gaussian_tracking_cc.cc:187-216."""
    if cfg.order == 2:
        return np.asarray([[1.0, TWO_PI * t], [0.0, 1.0]], dtype=np.float32)
    return np.asarray([
        [1.0, TWO_PI * t, 0.5 * TWO_PI * t * t],
        [0.0, 1.0, t],
        [0.0, 0.0, 1.0]], dtype=np.float32)


def _process_noise(cfg: GaussianConfig, t: float) -> np.ndarray:
    """Q = diag(T^4, T[, T]) (ctor :183-209)."""
    d = [t ** 4, t] + ([t] if cfg.order == 3 else [])
    return np.diag(np.asarray(d, dtype=np.float32))


@functools.lru_cache(maxsize=32)
def step_params(cfg: GaussianConfig, t: float) -> dict:
    """The K6b launch parameters of ``cfg`` at coherent time ``t``."""
    return dict(f=_transition(cfg, t),
                q=np.diag(_process_noise(cfg, t)).copy(), t=t,
                bayes_run=cfg.bayes_run, p_transient=cfg.p_transient,
                s_transient=cfg.s_transient, bce_kappa=cfg.bce_kappa,
                bce_nu=cfg.bce_nu)


def gaussian_step(state: GaussState, phase_err_rad, cn0_db_hz, t: float,
                  cfg: GaussianConfig):
    """One carrier-KF iteration for all channels. Returns ``(new_state,
    info)``; ``info`` holds ``phase_corr_rad`` (the phase increment to add
    to the NCO remnant beyond the nominal Doppler rotation),
    ``carrier_doppler_hz``, ``doppler_rate_hz_s`` and ``r_est`` (the
    measurement variance in use)."""
    x = state.x
    dev = x.device
    batch = x.shape[:-1]
    n = x.shape[-1]
    c = int(np.prod(batch)) if batch else 1

    def col(v, dtype=torch.float32):
        return torch.as_tensor(v, dtype=dtype, device=dev).reshape(
            -1).expand(c).contiguous()

    out = loops.gaussian_step(
        x.reshape(c, n), state.p.reshape(c, n, n),
        col(state.niw_iter, torch.int32), col(state.niw_n, torch.int32),
        col(state.niw_mu), col(state.niw_psi), col(phase_err_rad),
        col(cn0_db_hz), step_params(cfg, float(t)))
    x_out, p_out, it, nn, mu, psi, info = out
    new = GaussState(x=x_out.reshape(batch + (n,)),
                     p=p_out.reshape(batch + (n, n)),
                     niw_iter=it.reshape(batch), niw_n=nn.reshape(batch),
                     niw_mu=mu.reshape(batch), niw_psi=psi.reshape(batch))
    keys = ("phase_corr_rad", "carrier_doppler_hz", "doppler_rate_hz_s",
            "r_est")
    return new, {k: info[i].reshape(batch) for i, k in enumerate(keys)}
