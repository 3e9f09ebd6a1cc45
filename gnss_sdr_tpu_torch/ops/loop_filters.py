"""Tracking loop filters on torch tensors.

Port of ``gnss_sdr_tpu/ops/loop_filters.py``: the bilinear-transform
Wiener loop filter of orders 1-3 (gnss-sdr's tracking_loop_filter.cc) and
the FLL-assisted PLL filter (tracking_FLL_PLL_filter.cc), as pure state
transitions over a channel axis. Coefficients are computed on the host in
numpy, exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

HISTORY = 4  # MAX_LOOP_HISTORY_LENGTH (tracking_loop_filter.cc:27)


def loop_filter_coefficients(
    update_interval: float,
    noise_bandwidth: float,
    order: int = 2,
    include_last_integrator: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Input/output coefficient vectors, zero-padded to fixed length
    (Tracking_loop_filter::update_coefficients,
    tracking_loop_filter.cc:97-199). Float32 numpy
    (input_coeffs[HISTORY], output_coeffs[HISTORY-1])."""
    T = float(update_interval)
    zeta = 1.0 / math.sqrt(2.0)
    ic = np.zeros(HISTORY, dtype=np.float32)
    oc = np.zeros(HISTORY - 1, dtype=np.float32)

    if order == 1:
        wn = noise_bandwidth * 4.0
        g1 = wn
        if include_last_integrator:
            ic[0] = g1 * T / 2.0
            ic[1] = g1 * T / 2.0
            oc[0] = 1.0
        else:
            ic[0] = g1
    elif order == 2:
        wn = noise_bandwidth * (8.0 * zeta) / (4.0 * zeta * zeta + 1.0)
        g1 = wn * wn
        g2 = wn * 2.0 * zeta
        if include_last_integrator:
            ic[0] = T / 2.0 * (g1 * T / 2.0 + g2)
            ic[1] = T * T / 2.0 * g1
            ic[2] = T / 2.0 * (g1 * T / 2.0 - g2)
            oc[0] = 2.0
            oc[1] = -1.0
        else:
            ic[0] = g1 * T / 2.0 + g2
            ic[1] = g1 * T / 2.0 - g2
            oc[0] = 1.0
    elif order == 3:
        wn = noise_bandwidth / 0.7845
        a3, b3 = 1.1, 2.4
        g1 = wn * wn * wn
        g2 = a3 * wn * wn
        g3 = b3 * wn
        if include_last_integrator:
            ic[0] = T / 2.0 * (g3 + T / 2.0 * (g2 + T / 2.0 * g1))
            ic[1] = T / 2.0 * (-g3 + T / 2.0 * (g2 + 3.0 * T / 2.0 * g1))
            ic[2] = T / 2.0 * (-g3 - T / 2.0 * (g2 - 3.0 * T / 2.0 * g1))
            ic[3] = T / 2.0 * (g3 - T / 2.0 * (g2 - T / 2.0 * g1))
            oc[0] = 3.0
            oc[1] = -3.0
            oc[2] = 1.0
        else:
            ic[0] = g3 + T / 2.0 * (g2 + T / 2.0 * g1)
            ic[1] = g1 * T * T / 2.0 - 2.0 * g3
            ic[2] = g3 + T / 2.0 * (-g2 + T / 2.0 * g1)
            oc[0] = 2.0
            oc[1] = -1.0
    else:
        raise ValueError(f"loop order must be 1..3, got {order}")
    return ic, oc


def iir_init(shape=(), initial_output: float = 0.0, device="cpu"):
    """Fresh (x_hist, y_hist) state, both most-recent-first
    (Tracking_loop_filter::initialize, tracking_loop_filter.cc:260-266)."""
    x_hist = torch.zeros(shape + (HISTORY,), dtype=torch.float32,
                         device=device)
    y_hist = torch.full(shape + (HISTORY - 1,), initial_output,
                        dtype=torch.float32, device=device)
    return x_hist, y_hist


def iir_step(state, x, input_coeffs, output_coeffs):
    """One Tracking_loop_filter::apply step (tracking_loop_filter.cc:59-94).

    ``state = (x_hist, y_hist)`` newest first; coefficient tensors as from
    :func:`loop_filter_coefficients`, broadcast against the batch dims."""
    x_hist, y_hist = state
    result = torch.sum(output_coeffs * y_hist, dim=-1)
    x_hist = torch.cat([x[..., None], x_hist[..., :-1]], dim=-1)
    result = result + torch.sum(input_coeffs * x_hist, dim=-1)
    y_hist = torch.cat([result[..., None], y_hist[..., :-1]], dim=-1)
    return (x_hist, y_hist), result


@dataclasses.dataclass(frozen=True)
class FllPllGains:
    """Precomputed analog gains (Tracking_FLL_PLL_filter::set_params)."""

    order: int
    pll_w0p: float
    pll_w0p2: float
    pll_w0p3: float
    pll_w0f: float
    pll_w0f2: float
    pll_a2: float = 1.414
    pll_a3: float = 1.1
    pll_b3: float = 2.4

    @classmethod
    def make(cls, fll_bw_hz: float, pll_bw_hz: float,
             order: int) -> "FllPllGains":
        if order == 3:
            w0p = pll_bw_hz / 0.7845
            w0f = fll_bw_hz / 0.53
        else:
            w0p = pll_bw_hz / 0.53
            w0f = fll_bw_hz / 0.25
        return cls(
            order=order, pll_w0p=w0p, pll_w0p2=w0p * w0p, pll_w0p3=w0p ** 3,
            pll_w0f=w0f, pll_w0f2=w0f * w0f,
        )


def fll_pll_init(gains: FllPllGains, doppler_hz):
    """Initial (pll_w, pll_x) from a Doppler tensor
    (tracking_FLL_PLL_filter.cc:initialize)."""
    d = torch.as_tensor(doppler_hz, dtype=torch.float32)
    if gains.order == 3:
        return torch.zeros_like(d), 2.0 * d
    return d, torch.zeros_like(d)


def fll_pll_step(state, fll_disc, pll_disc, T, gains):
    """One get_carrier_error step (tracking_FLL_PLL_filter.cc:74-105).

    Returns ``(new_state, carrier_error_hz)``; discriminators in Hz.
    ``gains`` fields may be Python floats or per-channel tensors."""
    w, x = state
    if gains.order == 3:
        w_new = w + T * (gains.pll_w0p3 * pll_disc + gains.pll_w0f2 * fll_disc)
        x_new = x + T * (0.5 * w_new + gains.pll_a2 * gains.pll_w0f * fll_disc
                         + gains.pll_a3 * gains.pll_w0p2 * pll_disc)
        err = 0.5 * x_new + gains.pll_b3 * gains.pll_w0p * pll_disc
        return (w_new, x_new), err
    w_new = (w + pll_disc * gains.pll_w0p2 * T + fll_disc * gains.pll_w0f * T)
    err = 0.5 * (w_new + w) + gains.pll_a2 * gains.pll_w0p * pll_disc
    return (w_new, x), err
