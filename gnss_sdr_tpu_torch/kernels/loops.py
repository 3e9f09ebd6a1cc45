"""K6 wrappers: the fast engine's KF and Gaussian loop steps.

- :func:`kf_step` (K6a): one predict + two-measurement update of the
  4-state code/carrier KF for every channel
  (``gnss_sdr_tpu/ops/kalman.py::kf_step``);
- :func:`gaussian_step` (K6b): one iteration of the order-2/3 carrier KF
  with the NIW-adaptive measurement variance
  (``gnss_sdr_tpu/ops/gaussian.py::gaussian_step``).

F, Q and R come from the host as numbers (``ops/kalman.py``,
``ops/gaussian.py`` build them from the configuration and the group
time) and travel by value in the launch, so a step makes no host copy
and no sync. Each takes its ``*_plain`` PyTorch version for a CPU tensor
and launches ``csrc/loops.cu`` for a CUDA tensor. The plain versions
round where the kernels round: a matrix or vector product is the first
term's product and then one fused multiply-add per further term (over
j, then over k, first index first), as the JAX package's einsums run on
the CPU; the fused multiply-add is emulated in float64 (:func:`fma`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb


class KfParams(ctypes.Structure):
    _fields_ = [("f", ctypes.c_float * 16), ("q", ctypes.c_float * 4),
                ("r", ctypes.c_float * 2)]


class GsParams(ctypes.Structure):
    _fields_ = [("f", ctypes.c_float * 9), ("q", ctypes.c_float * 3),
                ("t", ctypes.c_float), ("order", ctypes.c_int),
                ("bayes_run", ctypes.c_int), ("p_transient", ctypes.c_int),
                ("s_transient", ctypes.c_int), ("bce_kappa", ctypes.c_int),
                ("bce_nu", ctypes.c_int)]


def kf_params(f, q, r) -> KfParams:
    """K6a's launch parameters from F [4, 4], diag(Q) [4] and diag(R)
    [2] (float32 numpy)."""
    prm = KfParams()
    prm.f[:] = [float(v) for v in np.asarray(f, np.float32).ravel()]
    prm.q[:] = [float(v) for v in np.asarray(q, np.float32)]
    prm.r[:] = [float(v) for v in np.asarray(r, np.float32)]
    return prm


def gs_params(prm: dict, n: int) -> GsParams:
    """K6b's launch parameters of order ``n`` from
    ``ops/gaussian.py::step_params``."""
    g = GsParams()
    f = np.zeros(9, np.float32)
    f[:n * n] = np.asarray(prm["f"], np.float32).ravel()
    q = np.zeros(3, np.float32)
    q[:n] = np.asarray(prm["q"], np.float32)
    g.f[:] = [float(v) for v in f]
    g.q[:] = [float(v) for v in q]
    g.t = float(np.float32(prm["t"]))
    g.order = n
    g.bayes_run = int(bool(prm["bayes_run"]))
    g.p_transient = int(prm["p_transient"])
    g.s_transient = int(prm["s_transient"])
    g.bce_kappa = int(prm["bce_kappa"])
    g.bce_nu = int(prm["bce_nu"])
    return g


def fma(a, b, c):
    """a * b + c with one rounding to float32 (float64 in between: the
    product of two float32 values is exact there), the kernel's
    ``__fmaf_rn``."""
    return (a.double() * b.double() + c.double()).float()


def dot(a_terms, b_terms):
    """sum_i a_i b_i as the JAX package's dots run on the CPU and the
    kernel runs them: the first product rounded, then one fused
    multiply-add per further term, in index order."""
    out = a_terms[0] * b_terms[0]
    for a, b in zip(a_terms[1:], b_terms[1:]):
        out = fma(a, b, out)
    return out


def predict_plain(f: np.ndarray, q: np.ndarray, x, p):
    """(F x, (F P) F^T + diag(q)) over a leading channel axis; ``f`` is
    the float32 [n, n] transition, ``q`` the float32 diagonal [n]."""
    n = f.shape[0]
    ft = torch.as_tensor(f, device=x.device)
    x_pred = dot([ft[:, j] for j in range(n)],
                 [x[:, j:j + 1] for j in range(n)])
    a = dot([ft[None, :, j, None] for j in range(n)],
            [p[:, None, j, :] for j in range(n)])
    pp = dot([a[:, :, k, None] for k in range(n)],
             [ft[None, None, :, k] for k in range(n)])
    return x_pred, pp + torch.diag(torch.as_tensor(q, device=x.device))


# ---- K6a ---------------------------------------------------------------------

def kf_step_plain(x, p, code_err, phase_err, f, q, r):
    x_pred, pp = predict_plain(f, q, x, p)
    r0, r1 = float(r[0]), float(r[1])
    s00, s01 = pp[:, 0, 0] + r0, pp[:, 0, 1] + 0.0
    s10, s11 = pp[:, 1, 0] + 0.0, pp[:, 1, 1] + r1
    det = fma(s00, s11, -(s01 * s10))
    i00, i01, i10, i11 = s11 / det, -s01 / det, -s10 / det, s00 / det
    ph0, ph1 = pp[:, :, 0], pp[:, :, 1]                          # [C,4]
    k0 = dot([ph0, ph1], [i00[:, None], i10[:, None]])
    k1 = dot([ph0, ph1], [i01[:, None], i11[:, None]])
    delta = dot([k0, k1], [code_err[:, None], phase_err[:, None]])
    khp = dot([k0[:, :, None], k1[:, :, None]],
              [pp[:, None, 0, :], pp[:, None, 1, :]])
    return x_pred + delta, pp - khp, delta


def _f32c(t):
    if t.dtype != torch.float32:
        raise ValueError("float32 tensors expected")
    return t.contiguous()


def kf_step(x, p, code_err, phase_err, f, q, r):
    """(x [C, 4], P [C, 4, 4], delta [C, 4]) after one KF step of
    ``x`` [C, 4], ``p`` [C, 4, 4] with the innovations ``code_err`` and
    ``phase_err`` [C]; ``f`` [4, 4], ``q`` [4] and ``r`` [2] float32
    numpy."""
    if x.device.type == "cpu":
        return kf_step_plain(x, p, code_err, phase_err, f, q, r)
    if x.device.type != "cuda":
        raise ValueError(f"kf_step: unsupported device {x.device}")
    c = x.shape[0]
    if x.shape != (c, 4) or p.shape != (c, 4, 4):
        raise ValueError("kf_step: x [C, 4] and p [C, 4, 4] expected")
    x, p = _f32c(x), _f32c(p)
    code_err, phase_err = _f32c(code_err), _f32c(phase_err)
    prm = kf_params(f, q, r)
    x_out = torch.empty_like(x)
    p_out = torch.empty_like(p)
    delta = torch.empty_like(x)
    err = kb.function("loops", "kf_step", [
        kb.VP, kb.VP, kb.VP, kb.VP, kb.I32, KfParams, kb.VP, kb.VP, kb.VP,
        kb.VP])(
        x.data_ptr(), p.data_ptr(), code_err.data_ptr(),
        phase_err.data_ptr(), c, prm, x_out.data_ptr(), p_out.data_ptr(),
        delta.data_ptr(), kb.stream_ptr())
    kb.check(err, "kf_step")
    LAUNCHES["kf_step"] += 1
    return x_out, p_out, delta


# ---- K6b ---------------------------------------------------------------------

def phase_detector_variance_plain(cn0_db_hz, t: float):
    """sigma^2 [rad^2] of the atan phase detector at C/N0 and coherent T
    (gps_l1_ca_gaussian_tracking_cc.cc:675-677), float32."""
    cn_lin = torch.pow(10.0, cn0_db_hz / 10.0)
    g = 1.0 / (2.0 * cn_lin * float(np.float32(t)))
    return g * (1.0 + g)


def gaussian_step_plain(x, p, niw_iter, niw_n, niw_mu, niw_psi, phase_err,
                        cn0_db_hz, prm: dict):
    """The plain version of :func:`gaussian_step` (same arguments)."""
    y = phase_err
    x_pre, p_pre = predict_plain(prm["f"], prm["q"], x, p)
    x_pre = torch.cat([x[:, :1], x_pre[:, 1:]], dim=1)
    r = phase_detector_variance_plain(cn0_db_hz, prm["t"])
    it = niw_iter
    do_upd = bool(prm["bayes_run"]) & (it >= prm["p_transient"])
    kappa_t = (prm["bce_kappa"] + niw_n).to(torch.float32)
    mu_new = (kappa_t * niw_mu + y) / (kappa_t + 1.0)
    dy = y - niw_mu
    psi_new = niw_psi + kappa_t / (kappa_t + 1.0) * (dy * dy)
    n1 = torch.where(do_upd, niw_n + 1, niw_n)
    mu1 = torch.where(do_upd, mu_new, niw_mu)
    psi1 = torch.where(do_upd, psi_new, niw_psi)
    nu_post = (prm["bce_nu"] + n1).to(torch.float32)
    psi_est = psi1 / torch.where(nu_post - 2.0 > 0.0, nu_post - 2.0,
                                 nu_post + 2.0)
    hph = p_pre[:, 0, 0]
    use_bayes = bool(prm["bayes_run"]) \
        & (it >= prm["p_transient"] + prm["s_transient"])
    tiny = torch.full_like(psi_est, 1e-12)
    p_y = torch.where(use_bayes, torch.maximum(psi_est, tiny), hph + r)
    r_est = torch.where(use_bayes, torch.maximum(psi_est - hph, tiny), r)
    k = p_pre[:, :, 0] / p_y[:, None]
    x_new = x_pre + k * y[:, None]
    p_new = p_pre - k[:, :, None] * p_pre[:, None, 0, :]
    x_out = torch.cat([torch.zeros_like(x_new[:, :1]), x_new[:, 1:]], dim=1)
    rate = x_new[:, 2] if x.shape[1] == 3 else torch.zeros_like(y)
    info = torch.stack([x_new[:, 0], x_new[:, 1], rate, r_est])
    return x_out, p_new, it + 1, n1, mu1, psi1, info


def gaussian_step(x, p, niw_iter, niw_n, niw_mu, niw_psi, phase_err,
                  cn0_db_hz, prm: dict):
    """One Gaussian-loop iteration of every channel: ``x`` [C, n], ``p``
    [C, n, n] (n = 2 or 3), the NIW carry (``niw_iter``, ``niw_n`` int32,
    ``niw_mu``, ``niw_psi`` float32, each [C]), the phase discriminator
    ``phase_err`` and ``cn0_db_hz`` [C]. ``prm`` holds ``f`` [n, n],
    ``q`` [n] (float32 numpy), ``t`` and the configuration's
    ``bayes_run``, ``p_transient``, ``s_transient``, ``bce_kappa`` and
    ``bce_nu``. Returns (x, p, niw_iter, niw_n, niw_mu, niw_psi, info
    [4, C]: phase correction, Doppler, Doppler rate, R in use)."""
    if x.device.type == "cpu":
        return gaussian_step_plain(x, p, niw_iter, niw_n, niw_mu, niw_psi,
                                   phase_err, cn0_db_hz, prm)
    if x.device.type != "cuda":
        raise ValueError(f"gaussian_step: unsupported device {x.device}")
    c, n = x.shape
    if n not in (2, 3) or p.shape != (c, n, n):
        raise ValueError("gaussian_step: x [C, 2|3] and p [C, n, n] "
                         "expected")
    if niw_iter.dtype != torch.int32 or niw_n.dtype != torch.int32:
        raise ValueError("gaussian_step: int32 NIW counters expected")
    x, p, niw_mu, niw_psi = _f32c(x), _f32c(p), _f32c(niw_mu), _f32c(niw_psi)
    phase_err, cn0_db_hz = _f32c(phase_err), _f32c(cn0_db_hz)
    niw_iter, niw_n = niw_iter.contiguous(), niw_n.contiguous()
    g = gs_params(prm, n)
    x_out, p_out = torch.empty_like(x), torch.empty_like(p)
    it_out, n_out = torch.empty_like(niw_iter), torch.empty_like(niw_n)
    mu_out, psi_out = torch.empty_like(niw_mu), torch.empty_like(niw_psi)
    info = torch.empty((4, c), dtype=torch.float32, device=x.device)
    err = kb.function("loops", "gaussian_step", [
        kb.VP, kb.VP, kb.VP, kb.VP, kb.VP, kb.VP, kb.VP, kb.VP, kb.I32,
        GsParams, kb.VP, kb.VP, kb.VP, kb.VP, kb.VP, kb.VP, kb.VP, kb.VP])(
        x.data_ptr(), p.data_ptr(), niw_iter.data_ptr(), niw_n.data_ptr(),
        niw_mu.data_ptr(), niw_psi.data_ptr(), phase_err.data_ptr(),
        cn0_db_hz.data_ptr(), c, g, x_out.data_ptr(), p_out.data_ptr(),
        it_out.data_ptr(), n_out.data_ptr(), mu_out.data_ptr(),
        psi_out.data_ptr(), info.data_ptr(), kb.stream_ptr())
    kb.check(err, "gaussian_step")
    LAUNCHES["gaussian_step"] += 1
    return x_out, p_out, it_out, n_out, mu_out, psi_out, info
