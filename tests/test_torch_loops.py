"""Parity of the port's KF and Gaussian loops (K6a, K6b and the fast
engine's ``loop="kf"|"gaussian"``) with the JAX package on the CPU.

Tolerances:

- ``kf_step`` / ``gaussian_step`` over 250 chained steps from the same
  state and the same seeded innovations: x within rtol 1e-5 of each
  column's scale (its largest magnitude over the channels) and P within
  rtol 1e-5 of each channel's largest |P| entry; integer NIW counters
  identical. The port's plain versions round where the JAX package's
  CPU programs round (a dot is one product, then a fused multiply-add
  per term), which makes the 2- and 3-term dots of the Gaussian step
  bit-identical; the 4-term dots of the KF sum in another order inside
  XLA (a few ulp a step, measured 3e-6 of the scale over 300 steps), and
  the filter's covariance recursion damps them, so 1e-5 holds over any
  number of steps.
- The fast engine on the one-satellite 1.4 s, 4 Msps scenes of
  ``test_fast_engine.py::test_kf_loop_mode_tracks`` and
  ``test_gaussian.py::test_gaussian_loop_mode_tracks``, both engines
  from the same scan-engine pull-in: period starts identical, Doppler
  within 1 Hz, C/N0 within 1 dB, prompt magnitude within 2% (the
  ROADMAP's fast-engine tolerances), and the JAX tests' own checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.codes import gps_l1ca_code
from gnss_sdr_tpu.ops import gaussian as jgauss
from gnss_sdr_tpu.ops import kalman as jkalman
from gnss_sdr_tpu.simulate import SatelliteParams, generate_gps_l1ca
from gnss_sdr_tpu.tracking import TrackingConfig as JConfig
from gnss_sdr_tpu.tracking.channels import TrackingChannels as JChannels
from gnss_sdr_tpu.tracking.fast_engine import FastTrackingEngine as JFast
from gnss_sdr_tpu_torch import convert
from gnss_sdr_tpu_torch.ops import gaussian as tgauss
from gnss_sdr_tpu_torch.ops import kalman as tkalman
from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig
from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

torch.set_num_threads(2)
C = 8
STEPS = 250
T_GROUP = 0.02


def _close_x(a, b, rtol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.maximum(np.max(np.abs(a), axis=0), 1e-30)
    assert np.max(np.abs(a - b) / scale) <= rtol


def _close_p(a, b, rtol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.max(np.abs(a), axis=(-2, -1), keepdims=True)
    assert np.max(np.abs(a - b) / scale) <= rtol


def test_kf_step_chained_matches_jax():
    rng = np.random.default_rng(40)
    cfg = jkalman.KfConfig()
    js = jkalman.kf_init(rng.normal(size=C), rng.uniform(0, 6, C),
                         rng.uniform(-4000, 4000, C))
    ts = convert.kf_state(js, "cpu")
    np.testing.assert_array_equal(
        ts.x.numpy(), tkalman.kf_init(np.asarray(js.x[:, 0]),
                                      np.asarray(js.x[:, 1]),
                                      np.asarray(js.x[:, 2])).x.numpy())
    for _ in range(STEPS):
        code_err = rng.normal(0, 0.05, C).astype(np.float32)
        phase_err = rng.normal(0, 0.2, C).astype(np.float32)
        js, jd = jkalman.kf_step(js, code_err, phase_err, T_GROUP, cfg)
        ts, td = tkalman.kf_step(ts, torch.from_numpy(code_err),
                                 torch.from_numpy(phase_err), T_GROUP,
                                 tkalman.KfConfig())
        _close_x(js.x, ts.x)
        _close_p(js.p, ts.p)
        _close_x(jd, td)
    # a scalar step keeps the unbatched shapes
    one, delta = tkalman.kf_step(tkalman.kf_init(0.0, 0.0, 1100.0), 0.01,
                                 0.1, 0.001, tkalman.KfConfig())
    assert one.x.shape == (4,) and one.p.shape == (4, 4)
    assert delta.shape == (4,)


@pytest.mark.parametrize("order", [2, 3])
def test_gaussian_step_chained_matches_jax(order):
    """250 steps cross p_transient (NIW updates) and p_transient +
    s_transient (the Bayesian R in use) of the default configuration."""
    rng = np.random.default_rng(41 + order)
    cfg = jgauss.GaussianConfig(order=order)
    tcfg = tgauss.GaussianConfig(order=order)
    dop = rng.uniform(-4000, 4000, C).astype(np.float32)
    js = jgauss.gaussian_init(dop, cfg, T_GROUP)
    ts = tgauss.gaussian_init(dop, tcfg, T_GROUP)
    for name, a in convert.field_dict(js).items():
        b = getattr(ts, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=name)
    ts = convert.gauss_state(js, "cpu")
    for _ in range(STEPS):
        y = rng.normal(0, 0.2, C).astype(np.float32)
        cn0 = rng.uniform(35, 50, C).astype(np.float32)
        js, ji = jgauss.gaussian_step(js, y, cn0, T_GROUP, cfg)
        ts, ti = tgauss.gaussian_step(ts, torch.from_numpy(y),
                                      torch.from_numpy(cn0), T_GROUP, tcfg)
        np.testing.assert_array_equal(np.asarray(js.niw_iter), ts.niw_iter)
        np.testing.assert_array_equal(np.asarray(js.niw_n), ts.niw_n)
        _close_x(js.x[:, 1:], ts.x[:, 1:])
        _close_p(js.p, ts.p)
        for name in ("niw_mu", "niw_psi"):
            _close_x(getattr(js, name)[:, None], getattr(ts, name)[:, None])
        for key, a in ji.items():
            _close_x(np.asarray(a)[:, None], ti[key][:, None])
    assert int(ts.niw_n[0]) == STEPS - 20
    var = tgauss.phase_detector_variance(np.float32(45.0), 0.001)
    np.testing.assert_allclose(
        float(var), float(jgauss.phase_detector_variance(45.0, 0.001)),
        rtol=1e-6)


#: (prn, C/N0, delay, Doppler, seed) of the JAX tests' scenes
SCENES = {"kf": (6, 47.0, 800.0, 900.0, 17),
          "gaussian": (8, 46.0, 600.0, -600.0, 23)}


@pytest.mark.parametrize("loop", ["kf", "gaussian"])
def test_fast_engine_loop_matches_jax(loop):
    fs = 4.0e6
    prn, cn0, delay, dopp, seed = SCENES[loop]
    x = generate_gps_l1ca([SatelliteParams(prn=prn, cn0_db_hz=cn0,
                                           delay_samples=delay,
                                           doppler_hz=dopp)], fs, 1.4,
                          seed=seed)
    kw = dict(fs=fs, extend_correlation_symbols=20, pll_bw_narrow_hz=5.0,
              dll_bw_narrow_hz=0.75, cn0_smoother_alpha=0.05)
    block = int(fs * 0.02)
    tc = JChannels(JConfig(**kw), 1, block)
    tc.start_channel(0, prn, gps_l1ca_code(prn), delay, dopp + 25.0, 0)
    for b in range(20):
        tc.process_block(x[b * block:(b + 1) * block + tc.overlap])
    jf = JFast(JConfig(**kw), 1, groups_per_block=5, loop=loop)
    tf = FastTrackingEngine(TrackingConfig(**kw), 1, 5, loop=loop,
                            device="cpu")
    js = jf.from_track_state(tc.state)
    ts = tf.from_track_state(convert.track_state(tc.state, "cpu"))
    for name, a in convert.field_dict(js).items():
        np.testing.assert_array_equal(convert.state_numpy(ts)[name], a,
                                      err_msg=name)
    # a restarted channel carries the same loop state as in JAX
    rj = convert.field_dict(jf.start_channel(js, 0, 1234.5, 77))
    rt = convert.state_numpy(tf.start_channel(ts, 0, 1234.5, 77))
    for name in ("kf_x", "kf_p", "gs_niw"):
        np.testing.assert_array_equal(rt[name], rj[name], err_msg=name)
    codes = np.asarray(gps_l1ca_code(prn), np.float32)[None, :]
    pos, k = 20 * block, 20
    n_blocks = (len(x) - pos - jf.overlap) // jf.block_samples
    assert n_blocks >= 8
    dopplers, cn0s = [], []
    for b in range(n_blocks):
        lo = pos + b * jf.block_samples
        seg = x[lo:lo + jf.block_samples + jf.overlap]
        re = np.ascontiguousarray(seg.real, np.float32)
        im = np.ascontiguousarray(seg.imag, np.float32)
        js, oj = jf.process_block(js, jnp.asarray(re), jnp.asarray(im),
                                  jnp.asarray(codes))
        ts, ot = tf.process_block(ts, torch.from_numpy(re),
                                  torch.from_numpy(im),
                                  torch.from_numpy(codes))
        pj, pt = np.asarray(oj["packed"]), ot["packed"].numpy()
        np.testing.assert_array_equal(pt[..., :k], pj[..., :k])
        np.testing.assert_allclose(np.abs(pt[..., 2 * k:3 * k]),
                                   np.abs(pj[..., 2 * k:3 * k]), rtol=0.02,
                                   atol=1e-3 * np.abs(pj[..., 2 * k:3 * k])
                                   .max())
        assert np.max(np.abs(pj[..., 5 * k] - pt[..., 5 * k])) < 1.0
        assert np.max(np.abs(pj[..., 5 * k + 1] - pt[..., 5 * k + 1])) < 1.0
        np.testing.assert_array_equal(pt[..., 5 * k + 2:],
                                      pj[..., 5 * k + 2:])
        valid = pt[:, 0, 5 * k + 2] > 0
        dopplers.extend(pt[valid, 0, 5 * k])
        cn0s.extend(pt[valid, 0, 5 * k + 1])
        assert not pt[..., 5 * k + 3].any()
    assert abs(np.mean(dopplers[-10:]) - dopp) < 5.0
    assert abs(cn0s[-1] - cn0) < 5.0
    # the Gaussian loop's NIW counters travel exactly in the f32 carry
    np.testing.assert_array_equal(convert.state_numpy(ts)["gs_niw"][:, :2],
                                  np.asarray(js.gs_niw)[:, :2])


def test_fast_engine_rejects_unknown_loop():
    with pytest.raises(ValueError, match="loop"):
        FastTrackingEngine(TrackingConfig(fs=4e6), 1, loop="ukf",
                           device="cpu")
