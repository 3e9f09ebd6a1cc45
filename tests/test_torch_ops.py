"""Parity of the port's loop math and correlator with the JAX package.

The same seeded numpy inputs go through each JAX function (jit on the
CPU) and its PyTorch counterpart in ``gnss_sdr_tpu_torch`` on the CPU.
Tolerances: loop math rel. 1e-5 (float32 transcendental rounding of two
libraries); the segmented-sum correlator rel. 1e-4 of the largest output
(prefix sums taken in another order by XLA and by PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.ops import discriminators as jdisc
from gnss_sdr_tpu.ops import lock_detectors as jlock
from gnss_sdr_tpu.ops import loop_filters as jlf
from gnss_sdr_tpu.ops.correlator import multicorrelate as jmulticorrelate
from gnss_sdr_tpu_torch.kernels.multicorr import multicorr
from gnss_sdr_tpu_torch.ops import discriminators as tdisc
from gnss_sdr_tpu_torch.ops import lock_detectors as tlock
from gnss_sdr_tpu_torch.ops import loop_filters as tlf
from gnss_sdr_tpu_torch.ops.correlator import multicorrelate, n_extra_bins

torch.set_num_threads(2)
RTOL = 1e-5


def _inputs(n_args, seed=0, size=64):
    rng = np.random.default_rng(seed)
    out = [(rng.standard_normal(size) * 50).astype(np.float32)
           for _ in range(n_args)]
    out[0][:3] = 0.0  # I == 0 branch of the Costas discriminator
    return out


def _close(a, b, rtol=RTOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(np.max(np.abs(a)), 1e-30)
    assert np.max(np.abs(a - b)) <= rtol * scale, \
        (np.max(np.abs(a - b)), scale)


DISCRIMINATORS = [
    ("pll_four_quadrant_atan", 2, ()),
    ("pll_cloop_two_quadrant_atan", 2, ()),
    ("fll_four_quadrant_atan", 4, (0.0, 0.02)),
    ("fll_diff_atan", 4, (0.0, 0.001)),
    ("dll_nc_e_minus_l_normalized", 4, (0.5, 1.0, 1.0)),
    ("dll_nc_vemlp_normalized", 8, ()),
    ("phase_unwrap", 1, ()),
]


@pytest.mark.parametrize("name,n_args,extra", DISCRIMINATORS,
                         ids=[d[0] for d in DISCRIMINATORS])
def test_discriminator_parity(name, n_args, extra):
    xs = _inputs(n_args, seed=len(name))
    if name == "phase_unwrap":
        xs = [x / 10.0 for x in xs]
    want = jax.jit(lambda *a: getattr(jdisc, name)(*a, *extra))(
        *[jnp.asarray(x) for x in xs])
    got = getattr(tdisc, name)(*[torch.from_numpy(x) for x in xs], *extra)
    _close(want, got.numpy())


@pytest.mark.parametrize("name", ["cn0_svn_estimator", "cn0_m2m4_estimator",
                                  "carrier_lock_detector"])
def test_lock_detector_parity(name):
    rng = np.random.default_rng(3)
    p_re = (rng.standard_normal((8, 20)) * 30 + 100).astype(np.float32)
    p_im = (rng.standard_normal((8, 20)) * 30).astype(np.float32)
    args = (0.02,) if name != "carrier_lock_detector" else ()
    want = jax.jit(lambda a, b: getattr(jlock, name)(a, b, *args))(
        jnp.asarray(p_re), jnp.asarray(p_im))
    got = getattr(tlock, name)(torch.from_numpy(p_re),
                               torch.from_numpy(p_im), *args)
    _close(want, got.numpy())


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("last", [False, True])
def test_loop_filter_coefficients_and_step(order, last):
    ic_j, oc_j = jlf.loop_filter_coefficients(0.02, 0.75, order, last)
    ic_t, oc_t = tlf.loop_filter_coefficients(0.02, 0.75, order, last)
    np.testing.assert_array_equal(ic_j, ic_t)
    np.testing.assert_array_equal(oc_j, oc_t)
    rng = np.random.default_rng(order)
    xh = rng.standard_normal((6, 4)).astype(np.float32)
    yh = rng.standard_normal((6, 3)).astype(np.float32)
    x = rng.standard_normal(6).astype(np.float32)
    (jx, jy), jr = jax.jit(lambda a, b, c: jlf.iir_step((a, b), c, ic_j, oc_j))(
        jnp.asarray(xh), jnp.asarray(yh), jnp.asarray(x))
    (tx, ty), tr = tlf.iir_step(
        (torch.from_numpy(xh), torch.from_numpy(yh)), torch.from_numpy(x),
        torch.from_numpy(ic_t), torch.from_numpy(oc_t))
    for a, b in ((jx, tx), (jy, ty), (jr, tr)):
        _close(a, b.numpy())


@pytest.mark.parametrize("order", [2, 3])
def test_fll_pll_step_parity(order):
    gj = jlf.FllPllGains.make(35.0, 5.0, order)
    gt = tlf.FllPllGains.make(35.0, 5.0, order)
    assert gj.__dict__ == gt.__dict__
    rng = np.random.default_rng(order + 10)
    w, x, fd, pd = (rng.standard_normal(8).astype(np.float32) * 100
                    for _ in range(4))
    (jw, jx), je = jax.jit(lambda a, b, c, d: jlf.fll_pll_step(
        (a, b), c, d, 0.02, gj))(*map(jnp.asarray, (w, x, fd, pd)))
    (tw, tx), te = tlf.fll_pll_step(
        (torch.from_numpy(w), torch.from_numpy(x)), torch.from_numpy(fd),
        torch.from_numpy(pd), 0.02, gt)
    for a, b in ((jw, tw), (jx, tx), (je, te)):
        _close(a, b.numpy())


# ---- correlator -----------------------------------------------------------

def _corr_inputs(seed, c=4, length=2516, fs=2.5e6, shifts=(-0.5, 0.0, 0.5)):
    rng = np.random.default_rng(seed)
    code = np.sign(rng.standard_normal((c, 1023))).astype(np.float32)
    step = np.full(c, 1.023e6 / fs, np.float32) \
        + rng.uniform(-2e-6, 2e-6, c).astype(np.float32)
    # remnant code phases at both ends of [0, step): the spill bins
    # (chips -1 and code_len) and the mod-wrap are exercised
    rem = np.array([0.0, 0.409, 0.001, 0.25], np.float32)[:c]
    n = np.arange(length)
    x = np.zeros((c, length), np.complex64)
    for i in range(c):
        chip = np.floor(step[i] * n - rem[i]).astype(np.int64) % 1023
        x[i] = code[i, chip] * np.exp(1j * (0.3 + 0.002 * n)) \
            + (rng.standard_normal(length) + 1j * rng.standard_normal(length))
    return dict(
        x_re=np.ascontiguousarray(x.real, np.float32),
        x_im=np.ascontiguousarray(x.imag, np.float32), code=code,
        shifts=np.asarray(shifts, np.float32), rem=rem, step=step,
        rem_carr=rng.uniform(0, 6.28, c).astype(np.float32),
        carr_step=rng.uniform(-0.01, 0.01, c).astype(np.float32),
        length=np.array([2500, 2501, 2499, 2516], np.int32)[:c])


ORDER = ("x_re", "x_im", "code", "shifts", "rem", "step", "rem_carr",
         "carr_step", "length")


@pytest.mark.parametrize("shifts", [(-0.5, 0.0, 0.5), (-1.0, -0.5, 0.0, 0.5,
                                                       1.0)],
                         ids=["elp", "veml"])
@pytest.mark.parametrize("seed", [0, 1])
def test_multicorrelate_parity(seed, shifts):
    q = _corr_inputs(seed, shifts=shifts)
    a = [q[k] for k in ORDER]
    sh = q["shifts"]
    want = jax.jit(lambda *v: jmulticorrelate(
        v[0], v[1], v[2], sh, *v[3:]))(
        *[jnp.asarray(v) for k, v in zip(ORDER, a) if k != "shifts"])
    got = multicorrelate(*[torch.from_numpy(v) for v in a],
                         n_extra=n_extra_bins(sh.tolist()))
    scale = np.max(np.abs(np.asarray(want[0])))
    for w, g in zip(want, got):
        assert np.max(np.abs(np.asarray(w) - g.numpy())) <= 1e-4 * scale


def test_multicorrelate_high_dynamics_parity():
    q = _corr_inputs(5)
    a = [torch.from_numpy(q[k]) for k in ORDER]
    rate = np.full(4, 1e-7, np.float32)
    want = jax.jit(lambda *v: jmulticorrelate(
        v[0], v[1], v[2], q["shifts"], *v[3:]))(
        *[jnp.asarray(q[k]) for k in ORDER if k != "shifts"],
        jnp.asarray(rate), jnp.asarray(rate * 1e-3))
    got = multicorrelate(*a, torch.from_numpy(rate),
                         torch.from_numpy(rate * 1e-3))
    scale = np.max(np.abs(np.asarray(want[0])))
    for w, g in zip(want, got):
        assert np.max(np.abs(np.asarray(w) - g.numpy())) <= 1e-4 * scale


def test_multicorr_wrapper_reads_ring_windows_on_cpu():
    """The K3 wrapper on CPU tensors is the segmented-sum oracle applied
    to the windows it slices from the int8 ring."""
    rng = np.random.default_rng(9)
    ring = rng.integers(-60, 60, size=(2, 30000)).astype(np.int8)
    q = _corr_inputs(2)
    start = np.array([10, 2000, 7000, 12000], np.int32)
    base = 5000
    src = torch.from_numpy(ring)
    got = multicorr(src[0], src[1], base, torch.from_numpy(start),
                    torch.from_numpy(q["length"]), torch.from_numpy(q["code"]),
                    torch.from_numpy(q["shifts"]), torch.from_numpy(q["rem"]),
                    torch.from_numpy(q["step"]),
                    torch.from_numpy(q["rem_carr"]),
                    torch.from_numpy(q["carr_step"]), 2516, 2)
    idx = base + start[:, None] + np.arange(2516)
    want = multicorrelate(
        torch.from_numpy(ring[0][idx].astype(np.float32)),
        torch.from_numpy(ring[1][idx].astype(np.float32)),
        *[torch.from_numpy(q[k]) for k in ORDER[2:]])
    for w, g in zip(want, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
