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


#: 10 g along the line of sight at L1: the carrier's Doppler rate
#: [Hz / s] and the code's [chips / s^2]
HD_DOPPLER_RATE = 98.0665 / (299792458.0 / 1575.42e6)
HD_CODE_RATE = HD_DOPPLER_RATE * 1.023e6 / 1575.42e6


def hd_inputs(seed, length, n_taps, table_len, accel_x10g=1.0, c=4):
    """Seeded K3-hd inputs at a tracking width (4 Msps): ``c`` windows of
    ``length`` samples, each a +-1 table (``table_len`` entries, 1023 or
    12 x 4092 for E1's sub-chips) read at the quadratic code phase under
    a carrier with the quadratic phase of ``accel_x10g`` x 10 g, plus
    noise; the rates in code-table units and radians per sample
    squared."""
    fs, cspc = 4e6, table_len // (1023 if table_len % 1023 == 0 else 4092)
    rng = np.random.default_rng(seed)
    code = np.sign(rng.standard_normal((c, table_len))).astype(np.float32)
    step = (np.full(c, 1.023e6 * cspc / fs)
            * (1.0 + rng.uniform(-3e-6, 3e-6, c))).astype(np.float32)
    code_rate = np.full(c, HD_CODE_RATE * accel_x10g * cspc / fs ** 2,
                        np.float32)
    carr_rate = np.full(c, 2.0 * np.pi * HD_DOPPLER_RATE * accel_x10g
                        / fs ** 2, np.float32)
    rem = rng.uniform(0.0, 3.0, c).astype(np.float32)
    rem_carr = rng.uniform(0, 6.28, c).astype(np.float32)
    carr_step = rng.uniform(-0.01, 0.01, c).astype(np.float32)
    n = np.arange(length, dtype=np.float64)
    x = np.zeros((c, length), np.complex64)
    for i in range(c):
        chip = np.floor(step[i] * n - rem[i] + 0.5 * code_rate[i] * n * n)
        ph = rem_carr[i] + carr_step[i] * n + 0.5 * carr_rate[i] * n * n
        x[i] = code[i, chip.astype(np.int64) % table_len] * np.exp(1j * ph) \
            + (rng.standard_normal(length)
               + 1j * rng.standard_normal(length))
    spc = 0.15 * cspc if n_taps == 5 else 0.5 * cspc
    shifts = [-0.6 * cspc, -spc, 0.0, spc, 0.6 * cspc] if n_taps == 5 \
        else [-spc, 0.0, spc]
    return dict(
        x_re=np.ascontiguousarray(x.real, np.float32),
        x_im=np.ascontiguousarray(x.imag, np.float32), code=code,
        shifts=np.asarray(shifts, np.float32), rem=rem, step=step,
        rem_carr=rem_carr, carr_step=carr_step,
        length=rng.integers(length - 16, length + 1, c).astype(np.int32),
        carr_rate=carr_rate, code_rate=code_rate)


@pytest.mark.parametrize("length,n_taps,table_len",
                         [(4016, 3, 1023), (16016, 5, 49104)],
                         ids=["l1", "e1"])
def test_multicorrelate_high_dynamics_parity_at_tracking_widths(
        length, n_taps, table_len):
    """K3-hd's plain version (``multicorrelate`` with both rates: the
    per-sample gather at the quadratic code phase, the quadratic carrier)
    against JAX's on seeded windows at the L1 and E1 scan widths, 10 g
    and 1000 g: every tap within 1e-5 of the prompt magnitude (the float32
    n * n past n = 4096 is formed alike; the sums differ in order)."""
    for accel in (1.0, 100.0):
        q = hd_inputs(int(accel) + length, length, n_taps, table_len, accel)
        a = [q[k] for k in ORDER]
        sh = q["shifts"]
        rates = (q["carr_rate"], q["code_rate"])
        want = jax.jit(lambda *v: jmulticorrelate(
            v[0], v[1], v[2], sh, *v[3:]))(
            *[jnp.asarray(v) for k, v in zip(ORDER, a) if k != "shifts"],
            *map(jnp.asarray, rates))
        got = multicorrelate(*[torch.from_numpy(v) for v in a],
                             *map(torch.from_numpy, rates))
        mid = n_taps // 2
        prompt = np.hypot(np.asarray(want[0])[:, mid],
                          np.asarray(want[1])[:, mid])
        # the signal is there: the prompt holds most of its coherent sum
        assert np.all(prompt > 0.8 * q["length"])
        for w, g in zip(want, got):
            err = np.max(np.abs(np.asarray(w) - g.numpy()), axis=1)
            assert np.all(err <= 1e-5 * prompt), (err / prompt, accel)


def test_multicorr_wrapper_high_dynamics_on_cpu():
    """With the rates, the K3 wrapper on CPU tensors is K3-hd's plain
    version (``multicorrelate``'s high-dynamics branch) on the windows it
    slices from the int8 ring; a carrier rate alone keeps the
    segmented sum with a quadratic carrier."""
    rng = np.random.default_rng(4)
    ring = torch.from_numpy(rng.integers(-60, 60, size=(2, 30000))
                            .astype(np.int8))
    q = {k: torch.from_numpy(v) for k, v in hd_inputs(6, 2516, 3, 1023,
                                                       100.0).items()}
    start = torch.tensor([10, 2000, 7000, 12000], dtype=torch.int32)
    idx = 5000 + start[:, None].long() + torch.arange(2516)
    x_re, x_im = ring[0][idx].float(), ring[1][idx].float()
    for rates in ((q["carr_rate"], q["code_rate"]), (None, q["code_rate"]),
                  (q["carr_rate"], None)):
        got = multicorr(ring[0], ring[1], 5000, start, q["length"],
                        q["code"], q["shifts"], q["rem"], q["step"],
                        q["rem_carr"], q["carr_step"], 2516, 2, *rates)
        want = multicorrelate(x_re, x_im, *[q[k] for k in ORDER[2:]],
                              *rates, n_extra=2)
        for w, g in zip(want, got):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


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
