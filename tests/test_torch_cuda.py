"""The port's hand kernels against their plain PyTorch versions on the
card, at small shapes. Marked ``cuda``: they skip without a GPU and run
on one with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` repeats the checks at the main path's shapes."""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _ring(dev, n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(-90, 90, size=(2, n))
                           .astype(np.int8), device=dev)


@pytest.mark.parametrize("src_dtype", ["int8", "float32"])
@pytest.mark.parametrize("n_taps", [1, 3, 5])
def test_multicorr_kernel_matches_plain(dev, n_taps, src_dtype):
    from gnss_sdr_tpu_torch.kernels import multicorr as k3
    from gnss_sdr_tpu_torch.ops.correlator import n_extra_bins

    rng = np.random.default_rng(n_taps)
    c, width = 4, 2516
    # the int8 ring (phase A superblocks) or a float32 block
    # (process_block)
    ring = _ring(dev, 40000, n_taps).to(getattr(torch, src_dtype))
    shifts = np.linspace(-0.5 * (n_taps // 2), 0.5 * (n_taps // 2),
                         n_taps).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    args = (ring[0], ring[1], 1000, t(np.array([0, 500, 9000, 20000],
                                               np.int32)),
            # period lengths near one code period, as the scan engine
            # produces them (the segmented form's bins cover one period)
            t(np.array([2500, 2501, 2499, 2500], np.int32)),
            t(np.sign(rng.standard_normal((c, 1023))).astype(np.float32)),
            t(shifts), t(rng.uniform(0, 0.4, c).astype(np.float32)),
            t(np.full(c, 1.023e6 / 2.5e6, np.float32)),
            t(rng.uniform(0, 6.2, c).astype(np.float32)),
            t(rng.uniform(-0.02, 0.02, c).astype(np.float32)), width,
            n_extra_bins(shifts.tolist()))
    got = k3.multicorr(*args)
    want = k3.multicorr_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(
            torch.max(torch.abs(want[0]))))


@pytest.mark.parametrize("src_dtype", ["int8", "float32"])
def test_bank_corr_kernel_matches_plain(dev, src_dtype):
    from gnss_sdr_tpu_torch.kernels import bank_corr as k1

    rng = np.random.default_rng(3)
    c, k, p1, nt, w = 3, 20, 17, 3, 2688
    ring = _ring(dev, 400000, 3).to(getattr(torch, src_dtype))

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    args = (ring[0], ring[1], 777,
            t(np.sort(rng.integers(0, 300000, (c, k))).astype(np.int32)),
            t(rng.uniform(0, 30, (c, k)).astype(np.float32)),
            t(rng.uniform(-0.01, 0.01, c).astype(np.float32)),
            t(np.sign(rng.standard_normal((c, p1, nt, w))).astype(np.float32)),
            t(rng.integers(0, 16, (c, k)).astype(np.int32)),
            t(rng.uniform(0, 1, (c, k)).astype(np.float32)), 2501)
    got = k1.bank_corr(*args)
    want = k1.bank_corr_plain(*args)
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, rtol=0, atol=1e-4 * float(
            torch.max(torch.abs(want[0]))))


@pytest.mark.parametrize("use_cfar", [True, False])
def test_acq_kernels_match_plain(dev, use_cfar):
    from gnss_sdr_tpu_torch.kernels import acq

    rng = np.random.default_rng(5)
    p, d, n = 6, 8, 2500
    x = torch.as_tensor((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                        .astype(np.complex64), device=dev)
    code = torch.as_tensor((rng.standard_normal((p, n))
                            + 1j * rng.standard_normal((p, n)))
                           .astype(np.complex64), device=dev)
    dop = torch.as_tensor(np.linspace(-3000, 3000, d).astype(np.float32),
                          device=dev)
    c0 = acq.wipeoff_scale(2.5e6)
    wk, wp = acq.acq_wipeoff(x, dop, c0), acq.acq_wipeoff_plain(x, dop, c0)
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=1e-5)
    pk, pp = acq.acq_product(wp, code), acq.acq_product_plain(wp, code)
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=1e-4)
    grid_k = grid_p = None
    for _ in range(2):
        grid_k, rmk, rak = acq.acq_accum(pp, grid_k, 0, n)
        grid_p, rmp, rap = acq.acq_accum_plain(pp, grid_p, 0, n)
    torch.testing.assert_close(grid_k, grid_p, rtol=1e-6, atol=0)
    assert torch.equal(rak, rap)
    sk = acq.acq_stats(grid_p, rmp, rap, 2, 2, use_cfar)
    sp = acq.acq_stats_plain(grid_p, rmp, rap, 2, 2, use_cfar)
    assert torch.equal(sk[1], sp[1]) and torch.equal(sk[2], sp[2])
    torch.testing.assert_close(sk[0], sp[0], rtol=1e-4, atol=0)


def test_kernel_wrappers_count_launches(dev):
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, acq, reset_launches

    reset_launches()
    x = torch.zeros(64, dtype=torch.complex64, device=dev)
    acq.acq_wipeoff(x, torch.zeros(2, device=dev), -1e-6)
    acq.acq_wipeoff_plain(x, torch.zeros(2, device=dev), -1e-6)
    assert LAUNCHES["acq_wipeoff"] == 1


def test_multicorr_kernel_long_window_matches_plain(dev):
    """Windows of 2.6 code periods: the kernel skips the samples past the
    chips -n_extra .. code_len + n_extra - 1, as the oracle does."""
    from gnss_sdr_tpu_torch.kernels import multicorr as k3

    rng = np.random.default_rng(21)
    c, width = 3, 6500
    ring = _ring(dev, 20000, 21)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    args = (ring[0], ring[1], 1000, t(np.array([0, 3000, 9000], np.int32)),
            t(np.array([6500, 6000, 6321], np.int32)),
            t(np.sign(rng.standard_normal((c, 1023))).astype(np.float32)),
            t(np.array([-0.5, 0.0, 0.5], np.float32)),
            t(np.array([0.1, 0.3, 0.0], np.float32)),
            t(np.full(c, 1.023e6 / 2.5e6, np.float32)),
            t(rng.uniform(0, 6.2, c).astype(np.float32)),
            t(rng.uniform(-0.02, 0.02, c).astype(np.float32)), width, 2)
    got = k3.multicorr(*args)
    want = k3.multicorr_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(
            torch.max(torch.abs(want[0]))))


def _cx(dev, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x[n // 3:n // 3 + 40] *= 100.0                       # a strong pulse
    x += 40.0 * np.exp(2j * np.pi * 0.125 * np.arange(n))  # a CW tone
    return torch.as_tensor(x.astype(np.complex64), device=dev)


def _rms_close(got, want, tol):
    rms = float(torch.sqrt(torch.mean(torch.abs(want) ** 2)))
    assert float(torch.max(torch.abs(got - want))) <= tol * rms


@pytest.mark.parametrize("nco_step", [0.0, -1.1780972450961724])
@pytest.mark.parametrize("decimation,n_taps", [(1, 33), (2, 65), (4, 65),
                                               (3, 1001)])
def test_fir_decim_kernel_matches_plain(dev, decimation, n_taps, nco_step):
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    x = _cx(dev, 50_001, n_taps)
    taps = np.random.default_rng(1).standard_normal(n_taps) \
        .astype(np.float32) / n_taps
    # an absolute index past 2^31 exercises the 64-bit NCO argument
    args = (x, taps, decimation, nco_step, 3 << 30)
    got, want = k7.fir_decim(*args), k7.fir_decim_plain(*args)
    assert got.shape == want.shape
    _rms_close(got, want, 1e-5)


@pytest.mark.parametrize("n", [100_000, 99_999])
def test_pulse_blank_and_notch_kernels_match_plain(dev, n):
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    x = _cx(dev, n, 4)
    assert torch.equal(k7.pulse_blank(x, 4.0), k7.pulse_blank_plain(x, 4.0))
    spec = torch.fft.fft(x)
    assert torch.equal(k7.notch_mask(spec, 8.0),
                       k7.notch_mask_plain(spec, 8.0))


@pytest.mark.parametrize("fs_out", [4e6, 6.4e6, 3.3e6])
def test_resample_kernel_matches_plain(dev, fs_out):
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    x = _cx(dev, 80_001, 6)
    for mode in (k7.MMSE, k7.DIRECT):
        got = k7.resample(x, 8e6, fs_out, mode)
        want = k7.resample_plain(x, 8e6, fs_out, mode)
        assert torch.equal(got, want), mode


def test_conditioner_wrappers_count_launches(dev):
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    x = _cx(dev, 4096, 7)
    reset_launches()
    k7.fir_decim(x, np.ones(5, np.float32), 2)
    k7.pulse_blank(x, 4.0)
    k7.notch_mask(x, 8.0)
    k7.resample(x, 8e6, 4e6, k7.MMSE)
    k7.resample(x, 8e6, 4e6, k7.DIRECT)
    k7.fir_decim_plain(x, np.ones(5, np.float32), 2)
    k7.pulse_blank_plain(x, 4.0)
    assert {k: LAUNCHES[k] for k in ("fir_decim", "pulse_blank",
                                     "notch_mask", "resample")} \
        == {"fir_decim": 1, "pulse_blank": 1, "notch_mask": 1, "resample": 2}


@pytest.mark.parametrize("n_taps", [4, 6])
def test_bank_corr_kernel_with_data_tap_matches_plain(dev, n_taps):
    """K1 with the data-code bank appended as one more tap (3 + 1, the
    Galileo E1 pilot's 5 + 1) over E1-length windows."""
    from gnss_sdr_tpu_torch.kernels import bank_corr as k1

    rng = np.random.default_rng(n_taps)
    c, k, p1, w, n_eff = 2, 25, 17, 16256, 16001
    ring = _ring(dev, 500000, n_taps)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    args = (ring[0], ring[1], 321,
            t(np.sort(rng.integers(0, 450000, (c, k))).astype(np.int32)),
            t(rng.uniform(0, 30, (c, k)).astype(np.float32)),
            t(rng.uniform(-0.01, 0.01, c).astype(np.float32)),
            t(rng.standard_normal((c, p1, n_taps, w)).astype(np.float32)),
            t(rng.integers(0, 16, (c, k)).astype(np.int32)),
            t(rng.uniform(0, 1, (c, k)).astype(np.float32)), n_eff)
    got = k1.bank_corr(*args)
    want = k1.bank_corr_plain(*args)
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, rtol=0, atol=1e-4 * float(
            torch.max(torch.abs(want[0]))))


@pytest.mark.parametrize("n_taps", [1, 5])
def test_multicorr_kernel_on_e1_subchip_tables(dev, n_taps):
    """K3 at the Galileo E1 shapes: 16016-sample windows on 49104-entry
    CBOC sub-chip tables, which take more than 48 KB of shared memory:
    the five VEML taps (+-0.15, +-0.6 chips) and the data prompt at zero
    shift."""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1_subchips
    from gnss_sdr_tpu_torch.kernels import multicorr as k3
    from gnss_sdr_tpu_torch.ops.correlator import n_extra_bins

    rng = np.random.default_rng(40 + n_taps)
    c, width = 3, 16016
    ring = _ring(dev, 80000, n_taps)
    shifts = (np.array([-7.2, -1.8, 0.0, 1.8, 7.2], np.float32)
              if n_taps == 5 else np.zeros(1, np.float32))

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    args = (ring[0], ring[1], 1000, t(np.array([0, 20000, 41000], np.int32)),
            t(np.array([16000, 16001, 15999], np.int32)),
            t(np.stack([galileo_e1_subchips(p, "C", True)
                        for p in (3, 11, 24)]).astype(np.float32)),
            t(shifts), t(rng.uniform(0, 3.0, c).astype(np.float32)),
            t(np.full(c, 1.023e6 * 12 / 4e6, np.float32)),
            t(rng.uniform(0, 6.2, c).astype(np.float32)),
            t(rng.uniform(-0.02, 0.02, c).astype(np.float32)), width,
            n_extra_bins(shifts.tolist()))
    got = k3.multicorr(*args)
    want = k3.multicorr_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(
            torch.max(torch.abs(want[0]))))


def test_acq_kernels_at_e1_shapes(dev):
    """K2 on a 4 ms Galileo E1 dwell (16000 samples, 80 Doppler bins of
    125 Hz, CBOC replicas): the grid, its row peaks and the statistics
    agree with the plain versions."""
    from gnss_sdr_tpu_torch.acquisition.adapters import \
        make_galileo_e1_acquisition
    from gnss_sdr_tpu_torch.kernels import acq

    eng = make_galileo_e1_acquisition([1, 5, 9, 30], 4e6, device=dev)
    rng = np.random.default_rng(8)
    n = eng.cfg.fft_size
    x = torch.as_tensor((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                        .astype(np.complex64), device=dev)
    dop, c0 = eng._dopplers, eng._c0
    assert dop.shape[0] == 80 and n == 16000
    spec = torch.fft.fft(acq.acq_wipeoff_plain(x, dop, c0), dim=-1)
    torch.testing.assert_close(acq.acq_wipeoff(x, dop, c0),
                               acq.acq_wipeoff_plain(x, dop, c0),
                               rtol=1e-5, atol=1e-5)
    prod = acq.acq_product_plain(spec, eng._code_fft)
    torch.testing.assert_close(acq.acq_product(spec, eng._code_fft), prod,
                               rtol=1e-5, atol=1e-3)
    corr = torch.fft.ifft(prod, dim=-1)
    gk, rmk, rak = acq.acq_accum(corr, None, 0, n)
    gp, rmp, rap = acq.acq_accum_plain(corr, None, 0, n)
    torch.testing.assert_close(gk, gp, rtol=1e-6, atol=0)
    assert torch.equal(rak, rap)
    sk = acq.acq_stats(gp, rmp, rap, 1, eng.cfg.samples_per_chip, True)
    sp = acq.acq_stats_plain(gp, rmp, rap, 1, eng.cfg.samples_per_chip, True)
    assert torch.equal(sk[1], sp[1]) and torch.equal(sk[2], sp[2])
    torch.testing.assert_close(sk[0], sp[0], rtol=1e-4, atol=0)


@pytest.mark.parametrize("fold,n", [(2, 4000), (2, 16000), (4, 16368)])
def test_fold_wipeoff_kernel_matches_plain(dev, fold, n):
    """K5a at QuickSync's L1 (1 ms) and E1 (4 ms) shapes: phases up to
    ~125 rad at E1's last samples."""
    from gnss_sdr_tpu_torch.kernels import acq_variants as k5
    from gnss_sdr_tpu_torch.kernels.acq import wipeoff_scale

    rng = np.random.default_rng(n + fold)
    x = torch.as_tensor((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                        .astype(np.complex64), device=dev)
    dop = torch.as_tensor(np.arange(-5000, 5000, 250, dtype=np.float32),
                          device=dev)
    c0 = wipeoff_scale(n * 1000.0 / (4 if n > 4000 else 1))
    got = k5.fold_wipeoff(x, dop, c0, fold)
    want = k5.fold_wipeoff_plain(x, dop, c0, fold)
    assert got.shape == (dop.shape[0], n // fold)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_cccwsr_combine_kernel_matches_plain(dev):
    """K5b: the grid to the bit, the row peaks and their first argmax
    equal, ties included."""
    from gnss_sdr_tpu_torch.kernels import acq_variants as k5

    rng = np.random.default_rng(12)
    shape = (3, 7, 5000)

    def grid():
        return torch.as_tensor((rng.standard_normal(shape) + 1j
                                * rng.standard_normal(shape))
                               .astype(np.complex64), device=dev)

    yb, yc = grid(), grid()
    yc[1, 2] = yb[1, 2]            # minus is 0 on a whole row
    yb[2, 3, 100] = yb[2, 3, 4000] = 30.0   # a tie: the first index wins
    yc[2, 3, 100] = yc[2, 3, 4000] = 0.0
    got = k5.cccwsr_combine(yb, yc)
    want = k5.cccwsr_combine_plain(yb, yc)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_kf_step_kernel_matches_plain_over_chained_steps(dev):
    """K6a over 500 chained steps of 8 channels, within 1e-5 of the plain
    version's scale (x per column, P per channel)."""
    from gnss_sdr_tpu_torch.kernels import loops
    from gnss_sdr_tpu_torch.ops.kalman import (KfConfig, _matrices,
                                               kf_init)

    rng = np.random.default_rng(21)
    f, q, r = _matrices(KfConfig(), 0.02)
    s = kf_init(rng.normal(size=8), rng.uniform(0, 6, 8),
                rng.uniform(-4000, 4000, 8), device=dev)
    xk, pk = s.x, s.p
    xp, pp = s.x, s.p
    for _ in range(500):
        ce = torch.as_tensor(rng.normal(0, 0.05, 8).astype(np.float32),
                             device=dev)
        pe = torch.as_tensor(rng.normal(0, 0.2, 8).astype(np.float32),
                             device=dev)
        xk, pk, dk = loops.kf_step(xk, pk, ce, pe, f, q, r)
        xp, pp, dp = loops.kf_step_plain(xp, pp, ce, pe, f, q, r)
    scale_x = torch.amax(torch.abs(xp), dim=0)
    assert float(torch.max(torch.abs(xk - xp) / scale_x)) <= 1e-5
    scale_p = torch.amax(torch.abs(pp), dim=(1, 2), keepdim=True)
    assert float(torch.max(torch.abs(pk - pp) / scale_p)) <= 1e-5


@pytest.mark.parametrize("order", [2, 3])
def test_gaussian_step_kernel_matches_plain_over_chained_steps(dev, order):
    """K6b over 500 chained steps of 8 channels (the NIW update from step
    20, the Bayesian R from step 70): counters equal, the rest within
    1e-5 of the plain version's scale."""
    from gnss_sdr_tpu_torch.kernels import loops
    from gnss_sdr_tpu_torch.ops.gaussian import (GaussianConfig,
                                                 gaussian_init, step_params)

    rng = np.random.default_rng(22 + order)
    cfg = GaussianConfig(order=order)
    prm = step_params(cfg, 0.02)
    s = gaussian_init(rng.uniform(-4000, 4000, 8), cfg, 0.02, device=dev)
    k = p = tuple(s)
    for _ in range(500):
        y = torch.as_tensor(rng.normal(0, 0.2, 8).astype(np.float32),
                            device=dev)
        cn0 = torch.as_tensor(rng.uniform(35, 50, 8).astype(np.float32),
                              device=dev)
        *k, ik = loops.gaussian_step(*k, y, cn0, prm)
        *p, ip = loops.gaussian_step_plain(*p, y, cn0, prm)
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    for a, b in [(k[0], p[0]), (k[4][:, None], p[4][:, None]),
                 (k[5][:, None], p[5][:, None]), (ik.T, ip.T)]:
        scale = torch.clamp(torch.amax(torch.abs(b), dim=0), min=1e-30)
        assert float(torch.max(torch.abs(a - b) / scale)) <= 1e-5
    scale_p = torch.amax(torch.abs(p[1]), dim=(1, 2), keepdim=True)
    assert float(torch.max(torch.abs(k[1] - p[1]) / scale_p)) <= 1e-5


def test_variant_and_loop_wrappers_count_launches(dev):
    from gnss_sdr_tpu_torch.kernels import (LAUNCHES, acq_variants, loops,
                                            reset_launches)
    from gnss_sdr_tpu_torch.ops.kalman import KfConfig, _matrices, kf_init

    reset_launches()
    x = torch.zeros(64, dtype=torch.complex64, device=dev)
    acq_variants.fold_wipeoff(x, torch.zeros(2, device=dev), -1e-6, 2)
    y = torch.zeros((1, 2, 8), dtype=torch.complex64, device=dev)
    acq_variants.cccwsr_combine(y, y)
    s = kf_init(np.zeros(2), np.zeros(2), np.zeros(2), device=dev)
    z = torch.zeros(2, device=dev)
    loops.kf_step(s.x, s.p, z, z, *_matrices(KfConfig(), 0.02))
    loops.kf_step_plain(s.x, s.p, z, z, *_matrices(KfConfig(), 0.02))
    assert [LAUNCHES[k] for k in ("fold_wipeoff", "cccwsr_combine",
                                  "kf_step")] == [1, 1, 1]


# ---- K3-loop and K1-loop against their plain versions (_blocks_stepwise)

FS = 4e6


def _cs25():
    from gnss_sdr_tpu_torch.codes.galileo_e1 import E1C_SECONDARY

    return np.array([1.0 if c == "0" else -1.0 for c in E1C_SECONDARY])


def _scene(dev, n, chans, e1, seed):
    """int8 planar ring of ``n`` samples at 4 Msps: per channel (PRN,
    delay [samples], Doppler [Hz]) one GPS C/A signal without data bits,
    or (``e1``) one Galileo E1 signal, E1-B with a random symbol a period
    minus the CS25-signed E1-C, over sqrt 2; plus noise."""
    from gnss_sdr_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1_subchips

    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 8.0
    for prn, delay, dopp in chans:
        rate = 1.023e6 * (1.0 + dopp / 1575.42e6)
        if e1:
            sub = np.floor((t - delay) * rate * 12 / FS).astype(np.int64)
            per = sub // 49104
            sym = np.sign(rng.standard_normal(per.max() - per.min() + 1))
            s = (galileo_e1_subchips(prn, "B", True)[sub % 49104]
                 * sym[per - per.min()]
                 - galileo_e1_subchips(prn, "C", True)[sub % 49104]
                 * _cs25()[per % 25]) / np.sqrt(2.0)
        else:
            chip = np.floor((t - delay) * rate / FS).astype(np.int64)
            s = gps_l1ca_code(prn).astype(np.float64)[chip % 1023]
        x = x + 3.0 * s * np.exp(2j * np.pi * dopp * t / FS)
    return torch.as_tensor(np.stack([np.clip(x.real, -127, 127),
                                     np.clip(x.imag, -127, 127)])
                           .astype(np.int8), device=dev)


PRNS = (1, 2, 10, 12, 15, 17, 18, 21)


def _pulled_in_scan(dev, e1, pilot=False, k_ext=1):
    """A scan engine (8 channels, 20 ms blocks), its ring, code tables and
    its state after 8 blocks of pull-in through the plain path."""
    from gnss_sdr_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1_subchips
    from gnss_sdr_tpu_torch.tracking.engine import (TrackingConfig,
                                                    TrackingEngine)

    rng = np.random.default_rng(30 + e1 + pilot)
    period = 16000 if e1 else 4000
    chans = list(zip(PRNS, rng.uniform(0, period, 8),
                     rng.uniform(-4000, 4000, 8)))
    kw = dict(fs=FS, enable_fll_pull_in=True, pull_in_time_s=0.1,
              extend_correlation_symbols=k_ext)
    if e1:
        kw.update(code_length_chips=4092, code_samples_per_chip=12,
                  veml=True, symbols_per_bit=1, pll_bw_hz=20.0,
                  pll_bw_narrow_hz=2.0,
                  early_late_space_chips=0.15,
                  very_early_late_space_chips=0.6, track_pilot=pilot)
    eng = TrackingEngine(TrackingConfig(**kw), 8, 80000, device=dev)
    ring = _scene(dev, 40 * 80000 + eng.overlap, chans, e1, 40 + e1)

    def tables(comp):
        rows = [galileo_e1_subchips(p, comp, True) if e1 else gps_l1ca_code(p)
                for p in PRNS]
        return torch.as_tensor(np.stack(rows).astype(np.float32), device=dev)

    codes = tables("C" if pilot else "B")
    dcodes = tables("B") if pilot else None
    s = eng.init_state()
    for ch, (_, delay, dopp) in enumerate(chans):
        s = eng.start_channel(s, ch, dopp + 10.0,
                              int(np.ceil(delay)) % period, period)
    s, _ = eng._blocks_stepwise(s, ring[0], ring[1], 0, 80000, 8, codes,
                                dcodes)
    return eng, ring, codes, dcodes, s, chans


def _next_periods(s, chans, base, period):
    """Per channel, the index of its next code period in the scene."""
    start = base + s.offset.cpu().numpy().astype(np.float64)
    return [int(round((st - d) / period)) for st, (_, d, _) in
            zip(start, chans)]


def _records_close(pa, pb, valid, start, rem, dopp, cn0, prompt):
    """The JAX suite's tolerances between two packed records: the same
    valid rows, boundaries 0.02 samples, Doppler 1 Hz, C/N0 1 dB, prompt
    magnitude 2% (columns given as index tuples)."""
    assert torch.equal(pa[..., valid], pb[..., valid])
    v = pa[..., valid] > 0.5
    assert int(v.sum()) > 0
    a, b = pa.double(), pb.double()
    bnd = (a[..., start] + a[..., rem]) - (b[..., start] + b[..., rem])
    assert float(bnd.abs().max()) < 0.02
    assert float((a[..., dopp] - b[..., dopp])[v].abs().max()) < 1.0
    assert float((a[..., cn0] - b[..., cn0])[v].abs().max()) < 1.0
    ma = torch.hypot(a[..., prompt[0]], a[..., prompt[1]])
    mb = torch.hypot(b[..., prompt[0]], b[..., prompt[1]])
    assert float(((ma - mb).abs() / mb.clamp(min=1e-3 * float(mb.max())))
                 .max()) < 0.02


@pytest.mark.parametrize("case", ["l1", "e1-pilot-extended"])
def test_scan_loop_matches_stepwise(dev, case):
    """K3-loop over one 10-block superblock from a pulled-in state against
    the per-step path on the card: the first step's correlations to the
    bit (K3's own body), every record and the end state within the JAX
    suite's tolerances; one launch per call, no K3 launch; the float32
    planes of process_block and superblock_step likewise."""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import E1C_SECONDARY
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches

    e1 = case != "l1"
    eng, ring, codes, dcodes, s, chans = _pulled_in_scan(
        dev, e1, pilot=e1, k_ext=25 if e1 else 20)
    base = 8 * 80000
    if e1:          # extended integration over the CS25-wiped pilot
        for ch, p in enumerate(_next_periods(s, chans, base, 16000)):
            s = eng.set_extended(s, ch, p % 25, E1C_SECONDARY)
    else:
        for ch in range(0, 8, 2):
            s = eng.set_extended(s, ch, ch % 20)
    sa, pa = eng._blocks_stepwise(s, ring[0], ring[1], base, 80000, 10,
                                  codes, dcodes)
    reset_launches()
    sb, out = eng.superblock_ring_i8(s, ring, base, 10, codes, dcodes)
    assert LAUNCHES["scan_loop"] == 1 and LAUNCHES["multicorr"] == 0
    pb = out["packed"]
    t = eng.cfg.n_taps
    assert torch.equal(pa[0, 0, :, 4:8], pb[0, 0, :, 4:8])
    assert torch.equal(pa[0, 0, :, 15:], pb[0, 0, :, 15:])
    _records_close(pa, pb, 0, 1, 3, 8, 11, (4, 5))
    _records_close(pa, pb, 0, 1, 3, 8, 11, (6, 7))
    assert torch.equal(sa.active, sb.active)
    assert torch.equal(sa.loss_of_lock, sb.loss_of_lock)
    assert float((sa.carrier_doppler_hz - sb.carrier_doppler_hz).abs()
                 .max()) < 1.0
    bnd = (sa.offset.double() + sa.rem_code_phase_samples.double()) \
        - (sb.offset.double() + sb.rem_code_phase_samples.double())
    assert float(bnd.abs().max()) < 0.02
    assert pb.shape == (10, eng.n_steps, 8, 15 + 2 * t)
    if e1:
        return
    # the float32 planes: one block (process_block), two (superblock_step)
    lo, width = base, 80000 + eng.overlap
    blocks = ring[:, lo:lo + 80000 + width].float()
    two = torch.stack([blocks[:, :width], blocks[:, 80000:80000 + width]], 1)
    reset_launches()
    s1, o1 = eng.process_block(s, two[0, 0].contiguous(),
                               two[1, 0].contiguous(), codes)
    s2, o2 = eng.superblock_step(s, two[0], two[1], codes)
    assert LAUNCHES["scan_loop"] == 2 and LAUNCHES["multicorr"] == 0
    assert torch.equal(o1["packed"], o2["packed"][0])
    _records_close(pa[:2], o2["packed"], 0, 1, 3, 8, 11, (4, 5))


def _fast_case(dev, case):
    """(fast engine, ring, code tables, data code tables, start state,
    base) of one K1-loop case, pulled in on a scan engine through the
    plain path."""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import E1C_SECONDARY
    from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

    e1 = case.startswith("e1")
    pilot = case == "e1-pilot"
    eng, ring, codes, dcodes, s, chans = _pulled_in_scan(dev, e1, pilot)
    cfg = dataclasses.replace(
        eng.cfg, extend_correlation_symbols={"e1-pilot": 25,
                                             "e1-k1": 1}.get(case, 20),
        pll_bw_narrow_hz=2.0 if pilot else 5.0)
    loop = case if case in ("kf", "gaussian") else "fllpll"
    fast = FastTrackingEngine(cfg, 8, {"e1-pilot": 1, "e1-k1": 25}.get(
        case, 5), loop=loop, sec_max_len=25 if pilot else 1, device=dev)
    fs = fast.from_track_state(s)
    base = 8 * 80000
    if pilot:
        for ch, p in enumerate(_next_periods(s, chans, base, 16000)):
            fs = fast.set_secondary(fs, ch, E1C_SECONDARY, p % 25)
    return fast, ring, codes, dcodes, fs, base


@pytest.mark.parametrize("case", ["fllpll", "kf", "gaussian", "e1-pilot",
                                  "e1-k1"])
def test_fast_loop_matches_stepwise(dev, case):
    """K1-loop over one superblock from a pulled-in state against the
    per-group path on the card (K1, K6 and PyTorch): the first group's
    prompts to the bit (K1's own body), every record, the group prompts
    and the end state within the JAX suite's tolerances; one launch per
    call and no K1 or K6 launch, for the three loops at L1 (K = 20), the
    E1 pilot with the data tap and CS25 (K = 25) and E1-B alone (K = 1);
    process_block's float32 planes likewise."""
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches

    fast, ring, codes, dcodes, s, base = _fast_case(dev, case)
    bank = fast.get_bank(codes, dcodes)
    nb = 2 if case == "e1-pilot" else 4
    sa, pa, ra, ia = fast._blocks_stepwise(s, ring[0], ring[1], base,
                                           fast.block_samples, nb, bank)
    reset_launches()
    sb, out = fast.superblock_ring_i8(s, ring, base, nb, bank)
    assert LAUNCHES["fast_loop"] == 1
    assert sum(LAUNCHES[k] for k in ("bank_corr", "kf_step",
                                     "gaussian_step")) == 0
    pb, k = out["packed"], fast.k
    assert pb.shape == (nb, fast.g, 8, 5 * k + 4)
    assert torch.equal(pa[0, 0, :, 2 * k:5 * k], pb[0, 0, :, 2 * k:5 * k])
    for j in range(k):
        _records_close(pa, pb, 5 * k + 2, j, k + j, 5 * k, 5 * k + 1,
                       (3 * k + j, 4 * k + j))
    assert torch.equal(pa[..., 5 * k + 3], pb[..., 5 * k + 3])
    assert torch.equal(sa.loss_of_lock, sb.loss_of_lock)
    assert float((sa.carrier_doppler_hz - sb.carrier_doppler_hz).abs()
                 .max()) < 1.0
    bnd = (sa.offset.double() + sa.rem_code_phase_samples.double()) \
        - (sb.offset.double() + sb.rem_code_phase_samples.double())
    assert float(bnd.abs().max()) < 0.02
    if case == "fllpll":
        width = fast.block_samples + fast.overlap
        blk = ring[:, base:base + width].float()
        reset_launches()
        s1, o1 = fast.process_block(s, blk[0].contiguous(),
                                    blk[1].contiguous(), codes)
        assert LAUNCHES["fast_loop"] == 1
        assert torch.equal(o1["packed"], pb[0])
        mag = torch.hypot(o1["prompt_re"], o1["prompt_im"])
        ref = torch.hypot(ra[0], ia[0])
        assert float(((mag - ref).abs() / ref).max()) < 0.02
