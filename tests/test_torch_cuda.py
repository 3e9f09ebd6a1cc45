"""The port's hand kernels against their plain PyTorch versions on the
card, at small shapes. Marked ``cuda``: they skip without a GPU and run
on one with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` repeats the checks at the main path's shapes."""

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
