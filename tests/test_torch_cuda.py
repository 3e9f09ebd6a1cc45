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


def _multicorr_case(dev, n_taps, src_dtype, width=2516,
                    lengths=(2500, 2501, 2499, 2500)):
    from gnss_sdr_tpu_torch.kernels import multicorr as k3
    from gnss_sdr_tpu_torch.ops.correlator import n_extra_bins

    rng = np.random.default_rng(n_taps)
    c = 4
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
            # produces them (the segmented form's bins cover one period),
            # or shorter (a window's slices past its length sum nothing)
            t(np.array(lengths, np.int32)),
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


def test_multicorr_kernel_matches_plain(dev):
    """K3 against its plain version for 1, 3 and 5 taps on the int8 ring
    and on float32 planes; K3 cuts each window into S slices of
    ceil(width / S) samples, one block of a cluster each
    (``corr_common.cuh::k3_slices``): windows of 2516 samples (S = 5),
    of 4016 (S = 8, the L1 width; no multiple of S x 256) with valid
    lengths down to a few samples, and of 700 (S = 2) with lengths
    shorter than one slice and 0
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    for n_taps in (1, 3, 5):
        for src_dtype in ("int8", "float32"):
            _multicorr_case(dev, n_taps, src_dtype)
    for width, lengths in ((4016, (4016, 3999, 1500, 7)),
                           (700, (700, 349, 13, 0))):
        for n_taps in (1, 3):
            _multicorr_case(dev, n_taps, "int8", width, lengths)


@pytest.mark.parametrize("src_dtype", ["int8", "float32"])
def test_bank_corr_kernel_matches_plain(dev, src_dtype):
    """K1 against its plain version on the int8 ring and on float32
    planes: 3 channels x 20 periods of 3 taps (a window starting at an odd
    byte, one ending at the source's last sample, row pair j0 = 15), one
    channel, 1 and 4 taps, and the E1-B shape (8 channels x K = 1 x 5
    taps of 16001 samples); the bank's packed form gives the bank back to
    the bit on the card, and a bank of more than 16 values raises
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    from gnss_sdr_tpu_torch.kernels import bank_corr as k1

    ring = _ring(dev, 400000, 3).to(getattr(torch, src_dtype))
    for c, k, nt, w, n_eff in ((3, 20, 3, 2688, 2501), (1, 20, 3, 2688, 2501),
                               (3, 20, 1, 2688, 2501), (3, 20, 4, 4608, 4001),
                               (8, 1, 5, 16128, 16001)):
        _bank_corr_case(dev, ring, c, k, nt, w, n_eff, seed=c * 10 + nt)
    bank = torch.as_tensor(np.arange(17 * 2688, dtype=np.float32)
                           .reshape(1, 17, 1, 2688), device=dev)
    with pytest.raises(ValueError, match="distinct values"):
        k1.pack_bank(bank)


#: CBOC levels of a Galileo E1 sub-chip table (alpha +- beta with alpha =
#: sqrt(10/11), beta = sqrt(1/11)) and the bank's zero support tail
E1_LEVELS = np.array([np.sqrt(10 / 11) + np.sqrt(1 / 11),
                      np.sqrt(10 / 11) - np.sqrt(1 / 11)], np.float32)


def _code_bank(rng, shape, n_eff, cboc=False):
    """A bank [C, P+1, T, W] of a code's levels (+-1, or E1's four CBOC
    levels) with the zero support tail past ``n_eff`` (row 0 one sample
    shorter, as the bank's first phase row is), zeros of both signs."""
    levels = np.concatenate([E1_LEVELS, -E1_LEVELS]) if cboc \
        else np.array([1.0, -1.0], np.float32)
    bank = levels[rng.integers(0, len(levels), shape)].astype(np.float32)
    bank[..., n_eff:] *= 0.0
    bank[:, 0, :, n_eff - 1:] *= 0.0
    return bank


def _bank_corr_case(dev, ring, c, k, nt, w, n_eff, seed, cboc=False):
    """K1 against its plain version on ``ring`` (int8 or float32 planes)
    for ``c`` channels x ``k`` periods of ``nt`` taps and ``n_eff``-sample
    windows: the first window starts at an odd byte, the last ends at the
    source's last sample, the first period reads rows 15 and 16."""
    from gnss_sdr_tpu_torch.kernels import bank_corr as k1

    rng = np.random.default_rng(seed)
    base = 777
    last = ring.shape[1] - base - n_eff

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    starts = np.sort(rng.integers(0, last, (c, k)), axis=None).reshape(c, k)
    starts[0, 0] |= 1
    starts[-1, -1] = last
    j0 = rng.integers(0, 16, (c, k))
    j0[0, 0] = 15
    bank = t(_code_bank(rng, (c, 17, nt, w), n_eff, cboc))
    args = (ring[0], ring[1], base, t(starts.astype(np.int32)),
            t(rng.uniform(0, 30, (c, k)).astype(np.float32)),
            t(rng.uniform(-0.01, 0.01, c).astype(np.float32)), bank,
            t(j0.astype(np.int32)),
            t(rng.uniform(0, 1, (c, k)).astype(np.float32)), n_eff)
    packed = k1.pack_bank(bank)
    got = k1.bank_corr(*args, packed=packed)
    want = k1.bank_corr_plain(*args)
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, rtol=0, atol=1e-4 * float(
            torch.max(torch.abs(want[0]))))
    back = k1.unpack_bank(*packed, nt)
    assert torch.equal(back.view(torch.int32), bank.view(torch.int32))


def _acq_case(dev, use_cfar):
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
    wp = acq.acq_wipeoff_plain(x, dop, c0)
    _wipeoff_case(x, dop, c0)
    pk, pp = acq.acq_product(wp, code), acq.acq_product_plain(wp, code)
    assert torch.equal(pk, pp)
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


def _wipeoff_case(x, dop, c0):
    """K2a against its plain version; each row equal to the bit to a
    launch of its bin alone (a grid's mirror bins share one sincosf, so
    this holds cos even and sin odd to the bit at every phase of the
    grid); K5a at S = 1 equal to K2a to the bit (one body)."""
    from gnss_sdr_tpu_torch.kernels import acq
    from gnss_sdr_tpu_torch.kernels import acq_variants as k5

    got = acq.acq_wipeoff(x, dop, c0)
    torch.testing.assert_close(got, acq.acq_wipeoff_plain(x, dop, c0),
                               rtol=1e-5, atol=1e-5)
    for d in range(dop.shape[0]):
        assert torch.equal(got[d], acq.acq_wipeoff(x, dop[d:d + 1], c0)[0])
    assert torch.equal(k5.fold_wipeoff(x, dop, c0, 1), got)


def _wipeoff_grids_case(dev):
    """K2a (``_wipeoff_case``) on the L1 search's grid (-5000 ... 4750 Hz,
    every bin but the first paired with its negation) at an odd N (one
    output a thread), at N = 4000 from a base 8 bytes past a 16-byte
    boundary (one output a thread), on a one-bin refine grid and on a
    grid off zero (no mirror pair)."""
    from gnss_sdr_tpu_torch.kernels import acq

    rng = np.random.default_rng(14)
    buf = torch.as_tensor((rng.standard_normal(4002)
                           + 1j * rng.standard_normal(4002))
                          .astype(np.complex64), device=dev)
    grid = torch.as_tensor(np.arange(-5000, 5000, 250, dtype=np.float32),
                           device=dev)
    c0 = acq.wipeoff_scale(4e6)
    for x, dop in ((buf[:4001], grid), (buf[1:4001], grid),
                   (buf[:4000], grid[3:4] + 1234.5),
                   (buf[:4000], grid + 130.0)):
        _wipeoff_case(x, dop, c0)


def _acq_product_case(dev, p, d, n, offset):
    """K2b on [P, D, N] against its plain version, to the bit; ``offset``
    samples into its storage the spectrum's base is not 16-byte
    aligned (the single-sample path, as for an odd N)."""
    from gnss_sdr_tpu_torch.kernels import acq

    rng = np.random.default_rng(p * d + n)

    def cx(size):
        return torch.as_tensor((rng.standard_normal(size)
                                + 1j * rng.standard_normal(size))
                               .astype(np.complex64), device=dev)

    spec = cx(d * n + offset)[offset:].view(d, n)
    code = cx(p * n).view(p, n)
    assert torch.equal(acq.acq_product(spec, code),
                       acq.acq_product_plain(spec, code))


def _acq_stats_case(dev, d, eff, spc, offset):
    """K2d on a seeded [4, D, eff] grid whose PRNs hold: equal maxima in
    rows 2 and 5 (row 2 must win), a peak in the last row (the CFAR row
    opposite it wraps to D / 2 - 1), a peak at sample 1 and one at
    eff - 2 (the second-peak exclusion wraps past either end of the row),
    each with a runner-up just outside and one just inside the
    exclusion. ``offset`` floats into its storage the grid's base is not
    16-byte aligned. Indices and the second-peak statistic equal to the
    plain version's, CFAR within 1e-4."""
    from gnss_sdr_tpu_torch.kernels import acq

    rng = np.random.default_rng(d * eff + offset)
    g = rng.exponential(1.0, size=(4, d, eff)).astype(np.float32)
    for p, (row, t) in enumerate(((2, eff // 3), (d - 1, eff // 2),
                                  (d // 3, 1), (d // 2, eff - 2))):
        g[p, row, t] = 400.0
        g[p, row, (t + spc + 1) % eff] = 50.0 + p
        g[p, row, (t - spc) % eff] = 90.0
    g[0, 5, eff // 4] = 400.0   # a tie: the smaller Doppler index wins
    flat = torch.as_tensor(np.concatenate([np.zeros(offset, np.float32),
                                           g.ravel()]), device=dev)
    grid = flat[offset:].view(4, d, eff)
    row_arg = torch.argmax(grid, dim=-1)
    row_max = torch.gather(grid, -1, row_arg[..., None])[..., 0]
    row_arg = row_arg.to(torch.int32)
    for use_cfar in (True, False):
        sk = acq.acq_stats(grid, row_max, row_arg, 2, spc, use_cfar)
        sp = acq.acq_stats_plain(grid, row_max, row_arg, 2, spc, use_cfar)
        assert torch.equal(sk[1], sp[1]) and torch.equal(sk[2], sp[2])
        assert sk[1].tolist() == [2, d - 1, d // 3, d // 2]
        if use_cfar:
            torch.testing.assert_close(sk[0], sp[0], rtol=1e-4, atol=0)
        else:
            assert torch.equal(sk[0], sp[0])
            torch.testing.assert_close(
                sk[0], torch.tensor([8.0, 8.0, 8.0, 8.0], device=dev)
                * 50.0 / torch.tensor([50.0, 51.0, 52.0, 53.0], device=dev),
                rtol=1e-6, atol=0)


def test_acq_kernels_match_plain(dev):
    """K2's four kernels against their plain versions, with the CFAR
    statistic and with the second-peak ratio; K2a on its other layouts
    and grids (``_wipeoff_grids_case``); K2b alone to the bit at an
    odd N, at a P x D x N that is no multiple of a block's work, from a
    misaligned spectrum and at the E5a search's 36 x 32 x 12000; K2d on
    planted peaks (ties, wrapping rows and exclusions) at rows of 4000
    and 12000 floats and of 1001 and 9001 (rows on every alignment, a
    row cut over one block or three), from grids whose base is 0-3
    floats past a 16-byte boundary
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    for use_cfar in (True, False):
        _acq_case(dev, use_cfar)
    _wipeoff_grids_case(dev)
    for p, d, n, offset in ((3, 5, 4001, 0), (5, 7, 778, 0), (4, 3, 1030, 1),
                            (36, 32, 12000, 0)):
        _acq_product_case(dev, p, d, n, offset)
    for d, eff, spc, offset in ((40, 4000, 4, 0), (32, 12000, 12, 1),
                                (9, 1001, 3, 2), (8, 1001, 3, 3),
                                (7, 9001, 3, 1)):
        _acq_stats_case(dev, d, eff, spc, offset)


def test_kernel_wrappers_count_launches(dev):
    """A wrapper counts its kernel's launches, not its plain version's
    calls. With two cards or more, the device guard of the launch path
    (``kernels/build.py::launch``): a K1 and a K3-loop launch on tensors
    of the second card, the first card current, run on the second card
    (the profiler's kernel events) and equal the same launches on the
    first card to the bit."""
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, acq, reset_launches

    reset_launches()
    x = torch.zeros(64, dtype=torch.complex64, device=dev)
    acq.acq_wipeoff(x, torch.zeros(2, device=dev), -1e-6)
    acq.acq_wipeoff_plain(x, torch.zeros(2, device=dev), -1e-6)
    assert LAUNCHES["acq_wipeoff"] == 1
    if torch.cuda.device_count() >= 2:
        cards = [_device_guard_case(torch.device("cuda", i)) for i in (0, 1)]
        assert all(torch.equal(a, b) for a, b in zip(*cards))


def _device_guard_case(card):
    """K1 (bank_corr) and one K3-loop block (scan engine, 4 channels)
    on ``card`` with card 0 current: the outputs on the host."""
    from gnss_sdr_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.kernels import bank_corr as k1
    from gnss_sdr_tpu_torch.tracking.engine import (TrackingConfig,
                                                    TrackingEngine)

    torch.cuda.set_device(0)
    rng = np.random.default_rng(11)
    eng = TrackingEngine(TrackingConfig(fs=FS), 4, 80000, device=card)
    ring = _ring(card, 80000 + eng.overlap, 11)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=card)

    c, k, p1, nt, w = 4, 20, 17, 3, 4608
    args = (ring[0], ring[1], 0,
            t(np.sort(rng.integers(0, 70000, (c, k))).astype(np.int32)),
            t(rng.uniform(0, 30, (c, k)).astype(np.float32)),
            t(rng.uniform(-0.01, 0.01, c).astype(np.float32)),
            t(np.sign(rng.standard_normal((c, p1, nt, w))).astype(np.float32)),
            t(rng.integers(0, 16, (c, k)).astype(np.int32)),
            t(rng.uniform(0, 1, (c, k)).astype(np.float32)), 4001)
    s = eng.init_state()
    for ch in range(c):
        s = eng.start_channel(s, ch, float(rng.uniform(-4000, 4000)),
                              int(rng.integers(0, 4000)), 4000)
    codes = t(np.stack([gps_l1ca_code(p) for p in PRNS[:c]])
              .astype(np.float32))
    packed = k1.pack_bank(args[6])
    reset_launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = k1.bank_corr(*args, packed=packed)
        sb, out = eng.superblock_ring_i8(s, ring, 0, 1, codes)
        torch.cuda.synchronize(card)
    assert LAUNCHES["bank_corr"] == 1 and LAUNCHES["scan_loop"] == 1
    assert torch.cuda.current_device() == 0
    ran = {e.device_index for e in prof.events()
           if "bank_corr_kernel" in e.name or "scan_loop_kernel" in e.name}
    assert ran == {card.index}, ran
    return [x.cpu() for x in (*got, out["packed"], sb.offset,
                              sb.carrier_doppler_hz)]


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


def _fir_decim_case(dev, decimation, n_taps, nco_step, n=50_001):
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    x = _cx(dev, n, n_taps)
    taps = np.random.default_rng(1).standard_normal(n_taps) \
        .astype(np.float32) / n_taps
    # an absolute index past 2^31 exercises the 64-bit NCO argument
    args = (x, taps, decimation, nco_step, 3 << 30)
    got, want = k7.fir_decim(*args), k7.fir_decim_plain(*args)
    assert got.shape == want.shape
    _rms_close(got, want, 1e-5)


def test_fir_decim_kernel_matches_plain(dev):
    """K7a against its plain version at decimations 1-5 (D <= 4 keep 8
    outputs a thread in register windows, D = 5 one) and 33-1001 taps,
    with and without the translation NCO; then D = 2 at 65 taps with a
    partial last tile (8 outputs a thread, 2048 a block), an input
    shorter than the taps, and the largest tap count the launcher takes
    (one more raises)
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    step = -1.1780972450961724
    for decimation, n_taps in ((1, 33), (2, 65), (4, 65), (3, 1001),
                               (5, 65)):
        for nco_step in (0.0, step):
            _fir_decim_case(dev, decimation, n_taps, nco_step)
    _fir_decim_case(dev, 2, 65, step, n=2 * (3 * 2048 + 37) + 1)
    _fir_decim_case(dev, 2, 65, step, n=40)
    most = k7.fir_max_taps(2, dev)
    assert most >= 4096
    _fir_decim_case(dev, 2, most, step)
    with pytest.raises(RuntimeError, match="fir_decim"):
        k7.fir_decim(_cx(dev, 100, 0), np.ones(most + 1, np.float32), 2)


def _notch_case(spec, factor=8.0, route=None):
    """K7c into a new tensor and in place against its plain version, to
    the bit; ``route``: the selection's expected route (0 among the
    bracket's candidates, 1 over all bins)."""
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    want = k7.notch_mask_plain(spec, factor)
    assert torch.equal(k7.notch_mask(spec, factor), want)
    assert torch.equal(k7.notch_mask_(spec.clone(), factor), want)
    sel = k7._notch_launch(spec, factor, torch.empty_like(spec))
    if route is not None:
        assert int(sel[k7.NOTCH_ROUTE]) == route


@pytest.mark.parametrize("n", [100_000, 99_999])
def test_pulse_blank_and_notch_kernels_match_plain(dev, n):
    """K7b and K7c against their plain versions, to the bit. K7c also on
    n = 1, 2, 3, a constant magnitude, 40% of the bins tied at the
    median, magnitudes within 4e-4 of 1.3, and a spectrum whose sampled
    bins are 60 dB louder, which
    misbrackets the median and forces the select over all bins
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    x = _cx(dev, n, 4)
    assert torch.equal(k7.pulse_blank(x, 4.0), k7.pulse_blank_plain(x, 4.0))
    _notch_case(torch.fft.fft(x), route=0)
    for tiny in (1, 2, 3):
        _notch_case(torch.fft.fft(_cx(dev, tiny, tiny)))
    _notch_case(torch.full((n,), 3 + 4j, dtype=torch.complex64, device=dev))
    rng = np.random.default_rng(9)
    noise = rng.standard_normal((2, n)).astype(np.float32)
    spec = torch.complex(*torch.as_tensor(noise, device=dev))
    spec[torch.as_tensor(rng.random(n) < 0.4, device=dev)] = 1.0
    _notch_case(spec, 1.5)
    # magnitudes 1.3 (1 +- 4e-4): the bracket's keys share two leading
    # bytes, whose radix passes the select skips
    phase = torch.as_tensor(rng.uniform(0, 2 * np.pi, n), device=dev)
    spec = torch.polar(
        torch.as_tensor(1.3 * (1.0 + 1e-4 * noise[0]), device=dev),
        phase.to(torch.float32))
    _notch_case(spec, 1.00005)
    spec = torch.complex(*torch.as_tensor(noise, device=dev))
    spec[k7.notch_sample_positions(n).to(dev)] *= 1000.0
    _notch_case(spec, route=1)


def _resample_case(dev, fs_out):
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    x = _cx(dev, 80_001, 6)
    for mode in (k7.MMSE, k7.DIRECT):
        got = k7.resample(x, 8e6, fs_out, mode)
        want = k7.resample_plain(x, 8e6, fs_out, mode)
        assert torch.equal(got, want), mode


def test_resample_kernel_matches_plain(dev):
    """K7d (both resamplers) against its plain version from 8 Msps to 4,
    6.4 and 3.3 Msps
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    for fs_out in (4e6, 6.4e6, 3.3e6):
        _resample_case(dev, fs_out)


def test_conditioner_wrappers_count_launches(dev):
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    x = _cx(dev, 4096, 7)
    reset_launches()
    k7.fir_decim(x, np.ones(5, np.float32), 2)
    k7.pulse_blank(x, 4.0)
    k7.notch_mask(x, 8.0)
    k7.notch_mask_(x.clone(), 8.0)
    k7.resample(x, 8e6, 4e6, k7.MMSE)
    k7.resample(x, 8e6, 4e6, k7.DIRECT)
    k7.fir_decim_plain(x, np.ones(5, np.float32), 2)
    k7.pulse_blank_plain(x, 4.0)
    assert {k: LAUNCHES[k] for k in ("fir_decim", "pulse_blank",
                                     "notch_mask", "resample")} \
        == {"fir_decim": 1, "pulse_blank": 1, "notch_mask": 2, "resample": 2}


@pytest.mark.parametrize("n_taps", [4, 6])
def test_bank_corr_kernel_with_data_tap_matches_plain(dev, n_taps):
    """K1 with the data-code bank appended as one more tap (3 + 1, the
    Galileo E1 pilot's 5 + 1) over E1-length windows of a bank of E1's
    CBOC levels (the first window at an odd byte, the last at the ring's
    end, row pair j0 = 15)."""
    ring = _ring(dev, 500000, n_taps)
    _bank_corr_case(dev, ring, 2, 25, n_taps, 16256, 16001, seed=n_taps,
                    cboc=True)


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
    125 Hz, CBOC replicas): the grid, its row peaks and both statistics
    agree with the plain versions (the second peak to the bit); K2a's
    rows each equal a launch of their bin alone to the bit."""
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
    _wipeoff_case(x, dop, c0)
    prod = acq.acq_product_plain(spec, eng._code_fft)
    assert torch.equal(acq.acq_product(spec, eng._code_fft), prod)
    corr = torch.fft.ifft(prod, dim=-1)
    gk, rmk, rak = acq.acq_accum(corr, None, 0, n)
    gp, rmp, rap = acq.acq_accum_plain(corr, None, 0, n)
    torch.testing.assert_close(gk, gp, rtol=1e-6, atol=0)
    assert torch.equal(rak, rap)
    for use_cfar in (True, False):
        sk = acq.acq_stats(gp, rmp, rap, 1, eng.cfg.samples_per_chip,
                           use_cfar)
        sp = acq.acq_stats_plain(gp, rmp, rap, 1, eng.cfg.samples_per_chip,
                                 use_cfar)
        assert torch.equal(sk[1], sp[1]) and torch.equal(sk[2], sp[2])
        if use_cfar:
            torch.testing.assert_close(sk[0], sp[0], rtol=1e-4, atol=0)
        else:
            assert torch.equal(sk[0], sp[0])


def test_fold_wipeoff_kernel_matches_plain(dev):
    """K5a at QuickSync's L1 (1 ms) and E1 (4 ms) shapes: phases up to
    ~125 rad at E1's last samples; S = 1 (equal to K2a to the bit), S = 3
    (the body's loop over segments) and an odd folded row (one output a
    thread), each on a grid of mirror pairs
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    for fold, n in ((2, 4000), (2, 16000), (4, 16368), (1, 4000),
                    (3, 12000), (2, 4002)):
        _fold_wipeoff_case(dev, fold, n)


def _fold_wipeoff_case(dev, fold, n):
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
    if fold == 1:
        from gnss_sdr_tpu_torch.kernels.acq import acq_wipeoff

        assert torch.equal(got, acq_wipeoff(x, dop, c0))


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
#: PRNs of the channels past the eighth (the cluster cases' C = 13)
MORE_PRNS = (3, 5, 7, 9, 24)
#: a PRN absent from every scene here (a channel tracking noise)
ABSENT_PRN = 30


def _pulled_in_scan(dev, e1, pilot=False, k_ext=1, n=8):
    """A scan engine (``n`` channels, 20 ms blocks), its ring, code tables
    and its state after 8 blocks of pull-in through the plain path."""
    from gnss_sdr_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1_subchips
    from gnss_sdr_tpu_torch.tracking.engine import (TrackingConfig,
                                                    TrackingEngine)

    rng = np.random.default_rng(30 + e1 + pilot)
    period = 16000 if e1 else 4000
    prns = (PRNS + MORE_PRNS)[:n]
    chans = list(zip(prns, rng.uniform(0, period, n),
                     rng.uniform(-4000, 4000, n)))
    kw = dict(fs=FS, enable_fll_pull_in=True, pull_in_time_s=0.1,
              extend_correlation_symbols=k_ext)
    if e1:
        kw.update(code_length_chips=4092, code_samples_per_chip=12,
                  veml=True, symbols_per_bit=1, pll_bw_hz=20.0,
                  pll_bw_narrow_hz=2.0,
                  early_late_space_chips=0.15,
                  very_early_late_space_chips=0.6, track_pilot=pilot)
    eng = TrackingEngine(TrackingConfig(**kw), n, 80000, device=dev)
    ring = _scene(dev, 40 * 80000 + eng.overlap, chans, e1, 40 + e1)

    def tables(comp):
        rows = [galileo_e1_subchips(p, comp, True) if e1 else gps_l1ca_code(p)
                for p in prns]
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


def test_scan_loop_matches_stepwise(dev):
    """K3-loop over one 10-block superblock from a pulled-in state against
    the per-step path on the card: the first step's correlations to the
    bit (K3's own body and window partition), every record and the end
    state within the JAX suite's tolerances; one launch per call, no K3
    launch; the float32 planes of process_block and superblock_step
    likewise; L1 and the E1 pilot in extended integration; L1 with a
    channel inactive from the start and one that loses lock inside the
    superblock; L1 with 5 and 13 channels (clusters of 8 blocks: C not a
    multiple of what the card holds at once)
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    for case in ("l1", "e1-pilot-extended", "l1-edge", "l1-c5", "l1-c13"):
        _scan_loop_case(dev, case)


def _edge_channels(state, codes, max_fail):
    """A state with channel 3 inactive from the start and channel 1 on a
    code table of a PRN absent from the scene with its lock-fail counters
    at their limits (``max_fail``: code, carrier), so that it loses lock
    at its next failed test; the code tables to match."""
    from gnss_sdr_tpu_torch.codes import gps_l1ca_code

    active = state.active.clone()
    active[3] = False
    fails = [f.clone() for f in (state.code_lock_fail,
                                 state.carrier_lock_fail)]
    for f, m in zip(fails, max_fail):
        f[1] = m
    codes = codes.clone()
    codes[1] = torch.as_tensor(gps_l1ca_code(ABSENT_PRN).astype(np.float32),
                               device=codes.device)
    return state._replace(active=active, code_lock_fail=fails[0],
                          carrier_lock_fail=fails[1]), codes


def _scan_loop_case(dev, case):
    from gnss_sdr_tpu_torch.codes.galileo_e1 import E1C_SECONDARY
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches

    e1 = case.startswith("e1")
    n = {"l1-c5": 5, "l1-c13": 13}.get(case, 8)
    eng, ring, codes, dcodes, s, chans = _pulled_in_scan(
        dev, e1, pilot=e1, k_ext=25 if e1 else 20, n=n)
    base = 8 * 80000
    if e1:          # extended integration over the CS25-wiped pilot
        for ch, p in enumerate(_next_periods(s, chans, base, 16000)):
            s = eng.set_extended(s, ch, p % 25, E1C_SECONDARY)
    else:
        for ch in range(0, n, 2):
            s = eng.set_extended(s, ch, ch % 20)
    if case == "l1-edge":
        s, codes = _edge_channels(s, codes, (eng.cfg.max_code_lock_fail,
                                             eng.cfg.max_carrier_lock_fail))
    sa, pa = eng._blocks_stepwise(s, ring[0], ring[1], base, 80000, 10,
                                  codes, dcodes)
    if case == "l1-edge":   # the two channels are what the case holds
        assert not bool(s.loss_of_lock[1]) and bool(sa.loss_of_lock[1])
        assert not bool(pa[..., 3, 0].any())
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
    assert pb.shape == (10, eng.n_steps, n, 15 + 2 * t)
    if case != "l1":
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


def _fast_case(dev, case, correlator="bank"):
    """(fast engine, ring, code tables, data code tables, start state,
    base) of one K1-loop case, pulled in on a scan engine through the
    plain path; ``correlator`` selects the bank or the segmented sum."""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import E1C_SECONDARY
    from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

    e1 = case.startswith("e1")
    shape, _, e1_loop = case.partition(":")
    pilot = shape == "e1-pilot"
    eng, ring, codes, dcodes, s, chans = _pulled_in_scan(
        dev, e1, pilot, n={"fllpll-c5": 5, "fllpll-c13": 13}.get(case, 8))
    cfg = dataclasses.replace(
        eng.cfg, extend_correlation_symbols={"e1-pilot": 25,
                                             "e1-k1": 1}.get(shape, 20),
        pll_bw_narrow_hz=2.0 if pilot else 5.0)
    loop = e1_loop or (case if case in ("kf", "gaussian") else "fllpll")
    fast = FastTrackingEngine(cfg, eng.n_channels, {"e1-pilot": 1,
                                                    "e1-k1": 25}.get(
        shape, 5), correlator=correlator, loop=loop,
        sec_max_len=25 if pilot else 1, device=dev)
    fs = fast.from_track_state(s)
    base = 8 * 80000
    if pilot:
        for ch, p in enumerate(_next_periods(s, chans, base, 16000)):
            fs = fast.set_secondary(fs, ch, E1C_SECONDARY, p % 25)
    return fast, ring, codes, dcodes, fs, base


def test_fast_loop_matches_stepwise(dev):
    """K1-loop over one superblock from a pulled-in state against the
    per-group path on the card (K1, K6 and PyTorch): the first group's
    prompts to the bit (K1's own body), every record, the group prompts
    and the end state within the JAX suite's tolerances; one launch per
    call and no K1 or K6 launch, for the three loops at L1 (K = 20) and
    at the E1 pilot with the data tap and CS25 (K = 25), and E1-B alone
    (K = 1);
    process_block's float32 planes likewise; at L1 with a channel
    inactive from the start and one that loses lock inside the
    superblock, and with 5 and 13 channels (clusters of 10 blocks: C
    not a multiple of what the card holds at once)
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    for case in ("fllpll", "kf", "gaussian", "e1-pilot", "e1-k1",
                 "fllpll-edge", "fllpll-c5", "fllpll-c13", "e1-pilot:kf",
                 "e1-pilot:gaussian"):
        _fast_loop_case(dev, case)


def _fast_loop_case(dev, case):
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches

    fast, ring, codes, dcodes, s, base = _fast_case(dev, case)
    if case == "fllpll-edge":
        s, codes = _edge_channels(s, codes, (fast.cfg.max_code_lock_fail,
                                             fast.cfg.max_carrier_lock_fail))
    bank = fast.get_bank(codes, dcodes)
    nb = 2 if case.startswith("e1-pilot") else 4
    sa, pa, ra, ia = fast._blocks_stepwise(s, ring[0], ring[1], base,
                                           fast.block_samples, nb, bank)
    if case == "fllpll-edge":   # the two channels are what the case holds
        assert not bool(s.loss_of_lock[1]) and bool(sa.loss_of_lock[1])
        assert not bool(pa[..., 3, 5 * fast.k + 2].any())
    reset_launches()
    sb, out = fast.superblock_ring_i8(s, ring, base, nb, bank)
    assert LAUNCHES["fast_loop"] == 1
    assert sum(LAUNCHES[k] for k in ("bank_corr", "kf_step",
                                     "gaussian_step")) == 0
    pb, k = out["packed"], fast.k
    assert pb.shape == (nb, fast.g, fast.n_channels, 5 * k + 4)
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


def test_fast_loop_segsum_matches_stepwise(dev, monkeypatch):
    """K1-loop with the segmented-sum body (K1-seg) over one superblock
    from a pulled-in state against the per-group path on the card: the
    plain version differences float32 prefix sums where the kernel sums
    each chip's samples, so the first group's period correlations agree
    within 1e-4 of the group's prompt magnitude (not to the bit), every
    record, the group prompts and the end state within the JAX suite's
    tolerances; one fast_loop_seg launch per call, no other launch and no
    call of the per-group path; L1 (K = 20) and the E1 pilot with the
    data prompt and CS25 (K = 25)
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    for case in ("fllpll", "e1-pilot"):
        with monkeypatch.context() as mp:
            _fast_loop_segsum_case(dev, case, mp)


def _fast_loop_segsum_case(dev, case, monkeypatch):
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

    fast, ring, codes, dcodes, s, base = _fast_case(dev, case, "segsum")
    tables = fast.get_bank(codes, dcodes)
    assert tuple(tables.shape) == (8, 1 + fast.track_pilot, fast.table_len)
    nb = 2 if case == "e1-pilot" else 4
    sa, pa, ra, ia = fast._blocks_stepwise(s, ring[0], ring[1], base,
                                           fast.block_samples, nb, tables)

    def refuse(*a, **k):
        raise AssertionError("the per-group path ran on the card")
    monkeypatch.setattr(FastTrackingEngine, "_blocks_stepwise", refuse)
    reset_launches()
    sb, out = fast.superblock_ring_i8(s, ring, base, nb, tables)
    assert {k: v for k, v in LAUNCHES.items() if v} == {"fast_loop_seg": 1}
    pb, k = out["packed"], fast.k
    assert pb.shape == (nb, fast.g, 8, 5 * k + 4)
    group = torch.hypot(ra[0, 0], ia[0, 0])
    err = (pa[0, 0, :, 2 * k:5 * k] - pb[0, 0, :, 2 * k:5 * k]).abs() \
        .amax(dim=1)
    assert bool((err <= 1e-4 * group).all()), (err / group)
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
        assert LAUNCHES["fast_loop_seg"] == 1
        assert torch.equal(o1["packed"], pb[0])
        mag = torch.hypot(o1["prompt_re"], o1["prompt_im"])
        ref = torch.hypot(ra[0], ia[0])
        assert float(((mag - ref).abs() / ref).max()) < 0.02


def _hd_windows(dev, seed, length, table_len, accel_x10g, c=4,
                code_rate=None, rem=None, lengths=None):
    """K3-hd arguments at a tracking width (4 Msps): ``c`` float32 windows
    of one C/A-like table (1023 entries, 3 taps) or E1-like sub-chip
    table (49104 entries, 5 taps) read at the quadratic code phase of
    ``accel_x10g`` x 10 g under its quadratic carrier, plus noise; and
    the code and carrier rates. ``code_rate``, ``rem`` and ``lengths``
    replace the code rate, the code phase remainders and the valid
    lengths drawn from the dynamics and the seed."""
    fs = 4e6
    cspc = 1 if table_len == 1023 else 12
    rng = np.random.default_rng(seed)
    f_dot = 98.0665 / (299792458.0 / 1575.42e6) * accel_x10g
    code = np.sign(rng.standard_normal((c, table_len))).astype(np.float32)
    step = (np.full(c, 1.023e6 * cspc / fs)
            * (1.0 + rng.uniform(-3e-6, 3e-6, c))).astype(np.float32)
    if code_rate is None:
        code_rate = f_dot * 1.023e6 / 1575.42e6 * cspc / fs ** 2
    code_rate = np.full(c, code_rate, np.float32)
    carr_rate = np.full(c, 2.0 * np.pi * f_dot / fs ** 2, np.float32)
    rem = (rng.uniform(0, 3, c) if rem is None
           else np.broadcast_to(rem, (c,))).astype(np.float32)
    rem_carr = rng.uniform(0, 6.28, c).astype(np.float32)
    carr_step = rng.uniform(-0.01, 0.01, c).astype(np.float32)
    n = np.arange(length, dtype=np.float64)
    x = np.zeros((c, length), np.complex64)
    for i in range(c):
        chip = np.floor(step[i] * n - rem[i] + 0.5 * code_rate[i] * n * n)
        ph = rem_carr[i] + carr_step[i] * n + 0.5 * carr_rate[i] * n * n
        x[i] = code[i, chip.astype(np.int64) % table_len] * np.exp(1j * ph) \
            + rng.standard_normal(length) + 1j * rng.standard_normal(length)
    spc = 0.15 * cspc if cspc == 12 else 0.5 * cspc
    shifts = [-0.6 * cspc, -spc, 0.0, spc, 0.6 * cspc] if cspc == 12 \
        else [-spc, 0.0, spc]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    planes = (t(x.real.astype(np.float32).ravel()),
              t(x.imag.astype(np.float32).ravel()))
    if lengths is None:
        lengths = rng.integers(length - 16, length + 1, c)
    args = planes + (
        0, t((np.arange(c) * length).astype(np.int32)),
        t(np.asarray(lengths).astype(np.int32)),
        t(code), t(np.asarray(shifts, np.float32)), t(rem), t(step),
        t(rem_carr), t(carr_step), length, 2)
    return args, t(carr_rate), t(code_rate)


def test_multicorr_hd_kernel_matches_plain(dev):
    """K3-hd against ``multicorrelate_hd`` on the same windows at the L1
    (4016 samples, 3 taps) and E1 (16016, 5 taps, 49104 entries) widths,
    10 g and 1000 g: the same float32 code index and carrier phase
    (formed alike), the sums in another order: within 1e-5 of the prompt
    magnitude; one multicorr_hd launch; without a carrier rate the linear
    carrier; a carrier rate alone refused on the card. Then the edges of
    the kernel's per-slice table staging: a negative code rate whose
    vertex (-step / rate, the code phase's turning point) falls inside
    the window; code indices that wrap past the table's end inside one
    slice; valid lengths that are no multiple of the 8 slices, or end
    slices early (the slices past them sum nothing)
    (the cases run in one test: the tier-1 run's count of collected
    tests sets xdist's schedule of the memory-heavy JAX tests)."""
    for length, table_len in ((4016, 1023), (16016, 49104)):
        for accel_x10g in (1.0, 100.0):
            _hd_case(dev, length, table_len, accel_x10g)
    l1_step, e1_step = 1.023e6 / 4e6, 12 * 1.023e6 / 4e6
    # vertices at samples 2000 and 9001 (slices 3 and 4)
    _hd_case(dev, 4016, 1023, 1.0, code_rate=-l1_step / 2000.0)
    _hd_case(dev, 16016, 49104, 100.0, code_rate=-e1_step / 9001.0)
    # the index passes the table's end at sample ~1262 (slice 2) / ~977
    # (slice 0)
    _hd_case(dev, 4016, 1023, 100.0, rem=-700.3)
    _hd_case(dev, 16016, 49104, 1.0, rem=-(49104 - 3000.5))
    _hd_case(dev, 4016, 1023, 1.0, lengths=[4013, 1500, 4011, 300])
    _hd_case(dev, 16016, 49104, 1.0, lengths=[16009, 7001, 16015, 2003])


def _hd_case(dev, length, table_len, accel_x10g, **kw):
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.kernels import multicorr as k3

    args, carr_rate, code_rate = _hd_windows(dev, 8, length, table_len,
                                             accel_x10g, **kw)
    for rates in ((carr_rate, code_rate), (None, code_rate)):
        reset_launches()
        got = k3.multicorr(*args, *rates)
        assert {k: v for k, v in LAUNCHES.items() if v} == \
            {"multicorr_hd": 1}
        want = k3.multicorr_plain(*args, *rates)
        mid = want[0].shape[1] // 2
        prompt = torch.hypot(want[0][:, mid], want[1][:, mid])
        for g, w in zip(got, want):
            err = (g - w).abs().amax(dim=1)
            assert bool((err <= 1e-5 * prompt).all()), (err / prompt)
    with pytest.raises(ValueError, match="code rate"):
        k3.multicorr(*args, carr_rate, None)


def _beamform_case(dev, m, n, pad, offset):
    """K7e on the interleaved complex64 capture x [M, N], a view ``offset``
    samples into rows of N + ``pad`` (``offset`` 1: a base that is not
    16-byte aligned; an odd row length: rows that are not), against its
    plain version (within 1e-5 of the output rms) and against itself on
    the two contiguous planes of x (to the bit)."""
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    rng = np.random.default_rng(m * n + pad)
    big = (rng.standard_normal((m, n + pad))
           + 1j * rng.standard_normal((m, n + pad))).astype(np.complex64)
    x = torch.as_tensor(big, device=dev)[:, offset:offset + n]
    w_re, w_im = (torch.as_tensor(rng.standard_normal(m).astype(np.float32),
                                  device=dev) for _ in range(2))
    got = k7.beamform_complex(x, w_re, w_im)
    assert got.dtype == torch.complex64 and got.shape == (n,)
    planes = [a.contiguous() for a in torch.view_as_real(x).unbind(-1)]
    assert torch.equal(torch.complex(*k7.beamform(*planes, w_re, w_im)), got)
    views = torch.view_as_real(x).unbind(-1)
    assert torch.equal(torch.complex(*k7.beamform(*views, w_re, w_im)), got)
    _rms_close(got, torch.complex(*k7.beamform_plain(*planes, w_re, w_im)),
               1e-5)


def test_beamform_kernel_matches_plain(dev):
    """K7e against JAX's einsums on the card (M = 8, N = 100 000): within
    1e-5 of the output rms, from contiguous planes and from the planes of
    one interleaved capture alike (to the bit), at an N that is no
    multiple of 4, from a base that is not 16-byte aligned and at other
    M (3 to 32, past one batch of eight rows' loads); one launch per
    filter call, which returns one complex64 array; the filter's gain in
    its look direction and its null on the jammer."""
    from gnss_sdr_tpu_torch.conditioner.beamformer import (BeamformerFilter,
                                                           array_response)
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    rng = np.random.default_rng(12)
    m, n = 8, 100_000
    sig = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)
    jam = 10 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = array_response(m, 0.5, 10.0)[:, None] * sig \
        + array_response(m, 0.5, 55.0)[:, None] * jam
    bf = BeamformerFilter.steered(m, 0.5, 10.0, device=dev)
    x_re = torch.as_tensor(x.real.astype(np.float32), device=dev)
    x_im = torch.as_tensor(x.imag.astype(np.float32), device=dev)
    got = k7.beamform(x_re, x_im, bf._w_re, bf._w_im)
    want = k7.beamform_plain(x_re, x_im, bf._w_re, bf._w_im)
    _rms_close(torch.complex(*got), torch.complex(*want), 1e-5)
    for case in ((8, 100_000, 0, 0), (8, 100_001, 1, 0), (8, 100_003, 0, 0),
                 (8, 99_998, 2, 1), (5, 100_001, 1, 0), (3, 7, 0, 0),
                 (11, 100_000, 0, 0), (32, 4_002, 2, 0)):
        _beamform_case(dev, *case)
    reset_launches()
    y = bf.apply(x)
    assert {k: v for k, v in LAUNCHES.items() if v} == {"beamform": 1}
    assert isinstance(y, np.ndarray) and y.dtype == np.complex64 \
        and y.shape == (n,)
    corr = np.vdot(sig, y) / np.vdot(sig, sig)
    assert abs(abs(corr) - 1.0) < 0.05
    jam_single = x[0] - array_response(m, 0.5, 10.0)[0] * sig
    assert np.mean(np.abs(y - corr * sig) ** 2) < 0.2 * np.mean(
        np.abs(jam_single) ** 2)


def test_collectives_match_plain(dev):
    """K8a and K8b against their plain versions on a logical mesh of four
    shards on one card, to the bit, one launch per wrapper call: K8a on
    float32 [4, L] rows and on the planar int8 ring's time shards (views
    of the ring; L a multiple of 16 and not), with and without a next
    rank's head; K8b on [D, N] grids (one whose rows are not 16-byte
    aligned: the element-wise path) for every shard and for two of four
    (one process's). With two cards or more, the same over a mesh of the
    real cards (peer reads, or staged copies where a card cannot read its
    peer)."""
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.kernels import collectives as k8
    from gnss_sdr_tpu_torch.parallel import make_mesh
    from gnss_sdr_tpu_torch.parallel.multihost import (
        allreduce_noncoherent_grid, halo_exchange_blocks)

    rng = np.random.default_rng(8)
    mesh = make_mesh(4, device=dev, logical=True)
    for length, halo in ((4096, 1000), (1001, 13)):
        x = torch.as_tensor(rng.standard_normal((4, length))
                            .astype(np.float32), device=dev)
        reset_launches()
        got = halo_exchange_blocks(mesh, x, halo)
        assert LAUNCHES["halo_exchange"] == 1
        assert torch.equal(got, torch.stack(
            k8.halo_exchange_plain(list(x.unbind(0)), halo)))
        ring = _ring(dev, 4 * length, length)
        pieces = [ring[:, g * length:(g + 1) * length] for g in range(4)]
        for head in (None, ring[:, :halo].clone()):
            reset_launches()
            got = k8.halo_exchange(pieces, halo, head)
            assert LAUNCHES["halo_exchange"] == 1
            want = k8.halo_exchange_plain(pieces, halo, head)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    for shape in ((32, 1200), (7, 13)):
        g = torch.as_tensor(rng.standard_normal((4,) + shape)
                            .astype(np.float32) ** 2, device=dev)
        want = k8.grid_allreduce_plain(list(g.unbind(0)))
        reset_launches()
        got = allreduce_noncoherent_grid(mesh, g)
        assert LAUNCHES["grid_allreduce"] == 1
        assert torch.equal(got, torch.stack(want))
        reset_launches()
        part = k8.grid_allreduce(list(g.unbind(0)), local=[2, 3])
        assert LAUNCHES["grid_allreduce"] == 1 and len(part) == 2
        assert all(torch.equal(p, want[0]) for p in part)
    if torch.cuda.device_count() < 2:
        return
    cards = make_mesh(2)
    x = torch.as_tensor(rng.standard_normal((2, 2, 5000)).astype(np.int8)
                        .astype(np.float32), device=dev)
    shards = [x[i].to(d) for i, d in enumerate(cards.devices)]
    reset_launches()
    got = halo_exchange_blocks(cards, shards, 700)
    assert LAUNCHES["halo_exchange"] == 2           # one launch a card
    want = k8.halo_exchange_plain([s.to(dev) for s in shards], 700)
    assert all(o.device == d and torch.equal(o.to(dev), w)
               for o, d, w in zip(got, cards.devices, want))
    grids = [(x[i, 0] ** 2).to(d) for i, d in enumerate(cards.devices)]
    got = allreduce_noncoherent_grid(cards, grids)
    want = k8.grid_allreduce_plain([gr.to(dev) for gr in grids])
    assert all(torch.equal(o.to(dev), w) for o, w in zip(got, want))
