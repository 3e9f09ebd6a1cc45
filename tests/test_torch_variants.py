"""Parity of the port's acquisition variants (QuickSync on K5a, CCCWSR on
K5b, the E5a noncoherent I/Q CAF search and Tong on K2) and of its
implementation-name registry with the JAX package on the CPU.

Inputs are the JAX tests' own (``tests/test_acq_variants.py``,
``tests/test_tong.py``): the same seeded signals at the same rates. Each
search must give the same delay and Doppler as the JAX engine and test
statistics within 1e-4 relative; each grid must agree within 1e-4 of its
peak (the JAX package transforms with float32 matmul DFTs, the port with
``torch.fft``, so the grids differ by float32 rounding of the
transforms). Tong's counters must follow the same sequence dwell by
dwell.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.acquisition import adapters as jad
from gnss_sdr_tpu.acquisition import variants as jvar
from gnss_sdr_tpu.acquisition.tong import TongAcquisition as JTong
from gnss_sdr_tpu.codes import gps_l1ca_code, sample_code
from gnss_sdr_tpu.codes.galileo_e5a import galileo_e5a_code
from gnss_sdr_tpu_torch.acquisition import AcqConfig, TongAcquisition
from gnss_sdr_tpu_torch.acquisition import adapters as tad
from gnss_sdr_tpu_torch.acquisition.pcps import PcpsAcquisition
from gnss_sdr_tpu_torch.acquisition.variants import (
    CccwsrAcquisition, NoncoherentIQCafAcquisition, QuickSyncAcquisition)
from gnss_sdr_tpu_torch.kernels.acq import pcps_magnitude_grid
from gnss_sdr_tpu_torch.kernels.acq_variants import cccwsr_grid, folded_grid

torch.set_num_threads(2)

#: the JAX registry test's rates per signal
TEST_FS = {
    "1C": 2.048e6, "2S": 1.2e6, "L5": 12.5e6, "1B": 4.092e6,
    "5X": 12.5e6, "7X": 12.5e6, "E6": 10.24e6, "1G": 1.022e6,
    "2G": 1.022e6, "B1": 4.092e6, "B3": 12.5e6,
}
ENGINES = {"pcps": PcpsAcquisition, "tong": TongAcquisition,
           "quicksync": QuickSyncAcquisition, "cccwsr": CccwsrAcquisition,
           "nciq_caf": NoncoherentIQCafAcquisition}


def synth_from_replica(replica, delay, doppler, fs, cn0_db=50.0, seed=3,
                       n_copies=3):
    """``tests/test_acq_variants.py::synth_from_replica``."""
    rng = np.random.default_rng(seed)
    sig = np.roll(np.tile(replica, n_copies), delay)
    n = sig.shape[0]
    t = np.arange(n) / fs
    sigma = np.sqrt(fs / (2 * 10 ** (cn0_db / 10)))
    noise = sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (sig * np.exp(2j * np.pi * doppler * t) + noise).astype(
        np.complex64)


def _same_results(jres, tres, prns):
    for prn in prns:
        a, b = jres[prn], tres[prn]
        assert b.positive == a.positive, prn
        assert b.delay_samples == a.delay_samples, prn
        assert b.doppler_hz == a.doppler_hz, prn
        assert b.threshold == pytest.approx(a.threshold, rel=1e-6)
        assert b.test_statistic == pytest.approx(a.test_statistic, rel=1e-4)


def _grid_close(jgrid, tgrid):
    a = np.asarray(jgrid)
    b = tgrid.numpy() if torch.is_tensor(tgrid) else np.asarray(tgrid)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(a))


def test_registry_builds_every_name():
    assert tad.ACQ_IMPLEMENTATIONS == jad.ACQ_IMPLEMENTATIONS
    for name, (suffix, variant, _) in tad.ACQ_IMPLEMENTATIONS.items():
        engine = tad.make_acquisition(name, [1, 2], TEST_FS[suffix],
                                      device="cpu")
        assert type(engine) is ENGINES[variant], name
        assert engine.prns == [1, 2], name
    with pytest.raises(ValueError, match="GPS_L1_CA_PCPS_Acquisition"):
        tad.make_acquisition("GPS_L1_CA_PCPS_Acquisitionn", [1], 2.048e6,
                             device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tad.make_acquisition("GPS_L1_CA_PCPS_QuickSync_Acquisition", [1],
                             2.048e6, folding_factor=3, device="cpu")
    qs = tad.make_acquisition("Galileo_E1_PCPS_QuickSync_Ambiguous_"
                              "Acquisition", [1], 4.092e6, folding_factor=4,
                              device="cpu")
    assert qs.folding_factor == 4 and qs.n_folded == 16368 // 4
    caf = tad.make_acquisition("Galileo_E5a_Noncoherent_IQ_Acquisition_CAF",
                               [3], 12e6, caf_window_hz=750.0,
                               both_signal_components=False, device="cpu")
    assert caf.caf_window_hz == 750.0 and caf._eng_q is None


def test_signal_replicas_match_jax():
    """Every signal's replicas, each code component, exactly."""
    for suffix, fs in TEST_FS.items():
        comps = {"1B": "BC", "5X": "IQ", "7X": "IQ", "L5": "IQ",
                 "E6": "BC"}.get(suffix, [None])
        for comp in comps:
            a = jad.signal_replicas(suffix, [3, 5], fs, 0, comp)
            b = tad.signal_replicas(suffix, [3, 5], fs, 0, comp)
            for prn in (3, 5):
                np.testing.assert_array_equal(b[prn], a[prn],
                                              err_msg=f"{suffix} {comp}")


@pytest.mark.parametrize("folding", [2, 4])
def test_quicksync_grid_and_search_match_jax(folding):
    """``TestQuickSync``'s scene: the delay in the second fold half, found
    only by the host's disambiguation."""
    fs = 2.048e6
    kw = dict(pfa=0.001, doppler_max=3000.0, doppler_step=250.0,
              folding_factor=folding)
    name = "GPS_L1_CA_PCPS_QuickSync_Acquisition"
    je = jad.make_acquisition(name, [17, 3], fs, **kw)
    te = tad.make_acquisition(name, [17, 3], fs, device="cpu", **kw)
    replica = jad.signal_replicas("1C", [17], fs, 1)[17]
    delay = 2048 // 2 + 137
    x = synth_from_replica(replica, delay, 750.0, fs, cn0_db=55.0)
    seg = x[:je.cfg.coherent_samples].reshape(folding, -1)
    jgrid = jvar._folded_grid(
        jnp.asarray(seg.real.astype(np.float32)),
        jnp.asarray(seg.imag.astype(np.float32)), je._cf_re, je._cf_im,
        je._dopplers, je._fs, je._plan)
    tgrid = folded_grid(torch.from_numpy(x[:je.cfg.coherent_samples]),
                        te._code_fft, te._dopplers, te._c0, folding)[0]
    _grid_close(jgrid, tgrid)
    jres, tres = je.search(x), te.search(x)
    _same_results(jres, tres, [17, 3])
    assert tres[17].positive
    assert abs(tres[17].delay_samples - delay) < 0.5 * fs / 1.023e6


def test_cccwsr_grid_and_search_match_jax():
    """``TestCccwsr``'s scene: E1 data minus pilot, the sign-recovery
    branch finds the full coherent gain."""
    fs = 4.092e6
    name = "Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition"
    kw = dict(pfa=0.001, doppler_max=3000.0, doppler_step=125.0)
    je = jad.make_acquisition(name, [19], fs, **kw)
    te = tad.make_acquisition(name, [19], fs, device="cpu", **kw)
    data = jad.signal_replicas("1B", [19], fs, 4, "B")[19]
    pilot = jad.signal_replicas("1B", [19], fs, 4, "C")[19]
    x = synth_from_replica((data - pilot) / np.sqrt(2), 1234, -500.0, fs)
    seg = x[:je.cfg.coherent_samples]
    jgrid = jvar._cccwsr_grid(
        jnp.asarray(seg.real.astype(np.float32)),
        jnp.asarray(seg.imag.astype(np.float32)), je._cb[0], je._cb[1],
        je._cc[0], je._cc[1], je._dopplers, je._fs, je._plan)
    tgrid = cccwsr_grid(torch.from_numpy(seg), te._cb, te._cc, te._dopplers,
                        te._c0)[0]
    _grid_close(jgrid, tgrid)
    jres, tres = je.search(x), te.search(x)
    _same_results(jres, tres, [19])
    assert tres[19].positive and tres[19].delay_samples == 1234.0


@pytest.mark.parametrize("caf_window_hz", [0.0, 1000.0])
def test_e5a_noncoherent_iq_caf_matches_jax(caf_window_hz):
    """``test_e5a_noncoherent_iq_caf_acquisition``'s 4 ms, 12 Msps E5a
    I/Q capture, two dwells, with and without the CAF refinement."""
    fs, prn = 12.0e6, 4
    rng = np.random.default_rng(5)
    ci = galileo_e5a_code(prn, "I").astype(np.float64)
    cq = galileo_e5a_code(prn, "Q").astype(np.float64)
    n = int(fs * 0.004)
    t = np.arange(n) / fs
    delay, dopp = 5321, 1570.0
    chips = np.floor((np.arange(n) - delay) * 10.23e6 / fs).astype(np.int64)
    x = ((ci[chips % 10230] + 1j * cq[chips % 10230]) / np.sqrt(2.0)
         * np.exp(2j * np.pi * dopp * t))
    x = (x + 0.9 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    name = "Galileo_E5a_Noncoherent_IQ_Acquisition_CAF"
    kw = dict(doppler_max=4000.0, doppler_step=250.0, pfa=0.001,
              max_dwells=2, caf_window_hz=caf_window_hz)
    je = jad.make_acquisition(name, [prn, 9], fs, **kw)
    te = tad.make_acquisition(name, [prn, 9], fs, device="cpu", **kw)
    if caf_window_hz == 0.0:
        xj = je._eng_i._prepare_buffer(x, 1)
        ti = te._eng_i
        _grid_close(je._eng_q._grid(xj, je._eng_q._dopplers),
                    pcps_magnitude_grid(ti._prepare_buffer(x, 1),
                                        te._eng_q._code_fft, ti._dopplers,
                                        ti._c0, ti._offset, ti._eff))
    jres, tres = je.search(x), te.search(x)
    _same_results(jres, tres, [prn, 9])
    assert tres[prn].positive
    assert abs(tres[prn].delay_samples - delay) < 2.0
    assert abs(tres[prn].doppler_hz - dopp) <= 250.0


def _tong_signal(fs, prn, delay, doppler, n_ms, cn0_db=45.0, seed=3):
    """``tests/test_tong.py::_signal``."""
    rng = np.random.default_rng(seed)
    n = int(fs * n_ms * 1e-3)
    code = sample_code(gps_l1ca_code(prn), fs, 1.023e6)
    chips = np.roll(np.tile(code, n_ms + 1), delay)[:n]
    t = np.arange(n) / fs
    sig = chips * np.exp(2j * np.pi * doppler * t)
    sigma = np.sqrt(fs / (2 * 10 ** (cn0_db / 10)))
    return (sig + sigma * (rng.standard_normal(n)
                           + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def test_tong_counter_sequence_matches_jax():
    """``test_tong_counts_up_to_positive_and_down_to_negative``'s scene
    and calibration; then the same sequence dwell by dwell, the forced
    negative at the dwell cap and ``reset``."""
    fs = 4.0e6
    cfg = dict(fs=fs, samples_per_code=4000, code_length_chips=1023,
               ms_per_code=1, doppler_max=5000.0, doppler_step=250.0)
    jcfg = jad.AcqConfig(**cfg)
    tcfg = AcqConfig(**cfg)
    codes = jad.gps_l1ca_replicas([5, 11], fs, 1)
    x = _tong_signal(fs, 5, 812, -1750.0, 8)
    n = tcfg.consumed_samples
    jprobe = JTong(jcfg, codes, threshold=np.inf, tong_max_dwells=100)
    tprobe = TongAcquisition(tcfg, codes, threshold=np.inf,
                             tong_max_dwells=100, device="cpu")
    jprobe.process_dwell(x[:n])
    tprobe.process_dwell(x[:n])
    _grid_close(jprobe._grid_acc, tprobe._grid_acc)
    peaks = np.asarray(jnp.max(jprobe._grid_acc.reshape(2, -1), axis=-1))
    thr = 0.5 * (peaks[0] + peaks[1])
    for kw in (dict(tong_init_val=1, tong_max_val=2, tong_max_dwells=10),
               dict(tong_init_val=2, tong_max_val=4, tong_max_dwells=6),
               dict(tong_init_val=1, tong_max_val=1000, tong_max_dwells=3)):
        ja = JTong(jcfg, codes, threshold=thr, **kw)
        ta = TongAcquisition(tcfg, codes, threshold=thr, device="cpu", **kw)
        for d in range(kw["tong_max_dwells"]):
            seg = x[(d % 8) * n:(d % 8 + 1) * n]
            jn, tn = ja.process_dwell(seg, d * n), ta.process_dwell(seg,
                                                                    d * n)
            assert ta.tong_count == ja.tong_count and sorted(tn) == sorted(jn)
            _same_results(jn, tn, list(jn))
            assert ta.dwell_count == ja.dwell_count
        assert sorted(ta.decided) == sorted(ja.decided)
    ta = TongAcquisition(tcfg, codes, threshold=thr, device="cpu")
    res = ta.search(x)
    assert res[5].positive and not res[11].positive
    assert abs(res[5].delay_samples - 812) < 2.0
    ta.reset()
    assert ta.dwell_count == 0 and ta._grid_acc is None and not ta.decided
    assert ta.tong_count == {5: 1, 11: 1}
