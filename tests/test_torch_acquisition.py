"""Parity of the port's PCPS acquisition (K2 plain path) with the JAX
package on the CPU.

Grid: <= 1e-3 of the grid maximum (the JAX side computes its transforms
as a float32 matmul DFT, the port with torch.fft). Statistics: rel. 1e-5
on identical grids and identical argmax. Search: the same positive flag,
delay and Doppler bin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.acquisition import pcps as jpcps
from gnss_sdr_tpu.acquisition.adapters import \
    make_gps_l1ca_acquisition as jmake
from gnss_sdr_tpu.codes import gps_l1ca_code, sample_code
from gnss_sdr_tpu_torch.acquisition.adapters import \
    make_gps_l1ca_acquisition as tmake
from gnss_sdr_tpu_torch.kernels import acq

torch.set_num_threads(2)
FS = 2.5e6


def synth(prn, delay, doppler, n_ms, cn0_db=45.0, fs=FS, seed=1):
    rng = np.random.default_rng(seed)
    n = int(fs * n_ms * 1e-3)
    code = sample_code(gps_l1ca_code(prn), fs, 1.023e6)
    delayed = np.roll(np.tile(code, n_ms + 1), int(delay))[:n]
    t = np.arange(n) / fs
    sigma = np.sqrt(fs / (2 * 10 ** (cn0_db / 10)))
    noise = sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (delayed * np.exp(2j * np.pi * doppler * t) + noise) \
        .astype(np.complex64)


@pytest.fixture(scope="module")
def engines():
    kw = dict(doppler_max=5000, doppler_step=250, pfa=0.001, max_dwells=2)
    prns = [3, 5, 11, 19]
    return jmake(prns, FS, **kw), tmake(prns, FS, device="cpu", **kw)


@pytest.mark.parametrize("bit_transition", [False, True])
def test_magnitude_grid_parity(bit_transition):
    kw = dict(doppler_max=4000, doppler_step=500,
              bit_transition_flag=bit_transition)
    je, te = jmake([5, 11], FS, **kw), tmake([5, 11], FS, device="cpu", **kw)
    x = synth(5, 700, 1500.0, 4)
    xj = je._prepare_buffer(x, 0)
    want = np.asarray(je._grid(xj, je._dopplers))
    got = acq.pcps_magnitude_grid(te._prepare_buffer(x, 0), te._code_fft,
                                  te._dopplers, te._c0, te._offset, te._eff)
    assert got.shape == want.shape
    assert np.max(np.abs(got.numpy() - want)) <= 1e-3 * want.max()


@pytest.mark.parametrize("use_cfar", [True, False])
def test_statistics_parity(use_cfar):
    rng = np.random.default_rng(4)
    grid = rng.exponential(1.0, (5, 16, 500)).astype(np.float32)
    grid[1, 3, 77] = 60.0
    grid[3, 9, 499] = 45.0
    if use_cfar:
        want = jpcps._cfar_statistics(jnp.asarray(grid), 2)
    else:
        want = jpcps._second_peak_statistics(jnp.asarray(grid), 2)
    g = torch.from_numpy(grid)
    _, rm, ra = acq.acq_accum_plain(torch.view_as_complex(torch.stack(
        [torch.sqrt(g), torch.zeros_like(g)], -1)), None, 0, 500)
    got = acq.acq_stats(g, rm, ra, 2, 2, use_cfar)
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)


def test_accum_adds_dwells():
    rng = np.random.default_rng(8)
    c1, c2 = (torch.from_numpy((rng.standard_normal((3, 4, 64))
                                + 1j * rng.standard_normal((3, 4, 64)))
                               .astype(np.complex64)) for _ in range(2))
    g1, _, _ = acq.acq_accum(c1, None, 32, 32)
    g2, rm, ra = acq.acq_accum(c2, g1, 32, 32)
    want = c1[..., 32:].abs() ** 2 + c2[..., 32:].abs() ** 2
    torch.testing.assert_close(g2, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rm, want.max(-1).values)
    assert torch.equal(ra.long(), want.argmax(-1))


@pytest.mark.parametrize("prn,delay,doppler", [(5, 1250, 2350.0),
                                               (19, 40, -3700.0)])
def test_search_parity(engines, prn, delay, doppler):
    je, te = engines
    x = synth(prn, delay, doppler, 4, seed=prn)
    rj, rt = je.search(x, samplestamp=1000), te.search(x, samplestamp=1000)
    assert sorted(rj) == sorted(rt)
    for p in rj:
        assert rj[p].positive == rt[p].positive, p
        if rj[p].positive:
            assert rj[p].delay_samples == rt[p].delay_samples
            assert rj[p].doppler_hz == rt[p].doppler_hz
            assert rt[p].samplestamp_samples == 1000
    assert rt[prn].positive
    assert abs(rt[prn].doppler_hz - doppler) <= 250


def test_two_step_refinement_parity():
    kw = dict(doppler_max=5000, doppler_step=500, pfa=0.001, max_dwells=1,
              make_2_steps=True, doppler_step2=125.0, pfa2=0.001,
              repeat_steps=True)
    je, te = jmake([7], FS, **kw), tmake([7], FS, device="cpu", **kw)
    x = synth(7, 333, 1130.0, 2, cn0_db=48.0, seed=7)
    rj, rt = je.search(x)[7], te.search(x)[7]
    assert rj.positive and rt.positive
    assert rj.doppler_hz == rt.doppler_hz
    assert rj.doppler_step == rt.doppler_step == 125.0
    assert rj.delay_samples == rt.delay_samples
