"""The port's signal conditioner, antenna-array beamformer, live and
LabSat sources, and the K3 long window, held against the JAX package on
the CPU.

The same seeded numpy inputs go through each JAX function and its port
counterpart. Tolerance: 2e-4 of the output rms (``tests/test_conditioner.
py:152``): float32 sums taken in another order (``jnp.convolve`` against
the port's tap-by-tap sum, the JAX matmul DFT against ``torch.fft``).
Where both sides do the same float32 arithmetic (the resampler gathers,
the stream against the one-shot result) the comparison is exact.
"""

import socket
import struct
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.conditioner import chain as jchain_mod
from gnss_sdr_tpu.conditioner import fir as jfir
from gnss_sdr_tpu.conditioner import interference as jint
from gnss_sdr_tpu.conditioner import resampler as jres
from gnss_sdr_tpu.ops.cplx import from_complex, to_complex
from gnss_sdr_tpu_torch import convert
from gnss_sdr_tpu_torch.conditioner import chain as tchain_mod
from gnss_sdr_tpu_torch.conditioner import fir as tfir
from gnss_sdr_tpu_torch.conditioner import interference as tint
from gnss_sdr_tpu_torch.conditioner import resampler as tres
from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import conditioner as k7

torch.set_num_threads(2)
TOL = 2e-4


def _cx(rng, n, scale=1.0):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def _close_rms(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    rms = float(np.sqrt(np.mean(np.abs(want) ** 2)))
    err = float(np.max(np.abs(got.astype(np.complex128) - want)))
    assert err <= tol * rms, (err, rms)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _interfered(rng, n, fs):
    """Noise, a 0.5 MHz carrier, two strong pulses and a strong CW tone
    on a bin of a 4000-point block: every filter has work to do."""
    t = np.arange(n)
    x = _cx(rng, n) + 0.3 * np.exp(2j * np.pi * 0.5e6 / fs * t)
    x[100:130] += 60.0
    x[n // 2:n // 2 + 20] -= 80.0j
    x = x + 25.0 * np.exp(2j * np.pi * 0.12 * t)
    return x.astype(np.complex64)


# ---- fir.py ----------------------------------------------------------------

def test_design_lowpass_taps_identical():
    np.testing.assert_array_equal(
        tfir.design_lowpass_taps(4e6, 1.2e6, 0.4e6, 97),
        jfir.design_lowpass_taps(4e6, 1.2e6, 0.4e6, 97))


@pytest.mark.parametrize("decimation", [1, 2, 4])
def test_fir_filter_parity(decimation):
    rng = np.random.default_rng(decimation)
    x = _cx(rng, 3001)
    taps = jfir.design_lowpass_taps(4e6, 1.2e6, 0.4e6, 33)
    want = to_complex(jfir.fir_filter(from_complex(x), taps, decimation))
    got = tfir.fir_filter(_t(x), taps, decimation).numpy()
    _close_rms(got, want)


def test_freq_xlating_fir_filter_parity():
    """1024 samples: the JAX function's float32 phase index is still
    within 3e-5 rad of the port's float64 one there."""
    rng = np.random.default_rng(7)
    fs, f0 = 4e6, 0.5e6
    n = np.arange(1024)
    x = (_cx(rng, 1024, 0.3)
         + np.exp(2j * np.pi * (f0 + 1e4) / fs * n)).astype(np.complex64)
    taps = jfir.design_lowpass_taps(fs, 1.0e6, 0.4e6, 33)
    want = to_complex(jfir.freq_xlating_fir_filter(from_complex(x), taps, f0,
                                                   fs, decimation=2))
    got = tfir.freq_xlating_fir_filter(_t(x), taps, f0, fs, decimation=2)
    _close_rms(got.numpy(), want)


# ---- interference.py -------------------------------------------------------

def test_pulse_blanking_parity():
    rng = np.random.default_rng(0)
    x = _cx(rng, 4096)
    x[100:110] += 100.0
    want = to_complex(jint.pulse_blanking(from_complex(x), 5.0))
    got = tint.pulse_blanking(_t(x), 5.0).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    _close_rms(got, want, tol=0.0)
    assert np.all(got[100:110] == 0)


@pytest.mark.parametrize("n", [4000, 3999], ids=["even", "odd"])
def test_notch_filter_block_parity(n):
    rng = np.random.default_rng(1)
    t = np.arange(n)
    x = (_cx(rng, n) + 30.0 * np.exp(2j * np.pi * 0.12 * t)) \
        .astype(np.complex64)
    want = to_complex(jint.notch_filter_block(from_complex(x), 8.0))
    got = tint.notch_filter_block(_t(x), 8.0).numpy()
    _close_rms(got, want)
    assert np.mean(np.abs(got) ** 2) < 0.02 * np.mean(np.abs(x) ** 2)


def test_notch_median_is_the_midpoint():
    """jnp.median's midpoint of the two middle values, not
    torch.median's lower one: the threshold moves with it."""
    mag = np.array([1.0, 2.0, 3.0, 10.0], np.float32)
    spec = _t(mag.astype(np.complex64))
    # median 2.5 -> threshold 4 * 2.5 = 10 keeps the 10; the lower
    # median 2 would drop it
    out = k7.notch_mask_plain(spec, 4.0).numpy()
    np.testing.assert_array_equal(out, mag.astype(np.complex64))
    assert float(jnp.median(jnp.asarray(mag))) == 2.5


# ---- resampler.py ----------------------------------------------------------

@pytest.mark.parametrize("fs_in,fs_out", [(8e6, 4e6), (8e6, 6.4e6),
                                          (2.5e6, 2.048e6)])
def test_resampler_parity(fs_in, fs_out):
    """Ratios 2, 1.25 and 625/512 are exact in float32, so JAX's float32
    positions are exact over 5000 outputs and the two sides agree to the
    bit."""
    rng = np.random.default_rng(int(fs_out) % 97)
    x = _cx(rng, 6001)
    want = to_complex(jres.mmse_resample(from_complex(x), fs_in, fs_out))
    got = tres.mmse_resample(_t(x), fs_in, fs_out).numpy()
    np.testing.assert_array_equal(got, want)
    idx = jres.direct_resample_indices(len(x), fs_in, fs_out)
    np.testing.assert_array_equal(
        tres.direct_resample_indices(len(x), fs_in, fs_out), idx)
    np.testing.assert_array_equal(
        tres.direct_resample(_t(x), fs_in, fs_out).numpy(), x[idx])


def test_mmse_position_fault_past_2_24():
    """JAX builds the Mmse_Resampler's positions as float32 k * ratio:
    k = 2^24 + 1 is not a float32, so output k lands on 2^25, the sample
    of output k - 1, and sample 2^25 + 2 is never used. The port's
    positions are exact."""
    k = 2 ** 24 + 1
    jpos = jnp.asarray([k], jnp.int32).astype(jnp.float32) \
        * jnp.float32(8e6 / 4e6)
    assert int(jnp.floor(jpos)[0]) == 2 ** 25           # the JAX defect
    ks = torch.tensor([k - 1, k, k + 1], dtype=torch.int64)
    i0, frac = k7.mmse_positions(ks, 8e6, 4e6)
    assert i0.tolist() == [2 ** 25, 2 ** 25 + 2, 2 ** 25 + 4]
    assert frac.tolist() == [0.0, 0.0, 0.0]
    i0, frac = k7.mmse_positions(ks, 8e6, 6.4e6)          # ratio 1.25
    assert i0.tolist() == [5 * (k - 1 + j) // 4 for j in range(3)]
    np.testing.assert_array_equal(
        frac.numpy(), [((5 * (k - 1 + j)) % 4) / 4 for j in range(3)])


# ---- chain.py --------------------------------------------------------------

FILTERS = sorted(tchain_mod.SUPPORTED_INPUT_FILTERS)
RESAMPLERS = sorted(tchain_mod.SUPPORTED_RESAMPLERS)


def _chain_kwargs(input_filter, resampler):
    fs_in = 8e6
    fs_mid = fs_in / 2 if "Fir" in input_filter else fs_in
    return dict(fs_in=fs_in, input_filter=input_filter, if_freq_hz=1.5e6,
                decimation=2, ntaps=33, resampler=resampler,
                resample_fs_out=fs_mid / 1.25, pb_threshold_sigma=4.0)


@pytest.mark.parametrize("resampler", RESAMPLERS)
@pytest.mark.parametrize("input_filter", FILTERS)
def test_chain_apply_parity(input_filter, resampler):
    x = _interfered(np.random.default_rng(11), 8000, 8e6)
    kw = _chain_kwargs(input_filter, resampler)
    jc = jchain_mod.SignalConditionerChain(**kw)
    tc = tchain_mod.SignalConditionerChain(**kw, device="cpu")
    assert (tc.fs_mid, tc.fs_out) == (jc.fs_mid, jc.fs_out)
    want = jc.apply(x)
    got = tc.apply(x)
    assert got.dtype == np.complex64
    _close_rms(got, want)
    assert set(tc.timings) == {"h2d_s", "device_s", "d2h_s"}


CHUNKS = [(0, 7_001), (7_001, 20_000), (20_000, 40_000)]


def _stream_chain(mod, input_filter="Freq_Xlating_Fir_Filter", **extra):
    return mod.SignalConditionerChain(
        fs_in=4.0e6, input_filter=input_filter, if_freq_hz=1.0e6,
        decimation=2, ntaps=33, **extra)


@pytest.mark.parametrize("input_filter", ["Freq_Xlating_Fir_Filter",
                                          "Fir_Filter",
                                          "Pulse_Blanking_Filter"])
def test_chain_stream_parity(input_filter):
    """The chunking of tests/test_conditioner.py:148-149: the port's
    stream matches JAX's stream, and (for the FIR chains, whose history
    is carried) the port's own one-shot result to the bit."""
    x = _interfered(np.random.default_rng(3), 40_000, 4e6)
    jc = _stream_chain(jchain_mod, input_filter)
    tc = _stream_chain(tchain_mod, input_filter, device="cpu")
    want = np.concatenate([jc.apply_stream(x[a:b]) for a, b in CHUNKS])
    got = np.concatenate([tc.apply_stream(x[a:b]) for a, b in CHUNKS])
    _close_rms(got, want)
    if "Fir" in input_filter:
        one = _stream_chain(tchain_mod, input_filter, device="cpu").apply(x)
        np.testing.assert_array_equal(got, one[:len(got)])
        assert len(one) - len(got) <= 16


def test_chain_stream_refuses_resamplers():
    tc = tchain_mod.SignalConditionerChain(
        fs_in=8e6, input_filter="Pulse_Blanking_Filter",
        resampler="Mmse_Resampler", resample_fs_out=4e6, device="cpu")
    with pytest.raises(NotImplementedError, match="resamplers"):
        tc.apply_stream(np.zeros(100, np.complex64))


def test_stream_resumed_through_convert():
    """A JAX chain streams two chunks; its state goes into a port chain,
    which streams the third as the JAX chain does."""
    x = _interfered(np.random.default_rng(5), 40_000, 4e6)
    jc = _stream_chain(jchain_mod)
    for a, b in CHUNKS[:2]:
        jc.apply_stream(x[a:b])
    tc = _stream_chain(tchain_mod, device="cpu")
    convert.conditioner_state(tc, jc.taps, jc._tail, jc._base, jc._next_k,
                              jc._n_in)
    a, b = CHUNKS[2]
    got = tc.apply_stream(x[a:b])
    want = jc.apply_stream(x[a:b])
    _close_rms(got, want)
    assert (tc._base, tc._next_k, tc._n_in) == (jc._base, jc._next_k,
                                                jc._n_in)


# ---- factory ---------------------------------------------------------------

def _cond_config(**props):
    from gnss_sdr_tpu_torch.config import InMemoryConfiguration

    config = InMemoryConfiguration()
    config.set_property("SignalConditioner.implementation",
                        "Signal_Conditioner")
    for k, v in props.items():
        config.set_property(k.replace("__", "."), v)
    return config


def test_factory_conditioner_rejections():
    """tests/test_conditioner.py:158-175 and the other unknown names."""
    from gnss_sdr_tpu_torch.receiver.factory import make_signal_conditioner

    bad = [dict(InputFilter__implementation="Warp_Filter"),
           dict(Resampler__implementation="Warp_Resampler"),
           dict(DataTypeAdapter__implementation="Warp_Adapter"),
           dict(InputFilter__implementation="Freq_Xlating_Fir_Filter",
                SignalSource__sampling_frequency="5000000",
                InputFilter__decimation_factor="2",
                GNSS_SDR__internal_fs_sps="2000000")]
    for props in bad:
        props = {k.replace("GNSS_SDR", "GNSS-SDR"): v
                 for k, v in props.items()}
        with pytest.raises(ValueError, match="not available|internal_fs_sps"):
            make_signal_conditioner(_cond_config(**props), device="cpu")
    c = _cond_config()
    c.set_property("SignalConditioner.implementation", "Warp_Conditioner")
    with pytest.raises(ValueError, match="not available"):
        make_signal_conditioner(c, device="cpu")


def test_factory_builds_the_jax_chain():
    from gnss_sdr_tpu.config import InMemoryConfiguration as JConfig
    from gnss_sdr_tpu.receiver.factory import \
        make_signal_conditioner as jmake
    from gnss_sdr_tpu_torch.receiver.factory import (make_signal_conditioner,
                                                     make_signal_source)

    props = {"SignalSource.implementation": "Fifo_Signal_Source",
             "SignalSource.sampling_frequency": "8000000",
             "InputFilter.implementation": "Freq_Xlating_Fir_Filter",
             "InputFilter.IF": "1500000",
             "InputFilter.decimation_factor": "2",
             "InputFilter.number_of_taps": "65",
             "GNSS-SDR.internal_fs_sps": "4000000"}
    tc_conf = _cond_config()
    jc_conf = JConfig()
    for k, v in dict(props, **{"SignalConditioner.implementation":
                               "Signal_Conditioner"}).items():
        tc_conf.set_property(k, v)
        jc_conf.set_property(k, v)
    tc = make_signal_conditioner(tc_conf, device="cpu")
    jc = jmake(jc_conf)
    for name in ("fs_in", "fs_mid", "fs_out", "if_freq_hz", "decimation",
                 "input_filter", "resampler", "pb_threshold_sigma"):
        assert getattr(tc, name) == getattr(jc, name), name
    np.testing.assert_array_equal(tc.taps, jc.taps)
    assert tc.device == torch.device("cpu")
    # the source runs at the raw front-end rate when a conditioner is set
    assert make_signal_source(tc_conf).fs == 8e6
    tc_conf.set_property("SignalConditioner.implementation", "Pass_Through")
    assert make_signal_conditioner(tc_conf, device="cpu") is None
    assert make_signal_source(tc_conf).fs == 4e6


# ---- K3 long window --------------------------------------------------------

def test_k3_long_window_parity():
    """Windows of 2.6 code periods: both segmented-sum forms sum the chips
    -n_extra .. code_len + n_extra - 1 only and drop the rest alike (the
    card's K3 kernel does the same since it takes n_extra)."""
    from gnss_sdr_tpu.ops.correlator import multicorrelate as jmc
    from gnss_sdr_tpu_torch.kernels.multicorr import multicorr_plain
    from gnss_sdr_tpu_torch.ops.correlator import n_extra_bins

    rng = np.random.default_rng(21)
    c, width, fs = 3, 6500, 2.5e6
    ring = rng.integers(-60, 60, size=(2, 20000)).astype(np.int8)
    start = np.array([0, 3000, 9000], np.int32)
    base = 1000
    code = np.sign(rng.standard_normal((c, 1023))).astype(np.float32)
    shifts = np.array([-0.5, 0.0, 0.5], np.float32)
    rem = np.array([0.1, 0.3, 0.0], np.float32)
    step = np.full(c, 1.023e6 / fs, np.float32)
    rem_carr = rng.uniform(0, 6.28, c).astype(np.float32)
    carr_step = rng.uniform(-0.01, 0.01, c).astype(np.float32)
    length = np.array([6500, 6000, 6321], np.int32)
    idx = base + start[:, None] + np.arange(width)
    xr = ring[0][idx].astype(np.float32)
    xi = ring[1][idx].astype(np.float32)
    want = jmc(jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(code), shifts,
               jnp.asarray(rem), jnp.asarray(step), jnp.asarray(rem_carr),
               jnp.asarray(carr_step), jnp.asarray(length))
    src = _t(ring)
    got = multicorr_plain(src[0], src[1], base, _t(start), _t(length),
                          _t(code), _t(shifts), _t(rem), _t(step),
                          _t(rem_carr), _t(carr_step), width,
                          n_extra_bins(shifts.tolist()))
    scale = float(np.max(np.abs(np.asarray(want[0]))))
    for w, g in zip(want, got):
        assert np.max(np.abs(np.asarray(w) - g.numpy())) <= 1e-4 * scale


# ---- beamformer.py (tests/test_conditioner.py::test_beamformer_gain_and_null)

def _array_scene(m_ant, n, seed):
    """A unit-power signal from 10 degrees and a 20 dB noise jammer from
    55 degrees on a half-wavelength ULA of ``m_ant`` antennas."""
    from gnss_sdr_tpu.conditioner.beamformer import array_response

    rng = np.random.default_rng(seed)
    sig = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)
    jam = 10 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    x = array_response(m_ant, 0.5, 10.0)[:, None] * sig[None, :] \
        + array_response(m_ant, 0.5, 55.0)[:, None] * jam[None, :]
    return sig, x


def test_beamformer_parity_gain_and_null():
    """The port's ``BeamformerFilter`` (K7e's plain version on the CPU)
    against the JAX filter on the same array scene: the steering and
    manifold vectors equal, the output within 1e-5 of its rms; on the
    port's own output the JAX test's unity gain in the look direction,
    the jammer held under 0.2 of one antenna's, a wrong channel count
    refused; no launch counted."""
    from gnss_sdr_tpu.conditioner import beamformer as jbf
    from gnss_sdr_tpu_torch.conditioner import beamformer as tbf

    for args in ((8, 0.5, 10.0), (4, 0.37, -33.0)):
        np.testing.assert_array_equal(tbf.steering_weights(*args),
                                      jbf.steering_weights(*args))
        np.testing.assert_array_equal(tbf.array_response(*args),
                                      jbf.array_response(*args))
    m_ant, n = 8, 4096
    sig, x = _array_scene(m_ant, n, 0)
    bf = tbf.BeamformerFilter.steered(m_ant, 0.5, 10.0, device="cpu")
    before = dict(LAUNCHES)
    y = bf.apply(x)
    assert dict(LAUNCHES) == before
    assert set(bf.timings) == {"h2d_s", "device_s", "d2h_s"}
    _close_rms(y, jbf.BeamformerFilter(jbf.steering_weights(
        m_ant, 0.5, 10.0)).apply(x), 1e-5)
    corr = np.vdot(sig, y) / np.vdot(sig, sig)
    assert abs(abs(corr) - 1.0) < 0.05
    jam_res = y - corr * sig
    jam_single = x[0] - tbf.array_response(m_ant, 0.5, 10.0)[0] * sig
    assert np.mean(np.abs(jam_res) ** 2) < 0.2 * np.mean(
        np.abs(jam_single) ** 2)
    with pytest.raises(ValueError, match="antenna channels"):
        bf.apply(x[:5])


# ---- the wrappers on the CPU -----------------------------------------------

def test_cpu_wrappers_run_the_plain_versions():
    rng = np.random.default_rng(2)
    x = _t(_interfered(rng, 4000, 4e6))
    taps = jfir.design_lowpass_taps(4e6, 1.2e6, 0.4e6, 33)
    before = dict(LAUNCHES)
    pairs = [
        (k7.fir_decim(x, taps, 2, -1.2, 77),
         k7.fir_decim_plain(x, taps, 2, -1.2, 77)),
        (k7.pulse_blank(x, 4.0), k7.pulse_blank_plain(x, 4.0)),
        (k7.notch_mask(x, 8.0), k7.notch_mask_plain(x, 8.0)),
        (k7.resample(x, 4e6, 3.2e6, k7.MMSE),
         k7.resample_plain(x, 4e6, 3.2e6, k7.MMSE)),
        (k7.resample(x, 4e6, 3.2e6, k7.DIRECT),
         k7.resample_plain(x, 4e6, 3.2e6, k7.DIRECT)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert dict(LAUNCHES) == before


def test_beamform_wrapper_runs_its_plain_version_on_the_cpu():
    """K7e's wrapper on CPU tensors is ``beamform_plain`` (JAX's einsums),
    counts no launch, and refuses a device it cannot run."""
    rng = np.random.default_rng(5)
    x_re, x_im = (_t(rng.standard_normal((6, 1000)).astype(np.float32))
                  for _ in range(2))
    w_re, w_im = (_t(rng.standard_normal(6).astype(np.float32))
                  for _ in range(2))
    before = dict(LAUNCHES)
    got = k7.beamform(x_re, x_im, w_re, w_im)
    want = k7.beamform_plain(x_re, x_im, w_re, w_im)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dict(LAUNCHES) == before
    meta = torch.empty((6, 1000), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k7.beamform(meta, meta, w_re, w_im)


# ---- sources/live.py (tests/test_live_sources.py) --------------------------

def test_fifo_source_blocking_reads(tmp_path):
    from gnss_sdr_tpu_torch.sources import FifoSignalSource

    path = tmp_path / "fifo.dat"
    path.write_bytes(b"")
    src = FifoSignalSource(path, sampling_frequency=1e6, item_type="ishort")
    data = np.arange(2000, dtype=np.int16)

    def writer():
        with open(path, "ab", buffering=0) as f:
            for k in range(0, len(data), 500):
                f.write(data[k: k + 500].tobytes())

    t = threading.Thread(target=writer)
    t.start()
    x = src.read_block(1000)
    t.join()
    assert x.dtype == np.complex64 and x.shape == (1000,)
    assert x[3] == np.complex64(6 + 7j)
    assert src.samples_delivered == 1000
    src.close()


def test_fifo_source_eof_raises(tmp_path):
    from gnss_sdr_tpu_torch.sources import FifoSignalSource

    path = tmp_path / "short.dat"
    path.write_bytes(np.arange(10, dtype=np.int16).tobytes())
    src = FifoSignalSource(path, 1e6, item_type="ishort")
    with pytest.raises(EOFError):
        src.read_block(100, max_retries=3)
    src.close()


@pytest.mark.parametrize("sample_type,iq_swap", [("cshort", False),
                                                 ("cbyte", True)])
def test_udp_source_roundtrip(sample_type, iq_swap):
    from gnss_sdr_tpu_torch.sources import UdpSignalSource

    src = UdpSignalSource(port=0, sampling_frequency=1e6,
                          sample_type=sample_type, iq_swap=iq_swap)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    dtype = np.int16 if sample_type == "cshort" else np.int8
    samples = np.arange(120, dtype=dtype)
    for k in range(0, 120, 40):
        tx.sendto(samples[k: k + 40].tobytes(), ("127.0.0.1", src.port))
    x = src.read_block(60, timeout=5.0)
    assert x.shape == (60,)
    want = (np.complex64(1 + 0j) if iq_swap else np.complex64(0 + 1j),
            np.complex64(119 + 118j) if iq_swap else np.complex64(118 + 119j))
    assert (x[0], x[59]) == want
    tx.close()
    src.close()


def test_file_timestamp_source(tmp_path):
    from gnss_sdr_tpu_torch.sources import FileTimestampSignalSource

    cap = tmp_path / "cap.dat"
    np.zeros(4000, dtype=np.int16).tofile(cap)
    ts = tmp_path / "cap.timestamp"
    with open(ts, "wb") as f:
        f.write(struct.pack("<QiI", 0, 2100, 345_600_000))
        f.write(struct.pack("<QiI", 1000, 2100, 345_601_000))
        f.write(struct.pack("<QiI", 1500, 2100, 604_799_900))
    src = FileTimestampSignalSource(
        cap, ts, sampling_frequency=1000.0, item_type="ishort",
        timestamp_clock_offset_ms=5.0)
    assert len(src.timetags) == 3
    t0 = src.timetag_for_sample(0)
    assert t0.week == 2100 and t0.tow_ms == pytest.approx(345_600_005.0)
    assert src.timetag_for_sample(500).tow_ms == pytest.approx(345_600_505.0)
    assert src.timetag_for_sample(1200).tow_ms == pytest.approx(345_601_205.0)
    # +200 ms past the last tag crosses the week edge
    t = src.timetag_for_sample(1700)
    assert t.week == 2101 and t.tow_ms == pytest.approx(105.0)


def test_factory_builds_live_sources(tmp_path):
    from gnss_sdr_tpu_torch.config import InMemoryConfiguration
    from gnss_sdr_tpu_torch.receiver.factory import make_signal_source
    from gnss_sdr_tpu_torch.sources import (FifoSignalSource,
                                            FileTimestampSignalSource,
                                            UdpSignalSource)

    conf = InMemoryConfiguration()
    conf.set_property("GNSS-SDR.internal_fs_sps", "4000000")
    conf.set_property("SignalSource.implementation",
                      "Custom_UDP_Signal_Source")
    conf.set_property("SignalSource.port", "0")
    conf.set_property("SignalSource.sample_type", "cshort")
    src = make_signal_source(conf)
    assert isinstance(src, UdpSignalSource) and src.fs == 4e6
    src.close()
    fifo = tmp_path / "p.dat"
    fifo.write_bytes(b"")
    conf.set_property("SignalSource.implementation", "Fifo_Signal_Source")
    conf.set_property("SignalSource.filename", str(fifo))
    src = make_signal_source(conf)
    assert isinstance(src, FifoSignalSource)
    src.close()
    np.zeros(400, dtype=np.int16).tofile(fifo)
    ts = tmp_path / "p.timestamp"
    ts.write_bytes(struct.pack("<QiI", 0, 2100, 1000))
    conf.set_property("SignalSource.implementation",
                      "File_Timestamp_Signal_Source")
    conf.set_property("SignalSource.item_type", "ishort")
    conf.set_property("SignalSource.timestamp_filename", str(ts))
    src = make_signal_source(conf)
    assert isinstance(src, FileTimestampSignalSource)
    assert src.n_samples == 200


# ---- sources/labsat.py (tests/test_labsat.py) ------------------------------

@pytest.mark.parametrize("bits", [2, 4])
def test_labsat_payload_and_container_match_jax(tmp_path, bits):
    from gnss_sdr_tpu.sources import labsat as jlab
    from gnss_sdr_tpu_torch.sources import labsat as tlab

    rng = np.random.default_rng(3)
    words = rng.integers(-32768, 32768, 64, dtype=np.int64).astype(np.int16)
    np.testing.assert_array_equal(tlab.decode_labsat_payload(words, bits),
                                  jlab.decode_labsat_payload(words, bits))
    n = 4096
    x = (rng.choice([-2.0, -1.0, 1.0, 2.0], n)
         + 1j * rng.choice([-2.0, -1.0, 1.0, 2.0], n))
    path = tmp_path / "cap.ls3"
    tlab.write_labsat_file(str(path), x, bits_per_sample=bits)
    jpath = tmp_path / "jcap.ls3"
    jlab.write_labsat_file(str(jpath), x, bits_per_sample=bits)
    assert path.read_bytes() == jpath.read_bytes()
    src = tlab.LabsatSignalSource(str(path), sampling_frequency=16.368e6)
    assert src.header == tlab.parse_labsat_header(jpath.read_bytes()[:64])
    assert src.n_samples == n
    got = src.read(0, n)
    np.testing.assert_array_equal(got, jlab.LabsatSignalSource(
        str(jpath)).read(0, n))
    np.testing.assert_array_equal(src.read(13, 100), got[13:113])


def test_labsat_header_rejections(tmp_path):
    from gnss_sdr_tpu_torch.sources.labsat import (LabsatSignalSource,
                                                   parse_labsat_header,
                                                   write_labsat_file)

    with pytest.raises(ValueError, match="preamble"):
        parse_labsat_header(b"\x01" * 64)
    rng = np.random.default_rng(0)
    x = rng.choice([-1.0, 1.0], 64) + 1j * rng.choice([-1.0, 1.0], 64)
    p = tmp_path / "dual.ls3"
    write_labsat_file(str(p), x, channel_selector=0)
    with pytest.raises(ValueError, match="dual-channel"):
        LabsatSignalSource(str(p))


def test_factory_accepts_labsat(tmp_path):
    from gnss_sdr_tpu_torch.config import InMemoryConfiguration
    from gnss_sdr_tpu_torch.receiver.factory import make_signal_source
    from gnss_sdr_tpu_torch.sources import LabsatSignalSource
    from gnss_sdr_tpu_torch.sources.labsat import write_labsat_file

    rng = np.random.default_rng(1)
    x = rng.choice([-1.0, 1.0], 256) + 1j * rng.choice([-1.0, 1.0], 256)
    path = tmp_path / "cap.ls3"
    write_labsat_file(str(path), x)
    config = InMemoryConfiguration()
    config.set_property("SignalSource.implementation",
                        "Labsat_Signal_Source")
    config.set_property("SignalSource.filename", str(path))
    config.set_property("GNSS-SDR.internal_fs_sps", "16368000")
    src = make_signal_source(config)
    assert isinstance(src, LabsatSignalSource)
    assert src.n_samples == 256
