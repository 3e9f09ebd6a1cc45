"""The port's multi-band receiver (GPS L1 C/A + Galileo E1) held against
the JAX package on the CPU, from the same numpy-seeded inputs.

- E1 codes, sampled replicas and the acquisition registry: identical.
- I/NAV decoding of an encoded page stream with noise and an inverted
  carrier: the same words, fields and TOW at every symbol.
- E1 PCPS search on 2 PRNs: the same peaks (delay, Doppler, verdict),
  statistics within 1e-4 relative.
- The scan engine tracking the E1-C pilot with the E1-B data prompt, one
  block from the same ``start_channel`` state: period starts identical,
  pilot and data prompts and every state field within 1e-4 of their scale
  (float32 sums of 16000 samples a period in two orders: the L1 test's
  1e-5 holds at 2500).
- The fast engine from the same state, at K = 25 with the CS25 wipe-off
  set by ``set_secondary`` and the data bank, and at K = 1 (E1-B, VEML):
  period starts identical, rems within 0.02 samples, prompts within 2%,
  Doppler within 1 Hz, C/N0 within 1 dB (the JAX suite's tolerances).
- ``convert`` round trips of the states and the data-tap bank.
- The factory: 1C + 1B routes to the multi-band receivers; every other
  group and PVT-block option raises naming its ROADMAP step.
- The slice: a 4.9 s 1C + 1B scene through both packages' factories from
  one INI: the same handoff sample and fixes within 1 m at the common
  epochs (one test function, so that xdist builds it once, and first in
  the module, so that a parallel run starts it early); and the CLI over
  its first 1.2 s.
"""

import os
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.codes.galileo_e1 import galileo_e1_sampled as j_sampled
from gnss_sdr_tpu.codes.galileo_e1 import galileo_e1_subchips as j_subchips
from gnss_sdr_tpu.tracking import TrackingConfig as JConfig
from gnss_sdr_tpu.tracking.channels import TrackingChannels as JChannels
from gnss_sdr_tpu.tracking.fast_engine import FastTrackingEngine as JFast
from gnss_sdr_tpu_torch import convert
from gnss_sdr_tpu_torch.codes.galileo_e1 import (E1C_SECONDARY,
                                                 galileo_e1_sampled,
                                                 galileo_e1_subchips)
from gnss_sdr_tpu_torch.kernels.bank_corr import unpack_bank
from gnss_sdr_tpu_torch.tracking.channels import TrackingChannels
from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig
from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

torch.set_num_threads(2)
FS = 4e6
BLOCK = int(FS * 0.02)
#: the E1 band's tracking configuration (receiver/bands.py), a short
#: pull-in for the tests
E1_KW = dict(fs=FS, code_length_chips=4092, chip_rate_cps=1.023e6,
             code_samples_per_chip=12, veml=True, symbols_per_bit=1,
             pll_bw_hz=20.0, enable_fll_pull_in=True, pull_in_time_s=0.1,
             early_late_space_chips=0.15, very_early_late_space_chips=0.6)
#: (PRN, code delay [samples], Doppler [Hz]) of the synthetic E1 signal
SATS = [(11, 3000.3, 1210.0), (19, 9000.7, -2480.0)]


def e1_signal(sats, n, seed, cn0_db_hz=48.0):
    """Composite E1 signals ((E1-B x symbols - E1-C x CS25) / sqrt 2) at
    fixed code delays and Doppler, plus noise, from a numpy seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    x = np.zeros(n, np.complex128)
    cs = np.array([1.0 if c == "0" else -1.0 for c in E1C_SECONDARY])
    for prn, delay, dopp in sats:
        sub = np.floor((t - delay) * 1.023e6 * 12 / FS).astype(np.int64)
        per = sub // 49104
        sym = np.sign(rng.standard_normal(per.max() - per.min() + 1))
        e = (galileo_e1_subchips(prn, "B", True)[sub % 49104]
             * sym[per - per.min()]
             - galileo_e1_subchips(prn, "C", True)[sub % 49104]
             * cs[per % 25]) / np.sqrt(2.0)
        x += e * np.exp(2j * np.pi * dopp * t / FS)
    sigma = np.sqrt(FS / (2.0 * 10.0 ** (cn0_db_hz / 10.0)))
    x += sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


@pytest.fixture(scope="module")
def signal():
    return e1_signal(SATS, int(FS * 0.52), 5)


# ---- the slice ------------------------------------------------------------

GPS_BITS = 7200.0 + 598 * 6.0
#: 0.1 s before a GPS subframe (the channel bit-syncs and the receiver
#: hands off 0.8 s in) and 2.1 s before an I/NAV page pair that carries
#: word 5 (GST): the page starts after the handoff has settled (a pilot
#: whose Costas loop sat at 180 degrees is pulled through by the
#: four-quadrant PLL, losing the page in flight, ROADMAP §3), so every E1
#: channel knows its TOW 4.2 s in. 4.92 s make phase B 40 fast blocks, 4
#: superblocks of 10 in each band.
T_START = GPS_BITS + 5.9
GAL_BITS = 7200.0 + 359 * 10.0 + 2.0
DURATION = 4.92


def _geometry():
    from gnss_sdr_tpu_torch.simulate.scenario import (make_constellation,
                                                      rx_position,
                                                      visible_sats)

    rx = rx_position()
    gps = make_constellation(range(1, 13), toe_s=7200.0)
    gal = make_constellation(range(1, 13), toe_s=7200.0, spread_seed=7)
    return dict(gps=gps, gal=gal, rx=rx,
                gps_prns=[int(p) for p in visible_sats(gps, rx, T_START)[:1]],
                gal_prns=[int(p) for p in visible_sats(gal, rx, T_START)[:4]])


def _scene(geo, duration):
    """The first ``duration`` seconds of the slice's scene: 1 GPS
    satellite (48 dB-Hz) and 4 Galileo E1 satellites (pilot and data, 51
    dB-Hz as in the JAX E1 pilot test) at 4 Msps. One second at a time,
    which keeps the generators' float64 work arrays to ~1 GB; the signals
    without noise and without the generators' front-end filter, which is
    applied once to their sum (firwin(65, 0.9), as both generators apply
    it), then white noise from a numpy seed."""
    from scipy import signal as sp_signal

    from gnss_sdr_tpu_torch.simulate.rf_scene import (generate_galileo_scene,
                                                      generate_scene)

    taps = sp_signal.firwin(65, 0.9)
    sigma = np.sqrt(FS / (2.0 * 10.0 ** (48.0 / 10.0)))
    parts = []
    for i in range(int(np.ceil(duration))):
        t0, dur = T_START + i, min(1.0, duration - i)
        part = generate_scene(geo["gps"], geo["gps_prns"], geo["rx"], t0,
                              dur, FS, bits_start_tow_s=GPS_BITS,
                              n_subframes=4, cn0_db_hz=300.0,
                              bandlimit=False) \
            + generate_galileo_scene(geo["gal"], geo["gal_prns"], geo["rx"],
                                     t0, dur, FS, bits_start_tow_s=GAL_BITS,
                                     noise=False, bandlimit=False,
                                     pilot=True) \
            * np.float32(10.0 ** (3.0 / 20.0))
        part = sp_signal.fftconvolve(part, taps, mode="same")
        rng = np.random.default_rng(91 + i)
        part += sigma * (rng.standard_normal(part.size)
                         + 1j * rng.standard_normal(part.size))
        parts.append(part.astype(np.complex64))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def mb_scene(tmp_path_factory):
    """The slice's scene, generated once per test run: under xdist the
    file is shared by the workers through the run's common temporary
    root."""
    geo = _geometry()
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / "torch_l1e1_scene.npy"
    try:
        os.close(os.open(path.with_suffix(".lock"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        deadline = time.monotonic() + 300.0
        while not path.exists() and time.monotonic() < deadline:
            time.sleep(0.5)
        return np.load(path), geo
    x = _scene(geo, DURATION)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.npy")
    np.save(tmp, x)
    os.replace(tmp, path)
    return x, geo


def _ini(tmp_path, geo, capture="unused.dat"):
    from gnss_sdr_tpu_torch.receiver.assistance import save_ephemeris_xml

    xml = save_ephemeris_xml({p: geo["gps"][p] for p in geo["gps_prns"]},
                             tmp_path / "gps_ephemeris.xml")
    conf = tmp_path / "rx.conf"
    conf.write_text(textwrap.dedent(f"""
        GNSS-SDR.internal_fs_sps=4000000
        SignalSource.implementation=File_Signal_Source
        SignalSource.filename={capture}
        SignalSource.item_type=gr_complex
        Channels_1C.count={len(geo["gps_prns"])}
        Channels_1C.satellites={",".join(map(str, geo["gps_prns"]))}
        Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
        Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
        Tracking_1C.pull_in_time_s=0.4
        TelemetryDecoder_1C.implementation=GPS_L1_CA_Telemetry_Decoder
        Channels_1B.count={len(geo["gal_prns"])}
        Channels_1B.satellites={",".join(map(str, geo["gal_prns"]))}
        Acquisition_1B.implementation=Galileo_E1_PCPS_Ambiguous_Acquisition
        Tracking_1B.implementation=Galileo_E1_DLL_PLL_VEML_Tracking
        Tracking_1B.track_pilot=true
        Tracking_1B.pll_bw_hz=20
        Tracking_1B.pull_in_time_s=0.4
        TelemetryDecoder_1B.implementation=Galileo_E1B_Telemetry_Decoder
        Observables.implementation=Hybrid_Observables
        PVT.implementation=RTKLIB_PVT
        GNSS-SDR.AGNSS_gps_ephemeris_xml={xml}
        """))
    return conf


def test_multiband_slice_matches_jax(mb_scene, tmp_path):
    """Both packages' ``make_receiver`` on one INI (1C + 1B pilot), the
    Galileo ephemerides seeded: the port hands off to K = 25 with every E1
    channel secondary-locked, at the JAX receiver's handoff sample, and
    its fixes lie within 1 m of the JAX fixes at the common epochs."""
    from gnss_sdr_tpu.config import FileConfiguration as JFile
    from gnss_sdr_tpu.receiver.factory import make_receiver as j_make
    from gnss_sdr_tpu_torch.config import FileConfiguration
    from gnss_sdr_tpu_torch.receiver.factory import make_receiver

    x, geo = mb_scene
    conf = _ini(tmp_path, geo)
    gal_eph = {("E", p): geo["gal"][p] for p in geo["gal_prns"]}
    recs = []
    for make, cfg, kw in ((make_receiver, FileConfiguration, {"device":
                                                              "cpu"}),
                          (j_make, JFile, {})):
        rec = make(cfg(str(conf)), **kw)
        rec.ephemerides.update(gal_eph)
        rec.run(x)
        recs.append(rec)
    port, jrec = recs
    assert port.in_fast_mode and jrec.in_fast_mode
    assert port.handoff_sample == jrec.handoff_sample < FS * 1.5
    ctx = port._ctx["1B"]
    assert ctx.k == 25 and bool(ctx.state.secondary_locked.all())
    fj = {round(s.rx_tow_s, 3): s.pos_ecef for s in jrec.solutions}
    ft = {round(s.rx_tow_s, 3): s.pos_ecef for s in port.solutions}
    common = sorted(set(fj) & set(ft))
    assert len(common) >= 5, (sorted(fj), sorted(ft))
    diffs = [float(np.linalg.norm(fj[t] - ft[t])) for t in common]
    assert max(diffs) < 1.0, diffs
    # real fixes: four E1 satellites right after their first TOW (the
    # chip run holds the accuracy bound on its 12 s scene)
    err = [float(np.linalg.norm(s.pos_ecef - geo["rx"]))
           for s in port.solutions]
    assert max(err) < 50.0, err


def test_cli_routes_a_two_group_ini_cpu(tmp_path, capsys):
    """``python -m gnss_sdr_tpu_torch -c rx.conf --device cpu`` on the
    first 1.2 s of the slice's scene (generated here: waiting for the
    slice's file on another worker would cost longer) builds the
    multi-band production receiver and runs it over the whole capture."""
    import gnss_sdr_tpu_torch.__main__ as cli
    from gnss_sdr_tpu_torch.receiver.fsm import ChannelState
    from gnss_sdr_tpu_torch.receiver.production_multiband import \
        ProductionMultiBandReceiver

    geo = _geometry()
    cap = tmp_path / "scene.dat"
    _scene(geo, 1.2).tofile(cap)
    conf = _ini(tmp_path, geo, cap)
    assert cli.main(["-c", str(conf), "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    rec = cli.last_receiver
    assert isinstance(rec, ProductionMultiBandReceiver)
    assert f"processed {int(1.2 * FS)} samples" in err
    assert "engine=production" in err
    states = rec.channel_states()
    assert sum(s is ChannelState.TRACKING for s in states) == len(states)


# ---- codes, telemetry, acquisition ----------------------------------------

def test_e1_codes_and_replicas_match_jax():
    """Exact equality of the sub-chip tables, sampled replicas, the CS25
    code, the acquisition replicas and the implementation registry."""
    from gnss_sdr_tpu.acquisition.adapters import (ACQ_IMPLEMENTATIONS,
                                                   signal_replicas)
    from gnss_sdr_tpu.codes.galileo_e1 import E1C_SECONDARY as J_CS25
    from gnss_sdr_tpu_torch.acquisition import adapters

    assert E1C_SECONDARY == J_CS25
    for prn in (1, 19, 36):
        for comp in "BC":
            for cboc in (True, False):
                np.testing.assert_array_equal(
                    galileo_e1_subchips(prn, comp, cboc),
                    j_subchips(prn, comp, cboc))
            np.testing.assert_array_equal(
                galileo_e1_sampled(prn, FS, comp, True),
                j_sampled(prn, FS, comp, True))
    for suffix, ms in (("1B", 8), ("1C", 2)):
        a = adapters.signal_replicas(suffix, [3, 5], FS, ms)
        b = signal_replicas(suffix, [3, 5], FS, ms)
        for prn in (3, 5):
            np.testing.assert_array_equal(a[prn], b[prn])
    assert adapters.ACQ_IMPLEMENTATIONS == ACQ_IMPLEMENTATIONS


def test_inav_decoder_matches_jax():
    """Both decoders over one encoded page stream (noise, inverted
    carrier): the same TOW after every symbol, the same words and
    fields, the same ephemeris."""
    from gnss_sdr_tpu.simulate.rf_scene import _inav_symbol_stream as j_stream
    from gnss_sdr_tpu.simulate.scenario import make_constellation
    from gnss_sdr_tpu.telemetry.galileo_inav import GalileoInavDecoder as JDec
    from gnss_sdr_tpu.telemetry.galileo_inav import \
        galileo_ephemeris_from_inav as j_eph
    from gnss_sdr_tpu_torch.simulate.rf_scene import _inav_symbol_stream
    from gnss_sdr_tpu_torch.telemetry.galileo_inav import (
        GalileoInavDecoder, galileo_ephemeris_from_inav)

    eph = make_constellation([4], toe_s=7200.0, spread_seed=7)[4]
    sym = _inav_symbol_stream(eph, 7200.0, 8)
    np.testing.assert_array_equal(sym, j_stream(eph, 7200.0, 8))
    rng = np.random.default_rng(17)
    soft = -(sym[37:] + 0.45 * rng.standard_normal(sym.size - 37))
    jd, td = JDec(), GalileoInavDecoder()
    for i, s in enumerate(soft):
        jd.feed(float(s), 1000 + 16000 * i)
        td.feed(float(s), 1000 + 16000 * i)
        assert jd.tow_at_last_symbol_ms == td.tow_at_last_symbol_ms, i
    assert td.tow_at_last_symbol_ms is not None and td.inverted
    assert jd.has_full_ephemeris() and td.has_full_ephemeris()
    assert jd.ephemeris_fields == td.ephemeris_fields
    a = galileo_ephemeris_from_inav(4, td.ephemeris_fields)
    b = j_eph(4, jd.ephemeris_fields)
    for t in (7000.0, 7300.0):
        np.testing.assert_array_equal(np.asarray(a.sat_pos(t)),
                                      np.asarray(b.sat_pos(t)))


def test_e1_pcps_search_matches_jax():
    """The E1 band's acquisition (4 ms CBOC replicas, 125 Hz bins, two
    dwells, two-step refinement) on 2 PRNs of a composite E1 signal."""
    from gnss_sdr_tpu.acquisition.adapters import \
        make_galileo_e1_acquisition as j_make
    from gnss_sdr_tpu_torch.acquisition.adapters import \
        make_galileo_e1_acquisition

    x = e1_signal([(11, 5210.0, 1130.0), (19, 1234.0, -2610.0)],
                  32000, 9, cn0_db_hz=50.0)
    kw = dict(doppler_max=5000.0, doppler_step=125.0, pfa=0.001,
              max_dwells=2)
    tr = make_galileo_e1_acquisition([11, 19], FS, device="cpu", **kw)
    jr = j_make([11, 19], FS, **kw)
    rt, rj = tr.search(x, samplestamp=0), jr.search(x, samplestamp=0)
    for prn in (11, 19):
        a, b = rt[prn], rj[prn]
        assert a.positive and b.positive
        assert (a.delay_samples, a.doppler_hz, a.doppler_step) \
            == (b.delay_samples, b.doppler_hz, b.doppler_step)
        assert abs(a.test_statistic - b.test_statistic) \
            <= 1e-4 * b.test_statistic
        assert abs(a.threshold - b.threshold) <= 1e-6 * b.threshold
    assert abs(rt[11].delay_samples - 5210.0) <= 1.0


# ---- tracking -------------------------------------------------------------

def _start(tc):
    for ch, (prn, delay, dopp) in enumerate(SATS):
        tc.start_channel(ch, prn, galileo_e1_subchips(prn, "C", True),
                         delay, dopp + 10.0, 0,
                         data_code_table=galileo_e1_subchips(prn, "B", True))


def test_scan_engine_pilot_one_block_parity(signal):
    """One block of the E1-C pilot with the E1-B data prompt (K3 twice
    per period): starts identical, prompts and state within 1e-4."""
    kw = dict(E1_KW, track_pilot=True)
    j = JChannels(JConfig(**kw), 2, BLOCK)
    t = TrackingChannels(TrackingConfig(**kw), 2, BLOCK, device="cpu")
    _start(j)
    _start(t)
    seg = signal[:BLOCK + j.overlap]
    oj, ot = j.process_block(seg), t.process_block(seg)
    for cj, ct in zip(oj, ot):
        assert len(cj) == len(ct) >= 4
        assert [p.sample_start for p in cj] == [p.sample_start for p in ct]
        for what in ("prompt", "data_prompt"):
            a = np.array([getattr(p, what) for p in cj])
            b = np.array([getattr(p, what) for p in ct])
            assert np.max(np.abs(a - b)) <= 1e-4 * np.max(np.abs(a)), what
        # the data prompt is the E1-B correlation, not the pilot's
        assert np.max(np.abs(np.array([p.data_prompt - p.prompt
                                       for p in ct]))) > 0
    jd, td = convert.field_dict(j.state), convert.state_numpy(t.state)
    assert set(jd) == set(td)
    for name, a in jd.items():
        b = td[name]
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            scale = float(np.max(np.abs(a))) or 1.0
            assert np.max(np.abs(a - b)) <= 1e-4 * scale, name


@pytest.mark.parametrize("mode", ["k25-pilot-cs25", "k1-veml"])
def test_fast_engine_e1_parity(signal, mode):
    pilot = mode.startswith("k25")
    k = 25 if pilot else 1
    kw = dict(E1_KW, extend_correlation_symbols=k, cn0_smoother_alpha=0.05,
              track_pilot=pilot, pll_bw_narrow_hz=2.0)
    g = 1 if pilot else 25
    sec = 25 if pilot else 1
    jf = JFast(JConfig(**kw), 2, g, sec_max_len=sec)
    tf = FastTrackingEngine(TrackingConfig(**kw), 2, g, sec_max_len=sec,
                            device="cpu")
    js = jf.init_state()
    for ch, (_, delay, dopp) in enumerate(SATS):
        off = int(np.ceil(delay))
        js = jf.start_channel(js, ch, dopp, off)
        js = js._replace(rem_code_phase_samples=js.rem_code_phase_samples
                         .at[ch].set(off - delay))
        if pilot:
            js = jf.set_secondary(js, ch, E1C_SECONDARY, 0)
    ts = convert.fast_state(js, "cpu")
    if pilot:
        # the port's set_secondary writes what the JAX one writes
        t2 = tf.set_secondary(convert.fast_state(jf.init_state(), "cpu"), 1,
                              E1C_SECONDARY, 27)
        j2 = jf.set_secondary(jf.init_state(), 1, E1C_SECONDARY, 27)
        for name in ("sec_signs", "sec_len", "sec_phase",
                     "secondary_locked"):
            np.testing.assert_array_equal(
                convert.state_numpy(t2)[name], np.asarray(getattr(j2, name)))
    comp = "C" if pilot else "B"
    pc = np.stack([galileo_e1_subchips(p, comp, True)
                   for p, _, _ in SATS]).astype(np.float32)
    dc = np.stack([galileo_e1_subchips(p, "B", True)
                   for p, _, _ in SATS]).astype(np.float32)
    jargs = [jnp.asarray(pc)] + ([jnp.asarray(dc)] if pilot else [])
    targs = [torch.from_numpy(pc), torch.from_numpy(dc) if pilot else None]
    n_blocks = (len(signal) - jf.overlap) // jf.block_samples
    assert n_blocks >= 3
    for b in range(n_blocks):
        lo = b * jf.block_samples
        seg = signal[lo:lo + jf.block_samples + jf.overlap]
        re = np.ascontiguousarray(seg.real, np.float32)
        im = np.ascontiguousarray(seg.imag, np.float32)
        js, oj = jf.process_block(js, jnp.asarray(re), jnp.asarray(im),
                                  *jargs)
        ts, ot = tf.process_block(ts, torch.from_numpy(re),
                                  torch.from_numpy(im), *targs)
        pj, pt = np.asarray(oj["packed"]), ot["packed"].numpy()
        assert pj.shape == pt.shape
        np.testing.assert_array_equal(pj[..., :k], pt[..., :k])
        assert np.max(np.abs(pj[..., k:2 * k] - pt[..., k:2 * k])) < 0.02
        # wiped pilot prompts, then the data prompts (re, im)
        for lo_, hi_ in ((2 * k, 3 * k), (3 * k, 5 * k)):
            a, c = pj[..., lo_:hi_], pt[..., lo_:hi_]
            assert np.max(np.abs(a - c)) <= 0.02 * np.max(np.abs(a))
        assert np.max(np.abs(pj[..., 5 * k] - pt[..., 5 * k])) < 1.0
        assert np.max(np.abs(pj[..., 5 * k + 1] - pt[..., 5 * k + 1])) < 1.0
        np.testing.assert_array_equal(pj[..., 5 * k + 2:], pt[..., 5 * k + 2:])
    np.testing.assert_array_equal(np.asarray(js.sec_phase),
                                  ts.sec_phase.numpy())
    for ch, (_, _, dopp) in enumerate(SATS):
        assert abs(float(ts.carrier_doppler_hz[ch]) - dopp) < 5.0


def test_convert_round_trips():
    """JAX states (secondary fields set) and the data-tap bank carry over
    into the port and back unchanged."""
    kw = dict(E1_KW, extend_correlation_symbols=25, track_pilot=True)
    jf = JFast(JConfig(**kw), 2, 1, sec_max_len=25)
    js = jf.set_secondary(jf.start_channel(jf.init_state(), 1, -1234.5,
                                           777), 1, E1C_SECONDARY, 7)
    ts = convert.fast_state(js, "cpu")
    back = convert.state_numpy(ts)
    for name, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, name)), name)
    j = JChannels(JConfig(**dict(E1_KW, track_pilot=True)), 2, BLOCK)
    _start(j)
    tt = convert.track_state(j.state, "cpu")
    for name, v in convert.state_numpy(tt).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(j.state, name)))
    pc = np.stack([galileo_e1_subchips(p, "C", True)
                   for p, _, _ in SATS]).astype(np.float32)
    dc = np.stack([galileo_e1_subchips(p, "B", True)
                   for p, _, _ in SATS]).astype(np.float32)
    bank = convert.code_bank(jf._get_bank(jnp.asarray(pc)),
                             jf._get_data_bank(jnp.asarray(dc)), "cpu")
    tf = FastTrackingEngine(TrackingConfig(**kw), 2, 1, sec_max_len=25,
                            device="cpu")
    mine = tf.get_bank(torch.from_numpy(pc), torch.from_numpy(dc))
    assert torch.equal(bank, mine)
    assert bank.shape[2] == 6
    # the packed form K1 and K1-loop read on the card, made with the bank,
    # gives the pilot + data bank back to the bit
    back = unpack_bank(*tf.packed_bank(mine), 6)
    assert torch.equal(back.view(torch.int32), bank.view(torch.int32))


# ---- factory --------------------------------------------------------------

def _two_group(**extra):
    from gnss_sdr_tpu_torch.config import InMemoryConfiguration

    cfg = InMemoryConfiguration()
    for key, value in {"GNSS-SDR.internal_fs_sps": "4000000",
                       "Channels_1C.count": "2", "Channels_1B.count": "2",
                       "Tracking_1B.track_pilot": "true", **extra}.items():
        cfg.set_property(key, value)
    return cfg


def test_factory_routes_1c_1b_and_refuses_the_rest():
    from gnss_sdr_tpu.receiver import factory as jfactory
    from gnss_sdr_tpu_torch.acquisition.adapters import make_acquisition
    from gnss_sdr_tpu_torch.receiver import factory
    from gnss_sdr_tpu_torch.receiver.multiband import MultiBandReceiver
    from gnss_sdr_tpu_torch.receiver.production_multiband import \
        ProductionMultiBandReceiver

    assert factory.BAND_REGISTRY == jfactory.BAND_REGISTRY
    rec = factory.make_receiver(_two_group(), device="cpu")
    assert isinstance(rec, ProductionMultiBandReceiver)
    assert [b.cfg.suffix for b in rec.receiver.bands] == ["1C", "1B"]
    assert rec.receiver.bands[1].tracking.cfg.track_pilot
    assert rec.receiver.bands[1].tracking.cfg.n_taps == 5
    scan = factory.make_receiver(_two_group(**{"GNSS-SDR.engine": "scan"}),
                                 device="cpu")
    assert type(scan) is MultiBandReceiver
    # E1 alone, and the registry names the JAX package accepts and
    # ignores (ROADMAP §3)
    alone = _two_group(**{"Channels_1C.count": "0",
                          "Tracking_1C.implementation":
                          "GPS_L1_CA_KF_Tracking"})
    assert isinstance(factory.make_receiver(alone, device="cpu"),
                      ProductionMultiBandReceiver)
    kf = _two_group(**{"Tracking_1C.implementation": "GPS_L1_CA_KF_Tracking"})
    assert factory.make_receiver(kf, device="cpu").receiver.bands[0] \
        .tracking.cfg.extend_correlation_symbols == 1
    with pytest.raises(ValueError, match="supported"):
        factory.make_receiver(_two_group(**{
            "Tracking_1B.implementation": "Nope"}), device="cpu")
    for extra, step in (({"Channels_L5.count": "2"}, "step 8b"),
                        ({"Channels_5X.count": "2"}, "step 8b"),
                        ({"Channels_B1.count": "2"}, "step 8c"),
                        ({"Channels_1G.count": "2"}, "step 8d"),
                        ({"Channels_2S.count": "2"}, "step 8e"),
                        ({"Channels_S1.count": "2"}, "step 8f"),
                        ({"PVT.positioning_mode": "PPP_Static"}, "step 8g"),
                        ({"PVT.rinex_output_enabled": "true"}, "step 8g"),
                        ({"PVT.iono_model": "IFLC"}, "step 8g"),
                        ({"Monitor.enable_monitor": "true"}, "step 8g")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{step}"):
            factory.make_receiver(_two_group(**extra), device="cpu")
    # the acquisition variants build (tests/test_torch_variants.py)
    assert type(make_acquisition(
        "Galileo_E1_PCPS_QuickSync_Ambiguous_Acquisition", [1], FS,
        device="cpu")).__name__ == "QuickSyncAcquisition"
    with pytest.raises(ValueError, match="known"):
        make_acquisition("Nope", [1], FS, device="cpu")
