"""Parity of the port's scan and fast tracking engines with the JAX
package on the CPU, from identical channel states.

- Scan engine, one block from the same ``start_channel`` state: every
  state field within rel. 1e-5 of its scale (a re/im pair scaled by the
  pair's magnitude); integer and boolean fields identical.
- Scan engine over many blocks: Doppler within 1 Hz, C/N0 within 1 dB,
  prompt magnitude within 2%.
- Fast engine from the same ``from_track_state`` input: period starts
  identical, rems within 0.02 samples, prompts within 2%, Doppler within
  1 Hz, C/N0 within 1 dB (the JAX suite's tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.codes import gps_l1ca_code
from gnss_sdr_tpu.simulate import SatelliteParams, generate_gps_l1ca
from gnss_sdr_tpu.tracking import TrackingConfig as JConfig
from gnss_sdr_tpu.tracking.channels import TrackingChannels as JChannels
from gnss_sdr_tpu.tracking.fast_engine import FastTrackingEngine as JFast
from gnss_sdr_tpu_torch import convert
from gnss_sdr_tpu_torch.kernels.bank_corr import pack_bank, unpack_bank
from gnss_sdr_tpu_torch.tracking.channels import TrackingChannels
from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig
from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

torch.set_num_threads(2)
FS = 2.5e6
BLOCK = int(FS * 0.02)
KW = dict(fs=FS, extend_correlation_symbols=20, pll_bw_narrow_hz=5.0,
          dll_bw_narrow_hz=0.75, enable_fll_pull_in=True, pull_in_time_s=0.1)
PAIRS = {"p_old_im": "p_old_re", "prompt_buf_im": "prompt_buf_re",
         "accu_im": "accu_re"}


@pytest.fixture(scope="module")
def signal():
    sats = [SatelliteParams(prn=9, cn0_db_hz=45.0, delay_samples=400.0,
                            doppler_hz=1200.0),
            SatelliteParams(prn=4, cn0_db_hz=48.0, delay_samples=1300.0,
                            doppler_hz=-2500.0)]
    return generate_gps_l1ca(sats, FS, 0.62, seed=11)


def _pair():
    j = JChannels(JConfig(**KW), 2, BLOCK)
    t = TrackingChannels(TrackingConfig(**KW), 2, BLOCK, device="cpu")
    for tc in (j, t):
        tc.start_channel(0, 9, gps_l1ca_code(9), 400.0, 1220.0, 0)
        tc.start_channel(1, 4, gps_l1ca_code(4), 1300.0, -2480.0, 0)
    return j, t


def _state_close(js, ts, rtol):
    jd = convert.field_dict(js)
    td = convert.state_numpy(ts)
    assert set(jd) == set(td)
    for name, a in jd.items():
        b = td[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        ref = [a] + ([jd[PAIRS[name]]] if name in PAIRS else [])
        ref += [jd[k] for k, v in PAIRS.items() if v == name]
        scale = max(float(np.max(np.abs(r))) for r in ref) or 1.0
        assert np.max(np.abs(a - b)) <= rtol * scale, (name,
                                                       np.max(np.abs(a - b)),
                                                       scale)


def test_scan_engine_one_block_parity(signal):
    j, t = _pair()
    _state_close(j.state, t.state, 0.0)
    seg = signal[:BLOCK + j.overlap]
    oj, ot = j.process_block(seg), t.process_block(seg)
    _state_close(j.state, t.state, 1e-5)
    for cj, ct in zip(oj, ot):
        assert [p.sample_start for p in cj] == [p.sample_start for p in ct]
        assert [p.length for p in cj] == [p.length for p in ct]
        np.testing.assert_allclose([abs(p.prompt) for p in ct],
                                   [abs(p.prompt) for p in cj], rtol=1e-5)


def test_scan_engine_converges_with_jax(signal):
    j, t = _pair()
    n_blocks = (len(signal) - j.overlap) // BLOCK
    out = {"j": [], "t": []}
    for b in range(n_blocks):
        seg = signal[b * BLOCK:(b + 1) * BLOCK + j.overlap]
        out["j"].append(j.process_block(seg))
        out["t"].append(t.process_block(seg))
        if b == 15:  # extended integration on channel 0 (states 3/4)
            j.enable_extended(0, 0)
            t.enable_extended(0, 0)
    for ch in (0, 1):
        pj = [p for blk in out["j"] for p in blk[ch]][-20:]
        pt = [p for blk in out["t"] for p in blk[ch]][-20:]
        assert len(pj) == len(pt) == 20
        assert abs(pj[-1].carrier_doppler_hz - pt[-1].carrier_doppler_hz) < 1
        assert abs(pj[-1].cn0_db_hz - pt[-1].cn0_db_hz) < 1
        np.testing.assert_allclose([abs(p.prompt) for p in pt],
                                   [abs(p.prompt) for p in pj], rtol=0.02)
        assert not any(p.loss_of_lock for p in pt)


@pytest.mark.parametrize("true_doppler", [-4800.0, 1300.0])
def test_fast_engine_parity_from_track_state(true_doppler):
    fs = 4e6
    block = int(fs * 0.02)
    sat = SatelliteParams(prn=13, cn0_db_hz=48.0, delay_samples=1000.0,
                          doppler_hz=true_doppler)
    x = generate_gps_l1ca([sat], fs, 0.9, seed=21)
    kw = dict(fs=fs, extend_correlation_symbols=20, pll_bw_narrow_hz=5.0,
              dll_bw_narrow_hz=0.75, cn0_smoother_alpha=0.05)
    tc = JChannels(JConfig(**kw), 1, block)
    tc.start_channel(0, 13, gps_l1ca_code(13), 1000.0, true_doppler + 15, 0)
    for b in range(12):
        tc.process_block(x[b * block:(b + 1) * block + tc.overlap])
    jf = JFast(JConfig(**kw), 1, 5)
    tf = FastTrackingEngine(TrackingConfig(**kw), 1, 5, device="cpu")
    js = jf.from_track_state(tc.state)
    ts = convert.fast_state(js, "cpu")
    # the port's own from_track_state agrees with the JAX one
    ts2 = tf.from_track_state(convert.track_state(tc.state, "cpu"))
    for name, v in convert.state_numpy(ts2).items():
        np.testing.assert_array_equal(v, convert.state_numpy(ts)[name], name)
    js = jax.tree_util.tree_map(lambda a: jnp.array(np.asarray(a)), js)
    codes = np.asarray(gps_l1ca_code(13), np.float32)[None, :]
    bank = tf.get_bank(torch.from_numpy(codes))
    np.testing.assert_array_equal(
        bank.numpy(), np.asarray(jf._get_bank(jnp.asarray(codes))))
    # the packed form K1 and K1-loop read on the card, made with the bank,
    # gives the bank back to the bit
    words, values = tf.packed_bank(bank)
    back = unpack_bank(words, values, bank.shape[2])
    assert torch.equal(back.view(torch.int32), bank.view(torch.int32))
    # pack_bank (banks made elsewhere, by their bits) gives the same form
    other = pack_bank(bank)
    assert torch.equal(other[0], words) and torch.equal(other[1], values)
    pos = 12 * block
    k = 20
    n_blocks = (len(x) - pos - jf.overlap) // jf.block_samples
    assert n_blocks >= 2
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
        assert pj.shape == pt.shape
        np.testing.assert_array_equal(pj[..., :k], pt[..., :k])
        assert np.max(np.abs(pj[..., k:2 * k] - pt[..., k:2 * k])) < 0.02
        np.testing.assert_allclose(np.abs(pt[..., 2 * k:3 * k]),
                                   np.abs(pj[..., 2 * k:3 * k]), rtol=0.02,
                                   atol=1e-3 * np.abs(pj[..., 2 * k:3 * k])
                                   .max())
        assert np.max(np.abs(pj[..., 5 * k] - pt[..., 5 * k])) < 1.0
        assert np.max(np.abs(pj[..., 5 * k + 1] - pt[..., 5 * k + 1])) < 1.0
        np.testing.assert_array_equal(pj[..., 5 * k + 2:], pt[..., 5 * k + 2:])
        np.testing.assert_allclose(
            np.hypot(ot["prompt_re"].numpy(), ot["prompt_im"].numpy()),
            np.hypot(np.asarray(oj["prompt_re"]), np.asarray(oj["prompt_im"])),
            rtol=0.02)
    assert abs(float(ts.carrier_doppler_hz[0]) - true_doppler) < 5.0


def test_ring_superblock_equals_float_blocks(signal):
    """The int8-ring superblock path reads the same samples as the float
    block path when the ring holds integer-valued samples."""
    xq = (np.clip(np.round(signal.real * 4.0), -127, 127)
          + 1j * np.clip(np.round(signal.imag * 4.0), -127, 127)
          ).astype(np.complex64)
    ring = torch.from_numpy(np.stack([xq.real.astype(np.int8),
                                      xq.imag.astype(np.int8)]))
    a = TrackingChannels(TrackingConfig(**KW), 2, BLOCK, device="cpu")
    b = TrackingChannels(TrackingConfig(**KW), 2, BLOCK, device="cpu")
    for tc in (a, b):
        tc.start_channel(0, 9, gps_l1ca_code(9), 400.0, 1220.0, 0)
    ra = a.process_superblock_ring(ring, 0, 3)
    rb = [[], []]
    for blk in range(3):
        for ch, lst in enumerate(b.process_block(
                xq[blk * BLOCK:(blk + 1) * BLOCK + b.overlap])):
            rb[ch].extend(lst)
    assert len(ra[0]) == len(rb[0]) > 50
    for pa, pb in zip(ra[0], rb[0]):
        assert pa.sample_start == pb.sample_start
        assert pa.prompt == pb.prompt
