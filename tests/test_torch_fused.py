"""The fused tracking programs (K3-loop ``kernels/scan_loop.py``, K1-loop
``kernels/fast_loop.py``) on the CPU.

- The ctypes structure each wrapper passes points at every field of
  ``TrackState`` / ``FastState`` (the KF / Gaussian carries and the
  secondary-code fields included), and the C structs of
  ``csrc/scan_loop.cu`` / ``csrc/fast_loop.cu`` list the same fields in
  the same order; each constants structure matches its C twin field for
  field.
- On the CPU both engines' ``superblock_ring_i8`` go through
  ``_blocks_stepwise`` (the kernels' plain version), and a 2-block
  superblock from a pulled-in state equals the JAX package's
  ``superblock_ring_i8`` from the same state within the JAX suite's
  tolerances (``tests/test_fast_engine.py:153-161``): Doppler 1 Hz, C/N0
  1 dB, prompt magnitude 2%, period boundaries 0.02 samples.
- Each launch-constants structure carries, in float32, the JAX engine's
  own coefficients (FLL/PLL gains, DLL filter, KF / Gaussian matrices) for
  L1, E1 pilot/VEML and second-order configurations; ``state_spec``
  describes every state the engines produce; ``state_pointers`` refuses a
  state the kernel's struct would misread.
- The wrappers run their plain version on the CPU without counting a
  launch and without writing the caller's state, refuse other devices,
  and every entry point (``process_block``, ``superblock_step``,
  ``superblock_ring_i8``) gives the same records and state to the bit.
- The segmented-sum fast engine (``correlator="segsum"``, K1-loop's
  K1-seg body on the card) against the JAX segsum engine: a 2-block L1
  superblock and one E1 pilot group (K = 25, CS25, the data prompt)
  within the same tolerances, each first-group period correlation
  within 1e-5 of the group's prompt magnitude (XLA's float32 prefix sums
  against PyTorch's, which the CPU accumulates in float64); its launch
  constants, state layout and raw code tables.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
holds them against ``_blocks_stepwise`` there).
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnss_sdr_tpu.codes import gps_l1ca_code
from gnss_sdr_tpu.simulate import SatelliteParams, generate_gps_l1ca
from gnss_sdr_tpu.tracking import TrackingConfig as JConfig
from gnss_sdr_tpu.tracking.engine import TrackingEngine as JEngine
from gnss_sdr_tpu.tracking.engine import TrackState as JTrackState
from gnss_sdr_tpu.tracking.fast_engine import FastState as JFastState
from gnss_sdr_tpu.tracking.fast_engine import FastTrackingEngine as JFast
from gnss_sdr_tpu_torch import convert
from gnss_sdr_tpu_torch.kernels import LAUNCHES
from gnss_sdr_tpu_torch.kernels import build as kb
from gnss_sdr_tpu_torch.kernels import fast_loop as kfl
from gnss_sdr_tpu_torch.kernels import loops as k6
from gnss_sdr_tpu_torch.kernels import scan_loop as ksl
from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig, TrackingEngine
from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

torch.set_num_threads(2)
CSRC = os.path.join(os.path.dirname(kb.__file__), "csrc")
CPU = torch.device("cpu")
# the small shapes of tests/test_torch_tracking.py
FS = 2.5e6
BLOCK = int(FS * 0.02)
KW = dict(fs=FS, extend_correlation_symbols=20, pll_bw_narrow_hz=5.0,
          dll_bw_narrow_hz=0.75, enable_fll_pull_in=True, pull_in_time_s=0.1)
PRNS = (9, 4)


def _c_struct(source: str, name: str) -> list[tuple[str, int]]:
    """(field, element count) of ``struct name`` in a csrc file, in
    declaration order; a nested struct counts as one field."""
    with open(os.path.join(CSRC, source)) as fh:
        text = fh.read()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, text, re.S).group(1)
    out = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if not decl:
            continue
        names = re.sub(r"^(unsigned\s+)?\w+\**\s+\**", "", decl)
        for item in names.split(","):
            item = item.strip()
            m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", item)
            out.append((m.group(1), int(m.group(2) or 1)))
    return out


def _ctypes_fields(cls) -> list[tuple[str, int]]:
    out = []
    for name, typ in cls._fields_:
        n = typ._length_ if issubclass(typ, ctypes.Array) else 1
        out.append((name, n))
    return out


@pytest.mark.parametrize("struct,source,cls", [
    ("ScanConsts", "scan_loop.cu", ksl.ScanConsts),
    ("FastConsts", "fast_loop.cu", kfl.FastConsts),
    ("FllPllGainsF", "loop_common.cuh", kfl.FllPllGainsF),
    ("KfParams", "loops.cuh", k6.KfParams),
    ("GsParams", "loops.cuh", k6.GsParams),
])
def test_constants_structs_match_their_c_twins(struct, source, cls):
    assert _c_struct(source, struct) == _ctypes_fields(cls)


def _engines(k_ext=20, loop="fllpll", sec_max_len=1):
    cfg = TrackingConfig(**dict(KW, extend_correlation_symbols=k_ext))
    return (TrackingEngine(cfg, 3, BLOCK, device="cpu"),
            FastTrackingEngine(cfg, 3, 2, loop=loop, sec_max_len=sec_max_len,
                               device="cpu"))


def _random_state(state, rng):
    """``state`` with every field filled with distinct seeded values of
    its own dtype and shape."""
    out = []
    for t in state:
        if t.dtype == torch.bool:
            v = rng.integers(0, 2, t.shape).astype(bool)
        elif t.dtype == torch.int32:
            v = rng.integers(-1000, 1000, t.shape).astype(np.int32)
        else:
            v = rng.standard_normal(t.shape).astype(np.float32)
        out.append(torch.from_numpy(v))
    return type(state)(*out)


@pytest.mark.parametrize("engine", ["scan", "fast"])
def test_state_struct_points_at_every_field(engine):
    scan, fast = _engines(k_ext=25, loop="gaussian", sec_max_len=25)
    eng, mod, c_name, source = {
        "scan": (scan, ksl, "ScanState", "scan_loop.cu"),
        "fast": (fast, kfl, "FastStatePtrs", "fast_loop.cu")}[engine]
    state = _random_state(eng.init_state(), np.random.default_rng(7))
    fields = type(state)._fields
    # the kernel's struct lists the NamedTuple's fields in its order
    assert [n for n, _ in _c_struct(source, c_name)] == list(fields)
    spec = mod.state_spec(eng)
    struct, tensors = kb.state_pointers(state, spec, 3, CPU, engine)
    for name, t in zip(fields, state):
        ptr = getattr(struct, name)
        raw = (ctypes.c_ubyte * (t.numel() * t.element_size())).from_address(
            ptr)
        got = np.frombuffer(bytes(raw), dtype=t.numpy().dtype).reshape(
            t.shape)
        np.testing.assert_array_equal(got, t.numpy(), err_msg=name)
    carries = {"fast": ("kf_x", "kf_p", "gs_niw", "sec_signs", "sec_len",
                        "sec_phase"), "scan": ("secondary_signs", "accu_re")}
    assert set(carries[engine]) <= set(fields)
    # a field of the wrong dtype or shape is refused
    bad = state._replace(**{fields[1]: state[1].to(torch.float64)})
    with pytest.raises(ValueError):
        kb.state_pointers(bad, spec, 3, CPU, engine)


@pytest.fixture(scope="module")
def ring():
    """0.42 s of two satellites at 2.5 Msps as the planar int8 ring."""
    sats = [SatelliteParams(prn=9, cn0_db_hz=45.0, delay_samples=400.0,
                            doppler_hz=1200.0),
            SatelliteParams(prn=4, cn0_db_hz=48.0, delay_samples=1300.0,
                            doppler_hz=-2500.0)]
    x = generate_gps_l1ca(sats, FS, 0.42, seed=11)
    xq = (np.clip(np.round(x.real * 4.0), -127, 127)
          + 1j * np.clip(np.round(x.imag * 4.0), -127, 127))
    return np.stack([xq.real.astype(np.int8), xq.imag.astype(np.int8)])


def _pulled_in(ring):
    """The port's scan engine (2 channels) after 8 blocks of pull-in and
    a switch of channel 0 into extended integration; its code tables."""
    eng = TrackingEngine(TrackingConfig(**KW), 2, BLOCK, device="cpu")
    codes = torch.from_numpy(np.stack([gps_l1ca_code(p) for p in PRNS])
                             .astype(np.float32))
    s = eng.init_state()
    for ch, (delay, dopp) in enumerate(((400.0, 1220.0), (1300.0, -2480.0))):
        s = eng.start_channel(s, ch, dopp, int(np.ceil(delay)) % 2500, 2500)
    r = torch.from_numpy(ring)
    s, _ = eng._blocks_stepwise(s, r[0], r[1], 0, BLOCK, 8, codes)
    return eng, eng.set_extended(s, 0, 0), codes


def _spy(monkeypatch, cls):
    calls = []
    orig = cls._blocks_stepwise

    def spy(self, *a, **k):
        calls.append(a[5])         # n_blocks
        return orig(self, *a, **k)
    monkeypatch.setattr(cls, "_blocks_stepwise", spy)
    return calls


def _boundaries(start, rem):
    return start.astype(np.float64) + rem.astype(np.float64)


def test_scan_superblock_ring_stepwise_matches_jax(ring, monkeypatch):
    eng, s, codes = _pulled_in(ring)
    calls = _spy(monkeypatch, TrackingEngine)
    base = 8 * BLOCK
    ts, out = eng.superblock_ring_i8(s, torch.from_numpy(ring), base, 2,
                                     codes)
    assert calls == [2]            # one stepwise call for the 2 blocks
    je = JEngine(JConfig(**KW), 2, BLOCK)
    js = JTrackState(**{k: jnp.asarray(v)
                        for k, v in convert.state_numpy(s).items()})
    js, jout = je._superblock_ring_i8(js, jnp.asarray(ring), jnp.int32(base),
                                      2, jnp.asarray(codes.numpy()))
    pj, pt = np.asarray(jout["packed"]), out["packed"].numpy()
    assert pj.shape == pt.shape == (2, eng.n_steps, 2, 21)
    np.testing.assert_array_equal(pj[..., 0], pt[..., 0])
    v = pt[..., 0] > 0.5
    assert v.sum() > 70
    assert np.max(np.abs(_boundaries(pj[..., 1], pj[..., 3])
                         - _boundaries(pt[..., 1], pt[..., 3]))[v]) < 0.02
    np.testing.assert_allclose(np.hypot(pt[..., 4], pt[..., 5])[v],
                               np.hypot(pj[..., 4], pj[..., 5])[v],
                               rtol=0.02)
    assert np.max(np.abs(pj[..., 8] - pt[..., 8])[v]) < 1.0
    assert np.max(np.abs(pj[..., 11] - pt[..., 11])[v]) < 1.0
    np.testing.assert_array_equal(pj[..., 14], pt[..., 14])
    jd = convert.field_dict(js)
    np.testing.assert_array_equal(jd["offset"], ts.offset.numpy())
    assert np.max(np.abs(jd["carrier_doppler_hz"]
                         - ts.carrier_doppler_hz.numpy())) < 1.0


def test_fast_superblock_ring_stepwise_matches_jax(ring, monkeypatch):
    eng, s, codes = _pulled_in(ring)
    fast = FastTrackingEngine(TrackingConfig(**KW), 2, 2, device="cpu")
    fs = fast.from_track_state(s)
    calls = _spy(monkeypatch, FastTrackingEngine)
    base = 8 * BLOCK
    bank = fast.get_bank(codes)
    ts, out = fast.superblock_ring_i8(fs, torch.from_numpy(ring), base, 2,
                                      bank)
    assert calls == [2]
    jf = JFast(JConfig(**KW), 2, 2)
    js = JFastState(**{k: jnp.asarray(v)
                       for k, v in convert.state_numpy(fs).items()})
    js, jout = jf._superblock_ring_i8(js, jnp.asarray(ring), jnp.int32(base),
                                      2, jf._get_bank(jnp.asarray(
                                          codes.numpy())))
    pj, pt = np.asarray(jout["packed"]), out["packed"].numpy()
    k = fast.k
    assert pj.shape == pt.shape == (2, 2, 2, 5 * k + 4)
    np.testing.assert_array_equal(pj[..., 5 * k + 2:], pt[..., 5 * k + 2:])
    assert (pt[..., 5 * k + 2] > 0.5).all()
    assert np.max(np.abs(_boundaries(pj[..., :k], pj[..., k:2 * k])
                         - _boundaries(pt[..., :k], pt[..., k:2 * k]))) < 0.02
    np.testing.assert_allclose(np.abs(pt[..., 2 * k:3 * k]),
                               np.abs(pj[..., 2 * k:3 * k]), rtol=0.02,
                               atol=1e-3 * np.abs(pj[..., 2 * k:3 * k]).max())
    assert np.max(np.abs(pj[..., 5 * k] - pt[..., 5 * k])) < 1.0
    assert np.max(np.abs(pj[..., 5 * k + 1] - pt[..., 5 * k + 1])) < 1.0
    jd = convert.field_dict(js)
    np.testing.assert_array_equal(jd["offset"], ts.offset.numpy())
    assert np.max(np.abs(jd["carrier_doppler_hz"]
                         - ts.carrier_doppler_hz.numpy())) < 1.0


# -- the launch constants against the JAX engines' coefficients ---------------

E1_KW = dict(fs=4e6, code_length_chips=4092, code_samples_per_chip=12,
             veml=True, symbols_per_bit=1, pll_bw_hz=20.0,
             pll_bw_narrow_hz=2.0, enable_fll_pull_in=True,
             pull_in_time_s=0.1, early_late_space_chips=0.15,
             very_early_late_space_chips=0.6)
SCAN_CASES = {"l1": KW, "l1-order2": dict(KW, pll_filter_order=2),
              "l1-no-fll-no-aiding": dict(KW, enable_fll_pull_in=False,
                                          carrier_aiding=False),
              "e1-pilot-veml": dict(E1_KW, extend_correlation_symbols=25,
                                    track_pilot=True)}


def _f32s(values) -> list[float]:
    return [float(v) for v in np.asarray(values, np.float32).ravel()]


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_consts_match_jax_engine(case):
    """Every coefficient K3-loop receives equals, in float32, the JAX scan
    engine's own for the same configuration."""
    kw = SCAN_CASES[case]
    block = int(kw["fs"] * 0.02)
    eng = TrackingEngine(TrackingConfig(**kw), 2, block, device="cpu")
    je = JEngine(JConfig(**kw), 2, block)
    cfg = je.cfg
    k = ksl.scan_consts(eng)
    assert (k.n_steps, k.block_samples, k.total, k.max_period,
            k.pull_in_steps, k.cn0_samples, k.pll_order) == (
        je.n_steps, je.block_samples, je.block_samples + je.overlap,
        je.max_period, je._pull_in_steps, cfg.cn0_samples, je._gains.order)
    assert k.k_ext == max(1, cfg.extend_correlation_symbols)
    assert (k.veml, k.carrier_aiding, k.fll_pull_in, k.fll_steady) == (
        cfg.veml, cfg.carrier_aiding, cfg.enable_fll_pull_in,
        cfg.enable_fll_steady_state)
    assert (k.max_code_fail, k.max_carr_fail) == (cfg.max_code_lock_fail,
                                                  cfg.max_carrier_lock_fail)
    taps = np.asarray(je._shifts)
    assert list(k.shifts)[:taps.size] == _f32s(taps)
    for pre, g in (("w_", je._gains), ("n_", je._gains_narrow)):
        for name in ("w0p", "w0p2", "w0p3", "w0f", "w0f2"):
            assert getattr(k, pre + name) == ksl.f32(getattr(g, "pll_" + name))
    g = je._gains
    assert (k.a2, k.a3, k.b3) == tuple(map(ksl.f32, (g.pll_a2, g.pll_a3,
                                                      g.pll_b3)))
    for field, ref in (("dll_ic", je._dll_ic), ("dll_oc", je._dll_oc),
                       ("dll_ic_n", je._dll_ic_narrow),
                       ("dll_oc_n", je._dll_oc_narrow)):
        assert list(getattr(k, field)) == _f32s(ref), field
    assert k.dll_gain == ksl.f32((cfg.y_intercept - cfg.slope * cfg.spc)
                                 / cfg.slope)
    assert (k.carrier_lock_th, k.cn0_min) == (ksl.f32(cfg.carrier_lock_th),
                                              ksl.f32(cfg.cn0_min))
    assert k.inv_n == float(np.float32(1) / np.float32(cfg.cn0_samples))


FAST_CASES = {"fllpll": (KW, "fllpll"),
              "fllpll-order2": (dict(KW, pll_filter_order=2), "fllpll"),
              "e1-veml-k1": (dict(E1_KW, extend_correlation_symbols=1),
                             "fllpll"),
              "kf": (KW, "kf"), "gaussian": (KW, "gaussian")}


FAST_CASES.update({
    "segsum": (KW, "fllpll"),
    "e1-pilot-segsum": (dict(E1_KW, extend_correlation_symbols=25,
                             track_pilot=True), "fllpll")})


@pytest.mark.parametrize("case", list(FAST_CASES))
def test_fast_consts_match_jax_engine(case):
    """Every coefficient K1-loop receives (the FLL/PLL products, the DLL
    filter, the KF / Gaussian matrices; for the segmented sum its window,
    code rate and tap shifts) equals, in float32, the JAX fast engine's
    own for the same configuration."""
    from gnss_sdr_tpu.ops import gaussian as jgauss
    from gnss_sdr_tpu.ops import kalman as jkalman

    kw, loop = FAST_CASES[case]
    corr = "segsum" if case.endswith("segsum") else "bank"
    eng = FastTrackingEngine(TrackingConfig(**kw), 2, 2, loop=loop,
                             correlator=corr, device="cpu")
    jf = JFast(JConfig(**kw), 2, 2, loop=loop, correlator=corr)
    cfg = jf.cfg
    k = kfl.fast_consts(eng)
    assert k.seg == (corr == "segsum")
    if corr == "segsum":
        # JAX's Lg, code_table_len, code_step_nom and cspc / fs (_build)
        assert (k.lg, k.table_len) == (
            jf.k * cfg.samples_per_code + 64,
            cfg.code_length_chips * cfg.code_samples_per_chip)
        assert k.code_step_nom == ksl.f32(
            cfg.chip_rate_cps / cfg.fs * cfg.code_samples_per_chip)
        assert k.cspc_over_fs == float(np.float32(cfg.code_samples_per_chip)
                                       / np.float32(cfg.fs))
        assert list(k.shifts)[:eng.n_taps] == _f32s(jf._shifts)
    assert (k.n_groups, k.K, k.block_samples, k.total, k.win_len, k.P1,
            k.sec_max_len, k.cn0_samples, k.pll_order) == (
        jf.g, jf.k, jf.block_samples, jf.block_samples + jf.overlap,
        jf.win_len, jf.BANK_PHASES + 1, jf.sec_max_len, cfg.cn0_samples,
        jf._gains.order)
    assert k.loop == kfl.LOOPS[loop]
    assert (k.veml, k.carrier_aiding) == (cfg.veml, cfg.carrier_aiding)
    assert list(k.dll_ic) == _f32s(jf._dll_ic)
    assert list(k.dll_oc) == _f32s(jf._dll_oc)
    g = jf._gains
    assert [getattr(k.g, n) for n in kfl._GAINS] == _f32s([
        g.pll_w0p2, g.pll_w0p3, g.pll_w0f, g.pll_w0f2, g.pll_a2 * g.pll_w0f,
        g.pll_a3 * g.pll_w0p2, g.pll_b3 * g.pll_w0p, g.pll_a2 * g.pll_w0p])
    assert k.dll_gain == ksl.f32((cfg.y_intercept - cfg.slope * cfg.spc)
                                 / cfg.slope)
    t_loop = cfg.code_period_s * jf.k
    if loop == "kf":
        assert list(k.kf.f) == _f32s(jkalman._transition(jf.kf_cfg, t_loop))
        assert list(k.kf.q) == _f32s(np.diag(jkalman._process_noise(
            jf.kf_cfg, t_loop)))
        assert list(k.kf.r) == _f32s([jf.kf_cfg.r_code, jf.kf_cfg.r_phase])
    if loop == "gaussian":
        n = jf.gs_cfg.order
        assert k.gs.order == n
        assert list(k.gs.f)[:n * n] == _f32s(jgauss._transition(jf.gs_cfg,
                                                                t_loop))
        assert list(k.gs.q)[:n] == _f32s(np.diag(jgauss._process_noise(
            jf.gs_cfg, t_loop)))
        assert k.gs.t == ksl.f32(t_loop)
        assert (k.gs.bayes_run, k.gs.p_transient, k.gs.s_transient,
                k.gs.bce_kappa, k.gs.bce_nu) == (
            int(bool(jf.gs_cfg.bayes_run)), jf.gs_cfg.p_transient,
            jf.gs_cfg.s_transient, jf.gs_cfg.bce_kappa, jf.gs_cfg.bce_nu)


# -- the state layouts the kernels are handed ---------------------------------

SPEC_CASES = {"l1-k20": (KW, 1),
              "e1-pilot-k25": (dict(E1_KW, extend_correlation_symbols=25,
                                    track_pilot=True), 25),
              "e1-veml-k1": (dict(E1_KW, extend_correlation_symbols=1), 1)}


@pytest.mark.parametrize("engine", ["scan", "fast"])
@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_state_spec_matches_init_state(case, engine):
    """``state_spec`` names every field of the engine's fresh state (and of
    the fast state handed over from a scan state) with its dtype and
    shape, so ``state_pointers`` accepts what the engines produce."""
    kw, sec = SPEC_CASES[case]
    cfg = TrackingConfig(**kw)
    scan = TrackingEngine(cfg, 3, int(kw["fs"] * 0.02), device="cpu")
    fast = FastTrackingEngine(cfg, 3, 2, sec_max_len=sec, device="cpu")
    if engine == "scan":
        eng, mod, states = scan, ksl, [scan.init_state()]
    else:
        eng, mod = fast, kfl
        states = [fast.init_state(), fast.from_track_state(scan.init_state())]
    spec = mod.state_spec(eng)
    for state in states:
        assert tuple(spec) == type(state)._fields
        for name, t in zip(type(state)._fields, state):
            dtype, trailing = spec[name]
            assert (t.dtype, tuple(t.shape)) == (dtype, (3, *trailing)), name
        kb.state_pointers(state, spec, 3, CPU, engine)


@pytest.mark.parametrize("fault", ["order", "dtype", "trailing", "channels",
                                   "device"])
def test_state_pointers_refuses(fault):
    """A state the kernel's struct would misread is refused before any
    pointer is taken: fields in another order, a wrong dtype, trailing
    shape or channel count, a tensor on another device."""
    scan, _ = _engines()
    state = scan.init_state()
    spec = ksl.state_spec(scan)
    name = "code_x_hist"
    if fault == "order":
        spec = dict(reversed(list(spec.items())))
    elif fault == "dtype":
        state = state._replace(offset=state.offset.to(torch.int64))
    elif fault == "trailing":
        state = state._replace(**{name: getattr(state, name)[:, :3]})
    elif fault == "channels":
        state = state._replace(**{name: getattr(state, name)[:2]})
    else:
        state = state._replace(**{name: torch.empty(
            (3, 4), dtype=torch.float32, device="meta")})
    with pytest.raises(ValueError):
        kb.state_pointers(state, spec, 3, CPU, "scan")


def test_pointer_struct_is_one_void_pointer_per_field():
    names = ("a", "b", "c")
    cls = kb.pointer_struct(names)
    assert kb.pointer_struct(names) is cls
    assert [(n, t) for n, t in cls._fields_] == [(n, ctypes.c_void_p)
                                                 for n in names]
    assert ctypes.sizeof(cls) == 3 * ctypes.sizeof(ctypes.c_void_p)


# -- the wrappers' device routing and their caller's state -------------------

@pytest.fixture(scope="module")
def pulled(ring):
    return _pulled_in(ring)


def _engine(kind, pulled):
    """The pulled-in scan engine and state, or a fast engine handed that
    state; with the code tables and what ``superblock_ring_i8`` takes."""
    eng, s, codes = pulled
    if kind == "scan":
        return eng, s, codes, codes
    fast = FastTrackingEngine(TrackingConfig(**KW), 2, 2, device="cpu")
    return fast, fast.from_track_state(s), codes, fast.get_bank(codes)


LOOPS = {"scan": ksl.scan_loop, "fast": kfl.fast_loop}


@pytest.mark.parametrize("engine", ["scan", "fast"])
def test_wrappers_refuse_a_device_they_cannot_run(engine, pulled):
    """A sample source on neither the CPU nor the card is refused; nothing
    is counted as launched."""
    eng, s, _, tables = _engine(engine, pulled)
    src = torch.empty(4 * BLOCK, dtype=torch.int8, device="meta")
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device"):
        LOOPS[engine](eng, s, src, src, 0, BLOCK, 1, tables)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("engine", ["scan", "fast"])
def test_wrappers_leave_the_callers_state_unwritten(engine, ring, pulled):
    """On the CPU each wrapper runs its plain version, counts no launch,
    and returns a fresh state: the caller's tensors keep their values."""
    eng, s, _, tables = _engine(engine, pulled)
    r = torch.from_numpy(ring)
    kept = [t.clone() for t in s]
    before = dict(LAUNCHES)
    new = LOOPS[engine](eng, s, r[0], r[1], 8 * BLOCK, BLOCK, 1, tables)[0]
    assert dict(LAUNCHES) == before
    for name, a, b in zip(type(s)._fields, s, kept):
        assert torch.equal(a, b), name
    assert not torch.equal(new.rem_carr_phase_rad, s.rem_carr_phase_rad)


# -- the entry points: one program whichever way the blocks arrive ------------

@pytest.mark.parametrize("engine,path", [("scan", "process_block"),
                                         ("scan", "superblock_step"),
                                         ("fast", "process_block")])
def test_entry_points_agree_with_the_ring(engine, path, ring, pulled):
    """Two blocks through ``process_block`` (or the scan engine's float
    ``superblock_step``) give the state and records of one 2-block
    ``superblock_ring_i8`` over the same samples, to the bit: every
    entry point walks the blocks as the kernels do."""
    eng, s, codes, tables = _engine(engine, pulled)
    base, n = 8 * BLOCK, 2
    ref_state, ref = eng.superblock_ring_i8(s, torch.from_numpy(ring), base,
                                            n, tables)
    width = eng.block_samples + eng.overlap
    planes = torch.from_numpy(ring.astype(np.float32))
    blocks = torch.stack([planes[:, base + b * eng.block_samples:][:, :width]
                          for b in range(n)], 1)
    if path == "superblock_step":
        st, out = eng.superblock_step(s, blocks[0].contiguous(),
                                      blocks[1].contiguous(), codes)
        packed = out["packed"]
    else:
        st, rows = s, []
        for b in range(n):
            st, out = eng.process_block(st, blocks[0, b].contiguous(),
                                        blocks[1, b].contiguous(), codes)
            rows.append(out["packed"])
        packed = torch.stack(rows)
    assert torch.equal(packed, ref["packed"])
    for name, a, b in zip(type(st)._fields, st, ref_state):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("call", ["scan-process_block", "scan-superblock_step",
                                  "scan-ring", "fast-process_block",
                                  "fast-ring"])
def test_entry_points_refuse_blocks_of_the_wrong_size(call, ring, pulled):
    kind, entry = call.split("-", 1)
    eng, s, codes, tables = _engine(kind, pulled)
    r = torch.from_numpy(ring)
    short = torch.zeros(eng.block_samples, dtype=torch.float32)
    with pytest.raises(ValueError):
        if entry == "process_block":
            eng.process_block(s, short, short, codes)
        elif entry == "superblock_step":
            eng.superblock_step(s, short[None], short[None], codes)
        else:
            eng.superblock_ring_i8(s, r, r.shape[1] - BLOCK, 1, tables)


# -- the segmented-sum fast engine (K1-seg) -------------------------------------

SEG_CASES = {"l1": (KW, 1),
             "e1-pilot": (dict(E1_KW, extend_correlation_symbols=25,
                               track_pilot=True), 25)}


@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segsum_engine_state_struct_and_tables(case):
    """A segsum engine hands K1-loop the same state as the bank engine
    (``state_spec`` names every field of its fresh and handed-over
    states; the pointer structure points at each) and, from ``get_bank``,
    the raw code tables [C, 1 (+ the data code), table_len] (JAX passes
    them unbanked), which the wrapper's check accepts; a bank is
    refused."""
    kw, sec = SEG_CASES[case]
    cfg = TrackingConfig(**kw)
    fast = FastTrackingEngine(cfg, 3, 2, correlator="segsum",
                              sec_max_len=sec, device="cpu")
    scan = TrackingEngine(cfg, 3, 80000, device="cpu")
    spec = kfl.state_spec(fast)
    rng = np.random.default_rng(3)
    for state in (fast.init_state(), fast.from_track_state(
            scan.init_state())):
        for name, t in zip(type(state)._fields, state):
            dtype, trailing = spec[name]
            assert (t.dtype, tuple(t.shape)) == (dtype, (3, *trailing)), name
        filled = _random_state(state, rng)
        struct, _ = kb.state_pointers(filled, spec, 3, CPU, "fast")
        for name, t in zip(type(filled)._fields, filled):
            raw = (ctypes.c_ubyte * (t.numel() * t.element_size())
                   ).from_address(getattr(struct, name))
            np.testing.assert_array_equal(np.frombuffer(
                bytes(raw), dtype=t.numpy().dtype).reshape(t.shape),
                t.numpy(), err_msg=name)
    q = fast.table_len
    codes = torch.from_numpy(rng.standard_normal((3, q)).astype(np.float32))
    data = torch.from_numpy(rng.standard_normal((3, q)).astype(np.float32))
    tables = fast.get_bank(codes, data if fast.track_pilot else None)
    want = [codes] + ([data] if fast.track_pilot else [])
    assert torch.equal(tables, torch.stack(want, 1))
    kfl.check_tables(fast, tables, CPU)
    bank = torch.zeros((3, fast.BANK_PHASES + 1, fast.n_taps, fast.win_len))
    with pytest.raises(ValueError, match="code tables"):
        kfl.check_tables(fast, bank, CPU)
    assert fast.overlap == fast.k * cfg.samples_per_code + fast.max_period


def _seg_records_match(pj, pt, k, first_scale):
    """The JAX suite's tolerances between two packed records, and each
    first-group period correlation within 1e-5 of ``first_scale`` [C],
    the group's prompt magnitude."""
    np.testing.assert_array_equal(pj[..., 5 * k + 2:], pt[..., 5 * k + 2:])
    assert np.max(np.abs(_boundaries(pj[..., :k], pj[..., k:2 * k])
                         - _boundaries(pt[..., :k], pt[..., k:2 * k]))) < 0.02
    np.testing.assert_allclose(np.abs(pt[..., 2 * k:3 * k]),
                               np.abs(pj[..., 2 * k:3 * k]), rtol=0.02,
                               atol=1e-3 * np.abs(pj[..., 2 * k:3 * k]).max())
    assert np.max(np.abs(pj[..., 5 * k] - pt[..., 5 * k])) < 1.0
    assert np.max(np.abs(pj[..., 5 * k + 1] - pt[..., 5 * k + 1])) < 1.0
    err = np.max(np.abs(pj[0, 0, :, 2 * k:5 * k] - pt[0, 0, :, 2 * k:5 * k]),
                 axis=1)
    assert np.all(err <= 1e-5 * first_scale), (err, first_scale)


def _group_prompt(p, k):
    """|sum of the first group's period prompts| [C] from a record whose
    columns 2K.. hold the prompt's re and 4K.. its im (a record without a
    data prompt)."""
    return np.abs(np.sum(p[0, 0][:, 2 * k:3 * k]
                         + 1j * p[0, 0][:, 4 * k:5 * k], axis=1))


def _e1_pilot_ring(n, chans, seed):
    """int8 planar ring at 4 Msps: per channel (PRN, delay, Doppler) one
    Galileo E1 signal (E1-B with a random symbol a period minus the
    CS25-signed E1-C, over sqrt 2) plus noise."""
    from gnss_sdr_tpu.codes.galileo_e1 import (E1C_SECONDARY,
                                               galileo_e1_subchips)

    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 8.0
    cs = np.array([1.0 if c == "0" else -1.0 for c in E1C_SECONDARY])
    for prn, delay, dopp in chans:
        sub = np.floor((t - delay) * 1.023e6 * 12 / 4e6).astype(np.int64)
        per = sub // 49104
        sym = np.sign(rng.standard_normal(per.max() - per.min() + 1))
        e = (galileo_e1_subchips(prn, "B", True)[sub % 49104]
             * sym[per - per.min()]
             - galileo_e1_subchips(prn, "C", True)[sub % 49104]
             * cs[per % 25]) / np.sqrt(2.0)
        x = x + 3.0 * e * np.exp(2j * np.pi * dopp * t / 4e6)
    return np.stack([np.clip(x.real, -127, 127).astype(np.int8),
                     np.clip(x.imag, -127, 127).astype(np.int8)])


def test_fast_segsum_superblock_matches_jax(ring, monkeypatch):
    """A 2-block L1 superblock of the segsum engine from a pulled-in
    state: one ``_blocks_stepwise`` call on the CPU, and the JAX segsum
    engine's records and end state within the JAX suite's tolerances."""
    eng, s, codes = _pulled_in(ring)
    fast = FastTrackingEngine(TrackingConfig(**KW), 2, 2,
                              correlator="segsum", device="cpu")
    fs = fast.from_track_state(s)
    calls = _spy(monkeypatch, FastTrackingEngine)
    base = 8 * BLOCK
    ts, out = fast.superblock_ring_i8(fs, torch.from_numpy(ring), base, 2,
                                      fast.get_bank(codes))
    assert calls == [2]
    jf = JFast(JConfig(**KW), 2, 2, correlator="segsum")
    js = JFastState(**{k: jnp.asarray(v)
                       for k, v in convert.state_numpy(fs).items()})
    js, jout = jf._superblock_ring_i8(js, jnp.asarray(ring), jnp.int32(base),
                                      2, jnp.asarray(codes.numpy()))
    pj, pt = np.asarray(jout["packed"]), out["packed"].numpy()
    k = fast.k
    assert pj.shape == pt.shape == (2, 2, 2, 5 * k + 4)
    assert (pt[..., 5 * k + 2] > 0.5).all()
    _seg_records_match(pj, pt, k, _group_prompt(pj, k))
    jd = convert.field_dict(js)
    np.testing.assert_array_equal(jd["offset"], ts.offset.numpy())
    assert np.max(np.abs(jd["carrier_doppler_hz"]
                         - ts.carrier_doppler_hz.numpy())) < 1.0


def test_fast_segsum_e1_pilot_group_matches_jax():
    """One E1 pilot group (K = 25 on the E1-C code with CS25 wiped off,
    VEML, the E1-B data prompt from the prompt tap's chip sums) of the
    segsum engine against the JAX segsum engine from the same state:
    every period's pilot and data prompts within 1e-5 of the group's
    prompt magnitude, the record and end state within the suite's
    tolerances."""
    from gnss_sdr_tpu.codes.galileo_e1 import (E1C_SECONDARY,
                                               galileo_e1_subchips)

    kw = dict(E1_KW, extend_correlation_symbols=25, track_pilot=True)
    # one channel: the plain version's [C, T, 25 x 49104 + 3] boundary
    # arrays (and JAX's) hold ~0.2 GB a channel
    chans = [(12, 11002.7, -2320.0)]
    fast = FastTrackingEngine(TrackingConfig(**kw), 1, 1,
                              correlator="segsum", sec_max_len=25,
                              device="cpu")
    ring = _e1_pilot_ring(fast.block_samples + fast.overlap + 16000, chans,
                          41)
    s = fast.init_state()
    for ch, (_, delay, dopp) in enumerate(chans):
        s = fast.start_channel(s, ch, dopp, int(np.ceil(delay)))
        s = fast.set_secondary(s, ch, E1C_SECONDARY, 0)
    s = s._replace(rem_code_phase_samples=torch.tensor(
        [np.ceil(d) - d for _, d, _ in chans], dtype=torch.float32))

    def tables(comp):
        return np.stack([galileo_e1_subchips(p, comp, True)
                         for p, _, _ in chans]).astype(np.float32)

    codes, dcodes = tables("C"), tables("B")
    src = torch.from_numpy(ring)
    ts, packed, pre, pim = kfl.fast_loop(
        fast, s, src[0], src[1], 0, fast.block_samples, 1,
        fast.get_bank(torch.from_numpy(codes), torch.from_numpy(dcodes)))
    jf = JFast(JConfig(**kw), 1, 1, correlator="segsum", sec_max_len=25)
    js = JFastState(**{k: jnp.asarray(v)
                       for k, v in convert.state_numpy(s).items()})
    js, jout = jf._superblock_ring_i8(js, jnp.asarray(ring), jnp.int32(0), 1,
                                      jnp.asarray(codes), jnp.asarray(dcodes))
    pj, pt = np.asarray(jout["packed"]), packed.numpy()
    k = fast.k
    assert pj.shape == pt.shape == (1, 1, 1, 5 * k + 4)
    assert (pt[..., 5 * k + 2] > 0.5).all()
    group = np.hypot(pre.numpy()[0, 0], pim.numpy()[0, 0])
    assert np.all(group > 0)
    _seg_records_match(pj, pt, k, group)
    jd = convert.field_dict(js)
    np.testing.assert_array_equal(jd["offset"], ts.offset.numpy())
    np.testing.assert_array_equal(jd["sec_phase"], ts.sec_phase.numpy())
    assert np.max(np.abs(jd["carrier_doppler_hz"]
                         - ts.carrier_doppler_hz.numpy())) < 1.0
