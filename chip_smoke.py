#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the receiver on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every CUDA kernel of the main path from ``gnss_sdr_tpu_torch/
   kernels/csrc`` (one ``nvcc`` per source, all started together).
3. Kernel phase: at the main path's shapes (4 Msps, 8 channels, K = 20,
   32 PRNs x 40 Doppler bins) holds each kernel against its plain PyTorch
   version on the same seeded inputs, and times kernel, plain version and
   (where one exists) a single PyTorch library call with CUDA events.
4. Slice phase: builds the production GPS L1 C/A receiver through
   ``make_receiver`` from an INI with the factory defaults (4 Msps, 8
   channels, K = 20), runs it over a generated 12 s scene of 8 satellites
   at 45 dB-Hz with assisted ephemerides, and checks fast mode, the
   handoff time, the fix count and the position error against the truth.
   Every kernel counter is set to 0 just before the run and read just
   after it; a kernel of the path that never launched fails the run.
5. Prints one ``{"kernels": [...]}`` line, one ``{"slice": ...}`` line
   and, last, ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. The script imports
neither JAX nor the JAX package. Without CUDA, or without the package
beside it, it exits with code 1 and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

TOL = {"bank_corr": 1e-4, "multicorr": 1e-3, "acq_wipeoff": 1e-4,
       "acq_product": 1e-4, "acq_accum": 1e-4, "acq_stats": 1e-4}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    tb = n_bytes / PEAK_BYTES_S * 1e3
    to = n_ops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(torch, fn, reps: int = 50) -> float:
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls, timed
    with CUDA events after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(torch, fn, reps: int = 20):
    """(wall ms per call, device ms per call, {kernel name: device us per
    launch}) of ``fn`` under ``torch.profiler``; device figures are None
    when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = {}
    total = 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            total += us
            kernels[evt.key] = (us / max(1, evt.count), evt.count)
    if total <= 0:
        return wall, None, {}
    return wall, total / 1e3 / reps, kernels


def kernel_device_us(torch, fn, kernel_symbol: str):
    """Device time per launch of the CUDA kernel whose symbol contains
    ``kernel_symbol``, from the profiler; None if it saw none."""
    _, _, kernels = profile(torch, fn)
    hits = [v for k, v in kernels.items() if kernel_symbol in k]
    if not hits:
        return None
    us = sum(u * n for u, n in hits)
    n = sum(n for _, n in hits)
    return us / n


def rel_err(torch, got, want) -> float:
    scale = float(torch.max(torch.abs(want)))
    return float(torch.max(torch.abs(got - want))) / (scale or 1.0)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def synthetic_ring(np, rng, n: int, chans):
    """int8 planar ring of ``n`` samples holding one C/A signal per
    channel (code phase, Doppler) plus noise, quantized like the ingest."""
    from gnss_sdr_tpu_torch.codes import gps_l1ca_code

    fs = 4e6
    t = np.arange(n, dtype=np.float64)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 8.0
    for prn, delay, dopp in chans:
        code = gps_l1ca_code(prn).astype(np.float64)
        chip = np.floor((t - delay) * 1.023e6 / fs).astype(np.int64) % 1023
        x = x + 3.0 * code[chip] * np.exp(2j * np.pi * dopp * t / fs)
    re = np.clip(x.real, -127, 127).astype(np.int8)
    im = np.clip(x.imag, -127, 127).astype(np.int8)
    return np.stack([re, im])


def check_k3(torch, np, rng):
    from gnss_sdr_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_tpu_torch.kernels import multicorr as k3
    from gnss_sdr_tpu_torch.tracking.engine import (TrackingConfig,
                                                    TrackingEngine)

    dev = torch.device("cuda")
    cfg = TrackingConfig(fs=4e6, extend_correlation_symbols=20)
    c = 8
    eng = TrackingEngine(cfg, c, 80000, device=dev)
    prns = list(range(1, c + 1))
    delays = rng.uniform(0, 4000, c)
    dopps = rng.uniform(-4500, 4500, c)
    ring = torch.as_tensor(synthetic_ring(
        np, rng, 10 * 80000 + eng.overlap, list(zip(prns, delays, dopps))),
        device=dev)
    s = eng.init_state()
    for ch in range(c):
        off = int(np.ceil(delays[ch])) % 4000
        s = eng.start_channel(s, ch, float(dopps[ch]), off, 4000)
    # a realistic remnant state: sub-sample code phase, carrier phase
    s = s._replace(
        rem_code_phase_chips=torch.as_tensor(
            rng.uniform(0, 0.25, c).astype(np.float32), device=dev),
        rem_carr_phase_rad=torch.as_tensor(
            rng.uniform(0, 6.28, c).astype(np.float32), device=dev),
        cur_len=torch.as_tensor(rng.integers(3999, 4002, c).astype(np.int32),
                                device=dev))
    codes = torch.as_tensor(np.stack([gps_l1ca_code(p) for p in prns])
                            .astype(np.float32), device=dev)
    base = 3 * 80000
    start = eng.window_start(s)
    args = (ring[0], ring[1], base, start, s.cur_len, codes, eng._shifts,
            s.rem_code_phase_chips, s.code_phase_step_chips,
            s.rem_carr_phase_rad, s.carrier_phase_step_rad, eng.max_period,
            eng._n_extra)
    got_re, got_im = k3.multicorr(*args)
    want_re, want_im = k3.multicorr_plain(*args)
    torch.cuda.synchronize()
    prompt = torch.sqrt(want_re[:, 1] ** 2 + want_im[:, 1] ** 2)
    err = float(torch.max(torch.maximum(
        torch.abs(got_re - want_re), torch.abs(got_im - want_im))
        / prompt[:, None]))
    n_valid = int(torch.sum(torch.clamp(s.cur_len, max=eng.max_period)))
    t = cfg.n_taps
    nb = n_valid * 2 + c * 1023 * 4 + c * (6 * 4) + c * t * 8
    no = n_valid * (8 + 4 * t)
    b, by = bound_ms(nb, no)
    return dict(name="multicorr", route="cuda",
                source="gnss_sdr_tpu_torch/kernels/csrc/multicorr.cu",
                replaces="gnss_sdr_tpu/ops/correlator.py:33",
                max_abs_err=float(torch.max(torch.abs(got_re - want_re))),
                rel_err=err, tol=TOL["multicorr"],
                ms=time_ms(torch, lambda: k3.multicorr(*args)),
                device_us=kernel_device_us(torch, lambda: k3.multicorr(*args),
                                           "multicorr_kernel"),
                plain_ms=time_ms(torch, lambda: k3.multicorr_plain(*args)),
                bound_ms=b, bound_by=by, library_ms=None,
                shape=f"C={c} T={t} L={eng.max_period} int8 ring")


def check_k1(torch, np, rng):
    from gnss_sdr_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_tpu_torch.kernels import bank_corr as k1
    from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig
    from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

    dev = torch.device("cuda")
    cfg = TrackingConfig(fs=4e6, extend_correlation_symbols=20)
    c = 8
    fe = FastTrackingEngine(cfg, c, 5, device=dev)
    prns = list(range(11, 11 + c))
    delays = rng.uniform(0, 4000, c)
    dopps = rng.uniform(-4500, 4500, c)
    ring = torch.as_tensor(synthetic_ring(
        np, rng, 3 * fe.block_samples + fe.overlap,
        list(zip(prns, delays, dopps))), device=dev)
    s = fe.init_state()
    for ch in range(c):
        s = fe.start_channel(s, ch, float(dopps[ch]),
                             int(np.ceil(delays[ch])) % 4000)
    s = s._replace(
        rem_code_phase_samples=torch.as_tensor(
            rng.uniform(0, 1, c).astype(np.float32), device=dev),
        rem_carr_phase_rad=torch.as_tensor(
            rng.uniform(0, 6.28, c).astype(np.float32), device=dev),
        code_doppler_chips=torch.as_tensor(
            (dopps / 1540.0).astype(np.float32), device=dev))
    codes = torch.as_tensor(np.stack([gps_l1ca_code(p) for p in prns])
                            .astype(np.float32), device=dev)
    bank = fe.get_bank(codes)
    q = fe.group_inputs(s)
    base = fe.block_samples
    args = (ring[0], ring[1], base, q["win_start"], q["ph0"], q["step"], bank,
            q["j0"], q["w"], fe.n_eff)
    got_re, got_im = k1.bank_corr(*args)
    want_re, want_im = k1.bank_corr_plain(*args)
    torch.cuda.synchronize()
    prompt = torch.sqrt(want_re[..., 1] ** 2 + want_im[..., 1] ** 2)
    err = float(torch.max(torch.maximum(
        torch.abs(got_re - want_re), torch.abs(got_im - want_im))
        / prompt[..., None]))
    k, t, n = fe.k, cfg.n_taps, fe.n_eff
    rows = torch.unique(torch.cat([
        q["j0"] + 17 * torch.arange(c, device=dev)[:, None],
        q["j0"] + 1 + 17 * torch.arange(c, device=dev)[:, None]]))
    nb = c * k * n * 2 + int(rows.numel()) * t * n * 4 + c * k * (4 * 4) \
        + c * k * t * 8
    no = c * k * n * (8 + 8 * t) + c * k * t * 6
    b, by = bound_ms(nb, no)
    # the TPU formulation for comparison: one einsum of pre-rotated
    # windows against all 17 bank rows
    idx = (base + q["win_start"].to(torch.int64))[..., None] \
        + torch.arange(fe.win_len, device=dev)
    rot = ring[0][idx].to(torch.float32)
    einsum_ms = time_ms(torch, lambda: torch.einsum("ckl,cptl->ckpt", rot,
                                                    bank))
    return dict(name="bank_corr", route="cuda",
                source="gnss_sdr_tpu_torch/kernels/csrc/bank_corr.cu",
                replaces="gnss_sdr_tpu/tracking/fast_engine.py:683",
                max_abs_err=float(torch.max(torch.abs(got_re - want_re))),
                rel_err=err, tol=TOL["bank_corr"],
                ms=time_ms(torch, lambda: k1.bank_corr(*args)),
                device_us=kernel_device_us(torch,
                                           lambda: k1.bank_corr(*args),
                                           "bank_corr_kernel"),
                plain_ms=time_ms(torch, lambda: k1.bank_corr_plain(*args)),
                bound_ms=b, bound_by=by, library_ms=None,
                einsum_all_rows_ms=einsum_ms,
                shape=f"C={c} K={k} T={t} n_eff={n} W={fe.win_len}")


def check_k2(torch, np, rng, prns):
    """K2 at the main path's shapes: the receiver's acquisition engine
    searches the PRNs of ``Channels_1C.satellites`` (P = 8) over 40
    Doppler bins of a 4000-sample dwell."""
    from gnss_sdr_tpu_torch.acquisition.adapters import \
        make_gps_l1ca_acquisition
    from gnss_sdr_tpu_torch.kernels import acq

    dev = torch.device("cuda")
    fs = SCENE["fs"]
    eng = make_gps_l1ca_acquisition(sorted(prns), fs,
                                    doppler_max=5000.0, doppler_step=250.0,
                                    max_dwells=2, device=dev)
    cfg = eng.cfg
    n = cfg.fft_size
    ring = synthetic_ring(np, rng, 2 * n, [(prns[0], 1234.0, 2130.0),
                                           (prns[3], 321.0, -3010.0)])
    xs = [torch.as_tensor((ring[0, i * n:(i + 1) * n].astype(np.float32)
                           + 1j * ring[1, i * n:(i + 1) * n]
                           .astype(np.float32)).astype(np.complex64),
                          device=dev) for i in range(2)]
    code_fft, dop, c0 = eng._code_fft, eng._dopplers, eng._c0
    p, d, eff, off = code_fft.shape[0], dop.shape[0], eng._eff, eng._offset
    out = []

    def entry(name, got, want, ms, plain_ms, nb, no, library_ms=None,
              err=None, replaces="gnss_sdr_tpu/acquisition/pcps.py:157",
              device_us=None):
        b, by = bound_ms(nb, no)
        e = rel_err(torch, got, want) if err is None else err
        out.append(dict(
            name=name, route="cuda",
            source="gnss_sdr_tpu_torch/kernels/csrc/acq.cu",
            replaces=replaces,
            max_abs_err=float(torch.max(torch.abs(got - want))),
            rel_err=e, tol=TOL[name], ms=ms, device_us=device_us,
            plain_ms=plain_ms, bound_ms=b,
            bound_by=by, library_ms=library_ms,
            shape=f"P={p} D={d} N={n} eff={eff}"))

    wk = acq.acq_wipeoff(xs[0], dop, c0)
    wp = acq.acq_wipeoff_plain(xs[0], dop, c0)
    entry("acq_wipeoff", torch.view_as_real(wk), torch.view_as_real(wp),
          time_ms(torch, lambda: acq.acq_wipeoff(xs[0], dop, c0)),
          time_ms(torch, lambda: acq.acq_wipeoff_plain(xs[0], dop, c0)),
          n * 8 + d * 4 + d * n * 8, d * n * 8,
          device_us=kernel_device_us(
              torch, lambda: acq.acq_wipeoff(xs[0], dop, c0),
              "wipeoff_kernel"))
    spec = torch.fft.fft(wp, dim=-1)
    pk = acq.acq_product(spec, code_fft)
    pp = acq.acq_product_plain(spec, code_fft)
    entry("acq_product", torch.view_as_real(pk), torch.view_as_real(pp),
          time_ms(torch, lambda: acq.acq_product(spec, code_fft)),
          time_ms(torch, lambda: acq.acq_product_plain(spec, code_fft)),
          d * n * 8 + p * n * 8 + p * d * n * 8, p * d * n * 6,
          library_ms=time_ms(torch, lambda: spec[None] * code_fft[:, None]),
          device_us=kernel_device_us(
              torch, lambda: acq.acq_product(spec, code_fft),
              "product_kernel"))
    corrs = []
    for x in xs:
        sp = torch.fft.fft(acq.acq_wipeoff_plain(x, dop, c0), dim=-1)
        corrs.append(torch.fft.ifft(acq.acq_product_plain(sp, code_fft),
                                    dim=-1))
    g1k, _, _ = acq.acq_accum(corrs[0], None, off, eff)
    g1p, _, _ = acq.acq_accum_plain(corrs[0], None, off, eff)
    g2k, rmk, rak = acq.acq_accum(corrs[1], g1k.clone(), off, eff)
    g2p, rmp, rap = acq.acq_accum_plain(corrs[1], g1p, off, eff)
    torch.cuda.synchronize()
    if not torch.equal(rak, rap):
        fail("acq_accum row argmax differs from the plain version")
    g_scratch = g1k.clone()
    entry("acq_accum", g2k, g2p,
          time_ms(torch, lambda: acq.acq_accum(corrs[1], g_scratch, off,
                                               eff)),
          time_ms(torch, lambda: acq.acq_accum_plain(corrs[1], g1p, off,
                                                     eff)),
          p * d * eff * (8 + 4 + 4) + p * d * 8, p * d * eff * 5,
          device_us=kernel_device_us(
              torch, lambda: acq.acq_accum(corrs[1], g_scratch, off, eff),
              "accum_kernel"))
    errs = []
    for use_cfar in (True, False):
        sk = acq.acq_stats(g2p, rmp, rap, 2, cfg.samples_per_chip, use_cfar)
        sp_ = acq.acq_stats_plain(g2p, rmp, rap, 2, cfg.samples_per_chip,
                                  use_cfar)
        torch.cuda.synchronize()
        if not (torch.equal(sk[1], sp_[1]) and torch.equal(sk[2], sp_[2])):
            fail(f"acq_stats argmax differs (use_cfar={use_cfar})")
        errs.append(float(torch.max(torch.abs(sk[0] - sp_[0]) / sp_[0])))
    entry("acq_stats", sk[0], sp_[0],
          time_ms(torch, lambda: acq.acq_stats(g2p, rmp, rap, 2,
                                               cfg.samples_per_chip, True)),
          time_ms(torch, lambda: acq.acq_stats_plain(
              g2p, rmp, rap, 2, cfg.samples_per_chip, True)),
          p * d * 8 + p * eff * 4 + p * 12, p * d + p * eff * 2,
          err=max(errs), replaces="gnss_sdr_tpu/acquisition/pcps.py:190",
          device_us=kernel_device_us(
              torch, lambda: acq.acq_stats(g2p, rmp, rap, 2,
                                           cfg.samples_per_chip, True),
              "stats_kernel"))
    return out


def kernel_phase(torch, np, prns):
    rng = np.random.default_rng(2024)
    res = [check_k1(torch, np, rng), check_k3(torch, np, rng)]
    res.extend(check_k2(torch, np, rng, prns))
    for r in res:
        dev_us = "n/a" if r["device_us"] is None else f"{r['device_us']:.2f}"
        print(f"chip_smoke: {r['name']}: rel err {r['rel_err']:.3g} "
              f"(tol {r['tol']}), {r['ms'] * 1e3:.2f} us/call, "
              f"{dev_us} us on the device, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} "
              f"us ({r['bound_by']})", file=sys.stderr, flush=True)
        if not r["rel_err"] <= r["tol"]:
            fail(f"{r['name']} disagrees with its plain version: "
                 f"{r['rel_err']} > {r['tol']}")
    return res


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

SCENE = dict(fs=4e6, n_sats=8, duration_s=12.0, cn0_db_hz=45.0, seed=1,
             toe_s=7200.0, bits_start_tow_s=7200.0 + 598 * 6.0)


def scene_geometry():
    """(ephemerides, the first ``n_sats`` visible PRNs, receiver position,
    scene start) of the slice's scene."""
    from gnss_sdr_tpu_torch.simulate.scenario import (make_constellation,
                                                      rx_position,
                                                      visible_sats)

    p = SCENE
    t_start = p["bits_start_tow_s"] + 4.5
    rx = rx_position()
    ephs = make_constellation(range(1, 33), toe_s=p["toe_s"])
    prns = [int(v) for v in visible_sats(ephs, rx, t_start)[:p["n_sats"]]]
    if len(prns) < p["n_sats"]:
        fail(f"only {len(prns)} visible satellites in the scene")
    return ephs, prns, rx, t_start


def scene(np, build_dir):
    """The slice's scene, generated once per checkout and cached under the
    (git-ignored) build directory, keyed by its parameters."""
    from gnss_sdr_tpu_torch.simulate.rf_scene import generate_scene

    p = SCENE
    ephs, prns, rx, t_start = scene_geometry()
    key = hashlib.sha1(json.dumps([p, prns],
                                  sort_keys=True).encode()).hexdigest()[:16]
    cache = os.path.join(build_dir, "scene_cache", f"l1ca-{key}.npy")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        x = np.load(cache)
    else:
        x = generate_scene(ephs, prns, rx, t_start, p["duration_s"], p["fs"],
                           bits_start_tow_s=p["bits_start_tow_s"],
                           n_subframes=4, cn0_db_hz=p["cn0_db_hz"],
                           seed=p["seed"])
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.save(cache + ".tmp.npy", x)
        os.replace(cache + ".tmp.npy", cache)
    return x, ephs, prns, rx, time.perf_counter() - t0


def slice_phase(torch, np, build_dir, card):
    from gnss_sdr_tpu_torch.config import FileConfiguration
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.receiver.assistance import save_ephemeris_xml
    from gnss_sdr_tpu_torch.receiver.factory import make_receiver

    x, ephs, prns, rx, scene_s = scene(np, build_dir)
    fs = SCENE["fs"]
    xml = save_ephemeris_xml({p: ephs[p] for p in prns},
                             os.path.join(build_dir, "gps_ephemeris.xml"))
    conf = os.path.join(build_dir, "rx.conf")
    with open(conf, "w") as fh:
        fh.write("\n".join([
            "GNSS-SDR.internal_fs_sps=4000000",
            "Channels_1C.count=8",
            "Channels_1C.satellites=" + ",".join(str(p) for p in prns),
            "Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition",
            "Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking",
            "TelemetryDecoder_1C.implementation=GPS_L1_CA_Telemetry_Decoder",
            "Observables.implementation=Hybrid_Observables",
            "PVT.implementation=RTKLIB_PVT",
            f"GNSS-SDR.AGNSS_gps_ephemeris_xml={xml}", ""]))
    rec = make_receiver(FileConfiguration(conf))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    sols = rec.run(x)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    if not rec.in_fast_mode:
        fail("the receiver never handed off to the fast engine")
    handoff_s = rec.handoff_sample / fs
    if not handoff_s < 4.0:
        fail(f"handoff at {handoff_s} s, not before 4 s")
    if len(sols) < 5:
        fail(f"{len(sols)} fixes, fewer than 5")
    tail = sols[len(sols) // 2:]
    errs = [float(np.linalg.norm(s.pos_ecef - rx)) for s in tail]
    mean_err = float(np.mean(errs))
    if not (np.isfinite(mean_err) and mean_err < 5.0):
        fail(f"mean 3-D error {mean_err} m over the second half")
    tm = dict(rec.timings)
    signal_s = len(x) / fs
    phases = profile_phases(torch, rec)
    result = dict(
        fixes=len(sols), mean_err_m=mean_err, max_err_m=float(max(errs)),
        handoff_s=handoff_s, timings=tm,
        rtf_phase_a=(tm["phase_a_samples"] / fs) / tm["phase_a_s"],
        rtf_phase_b=(tm["phase_b_samples"] / fs) / tm["phase_b_s"],
        rtf_total=signal_s / run_s, run_s=run_s, signal_s=signal_s,
        scene_s=scene_s, channels=8, fs=fs, prns=prns,
        profile=phases, card=card)
    return result, launches


def profile_phases(torch, rec):
    """After the main path's run (its launch counts already read): one
    more phase-A superblock (10 scan blocks, acquisition excluded) and
    one more phase-B superblock (10 fast blocks), each under the
    profiler, for the host wall time, the device time and the share of
    the wall time the device was busy."""
    out = {}
    trk = rec.receiver.tracking
    ring = rec._ring
    base = 0

    def phase_a():
        trk.engine.superblock_ring_i8(trk.state, ring, base, 10,
                                      trk._code_tables_dev)[1]["packed"].cpu()

    def phase_b():
        bank = rec.fast.get_bank(rec._fast_codes)
        rec.fast.superblock_ring_i8(rec.fast_state, ring, base, 10,
                                    bank)[1]["packed"].cpu()

    for name, fn in (("phase_a_superblock", phase_a),
                     ("phase_b_superblock", phase_b)):
        wall, dev, kernels = profile(torch, fn, reps=2)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0] * kv[1][1])
        out[name] = dict(
            wall_ms=wall, device_ms=dev,
            busy_share=None if dev is None else dev / wall,
            top_kernels=[dict(name=k[:60], us_per_launch=u, launches=n / 2)
                         for k, (u, n) in top[:6]])
    return out


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a GPU")
    if not os.path.isdir(os.path.join(ROOT, "gnss_sdr_tpu_torch")):
        fail("gnss_sdr_tpu_torch is not beside this script; run it from "
             "the root of a checkout")
    from gnss_sdr_tpu_torch.kernels import build as kbuild

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = kbuild.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"chip_smoke: built {name}.cu: {'; '.join(regs)}",
              file=sys.stderr, flush=True)
    print(f"chip_smoke: kernels built in {build_s:.1f} s", file=sys.stderr,
          flush=True)

    res = kernel_phase(torch, np, scene_geometry()[1])
    slice_res, launches = slice_phase(torch, np, kbuild.BUILD_DIR, card)
    for r in res:
        r["launches"] = launches.get(r["name"], 0)
        r["card"] = card
    print(json.dumps({"kernels": res, "build_s": build_s}), flush=True)
    print(json.dumps({"slice": slice_res}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
