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
   after it; a kernel of the path that never launched fails the run. The
   engines run on the fused kernels, K3-loop (``scan_loop``) and K1-loop
   (``fast_loop``), one launch per superblock (checked against the
   engine calls logged during the run); K3 and K1 run inside them.
5. Conditioned phase: the scene upsampled to an 8 Msps front-end capture
   (12 s, 96 M samples; the empty outer half of the band filled with
   seeded white noise) becomes three configs, each run from an INI
   through ``make_signal_source`` -> ``make_signal_conditioner(...)
   .apply`` -> ``make_receiver(...).run`` with the slice's checks and the
   counters read around it: A at IF 1.5 MHz through
   ``Freq_Xlating_Fir_Filter`` (65 taps, D = 2); B with DME-like pulse
   pairs through ``Pulse_Blanking_Filter`` + ``Mmse_Resampler``; C with a
   CW tone through ``Notch_Filter`` + ``Direct_Resampler``. Each config's
   conditioner kernels (K7a-K7d) are held against their plain versions on
   its capture (K7a also timed with the translation off; K7c timed in
   place, the form ``notch_filter_block`` runs, and into a new tensor).
   Then 3 s of A stream through the CLI's streaming branch
   (a FIFO source, ``apply_stream``, the scan receiver), held against
   the one-shot output.
6. Galileo E1 kernel phase: K1 at the E1 band's fast-engine shapes
   (the pilot at K = 25 with the E1-B data bank as a sixth tap; E1-B
   alone at K = 1), K3 on the CBOC sub-chip tables (T = 5 pilot taps, the
   T = 1 data prompt) and K2 on 4 ms dwells (N = 16000, 80 bins of
   125 Hz), each against its plain version.
7. Multi-band phase: the slice's scene plus eight Galileo E1 signals
   (pilot and data, 45 dB-Hz total; the first seven visible on eight
   channels) through the multi-band production
   receiver built by ``make_receiver`` from an INI with ``Channels_1C``
   and ``Channels_1B`` (``Tracking_1B.track_pilot=true``): fast mode,
   handoff before 4 s, K = 25 on E1, >= 6 of 8 E1 channels secondary-
   locked, >= 5 fixes, the last third's mean error under 5 m, >= 12
   satellites in the last fix, and every kernel of the path launched.
Steps 8 and 9 run right after step 6, before the slices (they generate
and cache the scenes the slices then load):

8. Acquisition variants (``acq_variants_phase``): K5a (QuickSync's
   folding wipe-off) and K5b (CCCWSR's sign-recovery combine) against
   their plain versions at the searches' shapes, then, through
   ``make_acquisition`` on the card, QuickSync and Tong over PRNs 1-32
   on the first milliseconds of the L1 scene, CCCWSR, QuickSync and Tong
   over PRNs 1-36 on the multi-band scene (E1) and the E5a noncoherent
   I/Q CAF search over PRNs 1-36 on a seeded 4 ms, 12 Msps capture with
   four satellites (K2 held against its plain version there): every
   visible satellite within 2 samples of its code delay and within the
   JAX tests' Doppler bound, a missed one searched again a quarter
   interval later up to 8 windows (E1 QuickSync and Tong, on E1-B
   alone: every satellite they detect at their own threshold, at least
   one, no absent PRN detected), every kernel of the searches launched.
9. Loop variants (``loop_variants_phase``): K6a (KF step) and K6b
   (Gaussian step) against their plain versions over 500 chained steps,
   then the L1 scene's 8 PRNs pulled in on a scan engine for 1 s from
   the truth and run to the end of the capture by four fast engines
   (``loop="fllpll"``, ``"kf"``, ``"gaussian"`` and
   ``correlator="segsum"``, K1-loop with the K1-seg body): no loss of
   lock, the last 10 groups' mean Doppler within 5 Hz of the truth, the
   last C/N0 within 5 dB of 45 dB-Hz, one launch per engine call and no
   call of the per-group path; the segsum engine against the bank
   engine within test_bank_vs_segsum_consistency's bounds on all 8
   channels (``bank_vs_segsum``).
10. Fused phase (``fused_loop_phase``, after step 7): K3-loop and
   K1-loop against their plain versions (the engines' per-step and
   per-group paths, ``_blocks_stepwise``: K3 / K1 / K6 and PyTorch) from
   states the receivers reached mid-run: the L1 slice's last phase-A
   superblock and its second phase-B superblock, the multi-band run's
   last ten E1 phase-A blocks (float32 planes, pilot + data prompt) and
   its second E1 phase-B superblock (K = 25, data tap, CS25). The first
   period's (group's) correlations must be equal to the bit, every
   record and the end state within the JAX suite's tolerances; both
   paths are timed with CUDA events. Each line carries its launch's
   thread-block cluster (``cluster_size`` blocks a channel and
   ``max_active_clusters``, cudaOccupancyMaxActiveClusters on this card)
   and ``serial_floor_us``: the channel's serial steps (periods, or
   groups x their rounds of periods) times the stand-alone K3's or K1's
   device time at the same shape. K1-loop's segmented-sum body
   (K1-seg) likewise, from the segsum run's second superblock and from
   the E1 band's second phase-B superblock rebuilt on a segsum engine,
   its first group within FIRST_SEG_TOL of the group prompt.
11. High dynamics and the beamformer, right after step 6: K3-hd
   (``multicorr`` with code and carrier rates) at the L1 and E1 scan
   widths, 10 g and 1000 g, each prompt against the signal's coherent
   sum and the kernel against its plain version (``hd_phase``); K7e
   through ``BeamformerFilter.steered(...).apply`` on a seeded 8-antenna
   capture of 1 s at 4 Msps with a 20 dB jammer, the JAX test's gain and
   null bounds, then the kernel against its plain version and
   ``torch.matmul`` (``beamformer_phase``).
12. Sharded path (``parallel_phase``, after step 10): on a logical mesh
   of four shards on the card, the L1 slice's and the E1 band's phase-B
   fast superblocks and the slice's last phase-A scan superblock with
   their channels split over the shards (``parallel/engines.py``), the
   PCPS grids at the L1 and E1 shapes split over their PRNs, the slice's
   12 s int8 ring cut into four time shards with K8a's halo (a fast
   superblock across a shard's end run on shard + halo) and K8b's sum of
   four E5a-sized dwell grids: one launch per K8 call and per shard,
   every result equal to the bit to one device's (the whole ring) or to
   the plain version, K8a and K8b timed against their plain versions and
   library calls; with two cards or more, again over the real cards.
13. Prints one ``{"kernels": [...]}`` line, one ``{"slice": ...}`` line,
   one ``{"multiband": ...}`` line, one ``{"conditioned": ...}`` line,
   one ``{"variants": ...}`` line, one ``{"high_dynamics": ...,
   "beamformer": ...}`` line, one ``{"parallel": ...}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. The script imports
neither JAX nor the JAX package. Without CUDA, or without the package
beside it, it exits with code 1 and prints no result.
"""

from __future__ import annotations

import argparse
import functools
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
       # K2b does the plain version's float32 operations exactly
       "acq_product": 0.0, "acq_accum": 1e-4, "acq_stats": 1e-4,
       # K7, relative to the rms of the plain output: K7a sums its taps in
       # the plain version's order with the same roundings; its NCO
       # rotates a float64 phasor between exact sincos, which moves a
       # phase by up to an ulp of step * n from the plain version's, so
       # cos and sin can differ by an ulp of float32;
       # K7b-d do the plain version's float32 arithmetic exactly
       "fir_decim": 1e-5, "pulse_blank": 0.0, "notch_mask": 0.0,
       "resample": 0.0,
       # K5 relative to the plain output's peak: the same float32
       # operations in the same order (the segments summed in order, no
       # contraction); only the sincosf of two libraries may differ by an
       # ulp
       "fold_wipeoff": 1e-4, "cccwsr_combine": 1e-4,
       # K6 over 500 chained steps, relative to each state column's scale
       # (x) and each channel's largest |P| entry (P): the same roundings
       # in the same order, fused multiply-adds where the plain version
       # fuses them
       "kf_step": 1e-5, "gaussian_step": 1e-5,
       # K3-hd relative to the prompt magnitude: the same float32 code
       # index and carrier phase (formed alike), sums in another order
       "multicorr_hd": 1e-4,
       # K7e relative to the output rms: M = 8 products summed in order
       # against the einsums' order
       "beamform": 1e-5}
#: kernels of the unconditioned slice (the production L1 receiver): K3
#: and K1 run there only inside K3-loop and K1-loop (their bodies are
#: inlined), so on the paths they launch only in the kernel phases and as
#: the fused kernels' oracle
SLICE_KERNELS = ("scan_loop", "fast_loop", "acq_wipeoff", "acq_product",
                 "acq_accum", "acq_stats")
#: the fused kernels against their plain versions (_blocks_stepwise), the
#: JAX suite's tolerances (tests/test_fast_engine.py:153-161): period
#: boundaries [samples], Doppler [Hz], C/N0 [dB-Hz], prompt magnitude
#: (relative)
FUSED_TOL = {"boundary": 0.02, "doppler": 1.0, "cn0": 1.0, "prompt": 0.02}
#: K1-seg's first group against the float64 sums of the same chips (the
#: plain version's boundaries and phases, ``segsum_corr(...,
#: torch.float64)``), relative to the group's prompt magnitude: the kernel
#: sums each chip's samples in float32 (~2e-7 of the prompt rehearsing its
#: code on the host). The plain version differences float32 prefix sums of
#: up to 400064 samples; its distance is reported, and held with the
#: records to FUSED_TOL
FIRST_SEG_TOL = 1e-5
#: which fused kernel runs each inlined kernel's body on the paths
INLINED = {"multicorr": "scan_loop", "bank_corr": "fast_loop",
           "kf_step": "fast_loop", "gaussian_step": "fast_loop"}


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


def library_device(torch, fn) -> dict:
    """The device time of a library call that launches each of its
    kernels once: the sum of their us a launch, and those kernels by
    name, from the profiler as for a hand kernel (a launch's mean, so a
    launch the profiler drops does not lower it; the line's
    ``library_ms`` includes the host)."""
    _, _, kernels = profile(torch, fn)
    return dict(library_device_us=sum(u for u, _ in kernels.values())
                if kernels else None,
                library_kernels={k: u for k, (u, _) in kernels.items()})


def event_us(torch, fn, reps: int = 10) -> float:
    """Median time of one call of ``fn`` in microseconds, CUDA events
    around a single call between two synchronizations: the device time
    plus the wrapper's host work between the events (tens of us)."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return sorted(times)[reps // 2]


def host_us(torch, steps: dict, reps: int = 1000) -> dict:
    """Median host microseconds of one call of each function in
    ``steps`` (name -> function): ``time.perf_counter_ns`` around single
    calls that do not synchronize; the card is drained every 50 calls,
    outside the timed calls, so the launch queue never fills."""
    out = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        ts = []
        for i in range(reps):
            t0 = time.perf_counter_ns()
            fn()
            ts.append(time.perf_counter_ns() - t0)
            if i % 50 == 49:
                torch.cuda.synchronize()
        out[name] = sorted(ts)[reps // 2] / 1e3
    return out


def k2b_host_split(torch, spec, code_fft) -> dict:
    """K2b's wrapper host time a call (``call``) and its parts: the two
    ``.contiguous()``, the output's allocation, the stream lookup, the
    ctypes launch of the kernel alone, and ``other`` = the call less
    those four parts (checks, pointers, counting); beside it the library
    call's host time."""
    from gnss_sdr_tpu_torch.kernels import acq
    from gnss_sdr_tpu_torch.kernels import build as kb

    (d, n), p = spec.shape, code_fft.shape[0]
    out = acq.acq_product(spec, code_fft)
    fn = kb.function("acq", "acq_product", [kb.VP, kb.VP, kb.I32, kb.I32,
                                            kb.I32, kb.VP, kb.VP])
    args = (spec.data_ptr(), code_fft.data_ptr(), n, d, p, out.data_ptr(),
            kb.stream_ptr(spec.device))
    r = host_us(torch, {
        "call": lambda: acq.acq_product(spec, code_fft),
        "contiguous": lambda: (spec.contiguous(), code_fft.contiguous()),
        "empty": lambda: spec.new_empty((p, d, n)),
        "stream": lambda: kb.stream_ptr(spec.device),
        "launch": lambda: fn(*args),
        "library": lambda: spec[None] * code_fft[:, None]})
    torch.cuda.synchronize()
    r["other"] = r["call"] - (r["contiguous"] + r["empty"] + r["stream"]
                              + r["launch"])
    return r


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
                variant="GPS L1 C/A",
                shape=f"C={c} T={t} L={eng.max_period} int8 ring",
                **k3.cluster(t, codes.shape[1], eng.max_period, ring.dtype,
                             dev))


def check_k3_long(torch, np, rng):
    """K3 at windows of 2.6 code periods (2.5 Msps, 6500 samples): past
    the chips -n_extra .. code_len + n_extra - 1 the kernel drops samples
    as its segmented-sum oracle does. Returns the error relative to the
    largest output."""
    from gnss_sdr_tpu_torch.kernels import multicorr as k3

    dev = torch.device("cuda")
    c, width = 8, 6500
    ring = torch.as_tensor(rng.integers(-90, 90, size=(2, 80000))
                           .astype(np.int8), device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    args = (ring[0], ring[1], 1000,
            t((np.arange(c) * 8000).astype(np.int32)),
            t(rng.integers(5000, 6501, c).astype(np.int32)),
            t(np.sign(rng.standard_normal((c, 1023))).astype(np.float32)),
            t(np.array([-0.5, 0.0, 0.5], np.float32)),
            t(rng.uniform(0, 0.4, c).astype(np.float32)),
            t(np.full(c, 1.023e6 / 2.5e6, np.float32)),
            t(rng.uniform(0, 6.2, c).astype(np.float32)),
            t(rng.uniform(-0.02, 0.02, c).astype(np.float32)), width, 2)
    got_re, got_im = k3.multicorr(*args)
    want_re, want_im = k3.multicorr_plain(*args)
    torch.cuda.synchronize()
    return max(rel_err(torch, got_re, want_re),
               rel_err(torch, got_im, want_im))


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
                einsum_all_rows_ms=einsum_ms, variant="GPS L1 C/A",
                shape=f"C={c} K={k} T={t} n_eff={n} W={fe.win_len}")


def ring_dwells(torch, np, ring, n):
    """The first two ``n``-sample dwells of an int8 ring as complex64
    tensors on the card."""
    return [torch.as_tensor((ring[0, i * n:(i + 1) * n].astype(np.float32)
                             + 1j * ring[1, i * n:(i + 1) * n]
                             .astype(np.float32)).astype(np.complex64),
                            device="cuda") for i in range(2)]


def check_k2(torch, np, rng, prns):
    """K2 at the main path's shapes: the receiver's acquisition engine
    searches the PRNs of ``Channels_1C.satellites`` (P = 8) over 40
    Doppler bins of a 4000-sample dwell."""
    from gnss_sdr_tpu_torch.acquisition.adapters import \
        make_gps_l1ca_acquisition

    eng = make_gps_l1ca_acquisition(sorted(prns), SCENE["fs"],
                                    doppler_max=5000.0, doppler_step=250.0,
                                    max_dwells=2, device="cuda")
    n = eng.cfg.fft_size
    ring = synthetic_ring(np, rng, 2 * n, [(prns[0], 1234.0, 2130.0),
                                           (prns[3], 321.0, -3010.0)])
    return check_k2_engine(torch, np, eng, ring_dwells(torch, np, ring, n),
                           "GPS L1 C/A")


def check_k2_engine(torch, np, eng, xs, variant):
    """The four K2 kernels of acquisition engine ``eng`` on its two
    dwells ``xs`` against their plain versions."""
    from gnss_sdr_tpu_torch.kernels import acq

    cfg = eng.cfg
    n = cfg.fft_size
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
            bound_by=by, library_ms=library_ms, variant=variant,
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
    torch.cuda.synchronize()
    if not torch.equal(pk, pp):
        fail(f"acq_product ({variant}) is not its plain version to the bit")
    entry("acq_product", torch.view_as_real(pk), torch.view_as_real(pp),
          time_ms(torch, lambda: acq.acq_product(spec, code_fft)),
          time_ms(torch, lambda: acq.acq_product_plain(spec, code_fft)),
          d * n * 8 + p * n * 8 + p * d * n * 8, p * d * n * 6,
          library_ms=time_ms(torch, lambda: spec[None] * code_fft[:, None]),
          device_us=kernel_device_us(
              torch, lambda: acq.acq_product(spec, code_fft),
              "product_kernel"))
    out[-1]["host_us"] = k2b_host_split(torch, spec, code_fft)
    out[-1].update(library_device(torch,
                                  lambda: spec[None] * code_fft[:, None]))
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
    res[1]["long_window_rel_err"] = check_k3_long(torch, np, rng)
    print(f"chip_smoke: multicorr long window (2.6 periods): rel err "
          f"{res[1]['long_window_rel_err']:.3g}", file=sys.stderr, flush=True)
    if not res[1]["long_window_rel_err"] <= TOL["multicorr"]:
        fail("multicorr disagrees with its plain version at a long window")
    res.extend(check_k2(torch, np, rng, prns))
    report(res)
    return res


def report(res):
    """Print each kernel check; fail on one that disagrees."""
    for r in res:
        dev_us = "n/a" if r["device_us"] is None else f"{r['device_us']:.2f}"
        print(f"chip_smoke: {r['name']} ({r['variant']}): rel err "
              f"{r['rel_err']:.3g} (tol {r['tol']}), {r['ms'] * 1e3:.2f} "
              f"us/call, {dev_us} us on the device, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.3f} "
              f"us ({r['bound_by']})"
              + (f", wrapper host {r['host_us']['call']:.2f} us"
                 if "host_us" in r else "")
              + (f", library {r['library_device_us']:.2f} us on the device"
                 if r.get("library_device_us") is not None else "")
              + (f", clusters of {r['cluster_size']} blocks, "
                 f"{r['max_active_clusters']} at once"
                 if "cluster_size" in r else ""),
              file=sys.stderr, flush=True)
        if not r["rel_err"] <= r["tol"]:
            fail(f"{r['name']} ({r['variant']}) disagrees with its plain "
                 f"version: {r['rel_err']} > {r['tol']}")


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


def receiver_conf(prns, xml) -> list[str]:
    """INI lines of the slice's receiver: the factory defaults (4 Msps,
    8 channels, K = 20) with assisted ephemerides."""
    return [
        "GNSS-SDR.internal_fs_sps=4000000",
        "Channels_1C.count=8",
        "Channels_1C.satellites=" + ",".join(str(p) for p in prns),
        "Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition",
        "Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking",
        "TelemetryDecoder_1C.implementation=GPS_L1_CA_Telemetry_Decoder",
        "Observables.implementation=Hybrid_Observables",
        "PVT.implementation=RTKLIB_PVT",
        f"GNSS-SDR.AGNSS_gps_ephemeris_xml={xml}"]


def check_fix_stream(np, rec, sols, rx, fs, what):
    """The slice's end-to-end checks; returns (mean, max) 3-D error of
    the second half of the fixes."""
    if not rec.in_fast_mode:
        fail(f"{what}: the receiver never handed off to the fast engine")
    handoff_s = rec.handoff_sample / fs
    if not handoff_s < 4.0:
        fail(f"{what}: handoff at {handoff_s} s, not before 4 s")
    if len(sols) < 5:
        fail(f"{what}: {len(sols)} fixes, fewer than 5")
    mean_err, max_err = second_half_err(np, sols, rx)
    if not (np.isfinite(mean_err) and mean_err < 5.0):
        fail(f"{what}: mean 3-D error {mean_err} m over the second half")
    return mean_err, max_err


def second_half_err(np, sols, rx):
    """(mean, max) 3-D error of the second half of the fixes (NaN for
    none)."""
    errs = [float(np.linalg.norm(s.pos_ecef - rx))
            for s in sols[len(sols) // 2:]] or [float("nan")]
    return float(np.mean(errs)), float(max(errs))


def slice_phase(torch, np, build_dir, card):
    from gnss_sdr_tpu_torch.config import FileConfiguration
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.receiver.assistance import save_ephemeris_xml
    from gnss_sdr_tpu_torch.receiver.factory import make_receiver
    from gnss_sdr_tpu_torch.acquisition.pcps import PcpsAcquisition
    from gnss_sdr_tpu_torch.receiver.production import ProductionReceiver
    from gnss_sdr_tpu_torch.tracking.channels import TrackingChannels
    from gnss_sdr_tpu_torch.tracking.engine import TrackingEngine
    from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

    x, ephs, prns, rx, scene_s = scene(np, build_dir)
    fs = SCENE["fs"]
    xml = save_ephemeris_xml({p: ephs[p] for p in prns},
                             os.path.join(build_dir, "gps_ephemeris.xml"))
    conf = os.path.join(build_dir, "rx.conf")
    with open(conf, "w") as fh:
        fh.write("\n".join(receiver_conf(prns, xml) + [""]))
    rec = make_receiver(FileConfiguration(conf))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with CallLog(TrackingEngine, "superblock_ring_i8") as scan_log, \
            CallLog(TrackingEngine, "process_block") as block_log, \
            CallLog(FastTrackingEngine, "superblock_ring_i8") as fast_log, \
            CallLog(PcpsAcquisition, "search") as acq_log, \
            CallLog(TrackingChannels, "process_superblock_ring") as trk_log, \
            CallLog(ProductionReceiver, "_consume_superblock") as use_log:
        sols = rec.run(x)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    missing = [k for k in SLICE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    # one fused launch per engine call, and K3 / K1 only inside them
    n_scan = len(scan_log.calls) + len(block_log.calls)
    if launches["scan_loop"] != n_scan \
            or launches["fast_loop"] != len(fast_log.calls) \
            or launches["multicorr"] or launches["bank_corr"]:
        fail(f"slice: launches {launches} are not one fused launch per "
             f"superblock ({n_scan} scan, {len(fast_log.calls)} fast)")
    mean_err, max_err = check_fix_stream(np, rec, sols, rx, fs, "slice")
    tm = dict(rec.timings)
    signal_s = len(x) / fs
    # mid-run superblocks: the last of phase A, the second of phase B
    mid = dict(scan=scan_log.calls[-1], fast=fast_log.calls[1])
    phases = profile_phases(torch, mid)
    result = dict(
        fixes=len(sols), mean_err_m=mean_err, max_err_m=max_err,
        handoff_s=rec.handoff_sample / fs, timings=tm,
        rtf_phase_a=(tm["phase_a_samples"] / fs) / tm["phase_a_s"],
        rtf_phase_b=(tm["phase_b_samples"] / fs) / tm["phase_b_s"],
        rtf_total=signal_s / run_s, run_s=run_s, signal_s=signal_s,
        scene_s=scene_s, channels=8, fs=fs, prns=prns,
        # host wall seconds inside the run: phase A's acquisition searches
        # and its scan superblocks (engine call, readback, period records),
        # phase B's dispatches and its host pass over each superblock
        # (readback wait, decode, observables; PVT runs outside it)
        split_s=dict(acquisition=acq_log.seconds,
                     scan_superblocks=trk_log.seconds,
                     fast_dispatch=fast_log.seconds,
                     fast_consume=use_log.seconds),
        profile=phases, card=card)
    return result, launches, mid


def busy_share(torch, calls, readback):
    """The engine ``calls`` (each one fused launch) as the receiver runs
    them, each followed by ``readback`` of its output: the host wall time
    (synchronized, median of three), the device time of the same calls
    back to back (CUDA events; the queue stays full, so the events time
    the kernels) and the share of the wall time the card is busy."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for call in calls:
            readback(call())
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls)[1]
    dev = time_ms(torch, lambda: [call() for call in calls], reps=3)
    return dict(wall_ms=wall, device_ms=dev, busy_share=dev / wall,
                calls=len(calls))


def profile_phases(torch, mid):
    """After the main path's run (its launch counts already read): the
    slice's last phase-A superblock (10 scan blocks, acquisition
    excluded) and its second phase-B superblock (10 fast blocks) again,
    from the states logged during the run, for the host wall time, the
    device time and the card's busy share (``busy_share``)."""
    eng, args = mid["scan"]
    fast, fargs = mid["fast"]
    return dict(
        phase_a_superblock=busy_share(
            torch, [lambda: eng.superblock_ring_i8(*args)],
            lambda out: out[1]["packed"].cpu()),
        phase_b_superblock=busy_share(
            torch, [lambda: fast.superblock_ring_i8(*fargs)],
            lambda out: out[1]["packed"].cpu()))


# ---------------------------------------------------------------------------
# conditioned slices: the signal conditioner in front of the receiver
# ---------------------------------------------------------------------------

#: the derived front-end captures: the slice's 4 Msps scene upsampled to
#: 8 Msps (12 s, 96 M samples), conditioned back to the receiver's 4 Msps
RAW_FS = 8e6
NOISE_SEED = 7
#: B and C resample 8 -> 4 Msps without a low-pass, as the configs are
#: written, so the outer half of the band aliases in: 3 dB less C/N0, at
#: which this scene's code-only fixes sit at the 5 m bound with no
#: conditioner at all (PERF.md, Findings). Their receiver smooths the code
#: with the carrier, as the repo's production tests do.
SMOOTHING = "Observables.enable_carrier_smoothing=true"
#: conditioner (and receiver) keys per config and the conditioner kernels
#: each one must launch
CONFIGS = {
    "A": (["InputFilter.implementation=Freq_Xlating_Fir_Filter",
           "InputFilter.IF=1500000", "InputFilter.decimation_factor=2",
           "InputFilter.number_of_taps=65"], ("fir_decim",)),
    "B": (["InputFilter.implementation=Pulse_Blanking_Filter",
           "InputFilter.pb_threshold_sigma=4",
           "Resampler.implementation=Mmse_Resampler", SMOOTHING],
          ("pulse_blank", "resample")),
    "C": (["InputFilter.implementation=Notch_Filter",
           "Resampler.implementation=Direct_Resampler", SMOOTHING],
          ("notch_mask", "resample")),
}
STREAM_S = 3.0


def baseband_8msps(torch, np, x):
    """The 4 Msps scene at 8 Msps on the card: its spectrum zero-padded
    (test data only, not the port's path), the empty outer half of the
    band filled with white noise of the in-band density from a seeded
    numpy Generator. Returns (complex64 tensor, in-band noise power)."""
    dev = torch.device("cuda")
    n = len(x)
    xt = torch.as_tensor(x, device=dev)
    sigma2 = float(torch.mean(torch.abs(xt) ** 2))
    spec = torch.fft.fft(xt)
    del xt
    up = torch.empty(2 * n, dtype=torch.complex64, device=dev)
    up[:n // 2] = 2 * spec[:n // 2]
    up[n // 2 + n:] = 2 * spec[n // 2:]
    del spec
    # in-band bins hold 4 n sigma2 on average (2x amplitude for 2x length)
    noise = np.random.default_rng(NOISE_SEED).standard_normal(
        (n, 2), dtype=np.float32)
    up[n // 2:n // 2 + n] = torch.view_as_complex(
        torch.as_tensor(noise, device=dev)) * float(np.sqrt(2.0 * n * sigma2))
    del noise
    return torch.fft.ifft(up), sigma2


def tone(torch, np, n, num: int, den: int):
    """e^{j 2 pi (num/den) k}, k < n, exact: the phase is (num k mod den)."""
    dev = torch.device("cuda")
    table = torch.as_tensor(np.exp(2j * np.pi * np.arange(den) / den)
                            .astype(np.complex64), device=dev)
    return table[(torch.arange(n, device=dev) * num) % den]


def capture(torch, np, name, xb, sigma2):
    """Config ``name``'s raw 8 Msps capture (numpy complex64). A: at IF
    +1.5 MHz. B: DME-like pulse pairs (3.5 us rectangular pulses 12 us
    apart, 2700 pairs/s, +40 dB over the band's noise power). C: a CW
    tone at +0.7 MHz, +30 dB."""
    n = xb.shape[0]
    p_noise = 2.0 * sigma2
    if name == "A":
        return (xb * tone(torch, np, n, 3, 16)).cpu().numpy()
    if name == "C":
        return (xb + float(np.sqrt(1e3 * p_noise))
                * tone(torch, np, n, 7, 80)).cpu().numpy()
    rng = np.random.default_rng(NOISE_SEED + 1)
    pairs = int(2700 * n / RAW_FS)
    slot = n // pairs                   # one pair per slot: no overlaps
    width, gap = int(3.5e-6 * RAW_FS), int(12e-6 * RAW_FS)
    first = np.arange(pairs) * slot + rng.integers(0, slot - gap - width,
                                                   pairs)
    k = np.arange(width)
    idx = np.concatenate([first[:, None] + k, first[:, None] + gap + k], 1)
    f = rng.uniform(-1e6, 1e6, pairs)[:, None]
    ph = rng.uniform(0, 2 * np.pi, pairs)[:, None]
    vals = np.sqrt(1e4 * p_noise) * np.exp(
        1j * (2 * np.pi * f / RAW_FS * idx + ph))
    out = xb.clone()
    out[torch.as_tensor(idx.reshape(-1), device=xb.device)] += torch.as_tensor(
        vals.reshape(-1).astype(np.complex64), device=xb.device)
    return out.cpu().numpy()


def k7_entry(torch, name, got, want, ms, plain_ms, nb, no, device_fn,
             replaces, shape, library_ms=None, **extra):
    """One K7 kernel line: error relative to the plain output's rms. Its
    device time is ``event_us``: at these shapes (milliseconds a call)
    ``torch.profiler`` dropped launch records of the kernels launched
    through ctypes (PERF.md, Findings)."""
    b, by = bound_ms(nb, no)
    diff = torch.abs(got - want)
    rms = float(torch.sqrt(torch.mean(torch.abs(want) ** 2)))
    torch.cuda.synchronize()
    return dict(name=name, route="cuda",
                source="gnss_sdr_tpu_torch/kernels/csrc/conditioner.cu",
                replaces=replaces, max_abs_err=float(torch.max(diff)),
                rel_err=float(torch.max(diff)) / (rms or 1.0),
                tol=TOL[name], ms=ms,
                event_us=event_us(torch, device_fn),
                plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=library_ms, shape=shape, **extra)


def check_k7(torch, np, name, raw, chain):
    """The config's conditioner kernels against their plain versions on
    its raw capture, at the main path's shapes."""
    from gnss_sdr_tpu_torch.conditioner.fir import nco_step
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    x = torch.as_tensor(raw, device="cuda")
    n = x.shape[0]
    out = []
    if name == "A":
        taps, d = chain.taps, chain.decimation
        step = nco_step(chain.if_freq_hz, chain.fs_in)
        args = (x, taps, d, step, 0)
        got, want = k7.fir_decim(*args), k7.fir_decim_plain(*args)
        nt, n_out = len(taps), got.shape[0]
        # the library yardstick: conv1d with stride D over the re/im planes
        # of the already translated capture
        xt = torch.view_as_real(k7.translate_plain(x, step, 0)).T
        planes = torch.nn.functional.pad(xt.contiguous(), (nt - 1, 0))[:, None]
        w = torch.as_tensor(taps[::-1].copy(), device="cuda")[None, None]

        def conv():
            return torch.nn.functional.conv1d(planes, w, stride=d)

        lib = conv()[:, 0]
        torch.cuda.synchronize()
        lib_err = float(torch.max(torch.abs(torch.complex(lib[0], lib[1])
                                            - want)))
        # the split: the same filter without the translation NCO
        plain_args = (x, taps, d)
        out.append(k7_entry(
            torch, "fir_decim", got, want,
            time_ms(torch, lambda: k7.fir_decim(*args), 10),
            time_ms(torch, lambda: k7.fir_decim_plain(*args), 3),
            n * 8 + nt * 4 + n_out * 8, n * 6 + n_out * nt * 4,
            lambda: k7.fir_decim(*args),
            "gnss_sdr_tpu/conditioner/fir.py:44",
            f"N={n} complex64, {nt} taps, D={d}, IF {chain.if_freq_hz:g} Hz",
            library_ms=time_ms(torch, conv, 10), library_max_abs_err=lib_err,
            translate_off_ms=time_ms(
                torch, lambda: k7.fir_decim(*plain_args), 10),
            translate_off_event_us=event_us(
                torch, lambda: k7.fir_decim(*plain_args)),
            occupancy=k7.fir_occupancy(nt, d, True, "cuda")))
        return out
    if name == "B":
        sig = chain.pb_threshold_sigma
        got, want = k7.pulse_blank(x, sig), k7.pulse_blank_plain(x, sig)
        flips = int(torch.sum((got == 0) != (want == 0)))
        blanked = int(torch.sum(want == 0))
        out.append(k7_entry(
            torch, "pulse_blank", got, want,
            time_ms(torch, lambda: k7.pulse_blank(x, sig), 10),
            time_ms(torch, lambda: k7.pulse_blank_plain(x, sig), 3),
            2 * n * 8, 5 * n, lambda: k7.pulse_blank(x, sig),
            "gnss_sdr_tpu/conditioner/interference.py:25",
            f"N={n} complex64, sigma={sig:g}", flipped=flips,
            blanked=blanked))
        if flips:
            fail(f"pulse_blank: {flips} blanking decisions differ")
        mid = want
    else:
        k = chain.notch_excision
        spec = torch.fft.fft(x)
        want = k7.notch_mask_plain(spec, k)
        # checked and timed in place, as notch_filter_block runs it (the
        # timing on a copy whose excised bins its first call zeroes), and
        # into a new tensor
        got = k7.notch_mask_(spec.clone(), k)
        work = spec.clone()
        fresh = k7.notch_mask(spec, k)
        route = int(k7._notch_launch(spec, k, torch.empty_like(spec))[
            k7.NOTCH_ROUTE])
        torch.cuda.synchronize()
        if not torch.equal(fresh, want):
            fail("notch_mask: the new-tensor form differs from its plain "
                 "version")
        del fresh
        out.append(k7_entry(
            torch, "notch_mask", got, want,
            time_ms(torch, lambda: k7.notch_mask_(work, k), 10),
            time_ms(torch, lambda: k7.notch_mask_plain(spec, k), 3),
            2 * n * 8, 5 * n, lambda: k7.notch_mask_(work, k),
            "gnss_sdr_tpu/conditioner/interference.py:33",
            f"N={n} complex64 spectrum, k={k:g}",
            excised=int(torch.sum(want == 0)),
            form="in place (notch_filter_block)",
            select_route="candidates" if route == 0 else "all bins",
            new_tensor_ms=time_ms(torch, lambda: k7.notch_mask(spec, k), 10),
            new_tensor_event_us=event_us(
                torch, lambda: k7.notch_mask(spec, k)),
            new_tensor_floor_ms=bound_ms(3 * n * 8, 5 * n)[0]))
        mid = torch.fft.ifft(want)
        del spec, work
    mode = k7.MMSE if chain.resampler == "Mmse_Resampler" else k7.DIRECT
    fi, fo = chain.fs_mid, chain.fs_out

    def run():
        return k7.resample(mid, fi, fo, mode)

    got, want = run(), k7.resample_plain(mid, fi, fo, mode)
    n_out = got.shape[0]
    library_ms = None
    if mode == k7.DIRECT:
        from gnss_sdr_tpu_torch.conditioner.resampler import \
            direct_resample_indices

        idx = torch.as_tensor(direct_resample_indices(n, fi, fo),
                              device="cuda")
        library_ms = time_ms(torch, lambda: torch.index_select(mid, 0, idx),
                             10)
    out.append(k7_entry(
        torch, "resample", got, want, time_ms(torch, run, 10),
        time_ms(torch, lambda: k7.resample_plain(mid, fi, fo, mode), 3),
        (n if mode == k7.MMSE else n_out) * 8 + n_out * 8,
        n_out * 6 if mode == k7.MMSE else 0, run,
        "gnss_sdr_tpu/conditioner/resampler.py:29",
        f"{chain.resampler} {fi:g} -> {fo:g} sps, N={n} complex64",
        library_ms=library_ms))
    if mode == k7.MMSE:
        # a ratio with fractional positions (8 -> 6.4 Msps) exercises the
        # interpolation weights, which the chip ratio 2 leaves at 0
        a = k7.resample(mid, fi, 6.4e6, mode)
        b = k7.resample_plain(mid, fi, 6.4e6, mode)
        out[-1]["frac_ratio_max_abs_err"] = float(torch.max(torch.abs(a - b)))
        if out[-1]["frac_ratio_max_abs_err"] != 0.0:
            fail("resample: the Mmse kernel differs at ratio 1.25")
    return out


def conditioned_run(torch, np, build_dir, name, raw, prns, xml, rx):
    """Config ``name`` end to end: its INI, ``make_signal_source`` over
    the raw capture file, ``make_signal_conditioner(...).apply`` and
    ``make_receiver(...).run``, with the launch counters read around the
    conditioner and the receiver."""
    from gnss_sdr_tpu_torch.config import FileConfiguration
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.receiver.factory import (make_receiver,
                                                     make_signal_conditioner,
                                                     make_signal_source)

    keys, kernels = CONFIGS[name]
    path = os.path.join(build_dir, f"capture_{name}.dat")
    raw.tofile(path)
    conf = os.path.join(build_dir, f"rx_{name}.conf")
    with open(conf, "w") as fh:
        fh.write("\n".join(receiver_conf(prns, xml) + [
            "SignalSource.implementation=File_Signal_Source",
            f"SignalSource.filename={path}",
            "SignalSource.item_type=gr_complex",
            f"SignalSource.sampling_frequency={int(RAW_FS)}",
            "SignalConditioner.implementation=Signal_Conditioner",
            "DataTypeAdapter.implementation=Pass_Through", *keys, ""]))
    config = FileConfiguration(conf)
    source = make_signal_source(config)
    chain = make_signal_conditioner(config)
    rec = make_receiver(config)
    samples = source.read(0, source.n_samples)
    os.remove(path)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    y = chain.apply(samples)
    t1 = time.perf_counter()
    sols = rec.run(y)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(LAUNCHES)
    missing = [k for k in SLICE_KERNELS + kernels if launches[k] == 0]
    if missing:
        fail(f"config {name}: kernels never launched: {missing}")
    fs = rec.cfg.fs
    mean_err, max_err = check_fix_stream(np, rec, sols, rx, fs,
                                         f"config {name}")
    tm = rec.timings
    extra = {}
    if SMOOTHING in keys:
        # the same conditioned samples without carrier smoothing: the
        # code-only error behind the configs' missing low-pass (no check)
        config.apply_overrides(
            {"Observables.enable_carrier_smoothing": "false"})
        extra["unsmoothed_mean_err_m"] = second_half_err(
            np, make_receiver(config).run(y), rx)[0]
    return chain, launches, dict(
        fixes=len(sols), mean_err_m=mean_err, max_err_m=max_err,
        handoff_s=rec.handoff_sample / fs, conditioner_s=t1 - t0,
        conditioner_split_s=dict(chain.timings),
        conditioner_rtf=(len(samples) / RAW_FS) / (t1 - t0),
        rtf_phase_a=(tm["phase_a_samples"] / fs) / tm["phase_a_s"],
        rtf_phase_b=(tm["phase_b_samples"] / fs) / tm["phase_b_s"],
        run_s=t2 - t1, raw_samples=len(samples),
        launches={k: launches[k] for k in SLICE_KERNELS + kernels}, **extra)


def decimation_control(torch, np, build_dir, xb, prns, xml, rx):
    """The receiver (no smoothing) on the 8 Msps capture decimated by 2
    with no conditioner at all: the second-half mean error that the
    aliased outer band alone leaves (B and C's control)."""
    from gnss_sdr_tpu_torch.config import FileConfiguration
    from gnss_sdr_tpu_torch.receiver.factory import make_receiver

    conf = os.path.join(build_dir, "rx_control.conf")
    with open(conf, "w") as fh:
        fh.write("\n".join(receiver_conf(prns, xml) + [""]))
    sols = make_receiver(FileConfiguration(conf)).run(
        xb[::2].cpu().numpy())
    return second_half_err(np, sols, rx)[0]


class RecordingConditioner:
    """The streaming branch's conditioner, keeping what it returned and
    the wall seconds it took."""

    def __init__(self, chain):
        self.chain = chain
        self.parts = []
        self.seconds = 0.0

    def apply_stream(self, chunk):
        t0 = time.perf_counter()
        out = self.chain.apply_stream(chunk)
        self.seconds += time.perf_counter() - t0
        self.parts.append(out)
        return out


class Timed:
    """``obj`` with the wall seconds spent in its method ``name`` summed
    in ``seconds``; every other attribute passes through."""

    def __init__(self, obj, name):
        self._obj, self._name, self.seconds = obj, name, 0.0

    def __getattr__(self, attr):
        fn = getattr(self._obj, attr)
        if attr != self._name:
            return fn

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
        return timed


class CallLog:
    """While active, every call of method ``name`` of class ``cls``:
    (the instance, its positional arguments) appended to ``calls`` and
    its host wall time added to ``seconds``; the method itself runs
    unchanged. The engines' states are functional, so a logged state is
    the one the call started from."""

    def __init__(self, cls, name):
        self.cls, self.name, self.calls, self.seconds = cls, name, [], 0.0

    def __enter__(self):
        orig = self._orig = self.cls.__dict__[self.name]

        def logged(inst, *a, **k):
            self.calls.append((inst, a))
            t0 = time.perf_counter()
            try:
                return orig(inst, *a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(self.cls, self.name, logged)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self._orig)


def streaming_phase(torch, np, build_dir, raw_a, prns, xml):
    """The first STREAM_S seconds of config A's raw capture through the
    CLI's streaming branch (``__main__.stream``): a FIFO source (a file
    standing in for the pipe), raw chunks of one second, ``apply_stream``
    and the scan receiver's ``process_block``."""
    import gnss_sdr_tpu_torch.__main__ as cli
    from gnss_sdr_tpu_torch.config import FileConfiguration
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.receiver.factory import (make_receiver,
                                                     make_signal_conditioner,
                                                     make_signal_source)
    from gnss_sdr_tpu_torch.receiver.fsm import ChannelState

    prefix = raw_a[:int(STREAM_S * RAW_FS)]
    path = os.path.join(build_dir, "stream_A.dat")
    prefix.tofile(path)
    conf = os.path.join(build_dir, "rx_stream.conf")
    with open(conf, "w") as fh:
        fh.write("\n".join(receiver_conf(prns, xml) + [
            "SignalSource.implementation=Fifo_Signal_Source",
            f"SignalSource.filename={path}",
            "SignalSource.item_type=gr_complex",
            f"SignalSource.sampling_frequency={int(RAW_FS)}",
            "SignalConditioner.implementation=Signal_Conditioner",
            *CONFIGS["A"][0], ""]))
    config = FileConfiguration(conf)
    source = make_signal_source(config)
    # the stand-in file has no writer that could come back: its end is
    # final, so the last read need not retry 10,000 empty reads first
    # (on the card's machine those took 100-130 s of the phase)
    source.read_block = functools.partial(source.read_block, max_retries=1)
    chain = RecordingConditioner(make_signal_conditioner(config))
    rec = make_receiver(config, engine="scan")
    timed_source = Timed(source, "read_block")
    timed_rec = Timed(rec, "process_block")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pos = cli.stream(timed_source, chain, timed_rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    source.close()
    os.remove(path)
    want = ("fir_decim", "scan_loop", "acq_wipeoff", "acq_product",
            "acq_accum", "acq_stats")
    missing = [k for k in want if launches[k] == 0]
    if missing:
        fail(f"streaming: kernels never launched: {missing}")
    streamed = np.concatenate(chain.parts)
    one = make_signal_conditioner(config).apply(prefix)
    if len(streamed) != len(one):
        fail(f"streaming: {len(streamed)} samples, one-shot {len(one)}")
    rms = float(np.sqrt(np.mean(np.abs(one) ** 2)))
    err = float(np.max(np.abs(streamed - one))) / rms
    if not err <= TOL["fir_decim"]:
        fail(f"streaming: stream differs from the one-shot output: {err}")
    tracking = sum(s is ChannelState.TRACKING for s in rec.channel_states())
    if tracking < 6:
        fail(f"streaming: {tracking} of 8 channels tracking at the end")
    return dict(signal_s=STREAM_S, wall_s=wall, rtf=STREAM_S / wall,
                read_s=timed_source.seconds, condition_s=chain.seconds,
                receiver_s=timed_rec.seconds,
                processed_samples=pos, chunks=len(chain.parts),
                rel_err_vs_oneshot=err, channels_tracking=tracking,
                launches={k: launches[k] for k in want})


def conditioned_phase(torch, np, build_dir, card):
    """Configs A, B and C: each config's conditioner kernels checked on
    its raw capture, then the config end to end; then the streaming run.
    Returns (K7 kernel lines, the conditioned record)."""
    from gnss_sdr_tpu_torch.receiver.assistance import save_ephemeris_xml

    x, ephs, prns, rx, _ = scene(np, build_dir)
    xml = save_ephemeris_xml({p: ephs[p] for p in prns},
                             os.path.join(build_dir, "gps_ephemeris.xml"))
    t0 = time.perf_counter()
    xb, sigma2 = baseband_8msps(torch, np, x)
    del x
    derive_s = time.perf_counter() - t0
    control = decimation_control(torch, np, build_dir, xb, prns, xml, rx)
    kernels, runs, path_launches = {}, {}, {}
    stream = None
    for name in CONFIGS:
        raw = capture(torch, np, name, xb, sigma2)
        chain, launches, runs[name] = conditioned_run(
            torch, np, build_dir, name, raw, prns, xml, rx)
        path_launches[name] = launches
        for entry in check_k7(torch, np, name, raw, chain):
            kernels.setdefault(entry["name"], []).append(entry)
        print(f"chip_smoke: config {name}: {json.dumps(runs[name])}",
              file=sys.stderr, flush=True)
        if name == "A":
            stream = streaming_phase(torch, np, build_dir, raw, prns, xml)
        del raw
    out = []
    for kname, entries in kernels.items():
        entry = entries[0]
        if len(entries) > 1:        # the resampler: Mmse in B, Direct in C
            entry = dict(entries[0], direct=entries[1],
                         rel_err=max(e["rel_err"] for e in entries),
                         max_abs_err=max(e["max_abs_err"] for e in entries))
        entry["launches"] = sum(pl[kname] for pl in path_launches.values())
        entry["card"] = card
        out.append(entry)
    for r in out:
        print(f"chip_smoke: {r['name']}: rel err {r['rel_err']:.3g} "
              f"(tol {r['tol']}), {r['ms'] * 1e3:.2f} us/call, "
              f"{r['event_us']:.2f} us per single call, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})",
              file=sys.stderr, flush=True)
        if not r["rel_err"] <= r["tol"]:
            fail(f"{r['name']} disagrees with its plain version: "
                 f"{r['rel_err']} > {r['tol']}")
    return out, dict(configs=runs, streaming=stream, derive_s=derive_s,
                     raw_fs=RAW_FS, noise_power_in_band=sigma2,
                     control_decimated_mean_err_m=control, card=card)


# ---------------------------------------------------------------------------
# Galileo E1 shapes and the multi-band slice (GPS L1 C/A + Galileo E1)
# ---------------------------------------------------------------------------

#: the Galileo E1 band of the multi-band slice: the first ``gal_sats``
#: visible of ``make_constellation(range(1, 37), spread_seed=7)`` on 8
#: channels, pilot and data at 45 dB-Hz total against the L1 scene's
#: noise, the I/NAV pages starting at an even GST second before the scene
#: (GST = GPST). Seven, not eight: on this scene's first 4.5 s the
#: eighth (PRN 21) is acquired 75 Hz off, its 4 ms FLL locks at the
#: +125 Hz alias and its CS25 never syncs, which holds the JAX receiver
#: and the port alike in phase A (PERF.md, Findings; ROADMAP §3)
MB = dict(gal_sats=7, gal_cn0_db_hz=45.0, gal_seed=2, spread_seed=7,
          gal_bits_start_tow_s=7200.0 + 359 * 10.0)

def e1_tracking_config(**kw):
    """The E1 band's tracking configuration (``receiver/bands.py``)."""
    from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig

    return TrackingConfig(
        fs=SCENE["fs"], code_length_chips=4092, chip_rate_cps=1.023e6,
        code_samples_per_chip=12, veml=True, symbols_per_bit=1,
        early_late_space_chips=0.15, very_early_late_space_chips=0.6, **kw)


def synthetic_e1_ring(np, rng, n: int, chans):
    """int8 planar ring of ``n`` samples holding one composite Galileo E1
    signal (E1-B with random symbols minus the CS25-signed E1-C, over
    sqrt 2) per channel (PRN, code phase, Doppler) plus noise."""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import (E1C_SECONDARY,
                                                     galileo_e1_subchips)

    fs = SCENE["fs"]
    t = np.arange(n, dtype=np.float64)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 8.0
    cs = np.array([1.0 if c == "0" else -1.0 for c in E1C_SECONDARY])
    for prn, delay, dopp in chans:
        sub = np.floor((t - delay) * 1.023e6 * 12 / fs).astype(np.int64)
        per = sub // 49104
        sym = np.sign(rng.standard_normal(per.max() - per.min() + 1))
        e = (galileo_e1_subchips(prn, "B", True)[sub % 49104]
             * sym[per - per.min()]
             - galileo_e1_subchips(prn, "C", True)[sub % 49104]
             * cs[per % 25]) / np.sqrt(2.0)
        x = x + 3.0 * e * np.exp(2j * np.pi * dopp * t / fs)
    re = np.clip(x.real, -127, 127).astype(np.int8)
    im = np.clip(x.imag, -127, 127).astype(np.int8)
    return np.stack([re, im])


def check_k1_e1(torch, np, rng, pilot: bool):
    """K1 at the E1 band's fast-engine shapes: the pilot at K = 25 with
    the E1-B data bank as a sixth tap (T = 5 + 1), or E1-B alone at K = 1
    (T = 5); 8 channels, 16001-sample windows."""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1_subchips
    from gnss_sdr_tpu_torch.kernels import bank_corr as k1
    from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

    dev = torch.device("cuda")
    c = 8
    cfg = e1_tracking_config(track_pilot=pilot,
                             extend_correlation_symbols=25 if pilot else 1)
    fe = FastTrackingEngine(cfg, c, 1 if pilot else 25,
                            sec_max_len=25 if pilot else 1, device=dev)
    prns = [1, 2, 10, 12, 15, 17, 18, 21]
    delays = rng.uniform(0, 16000, c)
    dopps = rng.uniform(-4500, 4500, c)
    ring = torch.as_tensor(synthetic_e1_ring(
        np, rng, 2 * fe.block_samples + fe.overlap,
        list(zip(prns, delays, dopps))), device=dev)
    s = fe.init_state()
    for ch in range(c):
        s = fe.start_channel(s, ch, float(dopps[ch]),
                             int(np.ceil(delays[ch])) % 16000)
    s = s._replace(
        rem_code_phase_samples=torch.as_tensor(
            rng.uniform(0, 1, c).astype(np.float32), device=dev),
        rem_carr_phase_rad=torch.as_tensor(
            rng.uniform(0, 6.28, c).astype(np.float32), device=dev),
        code_doppler_chips=torch.as_tensor(
            (dopps / 1540.0).astype(np.float32), device=dev))

    def tables(comp):
        return torch.as_tensor(np.stack([galileo_e1_subchips(p, comp, True)
                                         for p in prns]).astype(np.float32),
                               device=dev)

    bank = fe.get_bank(tables("C"), tables("B")) if pilot \
        else fe.get_bank(tables("B"))
    q = fe.group_inputs(s)
    base = fe.block_samples - fe.k * 16000 // 2
    args = (ring[0], ring[1], base, q["win_start"], q["ph0"], q["step"],
            bank, q["j0"], q["w"], fe.n_eff)
    got_re, got_im = k1.bank_corr(*args)
    want_re, want_im = k1.bank_corr_plain(*args)
    torch.cuda.synchronize()
    prompt = torch.sqrt(want_re[..., 2] ** 2 + want_im[..., 2] ** 2)
    err = float(torch.max(torch.maximum(
        torch.abs(got_re - want_re), torch.abs(got_im - want_im))
        / prompt[..., None]))
    k, t, n = fe.k, bank.shape[2], fe.n_eff
    rows = torch.unique(torch.cat([
        q["j0"] + 17 * torch.arange(c, device=dev)[:, None],
        q["j0"] + 1 + 17 * torch.arange(c, device=dev)[:, None]]))
    nb = c * k * n * 2 + int(rows.numel()) * t * n * 4 + c * k * (4 * 4) \
        + c * k * t * 8
    no = c * k * n * (8 + 8 * t) + c * k * t * 6
    b, by = bound_ms(nb, no)
    idx = (base + q["win_start"].to(torch.int64))[..., None] \
        + torch.arange(fe.win_len, device=dev)
    rot = ring[0][idx].to(torch.float32)
    einsum_ms = time_ms(torch, lambda: torch.einsum("ckl,cptl->ckpt", rot,
                                                    bank), 10)
    variant = "E1 pilot + data tap" if pilot else "E1-B data only"
    return dict(name="bank_corr", route="cuda",
                source="gnss_sdr_tpu_torch/kernels/csrc/bank_corr.cu",
                replaces="gnss_sdr_tpu/tracking/fast_engine.py:683"
                + (", :734" if pilot else ""),
                max_abs_err=float(torch.max(torch.abs(got_re - want_re))),
                rel_err=err, tol=TOL["bank_corr"],
                ms=time_ms(torch, lambda: k1.bank_corr(*args)),
                device_us=kernel_device_us(torch,
                                           lambda: k1.bank_corr(*args),
                                           "bank_corr_kernel"),
                plain_ms=time_ms(torch, lambda: k1.bank_corr_plain(*args), 5),
                bound_ms=b, bound_by=by, library_ms=None,
                einsum_all_rows_ms=einsum_ms, variant=variant,
                shape=f"C={c} K={k} T={t} n_eff={n} W={fe.win_len}")


def check_k3_e1(torch, np, rng):
    """K3 at the E1 band's scan-engine shapes: 8 channels of 16016-sample
    windows on the 49104-entry CBOC sub-chip tables of the E1-C pilot
    (T = 5: +-0.15, +-0.6 chips) and of E1-B at zero shift (T = 1, the
    data prompt, a second launch on the same windows)."""
    from gnss_sdr_tpu_torch.codes.galileo_e1 import galileo_e1_subchips
    from gnss_sdr_tpu_torch.kernels import multicorr as k3
    from gnss_sdr_tpu_torch.tracking.engine import TrackingEngine

    dev = torch.device("cuda")
    c = 8
    eng = TrackingEngine(e1_tracking_config(track_pilot=True), c, 80000,
                         device=dev)
    prns = [1, 2, 10, 12, 15, 17, 18, 21]
    delays = rng.uniform(0, 16000, c)
    dopps = rng.uniform(-4500, 4500, c)
    ring = torch.as_tensor(synthetic_e1_ring(
        np, rng, 4 * 80000 + eng.overlap, list(zip(prns, delays, dopps))),
        device=dev)
    s = eng.init_state()
    for ch in range(c):
        s = eng.start_channel(s, ch, float(dopps[ch]),
                              int(np.ceil(delays[ch])) % 16000, 16000)
    s = s._replace(
        rem_code_phase_chips=torch.as_tensor(
            rng.uniform(0, 3.0, c).astype(np.float32), device=dev),
        rem_carr_phase_rad=torch.as_tensor(
            rng.uniform(0, 6.28, c).astype(np.float32), device=dev),
        cur_len=torch.as_tensor(rng.integers(15999, 16002, c)
                                .astype(np.int32), device=dev))
    start = eng.window_start(s)
    out = []
    for comp, shifts, n_extra, variant in (
            ("C", eng._shifts, eng._n_extra, "E1 pilot T=5"),
            ("B", eng._zero_shift, eng._n_extra_data, "E1 data T=1")):
        codes = torch.as_tensor(np.stack([galileo_e1_subchips(p, comp, True)
                                          for p in prns]).astype(np.float32),
                                device=dev)
        args = (ring[0], ring[1], 80000, start, s.cur_len, codes, shifts,
                s.rem_code_phase_chips, s.code_phase_step_chips,
                s.rem_carr_phase_rad, s.carrier_phase_step_rad,
                eng.max_period, n_extra)
        got_re, got_im = k3.multicorr(*args)
        want_re, want_im = k3.multicorr_plain(*args)
        torch.cuda.synchronize()
        mid = shifts.shape[0] // 2
        prompt = torch.sqrt(want_re[:, mid] ** 2 + want_im[:, mid] ** 2)
        err = float(torch.max(torch.maximum(
            torch.abs(got_re - want_re), torch.abs(got_im - want_im))
            / prompt[:, None]))
        n_valid = int(torch.sum(torch.clamp(s.cur_len, max=eng.max_period)))
        t = shifts.shape[0]
        nb = n_valid * 2 + c * codes.shape[1] * 4 + c * 6 * 4 + c * t * 8
        no = n_valid * (8 + 4 * t)
        b, by = bound_ms(nb, no)
        out.append(dict(
            name="multicorr", route="cuda",
            source="gnss_sdr_tpu_torch/kernels/csrc/multicorr.cu",
            replaces="gnss_sdr_tpu/ops/correlator.py:33 (tracking/"
            "engine.py:454" + (", :465)" if comp == "B" else ")"),
            max_abs_err=float(torch.max(torch.abs(got_re - want_re))),
            rel_err=err, tol=TOL["multicorr"],
            ms=time_ms(torch, lambda: k3.multicorr(*args)),
            device_us=kernel_device_us(torch, lambda: k3.multicorr(*args),
                                       "multicorr_kernel"),
            plain_ms=time_ms(torch, lambda: k3.multicorr_plain(*args), 10),
            bound_ms=b, bound_by=by, library_ms=None, variant=variant,
            shape=f"C={c} T={t} L={eng.max_period} table={codes.shape[1]}",
            **k3.cluster(t, codes.shape[1], eng.max_period, ring.dtype,
                         dev)))
    return out


def check_k2_e1(torch, np, rng, prns):
    """K2 at the E1 band's shapes: the band's acquisition engine
    (``receiver/bands.py``: 4 ms CBOC replicas, 125 Hz bins) over the
    PRNs of ``Channels_1B.satellites`` on two 16000-sample dwells."""
    from gnss_sdr_tpu_torch.acquisition.adapters import \
        make_galileo_e1_acquisition

    eng = make_galileo_e1_acquisition(sorted(prns), SCENE["fs"],
                                      doppler_max=5000.0, doppler_step=125.0,
                                      pfa=0.001, max_dwells=2, device="cuda")
    n = eng.cfg.fft_size
    ring = synthetic_e1_ring(np, rng, 2 * n, [(prns[0], 5432.0, 1130.0),
                                              (prns[2], 12345.0, -2610.0)])
    return check_k2_engine(torch, np, eng, ring_dwells(torch, np, ring, n),
                           "Galileo E1")


def e1_kernel_phase(torch, np, gal_prns):
    """The kernels of the multi-band path at the E1 band's shapes."""
    rng = np.random.default_rng(2025)
    res = [check_k1_e1(torch, np, rng, True),
           check_k1_e1(torch, np, rng, False)]
    res.extend(check_k3_e1(torch, np, rng))
    res.extend(check_k2_e1(torch, np, rng, gal_prns))
    report(res)
    return res


def mb_geometry():
    """(Galileo ephemerides, the first MB["gal_sats"] visible PRNs) of the
    multi-band scene, whose start is the L1 scene's."""
    from gnss_sdr_tpu_torch.simulate.scenario import (make_constellation,
                                                      rx_position,
                                                      visible_sats)

    t_start = scene_geometry()[3]
    ephs = make_constellation(range(1, 37), toe_s=SCENE["toe_s"],
                              spread_seed=MB["spread_seed"])
    prns = [int(v) for v in visible_sats(ephs, rx_position(), t_start)
            [:MB["gal_sats"]]]
    if len(prns) < 5:
        fail(f"only {len(prns)} visible Galileo satellites")
    return ephs, prns


def mb_scene(np, build_dir):
    """The L1 scene plus the Galileo E1 signals (pilot and data, no noise
    of their own), cached like the L1 scene."""
    from gnss_sdr_tpu_torch.simulate.rf_scene import generate_galileo_scene

    x, _, gps_prns, rx, _ = scene(np, build_dir)
    ephs, prns = mb_geometry()
    t_start = scene_geometry()[3]
    key = hashlib.sha1(json.dumps([SCENE, MB, gps_prns, prns],
                                  sort_keys=True).encode()).hexdigest()[:16]
    cache = os.path.join(build_dir, "scene_cache", f"l1e1-{key}.npy")
    t0 = time.perf_counter()
    if os.path.exists(cache):
        x = np.load(cache)
    else:
        x = x + generate_galileo_scene(
            ephs, prns, rx, t_start, SCENE["duration_s"], SCENE["fs"],
            bits_start_tow_s=MB["gal_bits_start_tow_s"],
            cn0_db_hz=MB["gal_cn0_db_hz"], seed=MB["gal_seed"], noise=False,
            pilot=True)
        np.save(cache + ".tmp.npy", x)
        os.replace(cache + ".tmp.npy", cache)
    return x, ephs, gps_prns, prns, rx, time.perf_counter() - t0


def mb_receiver_conf(gps_prns, gal_prns, xml) -> list[str]:
    """INI lines of the multi-band receiver: the L1 slice's keys plus a
    Galileo E1 group tracked on its pilot (the reference's E1 default)."""
    return receiver_conf(gps_prns, xml) + [
        "Channels_1B.count=8",
        "Channels_1B.satellites=" + ",".join(str(p) for p in gal_prns),
        "Acquisition_1B.implementation=Galileo_E1_PCPS_Ambiguous_Acquisition",
        "Tracking_1B.implementation=Galileo_E1_DLL_PLL_VEML_Tracking",
        "Tracking_1B.track_pilot=true",
        "TelemetryDecoder_1B.implementation=Galileo_E1B_Telemetry_Decoder"]


def multiband_phase(torch, np, build_dir, card):
    """The multi-band production receiver (GPS L1 C/A + Galileo E1 pilot)
    through ``make_receiver`` on the L1 scene plus seven E1 signals, with
    the counters read around the run. The INI carries no Galileo
    assistance (the JAX factory reads only the GPS XML), so the Galileo
    ephemerides go into ``receiver.ephemerides`` before the run, as the
    JAX tests pass them."""
    from gnss_sdr_tpu_torch.config import FileConfiguration
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.receiver.assistance import save_ephemeris_xml
    from gnss_sdr_tpu_torch.receiver.factory import make_receiver
    from gnss_sdr_tpu_torch.receiver.production_multiband import \
        ProductionMultiBandReceiver
    from gnss_sdr_tpu_torch.tracking.engine import TrackingEngine
    from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

    x, gal_ephs, gps_prns, gal_prns, rx, scene_s = mb_scene(np, build_dir)
    gps_ephs = scene_geometry()[0]
    fs = SCENE["fs"]
    xml = save_ephemeris_xml({p: gps_ephs[p] for p in gps_prns},
                             os.path.join(build_dir, "gps_ephemeris.xml"))
    conf = os.path.join(build_dir, "rx_multiband.conf")
    with open(conf, "w") as fh:
        fh.write("\n".join(mb_receiver_conf(gps_prns, gal_prns, xml)
                           + [""]))
    rec = make_receiver(FileConfiguration(conf))
    if not isinstance(rec, ProductionMultiBandReceiver):
        fail(f"make_receiver built {type(rec).__name__} for 1C + 1B")
    rec.ephemerides.update({("E", p): gal_ephs[p] for p in gal_prns})
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with CallLog(TrackingEngine, "process_block") as scan_log, \
            CallLog(FastTrackingEngine, "superblock_ring_i8") as fast_log:
        sols = rec.run(x)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    missing = [k for k in SLICE_KERNELS if launches[k] == 0]
    if missing:
        fail(f"multi-band: kernels never launched: {missing}")
    if launches["multicorr"] or launches["bank_corr"]:
        fail(f"multi-band: K3 / K1 launched outside the fused kernels: "
             f"{launches}")
    if not rec.in_fast_mode:
        fail("multi-band: the receiver never handed off to the fast engines")
    handoff_s = rec.handoff_sample / fs
    if not handoff_s < 4.0:
        fail(f"multi-band: handoff at {handoff_s} s, not before 4 s")
    ctx = rec._ctx["1B"]
    if ctx.k != 25:
        fail(f"multi-band: the E1 fast engine runs K = {ctx.k}, not 25")
    sec_locked = int(torch.sum(ctx.state.secondary_locked))
    if sec_locked < 6:
        fail(f"multi-band: {sec_locked} of 8 E1 channels secondary-locked")
    if len(sols) < 5:
        fail(f"multi-band: {len(sols)} fixes, fewer than 5")
    tail = sols[2 * len(sols) // 3:]
    errs = [float(np.linalg.norm(s.pos_ecef - rx)) for s in tail]
    mean_err = float(np.mean(errs))
    if not (np.isfinite(mean_err) and mean_err < 5.0):
        fail(f"multi-band: mean 3-D error {mean_err} m over the last third")
    if sols[-1].n_sats < 12:
        fail(f"multi-band: {sols[-1].n_sats} satellites in the last fix")
    tm = dict(rec.timings)
    by_band = band_launches(rec, scan_log.calls, fast_log.calls)
    for k in ("scan_loop", "fast_loop"):
        if sum(b[k] for b in by_band.values()) != launches[k]:
            fail(f"multi-band: {k} launches {launches[k]} are not the "
                 f"bands' {by_band}")
    # mid-run superblocks of the E1 band for fused_loop_phase: its last
    # ten phase-A blocks (float32 planes) and its second phase-B superblock
    e1_scan = next(b for b in rec.receiver.bands
                   if b.cfg.suffix == "1B").tracking.engine
    e1_fast = rec._ctx["1B"].fast
    mid = dict(scan=[c for c in scan_log.calls if c[0] is e1_scan][-10:],
               fast=[c for c in fast_log.calls if c[0] is e1_fast][1],
               e1_tables=(ctx.codes, ctx.data_codes))
    profile = profile_mb_phases(torch, scan_log.calls, fast_log.calls)
    return dict(
        fixes=len(sols), mean_err_last_third_m=mean_err, max_err_m=max(errs),
        last_fix_sats=sols[-1].n_sats, handoff_s=handoff_s,
        e1_secondary_locked=sec_locked, e1_k=ctx.k, timings=tm,
        rtf_phase_a=(tm["phase_a_samples"] / fs) / tm["phase_a_s"],
        rtf_phase_b=(tm["phase_b_samples"] / fs) / tm["phase_b_s"],
        rtf_total=(len(x) / fs) / run_s, run_s=run_s, scene_s=scene_s,
        channels={"1C": 8, "1B": 8}, gps_prns=gps_prns, gal_prns=gal_prns,
        gal_cn0_db_hz=MB["gal_cn0_db_hz"], profile=profile,
        launches={k: launches[k] for k in SLICE_KERNELS},
        launches_by_band=by_band, card=card), launches, mid


def band_launches(rec, scan_calls, fast_calls):
    """The multi-band run's K3-loop and K1-loop launches split by band,
    from the engine calls logged during the run (one launch a call) and
    checked against the blocks each band's engines ran: a scan block is
    one process_block call, a fast superblock one dispatch."""
    out = {}
    for band in rec.receiver.bands:
        trk, ctx = band.tracking, rec._ctx[band.cfg.suffix]
        n_scan = sum(c[0] is trk.engine for c in scan_calls)
        fast = [c[1][3] for c in fast_calls if c[0] is ctx.fast]
        if n_scan != trk.abs_block_start // band.block_samples \
                or sum(fast) * ctx.fast.block_samples \
                != ctx.base - trk.abs_block_start:
            fail(f"multi-band: band {band.cfg.suffix}'s logged calls do not "
                 "cover its blocks")
        out[band.cfg.suffix] = dict(scan_loop=n_scan, fast_loop=len(fast))
    return out


def profile_mb_phases(torch, scan_calls, fast_calls):
    """After the run (its launch counts already read): both bands' last
    ten phase-A blocks (one scan-engine call and one readback a block and
    band, as phase A runs them; the blocks' host-to-device copies
    excluded) and both bands' second phase-B superblocks (dispatched and
    read back), from the calls logged during the run (``busy_share``)."""
    def bind(inst, args, name):
        return lambda: getattr(inst, name)(*args)

    keep = set()
    for e in dict.fromkeys(c[0] for c in scan_calls):
        keep.update([i for i, c in enumerate(scan_calls) if c[0] is e][-10:])
    last = [scan_calls[i] for i in sorted(keep)]
    fast = [[c for c in fast_calls if c[0] is e][1]
            for e in dict.fromkeys(c[0] for c in fast_calls)]
    return dict(
        phase_a_10_blocks=busy_share(
            torch, [bind(i, a, "process_block") for i, a in last],
            lambda out: out[1]["packed"].cpu()),
        phase_b_superblock=busy_share(
            torch, [bind(i, a, "superblock_ring_i8") for i, a in fast],
            lambda out: out[1]["packed"].cpu()))


# ---------------------------------------------------------------------------
# the fused tracking programs (K3-loop, K1-loop) against their plain versions
# ---------------------------------------------------------------------------

def record_maxima(torch, pa, pb, valid, starts, rems, dopp, cn0, prompts):
    """The plain (pa) against the fused (pb) packed records: the largest
    boundary [samples], Doppler [Hz] and C/N0 [dB-Hz] difference over the
    valid rows and the largest relative prompt-magnitude difference
    (column lists index the record's last axis). Fails on rows that one
    path processed and the other did not."""
    if not torch.equal(pa[..., valid], pb[..., valid]):
        fail("fused: the valid rows differ from the plain version's")
    v = pa[..., valid] > 0.5
    a, b = pa.double(), pb.double()
    bnd = (a[..., starts] + a[..., rems]) - (b[..., starts] + b[..., rems])
    ma = torch.hypot(a[..., prompts[0]], a[..., prompts[1]])
    mb = torch.hypot(b[..., prompts[0]], b[..., prompts[1]])
    rel = (ma - mb).abs() / ma.clamp(min=1e-3 * float(ma.max()))
    return dict(
        boundary=float(bnd[v].abs().max()),
        doppler=float((a[..., dopp] - b[..., dopp])[v].abs().max()),
        cn0=float((a[..., cn0] - b[..., cn0])[v].abs().max()),
        prompt=float(rel[v].max()),
        prompt_abs=float((torch.cat([a[..., prompts[0]], a[..., prompts[1]]])
                          - torch.cat([b[..., prompts[0]],
                                       b[..., prompts[1]]])).abs().max()),
        valid_rows=int(v.sum()))


def state_maxima(torch, sa, sb):
    """The two end states: boundary and Doppler differences, and whether
    the lock flags agree."""
    bnd = (sa.offset.double() + sa.rem_code_phase_samples.double()) \
        - (sb.offset.double() + sb.rem_code_phase_samples.double())
    return dict(
        end_boundary=float(bnd.abs().max()),
        end_doppler=float((sa.carrier_doppler_hz
                           - sb.carrier_doppler_hz).abs().max()),
        end_flags_equal=bool(torch.equal(sa.active, sb.active)
                             and torch.equal(sa.loss_of_lock,
                                             sb.loss_of_lock)))


def fused_case(torch, name, variant, fused, plain, cols, first, bound_of,
               launches, shape, cluster, floor, first_ref=None):
    """One fused kernel call (``fused``: (state, packed)) against its plain
    version (``plain``) from the same state: the kernel's launch count in
    that call, the first period's or group's correlations (``first``
    selects them) to the bit or, given ``first_ref`` (the plain
    version's group prompt magnitudes [C], read after ``plain`` ran, and
    the float64 sums of the selected columns), the kernel's within
    FIRST_SEG_TOL of those sums, the records (``cols`` for record_maxima)
    and the end state within FUSED_TOL, and the bound of the plain
    record's work (``bound_of``: bytes, operations). Times (CUDA
    events): ``ms`` per call over back-to-back calls, ``event_us`` of one
    call between synchronizations, ``plain_ms`` of one plain call;
    ``device_us`` from the profiler (None when it records no device
    time). ``cluster``: the launch's cluster size and
    cudaOccupancyMaxActiveClusters; ``floor``: (serial steps of a
    channel, device us of one step on one cluster, from the stand-alone
    kernel at the same shape) or None; their product is the line's
    ``serial_floor_us``. Returns the kernel line."""
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    sb, pb = fused()
    torch.cuda.synchronize()
    got = {k: v for k, v in LAUNCHES.items() if v}
    if got != {name: 1}:
        fail(f"fused {name} ({variant}): launches {got}, not one {name}")
    sa, pa = plain()
    torch.cuda.synchronize()
    m = record_maxima(torch, pa, pb, *cols)
    m.update(state_maxima(torch, sa, sb))
    if first_ref is None:
        m["first_correlations_equal"] = bool(torch.equal(first(pa),
                                                         first(pb)))
    else:
        # over the channels that processed the first group (a channel
        # without a satellite correlates zero tables)
        v0 = pa[0, 0, :, cols[0]] > 0.5
        scale, ref = first_ref()
        err = (first(pa) - first(pb)).abs().amax(dim=-1)[v0]
        m["first_rel_err"] = float((err / scale[v0]).max())
        # both against the float64 sums of the same chips; the kernel is
        # held there (the plain version's float32 prefix sums carry an
        # error of their own)
        for key, p in (("kernel", pb), ("plain", pa)):
            e64 = (first(p).double() - ref).abs().amax(dim=-1)[v0]
            m[f"first_rel_err_f64_{key}"] = float((e64 / scale[v0]).max())
        m["first_correlations_equal"] = \
            m["first_rel_err_f64_kernel"] <= FIRST_SEG_TOL
    print(f"chip_smoke: fused {name} ({variant}): {json.dumps(m)}",
          file=sys.stderr, flush=True)
    for key, tol in FUSED_TOL.items():
        for k in (key, "end_" + key):
            if k in m and not m[k] <= tol:
                fail(f"fused {name} ({variant}): {k} {m[k]} > {tol}")
    if not (m["end_flags_equal"] and m["first_correlations_equal"]):
        fail(f"fused {name} ({variant}): {m}")
    b, by = bound_ms(*bound_of(pa))
    symbol = f"{name}_kernel"
    return dict(
        name=name, route="cuda",
        source="gnss_sdr_tpu_torch/kernels/csrc/"
        + ("fast_loop.cu" if name == "fast_loop_seg" else f"{name}.cu"),
        replaces={"scan_loop": "gnss_sdr_tpu/tracking/engine.py:474",
                  "fast_loop": "gnss_sdr_tpu/tracking/fast_engine.py:422",
                  "fast_loop_seg":
                      "gnss_sdr_tpu/tracking/fast_engine.py:746"}[name],
        launches=launches, max_abs_err=m["prompt_abs"], rel_err=m["prompt"],
        tol=FUSED_TOL["prompt"], maxima=m, ms=time_ms(torch, fused, 5),
        device_us=kernel_device_us(torch, fused, symbol),
        event_us=event_us(torch, fused, 3),
        plain_ms=event_us(torch, plain, 1) / 1e3, bound_ms=b, bound_by=by,
        library_ms=None, variant=variant, shape=shape,
        serial_floor_us=None if floor is None or floor[1] is None
        else floor[0] * floor[1],
        serial_steps=None if floor is None else floor[0], **cluster)


def scan_case(torch, eng, state, src_re, src_im, base, stride, n, codes,
              dcodes, fused, variant, launches, period_us):
    """K3-loop on ``n`` blocks against TrackingEngine._blocks_stepwise;
    ``period_us``: K3's device us for one period's window at this shape
    (the serial chain's step)."""
    from gnss_sdr_tpu_torch.kernels import scan_loop as k3l

    t = eng.cfg.n_taps
    c = eng.n_channels

    def plain():
        return eng._blocks_stepwise(state, src_re, src_im, base, stride, n,
                                    codes, dcodes)

    def run():
        out = fused()
        return out[0], out[1]["packed"]

    def bound_of(pa):
        # each period's window read once (every period of every channel
        # is correlated), the tables once, the records and the state in
        # and out once
        n_samp = float(torch.clamp(pa[..., 2], max=eng.max_period).sum())
        tables = codes.numel() + (dcodes.numel() if dcodes is not None
                                  else 0)
        state_b = sum(x.numel() * x.element_size() for x in state)
        return (n_samp * 2 * src_re.element_size() + tables * 4
                + pa.numel() * 4 + 2 * state_b,
                n_samp * (8 + 4 * t + (4 if dcodes is not None else 0)))
    return fused_case(
        torch, "scan_loop", variant, run, plain,
        (0, [1], [3], 8, 11, ([4, 6], [5, 7])),
        lambda p: torch.cat([p[0, 0, :, 4:8], p[0, 0, :, 15:]], -1),
        bound_of, launches,
        f"C={c} T={t} blocks={n} steps={eng.n_steps} L={eng.max_period} "
        f"{src_re.dtype}",
        k3l.cluster(eng, codes.shape[1], src_re.dtype, src_re.device),
        (n * eng.n_steps, period_us))


def fast_case(torch, fast, state, ring, base, n, bank, variant, launches,
              period_us=None):
    """K1-loop on ``n`` ring blocks against
    FastTrackingEngine._blocks_stepwise: the bank body, or for a segsum
    engine (``bank`` its raw tables) the segmented sum, K1-seg;
    ``period_us``: K1's device us at this shape (each window on a block
    of its own, all at once: one period's time on one block), the serial
    chain's step being a group's rounds of periods (None: not
    measured)."""
    from gnss_sdr_tpu_torch.kernels import fast_loop as k1l

    k, c, g = fast.k, fast.n_channels, fast.g
    seg = fast.correlator == "segsum"
    nt = fast.n_taps + int(fast.track_pilot)
    held = {}

    def plain():
        st, pk, pre, pim = fast._blocks_stepwise(
            state, ring[0], ring[1], base, fast.block_samples, n, bank)
        held["group"] = torch.hypot(pre[0, 0], pim[0, 0])
        return st, pk

    def first_ref():
        """The first group's prompt magnitudes [C] and the float64 sums of
        its record columns 3K..5K (the data prompt, or the prompt)."""
        step = fast.group_inputs(state)["step"]
        cre, cim, dre, dim_ = fast.segsum_corr(
            state, ring[0], ring[1], base, step, bank, torch.float64)
        if dre is None:
            pt = fast.n_taps // 2
            dre, dim_ = cre[:, :, pt], cim[:, :, pt]
        return held["group"], torch.cat([dre, dim_], dim=1)

    def run():
        out = fast.superblock_ring_i8(state, ring, base, n, bank)
        return out[0], out[1]["packed"]

    def bound_of(pa):
        # the windows once (the segmented sum: its group windows), two
        # bank rows a channel at least (or the tables), the records and
        # the state in and out once
        state_b = sum(x.numel() * x.element_size() for x in state)
        if seg:
            n_samp = n * g * c * fast.lg
            return (n_samp * 2 + bank.numel() * 4 + pa.numel() * 4
                    + 2 * state_b, n_samp * (8 + 4 * nt))
        n_samp = n * g * c * k * fast.n_eff
        return (n_samp * 2 + c * 2 * nt * fast.n_eff * 4 + pa.numel() * 4
                + 2 * state_b, n_samp * (8 + 8 * nt))
    jj = list(range(k))
    shape = f"C={c} K={k} T={nt} G={g} blocks={n} " + (
        f"lg={fast.lg} table={fast.table_len}" if seg
        else f"n_eff={fast.n_eff}") + " int8 ring"
    cluster = k1l.cluster(fast, ring.dtype, ring.device)
    rounds = -(-k // cluster["cluster_size"])
    return fused_case(
        torch, "fast_loop_seg" if seg else "fast_loop", variant, run, plain,
        (5 * k + 2, jj, [k + j for j in jj], 5 * k, 5 * k + 1,
         ([3 * k + j for j in jj], [4 * k + j for j in jj])),
        (lambda p: p[0, 0, :, 3 * k:5 * k]) if seg
        else (lambda p: p[0, 0, :, 2 * k:5 * k]), bound_of, launches, shape,
        cluster, (n * g * rounds, period_us), first_ref if seg else None)


def fused_loop_phase(torch, np, slice_mid, slice_launches, mb_mid, mb_band,
                     seg, card, unit_us):
    """K3-loop and K1-loop against their plain versions at the main
    path's shapes, each from a state the receivers reached mid-run: the
    L1 slice's last phase-A superblock (10 ring blocks) and its second
    phase-B superblock (10 blocks of 5 groups, K = 20); the multi-band
    run's E1 band over its last ten phase-A blocks (float32 planes,
    superblock_step; the pilot with the data prompt) and its second
    phase-B superblock (K = 25, the data tap, CS25). Then K1-loop's
    segmented-sum body (K1-seg): the segsum run's second superblock
    (``seg``: that call and the run's launches, from
    ``loop_variants_phase``) and the E1 band's second phase-B superblock
    again, on a segsum engine from the same state. ``unit_us``: the
    stand-alone K3's and K1's device us at the L1 and E1 shapes (keys
    ("scan_loop" | "fast_loop", "L1" | "E1")), the steps of the serial
    floors. Returns the kernel lines."""
    from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

    out = []
    eng, (state, ring, base, n, codes, dcodes) = slice_mid["scan"]
    out.append(scan_case(
        torch, eng, state, ring[0], ring[1], base, eng.block_samples, n,
        codes, dcodes, lambda: eng.superblock_ring_i8(
            state, ring, base, n, codes, dcodes),
        "GPS L1 C/A, phase A", slice_launches["scan_loop"],
        unit_us["scan_loop", "L1"]))
    fast, (state, ring, base, n, bank) = slice_mid["fast"]
    out.append(fast_case(torch, fast, state, ring, base, n, bank,
                         "GPS L1 C/A, phase B (fllpll)",
                         slice_launches["fast_loop"],
                         unit_us["fast_loop", "L1"]))
    calls = mb_mid["scan"]
    eng = calls[0][0]
    state, codes, dcodes = calls[0][1][0], calls[0][1][3], calls[0][1][4]
    re = torch.stack([cl[1][1] for cl in calls])
    im = torch.stack([cl[1][2] for cl in calls])
    out.append(scan_case(
        torch, eng, state, re.reshape(-1), im.reshape(-1), 0, re.shape[1],
        len(calls), codes, dcodes, lambda: eng.superblock_step(
            state, re, im, codes, dcodes),
        "Galileo E1 pilot + data prompt, phase A", mb_band["scan_loop"],
        unit_us["scan_loop", "E1"]))
    fast, (state, ring, base, n, bank) = mb_mid["fast"]
    out.append(fast_case(torch, fast, state, ring, base, n, bank,
                         "Galileo E1 pilot K=25 + data tap, phase B",
                         mb_band["fast_loop"], unit_us["fast_loop", "E1"]))
    (seg_fast, (state, ring, base, n, tables)), seg_launches = seg
    out.append(fast_case(torch, seg_fast, state, ring, base, n, tables,
                         "GPS L1 C/A, segsum run's second superblock",
                         seg_launches))
    # no receiver builds a segsum engine: the E1 superblock is the bank
    # engine's, rebuilt on the segmented sum (no E1 path launches it)
    seg_e1 = FastTrackingEngine(fast.cfg, fast.n_channels, fast.g,
                                correlator="segsum",
                                sec_max_len=fast.sec_max_len, device="cuda")
    state, ring, base, n, _ = mb_mid["fast"][1]
    out.append(fast_case(torch, seg_e1, state, ring, base, n,
                         seg_e1.get_bank(*mb_mid["e1_tables"]),
                         "Galileo E1 pilot K=25 + data prompt, phase B, "
                         "segsum (no E1 path runs it)", 0))
    for r in out:
        r["card"] = card
    report(out)
    return out


# ---------------------------------------------------------------------------
# the sharded path (gnss_sdr_tpu_torch/parallel/, K8)
# ---------------------------------------------------------------------------

#: shards of the logical mesh on one card
PAR_SHARDS = 4
#: one E5a noncoherent search's dwell grid [P, D, N] (36 PRNs, 32 bins,
#: 12000 samples: 55 MB of float32), K8b's full size
E5A_GRID = (36, 32, 12000)


def k8_line(torch, name, call, plain, library, got, want, n_bytes, n_ops,
            replaces, variant, shape, card):
    """One K8 kernel line: ``got`` against the plain version's ``want``
    (lists of tensors) to the bit; ``call``, the plain version and the
    library call (``library``) timed with CUDA events over back-to-back
    calls, ``call`` also as one synchronized call (``event_us``), its
    kernel's device time from the profiler."""
    err = max(float(torch.max(torch.abs(a.float() - b.float())))
              for a, b in zip(got, want))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    b, by = bound_ms(n_bytes, n_ops)
    return dict(name=name, route="cuda",
                source="gnss_sdr_tpu_torch/kernels/csrc/collectives.cu",
                replaces=replaces, max_abs_err=err, rel_err=err, tol=0.0,
                equal=equal, ms=time_ms(torch, call, 20),
                device_us=kernel_device_us(torch, call, f"{name}_kernel"),
                event_us=event_us(torch, call, 5),
                plain_ms=time_ms(torch, plain, 20),
                library_ms=time_ms(torch, library, 20),
                bound_ms=b, bound_by=by, variant=variant, shape=shape,
                card=card)


def acq_input(np, eng, ring):
    """The first dwell of ``eng``'s search on an int8 ``ring`` as its
    engine prepares it."""
    n = eng.cfg.consumed_samples
    r = ring[:, :n].cpu().numpy().astype(np.float32)
    return eng._prepare_buffer((r[0] + 1j * r[1]).astype(np.complex64), 0)


def parallel_phase(torch, np, slice_mid, mb_mid, card):
    """The sharded path on a logical mesh of PAR_SHARDS shards on the card,
    at full width, from the states the receivers reached mid-run:

    - channel-sharded engine calls (``parallel/engines.py``): the L1
      slice's phase-B fast superblock (K1-loop, 8 channels, K = 20) and
      its last phase-A scan superblock (K3-loop), the multi-band run's E1
      phase-B superblock (K = 25, the data tap), 2 channels a shard;
    - PRN-sharded PCPS grids (K2) at the L1 (8 PRNs x 40 bins x 4000) and
      E1 (7 x 80 x 16000) shapes on the scenes' first dwells;
    - K8a: the slice's 12 s planar int8 ring cut into PAR_SHARDS time
      shards, each followed by a halo of one fast block plus the fast
      engine's overlap; then the L1 fast superblock placed so that its
      last block crosses the end of shard 0 (and of shard 1) run on that
      shard plus its halo, its base moved by the shard's start;
    - K8b: PAR_SHARDS seeded dwell grids at E5A_GRID summed.

    The counters are set to 0 before these calls and read after them: one
    launch per K8 call, one fused launch per shard and call. Then each
    result is held to the bit against the unsharded call (the whole ring
    for the halo's superblocks) or the kernel's plain version, K8a and K8b
    are timed against their plain versions and library calls, each engine
    call sharded and on one device is timed (one synchronized call,
    median of three), and with two cards or more the engines and both
    collectives run again over the real cards. Returns (kernel lines,
    record)."""
    from gnss_sdr_tpu_torch.acquisition.adapters import (
        make_galileo_e1_acquisition, make_gps_l1ca_acquisition)
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.kernels import collectives as k8
    from gnss_sdr_tpu_torch.kernels.acq import pcps_magnitude_grid
    from gnss_sdr_tpu_torch.parallel import (channel_sharding, gather,
                                             make_mesh)
    from gnss_sdr_tpu_torch.parallel.engines import (ShardedEngine,
                                                     gather_outputs,
                                                     pcps_grid)
    from gnss_sdr_tpu_torch.parallel.multihost import (
        allreduce_noncoherent_grid, halo_exchange_blocks)

    n_sh = PAR_SHARDS
    mesh = make_mesh(n_sh, device="cuda", logical=True)
    scan, (s_state, ring, s_base, s_n, codes, dcodes) = slice_mid["scan"]
    fast, (f_state, f_ring, f_base, f_n, bank) = slice_mid["fast"]
    e1, (e_state, e_ring, e_base, e_n, e_bank) = mb_mid["fast"]
    calls = {
        "L1 fast superblock (K1-loop)":
            (fast, f_state, f_ring, f_base, f_n, bank, None),
        "E1 fast superblock (K1-loop, K = 25, data tap)":
            (e1, e_state, e_ring, e_base, e_n, e_bank, None),
        "L1 scan superblock (K3-loop)":
            (scan, s_state, ring, s_base, s_n, codes, dcodes)}
    acq_l1 = make_gps_l1ca_acquisition(
        sorted(scene_geometry()[1]), SCENE["fs"], doppler_max=5000.0,
        doppler_step=250.0, max_dwells=2, device="cuda")
    acq_e1 = make_galileo_e1_acquisition(
        sorted(mb_geometry()[1]), SCENE["fs"], doppler_max=5000.0,
        doppler_step=125.0, pfa=0.001, max_dwells=2, device="cuda")
    searches = {"GPS L1 C/A": (acq_l1, acq_input(np, acq_l1, f_ring)),
                "Galileo E1": (acq_e1, acq_input(np, acq_e1, e_ring))}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    dwell = torch.rand((n_sh,) + E5A_GRID, generator=gen, device="cuda")
    length = f_ring.shape[1] // n_sh
    halo = fast.overlap + fast.block_samples
    span = (f_n - 1) * fast.block_samples + fast.block_samples // 2
    edges = [g * length + length - span for g in (0, 1)]

    # ---- the sharded path, counted ---------------------------------------
    torch.cuda.synchronize()
    reset_launches()
    sharded = {}
    for what, (eng, st, rg, base, n, tab, dtab) in calls.items():
        sh = ShardedEngine(eng, mesh)
        sts, outs = sh.superblock_ring_i8(sh.shard_state(st), rg, base, n,
                                          tab, dtab)
        sharded[what] = (gather(mesh, sts), gather_outputs(mesh, outs))
    grids = {what: gather(mesh, pcps_grid(mesh, x, eng._code_fft,
                                          eng._dopplers, eng._c0,
                                          eng._offset, eng._eff))
             for what, (eng, x) in searches.items()}
    pieces = channel_sharding(mesh, dim=1).place(f_ring[:, :n_sh * length])
    haloed = halo_exchange_blocks(mesh, pieces, halo)
    edge = [fast.superblock_ring_i8(f_state, haloed[g], b - g * length,
                                    f_n, bank)[1]["packed"]
            for g, b in enumerate(edges)]
    summed = allreduce_noncoherent_grid(mesh, dwell)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    want = {"fast_loop": 2 * n_sh + len(edges), "scan_loop": n_sh,
            "acq_wipeoff": 2 * n_sh, "acq_product": 2 * n_sh,
            "acq_accum": 2 * n_sh, "halo_exchange": 1, "grid_allreduce": 1}
    if launches != want:
        fail(f"parallel: launches {launches}, expected {want}")

    # ---- held against one device and the plain versions (not counted) ---
    checks, call_ms = {}, {}
    for what, (eng, st, rg, base, n, tab, dtab) in calls.items():
        args = (st, rg, base, n, tab) + ((dtab,) if dtab is not None
                                         else ())
        s1, o1 = eng.superblock_ring_i8(*args)
        sn, on = sharded[what]
        checks[what] = bool(torch.equal(o1["packed"], on["packed"])
                            and all(torch.equal(a, b)
                                    for a, b in zip(s1, sn)))
        sh = ShardedEngine(eng, mesh)
        states = sh.shard_state(st)
        call_ms[what] = dict(
            one_device=event_us(torch, lambda: eng.superblock_ring_i8(
                *args), 3) / 1e3,
            sharded=event_us(torch, lambda: sh.superblock_ring_i8(
                states, rg, base, n, tab, dtab), 3) / 1e3)
    for what, (eng, x) in searches.items():
        g1 = pcps_magnitude_grid(x, eng._code_fft, eng._dopplers, eng._c0,
                                 eng._offset, eng._eff)
        checks[f"{what} grid {tuple(g1.shape)}"] = bool(
            torch.equal(g1, grids[what]))
    for g, b in enumerate(edges):
        whole = fast.superblock_ring_i8(f_state, f_ring, b, f_n,
                                        bank)[1]["packed"]
        checks[f"superblock across the end of shard {g} on shard + halo"] \
            = bool(torch.equal(whole, edge[g]))
    want_halo = k8.halo_exchange_plain(pieces, halo)
    want_sum = k8.grid_allreduce_plain(list(dwell.unbind(0)))
    checks["K8a = plain"] = all(torch.equal(a, b)
                                for a, b in zip(haloed, want_halo))
    checks["K8b = plain"] = all(torch.equal(a, b)
                                for a, b in zip(summed.unbind(0), want_sum))
    print(f"chip_smoke: parallel checks: {json.dumps(checks)}",
          file=sys.stderr, flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"parallel: sharded results differ from one device: {bad}")

    # ---- K8a and K8b: times against the plain versions and the library --
    rows = f_ring.shape[0]
    zeros = torch.zeros((rows, halo), dtype=f_ring.dtype, device="cuda")
    outs = [torch.empty((rows, length + halo), dtype=f_ring.dtype,
                        device="cuda") for _ in range(n_sh)]

    def cat_halo():
        for g in range(n_sh):
            tail = pieces[g + 1][:, :halo] if g + 1 < n_sh else zeros
            torch.cat([pieces[g], tail], dim=1, out=outs[g])

    red_out = torch.empty_like(dwell)

    def stack_sum():
        total = torch.stack(list(dwell.unbind(0))).sum(0)
        for o in red_out.unbind(0):
            o.copy_(total)

    lines = [
        k8_line(torch, "halo_exchange",
                lambda: halo_exchange_blocks(mesh, pieces, halo),
                lambda: k8.halo_exchange_plain(pieces, halo), cat_halo,
                haloed, want_halo,
                2.0 * n_sh * rows * (length + halo), 0.0,
                "gnss_sdr_tpu/parallel/multihost.py:61",
                "the slice's planar int8 ring in time shards",
                f"n={n_sh} rows={rows} L={length} halo={halo} int8", card),
        k8_line(torch, "grid_allreduce",
                lambda: allreduce_noncoherent_grid(mesh, dwell),
                lambda: k8.grid_allreduce_plain(list(dwell.unbind(0))),
                stack_sum, list(summed.unbind(0)), want_sum,
                2.0 * dwell.numel() * 4, (n_sh - 1) * float(dwell[0].numel()),
                "gnss_sdr_tpu/parallel/multihost.py:85",
                "E5a dwell grids",
                f"n={n_sh} P x D x N = {E5A_GRID} float32", card)]
    for ln in lines:
        ln["launches"] = launches.get(ln["name"], 0)
    report(lines)
    record = dict(shards=n_sh, logical=True, checks=checks,
                  launches=launches, call_ms=call_ms, halo=halo,
                  shard_len=length,
                  edge_bases=edges, card=card,
                  cards=cards_run(torch, np, calls, dwell, pieces, halo,
                                  k8))
    return lines, record


def cards_run(torch, np, calls, dwell, pieces, halo, k8):
    """With two cards or more: the L1 fast superblock's channels and both
    collectives over a mesh of the real cards (up to PAR_SHARDS), each
    against one card to the bit; the superblock's wall time on one card
    and sharded (the ring's window replicated, and for comparison the
    whole ring); the peer access between the cards and the copies staged
    where a card cannot read its peer; with four cards or more also
    :func:`mp_run`. None on one card."""
    from gnss_sdr_tpu_torch.parallel import make_mesh
    from gnss_sdr_tpu_torch.parallel.engines import (ShardedEngine,
                                                     gather_outputs)
    from gnss_sdr_tpu_torch.parallel.multihost import (
        allreduce_noncoherent_grid, halo_exchange_blocks)

    count = torch.cuda.device_count()
    if count < 2:
        print("chip_smoke: parallel: one card; only the logical mesh ran",
              file=sys.stderr, flush=True)
        return None
    n = min(count, PAR_SHARDS)
    mesh = make_mesh(n)
    peer = {f"{a}->{b}": bool(torch.cuda.can_device_access_peer(a, b))
            for a in range(n) for b in range(n) if a != b}
    for key in k8.STAGED:
        k8.STAGED[key] = 0
    eng, st, rg, base, nb, tab, _ = next(iter(calls.values()))
    sh = ShardedEngine(eng, mesh)
    states = sh.shard_state(st)
    _, outs = sh.superblock_ring_i8(states, rg, base, nb, tab)
    got = gather_outputs(mesh, outs, "cuda:0")["packed"]
    want = eng.superblock_ring_i8(st, rg, base, nb, tab)[1]["packed"]
    ok = {"L1 fast superblock": bool(torch.equal(got, want))}

    def wall_ms(fn):
        """Median of three calls, every card synchronized around each."""
        times = []
        for _ in range(4):
            for i in range(n):
                torch.cuda.synchronize(i)
            t = time.perf_counter()
            fn()
            for i in range(n):
                torch.cuda.synchronize(i)
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times[1:])[1]

    window = nb * eng.block_samples + eng.overlap
    superblock_ms = dict(
        one_card=wall_ms(lambda: eng.superblock_ring_i8(st, rg, base, nb,
                                                        tab)),
        sharded=wall_ms(lambda: sh.superblock_ring_i8(states, rg, base, nb,
                                                      tab)),
        sharded_whole_ring=wall_ms(lambda: sh.superblock_ring_i8(
            states, sh.replicate(rg), base, nb, tab)),
        window_bytes=2 * window, ring_bytes=int(rg.numel()))
    shards = [p.to(d) for p, d in zip(pieces[:n], mesh.devices)]
    haloed = halo_exchange_blocks(mesh, shards, halo)
    plain = k8.halo_exchange_plain([s.to("cuda:0") for s in shards], halo)
    ok["K8a"] = all(torch.equal(a.to("cuda:0"), b)
                    for a, b in zip(haloed, plain))
    grids = [g.to(d) for g, d in zip(dwell[:n].unbind(0), mesh.devices)]
    summed = allreduce_noncoherent_grid(mesh, grids)
    plain = k8.grid_allreduce_plain([g.to("cuda:0") for g in grids])
    ok["K8b"] = all(torch.equal(a.to("cuda:0"), b)
                    for a, b in zip(summed, plain))
    out = dict(cards=n, peer_access=peer, staged=dict(k8.STAGED),
               checks=ok, superblock_ms=superblock_ms)
    print(f"chip_smoke: parallel over {n} cards: {json.dumps(out)}",
          file=sys.stderr, flush=True)
    if not all(ok.values()):
        fail(f"parallel over {n} cards differs from one card: {ok}")
    if count >= 4:
        out["processes"] = mp_run(torch, np)
    return out


def mp_run(torch, np):
    """``parallel/mp_worker.py`` in two processes of two cards each over
    NCCL (rank r on cards 2r and 2r + 1), its gathered results held against
    the same work in this process on card 0: the scan prompts and the fast
    records to the bit, the halo exact, every shard's sum equal to the
    plain sum in shard order."""
    import socket

    from gnss_sdr_tpu_torch.kernels import build as kbuild
    from gnss_sdr_tpu_torch.kernels.collectives import grid_allreduce_plain
    from gnss_sdr_tpu_torch.parallel import make_mesh
    from gnss_sdr_tpu_torch.parallel.dryrun import (_example_inputs,
                                                    fast_engine_sharded_case)
    from gnss_sdr_tpu_torch.tracking.engine import (TrackingConfig,
                                                    TrackingEngine)

    outdir = os.path.join(kbuild.BUILD_DIR, "mp_run")
    os.makedirs(outdir, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gnss_sdr_tpu_torch.parallel.mp_worker",
         str(rank), "2", f"127.0.0.1:{port}", outdir],
        env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        fail(f"mp_worker over NCCL: exit codes "
             f"{[p.returncode for p in procs]}: {logs[0][-1500:]} "
             f"{logs[1][-1500:]}")
    data = np.load(os.path.join(outdir, "mp_out.npz"))
    n_dev = int(data["n_dev"])
    eng = TrackingEngine(TrackingConfig(fs=1.0e5), 2 * n_dev, 400,
                         device="cuda:0")
    state, block_re, block_im, codes = _example_inputs(eng, seed=11)
    prompts = []
    for _ in range(3):
        state, o = eng.process_block(state, block_re, block_im, codes)
        prompts.append(o["packed"][..., 4].cpu().numpy())
    shards = data["halo_in"]
    tail = np.concatenate([shards[1:, :16], np.zeros((1, 16), np.float32)])
    total = grid_allreduce_plain(
        list(torch.as_tensor(data["grids"]).unbind(0)))[0].numpy()
    fast_1, _ = fast_engine_sharded_case(make_mesh(1, device="cuda"), n_dev)
    checks = {
        "prompts": bool(np.array_equal(np.stack(prompts), data["prompts"])),
        "halo": bool(np.array_equal(np.concatenate([shards, tail], axis=1),
                                    data["haloed"])),
        "sums": all(bool(np.array_equal(g, total)) for g in data["summed"]),
        "fast": bool(data["fast_identical"])
        and bool(np.array_equal(fast_1, data["fast_packed"]))}
    out = dict(processes=2, cards_per_process=2, backend="nccl",
               shards=n_dev, wall_s=wall_s, checks=checks)
    print(f"chip_smoke: parallel over 2 processes: {json.dumps(out)}",
          file=sys.stderr, flush=True)
    if not all(checks.values()):
        fail(f"mp_worker over NCCL differs from one process: {checks}")
    return out


# ---------------------------------------------------------------------------
# K3-hd (the high-dynamics multicorrelator) and K7e (the beamformer)
# ---------------------------------------------------------------------------

#: 10 g along the line of sight at L1: the carrier's Doppler rate [Hz/s]
HD_DOPPLER_RATE = 98.0665 / (299792458.0 / 1575.42e6)
#: K3-hd's shapes: (variant, window, taps, table entries, entries a chip)
HD_SHAPES = (("GPS L1 C/A", 4016, 3, 1023, 1),
             ("Galileo E1 pilot", 16016, 5, 49104, 12))
#: amplitude and noise sigma (each of re, im) of the K3-hd windows: the
#: prompt's noise is ~1.6% of the signal's sum at L1, 0.8% at E1
HD_AMP, HD_SIGMA = 8.0, 8.0


def hd_windows(torch, np, rng, length, n_taps, table_len, cspc, accel):
    """K3-hd's arguments for 8 channels: float32 windows of one +-1 table
    read at the quadratic code phase of ``accel`` x 10 g (code rate from
    the carrier's by 1.023 / 1575.42) under its quadratic carrier, at
    amplitude HD_AMP in noise of HD_SIGMA; and the two rates."""
    from gnss_sdr_tpu_torch.ops.correlator import n_extra_bins

    c, fs = 8, SCENE["fs"]
    f_dot = HD_DOPPLER_RATE * accel
    code = np.sign(rng.standard_normal((c, table_len))).astype(np.float32)
    step = (np.full(c, 1.023e6 * cspc / fs)
            * (1.0 + rng.uniform(-3e-6, 3e-6, c))).astype(np.float32)
    code_rate = np.full(c, f_dot * 1.023e6 / 1575.42e6 * cspc / fs ** 2,
                        np.float32)
    carr_rate = np.full(c, 2.0 * np.pi * f_dot / fs ** 2, np.float32)
    rem = rng.uniform(0, 3, c).astype(np.float32)
    rem_carr = rng.uniform(0, 6.28, c).astype(np.float32)
    carr_step = rng.uniform(-0.01, 0.01, c).astype(np.float32)
    n = np.arange(length, dtype=np.float64)
    x = np.empty((c, length), np.complex64)
    for i in range(c):
        chip = np.floor(step[i] * n - rem[i] + 0.5 * code_rate[i] * n * n)
        ph = rem_carr[i] + carr_step[i] * n + 0.5 * carr_rate[i] * n * n
        x[i] = HD_AMP * code[i, chip.astype(np.int64) % table_len] \
            * np.exp(1j * ph) + HD_SIGMA * (rng.standard_normal(length)
                                            + 1j * rng.standard_normal(length))
    spc = 0.15 * cspc if n_taps == 5 else 0.5
    shifts = [-0.6 * cspc, -spc, 0.0, spc, 0.6 * cspc] if n_taps == 5 \
        else [-spc, 0.0, spc]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device="cuda")

    length_c = rng.integers(length - 16, length + 1, c).astype(np.int32)
    args = (t(x.real.astype(np.float32).ravel()),
            t(x.imag.astype(np.float32).ravel()), 0,
            t((np.arange(c) * length).astype(np.int32)), t(length_c),
            t(code), t(np.asarray(shifts, np.float32)), t(rem), t(step),
            t(rem_carr), t(carr_step), length, n_extra_bins(shifts))
    return args, t(carr_rate), t(code_rate)


def hd_flips(np, args, code_rate):
    """(sample, tap) pairs whose float32 code index (as K3-hd and its plain
    version form it) differs from the exact float64 index: chip edges the
    float32 form moves, reported, not hidden."""
    _, _, _, _, length, _, shifts, rem, step = args[:9]
    n_max = int(length.max())
    n = np.arange(n_max, dtype=np.float64)
    f32 = np.float32
    out = 0
    for i in range(length.shape[0]):
        s_, r_, q_ = (float(v[i]) for v in (step, rem, code_rate))
        nf = n.astype(f32)
        lin = (np.float64(s_) * nf - np.float64(r_)).astype(f32)
        quad = (f32(0.5) * f32(q_) * nf).astype(f32)
        base = (lin.astype(np.float64) + quad.astype(np.float64) * nf
                ).astype(f32)
        exact = s_ * n - r_ + 0.5 * q_ * n * n
        for sh in shifts.cpu().numpy():
            got = np.floor(base + f32(sh))
            out += int(np.sum(got[:int(length[i])]
                              != np.floor(exact + float(sh))[:int(length[i])]))
    return out


def hd_phase(torch, np, card):
    """K3-hd, the high-dynamics form of ``multicorr`` (a library entry: no
    engine passes rates, as in the JAX package), at the scan widths of
    L1 (4016 samples, 3 taps) and E1 (16016, 5 taps, 49104 entries), C =
    8, at 10 g and 1000 g. The path: one ``multicorr`` call with both
    rates per shape and dynamics, the counters read around the four
    calls; each output's prompt against the coherent sum the signal puts
    there (amplitude x valid samples). Then each call's kernel against
    its plain version (``multicorrelate_hd``) and the timings. Returns
    (kernel lines, record)."""
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.kernels import multicorr as k3

    rng = np.random.default_rng(2027)
    cases = []
    for variant, length, n_taps, table_len, cspc in HD_SHAPES:
        for accel in (1.0, 100.0):
            cases.append((variant, accel, *hd_windows(
                torch, np, rng, length, n_taps, table_len, cspc, accel)))
    torch.cuda.synchronize()
    reset_launches()
    outs = [k3.multicorr(*args, carr_rate, code_rate)
            for _, _, args, carr_rate, code_rate in cases]
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    if launches != {"multicorr_hd": len(cases)}:
        fail(f"K3-hd path: launches {launches}, not {len(cases)} "
             "multicorr_hd")
    rec, lines = [], []
    for (variant, accel, args, carr_rate, code_rate), got in zip(cases,
                                                                 outs):
        want = k3.multicorr_plain(*args, carr_rate, code_rate)
        mid = want[0].shape[1] // 2
        prompt = torch.hypot(want[0][:, mid], want[1][:, mid])
        err = torch.maximum((got[0] - want[0]).abs(),
                            (got[1] - want[1]).abs()).amax(dim=1)
        ideal = HD_AMP * args[4].double()
        gain = torch.hypot(got[0][:, mid].double(), got[1][:, mid].double()) \
            / ideal
        # without the rates (the linear model) at the same windows
        lin = k3.multicorr_plain(*args)
        lin_gain = torch.hypot(lin[0][:, mid].double(),
                               lin[1][:, mid].double()) / ideal
        r = dict(variant=variant, accel_g=10.0 * accel,
                 rel_err=float((err / prompt).max()),
                 gain_min=float(gain.min()), gain_max=float(gain.max()),
                 linear_model_gain_min=float(lin_gain.min()),
                 floor_flips_vs_f64=hd_flips(np, args, code_rate))
        rec.append(r)
        print(f"chip_smoke: multicorr_hd ({variant}, {10 * accel:g} g): "
              f"{json.dumps(r)}", file=sys.stderr, flush=True)
        if not 0.9 < r["gain_min"] <= r["gain_max"] < 1.1:
            fail(f"K3-hd ({variant}, {10 * accel:g} g): prompt gain "
                 f"{r['gain_min']}..{r['gain_max']} of the signal's sum")
        if accel != 1.0:
            continue
        # the kernel line of each shape: times at 10 g, errors over both
        c = args[4].shape[0]
        n_valid = int(args[4].clamp(max=args[11]).sum())
        t = args[6].shape[0]
        nb = n_valid * 8 + args[5].numel() * 4 + c * 8 * 4 + c * t * 8
        no = n_valid * (18 + 4 * t)
        b, by = bound_ms(nb, no)

        def run(args=args, cr=carr_rate, kr=code_rate):
            return k3.multicorr(*args, cr, kr)

        def plain(args=args, cr=carr_rate, kr=code_rate):
            return k3.multicorr_plain(*args, cr, kr)
        lines.append(dict(
            name="multicorr_hd", route="cuda",
            source="gnss_sdr_tpu_torch/kernels/csrc/multicorr.cu",
            replaces="gnss_sdr_tpu/ops/correlator.py:67",
            launches=launches.get("multicorr_hd", 0),
            max_abs_err=float(torch.max(torch.abs(got[0] - want[0]))),
            rel_err=r["rel_err"], tol=TOL["multicorr_hd"],
            ms=time_ms(torch, run),
            device_us=kernel_device_us(torch, run, "multicorr_hd_kernel"),
            plain_ms=time_ms(torch, plain, 10), bound_ms=b, bound_by=by,
            library_ms=None, variant=variant,
            shape=f"C={c} T={t} L={args[11]} table={args[5].shape[1]} "
            "float32 windows", card=card))
    for line in lines:
        same = [r for r in rec if r["variant"] == line["variant"]]
        line["rel_err"] = max(r["rel_err"] for r in same)
        line["dynamics"] = same
    report(lines)
    return lines, dict(cases=rec, launches=launches, card=card)


#: the beamformer's array: M antennas at half a wavelength, steered to
#: 10 degrees, a 20 dB noise jammer at 55 degrees, 1 s at 4 Msps
BF = dict(m=8, spacing=0.5, steer_deg=10.0, jam_deg=55.0, jam_db=20.0,
          n=4_000_000, seed=11)


def beamformer_phase(torch, np, card):
    """K7e through ``BeamformerFilter.steered(...).apply`` on a seeded
    8-antenna capture of 1 s at 4 Msps (a unit-power signal from the look
    direction, a 20 dB jammer off it), the counters read around the call:
    the JAX test's gain (``||corr| - 1| < 0.05``) and null (residual
    jammer power under 0.2 of one antenna's) bounds on the card's output,
    and its host->device, device and device->host split, of the first
    call and of a second one on the same capture. Then the kernel
    on the capture as ``apply`` sends it (complex64, interleaved) against
    its plain version (JAX's einsums), against itself on two contiguous
    planes (to the bit) and the library call (``torch.matmul`` of
    complex64 [1, M] by [M, N], TF32 off) on the same card tensors.
    Returns (kernel lines, record)."""
    from gnss_sdr_tpu_torch.conditioner.beamformer import (BeamformerFilter,
                                                           array_response)
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    p = BF
    m, n = p["m"], p["n"]
    rng = np.random.default_rng(p["seed"])
    t0 = time.perf_counter()
    sig = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
           / np.sqrt(2)).astype(np.complex64)
    jam = (10.0 ** (p["jam_db"] / 20.0) * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
        / np.sqrt(2)).astype(np.complex64)
    a_sig = array_response(m, p["spacing"], p["steer_deg"]).astype(
        np.complex64)
    a_jam = array_response(m, p["spacing"], p["jam_deg"]).astype(
        np.complex64)
    x = a_sig[:, None] * sig[None, :] + a_jam[:, None] * jam[None, :]
    gen_s = time.perf_counter() - t0
    bf = BeamformerFilter.steered(m, p["spacing"], p["steer_deg"],
                                  device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    y = bf.apply(x)
    apply_s = time.perf_counter() - t0
    launches = {k: v for k, v in LAUNCHES.items() if v}
    if launches != {"beamform": 1}:
        fail(f"beamformer: launches {launches}, not one beamform")
    timings = dict(bf.timings)
    # the same capture again: the first call also loads the kernel library
    # and launches the kernel for the first time
    if not np.array_equal(bf.apply(x), y):
        fail("beamformer: a second apply gave another output")
    corr = np.vdot(sig, y) / np.vdot(sig, sig)
    jam_res = float(np.mean(np.abs(y - corr * sig) ** 2))
    jam_single = float(np.mean(np.abs(x[0] - a_sig[0] * sig) ** 2))
    rec = dict(gain=float(abs(corr)), residual_over_one_antenna=jam_res
               / jam_single, timings=timings,
               second_timings=dict(bf.timings), apply_s=apply_s,
               generate_s=gen_s, m=m, n=n, launches=launches, card=card)
    print(f"chip_smoke: beamformer: {json.dumps(rec)}", file=sys.stderr,
          flush=True)
    if not abs(abs(corr) - 1.0) < 0.05:
        fail(f"beamformer: gain {abs(corr)} in the look direction")
    if not jam_res < 0.2 * jam_single:
        fail(f"beamformer: jammer residual {jam_res} >= 0.2 x {jam_single}")

    # the capture as apply() sends it (complex64 [M, N], interleaved) and
    # as two contiguous planes: K7e gives the same bits from both
    xc = torch.as_tensor(x, device="cuda")
    x_re, x_im = (a.contiguous() for a in torch.view_as_real(xc).unbind(-1))
    w_re, w_im = bf._w_re, bf._w_im
    got = k7.beamform_complex(xc, w_re, w_im)
    planar = torch.complex(*k7.beamform(x_re, x_im, w_re, w_im))
    want = torch.complex(*k7.beamform_plain(x_re, x_im, w_re, w_im))
    torch.cuda.synchronize()
    if not torch.equal(got, planar):
        fail("beamform: the interleaved and the planar capture differ")
    rms = float(torch.sqrt(torch.mean(torch.abs(want) ** 2)))
    err = float(torch.max(torch.abs(got - want)))
    wc = torch.complex(w_re, w_im)[None, :]
    b, by = bound_ms(8 * m * n + 8 * n, 8 * m * n)
    line = dict(
        name="beamform", route="cuda",
        source="gnss_sdr_tpu_torch/kernels/csrc/conditioner.cu",
        replaces="gnss_sdr_tpu/conditioner/beamformer.py:20",
        launches=launches.get("beamform", 0), max_abs_err=err,
        rel_err=err / rms, tol=TOL["beamform"],
        ms=time_ms(torch, lambda: k7.beamform_complex(xc, w_re, w_im), 20),
        device_us=kernel_device_us(
            torch, lambda: k7.beamform_complex(xc, w_re, w_im),
            "beamform_kernel"),
        planar_ms=time_ms(torch, lambda: k7.beamform(x_re, x_im, w_re, w_im),
                          20),
        plain_ms=time_ms(torch, lambda: k7.beamform_plain(x_re, x_im, w_re,
                                                          w_im), 10),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.matmul(wc, xc), 20),
        variant="8-antenna ULA, 1 s at 4 Msps",
        shape=f"M={m} N={n} complex64 interleaved", card=card)
    line.update(library_device(torch, lambda: torch.matmul(wc, xc)))
    report([line])
    return [line], rec


# ---------------------------------------------------------------------------
# acquisition variants (K5) and the fast engine's KF / Gaussian loops (K6)
# ---------------------------------------------------------------------------

#: the seeded Galileo E5a capture of the I/Q CAF search: 4 ms at 12 Msps
#: built as tests/test_acq_variants.py builds its one satellite, with
#: four (PRN, code delay [samples], Doppler [Hz]) present
E5A = dict(fs=12e6, ms=4, noise=0.9, seed=5,
           sats=((4, 5321, 1570.0), (11, 811, -2330.0), (19, 9876, 420.0),
                 (27, 2222, 3380.0)))
#: the loop variants' scan-engine pull-in before the fast engines take
#: over, and the tracking configuration of the JAX tests they mirror
#: (test_fast_engine.py::test_kf_loop_mode_tracks)
PULL_IN_BLOCKS = 50
LOOP_CFG = dict(extend_correlation_symbols=20, pll_bw_narrow_hz=5.0,
                dll_bw_narrow_hz=0.75, cn0_smoother_alpha=0.05)
VARIANT_KERNELS = ("fold_wipeoff", "cccwsr_combine", "acq_wipeoff",
                   "acq_product", "acq_accum", "acq_stats")


def scene_truth(np, ephs, prns, rx, t_rx, bits_start_s, code_chips, fs):
    """{prn: (code delay [samples] at time ``t_rx``, Doppler [Hz])} from
    the geometry the scene generators use (light time, satellite clock
    minus group delay, the transmit chip phase from the bit-stream
    origin). The delay is the acquisition's: the replica's start lies
    that many samples into the buffer."""
    from gnss_sdr_tpu_torch.constants.general import SPEED_OF_LIGHT_M_S
    from gnss_sdr_tpu_torch.simulate.scenario import true_range_and_rate

    out = {}
    for prn in prns:
        eph = ephs[prn]
        rho, rate, _ = true_range_and_rate(eph, rx, t_rx)
        tau = rho / SPEED_OF_LIGHT_M_S
        dts = eph.clock_bias_s(t_rx - tau) - eph.tgd_s
        chips = (t_rx - bits_start_s - tau + dts) * 1.023e6
        out[prn] = (float((-chips) % code_chips * fs / 1.023e6),
                    float(-rate / SPEED_OF_LIGHT_M_S * 1575.42e6))
    return out


def e5a_capture(np):
    """The E5a I/Q capture and its truth {prn: (delay, Doppler)}."""
    from gnss_sdr_tpu_torch.codes.galileo_e5a import galileo_e5a_code

    p = E5A
    rng = np.random.default_rng(p["seed"])
    n = int(p["fs"] * p["ms"] * 1e-3)
    t = np.arange(n) / p["fs"]
    x = np.zeros(n, np.complex128)
    for prn, delay, dopp in p["sats"]:
        ci = galileo_e5a_code(prn, "I").astype(np.float64)
        cq = galileo_e5a_code(prn, "Q").astype(np.float64)
        chips = np.floor((np.arange(n) - delay) * 10.23e6 / p["fs"]
                         ).astype(np.int64)
        x += ((ci[chips % 10230] + 1j * cq[chips % 10230]) / np.sqrt(2.0)
              * np.exp(2j * np.pi * dopp * t))
    x += p["noise"] * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64), {prn: (float(d), f)
                                    for prn, d, f in p["sats"]}


def on_card(torch, np, x):
    return torch.as_tensor(np.ascontiguousarray(x, np.complex64),
                           device="cuda")


def check_k5a(torch, np, eng, x, variant):
    """K5a on the QuickSync engine's own inputs (its first coherent
    interval of the scene)."""
    from gnss_sdr_tpu_torch.kernels import acq_variants as k5

    xs = on_card(torch, np, x[:eng.cfg.coherent_samples])
    dop, c0, s = eng._dopplers, eng._c0, eng.folding_factor
    got = k5.fold_wipeoff(xs, dop, c0, s)
    want = k5.fold_wipeoff_plain(xs, dop, c0, s)
    torch.cuda.synchronize()
    n, d, p = xs.shape[0], dop.shape[0], len(eng.prns)
    b, by = bound_ms(n * 8 + d * 4 + d * (n // s) * 8, d * n * 8)
    return dict(
        name="fold_wipeoff", route="cuda",
        source="gnss_sdr_tpu_torch/kernels/csrc/acq_variants.cu",
        replaces="gnss_sdr_tpu/acquisition/variants.py:34",
        max_abs_err=float(torch.max(torch.abs(got - want))),
        rel_err=rel_err(torch, torch.view_as_real(got),
                        torch.view_as_real(want)),
        tol=TOL["fold_wipeoff"],
        ms=time_ms(torch, lambda: k5.fold_wipeoff(xs, dop, c0, s)),
        device_us=kernel_device_us(
            torch, lambda: k5.fold_wipeoff(xs, dop, c0, s),
            "fold_wipeoff_kernel"),
        event_us=event_us(torch, lambda: k5.fold_wipeoff(xs, dop, c0, s)),
        plain_ms=time_ms(torch, lambda: k5.fold_wipeoff_plain(xs, dop, c0,
                                                              s), 10),
        bound_ms=b, bound_by=by, library_ms=None, variant=variant,
        shape=f"P={p} D={d} N={n} S={s}")


def check_k5b(torch, np, eng, x):
    """K5b on the CCCWSR engine's own correlation grids of the scene's
    first 4 ms (the E1-B and E1-C products through the plain K2 path)."""
    from gnss_sdr_tpu_torch.kernels import acq
    from gnss_sdr_tpu_torch.kernels import acq_variants as k5

    xs = on_card(torch, np, x[:eng.cfg.coherent_samples])
    spec = torch.fft.fft(acq.acq_wipeoff_plain(xs, eng._dopplers, eng._c0),
                         dim=-1)
    yb = torch.fft.ifft(acq.acq_product_plain(spec, eng._cb), dim=-1)
    yc = torch.fft.ifft(acq.acq_product_plain(spec, eng._cc), dim=-1)
    del spec
    gk, mk, ak = k5.cccwsr_combine(yb, yc)
    gp, mp, ap = k5.cccwsr_combine_plain(yb, yc)
    torch.cuda.synchronize()
    if not (torch.equal(ak, ap) and torch.equal(mk, mp)):
        fail("cccwsr_combine row peaks differ from the plain version")
    p, d, n = yb.shape
    b, by = bound_ms(2 * p * d * n * 8 + p * d * n * 4 + p * d * 8,
                     p * d * n * 12)
    out = dict(
        name="cccwsr_combine", route="cuda",
        source="gnss_sdr_tpu_torch/kernels/csrc/acq_variants.cu",
        replaces="gnss_sdr_tpu/acquisition/variants.py:135",
        max_abs_err=float(torch.max(torch.abs(gk - gp))),
        rel_err=rel_err(torch, gk, gp), tol=TOL["cccwsr_combine"],
        ms=time_ms(torch, lambda: k5.cccwsr_combine(yb, yc), 20),
        device_us=kernel_device_us(torch,
                                   lambda: k5.cccwsr_combine(yb, yc),
                                   "cccwsr_combine_kernel"),
        event_us=event_us(torch, lambda: k5.cccwsr_combine(yb, yc)),
        plain_ms=time_ms(torch, lambda: k5.cccwsr_combine_plain(yb, yc), 5),
        bound_ms=b, bound_by=by, library_ms=None, variant="Galileo E1",
        shape=f"P={p} D={d} N={n}")
    del yb, yc, gk, gp
    torch.cuda.empty_cache()
    return out


def judge(np, eng, res, truth, stamp, dopp_tol):
    """Per visible PRN: positive, the delay within 2 samples of the truth
    at ``stamp`` (circularly) and the Doppler within ``dopp_tol``; a
    positive verdict outside them is ``wrong``."""
    spc = eng.cfg.samples_per_code
    rows = {}
    for prn, (delay0, dopp) in truth.items():
        r = res.get(prn)
        if r is None:
            rows[prn] = dict(ok=False, wrong=False, missing=True)
            continue
        want = (delay0 - stamp) % spc
        err = abs(r.delay_samples - want)
        err = min(err, spc - err)
        derr = abs(r.doppler_hz - dopp)
        near = bool(err <= 2.0 and derr <= dopp_tol)
        rows[prn] = dict(
            ok=bool(r.positive and near), wrong=bool(r.positive and not near),
            delay_err=float(err), doppler_err_hz=float(derr),
            stat=float(r.test_statistic), positive=bool(r.positive))
    return rows


#: acquisition windows a search may take per visible satellite: the first
#: coherent interval, then a quarter interval later each time, over two
#: intervals (a data symbol or secondary-code transition inside a window
#: cancels part of its correlation: E1-B's 4 ms symbols and E1-C's CS25
#: chips change at every code period, and a quarter interval on moves the
#: transition towards the window's edge; later windows bring new symbols
#: and fresh noise), as a receiver searches again on the next dwell
SEARCH_WINDOWS = 8


def run_search(torch, np, name, eng, x, truth, dopp_tol, tong=False,
               require_all=True):
    """Searches of ``eng`` on the first coherent interval of ``x`` (Tong:
    consecutive dwells from there) with the counters read around the
    first; each visible PRN still missed is searched again a quarter
    interval later, up to ``SEARCH_WINDOWS`` windows.

    ``require_all``: every visible PRN must be acquired (positive, within
    2 samples and ``dopp_tol``) in one of the windows. Otherwise (the E1
    searches on the E1-B component alone, whose statistic at the true
    cell sits at the noise floor for satellites with a symbol transition
    in the window) the engine's own threshold decides: no positive
    verdict may be wrong, no absent PRN may be positive in the first
    window, and at least one visible PRN must be acquired."""
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches

    n = eng.cfg.coherent_samples
    span = 4 * n if tong else n
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = eng.search(x[:span])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in VARIANT_KERNELS if LAUNCHES[k]}
    # the same search again, its FFT plans and code spectra warm
    if tong:
        eng.reset()
    t0 = time.perf_counter()
    eng.search(x[:span])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    rows = judge(np, eng, res, truth, 0, dopp_tol)
    false_alarms = [p for p, r in res.items()
                    if p not in truth and r.positive]
    windows = {p: 1 for p, r in rows.items() if r["ok"]}
    wrong = [p for p, r in rows.items() if r["wrong"]]
    later = {}
    for w in range(1, SEARCH_WINDOWS):
        missed = [p for p in truth if p not in windows]
        if not missed:
            break
        lo = w * (n // 4)
        if tong:
            eng.reset()
        got = judge(np, eng, eng.search(x[lo:lo + span], lo),
                    {p: truth[p] for p in missed}, lo, dopp_tol)
        for p, r in got.items():
            later.setdefault(p, []).append(dict(r, window=w + 1))
            if r["ok"]:
                windows[p] = w + 1
            wrong += [p] if r["wrong"] else []
    missed = [p for p in truth if p not in windows]
    detail = f"{json.dumps(rows)} / {json.dumps(later)}"
    if require_all and missed:
        fail(f"{name}: PRNs {missed} not acquired within 2 samples and "
             f"{dopp_tol} Hz in {SEARCH_WINDOWS} windows: {detail}")
    if not require_all and (wrong or false_alarms or not windows):
        fail(f"{name}: wrong detections {wrong}, false alarms "
             f"{false_alarms}, {len(windows)} acquired: {detail}")
    out = dict(name=name, engine=type(eng).__name__, prns=len(eng.prns),
               wall_s=wall, warm_wall_s=warm, launches=launches,
               visible=rows,
               windows_needed=windows, not_acquired=missed,
               later_windows=later, doppler_tol_hz=dopp_tol,
               require_all=require_all,
               threshold=float(eng.threshold if tong
                               else eng.cfg.calculate_threshold()))
    print(f"chip_smoke: {name}: {len(windows)} of {len(truth)} visible "
          f"acquired, windows {windows}, first search {wall * 1e3:.1f} ms "
          f"(again {warm * 1e3:.1f} ms), launches {launches}",
          file=sys.stderr, flush=True)
    return out, launches


def tong_threshold(np, eng, x, truth):
    """The absolute Tong threshold, calibrated as tests/test_tong.py
    calibrates it: on one power-normalized dwell, midway between the
    strongest absent PRN's peak and the weakest visible PRN's peak above
    it."""
    import torch

    eng.threshold = float("inf")
    eng.reset()
    eng.process_dwell(x[:eng.cfg.consumed_samples])
    peaks = torch.amax(eng._grid_acc.reshape(len(eng.prns), -1),
                       dim=-1).cpu().numpy()
    eng.reset()
    floor = max(v for p, v in zip(eng.prns, peaks) if p not in truth)
    above = [peaks[eng.prns.index(p)] for p in truth
             if peaks[eng.prns.index(p)] > floor]
    if not above:
        fail(f"Tong: no visible PRN's one-dwell peak above the absent "
             f"PRNs' {floor}")
    eng.threshold = 0.5 * (float(floor) + float(min(above)))
    return eng.threshold


def acq_variants_phase(torch, np, build_dir, card):
    """K5a/K5b against their plain versions at the searches' shapes, then
    the QuickSync, Tong, CCCWSR and E5a I/Q CAF engines built by
    ``make_acquisition`` on the card, each over all PRNs of its system on
    the first milliseconds of a scene, with the counters read around
    each search. Returns (kernel lines, the searches' record)."""
    from gnss_sdr_tpu_torch.acquisition.adapters import make_acquisition

    t_phase = time.perf_counter()
    fs = SCENE["fs"]
    x, ephs, gps_prns, rx, scene_s = scene(np, build_dir)
    t0 = scene_geometry()[3]
    x = np.array(x[:200_000])
    l1_truth = scene_truth(np, ephs, gps_prns, rx, t0,
                           SCENE["bits_start_tow_s"], 1023, fs)
    xe, gal_ephs, _, gal_prns, _, mb_scene_s = mb_scene(np, build_dir)
    xe = np.array(xe[:200_000])
    e1_truth = scene_truth(np, gal_ephs, gal_prns, rx, t0,
                           MB["gal_bits_start_tow_s"], 4092, fs)
    x5, e5_truth = e5a_capture(np)
    kernels, searches, path = [], [], {}
    dev = "cuda"

    def tol(cfg):     # the JAX adapter test's 2/(3T) + one bin
        return 2.0 / (3.0 * cfg.sampled_ms * 1e-3) + cfg.doppler_step

    l1 = dict(fs=fs, device=dev)
    e1 = dict(fs=fs, doppler_step=125.0, device=dev)
    # (name, PRNs, configuration, buffer, truth, every visible required).
    # QuickSync folds 4 ms of L1 (4 code periods) into one: at 1 ms its
    # fold of two code halves costs 3 dB and leaves 45 dB-Hz at the noise
    # floor (its statistic 22-35 against the noise's 22-28 on the chip);
    # over whole periods the fold is a coherent sum. On E1, QuickSync and
    # Tong search the E1-B component alone (half the 45 dB-Hz), QuickSync
    # 3 dB lower still after its fold, and E1-B's symbol changes every
    # period: there the engine's own threshold (QuickSync at pfa 0.001)
    # decides
    plan = [
        ("GPS_L1_CA_PCPS_QuickSync_Acquisition", range(1, 33),
         dict(l1, sampled_ms=4, folding_factor=4), x, l1_truth, True),
        ("GPS_L1_CA_PCPS_Tong_Acquisition", range(1, 33), l1, x, l1_truth,
         True),
        ("Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition", range(1, 37), e1,
         xe, e1_truth, True),
        ("Galileo_E1_PCPS_QuickSync_Ambiguous_Acquisition", range(1, 37),
         dict(e1, pfa=0.001), xe, e1_truth, False),
        ("Galileo_E1_PCPS_Tong_Ambiguous_Acquisition", range(1, 37), e1, xe,
         e1_truth, False),
        ("Galileo_E5a_Noncoherent_IQ_Acquisition_CAF", range(1, 37),
         dict(fs=E5A["fs"], doppler_max=4000.0, doppler_step=250.0,
              max_dwells=2, caf_window_hz=1000.0, device=dev), x5, e5_truth,
         True),
    ]
    for name, prns, kw, buf, truth, require_all in plan:
        kw = dict(kw)
        eng = make_acquisition(name, list(prns), kw.pop("fs"), **kw)
        tong = "Tong" in name
        if tong:
            tong_threshold(np, eng, buf, truth)
        dtol = 250.0 if "E5a" in name else tol(eng.cfg)
        rec, launches = run_search(torch, np, name, eng, buf, truth, dtol,
                                   tong, require_all)
        searches.append(rec)
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v
        if "QuickSync" in name:
            k = check_k5a(torch, np, eng, buf,
                          "GPS L1 C/A" if "GPS" in name else "Galileo E1")
            k["launches"] = launches.get("fold_wipeoff", 0)
            kernels.append(k)
            if "GPS" in name:
                # the registry's default L1 QuickSync (1 ms, two code
                # halves folded), which no search here runs
                k = check_k5a(torch, np, make_acquisition(
                    name, list(prns), fs, device=dev), buf,
                    "GPS L1 C/A 1 ms (registry default)")
                k["launches"] = 0
                kernels.append(k)
        elif "CCCWSR" in name:
            k = check_k5b(torch, np, eng, buf)
            k["launches"] = launches.get("cccwsr_combine", 0)
            kernels.append(k)
        elif "E5a" in name:
            n = eng.cfg.consumed_samples
            for k in check_k2_engine(torch, np, eng._eng_i,
                                     [on_card(torch, np, buf[:n]),
                                      on_card(torch, np, buf[n:2 * n])],
                                     "Galileo E5a I/Q CAF"):
                k["launches"] = launches.get(k["name"], 0)
                kernels.append(k)
        del eng
        torch.cuda.empty_cache()
    for k in ("fold_wipeoff", "cccwsr_combine"):
        if not path.get(k):
            fail(f"acquisition variants: {k} never launched")
    for k in kernels:
        k["card"] = card
    report(kernels)
    return kernels, dict(searches=searches, launches=path,
                         scenes_s=scene_s + mb_scene_s,
                         phase_s=time.perf_counter() - t_phase, card=card)


def col_err(torch, a, b):
    """max |a - b| over each column's scale (b's largest magnitude)."""
    scale = torch.clamp(torch.amax(torch.abs(b), dim=0), min=1e-30)
    return float(torch.max(torch.abs(a - b) / scale))


def mat_err(torch, a, b):
    """max |a - b| over each matrix's largest |entry| of b."""
    scale = torch.clamp(torch.amax(torch.abs(b), dim=(1, 2), keepdim=True),
                        min=1e-30)
    return float(torch.max(torch.abs(a - b) / scale))


def check_k6(torch, np, rng):
    """K6a and K6b against their plain versions over 500 chained steps of
    8 channels (the Gaussian loop at orders 3 and 2, past its NIW and
    Bayesian-R transients), then timed at C = 4096."""
    from gnss_sdr_tpu_torch.kernels import loops
    from gnss_sdr_tpu_torch.ops.gaussian import (GaussianConfig,
                                                 gaussian_init, step_params)
    from gnss_sdr_tpu_torch.ops.kalman import KfConfig, _matrices, kf_init

    dev = torch.device("cuda")
    t = 0.02
    f, q, r = _matrices(KfConfig(), t)

    def noise(c, sigma, lo=None, hi=None):
        v = rng.uniform(lo, hi, c) if lo is not None \
            else rng.normal(0, sigma, c)
        return torch.as_tensor(v.astype(np.float32), device=dev)

    def kf_states(c):
        s = kf_init(rng.normal(size=c), rng.uniform(0, 6, c),
                    rng.uniform(-4000, 4000, c), device=dev)
        return (s.x, s.p)

    kf_in = [(noise(8, 0.05), noise(8, 0.2)) for _ in range(500)]
    k = p = kf_states(8)
    for ce, pe in kf_in:
        k = loops.kf_step(k[0], k[1], ce, pe, f, q, r)[:2]
        p = loops.kf_step_plain(p[0], p[1], ce, pe, f, q, r)[:2]
    torch.cuda.synchronize()
    kf_err = max(col_err(torch, k[0], p[0]), mat_err(torch, k[1], p[1]))
    gs_err, gs_abs = {}, 0.0
    for order in (3, 2):
        prm = step_params(GaussianConfig(order=order), t)
        s = gaussian_init(rng.uniform(-4000, 4000, 8),
                          GaussianConfig(order=order), t, device=dev)
        gk = gp = tuple(s)
        for _ in range(500):
            y, cn0 = noise(8, 0.2), noise(8, None, 35.0, 50.0)
            *gk, ik = loops.gaussian_step(*gk, y, cn0, prm)
            *gp, ip = loops.gaussian_step_plain(*gp, y, cn0, prm)
        torch.cuda.synchronize()
        if not (torch.equal(gk[2], gp[2]) and torch.equal(gk[3], gp[3])):
            fail(f"gaussian_step (order {order}) NIW counters differ")
        gs_abs = max(gs_abs, float(torch.max(torch.abs(gk[0] - gp[0]))))
        gs_err[order] = max(col_err(torch, gk[0], gp[0]),
                            mat_err(torch, gk[1], gp[1]),
                            col_err(torch, gk[4][:, None], gp[4][:, None]),
                            col_err(torch, gk[5][:, None], gp[5][:, None]),
                            col_err(torch, ik.T, ip.T))
    c = 4096
    xk, pk = kf_states(c)
    ce, pe = noise(c, 0.05), noise(c, 0.2)
    b, by = bound_ms(c * (16 + 64 + 8) + c * (16 + 64 + 16), c * 420)
    kf_row = dict(
        name="kf_step", route="cuda",
        source="gnss_sdr_tpu_torch/kernels/csrc/loops.cu",
        replaces="gnss_sdr_tpu/ops/kalman.py:77",
        max_abs_err=float(torch.max(torch.abs(k[0] - p[0]))),
        rel_err=kf_err, tol=TOL["kf_step"],
        ms=time_ms(torch, lambda: loops.kf_step(xk, pk, ce, pe, f, q, r)),
        device_us=kernel_device_us(
            torch, lambda: loops.kf_step(xk, pk, ce, pe, f, q, r),
            "kf_step_kernel"),
        event_us=event_us(torch,
                          lambda: loops.kf_step(xk, pk, ce, pe, f, q, r)),
        plain_ms=time_ms(torch, lambda: loops.kf_step_plain(
            xk, pk, ce, pe, f, q, r), 20),
        bound_ms=b, bound_by=by, library_ms=None,
        variant="500 chained steps at C=8; timed at C=4096",
        shape=f"C={c} n=4")
    prm = step_params(GaussianConfig(), t)
    gs = tuple(gaussian_init(rng.uniform(-4000, 4000, c), GaussianConfig(),
                             t, device=dev))
    y, cn0 = noise(c, 0.2), noise(c, None, 35.0, 50.0)
    b, by = bound_ms(c * (12 + 36 + 16 + 8) + c * (12 + 36 + 16 + 16),
                     c * 200)
    gs_row = dict(
        name="gaussian_step", route="cuda",
        source="gnss_sdr_tpu_torch/kernels/csrc/loops.cu",
        replaces="gnss_sdr_tpu/ops/gaussian.py:114",
        max_abs_err=gs_abs, rel_err=max(gs_err.values()),
        rel_err_by_order=gs_err, tol=TOL["gaussian_step"],
        ms=time_ms(torch, lambda: loops.gaussian_step(*gs, y, cn0, prm)),
        device_us=kernel_device_us(
            torch, lambda: loops.gaussian_step(*gs, y, cn0, prm),
            "gaussian_step_kernel"),
        event_us=event_us(torch,
                          lambda: loops.gaussian_step(*gs, y, cn0, prm)),
        plain_ms=time_ms(torch, lambda: loops.gaussian_step_plain(
            *gs, y, cn0, prm), 20),
        bound_ms=b, bound_by=by, library_ms=None,
        variant="500 chained steps at C=8, orders 3 and 2; timed at "
        "C=4096, order 3", shape=f"C={c} n=3")
    return [kf_row, gs_row]


def periods_into_bit(np, ephs, prns, rx, t0, bits0, fs, starts):
    """Per channel, how many code periods of the current data bit the
    truth puts before the period starting at absolute sample
    ``starts[ch]`` (the scenes' periods start at whole milliseconds of
    transmit time, their bits at whole 20 ms from ``bits0``)."""
    from gnss_sdr_tpu_torch.constants.general import SPEED_OF_LIGHT_M_S
    from gnss_sdr_tpu_torch.simulate.scenario import true_range_and_rate

    out = []
    for prn, s in zip(prns, starts):
        t_rx = t0 + s / fs
        rho, _, _ = true_range_and_rate(ephs[prn], rx, t_rx)
        tau = rho / SPEED_OF_LIGHT_M_S
        dts = ephs[prn].clock_bias_s(t_rx - tau) - ephs[prn].tgd_s
        out.append(int(round((t_rx - bits0 - tau + dts) * 1000.0)) % 20)
    return out


def align_to_bits(np, torch, fast, ts, into_bit):
    """The fast engine's state from the scan engine's, every channel's
    next group moved to its next data-bit boundary (as the production
    receiver's handoff does, ``receiver/production.py::_handoff``);
    ``into_bit(starts)`` gives the periods of the current bit before the
    channels' next periods."""
    cfg = fast.cfg
    state = fast.from_track_state(ts)
    k = cfg.extend_correlation_symbols
    offs = state.offset.cpu().numpy().astype(np.int64)
    rems = state.rem_code_phase_samples.cpu().numpy().astype(np.float64)
    rcarr = state.rem_carr_phase_rad.cpu().numpy().astype(np.float64)
    steps = 2.0 * np.pi * state.carrier_doppler_hz.cpu().numpy() / cfg.fs
    code_freq = cfg.chip_rate_cps \
        + state.code_doppler_chips.cpu().numpy().astype(np.float64)
    into = into_bit(offs + rems)
    for ch in range(len(into)):
        skip = (k - into[ch]) % k
        t_prn = cfg.fs * cfg.code_length_chips / code_freq[ch]
        old = offs[ch] + rems[ch]
        boundary = old + skip * t_prn
        offs[ch] = int(np.floor(boundary))
        rems[ch] = boundary - offs[ch]
        rcarr[ch] = np.fmod(rcarr[ch] + steps[ch] * (boundary - old),
                            2.0 * np.pi)
    dev = state.offset.device
    return state._replace(
        offset=torch.as_tensor(offs.astype(np.int32), device=dev),
        rem_code_phase_samples=torch.as_tensor(rems.astype(np.float32),
                                               device=dev),
        rem_carr_phase_rad=torch.as_tensor(rcarr.astype(np.float32),
                                           device=dev))


#: the engines run from the pulled-in state: (name, loop, correlator)
LOOP_RUNS = (("fllpll", "fllpll", "bank"), ("kf", "kf", "bank"),
             ("gaussian", "gaussian", "bank"), ("segsum", "fllpll", "segsum"))


def bank_vs_segsum(np, bank_rows, seg_rows, k, g, block_samples, base0,
                   prns):
    """tests/test_fast_engine.py::test_bank_vs_segsum_consistency's bounds
    between the bank and the segsum engine's records ([groups, C, 5K + 4],
    ``g`` groups a block of ``block_samples`` from ``base0``) on every
    channel: the mean Doppler of the last 8 groups within 1 Hz, the last
    C/N0 within 1 dB, each group's prompt-magnitude ratio within 2%, the
    last 40 period boundaries within 0.02 samples. Returns the worst
    figures; fails on a miss."""
    n = min(len(bank_rows), len(seg_rows))
    out = dict(doppler_hz=0.0, cn0_db=0.0, prompt_ratio=0.0, boundary=0.0)
    for ch, prn in enumerate(prns):
        per = []
        for rows in (bank_rows[:n], seg_rows[:n]):
            r = rows[:, ch].astype(np.float64)
            valid = r[:, 5 * k + 2] > 0.5
            prompt = np.abs(np.sum(r[:, 3 * k:4 * k]
                                   + 1j * r[:, 4 * k:5 * k], axis=1))
            per.append((r, valid, prompt))
        (rb, vb, pb), (rs, vs, ps) = per
        if not np.array_equal(vb, vs) or vb.sum() < 20:
            fail(f"bank vs segsum: PRN {prn}: valid groups differ or fewer "
                 f"than 20 ({int(vb.sum())}, {int(vs.sum())})")
        d = abs(np.mean(rb[vb, 5 * k][-8:]) - np.mean(rs[vs, 5 * k][-8:]))
        c = abs(rb[vb, 5 * k + 1][-1] - rs[vs, 5 * k + 1][-1])
        ratio = np.max(np.abs(pb[vb] / ps[vs] - 1.0))
        grp = np.arange(n)[vb]
        # absolute period boundaries: the block's start in the capture,
        # the block-relative start and the sub-sample remainder
        blk = base0 + (grp // g) * block_samples
        phb = (blk[:, None] + rb[vb, :k] + rb[vb, k:2 * k]).ravel()
        phs = (blk[:, None] + rs[vs, :k] + rs[vs, k:2 * k]).ravel()
        bnd = float(np.max(np.abs(phb[-40:] - phs[-40:])))
        for key, v, tol in (("doppler_hz", d, 1.0), ("cn0_db", c, 1.0),
                            ("prompt_ratio", ratio, 0.02),
                            ("boundary", bnd, 0.02)):
            out[key] = max(out[key], float(v))
            if not v < tol:
                fail(f"bank vs segsum: PRN {prn}: {key} {v} >= {tol}")
    out["groups"] = int(n)
    return out


def loop_variants_phase(torch, np, build_dir, card):
    """K6a/K6b against their plain versions, then the loop variants and
    the segmented-sum correlator on the slice's scene: the 8 visible PRNs
    started on a scan engine from the scene's truth (Doppler + 25 Hz, as
    test_kf_loop_mode_tracks starts its channel), pulled in and
    bit-synced over 1 s, then four ``FastTrackingEngine``s (``fllpll``,
    ``kf``, ``gaussian`` on the bank; ``fllpll`` on the segmented sum,
    K1-seg; C = 8, K = 20, 5 groups a block) run the rest of the capture
    from that one state through ``superblock_ring_i8``, with the counters
    read around each run. The segsum engine's records are held against
    the bank engine's (``bank_vs_segsum``). The groups start at the
    data-bit boundaries the scene's truth gives (the first second of this
    scene carries too few bit transitions for the receiver's bit
    synchronizer). Returns (kernel lines, the loops' record, the segsum
    run's second superblock call and its launches)."""
    from gnss_sdr_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_tpu_torch.kernels import LAUNCHES, reset_launches
    from gnss_sdr_tpu_torch.native import complex_to_quantized_i8
    from gnss_sdr_tpu_torch.tracking.channels import TrackingChannels
    from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig
    from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

    t_phase = time.perf_counter()
    kernels = check_k6(torch, np, np.random.default_rng(2026))
    fs = SCENE["fs"]
    x, ephs, prns, rx, _ = scene(np, build_dir)
    t0 = scene_geometry()[3]
    bits0 = SCENE["bits_start_tow_s"]
    truth = scene_truth(np, ephs, prns, rx, t0, bits0, 1023, fs)
    cfg = TrackingConfig(fs=fs, **LOOP_CFG)
    block = int(fs * 0.02)
    c = len(prns)
    tc = TrackingChannels(cfg, c, block, device="cuda")
    for ch, prn in enumerate(prns):
        delay, dopp = truth[prn]
        tc.start_channel(ch, prn, gps_l1ca_code(prn), delay, dopp + 25.0, 0)
    t_a = time.perf_counter()
    for b in range(PULL_IN_BLOCKS):
        outs = tc.process_block(x[b * block:(b + 1) * block + tc.overlap])
        for ch, periods in enumerate(outs):
            for p in periods:
                if p.loss_of_lock:
                    fail(f"loop variants: PRN {prns[ch]} lost lock in the "
                         "pull-in")
    pull_s = time.perf_counter() - t_a
    head = np.ascontiguousarray(x[:1 << 20].real, np.float32)
    ring = complex_to_quantized_i8(
        x, 16.0 / (float(np.sqrt(np.mean(head * head))) * np.sqrt(2.0)),
        "cuda")
    base0 = tc.abs_block_start

    def into_bit(starts):
        return periods_into_bit(np, ephs, prns, rx, t0, bits0, fs,
                                base0 + starts)

    k = cfg.extend_correlation_symbols
    runs, records = {}, {}
    for loop, loop_kind, corr in LOOP_RUNS:
        fast = FastTrackingEngine(cfg, c, 5, correlator=corr, loop=loop_kind,
                                  device="cuda")
        state = align_to_bits(np, torch, fast, tc.state, into_bit)
        bank = fast.get_bank(tc._code_tables_dev)
        n_blocks = (ring.shape[1] - base0 - fast.overlap) \
            // fast.block_samples
        torch.cuda.synchronize()
        reset_launches()
        t_b = time.perf_counter()
        packed = []
        with CallLog(FastTrackingEngine, "superblock_ring_i8") as calls, \
                CallLog(FastTrackingEngine, "_blocks_stepwise") as plain:
            for b0 in range(0, n_blocks, 10):
                nb = min(10, n_blocks - b0)
                state, out = fast.superblock_ring_i8(
                    state, ring, base0 + b0 * fast.block_samples, nb, bank)
                packed.append(out["packed"])
            packed = torch.cat(packed).cpu().numpy()
        wall = time.perf_counter() - t_b
        launches = {n: v for n, v in LAUNCHES.items() if v}
        kernel = "fast_loop_seg" if corr == "segsum" else "fast_loop"
        if launches.get(kernel) != len(calls.calls) or plain.calls:
            fail(f"loop {loop}: launches {launches} are not one {kernel} "
                 f"per engine call ({len(calls.calls)}), or the per-group "
                 f"path ran ({len(plain.calls)} calls)")
        if set(launches) != {kernel}:
            fail(f"loop {loop}: kernels other than {kernel} launched: "
                 f"{launches}")
        if corr == "segsum":
            seg_mid = (fast, calls.calls[1][1])
            seg_launches = launches[kernel]
        rows = packed.reshape(-1, c, 5 * k + 4)
        records[loop] = rows
        valid = rows[:, :, 5 * k + 2] > 0.5
        if (rows[:, :, 5 * k + 3] > 0.5).any():
            lost = [prns[ch] for ch in range(c)
                    if (rows[:, ch, 5 * k + 3] > 0.5).any()]
            fail(f"loop {loop}: PRNs {lost} lost lock")
        t_end = t0 + (base0 + n_blocks * fast.block_samples) / fs
        late = scene_truth(np, ephs, prns, rx, t_end - 0.1, bits0, 1023, fs)
        chans = {}
        for ch, prn in enumerate(prns):
            d = rows[valid[:, ch], ch, 5 * k]
            cn0 = rows[valid[:, ch], ch, 5 * k + 1]
            if len(d) < 10:
                fail(f"loop {loop}: PRN {prn} has {len(d)} valid groups")
            derr = float(np.mean(d[-10:]) - late[prn][1])
            chans[prn] = dict(doppler_err_hz=derr, cn0_db_hz=float(cn0[-1]),
                              groups=int(len(d)))
            if not abs(derr) < 5.0:
                fail(f"loop {loop}: PRN {prn} Doppler {derr} Hz off the "
                     "truth over its last 10 groups")
            if not abs(cn0[-1] - SCENE["cn0_db_hz"]) < 5.0:
                fail(f"loop {loop}: PRN {prn} C/N0 {cn0[-1]} dB-Hz")
        signal_s = n_blocks * fast.block_samples / fs
        runs[loop] = dict(wall_s=wall, signal_s=signal_s,
                          rtf_phase_b=signal_s / wall, launches=launches,
                          channels=chans)
        print(f"chip_smoke: loop {loop}: {signal_s:.1f} s of signal in "
              f"{wall:.2f} s ({signal_s / wall:.2f}x real time), worst "
              f"Doppler error "
              f"{max(abs(v['doppler_err_hz']) for v in chans.values()):.3f}"
              f" Hz, launches {launches}", file=sys.stderr, flush=True)
        kname = {"kf": "kf_step", "gaussian": "gaussian_step"}.get(loop)
        for kr in kernels:
            if kr["name"] == kname:     # its body ran inside K1-loop
                kr["launches"] = launches.get(kname, 0)
                kr["inlined_into"] = "fast_loop"
                kr["fused_launches"] = launches["fast_loop"]
    consistency = bank_vs_segsum(np, records["fllpll"], records["segsum"],
                                 k, fast.g, fast.block_samples, base0, prns)
    print(f"chip_smoke: bank vs segsum over {consistency['groups']} groups: "
          f"{json.dumps(consistency)}; phase-B RTF bank "
          f"{runs['fllpll']['rtf_phase_b']:.2f}, segsum "
          f"{runs['segsum']['rtf_phase_b']:.2f}", file=sys.stderr,
          flush=True)
    del ring
    for kr in kernels:
        kr["card"] = card
    report(kernels)
    return kernels, dict(pull_in_s=pull_s, pull_in_blocks=PULL_IN_BLOCKS,
                         prns=prns, handoff_sample=base0, runs=runs,
                         bank_vs_segsum=consistency,
                         phase_s=time.perf_counter() - t_phase,
                         card=card), (seg_mid, seg_launches)


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
    e1_res = e1_kernel_phase(torch, np, mb_geometry()[1])
    hd_res, hd_rec = hd_phase(torch, np, card)
    bf_res, bf_rec = beamformer_phase(torch, np, card)
    # the variant phases before the slices: torch.profiler records no
    # device time after the slices' profiled superblocks (on that card's
    # machine); they generate and cache the scenes the slices then load
    k5_res, acq_var = acq_variants_phase(torch, np, kbuild.BUILD_DIR, card)
    k6_res, loop_var, seg = loop_variants_phase(torch, np, kbuild.BUILD_DIR,
                                                card)
    slice_res, launches, slice_mid = slice_phase(torch, np,
                                                 kbuild.BUILD_DIR, card)
    mb_res, mb_launches, mb_mid = multiband_phase(torch, np,
                                                  kbuild.BUILD_DIR, card)
    e1 = mb_res["launches_by_band"]["1B"]
    # the serial floors' steps: the stand-alone K3 (one period's window
    # on one cluster) and K1 (one window a block) at the fused shapes
    unit_us = {("fast_loop", "L1"): res[0]["device_us"],
               ("scan_loop", "L1"): res[1]["device_us"],
               ("fast_loop", "E1"): e1_res[0]["device_us"],
               ("scan_loop", "E1"): e1_res[2]["device_us"]}
    fused_res = fused_loop_phase(torch, np, slice_mid, launches, mb_mid, e1,
                                 seg, card, unit_us)
    par_res, par_rec = parallel_phase(torch, np, slice_mid, mb_mid, card)
    # each kernel line's launches: the run of the path whose shapes it
    # was checked at (the L1 slice; the multi-band slice, where the fused
    # kernels count the E1 band's launches and K2 both bands'). K3 and K1
    # launch on no path now: their bodies run inside K3-loop and K1-loop,
    # whose launches the lines carry beside them
    for r in res:
        r["launches"] = launches.get(r["name"], 0)
    for r in e1_res:
        r["launches"] = mb_launches[r["name"]]
    for rows, counts in ((res, launches), (e1_res, e1)):
        for r in rows:
            if r["name"] in INLINED:
                r["inlined_into"] = INLINED[r["name"]]
                # the E1-B data-only engine runs on no path here (E1 is
                # tracked on its pilot)
                r["fused_launches"] = 0 if r["variant"] == "E1-B data only" \
                    else counts[INLINED[r["name"]]]
    for r in res + e1_res:
        r["card"] = card
    k7_res, cond_res = conditioned_phase(torch, np, kbuild.BUILD_DIR, card)
    print(json.dumps({"kernels": res + e1_res + k7_res + k5_res + k6_res
                      + fused_res + hd_res + bf_res + par_res,
                      "build_s": build_s}),
          flush=True)
    print(json.dumps({"slice": slice_res}), flush=True)
    print(json.dumps({"multiband": mb_res}), flush=True)
    print(json.dumps({"conditioned": cond_res}), flush=True)
    print(json.dumps({"variants": {"acquisition": acq_var,
                                   "loops": loop_var}}), flush=True)
    print(json.dumps({"high_dynamics": hd_rec, "beamformer": bf_rec}),
          flush=True)
    print(json.dumps({"parallel": par_rec}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
