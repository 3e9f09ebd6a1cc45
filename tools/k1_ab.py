"""Time K1 (``bank_corr`` of ``csrc/bank_corr.cu``) and K1-loop
(``fast_loop`` of ``csrc/fast_loop.cu``, the bank body) as built from two
source trees, on one card, each timing run in a fresh process.

    python3 tools/k1_ab.py OTHER_ROOT [--rounds 3]

``OTHER_ROOT`` is the root of another checkout (``git archive`` of a
commit or tree unpacked into a git-ignored directory). Both trees' two
sources are compiled at once with the port's ``nvcc`` flags into
``build/ab/`` (``tools/k2d_hd_ab.py::build``). Each round then runs this
tree, the other, the other, this (``tools/k2d_hd_ab.py::ab_runs``): a run
is a new Python process that imports its tree's wrappers
(``kernels/bank_corr.py``, ``kernels/fast_loop.py``) bound to its tree's
two libraries, makes the seeded inputs and reads each case's device time
a launch from ``torch.profiler`` (``chip_smoke.kernel_device_us``, 20
launches after a warm-up), as the kernel table does. The cases: K1 at
the main path's three shapes (``chip_smoke.k1_inputs``: L1 8 channels x
K = 20 x T = 3; the E1 pilot at K = 25 with the data tap, T = 6; E1-B
alone at K = 1, T = 5) and one K1-loop superblock (10 blocks; L1 5
groups of K = 20, E1 1 group of K = 25 with the data tap and CS25) from
a started state on a seeded synthetic ring (cached in ``build/ab/``). A
run of this tree also reads the device time of an empty kernel launched
as each K1 shape is (``chip_smoke.k1_floor_us``) and K1-loop's clusters.
Prints one JSON line: the card, the bounds, the medians over rounds, the
serial floors (a superblock's serial periods times the stand-alone K1's
median at the same shape), the host time of a fresh ``get_bank`` of the
L1 and the E1 pilot + data engines (:func:`bank_host_ms`), every run, ``ptxas -v``'s lines of both
trees' kernels, and whether every output of the two trees (K1's
correlations; K1-loop's records, group prompts and end state) is equal
to the bit; exits 1 if one is not.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.k2d_hd_ab import OUT_DIR, ab_runs, build  # noqa: E402
from tools.wipeoff_ab import chip_smoke  # noqa: E402

SOURCES = ("bank_corr", "fast_loop")
#: K1's shapes (``chip_smoke.K1_SHAPES``) and their seeds
K1_CASES = (("L1", 2024), ("E1", 2025), ("E1B", 2026))
#: K1-loop's superblocks: (variant, ring blocks)
LOOP_CASES = (("L1", 10), ("E1", 10))


def ring_cached(np, cs, variant: str, n: int, chans):
    """The seeded synthetic int8 ring [2, n] of ``variant``'s superblock,
    made once and kept in ``build/ab/``."""
    path = os.path.join(OUT_DIR, f"k1_ring_{variant}_{n}.npy")
    if os.path.exists(path):
        return np.load(path)
    rng = np.random.default_rng(7)
    ring = (cs.synthetic_ring if variant == "L1"
            else cs.synthetic_e1_ring)(np, rng, n, chans)
    os.makedirs(OUT_DIR, exist_ok=True)
    np.save(path + ".tmp.npy", ring)
    os.replace(path + ".tmp.npy", path)
    return ring


def loop_inputs(torch, np, cs, variant: str, n_blocks: int):
    """(fast engine, state, ring, bank) of one K1-loop superblock of
    ``n_blocks`` ring blocks at base 0: 8 channels started on the
    synthetic ring's signals with a realistic remnant state (the E1 pilot
    with its CS25 wipe-off armed)."""
    from gnss_sdr_tpu_torch.codes import gps_l1ca_code
    from gnss_sdr_tpu_torch.codes.galileo_e1 import (E1C_SECONDARY,
                                                     galileo_e1_subchips)
    from gnss_sdr_tpu_torch.tracking.engine import TrackingConfig
    from gnss_sdr_tpu_torch.tracking.fast_engine import FastTrackingEngine

    dev = torch.device("cuda")
    c = 8
    rng = np.random.default_rng(2031)
    if variant == "L1":
        fe = FastTrackingEngine(
            TrackingConfig(fs=4e6, extend_correlation_symbols=20), c, 5,
            device=dev)
        prns, period = list(range(11, 11 + c)), 4000
    else:
        fe = FastTrackingEngine(
            cs.e1_tracking_config(track_pilot=True,
                                  extend_correlation_symbols=25), c, 1,
            sec_max_len=25, device=dev)
        prns, period = [1, 2, 10, 12, 15, 17, 18, 21], 16000
    delays = rng.uniform(0, period, c)
    dopps = rng.uniform(-4500, 4500, c)
    ring = torch.as_tensor(ring_cached(
        np, cs, variant, n_blocks * fe.block_samples + fe.overlap,
        list(zip(prns, delays, dopps))), device=dev)
    s = fe.init_state()
    for ch in range(c):
        s = fe.start_channel(s, ch, float(dopps[ch]),
                             int(np.ceil(delays[ch])) % period)
        if variant != "L1":
            s = fe.set_secondary(s, ch, E1C_SECONDARY, ch % 25)
    s = s._replace(
        rem_code_phase_samples=torch.as_tensor(
            rng.uniform(0, 1, c).astype(np.float32), device=dev),
        rem_carr_phase_rad=torch.as_tensor(
            rng.uniform(0, 6.28, c).astype(np.float32), device=dev),
        code_doppler_chips=torch.as_tensor(
            (dopps / 1540.0).astype(np.float32), device=dev))
    if variant == "L1":
        bank = fe.get_bank(torch.as_tensor(
            np.stack([gps_l1ca_code(p) for p in prns]).astype(np.float32),
            device=dev))
    else:
        def tables(comp):
            return torch.as_tensor(
                np.stack([galileo_e1_subchips(p, comp, True)
                          for p in prns]).astype(np.float32), device=dev)

        bank = fe.get_bank(tables("C"), tables("B"))
    return fe, s, ring, bank


def bank_host_ms(torch, np, cs, rounds: int = 5) -> dict:
    """{variant: host ms of a fresh ``get_bank``} for the L1 and the E1
    pilot + data engines of :func:`loop_inputs` (8 channels): the bank and
    whatever its tree makes beside it, on the card and synchronized, the
    median of ``rounds`` calls, each with the engine's bank cache emptied
    (the receiver's handoff from phase A to phase B pays one)."""
    import time

    out = {}
    for variant in ("L1", "E1"):
        fe, _, _, _ = loop_inputs(torch, np, cs, variant,
                                  dict(LOOP_CASES)[variant])
        code, data = fe._bank_cache[:2]
        times = []
        for _ in range(rounds):
            fe._bank_cache = None
            torch.cuda.synchronize()
            t = time.perf_counter()
            fe.get_bank(code, data)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out[variant] = statistics.median(times)
    return out


def cases(torch, np, cs):
    """{case: (call, kernel symbol, outputs of a call as a list of
    tensors, (serial periods, K1 case) or None)} at every shape."""
    from gnss_sdr_tpu_torch.kernels import bank_corr as k1
    from gnss_sdr_tpu_torch.kernels import fast_loop as k1l

    out = {}
    for variant, seed in K1_CASES:
        fe, args = cs.k1_inputs(torch, np, np.random.default_rng(seed),
                                variant)
        # a tree whose engine owns the bank's packed form passes it
        kw = dict(packed=fe.packed_bank(args[6])) \
            if hasattr(fe, "packed_bank") else {}
        out[f"bank_corr/{variant}"] = (
            lambda args=args, kw=kw: k1.bank_corr(*args, **kw),
            "bank_corr_kernel", lambda r: list(r), None)
    for variant, n in LOOP_CASES:
        fe, s, ring, bank = loop_inputs(torch, np, cs, variant, n)

        def call(fe=fe, s=s, ring=ring, n=n, bank=bank):
            return k1l.fast_loop(fe, s, ring[0], ring[1], 0,
                                 fe.block_samples, n, bank)
        rounds = -(-fe.k // k1l.cluster(fe, ring.dtype, ring.device)
                   ["cluster_size"])
        out[f"fast_loop/{variant}"] = (
            call, "fast_loop_kernel", lambda r: [*r[1:], *r[0]],
            (n * fe.g * rounds, f"bank_corr/{variant}"), fe, ring)
    return out


def worker(root: str, bank_so: str, loop_so: str, out_path: str,
           extras: bool) -> dict:
    """One timing run of the tree at ``root`` (its wrappers bound to its
    two libraries); its outputs saved to ``out_path``."""
    import ctypes

    sys.path.insert(0, root)
    import numpy as np
    import torch

    cs = chip_smoke()
    from gnss_sdr_tpu_torch.kernels import build as kb
    from gnss_sdr_tpu_torch.kernels import fast_loop as k1l

    kb._libs["bank_corr"] = ctypes.CDLL(bank_so)
    kb._libs["fast_loop"] = ctypes.CDLL(loop_so)
    times, outs, extra = {}, {}, {}
    for case, (call, symbol, keep, floor, *more) in cases(
            torch, np, cs).items():
        r = call()
        torch.cuda.synchronize()
        outs[case] = [x.cpu() for x in keep(r)]
        times[case] = cs.kernel_device_us(torch, call, symbol)
        if extras and floor is None:
            c, k = outs[case][0].shape[:2]
            extra[f"{case}/floor_us"] = cs.k1_floor_us(torch, c * k)
        if extras and floor is not None:
            fe, ring = more
            extra[f"{case}/cluster"] = k1l.cluster(fe, ring.dtype,
                                                   ring.device)
            extra[f"{case}/serial_periods"] = floor[0]
    torch.save(outs, out_path)
    return dict(times=times, extra=extra,
                get_bank_host_ms=bank_host_ms(torch, np, cs))


def bounds(torch, np, cs) -> dict:
    """Each K1 case's bound in us (``chip_smoke.k1_bound_ms``)."""
    out = {}
    for variant, seed in K1_CASES:
        fe, args = cs.k1_inputs(torch, np, np.random.default_rng(seed),
                                variant)
        out[f"bank_corr/{variant}"] = cs.k1_bound_ms(torch, args,
                                                     fe.k)[0] * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", nargs="?")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--worker", nargs=5, metavar=("ROOT", "BANK_SO",
                                                  "LOOP_SO", "OUT", "EXTRAS"))
    args = ap.parse_args()
    if args.worker:
        root, bank_so, loop_so, out, extras = args.worker
        r = worker(root, bank_so, loop_so, out, extras == "1")
        print("K1_AB " + json.dumps(r), flush=True)
        return 0

    import numpy as np
    import torch

    from tools.wipeoff_ab import ptxas_lines

    cs = chip_smoke()
    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.other_root is None:
        ap.error("OTHER_ROOT is required")
    roots = {"this": ROOT, "other": os.path.abspath(args.other_root)}
    libs = build(roots, SOURCES)
    done = ab_runs(__file__, lambda tag, extras: (
        roots[tag], libs[(tag, "bank_corr")], libs[(tag, "fast_loop")],
        os.path.join(OUT_DIR, f"k1-{tag}.pt"), "1" if extras else "0"),
        args.rounds, "K1_AB ")
    extra = done[0][1]["extra"]
    runs = [dict(tree=tag, **r["times"]) for tag, r in done]
    a = torch.load(os.path.join(OUT_DIR, "k1-other.pt"))
    b = torch.load(os.path.join(OUT_DIR, "k1-this.pt"))
    agree = {case: len(a[case]) == len(b[case]) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        for x, y in zip(a[case], b[case])) for case in a}
    names = [k for k in runs[0] if k != "tree"]
    median = {case: {tag: statistics.median(
        r[case] for r in runs if r["tree"] == tag and r[case] is not None)
        for tag in ("this", "other")} for case in names}
    bank_ms = {v: {tag: statistics.median(
        r["get_bank_host_ms"][v] for t, r in done if t == tag)
        for tag in ("this", "other")} for v in ("L1", "E1")}
    serial = {}
    for case in names:
        steps = extra.get(f"{case}/serial_periods")
        if steps is not None:
            unit = median[f"bank_corr/{case.split('/')[1]}"]
            serial[case] = {tag: steps * unit[tag] for tag in unit}
    print(json.dumps({
        "card": cs.card_line(), "bound_us": bounds(torch, np, cs),
        "median_device_us": median, "serial_floor_us": serial,
        "median_get_bank_host_ms": bank_ms,
        "this_extra": extra,
        "ptxas": {f"{tag}/{name}": ptxas_lines(
            libs[(tag, name)] + ".log", ("bank_corr", "fast_loop_kernel"))
            for tag in roots for name in SOURCES},
        "bit_equal": agree, "runs": runs}))
    return 0 if all(agree.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
