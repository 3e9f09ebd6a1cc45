"""Time K7a (``fir_decim``) and K7c (``notch_mask``) of
``csrc/conditioner.cu`` as built from two source trees, on one card, at
the conditioned configs' shapes.

    python3 tools/k7_ab.py OTHER_ROOT [--n 96000000] [--rounds 3]

``OTHER_ROOT`` is the root of another checkout (``git archive`` of a
commit or tree unpacked into a git-ignored directory). Both sources are
compiled with the port's ``nvcc`` flags into ``build/ab/`` and loaded side
by side; each tree's launchers are called through ctypes as its own
wrapper calls them (K7c's launcher took a magnitude buffer before it took
a candidate buffer: the tool calls either).

On one seeded capture of ``--n`` complex64 samples at 8 Msps: K7a as
config A runs it (65 taps of the chain's low-pass, D = 2, IF 1.5 MHz),
and its two splits, the translation off and D = 1 with the translation
off (twice the outputs); K7c on the spectrum of the capture plus a CW
tone 30 dB over the noise (config C), into a new tensor and, for a tree
that has it, in place (the form ``notch_filter_block`` runs; timed on a
copy). Each round times every case this/other/other/this, as the median
of 10 single calls between CUDA events (``chip_smoke.event_us``); then
``torch.profiler`` splits this tree's K7a and in-place K7c by kernel.
Prints one JSON line: the card, the medians over rounds, the split,
every round, whether
the two trees' K7c outputs are equal to the bit and how far apart their
K7a outputs are (relative to the output's rms; 1e-5 is the kernels'
tolerance against the plain version).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FS = 8e6
IF_HZ = 1.5e6
TAPS, DECIM = 65, 2


def build(roots: dict) -> dict:
    """{tag: loaded library} of each root's ``conditioner.cu``, the
    builds run at once."""
    from gnss_sdr_tpu_torch.kernels import build as kb

    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for tag, root in roots.items():
        csrc = os.path.join(root, "gnss_sdr_tpu_torch", "kernels", "csrc")
        so = os.path.join(out_dir, f"conditioner-{tag}.so")
        procs[tag] = (so, subprocess.Popen(
            [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", csrc, "-o", so,
             os.path.join(csrc, "conditioner.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {tag} tree:\n{log}")
        lib = ctypes.CDLL(so)
        lib.fir_decim.argtypes = [kb.VP, kb.I64, kb.VP, kb.I32, kb.I32,
                                  kb.I32, kb.F64, kb.I64, kb.VP, kb.I64,
                                  kb.VP]
        # K7c's launcher: a candidate buffer (since the bracket select) or
        # a magnitude buffer and a threshold
        lib.notch_mask.argtypes = [kb.VP, kb.I64, kb.F32, kb.VP, kb.VP,
                                   kb.U32 if hasattr(lib, "notch_sel_words")
                                   else kb.VP, kb.VP, kb.U32, kb.U32, kb.VP]
        libs[tag] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root")
    ap.add_argument("--n", type=int, default=96_000_000)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from gnss_sdr_tpu_torch.conditioner.fir import (design_lowpass_taps,
                                                    nco_step)
    from gnss_sdr_tpu_torch.kernels import build as kb
    from gnss_sdr_tpu_torch.kernels import conditioner as k7

    if not torch.cuda.is_available():
        print("k7_ab: no CUDA device", file=sys.stderr)
        return 1
    libs = build({"this": ROOT, "other": os.path.abspath(args.other_root)})
    dev = torch.device("cuda")
    n = args.n
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, dtype=torch.complex64, device=dev, generator=g)
    fs_mid = FS / DECIM
    taps = torch.as_tensor(design_lowpass_taps(FS, 0.45 * fs_mid,
                                               0.1 * fs_mid, TAPS),
                           device=dev)
    step = nco_step(IF_HZ, FS)
    tone = torch.exp(2j * np.pi * 0.0875 * torch.arange(
        n, dtype=torch.float64, device=dev)).to(torch.complex64)
    spec = torch.fft.fft(x + float(np.sqrt(2e3)) * tone)
    del tone
    factor = float(np.float32(8.0))
    lo, hi = k7.median_ranks(n)

    def fir(tag, decim, translate):
        n_out = k7.fir_output_len(n, decim)
        y = torch.empty(n_out, dtype=torch.complex64, device=dev)
        err = libs[tag].fir_decim(
            x.data_ptr(), n, taps.data_ptr(), TAPS, decim, int(translate),
            step if translate else 0.0, 0, y.data_ptr(), n_out,
            kb.stream_ptr(dev))
        kb.check(err, f"fir_decim ({tag})")
        return y

    def in_place(tag):
        return hasattr(libs[tag], "notch_sel_words")

    def notch(tag, work=None):
        """K7c of tree ``tag`` into a new tensor, or in place on ``work``
        (a copy of the spectrum)."""
        lib = libs[tag]
        stream = kb.stream_ptr(dev)
        if not in_place(tag):
            out = torch.empty_like(spec)
            mag = torch.empty(n, dtype=torch.float32, device=dev)
            sel = torch.empty(4 + 512, dtype=torch.int32, device=dev)
            thr = torch.empty(1, dtype=torch.float32, device=dev)
            err = lib.notch_mask(spec.data_ptr(), n, factor, mag.data_ptr(),
                                 sel.data_ptr(), thr.data_ptr(),
                                 out.data_ptr(), lo, hi, stream)
        else:
            src = spec if work is None else work
            out = torch.empty_like(spec) if work is None else work
            sel = torch.empty(lib.notch_sel_words(), dtype=torch.int32,
                              device=dev)
            cap = k7.notch_candidates(n)
            cand = torch.empty(cap, dtype=torch.int32, device=dev)
            err = lib.notch_mask(src.data_ptr(), n, factor, sel.data_ptr(),
                                 cand.data_ptr(), cap, out.data_ptr(), lo,
                                 hi, stream)
        kb.check(err, f"notch_mask ({tag})")
        return out

    # the outputs compared across the trees
    ya = {tag: fir(tag, DECIM, True) for tag in libs}
    za = {tag: notch(tag) for tag in libs}
    torch.cuda.synchronize()
    rms = float(torch.sqrt(torch.mean(torch.abs(ya["other"]) ** 2)))
    fir_rel = float(torch.max(torch.abs(ya["this"] - ya["other"]))) / rms
    notch_equal = bool(torch.equal(za["this"], za["other"]))
    del ya, za
    work = spec.clone()
    cases = {
        "fir_decim": lambda tag: fir(tag, DECIM, True),
        "fir_decim_translate_off": lambda tag: fir(tag, DECIM, False),
        "fir_decim_d1_translate_off": lambda tag: fir(tag, 1, False),
        "notch_mask_new_tensor": notch,
        "notch_mask_in_place": lambda tag: notch(tag, work),
    }
    rounds = []
    for _ in range(args.rounds):
        r = {}
        for case, fn in cases.items():
            for i, tag in enumerate(("this", "other", "other", "this")):
                if case == "notch_mask_in_place" and not in_place(tag):
                    continue
                r[f"{case}/{tag}_{i}"] = cs.event_us(torch,
                                                    lambda: fn(tag))
        rounds.append(r)

    # this tree's device time a launch of each kernel of a call, from the
    # profiler (empty where it records no device time)
    split = {}
    for case in ("fir_decim", "notch_mask_in_place"):
        _, _, kernels = cs.profile(torch, lambda: cases[case]("this"), 5)
        split[case] = {k: u for k, (u, _) in kernels.items()}

    def med(case, tag):
        v = [u for r in rounds for k, u in r.items()
             if k.startswith(f"{case}/{tag}_")]
        return statistics.median(v) if v else None

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    n_out = k7.fir_output_len(n, DECIM)
    print(json.dumps({
        "n": n, "taps": TAPS, "decimation": DECIM, "if_hz": IF_HZ,
        "card": card.strip(),
        "bound_us": {
            "fir_decim": cs.bound_ms(n * 8 + TAPS * 4 + n_out * 8,
                                     n * 6 + n_out * TAPS * 4)[0] * 1e3,
            "notch_mask": cs.bound_ms(2 * n * 8, 5 * n)[0] * 1e3},
        "notch_equal_to_the_bit": notch_equal,
        "fir_rel_diff": fir_rel,
        "median_us": {case: {tag: med(case, tag) for tag in libs}
                      for case in cases},
        "split_us_this": split,
        "fir_occupancy_this": k7.fir_occupancy(TAPS, DECIM, True, dev),
        "rounds": rounds}))
    return 0 if notch_equal and fir_rel <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
