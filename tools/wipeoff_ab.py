"""Time K2a (``acq_wipeoff`` of ``csrc/acq.cu``) and K5a (``fold_wipeoff``
of ``csrc/acq_variants.cu``) as built from two source trees, on one card,
each timing run in a fresh process.

    python3 tools/wipeoff_ab.py OTHER_ROOT [--rounds 3]

``OTHER_ROOT`` is the root of another checkout (``git archive`` of a
commit or tree unpacked into a git-ignored directory). Both trees' two
sources are compiled at once with the port's ``nvcc`` flags into
``build/ab/`` (``tools/k2d_hd_ab.py::build``). Each round then runs
this tree, the other, the other, this (``tools/k2d_hd_ab.py::ab_runs``):
a run is a new Python process that imports its tree's wrappers
(``kernels/acq.py``, ``kernels/acq_variants.py``) bound to its tree's
two libraries, makes the seeded inputs and reads each case's device time
a launch from ``torch.profiler`` (``chip_smoke.kernel_device_us``, 20
launches after a warm-up), as the kernel table does, and the wrapper's
host time a call split by step (``chip_smoke.wrapper_host_split``). The
timed cases (``TIMED``): K2a at the PCPS searches' shapes (L1 40 bins x
4000 samples, E1 80 x 16000, E5a 32 x 12000 at 12 Msps) and K5a at the
QuickSync searches' (L1 4 ms folded by 4, E1 4 ms folded by 2), each on
its search's Doppler grid. Checked for agreement only (``CHECKED``): an
odd N, a one-bin refine grid, a grid off zero, K5a at S = 3 and S = 1. A
run of this tree also reads the device time of an empty kernel launched
as each timed case is (``wipeoff_empty``), ``ptxas -v``'s lines for the
wipe-off kernels of both trees, and the issue-rate floor of each timed
case from this tree's SASS (``chip_smoke.wipeoff_issue_floor``). Prints
one JSON line: the card, the bounds, the medians over rounds, every run,
and whether the two trees' outputs are equal to the bit at every case;
exits 1 if they are not.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.k2d_hd_ab import OUT_DIR, ab_runs, build  # noqa: E402

SOURCES = ("acq", "acq_variants")
#: (case, S, N, bins, first bin Hz, bin step Hz, sample rate): the timed
#: cases at the searches' shapes and grids
TIMED = (("acq_wipeoff/L1", 1, 4000, 40, -5000.0, 250.0, 4e6),
         ("acq_wipeoff/E1", 1, 16000, 80, -5000.0, 125.0, 4e6),
         ("acq_wipeoff/E5a", 1, 12000, 32, -4000.0, 250.0, 12e6),
         ("fold_wipeoff/L1", 4, 16000, 40, -5000.0, 250.0, 4e6),
         ("fold_wipeoff/E1", 2, 16000, 80, -5000.0, 125.0, 4e6))
#: the other layouts and grids, checked for agreement only
CHECKED = (("acq_wipeoff/odd_n", 1, 4001, 40, -5000.0, 250.0, 4e6),
           ("acq_wipeoff/refine", 1, 4000, 1, 1234.5, 25.0, 4e6),
           ("acq_wipeoff/off_zero", 1, 4000, 41, -4870.0, 250.0, 4e6),
           ("fold_wipeoff/S3", 3, 12000, 40, -5000.0, 250.0, 4e6),
           ("fold_wipeoff/S1", 1, 4000, 40, -5000.0, 250.0, 4e6))


def ptxas_lines(log_path: str, keys=("wipeoff",)) -> dict:
    """{kernel entry: ptxas's resource lines} for the kernels whose entry
    names hold one of ``keys`` (the wipe-off kernels) in the ``nvcc
    -Xptxas -v`` log at ``log_path``."""
    out, entry = {}, None
    with open(log_path) as fh:
        log = fh.read()
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] \
                if any(k in line for k in keys) else None
        elif entry and ("Used" in line or "stack frame" in line):
            out[entry] = (out.get(entry, "") + " "
                          + line.split(":", 1)[-1].strip()).strip()
    return out


def chip_smoke():
    """This tree's ``chip_smoke.py`` as a module, whichever tree's
    package comes first on the path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def case_inputs(torch, np, s, n, d, f0, step, fs, dev):
    """The seeded buffer [N] complex64, the float32 grid f0 + step i and
    the float32 constant c0 = -2 pi / fs."""
    rng = np.random.default_rng(n * 131 + d * 7 + s)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        .astype(np.complex64)
    dop = (f0 + step * np.arange(d)).astype(np.float32)
    c0 = float(np.float32(-2.0 * np.pi) / np.float32(fs))
    return (torch.as_tensor(x, device=dev), torch.as_tensor(dop, device=dev),
            c0)


def worker(root: str, acq_so: str, var_so: str, out_path: str,
           extras: bool) -> dict:
    """One timing run of the tree at ``root`` (its wrappers bound to its
    two libraries); its outputs saved to ``out_path``."""
    import ctypes

    sys.path.insert(0, root)
    import numpy as np
    import torch

    cs = chip_smoke()
    from gnss_sdr_tpu_torch.kernels import acq
    from gnss_sdr_tpu_torch.kernels import acq_variants as k5
    from gnss_sdr_tpu_torch.kernels import build as kb

    kb._libs["acq"] = ctypes.CDLL(acq_so)
    kb._libs["acq_variants"] = ctypes.CDLL(var_so)
    dev = torch.device("cuda")
    times, host, outs, extra = {}, {}, {}, {}
    for case, s, n, d, f0, step, fs in TIMED + CHECKED:
        x, dop, c0 = case_inputs(torch, np, s, n, d, f0, step, fs, dev)
        if case.startswith("acq_wipeoff"):
            def call(x=x, dop=dop, c0=c0):
                return acq.acq_wipeoff(x, dop, c0)
        else:
            def call(x=x, dop=dop, c0=c0, s=s):
                return k5.fold_wipeoff(x, dop, c0, s)
        outs[case] = call()
        torch.cuda.synchronize()
        outs[case] = outs[case].cpu()
        if (case, s, n, d, f0, step, fs) not in TIMED:
            continue
        fold = case.startswith("fold_wipeoff")
        times[case] = cs.kernel_device_us(torch, call, "wipeoff")
        host[case] = cs.wrapper_host_split(
            torch, call, cs.wipeoff_parts(torch, x, dop, c0,
                                          s if fold else None))
        if extras:
            extra[f"{case}/floor_us"] = cs.wipeoff_floor_us(torch, n // s, d)
            extra[f"{case}/issue"] = cs.wipeoff_issue_floor(
                torch, kb.load("acq_variants" if fold else "acq")._name,
                dop, s, n)
    torch.save(outs, out_path)
    return dict(times=times, host=host, extra=extra)


def bounds(cs) -> dict:
    """Each timed case's bound in us, as ``chip_smoke`` counts it."""
    return {case: cs.bound_ms(n * 8 + d * 4 + d * (n // s) * 8,
                              d * n * 8)[0] * 1e3
            for case, s, n, d, *_ in TIMED}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", nargs="?")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--worker", nargs=5, metavar=("ROOT", "ACQ_SO", "VAR_SO",
                                                  "OUT", "EXTRAS"))
    args = ap.parse_args()
    if args.worker:
        root, acq_so, var_so, out, extras = args.worker
        r = worker(root, acq_so, var_so, out, extras == "1")
        print("WIPEOFF_AB " + json.dumps(r), flush=True)
        return 0

    import torch

    cs = chip_smoke()
    if not torch.cuda.is_available():
        print("wipeoff_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.other_root is None:
        ap.error("OTHER_ROOT is required")
    roots = {"this": ROOT, "other": os.path.abspath(args.other_root)}
    libs = build(roots, SOURCES)
    done = ab_runs(__file__, lambda tag, extras: (
        roots[tag], libs[(tag, "acq")], libs[(tag, "acq_variants")],
        os.path.join(OUT_DIR, f"wipeoff-{tag}.pt"), "1" if extras else "0"),
        args.rounds, "WIPEOFF_AB ")
    extra = done[0][1]["extra"]
    runs = [dict(tree=tag, **r["times"]) for tag, r in done]
    host = {tag: [r["host"] for t, r in done if t == tag]
            for tag in ("this", "other")}
    a = torch.load(os.path.join(OUT_DIR, "wipeoff-other.pt"))
    b = torch.load(os.path.join(OUT_DIR, "wipeoff-this.pt"))
    agree = {case: torch.equal(a[case], b[case]) for case in a}
    cases = [c[0] for c in TIMED]
    median = {case: {tag: statistics.median(
        r[case] for r in runs if r["tree"] == tag and r[case] is not None)
        for tag in ("this", "other")} for case in cases}
    host_median = {case: {tag: {k: statistics.median(h[case][k]
                                                      for h in host[tag])
                                for k in host[tag][0][case]}
                          for tag in ("this", "other")} for case in cases}
    print(json.dumps({
        "card": cs.card_line(), "bound_us": bounds(cs),
        "median_device_us": median, "median_host_us": host_median,
        "this_extra": extra,
        "ptxas": {f"{tag}/{name}": ptxas_lines(libs[(tag, name)] + ".log")
                  for tag in roots for name in SOURCES},
        "bit_equal": agree, "runs": runs}))
    return 0 if all(agree.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
