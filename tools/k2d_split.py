"""Split K2d's device time (``stats_kernel`` of ``csrc/acq.cu``) by
timing throwaway variants of this tree's source with one part changed or
cut out, on one card.

    python3 tools/k2d_split.py [--rounds 3]

Each variant is the source with one text substitution (checked to
apply), compiled with the port's ``nvcc`` flags into ``build/split/``,
all at once; no variant is part of the package. The variants:

- ``as_is``: the source unchanged;
- ``slice_<n>``: ``kStatsSlice`` = n floats of the row a block (the
  cluster size S = ceil(eff / n), at most 8; ``slice_all``: S = 1);
- ``no_row``: no load of the chosen row (the statistic is wrong): the
  launch, the row-peak argmax, the reductions and the cluster exchange;
- ``no_exchange``: no write into the leader's shared memory, no arrival
  on its barrier and no wait (the leader keeps its own part);
- ``no_argmax``: no read of the row peaks (row p mod D is taken): the
  first of the two dependent memory latencies gone.

Plus the empty kernel launched as K2d is (``acq_stats_empty``). Every
case runs the CFAR statistic at the PCPS searches' shapes on the seeded
grids of ``tools/k2d_hd_ab.py``; device us a launch from the profiler
(``chip_smoke.kernel_device_us``), medians over ``--rounds`` rounds that
each time every variant in turn. Prints one JSON line.
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

OUT_DIR = os.path.join(ROOT, "build", "split")
SLICE = "constexpr int kStatsSlice = 4096;"
VARIANTS = {
    "as_is": [],
    "slice_1024": [(SLICE, "constexpr int kStatsSlice = 1024;")],
    "slice_2048": [(SLICE, "constexpr int kStatsSlice = 2048;")],
    "slice_all": [(SLICE, "constexpr int kStatsSlice = 1 << 30;")],
    "no_row": [("  const int head = min(",
                "  eff = 0;\n  const int head = min(")],
    "no_exchange": [("    lead_part[r] = v;\n"
                     "    mbar_arrive_remote(&parts_in, 0);\n", ""),
                    ("  if (S > 1) mbar_wait(&parts_in, 0);\n", "")],
    "no_argmax": [("  warp_argmax(row_max + (size_t)p * D, D, peak, bd);",
                   "  peak = 1.0f;\n  bd = p % D;")],
}


def build() -> dict:
    """{variant: library path}, the ``nvcc`` runs started together."""
    from gnss_sdr_tpu_torch.kernels import build as kb

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(kb.CSRC, "acq.cu")) as fh:
        base = fh.read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = base
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"k2d_split: {name}: {old!r} is not in "
                                   "acq.cu once")
            src = src.replace(old, new)
        cu = os.path.join(OUT_DIR, f"acq-{name}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = cu[:-3] + ".so"
        procs[name] = (so, subprocess.Popen(
            [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", kb.CSRC, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = so
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from gnss_sdr_tpu_torch.kernels import build as kb
    from tools.k2d_hd_ab import K2D_SHAPES, k2d_inputs

    if not torch.cuda.is_available():
        print("k2d_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = {}
    for name, so in build().items():
        lib = ctypes.CDLL(so)
        lib.acq_stats.argtypes = [kb.VP, kb.VP, kb.VP, kb.I32, kb.I32,
                                  kb.I32, kb.F32, kb.I32, kb.I32, kb.VP,
                                  kb.VP, kb.VP, kb.VP]
        lib.acq_stats_empty.argtypes = [kb.I32, kb.I32, kb.VP]
        libs[name] = lib
    rounds = []
    for _ in range(args.rounds):
        r = {}
        for variant, p, d, eff, spc in K2D_SHAPES:
            grid, rm, ra = k2d_inputs(torch, np, p, d, eff, dev)
            res = [torch.empty(p, dtype=t, device=dev)
                   for t in (torch.float32, torch.int32, torch.int32)]
            for name, lib in libs.items():
                def run(lib=lib, p=p, d=d, eff=eff, spc=spc):
                    kb.check(kb.launch(
                        lib.acq_stats, dev, grid.data_ptr(), rm.data_ptr(),
                        ra.data_ptr(), p, d, eff, 2.0, spc, 1,
                        *(t.data_ptr() for t in res)), "acq_stats")
                r[f"{variant}/{name}"] = cs.kernel_device_us(
                    torch, run, "stats_kernel")
            r[f"{variant}/empty"] = cs.kernel_device_us(
                torch, lambda p=p, eff=eff: kb.check(kb.launch(
                    libs["as_is"].acq_stats_empty, dev, p, eff),
                    "acq_stats_empty"), "stats_empty_kernel")
            del grid
        rounds.append(r)
        print(f"k2d_split: {json.dumps(r)}", file=sys.stderr, flush=True)
    median = {k: statistics.median(x[k] for x in rounds
                                   if x[k] is not None)
              for k in rounds[0]}
    print(json.dumps({"card": cs.card_line(), "median_device_us": median,
                      "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
