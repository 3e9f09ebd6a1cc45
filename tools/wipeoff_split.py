"""Split K2a's and K5a's device time (``wipeoff_fold_kernel`` of
``csrc/wipeoff.cuh``) by timing throwaway variants of this tree's header
with one part changed or cut out, on one card.

    python3 tools/wipeoff_split.py [--rounds 3]

Each variant is the header with text substitutions (each checked to
apply once), written with copies of ``acq.cu`` and ``acq_variants.cu``
into ``build/split/wipeoff-<variant>/`` (so their ``#include
"wipeoff.cuh"`` finds the variant) and compiled with the port's ``nvcc``
flags, all at once; no variant is part of the package. The variants:

- ``as_is``: the header unchanged;
- ``threads_128``, ``threads_512``, ``threads_1024``: blocks of that
  many threads (``kWipeThreads``; 256 as is);
- ``pairs_always``, ``singles_always``: a pair of outputs a thread
  wherever the layout allows, or one output a thread everywhere
  (``kWipePairThreadsPerSm``);
- ``no_mirror``: no mirror pair shares a sincosf (each bin its own);
- ``no_sincos``: the phase itself for sin and cos (what is left without
  the sincosf).

Each beside the empty kernel launched as it launches that case
(``wipeoff_empty`` of the variant's own launch rule).
Every case runs at ``tools/wipeoff_ab.py``'s timed shapes on its seeded
inputs; device us a launch from the profiler
(``chip_smoke.kernel_device_us``), medians over ``--rounds`` rounds that
each time every variant in turn. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT_DIR = os.path.join(ROOT, "build", "split")
VARIANTS = {
    "as_is": [],
    "threads_128": [("constexpr int kWipeThreads = 256;",
                     "constexpr int kWipeThreads = 128;")],
    "threads_512": [("constexpr int kWipeThreads = 256;",
                     "constexpr int kWipeThreads = 512;")],
    "threads_1024": [("constexpr int kWipeThreads = 256;",
                      "constexpr int kWipeThreads = 1024;")],
    "pairs_always": [("constexpr int kWipePairThreadsPerSm = 512;",
                      "constexpr int kWipePairThreadsPerSm = 0;")],
    "singles_always": [("constexpr int kWipePairThreadsPerSm = 512;",
                        "constexpr int kWipePairThreadsPerSm = 1 << 20;")],
    "no_mirror": [("    mirror = __float_as_uint(f1) == "
                   "(__float_as_uint(f0) ^ 0x80000000u);",
                   "    mirror = false;")],
    "no_sincos": [("      sincosf(__fmul_rn(w0, n), &sn, &cs);",
                   "      sn = cs = __fmul_rn(w0, n);"),
                  ("          sincosf(__fmul_rn(w1, n), &sn, &cs);",
                   "          sn = cs = __fmul_rn(w1, n);")],
}


def build() -> dict:
    """{variant: (acq library, acq_variants library)}, the ``nvcc`` runs
    started together."""
    from gnss_sdr_tpu_torch.kernels import build as kb

    with open(os.path.join(kb.CSRC, "wipeoff.cuh")) as fh:
        base = fh.read()
    procs = {}
    for name, subs in VARIANTS.items():
        src = base
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"wipeoff_split: {name}: {old!r} is not "
                                   "in wipeoff.cuh once")
            src = src.replace(old, new)
        d = os.path.join(OUT_DIR, f"wipeoff-{name}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "wipeoff.cuh"), "w") as fh:
            fh.write(src)
        for lib in ("acq", "acq_variants"):
            cu = os.path.join(d, f"{lib}.cu")
            shutil.copy(os.path.join(kb.CSRC, f"{lib}.cu"), cu)
            procs[(name, lib)] = (cu[:-3] + ".so", subprocess.Popen(
                [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", kb.CSRC, "-o",
                 cu[:-3] + ".so", cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for (name, lib), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{log}")
        out.setdefault(name, {})[lib] = so
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from gnss_sdr_tpu_torch.kernels import build as kb
    from tools.wipeoff_ab import TIMED, case_inputs

    if not torch.cuda.is_available():
        print("wipeoff_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = {}
    for name, sos in build().items():
        a, v = ctypes.CDLL(sos["acq"]), ctypes.CDLL(sos["acq_variants"])
        a.acq_wipeoff.argtypes = [kb.VP, kb.VP, kb.F32, kb.I32, kb.I32,
                                  kb.VP, kb.VP]
        v.fold_wipeoff.argtypes = [kb.VP, kb.VP, kb.F32, kb.I32, kb.I32,
                                   kb.I32, kb.VP, kb.VP]
        a.wipeoff_empty.argtypes = [kb.I32, kb.I32, kb.I32, kb.VP]
        libs[name] = (a, v)
    rounds = []
    for _ in range(args.rounds):
        r = {}
        for case, s, n, d, f0, step, fs in TIMED:
            x, dop, c0 = case_inputs(torch, np, s, n, d, f0, step, fs, dev)
            nf = n // s
            out = torch.empty((d, nf), dtype=torch.complex64, device=dev)
            for name, (a, v) in libs.items():
                def run(a=a, v=v, s=s, n=n, d=d, nf=nf, c0=c0, x=x, dop=dop,
                        out=out, fold=case.startswith("fold")):
                    if fold:
                        err = kb.launch(v.fold_wipeoff, dev, x.data_ptr(),
                                        dop.data_ptr(), c0, s, nf, d,
                                        out.data_ptr())
                    else:
                        err = kb.launch(a.acq_wipeoff, dev, x.data_ptr(),
                                        dop.data_ptr(), c0, n, d,
                                        out.data_ptr())
                    kb.check(err, "wipeoff")
                r[f"{case}/{name}"] = cs.kernel_device_us(
                    torch, run, "wipeoff_fold_kernel")
                r[f"{case}/{name}/empty"] = cs.kernel_device_us(
                    torch, lambda a=a, nf=nf, d=d: kb.check(kb.launch(
                        a.wipeoff_empty, dev, nf, d, 1), "wipeoff_empty"),
                    "wipeoff_empty_kernel")
        rounds.append(r)
        print(f"wipeoff_split: {json.dumps(r)}", file=sys.stderr, flush=True)
    median = {k: statistics.median(x[k] for x in rounds
                                   if x[k] is not None)
              for k in rounds[0]}
    print(json.dumps({"card": cs.card_line(), "median_device_us": median,
                      "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
