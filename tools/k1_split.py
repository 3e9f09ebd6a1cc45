"""Split K1's and K1-loop's device time (the shared body
``k1_accumulate`` of ``csrc/corr_common.cuh``) by timing throwaway
variants of a tree's header with one part changed or cut out, on one
card.

    python3 tools/k1_split.py [--root ROOT] [--rounds 3]

``ROOT`` is the tree whose sources and wrappers are timed (this one by
default; a ``git archive`` of another commit unpacked into a git-ignored
directory for its split). Each variant is the header with text
substitutions (the first set of alternatives whose every old text is in
the header once; a variant with none that applies is left out and
named), written with copies of ``bank_corr.cu`` and ``fast_loop.cu``
into ``build/split/k1-<variant>/`` (so their ``#include
"corr_common.cuh"`` finds the variant) and compiled with the port's
``nvcc`` flags, all at once; no variant is part of the package. The
variants:

- ``as_is``: the header unchanged;
- ``no_sincos``: the phase itself times the sample for the rotated
  sample (what is left without the sincosf);
- ``const_row``: no bank load, a constant row (its value a tap's index);
- ``loads_only``: the sample and bank loads summed, no sincosf, no
  product;
- ``no_corr``: no sample walked (the launch, the block sums and, in
  K1-loop, the group chain without its correlations);
- ``batch_2``, ``batch_8``: 2 or 8 samples a thread in flight instead
  of 4 (``kK1Batch``; the packed-bank body only).

Beside them, ``empty``: an empty kernel of K1's threads launched on
K1's grid. The cases are ``tools/k1_ab.py``'s (K1 at the three shapes,
one K1-loop superblock at L1 and E1) on their seeded inputs, through the
tree's own wrappers bound to each variant's libraries; device us a
launch from the profiler (``chip_smoke.kernel_device_us``), medians over
``--rounds`` rounds that each time every variant in turn. Prints one
JSON line.
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

# the parent layout's texts (float32 bank rows, one sample a step)
_P_DEROT = """    derotate(to_f32(src_re[s0 + n]), to_f32(src_im[s0 + n]),
             __fadd_rn(p0, __fmul_rn(st, static_cast<float>(n))), rr, ri);"""
_P_LOADS = """      const float q0 = __ldg(b0 + (size_t)t * W + n);
      const float q1 = __ldg(b1 + (size_t)t * W + n);"""
_P_FMA = """      acc[t] = __fmaf_rn(q0, rr, acc[t]);
      acc[NT + t] = __fmaf_rn(q0, ri, acc[NT + t]);
      acc[2 * NT + t] = __fmaf_rn(q1, rr, acc[2 * NT + t]);
      acc[3 * NT + t] = __fmaf_rn(q1, ri, acc[3 * NT + t]);"""
_P_LOOP = "  for (int n = tid; n < n_eff; n += nthreads) {"
# the packed-bank layout's texts (k1_batch, k1_sample, k1_taps,
# k1_fetch, k1_accumulate)
_N_DEROT = """  derotate(to_f32(xr), to_f32(xi),
           __fadd_rn(p0, __fmul_rn(st, static_cast<float>(n))), rr, ri);"""
_N_LOADS = """      n0[u] = b0[m];
      n1[u] = b1[m];"""
_N_SINCOS = """    sincosf(__fadd_rn(p0, __fmul_rn(st, static_cast<float>(n + u * nthreads))),
            &sn[u], &cs[u]);"""
_N_ROT = "    rotate(to_f32(xr[u]), to_f32(xi[u]), sn[u], cs[u], rr, ri);"
_N_LOOP = "  for (int n = tid; n < n_eff; n += kK1Batch * nthreads) {"
_N_FMA = """    acc[t] = __fmaf_rn(q0, rr, acc[t]);
    acc[NT + t] = __fmaf_rn(q0, ri, acc[NT + t]);
    acc[2 * NT + t] = __fmaf_rn(q1, rr, acc[2 * NT + t]);
    acc[3 * NT + t] = __fmaf_rn(q1, ri, acc[3 * NT + t]);"""
_ADDS = """{0}acc[t] = __fadd_rn(acc[t], q0);
{0}acc[NT + t] = __fadd_rn(acc[NT + t], q1);
{0}acc[2 * NT + t] = __fadd_rn(acc[2 * NT + t], rr);
{0}acc[3 * NT + t] = __fadd_rn(acc[3 * NT + t], ri);"""


def _no_sincos(indent: str, xr: str, xi: str) -> str:
    return (f"{indent}{{\n"
            f"{indent}  const float ph = __fadd_rn(p0, __fmul_rn(st, "
            "static_cast<float>(n)));\n"
            f"{indent}  rr = __fmul_rn(to_f32({xr}), ph);\n"
            f"{indent}  ri = __fmul_rn(to_f32({xi}), ph);\n"
            f"{indent}}}")


#: variant -> alternatives, each a list of (old, new) substitutions
VARIANTS = {
    "as_is": [[]],
    "no_sincos": [
        [(_N_SINCOS, "    sn[u] = cs[u] = __fadd_rn(p0, __fmul_rn(st, "
                     "static_cast<float>(n + u * nthreads)));"),
         (_N_DEROT, _no_sincos("  ", "xr", "xi"))],
        [(_P_DEROT, _no_sincos("    ", "src_re[s0 + n]",
                               "src_im[s0 + n]"))]],
    "const_row": [
        [(_N_LOADS, """      n0[u] = 0x76543210u;
      n1[u] = 0x65432107u;""")],
        [(_P_LOADS, """      const float q0 = static_cast<float>(t + 1);
      const float q1 = static_cast<float>(t + 2);""")]],
    "loads_only": [
        [(_N_SINCOS, "    sn[u] = cs[u] = 0.0f;"),
         (_N_ROT, "    rr = to_f32(xr[u]);\n    ri = to_f32(xi[u]);"),
         (_N_DEROT, "  rr = to_f32(xr);\n  ri = to_f32(xi);"),
         (_N_FMA, _ADDS.format("    "))],
        [(_P_DEROT, "    rr = to_f32(src_re[s0 + n]);\n"
                    "    ri = to_f32(src_im[s0 + n]);"),
         (_P_FMA, _ADDS.format("      "))]],
    "no_corr": [
        [(_N_LOOP, "  for (int n = tid; n < 0 * n_eff; "
                   "n += kK1Batch * nthreads) {")],
        [(_P_LOOP, "  for (int n = tid; n < 0 * n_eff; n += nthreads) {")]],
    "batch_2": [[("constexpr int kK1Batch = 4;",
                  "constexpr int kK1Batch = 2;")]],
    "batch_8": [[("constexpr int kK1Batch = 4;",
                  "constexpr int kK1Batch = 8;")]],
}

#: an empty kernel of K1's threads, launched on K1's grid
EMPTY_CU = r"""#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) k1_split_empty_kernel() {}
extern "C" int k1_split_empty(int blocks, void* stream) {
  k1_split_empty_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def variant_source(base: str, alternatives):
    """The header with the first applicable set of substitutions, or None
    when none applies."""
    for subs in alternatives:
        if all(base.count(old) == 1 for old, _ in subs):
            src = base
            for old, new in subs:
                src = src.replace(old, new)
            return src
    return None


def build(csrc: str) -> tuple[dict, list, str]:
    """({variant: {source: library}}, the variants left out, the empty
    kernel's library), the ``nvcc`` runs started together."""
    from gnss_sdr_tpu_torch.kernels import build as kb

    with open(os.path.join(csrc, "corr_common.cuh")) as fh:
        base = fh.read()
    procs, skipped = {}, []
    os.makedirs(OUT_DIR, exist_ok=True)
    empty_cu = os.path.join(OUT_DIR, "k1_empty.cu")
    with open(empty_cu, "w") as fh:
        fh.write(EMPTY_CU)
    procs[("empty", "empty")] = (empty_cu[:-3] + ".so", subprocess.Popen(
        [kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", empty_cu[:-3] + ".so",
         empty_cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    for name, alternatives in VARIANTS.items():
        src = variant_source(base, alternatives)
        if src is None:
            skipped.append(name)
            continue
        d = os.path.join(OUT_DIR, f"k1-{name}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "corr_common.cuh"), "w") as fh:
            fh.write(src)
        for lib in ("bank_corr", "fast_loop"):
            cu = os.path.join(d, f"{lib}.cu")
            shutil.copy(os.path.join(csrc, f"{lib}.cu"), cu)
            procs[(name, lib)] = (cu[:-3] + ".so", subprocess.Popen(
                [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", csrc, "-o",
                 cu[:-3] + ".so", cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for (name, lib), (so, proc) in procs.items():
        log, _ = proc.communicate()
        with open(so + ".log", "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {lib}:\n{log}")
        out.setdefault(name, {})[lib] = so
    return out, skipped, out.pop("empty")["empty"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)

    import numpy as np
    import torch

    from tools.k1_ab import cases
    from tools.wipeoff_ab import chip_smoke

    # the root's package (the tools above are this tree's)
    sys.path.insert(0, root)
    from gnss_sdr_tpu_torch.kernels import build as kb

    cs = chip_smoke()
    if not torch.cuda.is_available():
        print("k1_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs, skipped, empty_so = build(os.path.join(
        root, "gnss_sdr_tpu_torch", "kernels", "csrc"))
    empty = ctypes.CDLL(empty_so).k1_split_empty
    empty.argtypes = [kb.I32, kb.VP]
    loaded = {name: {lib: ctypes.CDLL(so) for lib, so in sos.items()}
              for name, sos in libs.items()}

    def use(name):
        kb._libs.update(loaded[name])
        kb._fns.clear()

    use("as_is")
    runs = cases(torch, np, cs)
    rounds = []
    for _ in range(args.rounds):
        r = {}
        for name in loaded:
            use(name)
            for case, (call, symbol, keep, *_) in runs.items():
                call()
                torch.cuda.synchronize()
                r[f"{case}/{name}"] = cs.kernel_device_us(torch, call, symbol)
        for case, (call, _, keep, floor, *_) in runs.items():
            if floor is None:
                c, k = keep(call())[0].shape[:2]
                r[f"{case}/empty"] = cs.kernel_device_us(
                    torch, lambda n=c * k: kb.check(
                        kb.launch(empty, dev, n), "k1_split_empty"),
                    "k1_split_empty_kernel")
        rounds.append(r)
        print(f"k1_split: {json.dumps(r)}", file=sys.stderr, flush=True)
    median = {k: statistics.median(x[k] for x in rounds if x[k] is not None)
              if any(x[k] is not None for x in rounds) else None
              for k in rounds[0]}
    print(json.dumps({"card": cs.card_line(), "root": root,
                      "skipped": skipped, "median_device_us": median,
                      "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
