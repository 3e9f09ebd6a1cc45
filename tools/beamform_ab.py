"""Time K7e (``beamform`` of ``csrc/conditioner.cu``) as built from two
source trees, on one card, beside the library call that computes the
same function (``torch.matmul`` of complex64 [1, M] by [M, N]).

    python3 tools/beamform_ab.py OTHER_ROOT [--m 8] [--n 4194304]
                                 [--rounds 3]

``OTHER_ROOT`` is the root of another checkout (``git archive`` of a
commit or tree unpacked into a git-ignored directory) whose
``conditioner.cu`` has the same ``beamform`` launcher. Both sources are
compiled with the port's ``nvcc`` flags into ``build/ab/`` and loaded side
by side. On one seeded interleaved complex64 capture [M, N] each round
profiles, each in its own ``torch.profiler`` session of 20 calls: this
tree's kernel, the other's, the other's, this tree's, then the library
call. Prints one JSON line: the device us a launch of each kernel and of
the library call (every kernel it launches, by name) per round, their
medians, and whether the two kernels' outputs are equal to the bit.
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


def build(root: str, tag: str) -> ctypes.CDLL:
    from gnss_sdr_tpu_torch.kernels import build as kb

    csrc = os.path.join(root, "gnss_sdr_tpu_torch", "kernels", "csrc")
    out_dir = os.path.join(ROOT, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"conditioner-{tag}.so")
    subprocess.run([kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", csrc, "-o", so,
                    os.path.join(csrc, "conditioner.cu")], check=True,
                   stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(so)
    lib.beamform.argtypes = [kb.VP, kb.VP, kb.I64, kb.I64, kb.I32, kb.I64,
                             kb.VP, kb.VP, kb.VP, kb.VP]
    lib.beamform.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root")
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--n", type=int, default=4 * 1024 * 1024)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from gnss_sdr_tpu_torch.kernels import build as kb

    if not torch.cuda.is_available():
        print("beamform_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"this": build(ROOT, "this"),
            "other": build(os.path.abspath(args.other_root), "other")}
    m, n = args.m, args.n
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, n), dtype=torch.complex64, device="cuda",
                    generator=g)
    w_re = torch.randn(m, device="cuda", generator=g)
    w_im = torch.randn(m, device="cuda", generator=g)
    wc = torch.complex(w_re, w_im)[None, :]
    xr = torch.view_as_real(x)

    def call(tag):
        y = torch.empty(n, dtype=torch.complex64, device="cuda")
        err = libs[tag].beamform(
            xr.data_ptr(), xr.data_ptr() + 4, 2, 2 * n, m, n,
            w_re.data_ptr(), w_im.data_ptr(), y.data_ptr(),
            kb.stream_ptr(y.device))
        kb.check(err, f"beamform ({tag})")
        return y

    ys = {tag: call(tag) for tag in libs}
    torch.cuda.synchronize()
    rounds = []
    for _ in range(args.rounds):
        r = {}
        for i, tag in enumerate(("this", "other", "other", "this")):
            _, _, kernels = cs.profile(torch, lambda: call(tag))
            us = [u for k, (u, _) in kernels.items() if "beamform_kernel" in k]
            r[f"{tag}_{i}"] = us[0] if len(us) == 1 else None
        lib = cs.library_device(torch, lambda: torch.matmul(wc, x))
        r["library"] = lib["library_device_us"]
        r["library_kernels"] = lib["library_kernels"]
        rounds.append(r)

    def med(prefix):
        v = [u for r in rounds for k, u in r.items()
             if k.startswith(prefix) and isinstance(u, float)]
        return statistics.median(v) if v else None

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "m": m, "n": n, "card": card.strip(),
        "bound_us": cs.bound_ms(8 * m * n + 8 * n, 8 * m * n)[0] * 1e3,
        "equal_to_the_bit": bool(torch.equal(ys["this"], ys["other"])),
        "median_us": {"this": med("this"), "other": med("other"),
                      "library": med("library")},
        "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
