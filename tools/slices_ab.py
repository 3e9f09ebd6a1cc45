"""Time the two production slices of ``chip_smoke.py`` (the L1 C/A
receiver and the GPS L1 C/A + Galileo E1 receiver) as they stand in this
tree and in another, on one card, each run in a fresh process.

    python3 tools/slices_ab.py OTHER_ROOT [--rounds 3]

``OTHER_ROOT`` is the root of another checkout (``git archive`` of a
commit unpacked into a git-ignored directory). Each round runs this tree,
the other, the other, this. A run is a new Python process started in its
tree's root: it builds that tree's kernels (cached after the first run),
then calls that tree's ``chip_smoke.slice_phase`` and
``chip_smoke.multiband_phase``, which load the cached scenes (generated
by the first run) and check their limits. No other phase runs before
them, so no earlier profiler session or kernel check shares the process.
Prints one JSON line: per run, each slice's phase-A and phase-B wall
seconds and real-time factors and its mid-run superblocks' wall and
device ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke as cs
from gnss_sdr_tpu_torch.kernels import build as kb

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kb.build_all()
card = cs.card_line()
out = {}
for name, phase in (("L1", cs.slice_phase), ("L1+E1", cs.multiband_phase)):
    r = phase(torch, np, kb.BUILD_DIR, card)[0]
    out[name] = dict(phase_a_s=r["timings"]["phase_a_s"],
                     phase_b_s=r["timings"]["phase_b_s"],
                     rtf_phase_a=r["rtf_phase_a"],
                     rtf_phase_b=r["rtf_phase_b"], run_s=r["run_s"],
                     superblocks={k: [v["wall_ms"], v["device_ms"]]
                                  for k, v in r["profile"].items()})
print("SLICES_AB " + json.dumps(out), flush=True)
"""


def run(root: str) -> dict:
    p = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                       capture_output=True, text=True, timeout=900)
    for line in p.stdout.splitlines():
        if line.startswith("SLICES_AB "):
            return json.loads(line[len("SLICES_AB "):])
    raise RuntimeError(f"slices_ab: the run in {root} failed "
                       f"(rc {p.returncode}):\n{p.stderr[-4000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    roots = {"this": ROOT, "other": os.path.abspath(args.other_root)}
    runs = []
    for _ in range(args.rounds):
        for tag in ("this", "other", "other", "this"):
            runs.append(dict(tree=tag, **run(roots[tag])))
            print(f"slices_ab: {json.dumps(runs[-1])}", file=sys.stderr,
                  flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
