"""Run the L1 slice's receiver of ``chip_smoke.py`` on two cards, as this
tree stands and as another does, each run in a fresh process, and
compare the fixes.

    python3 tools/device_ab.py [OTHER_ROOT] [--cards 0 1]

Needs two cards. ``OTHER_ROOT`` is the root of another checkout (``git
archive`` of a commit unpacked into a git-ignored directory). For each
tree, the receiver that ``chip_smoke.slice_phase`` builds (``make_receiver``
from the factory-default L1 INI, over the 12 s scene that ``chip_smoke``
generates and caches under this tree's build directory) runs once with
``device="cuda:<first card>"`` and once on the second card, card 0 staying
the current card and holding a CUDA context (the process allocates on it
first, as any process that has used it does). A run prints its fix count, the mean 3-D error of the
second half of its fixes, a hash of every fix's position and the cards
the receiver's hand kernels ran on (their launches by card index, from
``torch.profiler`` over the run), or, if it fails, its exit code and
its last error lines. Prints one JSON line: the runs, and for each tree
whether its two cards gave the same fixes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import hashlib, json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from gnss_sdr_tpu_torch.config import FileConfiguration
from gnss_sdr_tpu_torch.kernels import build as kb
from gnss_sdr_tpu_torch.receiver.assistance import save_ephemeris_xml
from gnss_sdr_tpu_torch.receiver.factory import make_receiver

dev, scene_dir = torch.device(sys.argv[1]), sys.argv[2]
kb.build_all()
torch.zeros(1, device="cuda:0")   # card 0 current, with its context
x, ephs, prns, rx, _ = cs.scene(np, scene_dir)
os.makedirs(kb.BUILD_DIR, exist_ok=True)
xml = save_ephemeris_xml({p: ephs[p] for p in prns},
                         os.path.join(kb.BUILD_DIR, "gps_ephemeris.xml"))
conf = os.path.join(kb.BUILD_DIR, "rx-device-ab.conf")
with open(conf, "w") as fh:
    fh.write("\n".join(cs.receiver_conf(prns, xml) + [""]))
rec = make_receiver(FileConfiguration(conf), device=dev)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    sols = rec.run(x)
    torch.cuda.synchronize(dev)
# the slice's hand kernels (K3-loop, K1-loop, K2) by the card they ran on
hand = ("scan_loop_kernel", "fast_loop_kernel", "wipeoff_kernel",
        "product_kernel", "accum_kernel", "stats_kernel")
cards = {}
for e in prof.events():
    if "CUDA" in str(e.device_type) and any(h in e.name for h in hand):
        cards[e.device_index] = cards.get(e.device_index, 0) + 1
pos = np.array([s.pos_ecef for s in sols], dtype=np.float64)
print("DEVICE_AB " + json.dumps(dict(
    device=str(dev), current=torch.cuda.current_device(), fixes=len(sols),
    mean_err_m=cs.second_half_err(np, sols, rx)[0],
    in_fast_mode=bool(rec.in_fast_mode), kernel_launches_by_card=cards,
    positions_sha1=hashlib.sha1(pos.tobytes()).hexdigest())), flush=True)
"""


def run(root: str, device: str, scene_dir: str) -> dict:
    p = subprocess.run([sys.executable, "-c", CHILD, device, scene_dir],
                       cwd=root, capture_output=True, text=True, timeout=600)
    for line in p.stdout.splitlines():
        if line.startswith("DEVICE_AB "):
            return json.loads(line[len("DEVICE_AB "):])
    return dict(device=device, rc=p.returncode,
                error=p.stderr.strip().splitlines()[-12:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", nargs="?")
    ap.add_argument("--cards", type=int, nargs=2, default=(0, 1))
    args = ap.parse_args()
    roots = {"this": ROOT}
    if args.other_root:
        roots["other"] = os.path.abspath(args.other_root)
    scene_dir = os.path.join(ROOT, "build", "kernels")
    out = {"runs": [], "same_fixes": {}}
    for tag, root in roots.items():
        runs = [run(root, f"cuda:{i}", scene_dir) for i in args.cards]
        for r in runs:
            r["tree"] = tag
            print(f"device_ab: {json.dumps(r)}", file=sys.stderr, flush=True)
        out["runs"].extend(runs)
        out["same_fixes"][tag] = all("positions_sha1" in r for r in runs) \
            and runs[0]["positions_sha1"] == runs[1]["positions_sha1"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
