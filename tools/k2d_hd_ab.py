"""Time K2d (``acq_stats`` of ``csrc/acq.cu``) and K3-hd
(``multicorr_hd_f32`` of ``csrc/multicorr.cu``) as built from two source
trees, on one card, each timing run in a fresh process.

    python3 tools/k2d_hd_ab.py OTHER_ROOT [--rounds 3]

``OTHER_ROOT`` is the root of another checkout (``git archive`` of a
commit or tree unpacked into a git-ignored directory). Both trees' two
sources are compiled at once with the port's ``nvcc`` flags into
``build/ab/``. Each round then runs this tree, the other, the other,
this: a run is a new Python process that loads its tree's two libraries,
makes the seeded inputs and reads each case's device time a launch from
``torch.profiler`` (``chip_smoke.kernel_device_us``, 20 launches after a
warm-up), as the kernel table does. The cases: K2d at the PCPS searches'
shapes (L1 8 x 40 x 4000, E1 7 x 80 x 16000, E5a 36 x 32 x 12000; a
seeded grid with a planted peak a PRN, its row peaks and first argmaxes)
with the CFAR statistic and with the second peak; K3-hd at
``chip_smoke.HD_SHAPES`` (8 channels, 10 g, float32 windows). A run of
this tree also reads the device time of an empty kernel launched as K2d
is (``acq_stats_empty``) and both kernels' clusters. Prints one JSON
line: the card, the bounds, the medians over rounds, every run, and
whether the two trees agree (K2d's indices and second-peak statistic
equal, its CFAR statistic within 1e-4; K3-hd within 1e-5 of the prompt
magnitude); exits 1 if they do not.
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

OUT_DIR = os.path.join(ROOT, "build", "ab")
#: K2d's shapes (variant, P, D, eff, samples a chip)
K2D_SHAPES = (("L1", 8, 40, 4000, 4), ("E1", 7, 80, 16000, 4),
              ("E5a", 36, 32, 12000, 1))


def build(roots: dict, names=("acq", "multicorr")) -> dict:
    """{(tag, source): path of the library} for each tree's sources
    ``names`` (``csrc/<name>.cu``), every ``nvcc`` run started together;
    each compiler log (``-Xptxas -v``) is kept beside its library as
    ``<library>.log``."""
    from gnss_sdr_tpu_torch.kernels import build as kb

    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for tag, root in roots.items():
        csrc = os.path.join(root, "gnss_sdr_tpu_torch", "kernels", "csrc")
        for name in names:
            so = os.path.join(OUT_DIR, f"{name}-{tag}.so")
            procs[(tag, name)] = (so, subprocess.Popen(
                [kb.nvcc_path(), *kb.NVCC_FLAGS, "-I", csrc, "-o", so,
                 os.path.join(csrc, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        with open(so + ".log", "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        out[key] = so
    return out


def ab_runs(script: str, worker_argv, rounds: int, marker: str) -> list:
    """``rounds`` rounds of this tree, the other, the other, this: each a
    fresh process ``script --worker *worker_argv(tag, extras)`` whose
    stdout holds one line ``marker + JSON``; ``extras`` is true for the
    first run of this tree only. Returns [(tag, parsed JSON)] in order."""
    runs = []
    for _ in range(rounds):
        for tag in ("this", "other", "other", "this"):
            p = subprocess.run(
                [sys.executable, os.path.abspath(script), "--worker",
                 *worker_argv(tag, tag == "this" and not runs)],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            line = [s for s in p.stdout.splitlines() if s.startswith(marker)]
            if p.returncode != 0 or not line:
                raise RuntimeError(f"{os.path.basename(script)}: the {tag} "
                                   f"run failed (rc {p.returncode}):\n"
                                   f"{p.stderr[-4000:]}")
            runs.append((tag, json.loads(line[0][len(marker):])))
            print(f"{os.path.basename(script)}: {tag} "
                  f"{json.dumps(runs[-1][1].get('times'))}", file=sys.stderr,
                  flush=True)
    return runs


def k2d_inputs(torch, np, p, d, eff, dev):
    """A seeded [P, D, eff] grid of exponential noise with one peak a PRN,
    its row peaks and first argmaxes (as K2c leaves them)."""
    rng = np.random.default_rng(p * d + eff)
    g = rng.exponential(1.0, size=(p, d, eff)).astype(np.float32)
    for i in range(p):
        g[i, rng.integers(d), rng.integers(eff)] = 200.0
    grid = torch.as_tensor(g, device=dev)
    arg = torch.argmax(grid, dim=-1)
    row_max = torch.gather(grid, -1, arg[..., None])[..., 0].contiguous()
    return grid, row_max, arg.to(torch.int32).contiguous()


def worker(acq_so: str, mc_so: str, out_path: str, extras: bool) -> dict:
    """One timing run of one tree's libraries; its outputs saved to
    ``out_path``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from gnss_sdr_tpu_torch.kernels import build as kb

    VP, I32, F32, I64 = kb.VP, kb.I32, kb.F32, kb.I64
    dev = torch.device("cuda")
    la, lm = ctypes.CDLL(acq_so), ctypes.CDLL(mc_so)
    la.acq_stats.argtypes = [VP, VP, VP, I32, I32, I32, F32, I32, I32, VP,
                             VP, VP, VP]
    lm.multicorr_hd_f32.argtypes = [VP, VP, I64, VP, VP, VP, I32, VP, I32,
                                    VP, VP, VP, VP, VP, VP, I32, VP, VP,
                                    I32, VP]
    times, outs, extra = {}, {}, {}
    for variant, p, d, eff, spc in K2D_SHAPES:
        grid, rm, ra = k2d_inputs(torch, np, p, d, eff, dev)
        for use_cfar in (True, False):
            res = [torch.empty(p, dtype=t, device=dev)
                   for t in (torch.float32, torch.int32, torch.int32)]

            def run(grid=grid, rm=rm, ra=ra, p=p, d=d, eff=eff, spc=spc,
                    use_cfar=use_cfar, res=res):
                kb.check(kb.launch(
                    la.acq_stats, dev, grid.data_ptr(), rm.data_ptr(),
                    ra.data_ptr(), p, d, eff, 2.0, spc, int(use_cfar),
                    *(r.data_ptr() for r in res)), "acq_stats")
            case = f"acq_stats/{variant}/{'cfar' if use_cfar else 'peak2'}"
            run()
            torch.cuda.synchronize()
            outs[case] = [r.cpu() for r in res]
            times[case] = cs.kernel_device_us(torch, run, "stats_kernel")
        if extras:
            la.acq_stats_empty.argtypes = [I32, I32, VP]
            extra[f"acq_stats/{variant}/floor_us"] = cs.kernel_device_us(
                torch, lambda p=p, eff=eff: kb.check(kb.launch(
                    la.acq_stats_empty, dev, p, eff), "acq_stats_empty"),
                "stats_empty_kernel")
            extra[f"acq_stats/{variant}/cluster"] = query(
                la, "acq_stats_cluster", eff)
        del grid
    rng = np.random.default_rng(2027)
    for variant, length, n_taps, table_len, cspc in cs.HD_SHAPES:
        args, carr_rate, code_rate = cs.hd_windows(
            torch, np, rng, length, n_taps, table_len, cspc, 1.0)
        (re, im, base, start, lens, code, shifts, rem, step, rem_carr,
         carr_step, max_period, _) = args
        c = code.shape[0]
        o_re = torch.empty((c, n_taps), dtype=torch.float32, device=dev)
        o_im = torch.empty_like(o_re)

        def run_hd(re=re, im=im, start=start, lens=lens, code=code,
                   shifts=shifts, rem=rem, step=step, rem_carr=rem_carr,
                   carr_step=carr_step, max_period=max_period, c=c,
                   n_taps=n_taps, o_re=o_re, o_im=o_im, cr=carr_rate,
                   kr=code_rate):
            kb.check(kb.launch(
                lm.multicorr_hd_f32, dev, re.data_ptr(), im.data_ptr(), 0,
                start.data_ptr(), lens.data_ptr(), code.data_ptr(),
                code.shape[1], shifts.data_ptr(), n_taps, rem.data_ptr(),
                step.data_ptr(), kr.data_ptr(), rem_carr.data_ptr(),
                carr_step.data_ptr(), cr.data_ptr(), max_period,
                o_re.data_ptr(), o_im.data_ptr(), c), "multicorr_hd")
        case = f"multicorr_hd/{variant}"
        run_hd()
        torch.cuda.synchronize()
        outs[case] = [o_re.cpu(), o_im.cpu()]
        times[case] = cs.kernel_device_us(torch, run_hd, "multicorr_hd_kernel")
        if extras:
            extra[f"{case}/cluster"] = query(lm, "multicorr_hd_cluster",
                                             n_taps, table_len, length, 0)
    torch.save(outs, out_path)
    return dict(times=times, extra=extra)


def query(lib, name: str, *ints) -> dict:
    """A cluster query of ``lib`` (``name(*ints, &S, &n)``) on card 0."""
    from gnss_sdr_tpu_torch.kernels import build as kb

    f = getattr(lib, name)
    f.argtypes = [kb.I32] * len(ints) + [ctypes.POINTER(kb.I32)] * 2
    s, n = kb.I32(), kb.I32()
    kb.check(f(*ints, ctypes.byref(s), ctypes.byref(n)), name)
    return {"cluster_size": s.value, "max_active_clusters": n.value}


def compare(torch, a: dict, b: dict) -> dict:
    """How far tree b's outputs lie from tree a's, by case."""
    out = {}
    for case, wa in a.items():
        wb = b[case]
        if case.startswith("acq_stats"):
            same_idx = torch.equal(wa[1], wb[1]) and torch.equal(wa[2], wb[2])
            rel = float(((wa[0] - wb[0]).abs() / wa[0]).max())
            ok = same_idx and (rel <= 1e-4 if case.endswith("cfar")
                               else torch.equal(wa[0], wb[0]))
            out[case] = dict(indices_equal=same_idx, stat_rel=rel, ok=ok)
        else:
            mid = wa[0].shape[1] // 2
            prompt = torch.hypot(wa[0][:, mid], wa[1][:, mid])
            err = torch.maximum((wa[0] - wb[0]).abs(),
                                (wa[1] - wb[1]).abs()).amax(dim=1)
            rel = float((err / prompt).max())
            out[case] = dict(rel_of_prompt=rel, ok=rel <= 1e-5)
    return out


def bounds(cs) -> dict:
    """Each case's bound in us, as ``chip_smoke`` counts it: K2d reads
    the row peaks and arguments and one row and writes 12 bytes a PRN;
    K3-hd at the full valid lengths."""
    out = {}
    for variant, p, d, eff, _ in K2D_SHAPES:
        out[f"acq_stats/{variant}"] = cs.bound_ms(
            p * d * 8 + p * eff * 4 + p * 12, p * d + p * eff * 2)[0] * 1e3
    for variant, length, t, table_len, _ in cs.HD_SHAPES:
        n_valid = 8 * length
        out[f"multicorr_hd/{variant}"] = cs.bound_ms(
            n_valid * 8 + 8 * table_len * 4 + 8 * 8 * 4 + 8 * t * 8,
            n_valid * (18 + 4 * t))[0] * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root", nargs="?")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--worker", nargs=4, metavar=("ACQ_SO", "MC_SO", "OUT",
                                                  "EXTRAS"))
    args = ap.parse_args()
    if args.worker:
        acq_so, mc_so, out, extras = args.worker
        r = worker(acq_so, mc_so, out, extras == "1")
        print("K2D_HD_AB " + json.dumps(r), flush=True)
        return 0

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("k2d_hd_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.other_root is None:
        ap.error("OTHER_ROOT is required")
    libs = build({"this": ROOT, "other": os.path.abspath(args.other_root)})
    done = ab_runs(__file__, lambda tag, extras: (
        libs[(tag, "acq")], libs[(tag, "multicorr")],
        os.path.join(OUT_DIR, f"out-{tag}.pt"), "1" if extras else "0"),
        args.rounds, "K2D_HD_AB ")
    extra = done[0][1]["extra"]
    runs = [dict(tree=tag, **r["times"]) for tag, r in done]
    agree = compare(torch, torch.load(os.path.join(OUT_DIR, "out-other.pt")),
                    torch.load(os.path.join(OUT_DIR, "out-this.pt")))
    cases = [k for k in runs[0] if k != "tree"]
    median = {case: {tag: statistics.median(
        r[case] for r in runs if r["tree"] == tag and r[case] is not None)
        for tag in ("this", "other")} for case in cases}
    print(json.dumps({"card": cs.card_line(), "bound_us": bounds(cs),
                      "median_device_us": median, "this_extra": extra,
                      "agree": agree, "runs": runs}))
    return 0 if all(v["ok"] for v in agree.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
