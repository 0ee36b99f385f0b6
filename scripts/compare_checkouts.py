#!/usr/bin/env python3
"""Two checkouts of the port against each other on one GPU, in turns.

    python scripts/compare_checkouts.py OLD_DIR NEW_DIR [--rounds 1]
        [--replays 5] [--out results.json]

OLD_DIR and NEW_DIR are checkouts of this repository (for example the
parent commit unpacked with `git archive` into a gitignored directory, and
the working tree). Each round runs one process per checkout in the order
old, new, new, old; each process puts its checkout first on sys.path, so it
builds and runs that checkout's own kernels through that checkout's public
wrappers (`ops.em_scan.em_scan_cuda`, `solver.bcr_kernel.bcr_solve_cuda`,
`models.hitl.engine.HitLSLAM`), and measures with this script's helpers
(those of chip_smoke.py beside it) on the same inputs:

  - em_scan on the 1024-pose golden map (first logged selection): CUDA-event
    ms a call, and from torch.profiler the kernel's device ms a launch and
    all device ms a call (a fill launch before the kernel shows there);
  - bcr_solve at n = 64, 1024 and 16384: event ms, device ms a call;
  - the golden_large replay_log: per-cycle wall ms over --replays replays
    after one warm-up, and the LM iterations.

Prints the card's name and power limit, each process's numbers, and per
checkout the median, quartiles and minimum of the per-cycle walls (the
walls are host-bound, so the minimum is the least noisy of them). Needs
one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BCR_SIZES = (64, 1024, 16384)


def smoke_helpers():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(checkout: str, replays: int) -> dict:
    """The numbers of one checkout, in this process."""
    import torch

    S = smoke_helpers()
    sys.path.insert(0, os.path.abspath(checkout))
    import hitl_slam_torch

    pkg = os.path.abspath(hitl_slam_torch.__file__)
    S.check(pkg.startswith(os.path.abspath(checkout) + os.sep),
            f"imported {pkg}, not the package of {checkout}")
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.ops import em_scan as E
    from hitl_slam_torch.solver import bcr_kernel as B

    large = stfs.load_stfs_covars(
        os.path.join(S.DATA, "golden_large.stfs.covars.gz"))
    entries = logs.load_log(os.path.join(S.DATA, "golden_large.log"))
    state = make_map_state(large.poses, large.covariances,
                           large.point_clouds, large.normal_clouds,
                           device="cuda")
    world = state.world_points().contiguous()
    mask = state.point_mask
    sel = torch.as_tensor(entries[0].points, dtype=torch.float32,
                          device="cuda")
    out = {"checkout": checkout}
    counts, mins = E.em_scan_cuda(world, mask, sel)     # builds the kernels
    ref = E.em_scan_reference(world, mask, sel)
    S.check(torch.equal(counts, ref[0]) and torch.equal(mins, ref[1]),
            f"{checkout}: em_scan disagrees with its plain version")
    run = lambda: E.em_scan_cuda(world, mask, sel)   # noqa: E731
    dev, _, dev_all = S.device_ms(run, "em_scan_kernel")
    out["em_scan"] = {"ms": S.time_cuda(run, 200), "device_ms": dev,
                      "all_device_ms": dev_all}
    for n in BCR_SIZES:
        _, (D, U, b) = S._bcr_inputs(torch, n)
        fn = lambda: B.bcr_solve_cuda(D, U, b)   # noqa: E731
        _, dev, _ = S.device_ms(fn, "bcr_")
        out[f"bcr_{n}"] = {"ms": S.time_cuda(fn, 100), "device_ms": dev}

    walls, iters = [], None
    for r in range(replays + 1):
        eng = S._engine(large, 16384)
        torch.cuda.synchronize()
        w, it = [], []
        for e in entries:
            t0 = time.perf_counter()
            rep = eng.replay_log(e)
            torch.cuda.synchronize()
            w.append((time.perf_counter() - t0) * 1e3)
            it.append(rep.lm_iterations)
            S.check(rep.accepted, f"{checkout}: correction rejected")
        if r:                       # the first replay warms up
            walls.append(w)
            iters = it
    out["replay_walls_ms"] = walls
    out["lm_iterations"] = iters
    return out


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("old", nargs="?")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--replays", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--measure", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.measure:
        print("RESULT " + json.dumps(measure(args.measure, args.replays)),
              flush=True)
        return 0
    if not (args.old and args.new):
        ap.error("give the old and the new checkout")
    import torch

    if not torch.cuda.is_available():
        print("compare_checkouts: no CUDA device", file=sys.stderr)
        return 2
    S = smoke_helpers()
    print(f"device: {torch.cuda.get_device_name(0)} ({S.nvidia_smi_line()})",
          flush=True)
    runs = []
    for _ in range(args.rounds):
        for who, path in (("old", args.old), ("new", args.new),
                          ("new", args.new), ("old", args.old)):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--measure", path,
                 "--replays", str(args.replays)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=900)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("RESULT ")]
            S.check(proc.returncode == 0 and lines,
                    f"{who} ({path}) failed:\n{proc.stdout[-4000:]}")
            res = json.loads(lines[-1][len("RESULT "):])
            res["who"] = who
            runs.append(res)
            print(f"[{who}] em_scan {res['em_scan']} "
                  + " ".join(f"bcr n={n} {res[f'bcr_{n}']}" for n in BCR_SIZES)
                  + f" LM iterations {res['lm_iterations']}", flush=True)

    import numpy as np

    for who in ("old", "new"):
        a = np.asarray([w for r in runs if r["who"] == who
                        for w in r["replay_walls_ms"]])
        q = np.percentile(a, [25, 50, 75], axis=0)
        print(f"[{who}] golden_large per-cycle wall over {len(a)} replays: "
              f"median {q[1].tolist()} ms, quartiles {q[0].tolist()} .. "
              f"{q[2].tolist()} ms, min {a.min(axis=0).tolist()} ms",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
