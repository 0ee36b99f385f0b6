"""Replay-and-refine timing of the port on one device, as one JSON line.

    python -m hitl_slam_torch.bench [--device cuda] [--replays N] [--data DIR]

Replays the 1024-pose golden session (golden_large.* under tests/data of the
checkout, or --data) N times with per-correction wall times, then runs
post_optimize on the repaired map: once through the engine (the total and
the report), and once as its two halves, the correspondence search and the
LM solve, with a synchronise between them (the split). Prints one JSON
object: the device's name and power limit as nvidia-smi gives them, the
per-cycle wall ms (median and quartiles over the replays), the refine's wall
ms (total, match, solve), its LM iterations, match count and four drop
counters, peak device memory, and the pose errors against the golden poses
in tests/data. Correctness fields are against those files; nothing of JAX
is imported. Runs on the card unless --device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests", "data")


def device_facts(torch, device) -> dict:
    """Name and power limit of the device the run is on."""
    if device.type != "cuda":
        return {"device": str(device), "name": "cpu", "power_limit": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stdout}")
    name, _, limit = out.stdout.strip().splitlines()[0].partition(",")
    return {"device": str(device),
            "name": torch.cuda.get_device_name(device),
            "nvidia_smi_name": name.strip(), "power_limit": limit.strip()}


def pose_errors(got, expected) -> tuple[float, float]:
    """(max |dx|,|dy| in m, max wrapped |dtheta| in rad)."""
    import numpy as np

    dth = np.arctan2(np.sin(got[:, 2] - expected[:, 2]),
                     np.cos(got[:, 2] - expected[:, 2]))
    return (float(np.abs(got[:, :2] - expected[:, :2]).max()),
            float(np.abs(dth).max()))


def quartiles(xs: list[float]) -> dict:
    if len(xs) < 2:
        return {"median": xs[0], "q1": xs[0], "q3": xs[0]}
    q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": med, "q1": q1, "q3": q3}


def refine_split(sync, state, matcher: str, max_iterations: int,
                 solver: str = "auto") -> dict:
    """The refine as its two halves, timed apart: what
    refine.post_human_refine does at its default capacities, with a
    synchronise (`sync()`) after the match. The refined poses come back
    under "poses"."""
    from .models.hitl import refine as R
    from .solver.lm import LMConfig

    st = state
    sync()
    t0 = time.perf_counter()
    stf, match_dropped, vote_dropped, elect_dropped = R.match_factors(
        st.points, st.normals, st.point_mask, st.poses, matcher,
        capacity=65536, max_pairs=8192, bucket=64, max_cells=None)
    sync()
    t1 = time.perf_counter()
    out = R.solve_factors(st.poses, st.constraints, stf,
                          LMConfig(max_iterations=max_iterations), True,
                          solver, 8192)
    sync()
    t2 = time.perf_counter()

    def count(v):
        return None if v is None else int(v)

    return {
        "matcher": matcher, "solver": solver,
        "match_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3,
        "lm_iterations": int(out.iterations),
        "cg_iterations": out.cg_iterations,
        "num_matches": int(out.num_matches),
        "initial_cost": float(out.initial_cost),
        "final_cost": float(out.final_cost),
        "match_dropped": count(match_dropped),
        "pairs_dropped": count(out.pairs_dropped),
        "vote_dropped": count(vote_dropped),
        "elect_dropped": count(elect_dropped),
        "poses": out.poses,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hitl-slam-torch-bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda, cuda:1 or cpu")
    ap.add_argument("--replays", type=int, default=10,
                    help="timed replays of the session (after one warm-up)")
    ap.add_argument("--refine-iterations", type=int, default=30)
    ap.add_argument("--data", default=DATA,
                    help="directory holding golden_large.* (default: "
                         "tests/data of the checkout)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .io import logs, stfs
    from .models.hitl.engine import HitLSLAM

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda but no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    if args.replays < 1:
        print("ERROR: --replays must be at least 1", file=sys.stderr)
        return 2

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    data = stfs.load_stfs_covars(
        os.path.join(args.data, "golden_large.stfs.covars.gz"))
    entries = logs.load_log(os.path.join(args.data, "golden_large.log"))
    expected = np.loadtxt(
        os.path.join(args.data, "golden_large_expected_poses.txt"))

    def replay():
        eng = HitLSLAM(device=device)
        eng.init(data.poses, data.covariances, data.point_clouds,
                 data.normal_clouds, constraint_capacity=16384)
        sync()
        walls, iters = [], []
        for e in entries:
            t0 = time.perf_counter()
            rep = eng.replay_log(e)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
            iters.append(rep.lm_iterations)
            if not rep.accepted:
                raise RuntimeError(f"correction rejected: {rep.reason}")
        return eng, walls, iters

    replay()                                   # warm-up: build, load, caches
    per_cycle = [[] for _ in entries]
    for _ in range(args.replays):
        eng, walls, iters = replay()
        for k, w in enumerate(walls):
            per_cycle[k].append(w)
    replay_dxy, replay_dth = pose_errors(eng.get_poses(), expected)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    repaired = eng.state
    sync()
    t0 = time.perf_counter()
    rep = eng.post_optimize(max_iterations=args.refine_iterations)
    sync()
    total_ms = (time.perf_counter() - t0) * 1e3
    matcher = "pair" if "pair matcher" in rep.reason else "global"
    split = refine_split(sync, repaired, matcher, args.refine_iterations)
    split_poses = split.pop("poses")
    refined = eng.get_poses()
    shift_xy, shift_th = pose_errors(refined, repaired.poses.cpu().numpy())
    result = {
        **device_facts(torch, device),
        "torch": torch.__version__,
        "session": "golden_large",
        "poses": int(data.poses.shape[0]),
        "points": int(sum(len(pc) for pc in data.point_clouds)),
        "replays": args.replays,
        "cycle_wall_ms": [quartiles(ws) for ws in per_cycle],
        "cycle_lm_iterations": iters,
        "replay_pose_error": {"xy_m": replay_dxy, "theta_rad": replay_dth},
        "post_optimize": {
            "wall_ms": total_ms, "reason": rep.reason,
            "lm_iterations": rep.lm_iterations,
            "initial_cost": rep.initial_cost, "final_cost": rep.final_cost,
            "dropped_rows": rep.dropped_rows,
            **split,
            "split_equals_engine": bool(
                torch.equal(split_poses, eng.state.poses)),
            "pose_shift": {"xy_m": shift_xy, "theta_rad": shift_th},
            "finite": bool(np.isfinite(refined).all()),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None),
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
