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
in tests/data. Then the auto-proposal stage on the raw (drifted) map (wall ms
of propose_corrections, split into the device stage and the host loop, and
the number of proposals) and one LTVM curation of the repaired map (wall ms
of curate, split into SDF, filter, RANSAC and the host merge, and the number
of vectors), and the checkerboard EnML localizer on a figure-8 stream
(160 scans: wall ms and its stages, matches, batched GN steps, carry and
scatter, covariance pass). Then the replica batch of BASELINE config #5 on
the repaired map (--replicas perturbed copies, 20 LM iterations): the wall
ms of batched_solve with the batched BCR kernel and with its plain batched
twin, solves/s, the per-replica iteration counts, and the wall of the same
solves run one after another. With --sharded D, the pose-sharded LM on a
mesh of D partitions on the device (20 LM iterations; a replay of its
program on a card, and eagerly) beside the lone lm.solve, each wall ms for
the solve alone: on the repaired map (1024 poses)
and on a seeded chain 16 times as long (16384 poses); and the checkerboard
localizer's mesh branch (D replica entries) on the same stream, ms a node
at W = 10. Correctness fields are against those files; nothing of JAX is
imported. Runs on the card unless --device says otherwise.

    python -m hitl_slam_torch.bench [--headline] [--scale 8192,16384]

With either flag the run is the reference's own HitL bench sessions
(hitl_slam_torch/bench_sessions.py) instead, and the JSON object holds the
device's facts and only the sections asked for. --headline: the 1024-pose,
180-ray two-lap figure-8 session with its five mixed corrections (one
warm-up, three timed sessions: the per-correction replay_log wall ms as
median, quartiles and minimum over the accepted cycles, the accepted flags,
LM iterations, final costs, dropped rows, constraint rows, the aligned
error against ground truth), the pipelined chain (queue_chain over the first
four accepted corrections, 16 repetitions from the initial state: ms a
chained cycle, its flags and LM iterations, the scalar host reads and device
operations a cycle), solve-only (ms a joint solve on each accepted cycle's
snapshot, beside the f64 cpu_lm_solve and scipy_generic_solve of the same
problems) and the 8192-pose joint solve alone (wall ms, iterations).
--scale: the 8192-pose two-lap session (per-cycle walls, flags, LM
iterations, costs, rows, the plain and aligned errors against ground
truth, peak device memory) with the post-human refine at scale on its
result (pair matcher, PCG: wall ms of two samples, the match and LM halves,
matches, drop counters, iterations, costs), and the 16384-pose four-lap
session with the f64 cpu_lm_solve of its last cycle's problem (the relative
cost gap). --smoke shrinks the headline to 128 poses and 40 rays, one
session and two repetitions, to check the script on the CPU; it is no
measurement.

    python -m hitl_slam_torch.bench --reference [--smoke] [--out PATH]

The reference's whole bench record (hitl_slam_torch/bench_reference.py):
every number of the root bench.py's BENCH_DETAIL.json under its own key,
as one JSON object on the last line of stdout, also written to --out
(default hitl_slam_torch/build/bench_reference.json). On the card it takes
minutes: the scale map's sequential EnML sweep alone is one and a half,
the profiled device analysis four. --smoke runs
it at the reference's smoke sizes and leaves out what the reference leaves
out there.
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
REFERENCE_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "bench_reference.json")


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
    synchronise (`sync()`) after the match. On a card each half is a
    replay of its device program, captured by an untimed first run. The
    refined poses come back under "poses"."""
    from .models.hitl import refine as R
    from .solver.lm import LMConfig
    from .utils.device_loop import replays

    st = state
    config = LMConfig(max_iterations=max_iterations)

    def match():
        return R.match_factors(st.points, st.normals, st.point_mask,
                               st.poses, matcher, capacity=65536,
                               max_pairs=8192, bucket=64, max_cells=None)

    def solve(stf):
        return R.solve_factors(st.poses, st.constraints, stf, config, True,
                               solver, 8192)

    if replays(st.poses):
        solve(match()[0])
    sync()
    t0 = time.perf_counter()
    stf, match_dropped, vote_dropped, elect_dropped = match()
    sync()
    t1 = time.perf_counter()
    out = solve(stf)
    sync()
    t2 = time.perf_counter()

    def count(v):
        return None if v is None else int(v)

    return {
        "matcher": matcher, "solver": solver,
        "match_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3,
        "lm_iterations": int(out.iterations),
        "cg_iterations": count(out.cg_iterations),
        "num_matches": int(out.num_matches),
        "initial_cost": float(out.initial_cost),
        "final_cost": float(out.final_cost),
        "match_dropped": count(match_dropped),
        "pairs_dropped": count(out.pairs_dropped),
        "vote_dropped": count(vote_dropped),
        "elect_dropped": count(elect_dropped),
        "poses": out.poses,
    }


def checkerboard_split(sync, device, mesh=None) -> dict:
    """The checkerboard EnML localizer on tests/test_enml.py's figure-8
    stream (160 scans, 240 beams: 128 nodes), warm (the second of two
    calls): wall ms, ms a node, and its stage split (set-up, matches,
    batched GN steps, carry and scatter, covariance pass; synchronised at
    every boundary); with `mesh`, its mesh branch."""
    from .bench_reference import enml_state
    from .models.enml.localizer import EnmlOptions
    from .models.enml.parallel_localizer import checkerboard_localize

    st, steps = enml_state(dict(num_steps=160, num_rays=240, seed=11,
                                noise_trans=4e-3, noise_theta=2e-3), device)
    args = (st.points, st.normals, st.point_mask, st.poses, EnmlOptions())
    checkerboard_localize(*args, mesh=mesh)
    stages = {}
    sync()
    t0 = time.perf_counter()
    checkerboard_localize(*args, mesh=mesh, stage_ms=stages)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return {"scans": steps, "nodes": st.num_poses, "wall_ms": wall_ms,
            "ms_per_node": wall_ms / st.num_poses,
            **{f"{k}_ms": v for k, v in stages.items()}}


def replica_split(sync, state, num_replicas: int) -> dict:
    """BASELINE config #5 on `state` (the repaired map): `num_replicas`
    perturbed copies (make_perturbed_replicas, seed 0), LMConfig(
    max_iterations=20), each timed warm (the second of two calls): the
    batched solve (batched_solve: on the card a replay of its program,
    whose first call captured it; `capture_ms`, None elsewhere) with the
    device's default linear solver (the batched BCR kernel on the card),
    the batched solve with the plain batched BCR, and the same solves one
    after another."""
    import numpy as np
    import torch

    from .parallel.replicas import (batched_solve, make_perturbed_replicas,
                                    replica_program, replica_table)
    from .solver import joint, lm, tridiag

    config = lm.LMConfig(max_iterations=20)
    reps, tb = make_perturbed_replicas(state.poses.cpu().numpy(),
                                       state.constraints, num_replicas)

    def timed(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    out, kernel_ms = timed(lambda: batched_solve(reps, tb, config,
                                                 device=reps.device))
    capture_ms = (replica_program(reps, tb, config).graph().capture_ms
                  if reps.is_cuda else None)
    twin, twin_ms = timed(lambda: batched_solve(
        reps, tb, config, device=reps.device,
        linear_solver=tridiag.bcr_solve))

    def lone_all():
        return [lm.solve(joint.build_problem(reps[r], replica_table(tb, r)),
                         reps[r], config) for r in range(num_replicas)]

    lone, lone_ms = timed(lone_all)
    iters = out.iterations.cpu().numpy()
    return {
        "replicas": num_replicas, "poses": int(reps.shape[1]),
        "max_iterations": config.max_iterations,
        "wall_ms": kernel_ms, "solves_per_s": num_replicas / kernel_ms * 1e3,
        "capture_ms": capture_ms,
        "twin_wall_ms": twin_ms, "lone_wall_ms": lone_ms,
        "iterations": iters.tolist(),
        "iterations_equal_lone": bool(np.array_equal(
            iters, [int(r.iterations) for r in lone])),
        "twin_iterations_equal": bool(torch.equal(out.iterations,
                                                  twin.iterations)),
        "cost_not_up": bool((out.final_cost <= out.initial_cost).all()),
    }


def seeded_chain(n: int, seed: int, device):
    """A drifting n-pose chain and a table of 3 LINE_SEGMENT rows, made as
    tests/test_parallel.py's _chain_poses and _table make theirs (numpy,
    from `seed`): (poses [n, 3] f32 numpy, ConstraintTable of 16 rows on
    `device`)."""
    import numpy as np

    from .core.state import ConstraintTable, CorrectionType, table_from_numpy

    rng = np.random.default_rng(seed)
    p = np.zeros((n, 3), np.float32)
    for i in range(1, n):
        p[i, 2] = p[i - 1, 2] + rng.normal(0, 0.1)
        step = np.array([np.cos(p[i - 1, 2]), np.sin(p[i - 1, 2])]) * 0.5
        p[i, :2] = p[i - 1, :2] + step + rng.normal(0, 0.02, 2)
    t = {k: v.numpy() for k, v in vars(ConstraintTable.empty(16, "cpu")
                                        ).items()}
    for i in range(3):
        t["ctype"][i] = int(CorrectionType.LINE_SEGMENT)
        t["constrained"][i] = int(rng.integers(n // 2, n))
        t["anchor"][i] = int(rng.integers(0, n // 4))
        t["delta_parallel"][i] = float(rng.normal())
        t["delta_perpendicular"][i] = float(rng.normal())
        t["delta_angle"][i] = float(rng.normal() * 0.2)
        t["penalty_dir"][i] = 0.3
        t["active"][i] = True
    return p, table_from_numpy(t, device)


def sharded_split(sync, state, partitions: int, device) -> dict:
    """The pose-sharded LM on a mesh of `partitions` entries on `device`,
    LMConfig(max_iterations=20), a replay of its program on a card and
    eagerly (`eager=True`) side by side, beside the lone lm.solve of the
    same problem (each warm, the solve alone timed): on `state` (the
    repaired map) and on a seeded chain 16 times as long, with the BCR
    launches of the timed sharded solve (the multi route's, one an
    iteration, and the batched route's); then the checkerboard's mesh
    branch with `partitions` replica entries."""
    import torch

    from .parallel.mesh import make_mesh
    from .parallel.sharded_solver import sharded_lm_solve
    from .solver import bcr_kernel, joint, lm

    config = lm.LMConfig(max_iterations=20)
    P = state.num_poses
    chain, table = seeded_chain(16 * P, 0, device)
    mesh = make_mesh(1, partitions, [device] * partitions)
    out = {"partitions": partitions}
    for name, poses, tab in (
            ("map", state.poses, state.constraints),
            ("chain", torch.as_tensor(chain, device=device), table)):
        problem = joint.build_problem(poses, tab)
        runs = {}
        for kind, fn in (
                ("sharded", lambda: sharded_lm_solve(mesh, problem, poses,
                                                     config)),
                ("eager", lambda: sharded_lm_solve(mesh, problem, poses,
                                                   config, eager=True)),
                ("lone", lambda: lm.solve(problem, poses, config))):
            fn()
            sync()
            counters = (bcr_kernel.multi_launches,
                        bcr_kernel.batched_launches)
            before = [c.count for c in counters]
            t0 = time.perf_counter()
            res = fn()
            sync()
            runs[kind] = (res, (time.perf_counter() - t0) * 1e3,
                          [c.count - b for c, b in zip(counters, before)])
        (sh, sh_ms, launched), (lo, lo_ms, _) = runs["sharded"], runs["lone"]
        out[name] = {
            "poses": int(poses.shape[0]), "wall_ms": sh_ms,
            "eager_wall_ms": runs["eager"][1],
            "lone_wall_ms": lo_ms, "iterations": int(sh.iterations),
            "multi_launches": launched[0], "batched_launches": launched[1],
            "lone_iterations": int(lo.iterations),
            "final_cost": float(sh.final_cost),
            "lone_final_cost": float(lo.final_cost),
            "max_pose_diff": float((sh.poses - lo.poses).abs().max()),
        }
    cb = checkerboard_split(sync, device, make_mesh(partitions, 1, [
        device] * partitions))
    out["checkerboard_mesh"] = {k: cb[k] for k in ("nodes", "wall_ms",
                                                    "ms_per_node")}
    return out


def sessions_main(args, device) -> int:
    """The run of --headline / --scale: one JSON line."""
    import torch

    from . import bench_sessions as S

    sizes = [int(x) for x in args.scale.split(",") if x.strip()]
    unknown = [x for x in sizes if x not in S.SCALE_MAPS]
    if unknown:
        print(f"ERROR: --scale takes {sorted(S.SCALE_MAPS)}, not {unknown}",
              file=sys.stderr)
        return 2
    result = {**device_facts(torch, device), "torch": torch.__version__}
    if args.headline:
        run = S.public(S.headline_run(device, smoke=args.smoke))
        result["headline"] = {**run.pop("headline"), **run}
    if sizes:
        result["scale"] = {str(P): S.public(S.scale_session_section(device,
                                                                    P))
                           for P in sizes}
    print(json.dumps(result))
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hitl-slam-torch-bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda, cuda:1 or cpu")
    ap.add_argument("--replays", type=int, default=10,
                    help="timed replays of the session (after one warm-up)")
    ap.add_argument("--refine-iterations", type=int, default=30)
    ap.add_argument("--replicas", type=int, default=32,
                    help="perturbed replicas of the batched solve (0: skip)")
    ap.add_argument("--sharded", type=int, default=0,
                    help="partitions of the pose-sharded solve (0: skip)")
    ap.add_argument("--data", default=DATA,
                    help="directory holding golden_large.* (default: "
                         "tests/data of the checkout)")
    ap.add_argument("--headline", action="store_true",
                    help="the reference's headline session, its chain, "
                         "solve-only and the 8192-pose joint solve")
    ap.add_argument("--scale", default="",
                    help="comma-separated reference sessions to run: 8192, "
                         "16384")
    ap.add_argument("--reference", action="store_true",
                    help="the reference's whole bench record "
                         "(bench_reference.py) as one JSON line")
    ap.add_argument("--out", default=REFERENCE_OUT,
                    help="where --reference writes its record too (default: "
                         "hitl_slam_torch/build/bench_reference.json)")
    ap.add_argument("--smoke", action="store_true",
                    help="--headline or --reference at tiny shapes (a check "
                         "of the script, not a measurement)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

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

    if args.reference:
        from . import bench_reference

        return bench_reference.main(args, device)
    if args.headline or args.scale:
        return sessions_main(args, device)

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
    # the auto-proposal stage on the raw map, warm (the second of two calls)
    raw = HitLSLAM(device=device)
    raw.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=16384)
    raw.propose_corrections(max_proposals=4, seed=0)
    propose_split = {}
    sync()
    t0 = time.perf_counter()
    proposals = raw.propose_corrections(max_proposals=4, seed=0,
                                        timings_ms=propose_split)
    sync()
    propose_ms = (time.perf_counter() - t0) * 1e3

    # one LTVM curation of the repaired map, warm likewise
    from .models.ltvm.curator import LongTermVectorMap

    LongTermVectorMap(seed=0).curate(repaired.poses, repaired.points,
                                     repaired.point_mask)
    curate_split = {}
    sync()
    t0 = time.perf_counter()
    vectors = LongTermVectorMap(seed=0).curate(
        repaired.poses, repaired.points, repaired.point_mask,
        timings_ms=curate_split)
    sync()
    curate_ms = (time.perf_counter() - t0) * 1e3

    enml = checkerboard_split(sync, device)
    replicas = (replica_split(sync, repaired, args.replicas)
                if args.replicas > 0 else None)
    sharded = (sharded_split(sync, repaired, args.sharded, device)
               if args.sharded > 0 else None)

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
        "propose_corrections": {
            "wall_ms": propose_ms, **propose_split,
            "proposals": len(proposals),
            "pairs": [[p.anchor_pose, p.corrected_pose] for p in proposals],
        },
        "ltvm_curate": {"wall_ms": curate_ms, **curate_split,
                        "vectors": len(vectors)},
        "enml_checkerboard": enml,
        "replica_batch": replicas,
        "sharded": sharded,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
