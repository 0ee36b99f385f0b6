"""HitL-SLAM headless replay on PyTorch (CUDA by default).

Port of the headless flags of hitl_slam_tpu/cli.py:
  -P / --pose-graph   .stfs.covars pose-graph file (.gz accepted)
  -L / --log          correction log to replay
  -V / --save         output name for repaired poses (default
                      hitl_results.txt, one `x y theta` row per pose)
  --replay-all        replay every log entry in turn, save results, exit
  --replay-fused      same, but the whole log runs as one device-carried
                      chain (engine.run_queue)
  --post-optimize     run the STF correspondence refinement after the
                      replay (or on the loaded map when no replay mode is
                      given)
  --refine-matcher    auto | global | pair: the refinement's correspondence
                      search
  --device            torch device to run on (default cuda)

Run as `python -m hitl_slam_torch.cli -P map.stfs.covars -L session.log
--replay-all -V repaired.txt`.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hitl-slam-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-P", "--pose-graph", required=True)
    p.add_argument("-L", "--log", default=None)
    p.add_argument("-V", "--save", default="hitl_results.txt")
    p.add_argument("--replay-all", action="store_true")
    p.add_argument("--replay-fused", action="store_true",
                   help="replay the log as one device-carried chain "
                        "(engine.run_queue)")
    p.add_argument("--post-optimize", action="store_true",
                   help="run the STF correspondence refinement after the "
                        "replay (dense solve up to 2048 poses, matrix-free "
                        "PCG above)")
    p.add_argument("--refine-matcher", default="auto",
                   choices=("auto", "global", "pair"),
                   help="correspondence search for --post-optimize: "
                        "'global' 1-NN grid, 'pair' per-pose-pair dense "
                        "tiles (needed on heavily re-traversed maps), "
                        "'auto' falls back from global to pair when the "
                        "global matcher yields zero gated bundles")
    p.add_argument("--device", default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    return p


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _post_optimize(engine, matcher: str, device, timed: bool) -> None:
    t0 = time.perf_counter()
    rep = engine.post_optimize(matcher=matcher)
    _sync(device)
    dt = (time.perf_counter() - t0) * 1e3
    print(f"post-optimize (STF refine): lm_iters={rep.lm_iterations} "
          f"cost {rep.initial_cost:.4g} -> {rep.final_cost:.4g}"
          + (f" ({dt:.1f} ms)" if timed else ""))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from .io import logs, stfs
    from .models.hitl.engine import HitLSLAM

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("ERROR: --device cuda but no CUDA device is available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2

    print(f"loading pose graph: {args.pose_graph}")
    try:
        data = stfs.load_stfs_covars(args.pose_graph)
    except (OSError, ValueError) as e:
        print(f"ERROR: Unable to open specified pose-graph file: "
              f"{args.pose_graph} ({e})", file=sys.stderr)
        return 1
    print(f"loaded {len(data.poses)} poses, "
          f"{sum(len(pc) for pc in data.point_clouds)} points "
          f"(map '{data.map_name}') on {device}")

    engine = HitLSLAM(device=device)
    engine.init(data.poses, data.covariances, data.point_clouds,
                data.normal_clouds)

    input_log = []
    if args.log:
        try:
            input_log = logs.load_log(args.log)
        except (OSError, ValueError, IndexError) as e:
            print(f"ERROR: Unable to parse correction log: {args.log} ({e})",
                  file=sys.stderr)
            return 1
        print(f"loaded {len(input_log)} logged corrections from {args.log}")

    if args.replay_fused:
        live = [e for e in input_log if not e.undone]
        t_start = time.perf_counter()
        reports = engine.run_queue(live)
        _sync(device)
        total = time.perf_counter() - t_start
        for i, (entry, rep) in enumerate(zip(live, reports)):
            status = "ok" if rep.accepted else f"rejected: {rep.reason}"
            print(f"[{i}] {entry.correction_type.name}: {status} "
                  f"(lm_iters={rep.lm_iterations}, "
                  f"cost {rep.initial_cost:.4g} -> {rep.final_cost:.4g})")
        n_ok = sum(r.accepted for r in reports)
        print(f"fused-replayed {len(live)} corrections ({n_ok} accepted) in "
              f"{total:.2f} s ({total * 1e3 / max(len(live), 1):.1f} ms/cycle)")
        if args.post_optimize:
            _post_optimize(engine, args.refine_matcher, device, timed=False)
    elif args.replay_all:
        t_start = time.perf_counter()
        for i, entry in enumerate(input_log):
            if entry.undone:
                print(f"[{i}] skipping undone entry")
                continue
            t0 = time.perf_counter()
            rep = engine.replay_log(entry)
            _sync(device)
            dt = (time.perf_counter() - t0) * 1e3
            status = "ok" if rep.accepted else f"rejected: {rep.reason}"
            print(f"[{i}] {entry.correction_type.name}: {status} "
                  f"({dt:.1f} ms, lm_iters={rep.lm_iterations}, "
                  f"cost {rep.initial_cost:.4g} -> {rep.final_cost:.4g})")
        total = time.perf_counter() - t_start
        print(f"replayed {len(input_log)} corrections in {total:.2f} s")
        if args.post_optimize:
            _post_optimize(engine, args.refine_matcher, device, timed=True)
    elif args.post_optimize:
        _post_optimize(engine, args.refine_matcher, device, timed=True)

    stfs.save_results_poses(args.save, engine.get_poses())
    print(f"saved {len(data.poses)} poses to {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
