#!/usr/bin/env python3
"""Where the time of one correction cycle and of the post-human refine goes,
for the PyTorch port on a GPU.

    python scripts/profile_torch_cycle.py [--repeat 3] [--trace trace.json]

Replays the 1024-pose golden session (tests/data/golden_large.*) with the
port's engine on cuda: once to warm up, then `--repeat` times with host
timing (wall ms per cycle after torch.cuda.synchronize()), once with each
cycle stage timed on its own, then once under torch.profiler. Then the same
for post_optimize on the repaired map: wall ms, the refine's stages
(grid_match, build_stf_factors, the pair sort and compaction, the one-hot
selectors, assemble_dense, the Cholesky factorization and its triangular
solves, the cost-only factor pass) timed on their own for the fused and the
two-pass dense solver, and a torch.profiler window. Prints the card's name
and power limit, the wall times, host ms per stage, device time by kernel
name (top 20), the number of device operations, and the device's busy share
of each profiled window. Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(HERE, "tests", "data")


def replay(torch, data, entries):
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    eng = HitLSLAM(device="cuda")
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=16384)
    torch.cuda.synchronize()
    walls, iters = [], []
    for e in entries:
        t0 = time.perf_counter()
        rep = eng.replay_log(e)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        iters.append(rep.lm_iterations)
        if not rep.accepted:
            raise RuntimeError(f"correction rejected: {rep.reason}")
    return walls, iters


class StageTimer:
    """Wraps functions, named as (owner, attribute), so that each call is
    timed with a synchronise on both sides (which adds a little time of its
    own); restores them on exit."""

    def __init__(self, torch, targets):
        from collections import defaultdict

        self.torch = torch
        self.targets = targets
        self.spent = defaultdict(float)
        self.calls = defaultdict(int)
        self.saved = [(owner, name, getattr(owner, name))
                      for owner, name in targets]

    def _timed(self, name, fn):
        def run(*a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.spent[name] += (time.perf_counter() - t0) * 1e3
            self.calls[name] += 1
            return out
        return run

    def __enter__(self):
        for owner, name, fn in self.saved:
            setattr(owner, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)

    def report(self, title, total, rest_label):
        print(f"{title} ({total:.3f} ms wall, synchronising at every stage "
              f"boundary):")
        for name in sorted(self.spent, key=self.spent.get, reverse=True):
            print(f"  {name:24s} {self.spent[name]:9.3f} ms  "
                  f"{self.calls[name]:3d} calls  "
                  f"{100 * self.spent[name] / total:5.1f} %")
        rest = total - sum(self.spent.values())
        print(f"  {rest_label:24s} {rest:9.3f} ms")


def stage_split(torch, data, entries):
    """Host ms per cycle stage over one replay."""
    from hitl_slam_torch.models.hitl import cycle as C

    names = ("em_scan", "order_on_device", "apply_explicit",
             "constraint_deltas", "_scatter_constraints", "backprop",
             "build_problem", "lm_solve")
    targets = [(C, name) for name in names]
    targets.append((C.em_input, "endpoint_adjust_batch"))
    with StageTimer(torch, targets) as timer:
        walls, _ = replay(torch, data, entries)
    timer.report(f"stage split over {len(entries)} cycles", sum(walls),
                 "(rest of cycle + engine)")


def device_profile(torch, run, label, trace=None):
    """run() under torch.profiler: the device's busy share of the window
    and the top device operations by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = []   # device-side events only: op-level events repeat their time
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    launches = sum(r[1] for r in rows)
    print(f"{label}: device busy {busy_ms:.3f} ms of {window_ms:.3f} ms wall "
          f"({100 * busy_ms / window_ms:.2f} %, profiler on); {launches} "
          f"device operations")
    print(f"{'device ms':>10} {'count':>7}  name")
    for dev_us, count, key in rows[:20]:
        print(f"{dev_us / 1e3:10.3f} {count:7d}  {key[:100]}")
    if trace:
        prof.export_chrome_trace(trace)
        print(f"trace written to {trace}")


def refine_profile(torch, data, entries, repeat):
    """post_optimize on the repaired map: wall ms, stage split for both
    dense solvers, device profile."""
    from hitl_slam_torch.models.hitl import refine as R
    from hitl_slam_torch.models.hitl.engine import HitLSLAM
    from hitl_slam_torch.ops import correspond as C
    from hitl_slam_torch.solver import stf_solve as S
    from hitl_slam_torch.solver.lm import LMConfig

    eng = HitLSLAM(device="cuda")
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=16384)
    for e in entries:
        eng.replay_log(e)
    repaired = eng.state

    def refine(solver="auto"):
        st = repaired
        return R.post_human_refine(st.points, st.normals, st.point_mask,
                                   st.poses, st.constraints,
                                   config=LMConfig(max_iterations=30),
                                   solver=solver)

    for r in range(repeat + 1):           # the first run warms up
        eng.init_from_state(repaired)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = eng.post_optimize()
        torch.cuda.synchronize()
        print(f"post_optimize {r}{' (warm-up)' if r == 0 else ''}: wall "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms, LM iterations "
              f"{rep.lm_iterations}, cost {rep.initial_cost:.6g} -> "
              f"{rep.final_cost:.6g}, {rep.reason}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")

    targets = [(C, "grid_match"), (C, "build_stf_factors"),
               (C, "stf_residuals"), (S, "build_problem"),
               (S, "sort_factors_by_pair"), (S, "compact_pair_rows"),
               (S, "stf_onehots"), (S, "assemble_dense"),
               (S, "_mnt_updates"), (S, "_read_flags"),
               (torch.linalg, "cholesky_ex"),
               (torch.linalg, "solve_triangular")]
    for solver in ("dense_fused", "dense"):
        with StageTimer(torch, targets) as timer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = refine(solver)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        timer.report(f"refine stage split, solver {solver}, "
                     f"{int(out.iterations)} LM iterations, "
                     f"{int(out.num_matches)} matches", total,
                     "(rest of the refine)")
    device_profile(torch, refine, "profiled refine (dense_fused)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="also write a chrome trace of the profiled replay")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_cycle: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from hitl_slam_torch.io import logs, stfs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} ({smi})")
    data = stfs.load_stfs_covars(os.path.join(DATA,
                                              "golden_large.stfs.covars.gz"))
    entries = logs.load_log(os.path.join(DATA, "golden_large.log"))

    replay(torch, data, entries)            # warm-up: build, load, caches
    for r in range(args.repeat):
        walls, iters = replay(torch, data, entries)
        print(f"replay {r}: wall ms per cycle "
              f"{[round(w, 3) for w in walls]}, LM iterations {iters}")

    stage_split(torch, data, entries)

    device_profile(torch, lambda: replay(torch, data, entries),
                   f"profiled replay of {len(entries)} cycles",
                   trace=args.trace)
    refine_profile(torch, data, entries, args.repeat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
