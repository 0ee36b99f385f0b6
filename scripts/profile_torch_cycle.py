#!/usr/bin/env python3
"""Where the time of one correction cycle goes, for the PyTorch port on a GPU.

    python scripts/profile_torch_cycle.py [--repeat 3] [--trace trace.json]

Replays the 1024-pose golden session (tests/data/golden_large.*) with the
port's engine on cuda: once to warm up, then `--repeat` times with host
timing (wall ms per cycle after torch.cuda.synchronize()), once with each
cycle stage timed on its own, then once under torch.profiler. Prints the
card's name and power limit, the per-cycle wall times, host ms per stage,
device time by kernel name (top 20), the number of device operations, and
the device's busy share of the profiled window. Needs one CUDA device;
imports nothing of JAX.
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


def stage_split(torch, data, entries):
    """Host ms per cycle stage: the stage functions the cycle calls are
    wrapped with a synchronise on both sides (which adds a little time of
    its own), and one replay is run."""
    from collections import defaultdict

    from hitl_slam_torch.models.hitl import cycle as C

    spent = defaultdict(float)
    calls = defaultdict(int)
    names = {"em_scan": C, "order_on_device": C, "apply_explicit": C,
             "constraint_deltas": C, "_scatter_constraints": C,
             "backprop": C, "build_problem": C, "lm_solve": C}
    saved = {name: getattr(mod, name) for name, mod in names.items()}
    saved_refit = C.em_input.endpoint_adjust_batch

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] += (time.perf_counter() - t0) * 1e3
            calls[name] += 1
            return out
        return run

    try:
        for name, mod in names.items():
            setattr(mod, name, timed(name, saved[name]))
        C.em_input.endpoint_adjust_batch = timed("endpoint_adjust_batch",
                                                 saved_refit)
        walls, _ = replay(torch, data, entries)
    finally:
        for name, mod in names.items():
            setattr(mod, name, saved[name])
        C.em_input.endpoint_adjust_batch = saved_refit
    total = sum(walls)
    print(f"stage split over {len(entries)} cycles ({total:.3f} ms wall, "
          f"synchronising at every stage boundary):")
    for name in sorted(spent, key=spent.get, reverse=True):
        print(f"  {name:24s} {spent[name]:9.3f} ms  {calls[name]:3d} calls  "
              f"{100 * spent[name] / total:5.1f} %")
    rest = total - sum(spent.values())
    print(f"  {'(rest of cycle + engine)':24s} {rest:9.3f} ms")


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

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        walls, iters = replay(torch, data, entries)
        window_ms = (time.perf_counter() - t0) * 1e3
    print(f"profiled replay: wall ms per cycle {[round(w, 3) for w in walls]}"
          f" (profiler on), LM iterations {iters}")

    from torch.autograd import DeviceType

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
    print(f"device busy {busy_ms:.3f} ms of {window_ms:.3f} ms wall "
          f"({100 * busy_ms / window_ms:.2f} %); {launches} device "
          f"operations over {len(entries)} cycles")
    print(f"{'device ms':>10} {'count':>7}  name")
    for dev_us, count, key in rows[:20]:
        print(f"{dev_us / 1e3:10.3f} {count:7d}  {key[:100]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
        print(f"trace written to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
