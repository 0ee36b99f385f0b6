#!/usr/bin/env python3
"""The reference record's EnML checkerboard keys on the card, without the
rest of the record.

    python scripts/enml_record_check.py

Runs `bench_reference.enml_section` (the 160-scan stream: the sweep, the
checkerboard at W = 10 and W = 80) and `enml_scale_section` (the 1078-node
map) on cuda, then `device_analysis` over the scale map's two checkerboard
surfaces as `bench.py --reference` does: their walls are replays of the
checkerboard's program, their device ms, operations, host reads and busy
share an eager run's (`eager=True`) over that run's own wall. Prints one
JSON line (~2 min on an H100); exits 2 without CUDA. Imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("enml_record_check: no CUDA device", file=sys.stderr)
        return 2
    from hitl_slam_torch import bench_reference as R

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    e = R.enml_section(dev)
    out = {k: e[k] for k in ("checkerboard_ms", "w80_checkerboard_ms",
                             "sequential_ms")}
    s = R.enml_scale_section(dev)
    surfaces = {k: (fn, ms, s["_inputs"])
                for k, (fn, ms, *_) in s["_runs"].items()}
    profiled = {k: tuple(r[2:]) for k, r in s["_runs"].items()}
    out.update(scale_checkerboard_ms=s["checkerboard_ms"],
               scale_w80_ms=s["w80_ms"],
               analysis=R.device_analysis(dev, surfaces, profiled),
               seconds=time.perf_counter() - t0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
