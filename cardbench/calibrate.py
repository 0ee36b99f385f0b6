"""Readings that a cell's limits are set from: the check's numbers of the
program over many seeds and of the control (the reference in a lower
precision, put in the program's place) over a few, at the cell's own size,
in one process.

    python3 cardbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control tf32] [--out chiprun_out/cal.jsonl]

The benchmark's runs never call this; the readings and the limits chosen
from them are written in PERF.md.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from cardbench import harness

    cell = harness.find_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for control in ([None, args.control] if args.control else [None]):
            t = time.perf_counter()
            line, err = harness.run_cell(cell, seed, args.seconds, False,
                                         "cuda", T0, control=control)
            row = {"seed": seed, "control": control,
                   "correct": line["correct"],
                   "checks": {k: v["value"] for k, v in line["checks"].items()},
                   "metrics": {k: v["value"] for k, v in line["metrics"].items()},
                   "attempted": line["attempted"],
                   "notes": dict(e.split(" ", 2)[1:] for e in err
                                 if e.startswith("note ")),
                   "run_s": time.perf_counter() - t}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
