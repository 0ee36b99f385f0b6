"""Run one cell of the benchmark once, on the card(s) of this machine.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the check's numbers on standard error and, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or its per-layer metrics with --trace 1),
device, breakdown (trace runs)
and checks. Exits non-zero with no result where the machine has fewer cards
than the cell asks for, and where JAX or the JAX package was loaded.
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


def _caches() -> None:
    """Every kernel cache inside the checkout, at a fixed path; keep
    libraries from loading JAX on their own."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".cardbench-cache",
                                                  "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        ROOT, ".cardbench-cache", "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    from cardbench import harness

    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cardbench: {args.workload} needs {cell.chips} CUDA device(s),"
              f" this machine has {have}", file=sys.stderr)
        return 2
    line, err = harness.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda", T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"cardbench: loaded {', '.join(bad)}: the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for e in err:
        print(e, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
