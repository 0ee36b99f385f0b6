"""What the stage clock (utils/device_loop.py::StageClock) would cost each
device program, and the step of the card's %globaltimer, on the card.

Runs `chip_smoke.py` in this process (every program on its paths: the
cycle, the refine, EnML's sweep, window and checkerboard, the lone LM,
repair, SPIKE, SDF, RANSAC, the rounds) with a clock on every graph (only
the cycle's carry one otherwise), keeping the first graph captured under
each program label. Then each kept graph is replayed back to back against
the same function captured again without its clock (no `begin` or `end`
node, no mark in its loop tests or launch counters), the two in turns,
timed by CUDA events on the inputs the program last loaded; with the
marks a replay makes, from the clock's hits. A fresh capture's memory may
sit elsewhere than the first's, which alone moves a small graph's time by
a few percent either way.

    python scripts/clock_cost.py [--rounds 6] [--budget-ms 250]
        [--out chiprun_out/clock_cost.json]

Prints chip_smoke's lines, then one JSON object as its last line, also
written to --out. Exits with chip_smoke's code (2 without CUDA).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TIMER_STEP_SOURCE = r"""
extern "C" __global__ void steps(long long* out, int n, long long reads) {
  unsigned long long last, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(last));
  int k = 0;
  for (long long i = 0; i < reads && k < n; ++i) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t != last) {
      out[k++] = static_cast<long long>(t - last);
      last = t;
    }
  }
  for (; k < n; ++k) out[k] = 0;
}
extern "C" int timer_steps(long long* out, int n, long long reads) {
  steps<<<1, 1>>>(out, n, reads);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def timer_steps(torch, n: int = 64, reads: int = 1 << 22) -> list[int]:
    """The first n nonzero steps (ns) of %globaltimer one thread sees, in
    at most `reads` reads (a kernel built here with nvcc)."""
    from hitl_slam_torch.utils import cuda_build

    out_dir = os.path.join(cuda_build.BUILD, "probe")
    os.makedirs(out_dir, exist_ok=True)
    src, so = (os.path.join(out_dir, f) for f in ("timer_steps.cu",
                                                  "libtimer_steps.so"))
    with open(src, "w") as f:
        f.write(TIMER_STEP_SOURCE)
    built = subprocess.run([cuda_build.nvcc_path(), *cuda_build.ARCH,
                            *cuda_build.COMMON, "-shared", "-o", so, src],
                           capture_output=True, text=True)
    if built.returncode:
        raise RuntimeError(built.stdout + built.stderr)
    lib = ctypes.CDLL(so)
    lib.timer_steps.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_longlong]
    out = torch.zeros((n,), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    code = lib.timer_steps(out.data_ptr(), n, reads)
    if code:
        raise RuntimeError(f"timer steps: CUDA error {code}")
    return out.cpu().tolist()


def replay_cost(graph, fn, rounds: int = 6, budget_ms: float = 250.0) -> dict:
    """Device ms a replay of `graph` (a LoopGraph of `fn`) and of `fn`
    captured again without its clock, on the same stream: `rounds` rounds
    of back-to-back replays of each, the two in turns (the order swapped
    every round), each round ~`budget_ms` long; the marks a replay of
    `graph` makes."""
    import numpy as np
    import torch

    from hitl_slam_torch.utils.device_loop import LoopGraph

    bare = LoopGraph(fn, graph.device, stream=graph.stream,
                     label=graph.clock.label)

    def timed(g, k):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(k):
            g.replay()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / k

    hits0 = graph.clock.read()
    k = max(2, min(200, int(budget_ms / max(timed(graph, 1), 1e-3))))
    timed(bare, 1)
    ms = {"clock": [], "bare": []}
    for r in range(rounds):
        pair = [("clock", graph), ("bare", bare)]
        for name, g in (pair if r % 2 == 0 else pair[::-1]):
            ms[name].append(timed(g, k))
    hits1 = graph.clock.read()
    marks = ((hits1["hits"].sum() - hits0["hits"].sum())
             / max(hits1["replays"] - hits0["replays"], 1))
    c, b = float(np.median(ms["clock"])), float(np.median(ms["bare"]))
    return {"clock_ms": c, "bare_ms": b, "cost_ms": c - b,
            "cost_pct": (c - b) / b * 100 if b else None,
            "marks_a_replay": float(marks),
            "us_a_mark": (c - b) * 1e3 / marks if marks else None,
            "replays_a_round": k, "nodes": [graph.nodes, bare.nodes],
            "runs_ms": ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--budget-ms", type=float, default=250.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "clock_cost.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("clock_cost: needs a CUDA device", file=sys.stderr)
        return 2
    from hitl_slam_torch.utils import device_loop

    kept: dict = {}
    real_init = device_loop.LoopGraph.__init__

    def init(self, fn, device, pool=None, stream=None, label="graph",
             clock=False):
        real_init(self, fn, device, pool, stream, label, clock=True)
        if label not in kept:
            kept[label] = (self, fn)

    device_loop.LoopGraph.__init__ = init
    import chip_smoke

    try:
        rc = chip_smoke.main()
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    device_loop.LoopGraph.__init__ = real_init
    out = {"card": torch.cuda.get_device_name(0), "chip_smoke_rc": rc,
           "timer_steps_ns": timer_steps(torch), "programs": {}}
    for label, (graph, fn) in kept.items():
        try:
            out["programs"][label] = replay_cost(graph, fn, args.rounds,
                                                 args.budget_ms)
        except Exception as e:     # reported, the others still measured
            out["programs"][label] = {"error": repr(e)}
        print(f"[clock cost] {label}: {out['programs'][label]}", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps(out, default=float))
    return rc


if __name__ == "__main__":
    sys.exit(main())
