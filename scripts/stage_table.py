"""Where a correction's time goes, on the card: one run of a benchmark cell
(cardbench/) in this process, then the recorder's snapshot
(hitl_slam_torch/utils/timing.py): the cycle program's stage edges a
replay, its loops' trips, the engine's spans a correction, each
correction's wall, device and host-exposed time, over the window's
corrections (cardbench/stages.py) and over the process's, the EM refit
kernel's inlier counts and route in the last round of each cycle program,
and the device timer's calibration (bracket, drift) and step
(scripts/clock_cost.py).

    python scripts/stage_table.py [--workload <cell>] [--seed <n>]
        [--seconds <s>] [--trace 0|1] [--cost 0|1]
        [--out chiprun_out/stage_table.json]

With --trace 1 it also holds the stage clock against the profiler's trace
of the cell's traced window: each replay's begin and end, mapped onto the
host's clock and then the trace's (timing.trace_offset_us), against the
profiler's span of the same graph launch (cardbench/tracing.py).

With --cost 1 it also measures what the recorder costs: each captured
cycle graph replayed back to back against the same graph captured without
its clock (clock_cost.replay_cost), in turns, timed by CUDA events; and a
span's host time, with and without a profiler running.

Prints one JSON object as its last line and writes it to --out.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = ("lm", "bcr_solve")


def one_clock(snap, events, tracing) -> dict:
    """The traced window's cycle replays, mapped onto the trace's clock,
    against the profiler's graph spans, paired in order: distances (µs) of
    begin from the span's start and of end from its end."""
    from hitl_slam_torch.utils import timing

    off = timing.trace_offset_us(events, snap.spans)
    spans, _ = tracing.graph_spans(events)
    if off is None or not spans:
        return {"offset_us": off, "graph_spans": len(spans)}
    lo, hi = spans[0][0] - 1e3, spans[-1][1] + 1e3
    mapped = sorted((b * 1e-3 + off, e * 1e-3 + off)
                    for c in snap.clocks if c["label"] == "hitl"
                    for _, b, e in c["ring"] if lo <= b * 1e-3 + off <= hi)
    out = {"offset_us": off, "graph_spans": len(spans),
           "replays": len(mapped)}
    if len(mapped) == len(spans):
        d = np.array([(b - s0, s1 - e) for (b, e), (s0, s1)
                      in zip(mapped, spans)])
        q = [0, 50, 100]
        out.update(begin_after_start_us=np.percentile(d[:, 0], q).tolist(),
                   end_before_end_us=np.percentile(d[:, 1], q).tolist(),
                   median_distance_us=float(np.median(np.abs(d))),
                   each_us=np.round(d, 2).tolist())
    return out


def clock_cost() -> dict:
    """By correction type: clock_cost.replay_cost of the cycle graph."""
    from clock_cost import replay_cost

    from hitl_slam_torch.models.hitl import cycle

    out = {}
    for prog in list(cycle._programs._programs.values()):
        for key, g in prog.graphs.items():
            args = (*prog.inputs, key)
            out[int(key)] = replay_cost(g, lambda: prog.fn(*args), rounds=4)
    return out


def stage_rows(st, rows, mean_wall) -> dict:
    """The cycle program's stages `st` (timing.Stages) and the corrections
    `rows` (timing.Correction) read: edges, loops, device and host-exposed
    ms, against the window's mean wall."""
    trips, trip_ns = st.loop("lm", LM)
    rounds, round_ns = st.loop("em_refit", ("em_refit",))
    dev = float(np.mean([c.device_ns for c in rows])) * 1e-6
    exposed = float(np.mean([c.exposed_ns for c in rows])) * 1e-6
    return {
        "replays": st.replays, "replay_ms": st.mean_ms(),
        "edges_ms_a_replay": {k: [round(ms, 6), round(h, 4)]
                              for k, (ms, h) in sorted(
                                  st.edges_ms().items(),
                                  key=lambda kv: -kv[1][0])},
        "lm": {"trips_a_replay": trips / st.replays,
               "trip_ms": trip_ns / trips * 1e-6 if trips else None},
        "em_refit": {"rounds_a_replay": rounds / st.replays,
                     "round_ms": round_ns / rounds * 1e-6 if rounds else None},
        "pre_solve_ms": st.before_ms(LM),
        "corrections": len(rows),
        "wall_ms": float(np.mean([c.wall_ns for c in rows])) * 1e-6,
        "device_ms": dev, "exposed_ms": exposed,
        "device_plus_exposed_over_window_mean":
            (st.mean_ms() + exposed) / mean_wall - 1.0}


def refit_inliers() -> list:
    """Each live cycle program's EM refit record, read after the window:
    each stroke's inliers in the last refit round and where the kernel
    fitted them from (models/hitl/cycle.py::CycleProgram.refit_stats;
    ops/em_refit.py::ROUTES), for the program's map shape."""
    from hitl_slam_torch.models.hitl import cycle
    from hitl_slam_torch.ops import em_refit

    out = []
    for prog in list(cycle._programs._programs.values()):
        stats = prog.refit_stats.tolist()
        P, N = prog.inputs[0].shape[:2]
        out.append({"map": [P, N], "inliers": [r[0] for r in stats],
                    "routes": [em_refit.ROUTES[r[1]] if r[1] >= 0 else None
                               for r in stats]})
    return out


def span_cost(n: int = 20000) -> dict:
    """Host µs of one empty span, without and with a (CPU) profiler
    running, and of an empty `with` for comparison."""
    from torch.profiler import ProfilerActivity, profile

    from hitl_slam_torch.utils import timing

    rec = timing.TimerCollection()

    def per(fn):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with fn():
                pass
        return (time.perf_counter_ns() - t0) / n * 1e-3

    out = {"empty_with": per(contextlib.nullcontext),
           "span": per(lambda: rec.span("x"))}
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_profiled"] = per(lambda: rec.span("x"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="hitl-figure8-1024.corrections")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 5)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--cost", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "stage_table.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from cardbench import harness, stages, tracing
    from clock_cost import timer_steps
    from hitl_slam_torch.utils import device_loop, timing

    traces = []
    profiled = tracing.profiled

    @contextlib.contextmanager
    def keep(device, out):
        with profiled(device, out):
            yield
        traces.append(out)

    tracing.profiled = keep

    device_loop.calibrate(torch.device("cuda", 0))   # the run's first point
    cell = harness.find_cell(args.workload)
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T0)
    driver = harness.load_module(
        os.path.join(cell.base, "mixes", f"{cell.driver}.py"), "mix")
    run = driver.run(ctx)
    out = {"card": torch.cuda.get_device_name(0),
           "end_to_end": harness.read_metrics(cell, run, False),
           "per_layer": harness.read_metrics(cell, run, True)}
    walls = run.samples["correction_ms"]
    mean_wall = float(np.mean(walls))
    win = stages.window(run)
    snap = timing.snapshot()
    rows = [c for c in snap.corrections() if c.device_ns is not None]
    spans = {k: (timing.GLOBAL_TIMERS.acc[k] * 1e3
                 / timing.GLOBAL_TIMERS.count[k], timing.GLOBAL_TIMERS.count[k])
             for k in sorted(timing.GLOBAL_TIMERS.count)}
    out.update({
        "window": {"corrections": len(walls), "mean_ms": mean_wall,
                   "p50_ms": float(np.median(walls)), "window_s": run.window_s,
                   "setup_s": run.setup_s},
        "trace_window": {k: run.trace.get(k) for k in ("busy_s", "window_s",
                                                       "graphs")},
        "process": stage_rows(snap.stages("hitl"), rows, mean_wall),
        "window_stages": None if win is None else stage_rows(
            stages.stages(run), win[1], mean_wall),
        "spans_ms_mean_and_count": spans,
        "one_clock": one_clock(snap, traces[0]["events"], tracing)
        if traces else None,
        "counters": snap.counters,
        "em_refit_last_round": refit_inliers(),
        "timer": snap.timer(),
        "timer_steps_ns": timer_steps(torch),
        "checks": {c.name: c.value for c in run.checks},
    })
    if args.cost:
        out["cost"] = {"device_ms_a_replay": clock_cost(),
                       "span_us": span_cost()}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=float)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
