"""The reference's whole bench record on the port, as one JSON record.

    python -m hitl_slam_torch.bench --reference [--smoke] [--device cpu]
                                    [--out PATH]

The repository's root bench.py drives the JAX package and writes one
record, BENCH_DETAIL.json, whose `detail` holds every number it measures.
It imports JAX, so the port gives the same record from its own code: every
key of that `detail` under the same name and meaning (KEY_MAP names the
section that gives each), but those in NOT_PORTED. The sections of
bench_sessions.py give the headline, its chain, solve-only, the joint solve
and the 8192- and 16384-pose sessions; this module adds the rest, each a
function of the device that returns a dict (the replica batch of the
headline's final state, bench.py:683-708, is bench.replica_split's):

  overhead_section          the round trip of a trivial operation
                            (bench.py:265-282)
  speculative_section       the keypress latency of speculative cycles, and
                            two forced misses (bench.py:300-400)
  headline_refine_section   the post-human refine of the headline's final
                            state, its two halves, and the f64
                            cpu_refine_solve on its factors
                            (bench.py:710-786)
  enml_section              EnML on the 160-scan stream: the sweep, the
                            checkerboard, the checkerboard at W = 80
                            (bench.py:897-984)
  enml_scale_section        the same on the 2600-scan, 1078-node map
                            (bench.py:985-1073)
  bag_ingest_section        a bag of 1280 scans read by both routes of
                            io/rosbag.py (bench.py:1255-1283)

and `device_analysis`, in place of the reference's `xla_analysis`: for each
of its seven surfaces the wall, the device ms and device operations from
torch.profiler, the busy share and the bytes of the inputs (not measured,
None, for the sweep's replay: UNTRACED_SURFACES). The 8192-pose joint
solve (`solve_8192`) and the two scale-map checkerboard surfaces
(`enml_scale_checkerboard`, `enml_scale_w80`) take their wall from a
replay of their program, as the record's `solve_8192_poses_20iter_ms` and
`enml_*checkerboard_ms` keys do, and their device ms, operations, host
reads and busy share from an eager run (`eager=True`) of the same work,
over that run's own wall (`profiled_wall_ms`).

`hbm_peak_mb` is the largest torch.cuda.max_memory_allocated over the run:
the peak is reset before each section and read after it, and every section
is listed with its own peak in the record's notes. Every wall is host time
around work that ends in a synchronise. A section that fails makes the run
fail; at --smoke the sections the reference leaves out at its smoke size
are left out (SMOKE_LEFT_OUT), and the one key the reference keeps there,
`enml_w80_checkerboard_ms`, is null.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from . import bench_sessions as S
from .core.state import SingleInput, make_map_state
from .models.hitl.engine import HitLSLAM
from .solver import lm

# the human pause before the keypress, and the forced misses (bench.py:326,
# :353): the selection nudged by 2 cm, and a pose tensor of the same values
PAUSE_S = 0.3
MISS_KINDS = ("reselect", "drift")
RESELECT_NUDGE = 0.02
RTT_TRIPS = 15
REPLICAS, REPLICAS_SMOKE = 32, 4
# the refine of the headline's final state (bench.py:721, :752)
REFINE_CONFIG = lm.LMConfig(max_iterations=10)
REFINE_CAPACITY = 65536
# EnML (bench.py:901-1003): scans at 20 Hz; the test stream, its smoke
# size and the scale map; the checkerboard's windows a batch at W = 10 and
# at W = 80; the sweep of the scale map is warmed on its first 32 nodes
SCAN_PERIOD_S = 0.05
ENML_STREAM = dict(num_steps=160, num_rays=240, seed=11)
ENML_STREAM_SMOKE = dict(num_steps=24, num_rays=60, seed=11)
ENML_SCALE_STREAM = dict(num_steps=2600, num_rays=240, seed=12, num_laps=7)
CHUNK, CHUNK_SMOKE, CHUNK_W80 = 16, 4, 8
W80 = 80
# the bag of bench.py:1264-1270: 64 scans of 720 rays, 20 times over
BAG_STREAM = dict(num_steps=64, num_rays=720, seed=3)
BAG_REPEAT = 20
BAG_CHUNK = 1 << 20

# every key of the reference's BENCH_DETAIL.json `detail`, and the section
# of this port that gives it
KEY_MAP = {
    "backend": "device",
    **dict.fromkeys((
        "cycle_ms", "cycle_ms_min", "cycle_ms_session_medians",
        "dropped_constraint_rows", "accepted", "stage_ms_last_cycle",
        "lm_iterations", "final_costs", "num_constraints",
        "interactive_cycle_ms", "map_error_vs_gt_m"), "headline"),
    "tunnel_rtt_ms": "overhead",
    **dict.fromkeys(("hbm_peak_mb", "hbm_peak_kind"), "memory"),
    "bag_ingest_mb_s": "bag_ingest",
    **dict.fromkeys((
        "pipelined_cycle_ms", "pipelined_semantics",
        "pipelined_chain_accepted", "pipelined_chain_lm_iterations",
        "device_cycle_ms"), "chain"),
    **dict.fromkeys((
        "interactive_speculative_ms", "speculative_hits",
        "speculative_attempts", "speculative_hit_rate",
        "speculative_miss_ms", "speculative_miss_ms_per_kind",
        "vs_baseline_speculative", "vs_optimized_cpu_speculative"),
        "speculative"),
    "interactive_dispatch_overhead_ms": "overhead",
    **dict.fromkeys(("vs_baseline_interactive", "vs_baseline_device"),
                    "solve_only"),
    **dict.fromkeys((
        "enml_batch_localize_ms", "enml_checkerboard_ms", "enml_nodes",
        "enml_realtime_factor", "enml_checkerboard_realtime_factor",
        "enml_w80_checkerboard_ms"), "enml"),
    **dict.fromkeys((
        "enml_scale_nodes", "enml_scale_points", "enml_scale_padded_n",
        "enml_scale_mask_occupancy", "enml_scale_state_mb",
        "enml_scale_sequential_ms", "enml_scale_checkerboard_ms",
        "enml_scale_w80_checkerboard_ms", "enml_scale_realtime_factor",
        "enml_scale_checkerboard_realtime_factor",
        "enml_scale_w80_realtime_factor"), "enml_scale"),
    **dict.fromkeys((
        "hitl8192_accepted_cycles", "hitl8192_cycle_ms",
        "hitl8192_cycle_ms_median", "hitl8192_constraint_rows",
        "hitl8192_map_error_vs_gt_m", "post_optimize_8192_pair_ms",
        "post_optimize_8192_pair_ms_samples",
        "post_optimize_8192_variance_note", "post_optimize_8192_match_ms",
        "post_optimize_8192_lm_ms", "post_optimize_8192_matches",
        "post_optimize_8192_rows_dropped",
        "post_optimize_8192_elect_dropped", "post_optimize_8192_iters",
        "post_optimize_8192_cost"), "scale_8192"),
    **dict.fromkeys((
        "hitl16k_accepted_cycles", "hitl16k_cycle_ms",
        "hitl16k_cycle_ms_median", "hitl16k_constraint_rows",
        "hitl16k_map_error_vs_gt_m", "hitl16k_final_cost",
        "hitl16k_cpu_final_cost", "hitl16k_cost_parity_rel",
        "hitl16k_cpu_solve_ms", "hitl16k_cpu_iters"), "scale_16384"),
    **dict.fromkeys((
        "post_optimize_stf_refine_ms", "post_optimize_stf_matches",
        "post_optimize_match_dropped", "post_optimize_match_ms",
        "post_optimize_lm_ms", "post_optimize_lm_iters",
        "cpu_refine_solve_ms", "cpu_refine_final_cost", "cpu_refine_iters",
        "vs_optimized_cpu_refine"), "refine"),
    "solve_8192_poses_20iter_ms": "joint_solve",
    **dict.fromkeys(("replica32_batch_20iter_ms",
                     "replica32_throughput_solves_per_s"), "replicas"),
    **dict.fromkeys((
        "cpu_generic_solve_ms", "cpu_generic_final_cost",
        "cpu_optimized_solve_ms_per_cycle", "cpu_optimized_solve_ms_median",
        "cpu_optimized_final_cost_last", "vs_optimized_cpu_interactive",
        "vs_optimized_cpu", "device_solve_only_ms_per_cycle",
        "device_solve_only_ms_median", "vs_optimized_cpu_solve_only",
        "cpu_baselines"), "solve_only"),
}
NOT_PORTED = {
    "xla_analysis": "XLA's cost and memory analysis of a compiled program; "
                    "eager PyTorch compiles no program. `device_analysis` "
                    "stands in its place: the same seven surfaces measured "
                    "by torch.profiler.",
}
# the port's keys beside the reference's
PORT_KEYS = ("device_analysis",)
# what the reference leaves out at its smoke size (bench.py:795, 961, 990,
# 1078): the scale sessions and the scale map; W = 80 keeps its key
SMOKE_LEFT_OUT = ("scale_8192", "scale_16384", "enml_scale")
DEVICE_SURFACES = ("cycle_chain", "solve_8192", "refine_1024", "enml_batch",
                   "enml_scale_checkerboard", "enml_scale_w80",
                   "refine_8192_pair")


def _median(xs) -> float:
    return float(statistics.median(xs))


def _nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _timed(sync, fn):
    """(fn()'s result, its wall ms), synchronised on both sides."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------- (a)

def overhead_section(device, trips: int = RTT_TRIPS) -> dict:
    """The round trip of `x + 1.0` on a 0-d tensor on `device`, warm, then
    `trips` times, each ending in a synchronise: the median and the
    samples."""
    sync = S.synchronizer(device)
    x = torch.zeros((), device=device)
    _timed(sync, lambda: x + 1.0)
    rtts = [_timed(sync, lambda: x + 1.0)[1] for _ in range(trips)]
    return {"rtt_ms": _median(rtts), "rtt_ms_samples": rtts}


# ---------------------------------------------------------------- (b)

def _same_state(a: HitLSLAM, b: HitLSLAM) -> bool:
    """Poses, covariances, every column of the constraint table and the
    row count of two engines bit-equal."""
    sa, sb = a.state, b.state
    return (a.num_constraints == b.num_constraints
            and torch.equal(sa.poses, sb.poses)
            and torch.equal(sa.covariances, sb.covariances)
            and all(torch.equal(x, y) for x, y in zip(
                vars(sa.constraints).values(),
                vars(sb.constraints).values())))


def _engine(m, capacity, device, speculate=True) -> HitLSLAM:
    eng = HitLSLAM(device=device)
    eng.speculate = speculate
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             odometry=m.odometry, constraint_capacity=capacity)
    return eng


def _click(eng: HitLSLAM, ctype: int, sel) -> None:
    """The two drags of a selection; the second completes it."""
    eng.add_correction_points(ctype, sel[0], sel[1])
    eng.add_correction_points(ctype, sel[2], sel[3])


def speculative_section(device, m, capacity: int,
                        pause_s: float = PAUSE_S) -> dict:
    """The headline's corrections through the two-click path with
    speculative dispatch on a fresh engine: each selection sketched against
    the poses of the moment, clicked, a pause of `pause_s`, then a timed
    run(). A second engine that never speculates replays the same
    corrections in step, and each cycle's poses, covariances and rows are
    held bit-equal to its. Then the forced misses on another fresh pair of
    engines, one a kind with the first corrections: "reselect" (the
    selection re-dragged 2 cm off after the pause, without a dispatch) and
    "drift" (the state's poses replaced by a clone of the same values);
    each must leave `speculative_hits` where it was (else RuntimeError).
    run()'s wall is the keypress's: on a hit the adoption of the result, on
    a miss the wait for and the drop of the stale dispatch and a fresh
    cycle."""
    sync = S.synchronizer(device)
    specs = S.correction_specs(m.poses.shape[0])

    def keypress(eng):
        return _timed(sync, eng.run)

    eng, ref = (_engine(m, capacity, device, on) for on in (True, False))
    walls, accepted, hits, equal, iters = [], [], [], [], []
    for s in specs:
        try:
            sel = S.sketch(m, s, eng.get_poses())
        except ValueError:
            continue
        _click(eng, int(s["ctype"]), sel)
        time.sleep(pause_s)
        before = eng.speculative_hits
        rep, ms = keypress(eng)
        want = ref.replay_log(SingleInput(s["ctype"], 0, sel))
        accepted.append(bool(rep.accepted))
        hits.append(eng.speculative_hits > before)
        iters.append(int(rep.lm_iterations))
        equal.append(_same_state(eng, ref) and rep.accepted == want.accepted
                     and rep.lm_iterations == want.lm_iterations)
        if rep.accepted:
            walls.append(ms)
    if not walls:
        raise RuntimeError("speculative: no cycle accepted")
    attempts = len(accepted)

    eng, ref = (_engine(m, capacity, device, on) for on in (True, False))
    miss, miss_accepted, miss_equal = {}, {}, {}
    for kind, s in zip(MISS_KINDS, specs):
        try:
            sel = S.sketch(m, s, eng.get_poses())
        except ValueError:
            continue
        ct = int(s["ctype"])
        _click(eng, ct, sel)
        time.sleep(pause_s)
        ran = np.asarray(sel, np.float32)
        if kind == "reselect":
            ran = np.stack([sel[0] + RESELECT_NUDGE, sel[1] + RESELECT_NUDGE,
                            sel[2], sel[3]]).astype(np.float32)
            eng.speculate = False
            _click(eng, ct, ran)
            eng.speculate = True
        else:
            eng.state = eng.state.replace(poses=eng.state.poses.clone())
        before = eng.speculative_hits
        rep, ms = keypress(eng)
        if eng.speculative_hits != before:
            raise RuntimeError(f"forced miss ({kind}) reused the stale "
                               "dispatch")
        ref.replay_log(SingleInput(s["ctype"], 0, ran))
        miss_accepted[kind] = bool(rep.accepted)
        miss_equal[kind] = _same_state(eng, ref)
        if rep.accepted:
            miss[kind] = ms
    return {
        "pause_s": pause_s, "attempts": attempts, "hits": sum(hits),
        "hit_rate": sum(hits) / attempts, "accepted": accepted,
        "hit": hits, "lm_iterations": iters, "bit_equal_to_replay": equal,
        "ms": _median(walls), "ms_accepted": walls,
        "miss_ms": _median(list(miss.values())) if miss else None,
        "miss_ms_per_kind": miss, "miss_accepted": miss_accepted,
        "miss_equal_to_replay": miss_equal,
    }


# ---------------------------------------------------------------- (c)

def headline_refine_section(device, state) -> dict:
    """The post-human refine of `state` as bench.py times it: the whole
    refine (global matcher, capacity 65536, the dense fused LM, 10
    iterations) warm, then timed on points + 1e-6; its halves, each warm
    then timed: the match (timed on points + 1e-6), the LM over those
    factors (timed from poses + 1e-6); then the f64 cpu_refine_solve over
    the same factors from the same poses. `lm_final_cost` is the warm LM's
    (from the state's poses, as the f64 solve starts), and `f64_relative`
    its relative gap to the f64 cost. `_stf` holds the factors as the f64
    solve took them, `_f64_poses` its poses, `_run` reruns the timed
    refine, `_inputs` are its input tensors."""
    from .baselines.cpu_refine import cpu_refine_solve, stf_to_numpy
    from .models.hitl.refine import (match_factors, post_human_refine,
                                     solve_factors)

    sync = S.synchronizer(device)
    st = state
    pts_p = st.points + 1e-6

    def refine(points):
        out = post_human_refine(points, st.normals, st.point_mask, st.poses,
                                st.constraints, capacity=REFINE_CAPACITY,
                                config=REFINE_CONFIG)
        float(out.final_cost)
        return out

    def match(points):
        return match_factors(points, st.normals, st.point_mask, st.poses,
                             "global", REFINE_CAPACITY, 8192, 64, None)[0]

    def solve(poses, stf):
        out = solve_factors(poses, st.constraints, stf, REFINE_CONFIG, True,
                            "dense_fused", 8192)
        float(out.final_cost)
        return out

    refine(st.points)
    out, refine_ms = _timed(sync, lambda: refine(pts_p))
    match(st.points)
    stf, match_ms = _timed(sync, lambda: match(pts_p))
    warm = solve(st.poses, stf)
    lm_out, lm_ms = _timed(sync, lambda: solve(st.poses + 1e-6, stf))
    stf_np = stf_to_numpy(stf)
    t0 = time.perf_counter()
    f64_poses, f64_cost, f64_iters = cpu_refine_solve(
        st.poses.cpu().numpy(), S._np_table(st.constraints,
                                            st.constraints.capacity),
        stf_np, max_iterations=REFINE_CONFIG.max_iterations)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    cost = float(warm.final_cost)
    return {
        "refine_ms": refine_ms, "matches": int(out.num_matches),
        "match_dropped": int(out.match_dropped),
        "iterations": int(out.iterations),
        "initial_cost": float(out.initial_cost),
        "final_cost": float(out.final_cost),
        "match_ms": match_ms, "lm_ms": lm_ms,
        "lm_iterations": int(lm_out.iterations),
        "lm_final_cost": cost, "lm_warm_iterations": int(warm.iterations),
        "cpu_ms": cpu_ms, "cpu_final_cost": float(f64_cost),
        "cpu_iterations": int(f64_iters),
        "f64_relative": abs(cost - float(f64_cost))
        / max(abs(float(f64_cost)), 1e-9),
        "_stf": stf_np, "_f64_poses": f64_poses,
        "_run": lambda: refine(pts_p),
        "_inputs": (st.points, st.normals, st.point_mask, st.poses,
                    *vars(st.constraints).values()),
    }


# ---------------------------------------------------------------- (d)

def enml_state(stream: dict, device):
    """bench.py's EnML input: generate_raw_stream(**stream), episodes at
    clip 10/10, a map state with zero covariances on `device`. Returns (the
    state, the scan count)."""
    from .io.figure8 import generate_raw_stream
    from .models.enml.driver import EpisodeOptions, build_episodes

    scans, angles, rel, _, _ = generate_raw_stream(**stream)
    poses, pcs, ncs, _ = build_episodes(
        scans, angles, rel, EpisodeOptions(clip_low=10, clip_high=10))
    st = make_map_state(poses, np.zeros((len(poses), 3, 3), np.float32),
                        pcs, ncs, device=device)
    return st, len(scans)


def enml_footprint(st) -> dict:
    """Nodes, real points, padded points a node, the mask's occupancy and
    the state's MB (points + normals + mask) of an EnML map state."""
    return {
        "nodes": int(st.num_poses), "points": int(st.point_mask.sum()),
        "padded_n": int(st.points.shape[1]),
        "mask_occupancy": float(st.point_mask.float().mean()),
        "state_mb": _nbytes((st.points, st.normals, st.point_mask)) / 1e6,
    }


def _sweep_capture_ms(st, o) -> float | None:
    """The capture ms of the sweep program of `st` under `o` (on a card,
    after its first call), None on the CPU."""
    if st.points.device.type != "cuda":
        return None
    from .models.enml.program import sweep_program

    return sweep_program(st.points, o, None).graph().capture_ms


def _localizers(st):
    """(sweep, checkerboard) of `st` as functions of the points and of the
    options / chunk, each ending in a host read of one value (on a card
    each a replay of its program; the checkerboard's `eager=True` runs it
    eagerly)."""
    from .models.enml.localizer import batch_localize
    from .models.enml.parallel_localizer import checkerboard_localize

    def sweep(points, o):
        p, c = batch_localize(points, st.normals, st.point_mask, st.poses, o)
        float(c[-1, 0, 0])
        return p

    def board(points, o, chunk, eager=False):
        p, c = checkerboard_localize(points, st.normals, st.point_mask,
                                     st.poses, o, chunk=chunk, eager=eager)
        float(c[-1, 0, 0])
        return p

    return sweep, board


def _w80(sync, board, st, chunk):
    """The checkerboard at max_history = 80: warm, then the minimum of two
    timed calls on points + 1e-6 (k + 1)."""
    from .models.enml.localizer import EnmlOptions

    o = EnmlOptions(max_history=W80)
    board(st.points, o, chunk)
    return min(_timed(sync, lambda: board(st.points + 1e-6 * (k + 1), o,
                                          chunk))[1] for k in range(2))


def enml_section(device, smoke: bool = False) -> dict:
    """EnML on bench.py's 160-scan stream (24 scans of 60 rays at
    `smoke`): the sequential sweep (on a card a replay of its program: the
    warm call captures it, `sweep_capture_ms`) and the checkerboard (16
    windows a batch; 4 at `smoke`), each warm then timed on points + 1e-6,
    with their
    realtime factors over the scans at 20 Hz; the checkerboard at W = 80
    (8 a batch, the minimum of two after a warm call), left out (None) at
    `smoke`; the state's footprint. `_poses`: the timed sweep's poses;
    `_run` reruns the timed sweep, `_inputs` are its input tensors."""
    from .models.enml.localizer import EnmlOptions

    sync = S.synchronizer(device)
    st, steps = enml_state(ENML_STREAM_SMOKE if smoke else ENML_STREAM,
                           device)
    sweep, board = _localizers(st)
    o = EnmlOptions()
    chunk = CHUNK_SMOKE if smoke else CHUNK
    pts_p = st.points + 1e-6
    sweep(st.points, o)
    capture_ms = _sweep_capture_ms(st, o)
    poses, seq_ms = _timed(sync, lambda: sweep(pts_p, o))
    board(st.points, o, chunk)
    _, ck_ms = _timed(sync, lambda: board(pts_p, o, chunk))
    stream_s = steps * SCAN_PERIOD_S
    return {
        "scans": steps, **enml_footprint(st), "chunk": chunk,
        "sequential_ms": seq_ms, "sweep_capture_ms": capture_ms,
        "checkerboard_ms": ck_ms,
        "realtime_factor": stream_s / (seq_ms / 1e3),
        "checkerboard_realtime_factor": stream_s / (ck_ms / 1e3),
        "w80_checkerboard_ms": (None if smoke else
                                _w80(sync, board, st, CHUNK_W80)),
        "_poses": poses.cpu().numpy(),
        "_run": lambda: sweep(pts_p, o),
        "_inputs": (st.points, st.normals, st.point_mask, st.poses),
    }


def enml_scale_keys(footprint: dict, scans: int, sequential_ms: float,
                    checkerboard_ms: float, w80_ms: float) -> dict:
    """The eleven enml_scale_* keys of the reference's record from a scale
    map's footprint (enml_footprint), its scan count and three walls."""
    stream_s = scans * SCAN_PERIOD_S
    return {
        "enml_scale_nodes": footprint["nodes"],
        "enml_scale_points": footprint["points"],
        "enml_scale_padded_n": footprint["padded_n"],
        "enml_scale_mask_occupancy": footprint["mask_occupancy"],
        "enml_scale_state_mb": footprint["state_mb"],
        "enml_scale_sequential_ms": sequential_ms,
        "enml_scale_checkerboard_ms": checkerboard_ms,
        "enml_scale_w80_checkerboard_ms": w80_ms,
        "enml_scale_realtime_factor": stream_s / (sequential_ms / 1e3),
        "enml_scale_checkerboard_realtime_factor":
            stream_s / (checkerboard_ms / 1e3),
        "enml_scale_w80_realtime_factor": stream_s / (w80_ms / 1e3),
    }


def enml_scale_section(device) -> dict:
    """The scale map (2600 scans, 7 laps): the sequential sweep timed once
    on points + 1e-6 after a warm call (on a card the warm call captures
    its program, `sweep_capture_ms`, and the timed one replays it), the
    checkerboard at 16 windows a batch warm then timed, and W = 80 at 8 a
    batch (the minimum of two), each a replay of its program on a card.
    `_runs` reruns the two timed checkerboards for the device analysis,
    each with an eager run (`eager=True`) and its wall, which the profiler
    traces in the replay's place; `_inputs`."""
    from .models.enml.localizer import EnmlOptions

    sync = S.synchronizer(device)
    st, steps = enml_state(ENML_SCALE_STREAM, device)
    sweep, board = _localizers(st)
    o = EnmlOptions()
    sweep(st.points, o)
    capture_ms = _sweep_capture_ms(st, o)
    pts_p = st.points + 1e-6
    _, seq_ms = _timed(sync, lambda: sweep(pts_p, o))
    board(st.points, o, CHUNK)
    _, ck_ms = _timed(sync, lambda: board(pts_p, o, CHUNK))
    w80_ms = _w80(sync, board, st, CHUNK_W80)
    o80 = EnmlOptions(max_history=W80)
    pts_80 = st.points + 1e-6

    def eager(points, o, chunk):
        def run():
            return board(points, o, chunk, eager=True)
        return run, _timed(sync, run)[1]

    return {
        "scans": steps, "footprint": enml_footprint(st),
        "sequential_ms": seq_ms, "sweep_capture_ms": capture_ms,
        "checkerboard_ms": ck_ms, "w80_ms": w80_ms,
        "_runs": {"enml_scale_checkerboard": (
                      lambda: board(pts_p, o, CHUNK), ck_ms,
                      *eager(pts_p, o, CHUNK)),
                  "enml_scale_w80": (
                      lambda: board(pts_80, o80, CHUNK_W80), w80_ms,
                      *eager(pts_80, o80, CHUNK_W80))},
        "_inputs": (st.points, st.normals, st.point_mask, st.poses),
    }


# ---------------------------------------------------------------- (e)

def bag_messages() -> list:
    """bench.py's ingest bag: 64 LaserScan messages of 720 rays, 20 times
    over."""
    from .io import rosbag
    from .io.figure8 import generate_raw_stream

    scans, angles, _, _, _ = generate_raw_stream(**BAG_STREAM)
    inc = float(angles[1] - angles[0])
    msgs = [("laser", "sensor_msgs/LaserScan", 100.0 + i,
             rosbag.serialize_laser_scan(scans[i], float(angles[0]), inc))
            for i in range(len(scans))]
    return msgs * BAG_REPEAT


def bag_ingest_section(require_native: bool) -> dict:
    """The ingest bag written with 1 MiB chunks into a temporary directory,
    then read whole by read_messages through the native scanner and
    through Python, each timed once: MB/s (MiB of file a second) and the
    count, which must equal the messages written (else RuntimeError); then
    both routes read again side by side, message for message. Without the
    native scanner the native route is None, or RuntimeError with
    `require_native`."""
    from . import native
    from .io import rosbag

    msgs = bag_messages()
    have_native = native.bag_available()
    if require_native and not have_native:
        raise RuntimeError("bag ingest: the native bag scanner did not build")
    routes = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ingest.bag")
        rosbag.write_bag(path, msgs, chunk_size=BAG_CHUNK)
        size = os.path.getsize(path)
        for name, use in (("native", True), ("python", False)):
            if use and not have_native:
                routes[name] = None
                continue
            t0 = time.perf_counter()
            count = sum(1 for _ in rosbag.read_messages(path, use_native=use))
            secs = time.perf_counter() - t0
            if count != len(msgs):
                raise RuntimeError(f"bag ingest ({name}): {count} messages "
                                   f"read, {len(msgs)} written")
            routes[name] = {"seconds": secs, "messages": count,
                            "mb_s": size / 2 ** 20 / secs}
        equal = None
        if have_native:
            pairs = zip(rosbag.read_messages(path, use_native=True),
                        rosbag.read_messages(path, use_native=False),
                        strict=True)
            equal = all(a == b for a, b in pairs)
    return {"bytes": size, "written": len(msgs), "routes": routes,
            "routes_equal": equal}


# ---------------------------------------------------------------- device

def device_trace(run) -> tuple[float, int, int]:
    """(device ms, device operations, host reads) of run() from
    torch.profiler tracing the card alone (a window of 10^5 launches costs
    minutes with the host's operator events too); a host read is a
    device-to-host copy record (a scalar read is one). The window is run
    again, up to three times, where it comes back without a device record;
    RuntimeError if it never shows one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        ops = sum(e.count for e in events)
        if ops:
            us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                     for e in events)
            reads = sum(e.count for e in events if "DtoH" in e.key)
            return us / 1e3, ops, reads
    raise RuntimeError("the profiler showed no device operation in three "
                       "windows")


def device_profile(run) -> tuple[float, int]:
    """(device ms, device operations) of run(): device_trace's first two."""
    return device_trace(run)[:2]


# surfaces whose run replays a program with a long WHILE loop (the sweep):
# CUPTI does not trace its trips (a window over a replayed sweep reported
# one trip's kernels, and after a few such windows the process died of an
# illegal memory access), and CUDA events around the run span the host's
# gaps too, so their device ms, operations, host reads and busy share are
# not measured (None)
UNTRACED_SURFACES = ("enml_batch",)


def device_analysis(device, surfaces: dict,
                    profiled: dict | None = None) -> dict:
    """For each surface name -> (run, wall ms, input tensors[, extra]): the
    wall, the bytes of the inputs and, on a CUDA device, the device ms,
    device operations and host reads of one rerun under the profiler, the
    busy share (device ms over the wall) and the rerun's own seconds; None
    for those five on the CPU and for UNTRACED_SURFACES. `extra`, a
    callable, adds the fields it returns (the cycle programs' capture ms,
    graph nodes and pool MiB for the chain). `profiled` maps a surface to
    (an eager run of its work, that run's wall ms): the profiler traces the
    eager run in the rerun's place, and its busy share is the eager run's
    device ms over the eager run's wall (`profiled_wall_ms`); the surface's
    wall stays its own run's (the checkerboard's surfaces: their run
    replays a program whose WHILE trips the profiler does not trace)."""
    profiled = profiled or {}
    out = {}
    for name, (run, wall_ms, inputs, *extra) in surfaces.items():
        entry = {"wall_ms": wall_ms, "input_bytes": _nbytes(inputs),
                 "device_ms": None, "device_ops": None, "host_reads": None,
                 "busy": None, "profile_s": None}
        if (torch.device(device).type == "cuda"
                and name not in UNTRACED_SURFACES):
            traced, traced_ms = profiled.get(name, (run, wall_ms))
            t0 = time.perf_counter()
            dev_ms, ops, reads = device_trace(traced)
            entry.update(device_ms=dev_ms, device_ops=ops, host_reads=reads,
                         busy=dev_ms / traced_ms,
                         profile_s=time.perf_counter() - t0)
            if name in profiled:
                entry.update(profiled="eager", profiled_wall_ms=traced_ms)
        for fn in extra:
            entry.update(fn())
        out[name] = entry
    return out


# ---------------------------------------------------------------- record

PIPELINED_SEMANTICS = (
    "queue_chain over the first four accepted corrections of the last "
    "headline session, repeated 16 times from the initial drifted state (a "
    "fresh table each time, the poses moved by 1e-6 j and by the previous "
    "repetition's checksum times 1e-30), one host read (the checksum) at "
    "the end; ms a cycle is the minimum over three calls of the call's "
    "wall over its 64 cycles")
CPU_BASELINES = (
    "generic = scipy TRF with sparse finite-difference Jacobians "
    "(baselines/cpu_lm.py::scipy_generic_solve, the minimum of three), on "
    "the last accepted cycle's problem; optimized = the f64 numpy/LAPACK "
    "banded-Cholesky LM (cpu_lm_solve) on every accepted cycle's problem. "
    "Both are solve-only, against the port's full cycle (vs_*) and its "
    "solve alone (vs_optimized_cpu_solve_only), timed on the host of the "
    "same run")
VARIANCE_NOTE_8192 = (
    "the minimum of two timed refines after a warm one, both samples "
    "recorded; the port compiles nothing, so the spread is the host's")


def detail(s: dict) -> dict:
    """The record's `detail` from the sections' results `s` (keyed as
    KEY_MAP's values, plus "analysis"), under the reference's names and in
    its order; the sections of SMOKE_LEFT_OUT only where they ran."""
    head, chain, so = s["headline"], s["chain"], s["solve_only"]
    spec, ref, rep = s["speculative"], s["refine"], s["replicas"]
    enml = s["enml"]
    acc = [a for a in head["accepted"] if a is not None]
    runs = [i for i, a in enumerate(head["accepted"]) if a]
    interactive = head["cycle_wall_ms"]["median"]
    device_ms = chain["ms_per_cycle"]
    scipy_ms, cpu_ms = so["scipy_ms"], so["cpu_lm_ms"]
    stream_s = enml["scans"] * SCAN_PERIOD_S
    out = {
        "backend": s["device"].type,
        "cycle_ms": head["cycle_wall_ms_all"],
        "cycle_ms_min": head["cycle_wall_ms"]["min"],
        "cycle_ms_session_medians": head["session_medians_ms"],
        "tunnel_rtt_ms": s["overhead"]["rtt_ms"],
        "dropped_constraint_rows": sum(head["dropped_rows"][i] for i in runs),
        "accepted": acc,
        "stage_ms_last_cycle": head["stage_ms_last_cycle"],
        "lm_iterations": [head["lm_iterations"][i] for i in runs],
        "final_costs": [head["final_cost"][i] for i in runs],
        "num_constraints": head["active_rows"],
        "hbm_peak_mb": s["memory"]["peak_mib"],
        "hbm_peak_kind": "torch.cuda.max_memory_allocated",
        **({} if s.get("analysis") is None
           else {"device_analysis": s["analysis"]}),
        "bag_ingest_mb_s": (s["bag_ingest"]["routes"]["native"] or {}).get(
            "mb_s"),
        "pipelined_cycle_ms": device_ms,
        "pipelined_semantics": PIPELINED_SEMANTICS,
        "pipelined_chain_accepted": chain["accepted"],
        "pipelined_chain_lm_iterations": chain["lm_iterations"],
        "device_cycle_ms": device_ms,
        "interactive_cycle_ms": interactive,
        "interactive_speculative_ms": spec["ms"],
        "speculative_hits": spec["hits"],
        "speculative_attempts": spec["attempts"],
        "speculative_hit_rate": spec["hit_rate"],
        "speculative_miss_ms": spec["miss_ms"],
        "speculative_miss_ms_per_kind": spec["miss_ms_per_kind"],
        "vs_baseline_speculative": scipy_ms / spec["ms"],
        "vs_optimized_cpu_speculative": cpu_ms / spec["ms"],
        "interactive_dispatch_overhead_ms": max(interactive - device_ms, 0.0),
        "vs_baseline_interactive": scipy_ms / interactive,
        "vs_baseline_device": scipy_ms / device_ms,
        "map_error_vs_gt_m": head["gt_aligned"],
        "enml_batch_localize_ms": enml["sequential_ms"],
        "enml_checkerboard_ms": enml["checkerboard_ms"],
        "enml_nodes": enml["nodes"],
        "enml_realtime_factor": stream_s / (enml["sequential_ms"] / 1e3),
        "enml_checkerboard_realtime_factor":
            stream_s / (enml["checkerboard_ms"] / 1e3),
        "enml_w80_checkerboard_ms": enml["w80_checkerboard_ms"],
    }
    if "enml_scale" in s:
        e = s["enml_scale"]
        out.update(enml_scale_keys(e["footprint"], e["scans"],
                                   e["sequential_ms"], e["checkerboard_ms"],
                                   e["w80_ms"]))
    if "scale_8192" in s:
        out.update(_scale_8192_keys(s["scale_8192"]))
    if "scale_16384" in s:
        out.update(_scale_16384_keys(s["scale_16384"]))
    out.update({
        "post_optimize_stf_refine_ms": ref["refine_ms"],
        "post_optimize_stf_matches": ref["matches"],
        "post_optimize_match_dropped": ref["match_dropped"],
        "post_optimize_match_ms": ref["match_ms"],
        "post_optimize_lm_ms": ref["lm_ms"],
        "post_optimize_lm_iters": ref["lm_iterations"],
        "cpu_refine_solve_ms": ref["cpu_ms"],
        "cpu_refine_final_cost": ref["cpu_final_cost"],
        "cpu_refine_iters": ref["cpu_iterations"],
        "vs_optimized_cpu_refine": ref["cpu_ms"] / ref["lm_ms"],
        "solve_8192_poses_20iter_ms": s["joint_solve"]["wall_ms"],
        "replica32_batch_20iter_ms": rep["wall_ms"],
        "replica32_throughput_solves_per_s": rep["solves_per_s"],
        "cpu_generic_solve_ms": scipy_ms,
        "cpu_generic_final_cost": so["scipy_cost"],
        "cpu_optimized_solve_ms_per_cycle": so["cpu_lm_ms_each"],
        "cpu_optimized_solve_ms_median": cpu_ms,
        "cpu_optimized_final_cost_last": so["cpu_lm_final_cost_last"],
        "vs_optimized_cpu_interactive": cpu_ms / interactive,
        "vs_optimized_cpu": cpu_ms / device_ms,
        "device_solve_only_ms_per_cycle": so["ms_per_solve_each"],
        "device_solve_only_ms_median": so["ms_per_solve"],
        "vs_optimized_cpu_solve_only": cpu_ms / so["ms_per_solve"],
        "cpu_baselines": CPU_BASELINES,
    })
    return out


def _accepted_walls(sec: dict) -> list[float]:
    return [w for w, a in zip(sec["cycle_wall_ms"], sec["accepted"]) if a]


def _scale_8192_keys(sec: dict) -> dict:
    walls, r = _accepted_walls(sec), sec["refine"]
    return {
        "hitl8192_accepted_cycles": sec["accepted_cycles"],
        "hitl8192_cycle_ms": walls,
        "hitl8192_cycle_ms_median": _median(walls),
        "hitl8192_constraint_rows": sec["rows"],
        "hitl8192_map_error_vs_gt_m": sec["gt_mean"],
        "post_optimize_8192_pair_ms": r["wall_ms"],
        "post_optimize_8192_pair_ms_samples": r["wall_ms_samples"],
        "post_optimize_8192_variance_note": VARIANCE_NOTE_8192,
        "post_optimize_8192_match_ms": r["match_ms"],
        "post_optimize_8192_lm_ms": r["lm_ms"],
        "post_optimize_8192_matches": r["matches"],
        "post_optimize_8192_rows_dropped": r["match_dropped"],
        "post_optimize_8192_elect_dropped": r["elect_dropped"],
        "post_optimize_8192_iters": r["iterations"],
        "post_optimize_8192_cost": {"before": r["initial_cost"],
                                    "after": r["final_cost"]},
    }


def _scale_16384_keys(sec: dict) -> dict:
    walls, f = _accepted_walls(sec), sec["f64"]
    return {
        "hitl16k_accepted_cycles": sec["accepted_cycles"],
        "hitl16k_cycle_ms": walls,
        "hitl16k_cycle_ms_median": _median(walls),
        "hitl16k_constraint_rows": sec["rows"],
        "hitl16k_map_error_vs_gt_m": sec["gt_mean"],
        "hitl16k_final_cost": f["last_cycle_cost"],
        "hitl16k_cpu_final_cost": f["cost"],
        "hitl16k_cost_parity_rel": f["relative"],
        "hitl16k_cpu_solve_ms": f["ms"],
        "hitl16k_cpu_iters": f["iterations"],
    }


def record(s: dict, smoke: bool, device_facts: dict) -> dict:
    """The printed record: metric, value (the chained cycle's ms), unit,
    vs_baseline (scipy's solve over it), the device's facts, `detail` and
    the port's notes (each section's seconds and peak, the speculative and
    refine checks, the bag's routes)."""
    head, chain = s["headline"], s["chain"]
    d = detail(s)
    return {
        "metric": (f"ms per full HitL repair cycle (EM+explicit+backprop+LM "
                   f"solve), pipelined (queue_chain, one host read a call), "
                   f"figure-8 {head['poses']} poses / {head['points']} "
                   f"points, mixed corrections"),
        "value": chain["ms_per_cycle"], "unit": "ms",
        "vs_baseline": s["solve_only"]["scipy_ms"] / chain["ms_per_cycle"],
        "device": device_facts,
        "detail": d,
        "notes": notes(s, smoke),
    }


def notes(s: dict, smoke: bool) -> dict:
    spec, ref, bag = s["speculative"], s["refine"], s["bag_ingest"]
    return {
        "smoke": smoke,
        "left_out": [k for k in SMOKE_LEFT_OUT if k not in s]
        + (["enml_w80_checkerboard_ms"] if smoke else []),
        "not_ported": NOT_PORTED,
        "tunnel_rtt_ms": "the card's own round trip (x + 1.0 on a 0-d "
                         "tensor, then a synchronise): no tunnel or relay "
                         "lies between host and card",
        "enml_scale_sequential_ms": "one timed sweep after a warm call: on "
                                    "a card a replay of the sweep program "
                                    "the warm call captured",
        "sweep_capture_ms": {k: s[k].get("sweep_capture_ms")
                             for k in ("enml", "enml_scale") if k in s},
        "sections": s["memory"]["sections"],
        "speculative": {k: spec[k] for k in (
            "pause_s", "hit", "accepted", "lm_iterations",
            "bit_equal_to_replay", "ms_accepted", "miss_accepted",
            "miss_equal_to_replay")},
        "refine": {k: ref[k] for k in (
            "lm_final_cost", "cpu_final_cost", "f64_relative", "iterations",
            "lm_warm_iterations", "final_cost")},
        "replicas": {k: v for k, v in s["replicas"].items()
                     if k not in ("wall_ms", "solves_per_s")},
        "bag_ingest": bag,
    }


def reference_sections(device, smoke: bool = False) -> dict:
    """Every section of the record on `device`, in the reference's order
    (the headline, its chain, solve-only and the joint solve; the round
    trip, speculation, replicas, the refine; the scale sessions; EnML; the
    bag), each run with the device's peak memory reset before it; then the
    device analysis. Returns the sections' results keyed as KEY_MAP's
    values, "analysis", and "memory" (the peak and each section's seconds
    and peak)."""
    from .bench import replica_split

    device = torch.device(device)
    sections = {}
    s = {"device": device}

    def run(name, fn):
        S._reset_peak(device)
        t0 = time.perf_counter()
        s[name] = fn()
        sections[name] = {"seconds": time.perf_counter() - t0,
                          "peak_mib": S._peak_mib(device)}
        return s[name]

    run("headline_run", lambda: S.headline_run(device, smoke=smoke))
    s.update(s.pop("headline_run"))
    head = s["headline"]
    state = head["_session"]["engine"].state
    run("overhead", lambda: overhead_section(device))
    run("speculative", lambda: speculative_section(
        device, head["_map"], head["capacity"]))
    run("replicas", lambda: replica_split(
        S.synchronizer(device), state, REPLICAS_SMOKE if smoke else REPLICAS))
    run("refine", lambda: headline_refine_section(device, state))
    if not smoke:
        run("scale_8192", lambda: S.scale_session_section(device, 8192))
        run("scale_16384", lambda: S.scale_session_section(device, 16384))
    run("enml", lambda: enml_section(device, smoke=smoke))
    if not smoke:
        run("enml_scale", lambda: enml_scale_section(device))
    run("bag_ingest", lambda: bag_ingest_section(
        require_native=device.type == "cuda"))

    chain, big, ref = s["chain"], s["joint_solve"], s["refine"]
    # the joint solve replays a program with a WHILE node: the profiler
    # traces its eager run
    profiled = {"solve_8192": (big["_eager_run"], big["eager_wall_ms"])}
    surfaces = {
        "cycle_chain": (chain["_run"], chain["ms_per_cycle"] * chain["cycles"]
                        * chain["j_rep"], chain["_inputs"],
                        lambda: {"cycle_programs": chain["_programs"]()}),
        "solve_8192": (big["_run"], big["wall_ms"], big["_inputs"]),
        "refine_1024": (ref["_run"], ref["refine_ms"], ref["_inputs"]),
        "enml_batch": (s["enml"]["_run"], s["enml"]["sequential_ms"],
                       s["enml"]["_inputs"]),
    }
    if not smoke:
        e = s["enml_scale"]
        surfaces.update({k: (fn, ms, e["_inputs"])
                         for k, (fn, ms, *_) in e["_runs"].items()})
        profiled.update({k: tuple(r[2:]) for k, r in e["_runs"].items()})
        r8 = s["scale_8192"]["refine"]
        surfaces["refine_8192_pair"] = (r8["_run"], r8["wall_ms"],
                                        r8["_inputs"])
    run("analysis", lambda: device_analysis(device, surfaces, profiled))
    peaks = [v["peak_mib"] for v in sections.values()]
    s["memory"] = {"peak_mib": None if None in peaks else max(peaks),
                   "sections": sections}
    return s


def main(args, device, keep: dict | None = None) -> int:
    """The run of `bench --reference`: the record as the last line of
    stdout, and written whole to args.out. With `keep`, the sections'
    results (arrays included) are left in it."""
    from .bench import device_facts

    s = reference_sections(device, smoke=args.smoke)
    if keep is not None:
        keep.update(s)
    rec = record(S.public(s), args.smoke, device_facts(torch, device))
    line = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(f"[reference] {len(rec['detail'])} detail keys, value "
          f"{rec['value']:.3f} ms; written to {args.out}", file=sys.stderr)
    print(line)
    return 0
