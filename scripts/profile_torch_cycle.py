#!/usr/bin/env python3
"""Where the time of one correction cycle, of the post-human refine, of the
auto-proposal stage and of an LTVM curation goes, for the PyTorch port on a
GPU.

    python scripts/profile_torch_cycle.py [--repeat 3] [--trace trace.json]

Replays the 1024-pose golden session (tests/data/golden_large.*) with the
port's engine on cuda: once to warm up, then `--repeat` times with host
timing (wall ms per cycle after torch.cuda.synchronize()), once with each
cycle stage timed on its own, then once under torch.profiler. Then the same
for post_optimize on the repaired map: wall ms (a replay of the refine's
device program), the refine's stages (grid_match, build_stf_factors, the
pair sort and compaction, the one-hot selectors, assemble_dense, the
Cholesky factorization and its triangular solves, the cost-only factor
pass) timed on their own for the fused and the two-pass dense solver run
eagerly (no Python timer sees a replay's stages), and a torch.profiler
window over an eager refine. Prints the card's name
and power limit, the wall times, host ms per stage, device time by kernel
name (top 20), the number of device operations, and the device's busy share
of each profiled window.

Then propose_corrections on the drifted 1024-pose figure-8 map of
chip_smoke.py (wall ms, its stages and a profiler window at the 4 candidates
the auto-repair loop sees and at the full batch of 8, and the correlation as
the port's gathered sum beside the reference's dense conv2d), one LTVM curation of
the clean figure-8 map (the same), and, with --refine-poses N, post_optimize
on a drifted N-pose figure-8 map (above 2048 poses the matrix-free PCG
solver). Then the EnML sweep on chip_smoke.py's reference-scale map (1078
nodes): wall ms a node over 64 full windows, the node's stages (the window
match, the Cholesky factor and solve, the covariance inverse, the rest: the
window systems' assembly) timed on their own, and a profiler window over 8
nodes; then the checkerboard localizer on the same map at W = 10 and W =
80 (wall, its stage split: set-up, matches, batched GN steps, carry and
scatter, covariance pass; a profiler window); `--enml-only` runs this part
alone. `--loops-eager` runs only the curation, the proposals and the
scale map's checkerboard, with their SDF, RANSAC and checkerboard eager
(`eager=True`): the baseline of their device programs, profiled by kernel.
The profiler windows always run those three eagerly (it does not trace a
WHILE node's trips). Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
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
    """Host ms per cycle stage over the logged cycles run eagerly one after
    another (queue_chain_eager: the engine replays a CUDA graph, whose
    stages no Python timer sees)."""
    import numpy as np

    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.models.hitl import cycle as C

    st = make_map_state(data.poses, data.covariances, data.point_clouds,
                        data.normal_clouds, constraint_capacity=16384,
                        device="cuda")
    sels = torch.as_tensor(np.stack([np.asarray(e.points, np.float32)
                                     for e in entries]), device="cuda")
    ctypes = [int(e.correction_type) for e in entries]

    def run():
        C.queue_chain_eager(st.points, st.point_mask, st.poses,
                            st.covariances, st.constraints, ctypes, sels, 0)
        torch.cuda.synchronize()

    names = ("em_scan", "order_on_device", "apply_explicit",
             "constraint_deltas", "_scatter_constraints", "backprop",
             "build_problem", "lm_solve")
    targets = [(C, name) for name in names]
    targets.append((C.em_input, "endpoint_adjust_batch"))
    run()
    with StageTimer(torch, targets) as timer:
        t0 = time.perf_counter()
        run()
        total = (time.perf_counter() - t0) * 1e3
    timer.report(f"stage split over {len(entries)} eager cycles", total,
                 "(rest of cycle)")


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

    def refine(solver="auto", eager=False):
        st = repaired
        return R.post_human_refine(st.points, st.normals, st.point_mask,
                                   st.poses, st.constraints,
                                   config=LMConfig(max_iterations=30),
                                   solver=solver, eager=eager)

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
               (S, "_mnt_updates"),
               (torch.linalg, "cholesky_ex"),
               (torch.linalg, "solve_triangular")]
    for solver in ("dense_fused", "dense"):
        with StageTimer(torch, targets) as timer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = refine(solver, eager=True)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        timer.report(f"refine stage split, solver {solver}, "
                     f"{int(out.iterations)} LM iterations, "
                     f"{int(out.num_matches)} matches", total,
                     "(rest of the refine)")
    # eager: CUPTI does not trace a WHILE node's trips reliably
    device_profile(torch, lambda: refine(eager=True),
                   "profiled refine (dense_fused, eager)")


def event_ms(torch, fn, iters=10):
    """Mean ms per call by CUDA events, after two warm calls."""
    fn(), fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# min_gap at which chip_smoke.py's drifted map yields all 8 candidates that
# max_proposals=4 admits (the default, a quarter of the poses, yields 4)
FULL_BATCH_MIN_GAP = 96


def dense_correlation(torch, field, ki, kj, ok, W):
    """The reference's formulation of the matcher's scores, to hold the
    port's gathered sum against: each field [B, H, H] against its T
    rasterized 0/1 kernels [K, K] by one dense VALID cross-correlation."""
    import torch.nn.functional as F

    B, T, _ = ki.shape
    K = field.shape[1] - W + 1
    bt = torch.arange(B * T, device=field.device).view(B, T, 1)
    flat = (bt * K + kj.long()) * K + ki.long()
    flat = torch.where(ok, flat, B * T * K * K)
    kern = torch.zeros((B * T * K * K + 1,), dtype=field.dtype,
                       device=field.device)
    kern[flat.reshape(-1)] = 1.0
    kern = kern[:-1].view(B * T, 1, K, K)
    return F.conv2d(field[None], kern, groups=B)[0].view(B, T, W, W)


def proposal_profile(torch, repeat, programs=True):
    """propose_corrections on the drifted 1024-pose map at the default
    matcher parameters: as the auto-repair loop calls it (the default
    min_gap, B = 4 candidates on this map) and at the full batch
    max_proposals=4 admits (B = 8, min_gap=FULL_BATCH_MIN_GAP). Its RANSAC
    replays its programs but where `programs` is false; the stage split
    and the profiler window run it eagerly (the profiler does not trace a
    WHILE node's trips)."""
    from chip_smoke import DRIFTED_MAP, eager_loops
    from hitl_slam_torch.io.figure8 import generate_figure8
    from hitl_slam_torch.models.hitl import propose as P
    from hitl_slam_torch.models.hitl.engine import HitLSLAM
    from hitl_slam_torch.ops import scan_match as M

    m = generate_figure8(**DRIFTED_MAP)
    eng = HitLSLAM(device="cuda")
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             odometry=m.odometry, constraint_capacity=16384)
    poses = eng.state.poses.cpu().numpy()
    targets = [(P, "candidate_pairs"), (P, "candidate_inputs"),
               (P, "build_likelihood_field"), (P, "correlative_match"),
               (P, "extract_segments"), (P, "gate_and_pair")]

    for min_gap in (None, FULL_BATCH_MIN_GAP):
        B = len(P.candidate_pairs(poses, 4, min_gap=min_gap))
        if min_gap is not None and B != 8:
            raise RuntimeError(f"min_gap={min_gap} gave {B} candidates, not 8")
        label = f"propose_corrections, min_gap={min_gap}, B={B}"

        def propose():
            return eng.propose_corrections(max_proposals=4, seed=0,
                                           min_gap=min_gap)

        for eager in ((False, True) if programs else (True,)):
            with eager_loops() if eager else contextlib.nullcontext():
                for r in range(repeat + 1):
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    props = propose()
                    torch.cuda.synchronize()
                    print(f"{label}, {'eager' if eager else 'programs'}, "
                          f"run {r}{' (warm-up)' if r == 0 else ''}: wall "
                          f"{(time.perf_counter() - t0) * 1e3:.3f} ms, "
                          f"{len(props)} proposals, peak memory "
                          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f}"
                          f" MiB")
        with eager_loops(), StageTimer(torch, targets) as timer:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            propose()
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        timer.report(f"{label}: stage split (eager)", total,
                     "(host reads, the rest)")
        with eager_loops():
            device_profile(torch, propose, f"profiled {label} (eager)")

    # the correlation alone at B = 8: the port's gathered sum against the
    # reference's dense conv2d
    st = eng.state
    chosen = P.candidate_pairs(poses, max_proposals=4,
                               min_gap=FULL_BATCH_MIN_GAP)
    a_pts, a_mask, centers, scans, smask, guess = P.candidate_inputs(
        st, st.world_points(), poses, chosen)
    field = M.build_likelihood_field(a_pts, a_mask, centers)
    B, H, _ = field.shape
    T, W, N = 29, 41, scans.shape[1]
    K = H - W + 1
    g = torch.Generator().manual_seed(0)
    ki = torch.randint(0, K, (B, T, N), generator=g, dtype=torch.int32).cuda()
    kj = torch.randint(0, K, (B, T, N), generator=g, dtype=torch.int32).cuda()
    ok = smask[:, None, :].expand(B, T, N).contiguous()
    ms = event_ms(torch, lambda: M.correlate_gather(field, ki, kj, ok, W))
    print(f"correlation, B={B} T={T} W={W} K={K} N={N}: gathered sum "
          f"{ms:.3f} ms ({B * T * W * W * int(smask.sum(1).max())} additions "
          f"at most)")
    a = M.correlate_gather(field, ki, kj, ok, W)
    b = dense_correlation(torch, field, ki, kj, ok, W)
    ms = event_ms(torch, lambda: dense_correlation(torch, field, ki, kj, ok, W),
                  iters=3)
    print(f"correlation, same shapes: dense conv2d {ms:.3f} ms "
          f"({2 * B * T * W * W * K * K / 1e12:.3f} TFLOP), max difference "
          f"from the gathered sum {float((a - b).abs().max()):.3e}")


def ltvm_profile(torch, repeat, programs=True):
    """One LTVM curation of the clean 1024-pose figure-8 map at the default
    parameters (SDF at 0.04 m, RANSAC 32 x 256 on 131,072 points): walls
    with the SDF and the RANSAC replaying their programs (but where
    `programs` is false) and eager, the stage split (synchronised at each
    stage, with replays and eager), a profiler window over an eager
    curation, and the eager SDF and RANSAC each by kernel, with the SDF's
    device operations a pose."""
    from chip_smoke import CLEAN_MAP, eager_loops
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.io.figure8 import generate_figure8
    from hitl_slam_torch.models.ltvm import curator as L
    from hitl_slam_torch.ops import ransac, sdf as S
    from hitl_slam_torch.ops.geometry import pose_to_world

    m = generate_figure8(**CLEAN_MAP)
    st = make_map_state(m.gt_poses, m.covariances, m.point_clouds,
                        m.normal_clouds, device="cuda")

    def curate():
        return L.LongTermVectorMap(seed=0).curate(
            st.poses, st.points, st.point_mask)

    targets = [(L, "sdf_bounds"), (L, "build_sdf"), (L, "filter_points"),
               (L, "extract_segments")]
    for eager in ((False, True) if programs else (True,)):
        how = "eager" if eager else "programs"
        with eager_loops() if eager else contextlib.nullcontext():
            for r in range(repeat + 1):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                vectors = curate()
                torch.cuda.synchronize()
                print(f"curate, {how}, {r}{' (warm-up)' if r == 0 else ''}: "
                      f"wall {(time.perf_counter() - t0) * 1e3:.3f} ms, "
                      f"{len(vectors)} vectors, peak memory "
                      f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} "
                      f"MiB")
            with StageTimer(torch, targets) as timer:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                curate()
                torch.cuda.synchronize()
                total = (time.perf_counter() - t0) * 1e3
            timer.report(f"curate stage split ({how})", total,
                         "(host merge, the rest)")
    with eager_loops():
        device_profile(torch, curate, "profiled curate (eager)")
    cur = L.LongTermVectorMap(seed=0)
    with eager_loops():
        cur.curate(st.poses, st.points, st.point_mask)
    img = cur.last_sdf
    H, W = img.values.shape
    P = st.poses.shape[0]
    params = S.SdfParams()
    device_profile(torch, lambda: S.build_sdf(
        st.poses, st.points, st.point_mask, img.origin, H, W, params,
        eager=True), f"profiled build_sdf (eager; {P} poses, {H} x {W} "
        f"pixels: device operations / {P} = a pose's)")
    world = pose_to_world(st.poses[:, None, :], st.points)
    keep = S.filter_points(img, world, st.point_mask, params)
    rp = ransac.RansacParams()
    u = ransac.uniform_draws(0, rp, "cuda")
    device_profile(torch, lambda: ransac.extract_segments(
        world.reshape(-1, 2), keep.reshape(-1), u, rp, eager=True),
        f"profiled extract_segments (eager; {rp.num_segments} rounds)")


def large_refine(torch, num_poses):
    """post_optimize on a drifted two-lap figure-8 map of `num_poses` poses
    (the matrix-free PCG solver above 2048 poses)."""
    from hitl_slam_torch.io.figure8 import generate_figure8
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    m = generate_figure8(num_poses=num_poses, num_rays=120, seed=11,
                         drift_theta_bias=1.5e-4 * 1024 / num_poses,
                         num_laps=2)
    eng = HitLSLAM(device="cuda")
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             odometry=m.odometry, constraint_capacity=16384)
    start = eng.state
    for r in range(2):
        eng.init_from_state(start)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rep = eng.post_optimize()
        torch.cuda.synchronize()
        print(f"post_optimize on {num_poses} figure-8 poses, run {r}: wall "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms, LM iterations "
              f"{rep.lm_iterations}, cost {rep.initial_cost:.6g} -> "
              f"{rep.final_cost:.6g}, {rep.reason}, dropped rows "
              f"{rep.dropped_rows}, finite "
              f"{bool(torch.isfinite(eng.state.poses).all())}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")


def enml_profile(torch, repeat):
    """The EnML sweep on the reference-scale map: nodes 64..127 (full
    windows) by sweep_segment."""
    from chip_smoke import ENML_SCALE_STREAM, _episode_state
    from hitl_slam_torch.io.figure8 import generate_raw_stream
    from hitl_slam_torch.models.enml import localizer as L

    st = _episode_state(generate_raw_stream(**ENML_SCALE_STREAM), "cuda")[0]
    o = L.EnmlOptions()
    pre = L.sweep_precompute(st.poses, o)
    cov0 = torch.zeros((st.num_poses, 3, 3), device="cuda")
    P, N = st.points.shape[:2]

    def sweep(t0, nodes):
        return L.sweep_segment(st.points, st.normals, st.point_mask,
                               st.poses, cov0, pre, t0, o, nodes)

    sweep(0, 8)
    for r in range(repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep(64, 64)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"enml sweep {r}: {P} nodes x {N} padded points, nodes 64..127 "
              f"in {ms:.1f} ms ({ms / 64:.2f} ms a node)")
    targets = [(L, "_brute_window_match"), (L, "_pair_mask"),
               (torch.linalg, "cholesky_ex"), (torch, "cholesky_solve"),
               (torch.linalg, "inv_ex")]
    with StageTimer(torch, targets) as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep(64, 16)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    timer.report("enml stage split over 16 nodes", total,
                 "(window systems, set-up)")
    device_profile(torch, lambda: sweep(64, 8), "profiled enml, 8 nodes")
    checkerboard_profile(torch, st, repeat)


def checkerboard_profile(torch, st, repeat, programs=True):
    """The checkerboard localizer on the reference-scale map at chip_smoke's
    two configurations: walls (a replay of its program, but where
    `programs` is false, and eager), the stage split (window set-up,
    matches, the batched GN steps, the SE(2) carry and scatter, the
    covariance pass with its own matches; synchronised at every boundary,
    so eager) and a profiler window over an eager run."""
    from chip_smoke import CB_SCALE
    from hitl_slam_torch.models.enml import localizer as L
    from hitl_slam_torch.models.enml import parallel_localizer as CB

    args = (st.points, st.normals, st.point_mask, st.poses)
    P, N = st.points.shape[:2]
    for name, okw, chunk in CB_SCALE:
        o = L.EnmlOptions(**okw)

        def run(stage_ms=None, eager=False):
            return CB.checkerboard_localize(*args, o, chunk=chunk,
                                            stage_ms=stage_ms, eager=eager)

        for eager in ((False, True) if programs else (True,)):
            run(eager=eager)
            for r in range(repeat):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(eager=eager)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                print(f"checkerboard {name} "
                      f"{'eager' if eager else 'program'} {r}: {P} nodes x "
                      f"{N} padded points, {chunk} windows a batch, "
                      f"{ms:.1f} ms ({ms / P:.3f} ms a node)")
        stages = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(stages)
        total = (time.perf_counter() - t0) * 1e3
        print(f"checkerboard {name} stage split (synchronised), "
              f"{total:.1f} ms:")
        for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
            print(f"  {k:14s} {v:10.2f} ms  {100 * v / total:5.1f} %")
        device_profile(torch, lambda: run(eager=True),
                       f"profiled checkerboard {name} (eager)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="also write a chrome trace of the profiled replay")
    ap.add_argument("--refine-poses", type=int, default=0, metavar="N",
                    help="also run post_optimize on a drifted N-pose "
                         "figure-8 map")
    ap.add_argument("--enml-only", action="store_true",
                    help="profile only the EnML sweep")
    ap.add_argument("--loops-eager", action="store_true",
                    help="profile only the curation, the proposals and the "
                         "scale map's checkerboard, all eagerly (no "
                         "program replayed)")
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
    if args.enml_only:
        enml_profile(torch, args.repeat)
        return 0
    if args.loops_eager:
        from chip_smoke import ENML_SCALE_STREAM, _episode_state
        from hitl_slam_torch.io.figure8 import generate_raw_stream

        ltvm_profile(torch, args.repeat, programs=False)
        proposal_profile(torch, args.repeat, programs=False)
        st = _episode_state(generate_raw_stream(**ENML_SCALE_STREAM),
                            "cuda")[0]
        checkerboard_profile(torch, st, args.repeat, programs=False)
        return 0
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
    proposal_profile(torch, args.repeat)
    ltvm_profile(torch, args.repeat)
    if args.refine_poses:
        large_refine(torch, args.refine_poses)
    enml_profile(torch, args.repeat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
