#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hitl_slam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):
  1. device facts, then build the CUDA sources of hitl_slam_torch/csrc/
     (the kernels and the graph loops' helper; ptxas registers, shared
     memory and spills are printed);
  2. em_scan kernel vs its plain torch version on the 1024-pose golden map:
     exact counts and bit-equal minima, over threshold and edge cases, an
     odd N, and two calls back to back (the in-kernel reset of the minima);
  3. block-cyclic-reduction kernel vs its plain torch version and an f64
     direct solve, n = 1 .. 65536, each route (one block, clusters of 2 to
     16 blocks, top levels in device memory ahead of a cluster of 16);
  3b. the LM trip kernel (csrc/lm_step.cu) against its plain version on
     the card, P = 8 .. 16385 (each route and one pose past its end): the
     first assembly and one trip from the same carry and step, the same
     accept flag, count, done and go and the rest to f32 round-off; at
     1024 and 8192 poses its device ms by torch.profiler beside its bound
     (bytes / 3.35 TB/s), its event ms and the plain version's ms;
  3c. the EM refit kernel (csrc/em_refit.cu) against its plain version on
     the benchmark's two maps (cardbench/: 1024 and 8192 poses, held as
     the engine holds them, 256 slots a pose) at their cells' strokes: one round from the same carry, the same inlier
     count of each stroke and endpoints within 1e-5 m; its device ms by
     torch.profiler beside its bound (bytes / 3.35 TB/s), its event ms,
     the plain round's ms, each stroke's inliers and where the kernel
     fitted them from (tests/test_torch_em_refit.py holds the same on
     edge cases, replays and the cycle's graph);
  4. the main path, HitLSLAM on cuda: replay_log of the small golden
     session (both tolerances of tests/test_golden.py), replay_log and
     run_queue of the 1024-pose golden session; each run's kernel launch
     counts are zeroed just before it and checked just after
     (em_scan = 2 x cycles, bcr = LM iterations, lm_step = LM iterations
     + cycles, em_refit = refit rounds, the em_refit -> em_refit hits of
     the stage clocks), and the run_queue's repaired map is phase 15's;
  5. the post-human STF refine on the repaired 1024-pose map (each refine
     and each half a replay of its device program, phase 21):
     post_optimize(matcher="auto") (accepted, cost not increased, finite,
     pose 0 unmoved, matches found, a second run bit-equal, undo() back to
     the pre-refine poses with the input history untouched), the same
     refine by the matrix-free PCG solver (same matches, poses within 2e-3
     of the dense result) and by the pair matcher; wall ms of each (match
     and solve apart), LM and CG iterations, drop counters, peak memory;
  6. one speculative correction: two clicks with the first logged
     selection, then run(): one speculative hit, poses bit-equal to
     replay_log of the same entry, launch counts as for one cycle;
  7. auto-proposed corrections and headless auto-repair on a drifted
     two-lap 1024-pose figure-8 map made by the port's own generator:
     propose_corrections (repeatable, and the card's first round equal to
     the CPU's), then the CLI's auto-repair loop for 3 rounds (at least one
     correction applied, the aligned error against ground truth below 0.8
     of its start, em_scan launched twice a cycle and BCR once an LM
     iteration); no proposal on the clean map; wall and device ms of every
     stage (RANSAC replays its programs, phase 22; the device ms are an
     eager run's);
  8. render_map and info_matrix_image on the repaired map (shapes,
     non-empty, bit-equal repeat, the card's image against the CPU's);
  9. the LTVM curator on the repaired 1024-pose golden map and on the clean
     figure-8 map (the figure-8's walls, the prune floors, bit-equal repeat
     from the seed, the SDF against the CPU's); wall and device ms of the
     SDF, the filter and the RANSAC (the SDF and the RANSAC replay their
     programs, phase 22; the device ms are eager runs');
 10. EnML batch localization (launches neither kernel; the counts are
     zeroed before it and must stay 0): the sweep on the card (a replay of
     its program, models/enml/program.py) against the CPU on the test-size
     stream (pose and covariance differences, match counts of every 16th
     window); the sweep over the reference's scale map (1078 nodes, 256
     padded points a node) by its program with its wall, ms a node,
     realtime factor and graph operations a node from a 32-node segment
     (a segment program's replay; its busy share not measured), peak
     memory,
     consistency and the error against ground truth; then a bag through
     `cli_enml` on the card into HitLSLAM;
 11. the checkerboard localizer (launches neither kernel; each call a
     replay of its program, phase 22): card against CPU on the test-size
     stream (both matcher routes, the probe's counts), then the scale map
     at W = 10 (16 windows a batch) and at W = 80 (the grid matcher, 8 a
     batch) with the replay's wall, ms a node and realtime factor, the
     eager wall with its launches a node and busy share from a device-only
     profile, peak memory, consistency, aligned error and the probe's
     dropped count;
 12. an interactive EnML session on a drifted two-lap 256-pose figure-8:
     segments of 32, one loop correction queued mid-sweep and one after
     (em_scan = 2 x cycles, bcr = LM iterations), then a fresh session
     replays its log: poses and covariances bit-equal to the session's;
 13. `cli_enml --online` on the bag of phase 10 at the recorded rate:
     nodes localized live and the lag at the final flush;
 14. one round trip through the GUI bridge (`cli --gui` on a free port:
     a correction drawn and run, saved, shut down): the saved poses and the
     launches equal replay_log's; skipped, and said so, without
     `websockets`; then one `{"enml": {...}}` line for phases 10-14;
 15. the replica batch (BASELINE config #5 at the bench's size): 32
     perturbed replicas of the repaired 1024-pose golden_large map by
     make_perturbed_replicas (seed 0), solved by batched_solve with 20 LM
     iterations on the card (the LM a replay of its program, its busy
     share not measured): costs finite and not up,
     the batched BCR
     route launched once a step (and nothing else), 4 replicas chosen by a
     seed equal to their lone solves (iterations, accept sequence, poses
     within 1e-5), the batched wall at or below 32 lone solves' one after
     another; then the batched kernel against lone launches (bit-equal) and
     its twin (BCR_RTOL) on the first step's systems and at n = 64, 1024,
     16384 (B = 32) and 32768 (B = 8, the levels route), with its times,
     bound and the dense batched torch.linalg.solve; repair_step on the
     small golden map's first correction against the CPU; the native
     libraries built, and their parses equal the Python paths (both golden
     maps, phase 10's bag); then one `{"replicas": {...}}` line;
 16. the mesh: (a) the pose-sharded LM (20 LM iterations, run eagerly
     here: phase 23 replays its program) on the repaired
     1024-pose map of phase 4 on meshes [cuda:0] x 4 and x 8: cost and
     poses within the reference's criteria of the lone lm.solve, poses
     within 1e-4 of the same sharded solve on the CPU (an iteration count
     that differs there, at the cost's f32 floor, is reported with both
     runs' trial costs), the multi BCR route launched once an iteration
     and nothing else, the batched route not at all (counts zeroed just
     before, read just after), the mesh's collective counter within the
     reference's volume bounds, and the first iteration's multi call (d
     systems, each against 7 right-hand sides) with each column against
     lone launches (bit-equal) and the twin, with its times, the bound,
     the dense library solve of the same function, and the old call of
     PR 9 (D and U copied 7 times, the batched route on 7d systems);
     then the same on replica 0 of phase 15, whose LM ends on real
     decreases, with the card's iteration count equal to the CPU's;
     (b) the same at 16384 poses (a seeded
     chain, d = 8) with both costs against the f64 cpu_lm_solve; (c)
     phase 15's replicas placed on a [cuda:0] x 4 replica mesh, bit-equal
     to phase 15's batch; (d) the checkerboard's mesh branch on
     [cuda:0] x 4: the test-size stream within 1e-4 of mesh=None, the
     scale map at W = 10 with wall, ms a node and peak memory; (e) the
     sharded LM one partition a card where the machine has several cards
     (said when it does not run); then the multi route against lone
     launches and its twin on S systems x 7 right-hand sides at n = 64,
     1024, 16384 and 32768 (the last two the levels route), timed but at
     32768; then one `{"mesh": {...}}` line;
 17. the reference's own HitL bench sessions at its sizes
     (hitl_slam_torch/bench_sessions.py), each section's launches counted
     (em_scan = 2 x cycles, bcr = LM iterations of every solve, counts
     zeroed just before and read just after) and held against the JAX
     package's record of the same sessions (tests/data/
     scale_sessions_jax.json and .npz, made by scripts/
     make_scale_fixture.py): the 1024-pose, 180-ray headline session (one
     warm-up, one timed: accepted flags and constraint rows equal to
     JAX's, poses within the loose golden of JAX's), its pipelined chain
     (queue_chain, 16 repetitions from the initial state: every cycle
     accepted, the first repetition within the loose golden of the
     sequential session), the 8192-pose joint solve alone, the 8192-pose
     session (3 cycles accepted, rows equal, the ground-truth error falls
     and ends within 0.05 m of JAX's) with the refine at scale (a replay
     of its program, phase 21; PCG, cost
     falls, finite; the same refine from JAX's poses and rows within 1e-2
     of JAX's final cost), the 16384-pose session (the same gates, and its
     last cycle's cost within 5e-3 of the f64 cpu_lm_solve's) with the
     device's busy share of its last cycle; then em_scan against its plain
     version at [1024, 256], [8192, 128] and [16384, 128] and BCR at
     n = 8192 on the session's LM system, with times, bytes and bounds;
     `[scale]` lines and one `{"scale": {...}}` line;
 18. the rest of the reference's bench record
     (hitl_slam_torch/bench_reference.py) at its full sizes, on phase 17's
     headline session and with phase 17's other sessions and phases
     10-11's scale-map walls (none run again): solve-only with the f64
     baselines, the round trip, five speculative cycles (every one a hit,
     each bit-equal to a non-speculative replay on the card) and the two
     forced misses (reselect, drift: no hit, each equal to its replay),
     32 replicas of the headline's final state on the batched route, the
     refine of that state (replays of its programs; its final cost within
     1e-2 of the f64
     cpu_refine_solve on the same factors), EnML on the reference's
     160-scan stream, the bag's ingest (the native scanner built, both
     routes exact); each section's launches counted (em_scan = 2 x
     cycles, bcr = LM iterations); the assembled record holds every key
     of bench_reference.KEY_MAP; `[reference]` lines and one
     `{"reference": {...}}` line;
 19. the cycle as a device program (models/hitl/cycle.py::CycleProgram:
     a CUDA graph a correction type whose EM refit and LM solve are WHILE
     nodes; phases 4-18 already ran every cycle through it): on
     golden_large's and the headline's corrections, a replay against
     eager cycle_step from the same state (verified, order_valid, new
     rows, LM iterations and em_scan's inlier counts equal; floats
     bit-equal wherever two eager runs are, else within phase 16's card-
     against-CPU bounds; which standard held is printed); run_queue
     through the program against replay_log (the same per-cycle flags),
     with its host reads under torch.profiler (one a chain) and both
     kernels' launches from its replays (em_scan = 2 x cycles, BCR = LM
     iterations); queue_chain under torch.cuda.set_sync_debug_mode
     ("error"); eager against program at 1024, 8192 and 16384 poses (a
     correction's wall, the chained cycle, host reads and device
     operations a cycle, busy share, capture ms, graph nodes, pool MiB);
     `[program]` lines and one `{"program": {...}}` line;
 20. EnML and the replica batch's LM as device programs (a sweep one
     WHILE node over the nodes, a segment one over its trips, the online
     window a straight graph, the batched LM one WHILE node over its
     steps; phases 10-13, 15 and 18 already ran them): replays against
     the eager functions (`eager=True`) on the test-size stream's sweep,
     the first 64 nodes of the scale map, the session's 32-node segments
     over 80 nodes (the last past the end), the online [W, 384] window and
     phase 15's 32 replicas (batched_solve, and solve_batched with its
     accept flags): bit-equal wherever two eager runs are, else within
     phase 16's card-against-CPU pose bound and phase 10's covariance
     bound (the standard that held is printed); one host read a sweep, a
     segment, a window and a batched solve under torch.profiler; each
     under torch.cuda.set_sync_debug_mode("error"); no kernel launched by
     the EnML replays, the batched BCR route once a step by the replica
     replays and nothing else; eager and program walls, ms a node and
     realtime factor, graph operations, capture ms, graph nodes and pool
     MiB (the busy share not measured); `[program]` lines and one
     `{"enml_program":
     {...}}` line;
 21. the post-human refine as a device program (models/hitl/refine.py:
     one CUDA graph of the match and the LM whose CG loop is a WHILE node
     inside the LM's WHILE node, and each half a program of its own;
     phases 5, 17 and 18 already ran them): on phase 5's repaired
     1024-pose map (auto, which picks dense_fused, then dense, pcg and the
     pair matcher) and phase 17's 8192-pose session state (pcg, the pair
     matcher, the record's capacities), a replay against eager
     post_human_refine (`eager=True`) from the same state (LM and CG
     iterations, matches and every drop counter equal; poses and costs
     bit-equal wherever two eager runs are, else within phase 5's pose
     bound and phase 17's cost bound; the standard that held is printed);
     one host read a refine and one a post_optimize (auto and pair); each
     under torch.cuda.set_sync_debug_mode("error"); no kernel launched;
     eager and program walls and halves, graph nodes by WHILE level,
     capture ms, pool MiB and peak memory; `[program]` lines and one
     `{"refine_program": {...}}` line;
 22. the checkerboard localizer, build_sdf and RANSAC's extract_segments
     as device programs (models/enml/program.py::CheckerboardProgram: one
     CUDA graph of 2 n_passes + 2 WHILE nodes over chunk indices, with the
     grid matcher a WHILE node over a chunk's windows inside each trip;
     ops/sdf.py::sdf_program, one WHILE node over the poses; ops/
     ransac.py::ransac_program, one over the rounds; phases 7, 9 and 11
     already ran them): a replay against `eager=True` from the same inputs
     for the checkerboard on the test-size stream (both routes) and the
     scale map at W = 10 and W = 80, the SDF and curate's RANSAC on the
     repaired 1024-pose golden map and the clean figure-8, and each side's
     RANSAC of phase 7's proposals at B = 4 and 8: bit-equal wherever two
     eager runs are, else within phase 11's, phase 9's or phase 7's
     card-against-CPU bounds (the standard that held is printed); one host
     read a call; each under torch.cuda.set_sync_debug_mode("error"); no
     kernel launched; eager and program walls, graph nodes by WHILE level,
     capture ms, pool MiB; curate and propose_corrections eager against
     programs with their SDF and RANSAC splits; the memory reserved after
     the phase; `[program]` lines and one `{"loop_programs": {...}}` line;
 23. the lone LM, repair_step and the pose-sharded (SPIKE) LM as device
     programs (solver/lm.py::solve_program, models/hitl/repair.py::
     repair_program, parallel/sharded_solver.py::sharded_program: one
     CUDA graph each, the LM loop a WHILE node; phases 15-18 already ran
     the lone solves and repair_step through theirs, phase 16 runs the
     SPIKE eagerly, where it counts collectives): a replay against
     `eager=True` from the same inputs for lm.solve at 8192 poses with
     BIG_CONFIG (phase 17's joint solve), repair_step on the map of phases
     4-5 after its first logged correction (its second), and the SPIKE at
     d = 4 and 8 on the repaired 1024-pose map and at d = 8 on the
     16384-pose chain (S = 8, n = 2048): bit-equal wherever two eager runs
     are, else within phase 16's card-against-CPU bounds (the standard
     that held is printed); BCR (the SPIKE: its multi route) launched once
     a trip by the replay, counted by device counters, and no other
     kernel; one host read a call; each under torch.cuda.
     set_sync_debug_mode("error"); eager and program walls, graph nodes
     by WHILE level, capture ms, pool MiB; `[program]` lines and one
     `{"solve_programs": {...}}` line;
 24. times at the main path's shapes: each kernel by CUDA events (host
     overhead included) and by torch.profiler (its own device time), its
     plain version, its bound from the shapes, and for BCR
     torch.linalg.solve on the dense system; BCR also at n = 64, 16384
     and 32768;
 25. a `{"kernels": [...]}` line with launches (phases 17's, 18's, 19's,
     20's and 23's also apart), agreement, times and bounds (the batched
     route's launches from phases 15, 18 and 20, the multi route's from
     phases 16 and 23; em_scan and BCR also at phase 17's shapes);
 26. the last line: {"ok": true, "device": {...}}.

scripts/compare_checkouts.py times two checkouts' kernels and replays
against each other on one card with the helpers here.

Needs a CUDA device, the repository checkout it sits in, nvcc, numpy and
scipy. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")

# golden tolerances (tests/test_golden.py): loose and tight
LOOSE = (0.02, 0.01)
TIGHT = (0.002, 0.001)
# BCR agreement bound, relative to max|x|: the test systems have
# cond(H) < ~20 and f32 eps is 6e-8, so round-off over <= 15 levels stays
# well under 1e-5; 1e-4 leaves an order of magnitude of margin
BCR_RTOL = 1e-4
DEVICE = "cuda"
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM rate, and the
# f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# a replay whose graph holds a WHILE node: torch.profiler (CUPTI) does not
# trace its trips (a window over a replayed sweep showed one trip's
# kernels), and CUDA events around it span the host's gaps too, so no
# device time is measured for it, and no busy share
BUSY_NOT_MEASURED = ("busy share not measured (the profiler does not trace "
                     "a WHILE node's trips)")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, iters: int, warmup: int = 5) -> float:
    """Mean ms per call of fn() on the current stream, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(run, wanted: str = "") -> list[tuple[str, float, int]]:
    """run() under torch.profiler: (name, device us, count) of its device
    operations. The profiler now and then delivers no device record at all
    for a window (seen on the H100 machine for windows short and long), so
    the window is run again, up to three times, until it shows an operation
    whose name contains `wanted`; else the list comes back without one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [(evt.key,
                   getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0)),
                   evt.count)
                  for evt in prof.key_averages()
                  if evt.device_type == DeviceType.CUDA]
        if any(wanted in key for key, _, _ in events):
            break
    return events


def device_ms(fn, kernel: str, iters: int = 50
              ) -> tuple[float, float, float]:
    """From torch.profiler over `iters` calls of fn: (device ms per launch
    of the kernels whose names contain `kernel`, their device ms per call,
    device ms of all device operations per call)."""
    import torch

    fn()
    torch.cuda.synchronize()

    def window():
        for _ in range(iters):
            fn()

    events = device_events(window, kernel)
    all_us = sum(us for _, us, _ in events)
    mine_us = sum(us for key, us, _ in events if kernel in key)
    mine_n = sum(n for key, _, n in events if kernel in key)
    # the profiler does not always deliver every kernel record of a window
    # (up to a fifth were missing on the H100 machine), so the means are
    # over the records it delivered
    check(mine_n > 0, f"profiler saw no launch of {kernel} in {iters} calls, "
          f"in three windows")
    return mine_us / mine_n / 1e3, mine_us / iters / 1e3, all_us / iters / 1e3


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the HBM rate or
    f32 operations over the f32 peak, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def em_scan_work(mask) -> tuple[int, int]:
    """(bytes, flops) of one em_scan call: world, mask and sel read once,
    counts and minima written once; per point 6 operations for each of the
    4 clicked points, and 18 for each of the 2 segments where the point is
    masked in (the kernel skips the segment test elsewhere)."""
    P, N = mask.shape
    bytes_moved = P * N * 8 + P * N + 4 * 2 * 4 + P * 2 * 4 + 4 * 4
    flops = P * N * 4 * 6 + int(mask.sum()) * 2 * 18
    return bytes_moved, flops


def bcr_work(n: int, systems: int = 1, rhs: int = 1) -> tuple[int, int]:
    """(bytes, flops) of `systems` n-pose systems, each solved against `rhs`
    right-hand sides: D, U read once a system, b read and x written once a
    right-hand side. Cyclic reduction of an n-pose system eliminates n - 1
    lanes. The factorization, once a system, does a lane's 3x3 adjugate
    inverse (42 operations), its products Dinv L, Dinv U (90) and its even
    neighbour's matrix update (four 3x3 products, 18 subtractions, 18
    negations: 216), and at the root one more inverse (42); each
    right-hand side does a lane's Dinv b (15), its neighbour's vector update
    (two matrix-vector products, 6 subtractions: 36) and its
    back-substitution (51), and at the root one product (15)."""
    bytes_moved = 4 * (systems * (9 * n + 9 * (n - 1))
                       + systems * rhs * (3 * n + 3 * n))
    flops = (systems * ((n - 1) * (42 + 90 + 216) + 42)
             + systems * rhs * ((n - 1) * (15 + 36 + 51) + 15))
    return bytes_moved, flops


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stdout}")
    return out.stdout.strip().splitlines()[0]


def log_ptxas(tag: str, build_log: str) -> None:
    for line in build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "error",
                                   "entry function")):
            log(f"[{tag}] {line.strip()}")


def pose_errors(got, expected):
    import numpy as np

    dxy = float(np.abs(got[:, :2] - expected[:, :2]).max())
    dth = np.arctan2(np.sin(got[:, 2] - expected[:, 2]),
                     np.cos(got[:, 2] - expected[:, 2]))
    return dxy, float(np.abs(dth).max())


# ---------------------------------------------------------------- phase 2

def phase_em_scan(torch, state, log_entries):
    import numpy as np

    from hitl_slam_torch.ops import em_scan as E

    world = state.world_points().contiguous()
    mask = state.point_mask
    P, N = mask.shape
    dev = world.device
    log(f"[em_scan] world [{P}, {N}, 2]")

    def sel_t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    # points placed exactly on the threshold: (0, y) against the segment
    # (-1, 0)-(1, 0) has d2 = fl(y*y); sweep y over f32 neighbours of 0.03
    # and keep the run only if some d2 equals fl(0.03**2) exactly
    w_edge = world.clone()
    m_edge = mask.clone()
    y0 = np.float32(0.03)
    ys = [y0]
    for _ in range(24):
        ys.append(np.nextafter(ys[-1], np.float32(1)))
        ys.insert(0, np.nextafter(ys[0], np.float32(0)))
    ys = np.asarray(ys, np.float32)
    rows = torch.arange(len(ys), device=dev)
    w_edge[rows, 0, 0] = 0.0
    w_edge[rows, 0, 1] = torch.as_tensor(ys, device=dev)
    m_edge[rows, 0] = True
    t2 = np.float32(0.03 ** 2)
    check(np.any(ys * ys == t2), "edge case has no point exactly at t2")
    edge_sel = sel_t([[-1, 0], [1, 0], [-1, 0], [1, 0]])

    m_holes = mask.clone()
    m_holes[::7] = False          # fully masked rows
    p_pt = world[10, 0].tolist()
    q_pt = world[700, 0].tolist()
    cases = []
    for i, e in enumerate(log_entries):
        cases.append((f"log{i}", world, mask, sel_t(e.points), 0.03))
    cases += [
        ("point_pq", world, mask, sel_t([p_pt, p_pt, q_pt, q_pt]), 0.05),
        ("at_threshold", w_edge, m_edge, edge_sel, 0.03),
        ("P_not_tile", world[:P - 3].contiguous(), mask[:P - 3].contiguous(),
         sel_t(log_entries[0].points), 0.03),
        ("masked_rows", world, m_holes, sel_t(log_entries[0].points), 0.03),
        ("masked_rows_odd_P", world[:P - 5].contiguous(),
         m_holes[:P - 5].contiguous(), sel_t(log_entries[1].points), 0.03),
        ("N_odd", world[:, :N - 1].contiguous(), mask[:, :N - 1].contiguous(),
         sel_t(log_entries[1].points), 0.03),
    ]

    def held(name, w, m, s, thr, ck, mk):
        cr, mr = E.em_scan_reference(w, m, s, thr)
        torch.cuda.synchronize()
        check(torch.equal(ck, cr),
              f"em_scan {name}: counts differ in "
              f"{int((ck != cr).sum())} entries")
        check(torch.equal(mk.view(torch.int32), mr.view(torch.int32)),
              f"em_scan {name}: minima not bit-equal {mk.tolist()} vs "
              f"{mr.tolist()}")
        log(f"[em_scan] {name}: P={w.shape[0]} N={w.shape[1]} thr={thr} "
            f"counts exact (sum {int(ck.sum())}), minima bit-equal "
            f"{mk.tolist()}")
        return max(float((mk - mr).abs().max()), float((ck - cr).abs().max()))

    worst = 0.0
    for name, w, m, s, thr in cases:
        ck, mk = E.em_scan_cuda(w, m, s, thr)
        worst = max(worst, held(name, w, m, s, thr, ck, mk))
    # back to back with no synchronise between, other selections and P:
    # the second call must see nothing of the first one's minima or counter
    by_name = {c[0]: c for c in cases}
    first, second = by_name["log0"], by_name["masked_rows_odd_P"]
    out1 = E.em_scan_cuda(*first[1:])
    out2 = E.em_scan_cuda(*second[1:])
    worst = max(worst, held("back_to_back_1", *first[1:], *out1),
                held("back_to_back_2", *second[1:], *out2))
    return worst


# ---------------------------------------------------------------- phase 3

def _spd_system(n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 3, 3))
    D = A @ np.swapaxes(A, -1, -2) + 4.0 * np.eye(3)
    U = rng.normal(size=(max(n - 1, 0), 3, 3)) * 0.3
    b = rng.normal(size=(n, 3))
    return D, U, b


def _bcr_inputs(torch, n):
    D, U, b = _spd_system(n, seed=n)
    return (D, U, b), tuple(torch.as_tensor(a, dtype=torch.float32,
                                            device=DEVICE) for a in (D, U, b))


def _f64_solve(D, U, b):
    """Direct f64 solve: dense LU up to 3n = 3072, banded LU (bandwidth 5)
    above."""
    import numpy as np

    n = D.shape[0]
    if n <= 1024:
        H = np.zeros((3 * n, 3 * n))
        for i in range(n):
            H[3 * i:3 * i + 3, 3 * i:3 * i + 3] = D[i]
            if i + 1 < n:
                H[3 * i:3 * i + 3, 3 * i + 3:3 * i + 6] = U[i]
                H[3 * i + 3:3 * i + 6, 3 * i:3 * i + 3] = U[i].T
        return np.linalg.solve(H, b.reshape(-1)).reshape(n, 3)
    from scipy.linalg import solve_banded

    ab = np.zeros((11, 3 * n))
    i = np.arange(n)
    j = np.arange(n - 1)
    for r in range(3):
        for c in range(3):
            ab[5 + r - c, 3 * i + c] = D[:, r, c]
            ab[5 + r - c - 3, 3 * (j + 1) + c] = U[:, r, c]   # H[i, i+1]
            ab[5 + 3 + r - c, 3 * j + c] = U[:, c, r]         # H[i+1, i]
    return solve_banded((5, 5), ab, b.reshape(-1)).reshape(n, 3)


def _dense_system(torch, D, U, b):
    """The dense 3n x 3n matrix and right-hand side of a block-tridiagonal
    system, on the card."""
    n = D.shape[0]
    H = torch.zeros((n, 3, n, 3), dtype=torch.float32, device=D.device)
    i = torch.arange(n, device=D.device)
    H[i, :, i, :] = D
    j = torch.arange(n - 1, device=D.device)
    H[j, :, j + 1, :] = U
    H[j + 1, :, j, :] = U.transpose(-1, -2)
    return H.reshape(3 * n, 3 * n), b.reshape(3 * n, 1)


def phase_bcr(torch):
    import numpy as np

    from hitl_slam_torch.solver import bcr_kernel as B, tridiag

    worst = 0.0
    for n in (1, 2, 64, 127, 128, 129, 1000, 1024, 1025, 2048, 4096, 4097,
              8192, 16384, 16385, 32768, 65536):
        (D, U, b), (Dt, Ut, bt) = _bcr_inputs(torch, n)
        plan = B.launch_plan(B.check_inputs(Dt, Ut, bt))
        xt = tridiag.bcr_solve(Dt, Ut, bt)
        x64 = _f64_solve(D, U, b)
        scale = max(1.0, float(np.abs(x64).max()))
        xk = B.bcr_solve_cuda(Dt, Ut, bt)
        torch.cuda.synchronize()
        what = f"bcr n={n} {plan.route} of {plan.blocks}, top {plan.top}"
        check(bool(torch.isfinite(xk).all()), f"{what}: non-finite")
        e_twin = float((xk - xt).abs().max())
        e_f64 = float(np.abs(xk.cpu().numpy().astype(np.float64) - x64).max())
        check(e_twin <= BCR_RTOL * scale,
              f"{what}: kernel vs plain {e_twin:.3e} > {BCR_RTOL * scale:.3e}")
        check(e_f64 <= BCR_RTOL * scale,
              f"{what}: kernel vs f64 {e_f64:.3e} > {BCR_RTOL * scale:.3e}")
        worst = max(worst, e_twin)
        log(f"[{what}] max|kernel-plain| {e_twin:.3e}, max|kernel-f64| "
            f"{e_f64:.3e} (max|x| {scale:.3f}; {plan.smem_bytes} B shared, "
            f"{plan.threads} threads a block)")
    return worst


# ---------------------------------------------------------------- phase 4

def _reset_counts():
    from hitl_slam_torch.ops import em_scan as E
    from hitl_slam_torch.solver import bcr_kernel as B

    from hitl_slam_torch.ops import em_refit
    from hitl_slam_torch.solver import lm_step

    em_refit.launches.count = 0
    E.launches.count = 0
    B.launches.count = 0
    B.batched_launches.count = 0
    B.multi_launches.count = 0
    lm_step.launches.count = 0


def _read_counts():
    from hitl_slam_torch.ops import em_scan as E
    from hitl_slam_torch.solver import bcr_kernel as B

    return E.launches.count, B.launches.count


# ---------------------------------------------------------------- phase 3b

# the trip kernel's sizes: each route (a block, a cluster, two launches) and
# one pose past each end; timed at the cycle's 1024 poses and the lone LM's
# 8192
LM_STEP_SIZES = (8, 1024, 1025, 8192, 16384, 16385)
LM_STEP_TIMED = (1024, 8192)


def lm_step_work(P: int) -> int:
    """Bytes of one trip of the LM kernel: x, the step, D and g of the
    carry, the chain factors' axis, radial, rotation and inv_sigma rows,
    the human terms' A, c and q0 read once; x, D, U, g and the next
    system's D and b written once."""
    F = P - 1
    read = P * (3 + 3 + 9 + 3 + 9 + 3 + 3) + F * (4 + 1 + 1 + 3)
    write = P * (3 + 9 + 3 + 9 + 3) + F * 9
    return 4 * (read + write)


def _lm_step_gap(k, p, config):
    """The kernel's carry `k` against the plain carry `p`: the largest
    difference over each field's f32 round-off tolerance (within 1e-5 of
    its largest entry and 1e-6 of D's: g and b cancel terms of that size),
    and whether the flags agree."""
    from hitl_slam_torch.solver import lm_step as S

    scale = float(p.D.abs().max())
    (kD, _, kb), (pD, _, pb) = S.system(k, config), S.system(p, config)
    worst = 0.0
    for got, want in ((k.x, p.x), (k.D, p.D), (k.U, p.U), (k.g, p.g),
                      (k.c, p.c), (k.mu, p.mu), (k.nu, p.nu), (kD, pD),
                      (kb, pb)):
        if want.numel():
            want = want.double()
            tol = 1e-5 * max(float(want.abs().max()), 1.0) + 1e-6 * scale
            worst = max(worst, float((got.double() - want).abs().max()) / tol)
    flags = all(bool((getattr(k, n) == getattr(p, n)).all())
                for n in ("it", "done", "go"))
    return worst, flags


def phase_lm_step(torch):
    """The LM trip kernel against its plain version on the card, and its
    times. Returns (its launches, the worst gap over tolerance, {P: times})."""
    import numpy as np

    from hitl_slam_torch.bench import seeded_chain
    from hitl_slam_torch.solver import bcr_kernel as B, joint, lm_step as S
    from hitl_slam_torch.solver.lm import LMConfig

    config = LMConfig()
    S.launches.count = 0
    worst, times = 0.0, {}
    for P in LM_STEP_SIZES:
        poses, table = seeded_chain(P, P, DEVICE)
        poses = torch.as_tensor(poses, device=DEVICE)
        problem = joint.build_problem(poses, table)
        jitter = np.random.default_rng(P).normal(
            0, [0.05, 0.05, 0.01], (P, 3)).astype(np.float32)
        jitter[0] = 0.0
        start = poses + torch.as_tensor(jitter, device=DEVICE)
        k = S.begin(problem, start, config)
        p = S.begin_reference(S.soa_assembler(problem), start, config)
        first, first_flags = _lm_step_gap(k, p, config)
        step = B.bcr_solve(*S.system(p, config))
        accept = bool(S.trip_reference(p, step, config))
        S.trip(k, step, config)
        _sync()
        gap, flags = _lm_step_gap(k, p, config)
        k_accept = bool(k.accepted[0]) if k.accepted is not None else accept
        check(first_flags and flags and first <= 1.0 and gap <= 1.0
              and k_accept == accept,
              f"lm_step P={P}: kernel against plain version, first "
              f"assembly {first:.3f} and trip {gap:.3f} of tolerance, flags "
              f"{first_flags} {flags}, accept {k_accept} / {accept}")
        worst = max(worst, first, gap)
        plan = S.launch_plan(P)
        line = (f"[lm_step] P={P} ({plan.route}, {plan.blocks} x "
                f"{plan.threads}): first assembly {first:.3f}, trip "
                f"{gap:.3f} of the f32 tolerance; accept {accept}")
        if P in LM_STEP_TIMED:
            run = lambda: S.trip(k, step, config)   # noqa: E731
            ms = time_cuda(run, 200)
            per_launch, dev_ms, dev_all = device_ms(run, "lm_step_kernel")
            plain_ms = time_cuda(lambda: S.trip_reference(p, step, config),
                                 20)
            bound_ms = lm_step_work(P) / HBM_BYTES_PER_S * 1e3
            times[P] = dict(ms=ms, device_ms=per_launch,
                            device_ms_per_call=dev_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by="bytes",
                            bytes=lm_step_work(P), library_ms=None)
            line += (f"; events {ms:.5f} ms, device {per_launch:.5f} ms a "
                     f"launch (all device work a call {dev_all:.5f} ms), "
                     f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
                     f"({lm_step_work(P)} bytes)")
        log(line)
    _sync()
    return S.launches.count, worst, times


def lm_step_count() -> int:
    from hitl_slam_torch.solver import lm_step

    return lm_step.launches.count


# the trip kernel's launches on the main path (phase 4), for the kernels line
LM_STEP_LAUNCHES: list[int] = []


# ---------------------------------------------------------------- phase 3c

# the refit kernel on the benchmark's maps: (cell's map, configuration,
# traffic) files under cardbench/
EM_REFIT_CELLS = (("1024", "hitl-figure8-1024.json", "corrections.json"),
                  ("8192", "hitl-figure8-8192.json", "colinear-session.json"))
# endpoints, kernel against plain version (tests/test_torch_em_refit.py)
EM_REFIT_TOL_M = 1e-5


def em_refit_work(M: int, S: int = 2) -> int:
    """Bytes of one refit round over M slots: the points and the mask read
    once, the carry (endpoints, moved, the loop's flag) read and written
    once; the inliers' trip through the kernel's scratch is its own."""
    return M * (8 + 1) + 2 * S * (16 + 4) + 1


def _cell_strokes(torch, config: str, traffic: str):
    """The cell's map at its seed-0 jitter as the engine holds it on the
    card (make_map_state's padding: world points [P, N, 2], mask [P, N])
    and its traffic's strokes sketched on the initial poses, each
    [2, 2, 2] on the card."""
    import numpy as np

    from cardbench.frozen.sessions import sketch
    from cardbench.mixes.corrections import decode_specs, make_map
    from hitl_slam_torch.core.state import make_map_state

    with open(os.path.join(HERE, "cardbench", "configs", config)) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "cardbench", "traffic", traffic)) as f:
        tr = json.load(f)
    m = make_map(cfg, tr, 0)
    st = make_map_state(np.asarray(m.poses), np.asarray(m.covariances),
                        m.point_clouds, m.normal_clouds, device=DEVICE)
    strokes = []
    for spec in decode_specs(tr["specs"], len(m.poses)):
        try:
            sel = sketch(m, spec, m.poses)
        except ValueError:
            continue
        strokes.append(torch.as_tensor(np.asarray(sel, np.float32),
                                       device=DEVICE).reshape(2, 2, 2))
    return st.world_points(), st.point_mask, strokes


def phase_em_refit(torch):
    """The EM refit kernel against its plain version on the benchmark's
    maps, and its times. Returns (its launches, the largest endpoint gap in
    m, {cell: times and inliers})."""
    from hitl_slam_torch.ops import em_refit as R
    from hitl_slam_torch.ops.geometry import dist_to_segment

    R.launches.count = 0
    worst, out = 0.0, {}
    for cell, config, traffic in EM_REFIT_CELLS:
        world, mask, strokes = _cell_strokes(torch, config, traffic)
        P, N = mask.shape
        flat, fmask = world.reshape(-1, 2).contiguous(), mask.reshape(-1)
        M = flat.shape[0]
        check(strokes, f"em_refit {cell}: no stroke could be sketched")
        buffers = R.scratch(M, 2, DEVICE)
        inliers, routes, cell_gap = [], [], 0.0
        for k, segs in enumerate(strokes):
            inf = torch.full((2,), float("inf"), device=DEVICE)
            s, mv = segs.clone(), inf.clone()
            go = torch.ones((), dtype=torch.bool, device=DEVICE)
            stats = torch.full((2, 2), -1, dtype=torch.int32, device=DEVICE)
            R.round_cuda(flat, fmask, s, mv, go, stats, buffers)
            ps, pmv, pgo = segs.clone(), inf.clone(), go.clone()
            R.round_reference(flat, fmask, ps, pmv, pgo)
            d = dist_to_segment(segs[:, None, 0], segs[:, None, 1], flat[None])
            want = (fmask[None] & (d < R.INLIER_THRESHOLD)).sum(-1)
            gap = float(max((s - ps).abs().max(), (mv - pmv).abs().max()))
            check(stats[:, 0].tolist() == want.tolist()
                  and gap <= EM_REFIT_TOL_M and bool(go) == bool(pgo),
                  f"em_refit {cell} stroke {k}: inliers {stats.tolist()} "
                  f"against {want.tolist()}, endpoint gap {gap:.3e} m, go "
                  f"{bool(go)} / {bool(pgo)}")
            cell_gap = max(cell_gap, gap)
            inliers.append(stats[:, 0].tolist())
            routes.append([R.ROUTES[int(r)] for r in stats[:, 1]])
        segs = strokes[0]
        s, mv = segs.clone(), torch.empty(2, device=DEVICE)
        go = torch.ones((), dtype=torch.bool, device=DEVICE)

        def run():
            s.copy_(segs)
            mv.fill_(float("inf"))
            R.round_cuda(flat, fmask, s, mv, go, None, buffers)

        def plain():
            s.copy_(segs)
            mv.fill_(float("inf"))
            R.round_reference(flat, fmask, s, mv, go)

        ms = time_cuda(run, 200)
        per_launch, _, dev_all = device_ms(run, "em_refit_kernel")
        plain_ms = time_cuda(plain, 20)
        work = em_refit_work(M)
        bound_ms = work / HBM_BYTES_PER_S * 1e3
        plan = R.launch_plan(M)
        out[cell] = dict(ms=ms, device_ms=per_launch, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by="bytes", bytes=work,
                         map=[P, N], slots=M, blocks=plan.blocks,
                         inliers=inliers,
                         routes=routes, max_endpoint_gap_m=cell_gap,
                         library_ms=None)
        worst = max(worst, cell_gap)
        log(f"[em_refit] {P} x {N} ({M} slots, a cluster of "
            f"{plan.blocks}): strokes' inliers {inliers}, fitted from "
            f"{routes}; endpoints within {cell_gap:.2e} m of the plain round; "
            f"events {ms:.5f} ms (the carry's reset included), device "
            f"{per_launch:.5f} ms a launch (all device work a call "
            f"{dev_all:.5f} ms), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({work} bytes)")
    _sync()
    return R.launches.count, worst, out


def em_refit_count() -> int:
    from hitl_slam_torch.ops import em_refit

    return em_refit.launches.count


def refit_rounds() -> dict:
    """The EM refit rounds each live stage clock has seen, by clock: its
    em_refit -> em_refit hits (one a round, the loop's test to the next)."""
    from hitl_slam_torch.utils import device_loop

    out = {}
    for c in list(device_loop.clocks.values()):
        if "em_refit" in c.marks:
            i = c.marks.index("em_refit")
            out[c.index] = int(c.read()["edge_hits"][i, i])
    return out


# the refit kernel's launches on the main path (phase 4), for the kernels
# line
EM_REFIT_LAUNCHES: list[int] = []


def _engine(data, capacity):
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    eng = HitLSLAM(device=DEVICE)
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=capacity)
    return eng


def run_main_path(torch, name, data, entries, capacity, expected, tols,
                  fused):
    import numpy as np

    eng = _engine(data, capacity)
    torch.cuda.synchronize()
    _reset_counts()
    rounds0 = refit_rounds()
    walls = []
    if fused:
        t0 = time.perf_counter()
        reports = eng.run_queue(entries)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / len(entries))
    else:
        reports = []
        for e in entries:
            t0 = time.perf_counter()
            reports.append(eng.replay_log(e))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    n_em, n_bcr = _read_counts()
    iters = [r.lm_iterations for r in reports]
    for i, r in enumerate(reports):
        check(r.accepted, f"{name}: correction {i} rejected: {r.reason}")
    cycles = len(entries)
    check(n_em == 2 * cycles,
          f"{name}: em_scan launches {n_em} != 2 x {cycles} cycles")
    check(n_bcr == sum(iters),
          f"{name}: bcr launches {n_bcr} != LM iterations {sum(iters)}")
    n_step = lm_step_count()
    check(n_step == sum(iters) + cycles,
          f"{name}: lm_step launches {n_step} != LM iterations "
          f"{sum(iters)} + {cycles} solves")
    LM_STEP_LAUNCHES.append(n_step)
    n_refit = em_refit_count()
    rounds = sum(n - rounds0.get(i, 0) for i, n in refit_rounds().items())
    check(rounds >= cycles and n_refit == rounds,
          f"{name}: em_refit launches {n_refit}, refit rounds {rounds} "
          f"(the clocks' em_refit -> em_refit hits), cycles {cycles}")
    EM_REFIT_LAUNCHES.append(n_refit)
    got = eng.get_poses()
    check(np.all(np.isfinite(got)) and got.shape == data.poses.shape,
          f"{name}: poses not finite / wrong shape")
    errs = []
    for exp, (atol_xy, atol_th) in zip(expected, tols):
        dxy, dth = pose_errors(got, exp)
        check(dxy <= atol_xy and dth <= atol_th,
              f"{name}: pose error {dxy:.3e} m / {dth:.3e} rad exceeds "
              f"{atol_xy} m / {atol_th} rad")
        errs.append(f"{dxy:.2e} m / {dth:.2e} rad (<= {atol_xy} / {atol_th})")
    log(f"[main] {name}: {cycles} cycles accepted, per-cycle wall ms "
        f"{[round(w, 3) for w in walls]}{' (chain mean)' if fused else ''}, "
        f"LM iterations {iters}, launches em_scan={n_em} bcr={n_bcr} "
        f"lm_step={n_step} em_refit={n_refit}, "
        f"pose error {'; '.join(errs)}")
    return n_em, n_bcr, eng


def phase_main(torch, small, small_log, large, large_log):
    """The golden replays; returns the launch totals and the state the
    golden_large run_queue leaves (the repaired 1024-pose map)."""
    import numpy as np

    exp_small = [np.loadtxt(os.path.join(DATA, "golden_expected_poses.txt")),
                 np.loadtxt(os.path.join(DATA, "golden_expected_poses_tight.txt"))]
    exp_large = [np.loadtxt(os.path.join(DATA, "golden_large_expected_poses.txt"))]
    totals = [0, 0]
    for args in (
        ("golden replay_log", small, small_log, 256, exp_small,
         [LOOSE, TIGHT], False),
        ("golden_large replay_log", large, large_log, 16384, exp_large,
         [LOOSE], False),
        ("golden_large run_queue", large, large_log, 16384, exp_large,
         [LOOSE], True),
    ):
        n_em, n_bcr, eng = run_main_path(torch, *args)
        totals[0] += n_em
        totals[1] += n_bcr
    return totals, eng.state


# ---------------------------------------------------------------- phase 5

# tests/test_stf.py::test_pcg_refine_matches_dense: PCG against dense poses
PCG_ATOL = 2e-3


def _sync():
    import torch

    if DEVICE != "cpu":
        torch.cuda.synchronize()


def _peak_memory_mb(torch):
    if DEVICE == "cpu":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2 ** 20


def phase_refine(torch, data, entries, capacity):
    """The post-human STF refine at the map's full width, on the state the
    replayed session leaves. Launches no hand-written kernel: the reference
    refine reaches none (its PCG preconditioner is the plain block cyclic
    reduction)."""
    import numpy as np

    from hitl_slam_torch.bench import refine_split
    from hitl_slam_torch.models.hitl import refine as R

    eng = _engine(data, capacity)
    for e in entries:
        rep = eng.replay_log(e, record=True)
        check(rep.accepted, f"refine: replay rejected: {rep.reason}")
    repaired = eng.state
    history = [(h.correction_type, h.undone) for h in eng.get_input_history()]
    P = repaired.num_poses
    log(f"[refine] map: {P} poses x {repaired.max_points} padded points, "
        f"{int(repaired.point_mask.sum())} real")
    smi = nvidia_smi_line() if DEVICE != "cpu" else "cpu"

    # ---- post_optimize through the engine ----
    _sync()
    _reset_counts()
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = eng.post_optimize(matcher="auto")
    _sync()
    wall = (time.perf_counter() - t0) * 1e3
    peak = _peak_memory_mb(torch)
    check(_read_counts() == (0, 0),
          f"refine: kernel launches {_read_counts()} on a path with none")
    refined = eng.state.poses
    check(rep.accepted, f"post_optimize not accepted: {rep.reason}")
    check(rep.final_cost <= rep.initial_cost,
          f"post_optimize cost rose: {rep.initial_cost} -> {rep.final_cost}")
    check(bool(torch.isfinite(refined).all()), "post_optimize: poses not finite")
    d0 = float((refined[0] - repaired.poses[0]).abs().max())
    check(d0 <= 1e-6, f"post_optimize moved pose 0 by {d0}")
    moved = pose_errors(refined.cpu().numpy(), repaired.poses.cpu().numpy())
    log(f"[refine] post_optimize(auto): {rep.reason}; wall {wall:.1f} ms, "
        f"LM iterations {rep.lm_iterations}, cost {rep.initial_cost:.6g} -> "
        f"{rep.final_cost:.6g}, dropped_rows {rep.dropped_rows}, poses moved "
        f"{moved[0]:.3e} m / {moved[1]:.3e} rad, peak memory {peak:.0f} MiB "
        f"({smi})")
    matcher = "pair" if "pair matcher" in rep.reason else "global"

    # ---- a second run from the same state: bit-equal, and the split ----
    results = {}
    for name, m, solver in (("dense", matcher, "auto"),
                            ("pcg", matcher, "pcg"),
                            ("pair", "pair", "auto")):
        if DEVICE != "cpu":
            torch.cuda.reset_peak_memory_stats()
        r = refine_split(_sync, repaired, m, 30, solver=solver)
        r["peak_mib"] = _peak_memory_mb(torch)
        results[name] = r
        poses = r["poses"]
        check(bool(torch.isfinite(poses).all()), f"refine {name}: not finite")
        check(r["final_cost"] <= r["initial_cost"],
              f"refine {name}: cost rose {r['initial_cost']} -> "
              f"{r['final_cost']}")
        check(r["num_matches"] > 0, f"refine {name}: no matches")
        log(f"[refine] {name} (matcher {m}, solver {solver}): match "
            f"{r['match_ms']:.1f} ms, solve {r['solve_ms']:.1f} ms, LM "
            f"iterations {r['lm_iterations']}, CG iterations "
            f"{r['cg_iterations']}, matches {r['num_matches']}, cost "
            f"{r['initial_cost']:.6g} -> {r['final_cost']:.6g}, dropped: "
            f"match {r['match_dropped']} pairs {r['pairs_dropped']} vote "
            f"{r['vote_dropped']} elect {r['elect_dropped']}, peak memory "
            f"{r['peak_mib']:.0f} MiB ({smi})")
    dense, pcg = results["dense"], results["pcg"]
    check(torch.equal(dense["poses"], refined),
          "two refines from the same state are not bit-equal: max diff "
          f"{float((dense['poses'] - refined).abs().max()):.3e}")
    check(dense["lm_iterations"] == rep.lm_iterations
          and dense["match_dropped"] == rep.dropped_rows,
          "the second refine's report differs from the first's")
    check(pcg["num_matches"] == dense["num_matches"],
          f"pcg matches {pcg['num_matches']} != dense {dense['num_matches']}")
    dpcg = float((pcg["poses"] - dense["poses"]).abs().max())
    check(dpcg <= PCG_ATOL, f"pcg poses {dpcg:.3e} from dense > {PCG_ATOL}")
    # the pair matcher's table: distinct pose pairs among its rows
    stf, *_ = R.match_factors(repaired.points, repaired.normals,
                              repaired.point_mask, repaired.poses, "pair",
                              65536, 8192, 64, None)
    keys = (stf.pose0.long() * P + stf.pose1.long())[stf.valid]
    n_pairs = int(torch.unique(keys).numel())
    check(n_pairs > 0, "pair matcher: no pose pair")
    log(f"[refine] second run bit-equal to the first; pcg within "
        f"{dpcg:.3e} of dense (<= {PCG_ATOL}); pair matcher: {n_pairs} "
        f"pose pairs in {int(stf.valid.sum())} rows")

    # ---- undo reverts the refine alone ----
    check(eng.undo(), "undo after post_optimize returned False")
    check(torch.equal(eng.state.poses, repaired.poses),
          "undo did not restore the pre-refine poses bit for bit")
    check([(h.correction_type, h.undone) for h in eng.get_input_history()]
          == history, "undo of the refine touched the input history")
    log("[refine] undo: pre-refine poses restored bit for bit, input "
        "history untouched")
    return repaired


# ---------------------------------------------------------------- phase 6

def phase_speculative(torch, data, entry, capacity):
    """One correction through the two-click path with speculative dispatch,
    against replay_log of the same entry from the same state."""
    want = _engine(data, capacity)
    rep_w = want.replay_log(entry)
    check(rep_w.accepted, f"speculative: replay rejected: {rep_w.reason}")

    eng = _engine(data, capacity)
    _sync()
    _reset_counts()
    ct = int(entry.correction_type)
    p = entry.points
    eng.add_correction_points(ct, p[0], p[1])
    eng.add_correction_points(ct, p[2], p[3])
    rep = eng.run()
    _sync()
    n_em, n_bcr = _read_counts()
    check(rep.accepted, f"speculative run rejected: {rep.reason}")
    check(eng.speculative_hits == 1,
          f"speculative hits {eng.speculative_hits} != 1")
    check(torch.equal(eng.state.poses, want.state.poses),
          "speculative run's poses differ from replay_log's: max "
          f"{float((eng.state.poses - want.state.poses).abs().max()):.3e}")
    check(torch.equal(eng.state.covariances, want.state.covariances)
          and torch.equal(eng.state.constraints.active,
                          want.state.constraints.active),
          "speculative run's covariances or constraint rows differ")
    check(rep.lm_iterations == rep_w.lm_iterations,
          "speculative run's LM iterations differ from replay_log's")
    check(n_em == 2 and n_bcr == rep.lm_iterations,
          f"speculative cycle launches em_scan={n_em} bcr={n_bcr}, expected "
          f"2 and {rep.lm_iterations}")
    log(f"[speculative] 1 hit, poses bit-equal to replay_log, LM iterations "
        f"{rep.lm_iterations}, launches em_scan={n_em} bcr={n_bcr}")
    return n_em, n_bcr


# ---------------------------------------------------------------- phase 7

# The drifted map of the proposal phases: the port's own figure-8 generator,
# two laps, 1024 poses, 120 rays (128 padded points a pose). On this map the
# JAX package's propose_corrections(max_proposals=4, seed=0), run on a CPU,
# yields 1 proposal (anchor pose 7, corrected pose 519, score 0.806); the
# port's CPU run of the auto-repair loop applies 3 corrections in 3 rounds
# and takes the aligned error from 0.324 m to 0.196 m (0.60 of its start).
DRIFTED_MAP = dict(num_poses=1024, num_rays=120, seed=11,
                   drift_theta_bias=1.5e-4, num_laps=2)
# min_gap at which DRIFTED_MAP yields all 2 x max_proposals = 8 candidates
FULL_BATCH_MIN_GAP = 96
CLEAN_MAP = dict(num_poses=1024, num_rays=120, seed=5, drift_theta_bias=0.0,
                 noise_trans=0.0, noise_theta=0.0, num_laps=2)
# card against CPU: selections are snapped to observed points, so equal
# proposals have equal selections up to the world transform's round-off
SEL_ATOL = 1e-4
# render: pixels of the card's image that may differ from the CPU's image of
# the same world points (subtract, multiply, cast: none is expected)
RENDER_PIXELS = 4
# SDF, card against CPU: values 1e-5, weights 1e-4, but for at most 0.1 %
# of the pixels (a bearing within an ulp of a bin edge reads the
# neighbouring beam; 79 of 269,990 pixels on an H100 against its host)
SDF_VALUE_ATOL, SDF_WEIGHT_ATOL, SDF_OUTLIER_SHARE = 1e-5, 1e-4, 1e-3


def procrustes_error(poses, gt_poses) -> float:
    """Mean position error after the best rigid alignment onto gt_poses."""
    import numpy as np

    a = np.asarray(poses[:, :2], np.float64)
    b = np.asarray(gt_poses[:, :2], np.float64)
    ca, cb = a.mean(0), b.mean(0)
    U, _, Vt = np.linalg.svd((a - ca).T @ (b - cb))
    R = (U @ Vt).T
    if np.linalg.det(R) < 0:
        Vt[-1] *= -1
        R = (U @ Vt).T
    return float(np.linalg.norm((a - ca) @ R.T + cb - b, axis=1).mean())


def stage_ms(name: str, fn, on_device: bool = True, profiled=None):
    """Run fn() on the card: warm, timed by the host clock around a
    synchronise (wall ms), and under torch.profiler (device ms: the sum of
    its device operations, and their number); a stage that works on the
    device must show some. Where fn() replays a device program with a
    WHILE node, whose trips the profiler does not trace, `profiled` (the
    same work run eagerly) is profiled in its place. Logs and returns
    (result, wall_ms, device_ms, device_ops)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = device_events(profiled or fn) if on_device else []
    dev_ms = sum(us for _, us, _ in events) / 1e3
    ops = sum(n for _, _, n in events)
    check(ops > 0 or not on_device,
          f"{name}: the profiler showed no device operation in three windows")
    log(f"[stage] {name}: wall {wall:.3f} ms, device {dev_ms:.3f} ms in "
        f"{ops} device operations")
    return out, wall, dev_ms, ops


def _eagerly(fn):
    """fn() within eager_loops()."""
    with eager_loops():
        return fn()


@contextlib.contextmanager
def eager_loops():
    """Within it, the curator's and the proposals' build_sdf and
    extract_segments run eagerly (`eager=True`) instead of replaying their
    programs: for the eager side of a comparison, and for a profiler
    window (the profiler does not trace a WHILE node's trips)."""
    import functools

    from hitl_slam_torch.models.hitl import propose
    from hitl_slam_torch.models.ltvm import curator

    saved = [(m, name, getattr(m, name)) for m, name in (
        (curator, "build_sdf"), (curator, "extract_segments"),
        (propose, "extract_segments"))]
    for m, name, fn in saved:
        setattr(m, name, functools.partial(fn, eager=True))
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _fig8_engine(m, device):
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    eng = HitLSLAM(device=device)
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             odometry=m.odometry, constraint_capacity=16384)
    return eng


def _same_proposals(what, got, want):
    check(len(got) == len(want),
          f"{what}: {len(got)} proposals against {len(want)}")
    import numpy as np

    for k, (a, b) in enumerate(zip(got, want)):
        pair_a = (a.anchor_pose, a.corrected_pose)
        pair_b = (b.anchor_pose, b.corrected_pose)
        d = float(np.abs(a.input.points - b.input.points).max())
        check(pair_a == pair_b and d <= SEL_ATOL,
              f"{what}: candidate {k} differs: poses {pair_a} against "
              f"{pair_b}, selections {d:.3e} m apart")


def phase_proposals(torch):
    """Proposals and the CLI's auto-repair loop at full width: 1024 poses,
    128 padded points, max_proposals=4, the default matcher parameters
    (0.05 m cells, a 560 x 560 field, 29 angles, a 41 x 41 window). At the
    default min_gap (a quarter of the poses), which the auto-repair loop
    uses, the map yields B = 4 candidates: one per cluster of 128 poses
    within 4 m of an earlier pass. The device stages are also driven and
    timed at the full batch that max_proposals=4 admits, B = 8
    (min_gap=FULL_BATCH_MIN_GAP)."""
    import numpy as np

    from hitl_slam_torch.cli import auto_repair
    from hitl_slam_torch.io.figure8 import generate_figure8
    from hitl_slam_torch.models.hitl import propose as P
    from hitl_slam_torch.ops import ransac, scan_match

    m = generate_figure8(**DRIFTED_MAP)
    eng = _fig8_engine(m, DEVICE)
    st = eng.state
    check(st.points.shape == (1024, 128, 2), f"map {st.points.shape}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- propose: repeatable, and equal to the CPU's ----
    _reset_counts()
    t0 = time.perf_counter()
    first = eng.propose_corrections(max_proposals=4, seed=0)
    wall = (time.perf_counter() - t0) * 1e3
    check(len(first) >= 1, "no proposal on the drifted map")
    check(_read_counts() == (0, 0), "propose_corrections launched a kernel")
    again = eng.propose_corrections(max_proposals=4, seed=0)
    _same_proposals("second propose_corrections", again, first)
    for a, b in zip(again, first):
        check(np.array_equal(a.input.points, b.input.points)
              and a.score == b.score and np.array_equal(a.drift, b.drift),
              "two propose_corrections from one state are not identical")
    cpu_eng = _fig8_engine(m, "cpu")
    cpu = cpu_eng.propose_corrections(max_proposals=4, seed=0)
    _same_proposals("card against CPU", first, cpu)
    log(f"[propose] {len(first)} proposals "
        f"{[(p.anchor_pose, p.corrected_pose, round(p.score, 3)) for p in first]}"
        f", identical on a second call, equal to the CPU's; wall {wall:.1f} "
        f"ms first call; peak memory {_peak_memory_mb(torch):.0f} MiB")

    # ---- the full batch: B = 8 candidates, card against CPU ----
    poses_np = st.poses.cpu().numpy()
    check(len(P.candidate_pairs(poses_np, max_proposals=4)) == 4,
          "the drifted map no longer yields 4 candidates at the default gap")
    wide = eng.propose_corrections(max_proposals=4, seed=0,
                                   min_gap=FULL_BATCH_MIN_GAP)
    wide_cpu = cpu_eng.propose_corrections(max_proposals=4, seed=0,
                                           min_gap=FULL_BATCH_MIN_GAP)
    check(len(wide) >= 1, "no proposal at the full batch")
    _same_proposals("card against CPU, B = 8", wide, wide_cpu)

    # ---- the stages, one by one, at B = 4 and at B = 8 ----
    rp = P.PROPOSAL_RANSAC
    for min_gap, want_B in ((None, 4), (FULL_BATCH_MIN_GAP, 8)):
        chosen = P.candidate_pairs(poses_np, max_proposals=4, min_gap=min_gap)
        B = len(chosen)
        check(B == want_B, f"min_gap={min_gap}: {B} candidates, not {want_B}")
        inputs = P.candidate_inputs(st, st.world_points(), poses_np, chosen)
        a_pts, a_mask, centers, scans, scan_masks, guesses = inputs
        log(f"[propose] B = {B} candidates (min_gap={min_gap}), anchor "
            f"points {tuple(a_pts.shape)}, scans {tuple(scans.shape)}")
        torch.cuda.reset_peak_memory_stats()
        def propose(min_gap=min_gap):
            return eng.propose_corrections(max_proposals=4, seed=0,
                                           min_gap=min_gap)

        stage_ms(f"propose_corrections, B={B}", propose,
                 profiled=lambda: _eagerly(propose))
        fields, *_ = stage_ms(
            f"build_likelihood_field, B={B}",
            lambda: scan_match.build_likelihood_field(a_pts, a_mask, centers))
        (matched, _, _), *_ = stage_ms(
            f"correlative_match, B={B}",
            lambda: scan_match.correlative_match(fields, centers, scans,
                                                 scan_masks, guesses))
        u = ransac.uniform_draws(0, rp, DEVICE, batch=2 * B)
        stage_ms(f"extract_segments (anchor side), B={B}",
                 lambda: ransac.extract_segments(a_pts, a_mask, u[:B], rp),
                 profiled=lambda: ransac.extract_segments(
                     a_pts, a_mask, u[:B], rp, eager=True))
        scans_w = P.place_scans(scans, matched)
        stage_ms(f"extract_segments (corrected side), B={B}",
                 lambda: ransac.extract_segments(scans_w, scan_masks, u[B:],
                                                 rp),
                 profiled=lambda: ransac.extract_segments(
                     scans_w, scan_masks, u[B:], rp, eager=True))
        found = P.match_candidates(st, poses_np, chosen, seed=0)
        stage_ms(f"gate_and_pair (the host loop), B={B}",
                 lambda: P.gate_and_pair(poses_np, chosen, found,
                                         max_proposals=4), on_device=False)
        log(f"[propose] B = {B}: peak memory {_peak_memory_mb(torch):.0f} MiB")

    # ---- the CLI's auto-repair loop, 3 rounds ----
    before = procrustes_error(eng.get_poses(), m.gt_poses)
    # a rejected cycle reports 0 LM iterations though its gated solve ran,
    # so the iterations of every solve are read where the cycle makes it
    from hitl_slam_torch.models.hitl import cycle as C

    # (the solve of a replayed program, or of an eager cycle on the CPU)
    per_call, solved = [], []
    replay, solve = eng.replay_log, C.lm_solve
    program_replay = C.CycleProgram.replay

    def counted_solve(*a, **k):
        out = solve(*a, **k)
        if DEVICE == "cpu" or not torch.cuda.is_current_stream_capturing():
            solved.append(out.iterations)
        return out

    def counted_program(prog, ctype):
        out = program_replay(prog, ctype)
        solved.append(prog.solve_iterations(ctype).clone())
        return out

    def counted(entry, record=False):
        em0, bcr0 = _read_counts()
        n0 = len(solved)
        rep = replay(entry, record=record)
        em1, bcr1 = _read_counts()
        per_call.append((rep, em1 - em0, bcr1 - bcr0,
                         [int(i) for i in solved[n0:]]))
        return rep

    eng.replay_log, C.lm_solve = counted, counted_solve
    C.CycleProgram.replay = counted_program
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        tried = auto_repair(eng, 3, torch.device(DEVICE))
    finally:
        eng.replay_log, C.lm_solve = replay, solve
        C.CycleProgram.replay = program_replay
    wall = (time.perf_counter() - t0) * 1e3
    n_em, n_bcr = _read_counts()
    solved = [int(i) for i in solved]
    applied = sum(rep.accepted for _, _, rep in tried)
    check(applied >= 1, "auto-repair applied no correction")
    check(len(per_call) == len(tried) and n_em == 2 * len(tried),
          f"auto-repair: em_scan launches {n_em} != 2 x {len(tried)} cycles")
    for rep, d_em, d_bcr, its in per_call:
        check(d_em == 2, f"auto-repair: a cycle launched em_scan {d_em} times")
        check(len(its) == 1 and d_bcr == its[0] and d_bcr > 0,
              f"auto-repair: bcr launches {d_bcr} != LM iterations of the "
              f"cycle's solve {its}")
        check(rep.lm_iterations == (its[0] if rep.accepted else 0),
              f"auto-repair: report says {rep.lm_iterations} LM iterations, "
              f"the solve made {its}")
    check(n_bcr == sum(solved),
          f"auto-repair: bcr launches {n_bcr} != LM iterations {sum(solved)}")
    after = procrustes_error(eng.get_poses(), m.gt_poses)
    check(np.isfinite(eng.get_poses()).all(), "auto-repair: poses not finite")
    check(after < 0.8 * before,
          f"auto-repair: aligned error {before:.4f} -> {after:.4f} m, not "
          f"below 0.8 of its start")
    check(len(eng.get_input_history()) >= applied,
          "auto-repair: corrections missing from the input history")
    log(f"[auto-repair] {applied} of {len(tried)} corrections applied in "
        f"{wall:.1f} ms, aligned error {before:.4f} -> {after:.4f} m "
        f"({after / before:.3f} of its start), LM iterations of each cycle's "
        f"solve {solved} (accepted: "
        f"{[rep.accepted for _, _, rep in tried]}), launches "
        f"em_scan={n_em} bcr={n_bcr}")

    # ---- the clean map proposes nothing ----
    clean = generate_figure8(**CLEAN_MAP)
    none = _fig8_engine(clean, DEVICE).propose_corrections(max_proposals=4,
                                                           seed=5)
    check(none == [], f"{len(none)} proposals on the clean map")
    log("[propose] clean map: no proposal")
    return eng, clean, n_em, n_bcr


# ---------------------------------------------------------------- phase 8

def phase_render(torch, eng):
    from hitl_slam_torch.ops import raster

    st = eng.state
    world = st.world_points()
    tab = st.constraints
    img, *_ = stage_ms(
        "render_map", lambda: raster.render_map(world, st.point_mask,
                                                st.poses))
    info, *_ = stage_ms(
        "info_matrix_image",
        lambda: raster.info_matrix_image(st.poses[:, 0], tab.anchor,
                                         tab.constrained, tab.active))
    check(img.shape == (1024, 1024, 3) and img.dtype == torch.uint8,
          f"render_map gave {tuple(img.shape)} {img.dtype}")
    check(info.shape == (1024, 1024) and info.dtype == torch.uint8,
          f"info_matrix_image gave {tuple(info.shape)} {info.dtype}")
    lit = int((img > 0).any(-1).sum())
    band = int((info > 0).sum())
    check(lit > 10000, f"render_map lit only {lit} pixels")
    check(band > 2 * 1023, "info_matrix_image shows no constraint pair")
    check(torch.equal(img, raster.render_map(world, st.point_mask, st.poses)),
          "two renders are not bit-equal")
    cpu = raster.render_map(world.cpu(), st.point_mask.cpu(), st.poses.cpu())
    off = int((img.cpu() != cpu).any(-1).sum())
    check(off <= RENDER_PIXELS,
          f"render_map: {off} pixels differ from the CPU's image")
    info_cpu = raster.info_matrix_image(
        st.poses[:, 0].cpu(), tab.anchor.cpu(), tab.constrained.cpu(),
        tab.active.cpu())
    check(torch.equal(info.cpu(), info_cpu),
          "info_matrix_image differs from the CPU's")
    log(f"[render] map {lit} lit pixels, {off} differ from the CPU's (<= "
        f"{RENDER_PIXELS}), repeat bit-equal; adjacency image {band} set "
        f"pixels, equal to the CPU's")


# ---------------------------------------------------------------- phase 9

def _same_vectors(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        va.mass == vb.mass and all(
            np.array_equal(getattr(va, k), getattr(vb, k))
            for k in ("p1", "p2", "p_bar", "scatter", "endpoint_cov"))
        for va, vb in zip(a, b))


def phase_ltvm(torch, large, large_log, clean):
    """The curator at its default parameters (SDF at 0.04 m, RANSAC 32
    rounds of 256 hypotheses against all 131,072 padded points)."""
    import numpy as np

    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.models.ltvm.curator import LongTermVectorMap
    from hitl_slam_torch.ops import ransac, sdf as S
    from hitl_slam_torch.ops.geometry import pose_to_world

    eng = _engine(large, 16384)
    for e in large_log:
        check(eng.replay_log(e).accepted, "ltvm: golden_large replay rejected")
    maps = {
        "golden_large (repaired)": eng.state,
        "figure-8 (clean)": make_map_state(
            clean.gt_poses, clean.covariances, clean.point_clouds,
            clean.normal_clouds, device=DEVICE),
    }
    found = {}
    for name, st in maps.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        curs = [LongTermVectorMap(seed=0) for _ in range(2)]
        curs[0].curate(st.poses, st.points, st.point_mask)      # warm
        curs[0] = LongTermVectorMap(seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vectors = curs[0].curate(st.poses, st.points, st.point_mask)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        second = curs[1].curate(st.poses, st.points, st.point_mask)
        check(_read_counts() == (0, 0), "curate launched a kernel")
        check(_same_vectors(vectors, second),
              f"ltvm {name}: two curators with one seed differ")
        params = curs[0].params
        for v in vectors:
            check(v.mass >= params.prune_min_mass
                  and np.linalg.norm(v.p2 - v.p1) >= params.prune_min_length
                  and np.isfinite(v.endpoint_cov).all(),
                  f"ltvm {name}: a vector fails the prune floors")
        sdf = curs[0].last_sdf
        lengths = sorted((float(np.linalg.norm(v.p2 - v.p1))
                          for v in vectors), reverse=True)
        log(f"[ltvm] {name}: {len(vectors)} vectors, lengths (m) "
            f"{[round(x, 2) for x in lengths]}; SDF "
            f"{tuple(sdf.values.shape)}; curate wall {wall:.1f} ms; second "
            f"curator bit-equal; peak memory {_peak_memory_mb(torch):.0f} MiB")
        found[name] = (vectors, lengths, sdf)
    st = maps["figure-8 (clean)"]
    vectors, lengths, sdf = found["figure-8 (clean)"]
    # the figure-8 has 6 walls, 107 m in all (two long, two short outer,
    # two halves of the divider); a wall seen in pieces may come out as more
    # than one vector
    check(4 <= len(vectors) <= 12 and sum(lengths) > 90.0,
          f"ltvm: the clean figure-8 gave {len(vectors)} vectors of "
          f"{sum(lengths):.1f} m in all")

    # ---- the stages on the clean figure-8, and its SDF against the CPU ----
    params = S.SdfParams()
    world = pose_to_world(st.poses[:, None, :], st.points)
    lo = sdf.origin
    H, W = sdf.values.shape
    card, *_ = stage_ms(
        "build_sdf", lambda: S.build_sdf(st.poses, st.points, st.point_mask,
                                         lo, H, W, params),
        profiled=lambda: S.build_sdf(st.poses, st.points, st.point_mask, lo,
                                     H, W, params, eager=True))
    check(torch.equal(card.values, sdf.values)
          and torch.equal(card.weights, sdf.weights),
          "build_sdf: a second build is not bit-equal")
    keep, *_ = stage_ms(
        "filter_points",
        lambda: S.filter_points(card, world, st.point_mask, params))
    rp = ransac.RansacParams()
    u = ransac.uniform_draws(0, rp, DEVICE)
    stage_ms("extract_segments (LTVM, 32 x 256 on 131072 points)",
             lambda: ransac.extract_segments(world.reshape(-1, 2),
                                             keep.reshape(-1), u, rp),
             profiled=lambda: ransac.extract_segments(
                 world.reshape(-1, 2), keep.reshape(-1), u, rp, eager=True))
    t0 = time.perf_counter()
    cpu = S.build_sdf(st.poses.cpu(), st.points.cpu(), st.point_mask.cpu(),
                      lo.cpu(), H, W, params)
    cpu_s = time.perf_counter() - t0
    dv = (card.values.cpu() - cpu.values).abs()
    dw = (card.weights.cpu() - cpu.weights).abs()
    n_v, n_w = int((dv > SDF_VALUE_ATOL).sum()), int((dw > SDF_WEIGHT_ATOL).sum())
    allowed = SDF_OUTLIER_SHARE * dv.numel()
    check(n_v <= allowed and n_w <= allowed,
          f"build_sdf: {n_v} values and {n_w} weights of {dv.numel()} pixels "
          f"off the CPU's beyond {SDF_VALUE_ATOL} / {SDF_WEIGHT_ATOL}")
    log(f"[ltvm] SDF against the CPU's ({cpu_s:.1f} s there): {n_v} values > "
        f"{SDF_VALUE_ATOL} and {n_w} weights > {SDF_WEIGHT_ATOL} of "
        f"{dv.numel()} pixels (<= {allowed:.0f} allowed), {int(keep.sum())} "
        f"of {int(st.point_mask.sum())} points kept by the filter")


# ---------------------------------------------------------------- phase 10

# tests/test_enml.py's stream, and bench.py's reference-scale EnML map
# (2600 raw steps, 7 laps: 1078 episode nodes, 199,679 points, 256 padded
# points a node, so W * N = 2560 matcher rows a window at W = 10)
ENML_TEST_STREAM = dict(num_steps=160, num_rays=240, seed=11,
                        noise_trans=4e-3, noise_theta=2e-3)
ENML_SCALE_STREAM = dict(num_steps=2600, num_rays=240, seed=12, num_laps=7)
ENML_SCAN_PERIOD_S = 0.05          # the CLI's --scan-period default
# the sweep of the scale map runs whole unless its projected wall passes
# this; it is then cut to its first K nodes, never below ENML_MIN_NODES
ENML_SWEEP_BUDGET_S = 300.0
ENML_MIN_NODES = 512
# card against CPU on the test-size stream: poses and relative covariances
# (f32 round-off carried through 128 window solves; the CPU parity tests
# hold the port to the JAX package at 1e-4 and 1e-3)
ENML_POSE_ATOL, ENML_COV_RTOL = 1e-3, 1e-2


def _episode_state(stream, device):
    import numpy as np

    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.models.enml.driver import (EpisodeOptions,
                                                     build_episodes)

    scans, angles, rel = stream[:3]
    poses, pcs, ncs, _ = build_episodes(
        scans, angles, rel, EpisodeOptions(clip_low=10, clip_high=10))
    st = make_map_state(poses, np.zeros((len(poses), 3, 3), np.float32),
                        pcs, ncs, device=device)
    return st, poses, pcs, ncs


def _node_scans(rel) -> list[int]:
    """The scan index of each episode node: build_episodes' motion gating
    at the CLI's EpisodeOptions, replayed on the odometry alone."""
    import numpy as np

    from hitl_slam_torch.models.enml.driver import EpisodeOptions

    o = EpisodeOptions(clip_low=10, clip_high=10)
    acc_t, acc_th, first, out = np.zeros(2), 0.0, True, []
    for k, r in enumerate(rel):
        c, s = np.cos(acc_th), np.sin(acc_th)
        acc_t = acc_t + np.array([[c, -s], [s, c]]) @ r[:2]
        acc_th = acc_th + r[2]
        if (not first and np.linalg.norm(acc_t) < o.minimum_node_translation
                and abs(acc_th) < o.minimum_node_rotation):
            continue
        out.append(k)
        acc_t, acc_th, first = np.zeros(2), 0.0, False
    return out


def _check_covariances(name, covs, rel=None) -> None:
    """Finite, symmetric and PSD: to 1e-5 and -1e-7 absolute, or, with
    `rel`, to `rel` of each pose's largest entry (an f32 inverse of a
    [3W, 3W] window system rounds in proportion to its entries)."""
    import numpy as np

    check(np.isfinite(covs).all(), f"{name}: covariances not finite")
    scale = (1.0 if rel is None else
             np.maximum(np.abs(covs).max(axis=(1, 2)), 1e-30)[:, None, None])
    asym = float((np.abs(covs - np.swapaxes(covs, 1, 2)) / scale).max())
    check(asym <= (1e-5 if rel is None else rel),
          f"{name}: covariances asymmetric by {asym:.3e}"
          + ("" if rel is None else " relative"))
    low = float((np.linalg.eigvalsh(covs[1:]) / scale[1:, :, 0]).min()
                if rel is not None else np.linalg.eigvalsh(covs[1:]).min())
    check(low > (-1e-7 if rel is None else -rel),
          f"{name}: a covariance eigenvalue is {low:.3e}"
          + ("" if rel is None else " relative"))


def _cobot_bag_messages(scans, angles, rel):
    """LaserScan messages interleaved with two CobotOdometryMsg deltas a
    scan, as a CoBot bag records them (tests/test_rosbag.py)."""
    import numpy as np

    from hitl_slam_torch.io import rosbag as rb

    msgs = []
    t = 100.0
    inc = float(angles[1] - angles[0])
    for i in range(len(scans)):
        if i > 0:
            dr, dx, dy = float(rel[i][2]), float(rel[i][0]), float(rel[i][1])
            msgs.append(("/Cobot/Odometry", "vector_slam_msgs/CobotOdometryMsg",
                         t, rb.serialize_cobot_odometry(dr / 2, dx / 2, dy / 2,
                                                        t)))
            t += 0.01
            # the second half is in the frame after the first half-rotation
            c, s = np.cos(dr / 2), np.sin(dr / 2)
            hx, hy = dx / 2, dy / 2
            msgs.append(("/Cobot/Odometry", "vector_slam_msgs/CobotOdometryMsg",
                         t, rb.serialize_cobot_odometry(
                             dr / 2, c * hx + s * hy, -s * hx + c * hy, t)))
            t += 0.01
        msgs.append(("laser", "sensor_msgs/LaserScan", t,
                     rb.serialize_laser_scan(scans[i], float(angles[0]), inc,
                                             range_min=0.02, range_max=13.0,
                                             stamp=t)))
        t += 0.03
    return msgs


def _device_only_profile(torch, run) -> tuple[float, int]:
    """(device ms, device operations) of run() from torch.profiler tracing
    the card alone (bench_reference.device_profile: rerun up to three
    times where the window comes back without a device record)."""
    from hitl_slam_torch.bench_reference import device_profile

    return device_profile(run)


def _capture_ms(points, o):
    """The capture ms of the sweep program of `points` (NaN on the CPU,
    where the sweep runs eagerly)."""
    if DEVICE == "cpu":
        return float("nan")
    from hitl_slam_torch.models.enml.program import sweep_program

    return sweep_program(points, o, None).graph().capture_ms


def _trip_nodes(points, o, segment):
    """The graph nodes of one trip (one node) of the segment program of
    `points` (0 on the CPU)."""
    if DEVICE == "cpu":
        return 0
    from hitl_slam_torch.models.enml.program import sweep_program

    return sum(sweep_program(points, o, segment).graph().body_nodes)


def phase_enml(torch, smi, tmp):
    """EnML batch localization: card against CPU at test size, the sweep at
    the reference's scale, and a bag through the CLI into HitLSLAM. Returns
    the `enml` record, the test-size stream, the scale map (state, initial
    poses, clouds, ground truth at the nodes, scan count, and the sweep's
    poses where it ran whole) and the bag's path under `tmp`."""
    import numpy as np

    from hitl_slam_torch import cli_enml
    from hitl_slam_torch.io import rosbag, stfs
    from hitl_slam_torch.io.figure8 import generate_raw_stream
    from hitl_slam_torch.models.enml import localizer as L
    from hitl_slam_torch.models.enml.driver import consistency_metric
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    o = L.EnmlOptions()
    out = {"card": smi}
    _sync()
    _reset_counts()

    # ---- 1. card against CPU on the test-size stream ----
    stream = generate_raw_stream(**ENML_TEST_STREAM)
    runs = {}
    for dev in (DEVICE, "cpu"):
        st, poses0, pcs, _ = _episode_state(stream, dev)
        t0 = time.perf_counter()
        p, c = L.batch_localize(st.points, st.normals, st.point_mask,
                                st.poses, o)
        _sync()
        runs[dev] = (st, p, c, (time.perf_counter() - t0) * 1e3)
    st, p_card, c_card, ms_card = runs[DEVICE]
    st_cpu, p_cpu, c_cpu, ms_cpu = runs["cpu"]
    pc, cc = p_card.cpu().numpy(), c_card.cpu().numpy()
    dxy, dth = pose_errors(pc, p_cpu.numpy())
    scale = np.maximum(np.abs(c_cpu.numpy()).max(axis=(1, 2), keepdims=True),
                       1e-30)
    cov_rel = float((np.abs(cc - c_cpu.numpy()) / scale).max())
    check(np.isfinite(pc).all(), "enml test size: poses not finite")
    _check_covariances("enml test size", cc)
    check(dxy <= ENML_POSE_ATOL and dth <= ENML_POSE_ATOL,
          f"enml: card poses {dxy:.3e} m / {dth:.3e} rad from the CPU's")
    check(cov_rel <= ENML_COV_RTOL,
          f"enml: card covariances {cov_rel:.3e} (relative) from the CPU's")
    before = consistency_metric(poses0, pcs)
    after = consistency_metric(pc, pcs)
    check(after <= 1.05 * before,
          f"enml test size: consistency {before:.4f} -> {after:.4f}")
    P = st.num_poses
    counts, differ = {}, []
    for t in range(0, P, 16):
        n = []
        for s_, p_ in ((st, p_card), (st_cpu, p_card.cpu())):
            _, _, valid = L.window_correspondences(
                s_.points, s_.normals, s_.point_mask, p_, t, o)
            n.append(int(valid.sum()))
        counts[t] = n[0]
        if n[0] != n[1]:
            differ.append((t, n[0], n[1]))
    log(f"[enml] test size: {P} nodes x {st.max_points} padded points; card "
        f"{ms_card:.0f} ms, CPU {ms_cpu:.0f} ms; card against CPU: poses "
        f"{dxy:.3e} m / {dth:.3e} rad, covariances {cov_rel:.3e} relative; "
        f"matches at every 16th window {counts}, "
        f"{'equal' if not differ else f'differ at (node, card, cpu) {differ}'}"
        f"; consistency {before:.4f} -> {after:.4f} ({smi})")
    out["test_size"] = dict(nodes=P, card_ms=ms_card, cpu_ms=ms_cpu,
                            pose_diff_m=dxy, pose_diff_rad=dth,
                            cov_rel_diff=cov_rel, matches=counts,
                            match_differ=differ, consistency=[before, after])

    # ---- 2. the reference's scale map ----
    scans, angles, rel, gt, _ = generate_raw_stream(**ENML_SCALE_STREAM)
    st, poses0, pcs, _ = _episode_state((scans, angles, rel), DEVICE)
    P, N = st.points.shape[:2]
    real = int(st.point_mask.sum())
    nodes = _node_scans(rel)
    check(len(nodes) == P, f"node gating replay gave {len(nodes)} != {P}")
    W = min(o.max_history, P)
    pre = L.sweep_precompute(st.poses, o)
    cov0 = torch.zeros((P, 3, 3), dtype=st.poses.dtype, device=DEVICE)
    seg = 32
    # warm, then the profiled 32-node segment (nodes 64..95: full windows)
    L.sweep_segment(st.points, st.normals, st.point_mask, st.poses, cov0,
                    pre, 0, o, seg)
    _sync()
    t0 = time.perf_counter()
    L.sweep_segment(st.points, st.normals, st.point_mask, st.poses, cov0,
                    pre, 64, o, seg)
    _sync()
    seg_ms = (time.perf_counter() - t0) * 1e3
    # the operations a node are one trip's graph nodes; the busy share is
    # not measured (BUSY_NOT_MEASURED)
    ops = _trip_nodes(st.points, o, seg) * seg
    # the whole sweep, or its first K nodes where the budget forces a cut
    K = P
    if seg_ms / seg * P / 1e3 > ENML_SWEEP_BUDGET_S:
        K = max(ENML_MIN_NODES, int(ENML_SWEEP_BUDGET_S * 1e3 * seg / seg_ms))
        K = min(K, P)
    sweep_in = (st.points[:K], st.normals[:K], st.point_mask[:K],
                st.poses[:K], o)
    # the first call captures the sweep's program; the timed one replays it
    L.batch_localize(*sweep_in)
    capture_ms = _capture_ms(sweep_in[0], o)
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    _sync()
    t0 = time.perf_counter()
    p_l, c_l = L.batch_localize(*sweep_in)
    _sync()
    wall_s = time.perf_counter() - t0
    peak = _peak_memory_mb(torch)
    p_l, c_l = p_l.cpu().numpy(), c_l.cpu().numpy()
    check(np.isfinite(p_l).all(), "enml scale: poses not finite")
    check(np.isfinite(c_l).all(), "enml scale: covariances not finite")
    sub = slice(0, K, 16)
    sub_pcs = pcs[:K][sub]
    before = consistency_metric(poses0[:K][sub], sub_pcs)
    after = consistency_metric(p_l[sub], sub_pcs)
    check(after <= 1.05 * before,
          f"enml scale: consistency {before:.4f} -> {after:.4f}")
    gt_nodes = gt[np.asarray(nodes[:K])]
    err_odo = procrustes_error(poses0[:K], gt_nodes)
    err_loc = procrustes_error(p_l, gt_nodes)
    steps = nodes[K - 1] + 1 if K < P else len(scans)
    rtf = steps * ENML_SCAN_PERIOD_S / wall_s
    cut = "" if K == P else f" (cut to the first {K} of {P} nodes: time)"
    log(f"[enml] scale map: {P} nodes x {N} padded points ({real} real), "
        f"W = {W}, W*N = {W * N} matcher rows; sweep of {K} nodes{cut}: "
        f"wall {wall_s:.2f} s, {wall_s * 1e3 / K:.2f} ms a node, realtime "
        f"factor {rtf:.2f} ({steps} scans at {ENML_SCAN_PERIOD_S} s), "
        f"program capture {capture_ms:.1f} ms; "
        f"32-node segment (a replay): wall {seg_ms:.1f} ms, "
        f"{ops / seg:.0f} graph operations a node, {BUSY_NOT_MEASURED}; "
        f"peak memory {peak:.0f} MiB; consistency "
        f"(every 16th node) {before:.4f} -> {after:.4f}; error against "
        f"ground truth (aligned) odometry {err_odo:.4f} m, localized "
        f"{err_loc:.4f} m ({smi})")
    out["scale"] = dict(nodes=P, padded_points=P * N, real_points=real,
                        swept_nodes=K, wall_s=wall_s,
                        capture_ms=capture_ms,
                        ms_per_node=wall_s * 1e3 / K, realtime_factor=rtf,
                        segment_wall_ms=seg_ms,
                        graph_ops_per_node=ops / seg, busy_share=None,
                        peak_mib=peak, consistency=[before, after],
                        gt_error_m=[err_odo, err_loc])
    scale = dict(state=st, poses0=poses0, pcs=pcs,
                 gt=gt[np.asarray(nodes)], scans=len(scans),
                 sequential=p_l if K == P else None)

    # ---- 3. a bag through cli_enml on the card into HitLSLAM ----
    scans, angles, rel = stream[:3]
    bag = os.path.join(tmp, "session.bag")
    rosbag.write_bag(bag, _cobot_bag_messages(scans, angles, rel))
    prefix = os.path.join(tmp, "bagout")
    t0 = time.perf_counter()
    rc = cli_enml.main(["-b", bag, "-o", prefix, "--device", DEVICE])
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"cli_enml exited {rc}")
    data = stfs.load_stfs_covars(prefix + ".stfs.covars")
    n_bag = len(data.poses)
    check(n_bag > 5 and np.isfinite(data.poses).all(),
          f"cli_enml: {n_bag} poses from the bag")
    eng = HitLSLAM(device=DEVICE)
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=256)
    check(eng.get_poses().shape == data.poses.shape
          and eng.state.points.shape[0] == n_bag,
          f"HitLSLAM took {eng.get_poses().shape} from {data.poses.shape}")
    check(_read_counts() == (0, 0),
          f"EnML launched a hand-written kernel: {_read_counts()}")
    log(f"[enml] bag ({len(scans)} scans) -> cli_enml on {DEVICE} in "
        f"{cli_s:.1f} s -> {n_bag} poses -> HitLSLAM state "
        f"{tuple(eng.state.points.shape)}; kernel launches 0 and 0 ({smi})")
    out["bag"] = dict(scans=len(scans), poses=n_bag, cli_s=cli_s)
    return out, stream, scale, bag


# ---------------------------------------------------------------- phase 11

# card against CPU, checkerboard on the test-size stream: poses and
# relative covariances (the CPU parity tests hold the port to the JAX
# package at 1e-5 and 1e-3 for one pass)
CB_POSE_ATOL, CB_COV_RTOL = 1e-4, 1e-2
# the grid route against the CPU: one pass over the first 64 nodes, as
# tests/test_torch_checkerboard.py runs it
CB_GRID_NODES, CB_GRID_OPTS = 64, dict(gn_iterations=6, match_rounds=1)
# the two scale configurations of bench.py: the default window (brute
# matcher, 16 windows a batch) and the reference config's max_history = 80
# (grid matcher, 8 windows a batch)
CB_SCALE = (("W10", {}, 16), ("W80", dict(max_history=80), 8))
# symmetry and PSD of the scale map's covariances, relative to each pose's
# largest entry: at W = 80 the f32 inverse of a [240, 240] window system
# leaves 3.8e-5 of absolute asymmetry on the H100
CB_COV_SYM_RTOL = 1e-3


def phase_checkerboard(torch, smi, stream, scale):
    """The checkerboard localizer (launches neither kernel): card against
    CPU on the test-size stream, both routes, and the probe's counts; then
    the scale map at W = 10 and W = 80 with wall (a replay of the map's
    program; the first call captures it), ms a node, realtime factor, the
    eager wall with its launches a node and busy share from a device-only
    profile, peak memory, consistency, aligned error and the probe's
    dropped count."""
    import numpy as np

    from hitl_slam_torch.models.enml import localizer as L
    from hitl_slam_torch.models.enml import parallel_localizer as CB
    from hitl_slam_torch.models.enml.driver import consistency_metric

    out = {"card": smi}
    _sync()
    _reset_counts()

    # ---- 1. card against CPU on the test-size stream ----
    o = L.EnmlOptions()
    runs = {}
    for dev in (DEVICE, "cpu"):
        st, poses0, pcs, _ = _episode_state(stream, dev)
        args = (st.points, st.normals, st.point_mask, st.poses)
        t0 = time.perf_counter()
        p, c = CB.checkerboard_localize(*args, o)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        g = tuple(a[:CB_GRID_NODES] for a in args)
        gp, gc = CB.checkerboard_localize(*g, L.EnmlOptions(**CB_GRID_OPTS),
                                          n_passes=1, force_grid=True)
        probe = int(CB.probe_match_capacity(*args, o))
        probe_cb = int(CB.probe_match_capacity(*args, L.EnmlOptions(
            max_history=80)))
        runs[dev] = [x.cpu().numpy() for x in (p, c, gp, gc)] + [
            ms, (probe, probe_cb)]
    (p, c, gp, gc, ms_card, probe), (pc, cc, gpc, gcc, ms_cpu, probe_cpu) = (
        runs[DEVICE], runs["cpu"])
    P = len(p)

    def rel(a, b):
        scale_ = np.maximum(np.abs(b).max(axis=(1, 2), keepdims=True), 1e-30)
        return float((np.abs(a - b) / scale_).max())

    dxy, dth = pose_errors(p, pc)
    gxy, gth = pose_errors(gp, gpc)
    cov_rel, gcov_rel = rel(c, cc), rel(gc, gcc)
    check(np.isfinite(p).all() and np.isfinite(gp).all(),
          "checkerboard test size: poses not finite")
    _check_covariances("checkerboard test size", c)
    check(max(dxy, dth, gxy, gth) <= CB_POSE_ATOL,
          f"checkerboard: card poses {dxy:.3e} m / {dth:.3e} rad (grid "
          f"{gxy:.3e} / {gth:.3e}) from the CPU's")
    check(max(cov_rel, gcov_rel) <= CB_COV_RTOL,
          f"checkerboard: card covariances {cov_rel:.3e} (grid {gcov_rel:.3e})"
          " relative from the CPU's")
    check(probe == probe_cpu,
          f"checkerboard: probe counts {probe} on the card, {probe_cpu} on "
          "the CPU")
    before = consistency_metric(poses0, pcs)
    after = consistency_metric(p, pcs)
    check(after <= 1.05 * before,
          f"checkerboard test size: consistency {before:.4f} -> {after:.4f}")
    log(f"[checkerboard] test size: {P} nodes; card {ms_card:.0f} ms, CPU "
        f"{ms_cpu:.0f} ms; card against CPU: poses {dxy:.3e} m / {dth:.3e} "
        f"rad, covariances {cov_rel:.3e} relative; grid route ({CB_GRID_NODES}"
        f" nodes, one pass) {gxy:.3e} m / {gth:.3e} rad, {gcov_rel:.3e}; "
        f"probe dropped (W = 10, W = 80) {probe} on both; consistency "
        f"{before:.4f} -> {after:.4f} ({smi})")
    out["test_size"] = dict(nodes=P, card_ms=ms_card, cpu_ms=ms_cpu,
                            pose_diff_m=dxy, pose_diff_rad=dth,
                            cov_rel_diff=cov_rel, grid_pose_diff=[gxy, gth],
                            grid_cov_rel_diff=gcov_rel, probe=list(probe),
                            consistency=[before, after])

    # ---- 2. the scale map at W = 10 and W = 80 ----
    st = scale["state"]
    args = (st.points, st.normals, st.point_mask, st.poses)
    P, N = st.points.shape[:2]
    pcs, poses0, gt = scale["pcs"], scale["poses0"], scale["gt"]
    sub = slice(0, P, 16)
    before = consistency_metric(poses0[sub], pcs[sub])
    err_odo = procrustes_error(poses0, gt)
    out["scale"] = {}
    for name, okw, chunk in CB_SCALE:
        o = L.EnmlOptions(**okw)
        W = min(o.max_history, P)
        route = "grid" if W * N > CB.BRUTE_MATCH_LIMIT else "brute"
        # the first call captures the map's program (phase 22 has its
        # capture facts); the timed one replays it; the profiled one runs
        # eagerly (the profiler does not trace a WHILE node's trips), and
        # the busy share is its device ms over its own wall
        _sync()
        if DEVICE != "cpu":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        CB.checkerboard_localize(*args, o, chunk=chunk)
        _sync()
        first_s = time.perf_counter() - t0
        peak = _peak_memory_mb(torch)
        t0 = time.perf_counter()
        p, c = CB.checkerboard_localize(*args, o, chunk=chunk)
        _sync()
        wall_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        CB.checkerboard_localize(*args, o, chunk=chunk, eager=True)
        _sync()
        eager_s = time.perf_counter() - t0
        dev_ms, ops = _device_only_profile(
            torch, lambda: CB.checkerboard_localize(*args, o, chunk=chunk,
                                                    eager=True))
        busy = dev_ms / (eager_s * 1e3)
        dropped = int(CB.probe_match_capacity(*args[:3], p, o))
        p, c = p.cpu().numpy(), c.cpu().numpy()
        check(np.isfinite(p).all(), f"checkerboard {name}: poses not finite")
        _check_covariances(f"checkerboard {name}", c, rel=CB_COV_SYM_RTOL)
        asym = float(np.abs(c - np.swapaxes(c, 1, 2)).max())
        after = consistency_metric(p[sub], pcs[sub])
        check(after <= 1.05 * before,
              f"checkerboard {name}: consistency {before:.4f} -> {after:.4f}")
        err = procrustes_error(p, gt)
        rtf = scale["scans"] * ENML_SCAN_PERIOD_S / wall_s
        seq = scale["sequential"]
        vs_seq = (None if seq is None or W != L.EnmlOptions().max_history
                  else float(np.abs(p[:, :2] - seq[:, :2]).max()))
        log(f"[checkerboard] scale map {name}: {P} nodes x {N} padded points, "
            f"W = {W}, {route} matcher, {chunk} windows a batch; wall "
            f"{wall_s:.3f} s (a replay; first call {first_s:.3f} s with the "
            f"capture), {wall_s * 1e3 / P:.3f} ms a node, realtime "
            f"factor {rtf:.1f} ({scale['scans']} scans at "
            f"{ENML_SCAN_PERIOD_S} s); eager {eager_s:.3f} s, device "
            f"{dev_ms:.1f} ms in {ops / P:.1f} device operations a node, "
            f"busy {100 * busy:.1f} % (eager); peak memory {peak:.0f} MiB "
            f"(first call); consistency "
            f"(every 16th node) {before:.4f} -> {after:.4f}; error against "
            f"ground truth (aligned) odometry {err_odo:.4f} m, localized "
            f"{err:.4f} m; probe dropped {dropped}; covariances asymmetric "
            f"by {asym:.2e} at most (largest entry {np.abs(c).max():.2e})"
            + ("" if vs_seq is None else
               f"; {vs_seq:.4f} m from the sequential sweep") + f" ({smi})")
        out["scale"][name] = dict(
            nodes=P, W=W, route=route, chunk=chunk, wall_s=wall_s,
            first_call_s=first_s, eager_wall_s=eager_s,
            ms_per_node=wall_s * 1e3 / P, realtime_factor=rtf,
            device_ms=dev_ms, launches_per_node=ops / P, busy_share=busy,
            peak_mib=peak, consistency=[before, after],
            gt_error_m=[err_odo, err], probe_dropped=dropped,
            from_sequential_m=vs_seq)
    check(_read_counts() == (0, 0),
          f"the checkerboard launched a hand-written kernel: {_read_counts()}")
    return out


# ---------------------------------------------------------------- phase 12

# a drifted two-lap figure-8 (tests/test_torch_engine.py's auto-repair map);
# 256 poses, so the second lap re-observes the first at an offset of 128
SESSION_MAP = dict(num_poses=256, num_rays=120, seed=7, drift_theta_bias=6e-4,
                   num_laps=2)
# (corrected poses, anchor poses, wall as (axis, value)) of the correction
# queued at the 224-node boundary (it applies at the next one, the sweep's
# last, before the progress call) and of the one made after the sweep: the
# bottom wall y = 0, then the centre wall x = 0 (on the port's CPU run both
# are accepted, in 1 and 12 LM iterations, and the aligned error falls from
# 0.275 m after the sweep to 0.177 m and then 0.105 m)
SESSION_QUEUED = ((128, 160), (0, 32), (1, 0.0))
SESSION_QUEUE_AT = 224
SESSION_AFTER = ((160, 192), (32, 64), (0, 0.0))


def _logged(sel):
    """The selection as a correction log stores and reloads it (4 decimals),
    so that a replay of the log applies the very same floats."""
    import numpy as np

    return np.array([[float(f"{v:.4f}") for v in p] for p in sel], np.float32)


def phase_session(torch, smi, tmp):
    """An interactive EnML session on the card: localize in segments of 32
    with one loop correction queued mid-sweep and one made after the sweep,
    launches held against its cycles and LM iterations, then a fresh
    session replays its log: poses and covariances bit-equal."""
    import numpy as np

    from hitl_slam_torch.core.state import CorrectionType
    from hitl_slam_torch.io.figure8 import generate_figure8, synthesize_correction
    from hitl_slam_torch.models.enml.localizer import EnmlOptions
    from hitl_slam_torch.models.enml.session import EnmlSession

    m = generate_figure8(**SESSION_MAP)
    pcs = [np.asarray(p) for p in m.point_clouds]
    ncs = [np.asarray(c) for c in m.normal_clouds]
    o = EnmlOptions()

    def session():
        return EnmlSession(m.poses, pcs, ncs, options=o, device=DEVICE,
                           constraint_capacity=16384)

    def selection(s, spec):
        late, early, wall = spec
        return _logged(synthesize_correction(m, range(*late), range(*early),
                                             wall, wall, poses=s.poses))

    sess = session()
    reports, boundaries = [], []
    add = sess.add_loop_correction

    def recorded(ctype, sel):
        rep = add(ctype, sel)
        reports.append(rep)
        return rep

    sess.add_loop_correction = recorded       # what _apply_pending calls too

    def progress(s, t):
        boundaries.append(t)
        if t == SESSION_QUEUE_AT:
            s.queue_correction(CorrectionType.COLINEAR,
                               selection(s, SESSION_QUEUED))

    loc_err = []
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    sess.localize(segment=32, progress_cb=progress)
    _sync()
    sweep_s = time.perf_counter() - t0
    loc_err.append(procrustes_error(sess.poses, m.gt_poses))
    t0 = time.perf_counter()
    sess.add_loop_correction(CorrectionType.COLINEAR,
                             selection(sess, SESSION_AFTER))
    _sync()
    after_ms = (time.perf_counter() - t0) * 1e3
    n_em, n_bcr = _read_counts()
    live = sess.poses.copy()
    loc_err.append(procrustes_error(live, m.gt_poses))
    iters = [r.lm_iterations for r in reports]
    check(boundaries == list(range(32, 257, 32)),
          f"session: segment boundaries {boundaries}")
    check(len(reports) == 2 and all(r.accepted for r in reports),
          f"session: corrections {[(r.accepted, r.reason) for r in reports]}")
    check(n_em == 2 * len(reports),
          f"session: em_scan launches {n_em} != 2 x {len(reports)} cycles")
    check(n_bcr == sum(iters),
          f"session: bcr launches {n_bcr} != LM iterations {sum(iters)}")
    check(np.isfinite(live).all() and np.isfinite(sess.covariances).all(),
          "session: poses or covariances not finite")
    odo_err = procrustes_error(m.poses, m.gt_poses)
    check(loc_err[1] < odo_err,
          f"session: aligned error {odo_err:.4f} -> {loc_err[1]:.4f} m")
    log_path = os.path.join(tmp, "enml_session.log")
    sess.save_log(log_path)

    # the log replayed by a fresh session: the queued correction applied
    # after the sweep's last segment, as a replay applies it
    s2 = session()
    check(s2.load_log(log_path) == 2, "session: the log holds 2 entries")
    t0 = time.perf_counter()
    s2.localize(segment=32)
    reps = s2.replay_all()
    _sync()
    replay_s = time.perf_counter() - t0
    check([(r.accepted, r.lm_iterations) for r in reps]
          == [(r.accepted, r.lm_iterations) for r in reports],
          f"session replay: {[(r.accepted, r.reason) for r in reps]}")
    check(np.array_equal(s2.poses, live)
          and np.array_equal(s2.covariances, sess.covariances),
          "session: the replayed log's poses differ from the session's: max "
          f"{np.abs(s2.poses - live).max():.3e}")
    log(f"[session] {len(live)} poses, segments of 32: sweep with the "
        f"correction queued at node {SESSION_QUEUE_AT} {sweep_s:.2f} s, "
        f"correction after the sweep {after_ms:.1f} ms; accepted [True, True],"
        f" new constraints {[r.new_constraints for r in reports]}, LM "
        f"iterations {iters}, launches em_scan={n_em} bcr={n_bcr}; aligned "
        f"error odometry {odo_err:.4f} m, after the sweep and the queued "
        f"correction {loc_err[0]:.4f} m, after both {loc_err[1]:.4f} m; the "
        f"log replayed by a fresh session in {replay_s:.2f} s: poses and "
        f"covariances bit-equal ({smi})")
    return dict(poses=len(live), sweep_s=sweep_s, after_ms=after_ms,
                replay_s=replay_s, lm_iterations=iters,
                new_constraints=[r.new_constraints for r in reports],
                launches=dict(em_scan=n_em, bcr=n_bcr),
                gt_error_m=[odo_err] + loc_err,
                replay_bit_equal=True), n_em, n_bcr


# ---------------------------------------------------------------- phase 13

def phase_online(torch, smi, bag, tmp):
    """cli_enml --online on the bag of phase 10 at the recorded rate: the
    producer feeds scans every 0.05 s, the worker localizes each new node's
    trailing window on the card."""
    import contextlib
    import io
    import re

    import numpy as np

    from hitl_slam_torch import cli_enml

    prefix = os.path.join(tmp, "online")
    buf = io.StringIO()
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_enml.main(["-b", bag, "--online", "--rate", "1", "-o", prefix,
                            "--device", DEVICE])
    wall_s = time.perf_counter() - t0
    text = buf.getvalue()
    check(rc == 0, f"cli_enml --online exited {rc}: {text[-500:]}")
    got = re.search(r"online: (\d+) episode nodes localized live in "
                    r"([\d.]+)s .*lag at flush ([\d.]+)s", text)
    check(got is not None, f"cli_enml --online printed no summary: {text}")
    nodes, lag = int(got[1]), float(got[3])
    poses = np.loadtxt(prefix + ".poses")
    check(poses.shape == (nodes, 3) and nodes > 5 and np.isfinite(poses).all(),
          f"online: {poses.shape} poses for {nodes} nodes")
    check(_read_counts() == (0, 0),
          f"the online localizer launched a hand-written kernel: "
          f"{_read_counts()}")
    log(f"[online] {got[0]} ({smi})")
    return dict(nodes=nodes, wall_s=wall_s, stream_s=float(got[2]),
                lag_at_flush_s=lag)


# ---------------------------------------------------------------- phase 14

def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_gui(torch, smi, small, small_log, tmp):
    """One round trip through the GUI bridge: `cli --gui` on the card on a
    free port, a client enters correction mode, draws the first logged
    correction, runs it, saves and shuts the server down; the saved poses
    and the launches equal replay_log's."""
    try:
        import websockets
    except ImportError:
        log("[gui] skipped: websockets not installed")
        return {"skipped": "websockets not installed"}, 0, 0
    import asyncio
    import threading

    import numpy as np

    from hitl_slam_torch import cli
    from hitl_slam_torch.gui import server as S

    entry = small_log[0]
    want = _engine(small, 8192)       # the CLI's constraint capacity
    _sync()
    _reset_counts()
    rep = want.replay_log(entry)
    _sync()
    w_counts = _read_counts()
    check(rep.accepted, f"gui: replay_log rejected: {rep.reason}")

    port = _free_port()
    out = os.path.join(tmp, "gui_saved.txt")
    listening = threading.Event()
    start = S.GuiServer.start

    def start_and_signal(self):
        start(self)
        listening.set()

    rc = {}
    S.GuiServer.start = start_and_signal
    try:
        _sync()
        _reset_counts()
        t0 = time.perf_counter()
        th = threading.Thread(target=lambda: rc.update(code=cli.main(
            ["-P", os.path.join(DATA, "golden.stfs.covars"), "--gui",
             "--gui-port", str(port), "-V", out, "--device", DEVICE])),
            daemon=True)
        th.start()
        check(listening.wait(120), "gui: the bridge did not start")
    finally:
        S.GuiServer.start = start
    frames = []

    async def drive():
        async with websockets.connect(f"ws://127.0.0.1:{port}",
                                      max_size=2 ** 24) as ws:
            async def recv():
                frames.append(json.loads(await asyncio.wait_for(ws.recv(),
                                                                timeout=120)))

            async def send(obj):
                await ws.send(json.dumps(obj))

            await recv()                                  # the latched frame
            await send({"type": "keyboard", "keycode": 0x50})      # 'p'
            p = [list(map(float, q)) for q in entry.points]
            for k in (0, 2):
                await send({"type": "mouse_click",
                            "modifiers": int(entry.correction_type),
                            "mouse_down": p[k], "mouse_up": p[k + 1]})
                await recv()                              # selection drawn
            await send({"type": "keyboard", "keycode": 0x50})      # run
            await recv()
            await send({"type": "keyboard", "keycode": 0x56})      # 'v'
            await send({"type": "shutdown"})

    asyncio.run(drive())
    th.join(timeout=120)
    _sync()
    wall_s = time.perf_counter() - t0
    counts = _read_counts()
    check(not th.is_alive() and rc.get("code") == 0,
          f"gui: the serve loop did not end cleanly ({rc})")
    got = np.loadtxt(out)
    dxy, dth = pose_errors(got, want.get_poses())
    # the saved file has 6 decimals
    check(max(dxy, dth) <= 1e-6,
          f"gui: saved poses {dxy:.3e} m / {dth:.3e} rad from replay_log's")
    check(counts == w_counts,
          f"gui: launches {counts}, replay_log's {w_counts}")
    moved = np.abs(np.asarray(frames[-1]["points"])
                   - np.asarray(frames[0]["points"])).max()
    log(f"[gui] cli --gui on port {port}: 'p', two drags, 'p', 'v', shutdown "
        f"in {wall_s:.2f} s; {len(frames)} frames, the map moved "
        f"{moved:.3f} m; saved poses {dxy:.1e} m / {dth:.1e} rad from "
        f"replay_log's (6 decimals); launches em_scan={counts[0]} "
        f"bcr={counts[1]}, as replay_log's ({smi})")
    return dict(frames=len(frames), wall_s=wall_s, pose_diff=[dxy, dth],
                launches=dict(em_scan=counts[0], bcr=counts[1])), *counts


# ---------------------------------------------------------------- phase 15

# the replica run (BASELINE config #5 at the reference bench's size): 32
# perturbed replicas of the repaired 1024-pose map, 20 LM iterations
REPLICAS = 32
REPLICA_ITERS = 20
# a replica's lone solve on the card against its column of the batch: the
# same operations, but a [B, P] cost sum may reduce in another order than a
# [P] one on the card, so poses agree to round-off, not to the bit
REPLICA_POSE_TOL = 1e-5
# batch sizes and pose counts of the batched kernel's checks and times:
# (n, B); n = 32768 takes the levels route
BATCHED_BCR = ((64, 32), (1024, 32), (16384, 32), (32768, 8))
# the largest dense [systems, 3n, 3n] matrix the library comparison builds
DENSE_MAX_BYTES = 2 << 30


def _replica_lone(reps, tb, r, config):
    """Replica r's lone solve on the card, with its accept sequence."""
    from hitl_slam_torch.parallel.replicas import replica_table
    from hitl_slam_torch.solver import joint, lm

    acc = []
    res = lm.solve(joint.build_problem(reps[r], replica_table(tb, r)),
                   reps[r], config, accepts=acc)
    return res, [bool(a) for a in acc]


def _batched_case(torch, what, D, U, b, timed: bool):
    """The batched route on stacked systems (D, U, b) against lone launches
    (bit-equal) and its plain twin (BCR_RTOL). Returns (error against the
    twin, and where `timed` its times: events, profiler device ms, the
    plain twin, the same systems as lone launches, the bound and the dense
    batched library solve where it fits in DENSE_MAX_BYTES)."""
    from hitl_slam_torch.solver import bcr_kernel as B, tridiag

    nb, n = D.shape[0], D.shape[1]
    xb = B.bcr_solve_cuda_batched(D, U, b)
    lone = torch.stack([B.bcr_solve_cuda(D[i], U[i], b[i])
                        for i in range(nb)])
    twin = tridiag.bcr_solve(D, U, b)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(xb).all()), f"{what}: non-finite")
    check(torch.equal(xb, lone),
          f"{what}: batched x differs from lone launches by "
          f"{float((xb - lone).abs().max()):.3e}")
    scale = max(1.0, float(xb.abs().max()))
    err = float((xb - twin).abs().max())
    check(err <= BCR_RTOL * scale,
          f"{what}: batched kernel vs twin {err:.3e} > {BCR_RTOL * scale:.3e}")
    plan = B.launch_plan(n)
    log(f"[bcr batched] {what}: {plan.route} of {plan.blocks} x {nb}, each "
        f"x bit-equal to a lone launch, max|batched-plain| {err:.3e} "
        f"(max|x| {scale:.3f})")
    if not timed:
        return err, None
    fn = lambda: B.bcr_solve_cuda_batched(D, U, b)   # noqa: E731
    ms = time_cuda(fn, 50)
    per_launch, dev_ms, _ = device_ms(fn, "bcr_")
    plain_ms = time_cuda(lambda: tridiag.bcr_solve(D, U, b), 5)
    lone_ms = time_cuda(lambda: [B.bcr_solve_cuda(D[i], U[i], b[i])
                                 for i in range(nb)], 10)
    bound_ms, bound_by = bound(*bcr_work(n, nb))
    t = dict(B=nb, n=n, ms=ms, device_ms=dev_ms,
             device_ms_per_launch=per_launch, plain_ms=plain_ms,
             lone_launches_ms=lone_ms, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=None)
    if nb * (3 * n) ** 2 * 4 <= DENSE_MAX_BYTES:
        dense = [_dense_system(torch, D[i], U[i], b[i]) for i in range(nb)]
        H = torch.stack([h for h, _ in dense])
        cols = torch.stack([c for _, c in dense])
        del dense
        t["library_ms"] = time_cuda(lambda: torch.linalg.solve(H, cols), 3,
                                    warmup=1)
        del H, cols
    log(f"[time] bcr batched B={nb} n={n} ({what}): events {ms:.5f} ms, "
        f"device {dev_ms:.5f} ms a call ({per_launch:.5f} a launch), {nb} "
        f"lone launches {lone_ms:.5f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by})"
        + (f", dense torch.linalg.solve [{nb}, {3 * n}, {3 * n}] "
           f"{t['library_ms']:.3f} ms" if t["library_ms"] else ""))
    return err, t


def _batched_bcr_checks(torch, first_step):
    """The batched route against lone launches and its twin on the replica
    run's first-step systems and on _spd_system batches; its times at each
    size but 32768. Returns (worst error against the twin, {n: times})."""
    import numpy as np

    worst, times = 0.0, {}
    cases = [("replicas' first step", *first_step)]
    for n, nb in BATCHED_BCR:
        sys_ = [_spd_system(n, seed=1000 * n + i) for i in range(nb)]
        cases.append((f"spd n={n} B={nb}", *(
            torch.as_tensor(np.stack([s[k] for s in sys_]),
                            dtype=torch.float32, device=DEVICE)
            for k in range(3))))
    for what, D, U, b in cases:
        n = D.shape[1]
        err, t = _batched_case(torch, what, D, U, b,
                               what.startswith("spd") and n != 32768)
        worst = max(worst, err)
        if t is not None:
            times[n] = t
    return worst, times


def _repair_on_card(torch, small, small_log):
    """repair_step on the small golden map's first logged correction, the
    selection refit and counted on the card and ordered by the host's
    order_and_filter; poses against the same step on the CPU."""
    import numpy as np

    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.models.hitl import em_input as EI
    from hitl_slam_torch.models.hitl.repair import repair_step
    from hitl_slam_torch.solver import bcr_kernel as B
    from hitl_slam_torch.solver.lm import LMConfig

    entry = small_log[0]
    out = {}
    for dev in (DEVICE, "cpu"):
        st = make_map_state(small.poses, small.covariances, small.point_clouds,
                            small.normal_clouds, constraint_capacity=256,
                            device=dev)
        world = st.world_points()
        raw = torch.as_tensor(np.asarray(entry.points, np.float32),
                              device=dev)
        ok = EI.verify_input(world, st.point_mask, raw)
        check(bool(ok.all()), f"repair_step on {dev}: clicks not verified")
        refit = EI.endpoint_adjust_batch(
            world, st.point_mask, torch.stack([raw[0:2], raw[2:4]])
        ).reshape(4, 2)
        c1, c2 = EI.observation_counts(world, st.point_mask, refit)
        o = EI.order_and_filter(c1.cpu().numpy(), c2.cpu().numpy(),
                                refit.cpu().numpy())
        check(o.valid, f"repair_step on {dev}: ordering invalid")
        corr, anch = o.corrected_poses, o.anchor_poses
        breaks = np.nonzero(np.diff(corr) > 1)[0]
        group = corr[:breaks[0] + 1] if len(breaks) else corr
        gmask = np.zeros(len(small.poses), bool)
        gmask[group] = True
        pad = lambda ix: np.concatenate(   # noqa: E731
            [ix[:64], np.full(64 - min(len(ix), 64), -1)]).astype(np.int32)
        T = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
        _reset_counts()
        res = repair_step(st.poses, st.covariances, st.constraints,
                          int(entry.correction_type),
                          T(o.selected_points.astype(np.float32)), T(gmask),
                          int(group[-1]), T(pad(anch)), T(pad(corr)),
                          o.backprop_start, o.backprop_end, 0,
                          lm_config=LMConfig(max_iterations=20))
        iters = int(res.lm.iterations)
        if dev == DEVICE:
            check(B.launches.count == iters,
                  f"repair_step: bcr launches {B.launches.count} != LM "
                  f"iterations {iters}")
        out[dev] = (res.poses.cpu().numpy(), iters,
                    int(res.num_new_constraints))
    dxy, dth = pose_errors(out[DEVICE][0], out["cpu"][0])
    check(dxy <= LOOSE[0] and dth <= LOOSE[1],
          f"repair_step: card vs CPU {dxy:.3e} m / {dth:.3e} rad")
    log(f"[replicas] repair_step on the golden map's first correction: "
        f"LM iterations {out[DEVICE][1]} (CPU {out['cpu'][1]}), "
        f"{out[DEVICE][2]} rows, card vs CPU {dxy:.3e} m / {dth:.3e} rad")
    return dict(lm_iterations=out[DEVICE][1], card_vs_cpu=[dxy, dth])


def _native_on_card_host(bag, tmp):
    """The native host libraries build on this machine, and their parses
    equal the Python paths: both golden maps, and phase 10's bag."""
    import gzip

    import numpy as np

    from hitl_slam_torch import native
    from hitl_slam_torch.io import rosbag, stfs

    check(native.available() and native.bag_available(),
          "native: a library did not build")
    plain = os.path.join(tmp, "golden_large.stfs.covars")
    with gzip.open(os.path.join(DATA, "golden_large.stfs.covars.gz")) as f, \
            open(plain, "wb") as g:
        g.write(f.read())
    for path in (os.path.join(DATA, "golden.stfs.covars"), plain):
        check(native.parse_stfs_file(path) is not None,
              f"native: {path} fell back")
        a = stfs.load_stfs_covars(path, use_native=True)
        b = stfs.load_stfs_covars(path, use_native=False)
        same = (np.array_equal(a.poses, b.poses)
                and np.array_equal(a.covariances, b.covariances)
                and all(np.array_equal(x, y) for x, y in
                        zip(a.point_clouds, b.point_clouds)))
        check(same, f"native: {path} parses differently")
    nat = list(rosbag.read_messages(bag, use_native=True))
    py = list(rosbag.read_messages(bag, use_native=False))
    check(len(nat) == len(py) > 0 and all(
        (x.topic, x.time, x.raw) == (y.topic, y.time, y.raw)
        for x, y in zip(nat, py)), "native: the bag reads differently")
    log(f"[native] both libraries built; golden maps parse equal; the bag's "
        f"{len(nat)} messages equal")
    return dict(stfs=True, bag_messages=len(nat))


def phase_replicas(torch, smi, repaired, small, small_log, bag, tmp):
    """The replica batch on the card (the slice's main path), the batched
    kernel against lone launches and its twin, repair_step, and the native
    libraries. Returns the `replicas` record, the batched launches, the
    batched route's worst error and times, and the batch's LMResult."""
    import numpy as np

    from hitl_slam_torch.parallel.replicas import (batched_solve,
                                                   build_problems,
                                                   make_perturbed_replicas,
                                                   replica_program)
    from hitl_slam_torch.solver import bcr_kernel as B, lm
    from hitl_slam_torch.solver.lm import LMConfig

    config = LMConfig(max_iterations=REPLICA_ITERS)
    poses = repaired.poses.cpu().numpy()
    reps, tb = make_perturbed_replicas(poses, repaired.constraints, REPLICAS,
                                       seed=0)
    P = poses.shape[0]
    check(reps.device.type == torch.device(DEVICE).type
          and reps.shape == (REPLICAS, P, 3),
          f"replicas: {tuple(reps.shape)} on {reps.device}")
    batched_solve(reps, tb, config, device=DEVICE)    # warm-up
    torch.cuda.synchronize()
    # ---- 1. the replica batch: the slice's main path ----
    _reset_counts()
    t0 = time.perf_counter()
    out = batched_solve(reps, tb, config, device=DEVICE)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    n_em, n_lone = _read_counts()
    n_batched = B.batched_launches.count
    iters = out.iterations.cpu().numpy()
    c0, c1 = out.initial_cost.cpu().numpy(), out.final_cost.cpu().numpy()
    steps = int(iters.max())
    check(np.isfinite(c1).all() and (c1 <= c0).all(),
          f"replicas: a cost went up or is not finite: {c0} -> {c1}")
    check(n_batched == steps and n_lone == 0 and n_em == 0,
          f"replicas: batched bcr launches {n_batched} != {steps} steps "
          f"(lone {n_lone}, em_scan {n_em})")
    check(np.isfinite(out.poses.cpu().numpy()).all(), "replicas: poses")
    # ---- each of 4 replicas against its lone solve ----
    picks = sorted(np.random.default_rng(0).choice(REPLICAS, 4,
                                                   replace=False).tolist())
    prob_b = build_problems(reps, tb)
    acc_b = []
    ref = lm.solve_batched(prob_b, reps, config, accepts=acc_b)
    acc_b = torch.stack(acc_b).cpu().numpy()
    check(torch.equal(ref.iterations, out.iterations),
          "replicas: a second batched solve gave other iteration counts")
    worst_pose = 0.0
    for r in picks:
        lone, acc = _replica_lone(reps, tb, r, config)
        k = int(lone.iterations)
        check(k == int(iters[r]) and acc == acc_b[:k, r].tolist(),
              f"replica {r}: lone {k} iterations {acc}, batched "
              f"{int(iters[r])} {acc_b[:, r].tolist()}")
        dxy, dth = pose_errors(lone.poses.cpu().numpy(),
                               out.poses[r].cpu().numpy())
        check(max(dxy, dth) <= REPLICA_POSE_TOL,
              f"replica {r}: lone vs batched {dxy:.3e} m / {dth:.3e} rad")
        worst_pose = max(worst_pose, dxy, dth)
    # ---- the same 32 solves one after another ----
    def lone_all():
        for r in range(REPLICAS):
            _replica_lone(reps, tb, r, config)

    lone_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lone_all()
    torch.cuda.synchronize()
    lone_ms = (time.perf_counter() - t0) * 1e3
    check(wall_ms <= lone_ms,
          f"replicas: batched {wall_ms:.1f} ms above {REPLICAS} lone solves "
          f"{lone_ms:.1f} ms")
    # the batch's program: its operations counted from the graph (the busy
    # share is not measured: BUSY_NOT_MEASURED)
    g = replica_program(reps, tb, config).graph()
    body = sum(g.body_nodes)
    ops = g.nodes - body + body * steps
    rec = dict(B=REPLICAS, n=P, max_iterations=REPLICA_ITERS,
               wall_ms=wall_ms, lone_wall_ms=lone_ms,
               solves_per_s=REPLICAS / wall_ms * 1e3,
               iterations=dict(min=int(iters.min()),
                               median=float(np.median(iters)),
                               max=int(iters.max())),
               steps=steps, launches_bcr_batched=n_batched,
               graph_ops=ops, busy_share=None,
               sampled=picks, lone_vs_batched=worst_pose,
               cost_initial_mean=float(c0.mean()),
               cost_final_mean=float(c1.mean()))
    log(f"[replicas] B={REPLICAS} n={P}: batched {wall_ms:.2f} ms "
        f"({rec['solves_per_s']:.1f} solves/s), {REPLICAS} lone solves "
        f"{lone_ms:.2f} ms; iterations min/median/max "
        f"{int(iters.min())}/{float(np.median(iters))}/{int(iters.max())}; "
        f"batched bcr launches {n_batched} = steps; replicas {picks} equal "
        f"their lone solves (<= {worst_pose:.3e}); a replay {ops} graph "
        f"operations, {BUSY_NOT_MEASURED} ({smi})")
    # ---- 2. the batched kernel on the first step's systems and others ----
    first = []

    def record(D, U, b):
        first.append((D.clone(), U.clone(), b.clone()))
        return B.bcr_solve_cuda_batched(D, U, b)

    lm.solve_batched(prob_b, reps, LMConfig(max_iterations=1),
                     linear_solver=record, eager=True)
    err, times = _batched_bcr_checks(torch, first[0])
    # ---- 3. repair_step on the card ----
    rec["repair_step"] = _repair_on_card(torch, small, small_log)
    # ---- 4. the native libraries ----
    rec["native"] = _native_on_card_host(bag, tmp)
    rec["card"] = smi
    return rec, n_batched, err, times, out


# ---------------------------------------------------------------- phase 16

# the multi route's checks and times beyond the sharded shapes: (n, S)
# systems of _spd_system, each against MULTI_RHS right-hand sides; n = 16384
# and 32768 take the levels route (a cluster holds 8192 lanes at R = 7)
MULTI_RHS = 7
MULTI_BCR = ((64, 8), (1024, 8), (16384, 4), (32768, 2))


def _multi_case(torch, what, D, U, b, timed: bool):
    """The multi route on S systems (D [S,n,3,3], U [S,n-1,3,3] as handed,
    b [S,n,3,R]) against lone launches on each column (bit-equal) and its
    plain twin (BCR_RTOL). Returns (error against the twin, and where
    `timed` its times: events, profiler device ms, the plain twin, the
    bound of the function, the dense library solve [S, 3n, 3n] against R
    columns where it fits in DENSE_MAX_BYTES, and the old call that PR 9's
    SPIKE made for the same function: D and U copied R times, the batched
    route on S * R systems, the right-hand sides permuted)."""
    from hitl_slam_torch.solver import bcr_kernel as B

    S, n, R = D.shape[0], D.shape[1], b.shape[-1]
    x = B.bcr_solve_cuda_multi(D, U, b)
    lone = torch.stack([torch.stack([
        B.bcr_solve_cuda(D[s], U[s].contiguous(), b[s, :, :, c].contiguous())
        for c in range(R)], -1) for s in range(S)])
    twin = B.bcr_solve_multi_reference(D, U, b)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(x).all()), f"{what}: non-finite")
    scale = max(1.0, float(x.abs().max()))
    d_lone = float((x - lone).abs().max())
    check(torch.equal(x, lone),
          f"{what}: multi x differs from lone launches by {d_lone:.3e} "
          f"(max|x| {scale:.3f})")
    err = float((x - twin).abs().max())
    check(err <= BCR_RTOL * scale,
          f"{what}: multi kernel vs twin {err:.3e} > {BCR_RTOL * scale:.3e}")
    plan = B.launch_plan(n, R)
    log(f"[bcr multi] {what}: S={S} n={n} R={R}, {plan.route} of "
        f"{plan.blocks} x {S} (top {plan.top}, {plan.lanes_per_block} lanes "
        f"and {plan.threads} threads a block, {plan.smem_bytes} B shared), "
        f"each column bit-equal to a lone launch, max|multi-plain| "
        f"{err:.3e} (max|x| {scale:.3f})")
    if not timed:
        return err, None

    def old():
        x7 = B.bcr_solve_cuda_batched(
            D[:, None].expand(S, R, n, 3, 3).reshape(S * R, n, 3, 3),
            U[:, None].expand(S, R, n - 1, 3, 3).reshape(S * R, n - 1, 3, 3),
            b.permute(0, 3, 1, 2).reshape(S * R, n, 3))
        return x7.reshape(S, R, n, 3).permute(0, 2, 3, 1)

    fn = lambda: B.bcr_solve_cuda_multi(D, U, b)   # noqa: E731
    ms = time_cuda(fn, 50)
    per_launch, dev_ms, _ = device_ms(fn, "bcr_multi")
    old_ms = time_cuda(old, 50)
    old_launch, old_kernel_ms, old_all_ms = device_ms(old, "bcr_")
    plain_ms = time_cuda(lambda: B.bcr_solve_multi_reference(D, U, b), 5)
    bound_ms, bound_by = bound(*bcr_work(n, S, R))
    t = dict(S=S, n=n, rhs=R, plan_route=plan.route, blocks=plan.blocks * S,
             ms=ms, device_ms=dev_ms, device_ms_per_launch=per_launch,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=None,
             old_copies_call=dict(ms=old_ms, device_ms_per_launch=old_launch,
                                  kernel_device_ms=old_kernel_ms,
                                  all_device_ms=old_all_ms, B=S * R))
    if S * (3 * n) ** 2 * 4 <= DENSE_MAX_BYTES:
        dense = [_dense_system(torch, D[s], U[s].contiguous(), b[s, :, :, 0])
                 for s in range(S)]
        H = torch.stack([h for h, _ in dense])
        del dense
        cols = b.reshape(S, 3 * n, R)
        t["library_ms"] = time_cuda(lambda: torch.linalg.solve(H, cols), 3,
                                    warmup=1)
        del H
    log(f"[time] bcr multi S={S} n={n} R={R} ({what}): events {ms:.5f} ms, "
        f"device {dev_ms:.5f} ms a call ({per_launch:.5f} a launch), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})"
        + (f", dense torch.linalg.solve [{S}, {3 * n}, {3 * n}] x {R} "
           f"columns {t['library_ms']:.3f} ms" if t["library_ms"] else "")
        + f"; the old call (copies, batched B={S * R}): events {old_ms:.5f} "
        f"ms, device {old_launch:.5f} ms a launch, {old_all_ms:.5f} ms of "
        f"device operations a call")
    return err, t


def _multi_bcr_checks(torch):
    """The multi route on MULTI_BCR's sets: checks at each, times at each
    but 32768. Returns (worst error against the twin, {n: times})."""
    import numpy as np

    worst, times = 0.0, {}
    for n, S in MULTI_BCR:
        sys_ = [_spd_system(n + 1, seed=3000 * n + s) for s in range(S)]
        D = torch.as_tensor(np.stack([q[0][:n] for q in sys_]),
                            dtype=torch.float32, device=DEVICE)
        # U as the SPIKE hands it: a view [:, :-1] of [S, n, 3, 3]
        U = torch.as_tensor(np.stack([q[1] for q in sys_]),
                            dtype=torch.float32, device=DEVICE)[:, :-1]
        rng = np.random.default_rng(n)
        b = torch.as_tensor(rng.normal(size=(S, n, 3, MULTI_RHS)),
                            dtype=torch.float32, device=DEVICE)
        err, t = _multi_case(torch, f"spd n={n} S={S}", D, U, b,
                             timed=n != 32768)
        worst = max(worst, err)
        if t is not None:
            times[n] = t
    return worst, times


# the sharded LM on the repaired 1024-pose map: partitions of the meshes
# [cuda:0] x d, and the reference's criteria against the lone solve
# (tests/test_parallel.py): cost <= 1.05 x + 1e-4, poses within 2e-2
MESH_PARTITIONS = (4, 8)
MESH_ITERS = 20
MESH_COST_FACTOR, MESH_COST_ABS, MESH_POSE_TOL = 1.05, 1e-4, 2e-2
# the same sharded solve on the CPU: poses within this, final cost within
# this relative (f32 round-off of the card's reductions, sin/cos and LU
# against the CPU's). On the repaired map the LM ends at the f32 noise floor
# of the cost (accepts of a decrease below the cost's resolution), so its
# iteration count is decided by round-off, for the lone lm.solve as well
# (9 iterations on an H100, 11 on its host's CPU): a differing count there
# is reported with its input, the lone solve's counts and both runs' trial
# costs, and the count is held on the next input
MESH_CPU_POSE_TOL, MESH_CPU_COST_RTOL = 1e-4, 1e-5
# the iteration count, card against CPU, on an input whose LM ends on real
# decreases: this replica of phase 15 (the repaired map perturbed, seed 0).
# On the CPU its sharded LM ends after 6 accepts at d = 4 and 8, in f32 as
# in f64, the last two decreases 7.9e-6 and 3.6e-7 of the cost, either
# side of the 1e-6 function tolerance. Its poses are held to a looser bound
# than the repaired map's: f32 round-off puts the CPU's f32 solve 1.7e-4
# from its f64 solve on this input
MESH_COUNT_REPLICA, MESH_COUNT_POSE_TOL = 0, 1e-3
# the collective volume bounds of tests/test_parallel.py, a partition an
# iteration: gathered floats (the reduced coefficients and the sums), and
# the floats of one shift
MESH_GATHER_MAX, MESH_SHIFT_MAX = 64, 16
# the long chain: tests/test_parallel.py's generators at 16384 poses, seed 0
MESH_CHAIN_POSES, MESH_CHAIN_PARTITIONS = 16384, 8
# the checkerboard's mesh branch against mesh=None on the test-size stream
# (tests/test_parallel.py's tolerance) and its replica entries
MESH_CB_TOL, MESH_CB_ENTRIES = 1e-4, 4
# the replica batch on a replica mesh of this many entries
MESH_REPLICA_ENTRIES = 4


def _on(value, device):
    """A (nested) dataclass of tensors with every tensor on `device`."""
    import dataclasses

    import torch

    if isinstance(value, torch.Tensor):
        return value.to(device)
    if dataclasses.is_dataclass(value):
        return type(value)(**{f.name: _on(getattr(value, f.name), device)
                              for f in dataclasses.fields(value)})
    return value


def _sharded_run(torch, mesh, problem, poses, config):
    """One eager sharded solve on the card (`eager=True`: the collective
    counter counts what Python runs, which a replay does not), its counts
    zeroed just before and read just after: (result, wall ms, (multi,
    batched) BCR launches, lone BCR and em_scan launches, collective
    counts)."""
    from hitl_slam_torch.parallel import mesh as M
    from hitl_slam_torch.parallel.sharded_solver import sharded_lm_solve
    from hitl_slam_torch.solver import bcr_kernel as B

    torch.cuda.synchronize()
    _reset_counts()
    M.collectives.reset()
    t0 = time.perf_counter()
    res = sharded_lm_solve(mesh, problem, poses, config, eager=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    c = M.collectives
    return (res, wall, (B.multi_launches.count, B.batched_launches.count),
            _read_counts(),
            dict(calls=dict(c.calls), floats=dict(c.floats),
                 largest=dict(c.largest)))


def _trial_costs(mesh, problem, poses, config) -> list[float]:
    """The global cost of a sharded solve at its start and at each trial
    point, in order (a trial is accepted where its cost is below the
    current one): read through a spy on the solver's assembly in an eager
    solve."""
    from hitl_slam_torch.parallel import sharded_solver as S

    seen, real = [], S._local_assemble

    def spy(*args):
        out = real(*args)
        seen.append(out[3][0])
        return out

    S._local_assemble = spy
    try:
        S.sharded_lm_solve(mesh, problem, poses, config, eager=True)
    finally:
        S._local_assemble = real
    return [float(c) for c in seen]


def _check_sharded(name, res, lone, counts, others, coll,
                   converged=True, groups=1):
    """The reference's criteria against the lone solve (its pose criterion
    only where both solves converge within the iteration cap), one launch
    of the multi BCR route a device group an iteration and nothing else
    (no batched, lone BCR or em_scan launch), and the collective volume."""
    n_multi, n_batched = counts
    it = int(res.iterations)
    cost, lone_cost = float(res.final_cost), float(lone.final_cost)
    dpose = float((res.poses - lone.poses).abs().max())
    import torch

    check(bool(torch.isfinite(res.poses).all()), f"{name}: poses not finite")
    check(cost <= lone_cost * MESH_COST_FACTOR + MESH_COST_ABS,
          f"{name}: cost {cost:.6e} above the lone solve's {lone_cost:.6e}"
          f" x {MESH_COST_FACTOR} + {MESH_COST_ABS}")
    check(dpose <= MESH_POSE_TOL or not converged,
          f"{name}: poses {dpose:.3e} from the lone solve's")
    check(cost <= float(res.initial_cost), f"{name}: the cost went up")
    check(n_multi == it * groups and n_batched == 0 and others == (0, 0),
          f"{name}: multi bcr launches {n_multi} != {it} iterations x "
          f"{groups} device groups (batched bcr {n_batched}, em_scan and "
          f"lone bcr {others})")
    gathered = (coll["floats"]["gather"] + coll["floats"]["sum"]) / max(it, 1)
    check(gathered <= MESH_GATHER_MAX
          and coll["largest"]["shift"] <= MESH_SHIFT_MAX,
          f"{name}: collective volume {gathered} gathered floats a partition "
          f"an iteration, {coll['largest']['shift']} a shift")
    return dict(iterations=it, final_cost=cost, lone_final_cost=lone_cost,
                initial_cost=float(res.initial_cost),
                pose_diff_lone=dpose, launches_bcr_multi=n_multi,
                launches_bcr_batched=n_batched,
                gathered_floats_per_iteration=gathered,
                largest_shift_floats=coll["largest"]["shift"],
                collectives=coll)


def _np_table(table) -> dict:
    """The f64 baselines' table dict of a ConstraintTable."""
    from hitl_slam_torch.core.state import table_to_numpy

    t = table_to_numpy(table)
    return dict(ctype=t["ctype"], constrained=t["constrained"],
                anchor=t["anchor"], dpar=t["delta_parallel"],
                dperp=t["delta_perpendicular"], dth=t["delta_angle"],
                pen=t["penalty_dir"], active=t["active"])


def _sharded_over_cards(torch, repaired, config):
    """Phase 16 (e): the sharded LM on the repaired map with one partition a
    card (make_mesh's default devices), against the lone solve on card 0,
    where the machine has several cards that divide the poses; else None,
    and said so."""
    from hitl_slam_torch.parallel import sharded_solver as S
    from hitl_slam_torch.parallel.mesh import make_mesh
    from hitl_slam_torch.solver import joint, lm

    k = torch.cuda.device_count()
    if k < 2 or repaired.num_poses % k:
        log(f"[mesh] did not run: one partition a card needs more than one "
            f"card dividing {repaired.num_poses} poses; this machine has {k}")
        return None
    mesh = make_mesh(1, k)
    problem = joint.build_problem(repaired.poses, repaired.constraints)
    lone = lm.solve(problem, repaired.poses, config)
    S.sharded_lm_solve(mesh, problem, repaired.poses, config,
                       eager=True)                            # warm-up
    res, wall, counts, others, coll = _sharded_run(
        torch, mesh, problem, repaired.poses, config)
    rec = _check_sharded(f"sharded over {k} cards", res, lone, counts,
                         others, coll, groups=k)
    rec.update(wall_ms=wall, cards=k, devices=[
        torch.cuda.get_device_name(i) for i in range(k)])
    log(f"[mesh] ran: sharded LM one partition a card over {k} cards: "
        f"{rec['iterations']} iterations in {wall:.2f} ms, cost "
        f"{rec['final_cost']:.6e} (lone {rec['lone_final_cost']:.6e}), poses "
        f"{rec['pose_diff_lone']:.3e} from the lone solve's, multi bcr "
        f"launches {counts[0]} (one a card an iteration, S = 1, R = 7)")
    return rec


def phase_mesh(torch, smi, repaired, stream, scale, replica_out):
    """The multi-device layer on the card: the sharded LM at full width on
    meshes that repeat the card, its BCR systems against the kernel's plain
    version, the 16384-pose chain against the f64 baseline, the replica
    batch placed on a replica mesh, the checkerboard's mesh branch, and
    the same sharded LM one partition a card where there are several.
    Returns the `mesh` record, the multi BCR launches of the sharded runs,
    the worst error of the multi route against its twin and its times (at
    the sharded shapes and at MULTI_BCR's)."""
    import numpy as np

    from hitl_slam_torch.baselines.cpu_lm import cpu_lm_solve
    from hitl_slam_torch.bench import seeded_chain
    from hitl_slam_torch.models.enml import localizer as L
    from hitl_slam_torch.models.enml import parallel_localizer as CB
    from hitl_slam_torch.models.enml.driver import consistency_metric
    from hitl_slam_torch.parallel import sharded_solver as S
    from hitl_slam_torch.parallel.mesh import make_mesh
    from hitl_slam_torch.parallel.replicas import (batched_solve,
                                                   make_perturbed_replicas,
                                                   replica_table,
                                                   shard_replicas)
    from hitl_slam_torch.solver import bcr_kernel as B, joint, lm
    from hitl_slam_torch.solver.lm import LMConfig

    card = torch.device(DEVICE, 0)
    config = LMConfig(max_iterations=MESH_ITERS)
    out = {"card": smi, "device_count": torch.cuda.device_count()}
    n_sharded, worst, times = 0, 0.0, {}

    def lone_solve(problem, poses):
        lm.solve(problem, poses, config)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lm.solve(problem, poses, config)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def record_systems(mesh, problem, poses):
        """The first iteration's multi BCR call of a sharded solve, its
        tensors cloned with their layout (U a view of the partitions'
        couplings)."""
        seen, real = [], B.bcr_solve_multi

        def spy(D, U, b):
            Ufull = torch.empty((U.shape[0], U.shape[1] + 1, 3, 3),
                                dtype=U.dtype, device=U.device)
            Ufull[:, :-1] = U
            seen.append((D.clone(), Ufull[:, :-1], b.clone()))
            return real(D, U, b)

        B.bcr_solve_multi = spy
        try:
            S.sharded_lm_solve(mesh, problem, poses, LMConfig(
                max_iterations=1), eager=True)
        finally:
            B.bcr_solve_multi = real
        return seen[0]

    # ---- (a) the repaired 1024-pose map on [cuda:0] x d ----
    poses = repaired.poses
    problem = joint.build_problem(poses, repaired.constraints)
    lone, lone_ms = lone_solve(problem, poses)
    # the CPU solves the card's problem: the same input floats
    cpu_problem = _on(problem, "cpu")
    out["map"] = {"poses": int(poses.shape[0]), "lone_wall_ms": lone_ms,
                  "lone_iterations": int(lone.iterations)}
    cpu_lone = int(lm.solve(cpu_problem, poses.cpu(), config).iterations)
    out["map"]["lone_cpu_iterations"] = cpu_lone
    for d in MESH_PARTITIONS:
        mesh = make_mesh(1, d, [card] * d)
        cpu_mesh = make_mesh(1, d, [torch.device("cpu")] * d)
        S.sharded_lm_solve(mesh, problem, poses, config,
                           eager=True)                        # warm-up
        res, wall, counts, others, coll = _sharded_run(torch, mesh, problem,
                                                       poses, config)
        rec = _check_sharded(f"sharded d={d}", res, lone, counts, others,
                             coll)
        n_sharded += counts[0]
        cpu = S.sharded_lm_solve(cpu_mesh, cpu_problem, poses.cpu(), config)
        dcpu = float((res.poses.cpu() - cpu.poses).abs().max())
        dcost = abs(float(cpu.final_cost) - rec["final_cost"]) / max(
            abs(float(cpu.final_cost)), 1e-30)
        check(dcpu <= MESH_CPU_POSE_TOL and dcost <= MESH_CPU_COST_RTOL,
              f"sharded d={d}: card poses {dcpu:.3e} and cost {dcost:.3e} "
              f"(relative) from the CPU's")
        dev_ms, ops = _device_only_profile(
            torch, lambda: S.sharded_lm_solve(mesh, problem, poses, config,
                                              eager=True))
        rec.update(wall_ms=wall, card_vs_cpu=dcpu, card_vs_cpu_cost=dcost,
                   device_ms=dev_ms, device_ops=ops, busy_share=dev_ms / wall,
                   launches_per_iteration=ops / rec["iterations"],
                   cpu_iterations=int(cpu.iterations))
        if int(cpu.iterations) != rec["iterations"]:
            rec["iteration_flip"] = dict(
                input="the repaired golden_large map of phase 4",
                lone_card=int(lone.iterations), lone_cpu=cpu_lone,
                trial_costs_card=_trial_costs(mesh, problem, poses, config),
                trial_costs_cpu=_trial_costs(cpu_mesh, cpu_problem,
                                             poses.cpu(), config))
            f = rec["iteration_flip"]
            log(f"[mesh] FLIP sharded d={d}: {rec['iterations']} iterations "
                f"on the card, {int(cpu.iterations)} on the CPU, on "
                f"{f['input']}; trial costs on the card "
                f"{[f'{c:.9e}' for c in f['trial_costs_card']]}, on the CPU "
                f"{[f'{c:.9e}' for c in f['trial_costs_cpu']]}; the lone "
                f"lm.solve on the same input: {f['lone_card']} on the card, "
                f"{f['lone_cpu']} on the CPU")
        D, U, b = record_systems(mesh, problem, poses)
        err, t = _multi_case(torch, f"sharded d={d} first step", D, U, b,
                             timed=True)
        worst = max(worst, err)
        times[d] = t
        rec["bcr_multi"] = t
        out["map"][f"d{d}"] = rec
        log(f"[mesh] sharded LM, {poses.shape[0]} poses on [cuda:0] x {d}: "
            f"{rec['iterations']} iterations in {wall:.2f} ms (lone solve "
            f"{int(lone.iterations)} in {lone_ms:.2f} ms); cost "
            f"{rec['final_cost']:.6e} (lone {rec['lone_final_cost']:.6e}), "
            f"poses {rec['pose_diff_lone']:.3e} from the lone solve's, "
            f"{dcpu:.3e} from the CPU's ({int(cpu.iterations)} iterations); "
            f"multi bcr launches {counts[0]} = iterations, batched "
            f"{counts[1]} (S = {d}, n = {poses.shape[0] // d}, R = 7); "
            f"{rec['gathered_floats_per_iteration']:.1f}"
            f" gathered floats a partition an iteration, shifts of at most "
            f"{rec['largest_shift_floats']}; device {dev_ms:.2f} ms in {ops} "
            f"operations ({ops / rec['iterations']:.0f} an iteration), busy "
            f"{100 * dev_ms / wall:.1f} % ({smi})")

    # ---- (a) the iteration count on a replica of phase 15 ----
    reps, tb = make_perturbed_replicas(repaired.poses.cpu().numpy(),
                                       repaired.constraints, REPLICAS, seed=0)
    r = MESH_COUNT_REPLICA
    rposes = torch.as_tensor(reps[r], device=card)
    problem = joint.build_problem(rposes, replica_table(tb, r))
    cpu_problem = _on(problem, "cpu")
    rlone, _ = lone_solve(problem, rposes)
    out["replica"] = {"replica": r, "lone_iterations": int(rlone.iterations)}
    for d in MESH_PARTITIONS:
        mesh = make_mesh(1, d, [card] * d)
        res, wall, counts, others, coll = _sharded_run(torch, mesh, problem,
                                                       rposes, config)
        rec = _check_sharded(f"replica {r} d={d}", res, rlone, counts,
                             others, coll)
        n_sharded += counts[0]
        cpu = S.sharded_lm_solve(make_mesh(1, d, [torch.device("cpu")] * d),
                                 cpu_problem, rposes.cpu(), config)
        dcpu = float((res.poses.cpu() - cpu.poses).abs().max())
        dcost = abs(float(cpu.final_cost) - rec["final_cost"]) / max(
            abs(float(cpu.final_cost)), 1e-30)
        check(int(cpu.iterations) == rec["iterations"]
              and dcpu <= MESH_COUNT_POSE_TOL and dcost <= MESH_CPU_COST_RTOL,
              f"replica {r} d={d}: {rec['iterations']} iterations on the "
              f"card, {int(cpu.iterations)} on the CPU; poses {dcpu:.3e} and "
              f"cost {dcost:.3e} (relative) from the CPU's")
        rec.update(wall_ms=wall, cpu_iterations=int(cpu.iterations),
                   card_vs_cpu=dcpu, card_vs_cpu_cost=dcost)
        out["replica"][f"d{d}"] = rec
        log(f"[mesh] sharded LM, replica {r} of phase 15 on [cuda:0] x {d}: "
            f"{rec['iterations']} iterations on the card = "
            f"{int(cpu.iterations)} on the CPU (lone solve "
            f"{int(rlone.iterations)}); cost {rec['final_cost']:.6e} from "
            f"{rec['initial_cost']:.6e}, {dcost:.3e} (relative) from the "
            f"CPU's; poses {dcpu:.3e} from the CPU's, "
            f"{rec['pose_diff_lone']:.3e} from the lone solve's; multi bcr "
            f"launches {counts[0]}, batched {counts[1]}; {wall:.2f} ms")

    # ---- (b) the 16384-pose chain, d = 8, against the f64 baseline ----
    d = MESH_CHAIN_PARTITIONS
    chain_np, table = seeded_chain(MESH_CHAIN_POSES, 0, card)
    chain = torch.as_tensor(chain_np, device=card)
    problem = joint.build_problem(chain, table)
    mesh = make_mesh(1, d, [card] * d)
    lone, lone_ms = lone_solve(problem, chain)
    S.sharded_lm_solve(mesh, problem, chain, config,
                       eager=True)                            # warm-up
    res, wall, counts, others, coll = _sharded_run(torch, mesh, problem,
                                                   chain, config)
    # 20 iterations stop both solves short of the optimum of so long a
    # chain (on the CPU at 1024 poses: 1.26 m apart after 20 iterations,
    # 0.021 m after both converged), so their poses are not compared
    rec = _check_sharded(f"chain d={d}", res, lone, counts, others, coll,
                         converged=False)
    n_sharded += counts[0]
    t0 = time.perf_counter()
    _, f64_cost, f64_iters = cpu_lm_solve(chain_np, _np_table(table),
                                          max_iterations=MESH_ITERS)
    f64_s = time.perf_counter() - t0
    rel = abs(rec["final_cost"] - f64_cost) / f64_cost
    lone_rel = abs(rec["lone_final_cost"] - f64_cost) / f64_cost
    D, U, b = record_systems(mesh, problem, chain)
    err, t = _multi_case(torch, f"chain d={d} first step", D, U, b,
                         timed=True)
    worst = max(worst, err)
    times["chain"] = t
    rec.update(poses=MESH_CHAIN_POSES, partitions=d, wall_ms=wall,
               lone_wall_ms=lone_ms, lone_iterations=int(lone.iterations),
               f64_cost=float(f64_cost), f64_iterations=int(f64_iters),
               f64_wall_s=f64_s, cost_rel_f64=rel, lone_cost_rel_f64=lone_rel,
               bcr_multi=t)
    out["chain"] = rec
    log(f"[mesh] sharded LM, {MESH_CHAIN_POSES}-pose chain on [cuda:0] x "
        f"{d}: {rec['iterations']} iterations in {wall:.2f} ms, lone solve "
        f"{int(lone.iterations)} in {lone_ms:.2f} ms; cost "
        f"{rec['final_cost']:.6e}, lone {rec['lone_final_cost']:.6e}, f64 "
        f"cpu_lm_solve {f64_cost:.6e} ({f64_iters} iterations, {f64_s:.2f} "
        f"s): relative {rel:.3e} (lone {lone_rel:.3e}); multi bcr launches "
        f"{counts[0]}, batched {counts[1]} (S = {d}, n = "
        f"{MESH_CHAIN_POSES // d}, R = 7) ({smi})")

    # ---- (c) the replica batch of phase 15 on a replica mesh ----
    rmesh = make_mesh(MESH_REPLICA_ENTRIES, 1, [card] * MESH_REPLICA_ENTRIES)
    _reset_counts()
    got = batched_solve(*shard_replicas(rmesh, reps, tb),
                        LMConfig(max_iterations=REPLICA_ITERS), device=DEVICE)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(got, k), getattr(replica_out, k))
               for k in ("poses", "final_cost", "iterations", "converged"))
    check(same, "replicas on the replica mesh differ from phase 15's batch")
    out["replicas"] = dict(entries=MESH_REPLICA_ENTRIES, bit_equal=same,
                           launches_bcr_batched=B.batched_launches.count)
    log(f"[mesh] {REPLICAS} replicas placed on [cuda:0] x "
        f"{MESH_REPLICA_ENTRIES} (replica axis): bit-equal to phase 15's "
        f"batch")

    # ---- (d) the checkerboard's mesh branch ----
    o = L.EnmlOptions()
    st, _, _, _ = _episode_state(stream, DEVICE)
    args = (st.points, st.normals, st.point_mask, st.poses)
    cmesh = make_mesh(MESH_CB_ENTRIES, 1, [card] * MESH_CB_ENTRIES)
    p1, c1 = CB.checkerboard_localize(*args, o)
    pm, cm = CB.checkerboard_localize(*args, o, mesh=cmesh)
    _sync()
    dp = float((pm - p1).abs().max())
    dc = float((cm - c1).abs().max())
    check(dp <= MESH_CB_TOL and dc <= MESH_CB_TOL,
          f"checkerboard mesh branch: {dp:.3e} (poses), {dc:.3e} "
          f"(covariances) from mesh=None")
    sst = scale["state"]
    sargs = (sst.points, sst.normals, sst.point_mask, sst.poses)
    P = sst.num_poses
    CB.checkerboard_localize(*(a[:4 * 10] for a in sargs), o, mesh=cmesh)
    _sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ps, cs = CB.checkerboard_localize(*sargs, o, mesh=cmesh)
    _sync()
    wall_s = time.perf_counter() - t0
    peak = _peak_memory_mb(torch)
    pn, _ = CB.checkerboard_localize(*sargs, o, chunk=16)
    ps_np = ps.cpu().numpy()
    check(np.isfinite(ps_np).all() and bool(torch.isfinite(cs).all()),
          "checkerboard mesh branch, scale map: not finite")
    sub = slice(0, P, 16)
    before = consistency_metric(scale["poses0"][sub], scale["pcs"][sub])
    after = consistency_metric(ps_np[sub], scale["pcs"][sub])
    check(after <= 1.05 * before,
          f"checkerboard mesh branch, scale map: consistency {before:.4f} -> "
          f"{after:.4f}")
    dscale = float((ps - pn).abs().max())
    out["checkerboard"] = dict(
        entries=MESH_CB_ENTRIES, test_size_pose_diff=dp, test_size_cov_diff=dc,
        scale=dict(nodes=P, W=o.max_history, wall_s=wall_s,
                   ms_per_node=wall_s * 1e3 / P, peak_mib=peak,
                   consistency=[before, after], from_chunked=dscale))
    log(f"[mesh] checkerboard mesh branch on [cuda:0] x {MESH_CB_ENTRIES}: "
        f"test size {dp:.3e} m / {dc:.3e} (covariances) from mesh=None; "
        f"scale map ({P} nodes, W = {o.max_history}, every window of a "
        f"parity in one batch) {wall_s:.3f} s, {wall_s * 1e3 / P:.3f} ms a "
        f"node, peak memory {peak:.0f} MiB, consistency {before:.4f} -> "
        f"{after:.4f}, {dscale:.3e} from the chunked run ({smi})")

    # ---- (e) one partition a card, where there are several ----
    out["cards"] = _sharded_over_cards(torch, repaired, config)

    # ---- the multi route beyond the sharded shapes ----
    err, spd_times = _multi_bcr_checks(torch)
    worst = max(worst, err)
    times.update(spd_times)
    return out, n_sharded, worst, times


# ---------------------------------------------------------------- phase 17

SCALE_FIXTURE = os.path.join(DATA, "scale_sessions_jax")
# what phase 17 reads of the JAX package's record (scripts/
# make_scale_fixture.py): per session in the JSON, and the arrays
SCALE_FIXTURE_KEYS = {
    "headline": ("accepted", "lm_iterations", "rows", "chain"),
    "s8192": ("accepted", "lm_iterations", "rows", "gt_mean", "refine"),
    "s16384": ("accepted", "lm_iterations", "rows", "gt_mean", "f64"),
}
SCALE_FIXTURE_ARRAYS = ("headline_poses", "s8192_poses", "s16384_poses") + \
    tuple(f"s8192_table_{k}" for k in (
        "ctype", "constrained", "anchor", "delta_parallel",
        "delta_perpendicular", "delta_angle", "penalty_dir", "active"))
# the sessions' ground-truth error after the session against the JAX
# package's on the CPU: its own TPU and CPU runs differ by 0.044 m at 16k
SCALE_GT_ATOL = 0.05
# the 16k last-cycle cost against the f64 cpu_lm_solve of the same problem
# (the JAX package: 1.68e-3 on the CPU, 2.96e-3 on its TPU)
SCALE_F64_RTOL = 5e-3
# the refine at 8192 from the JAX session's own poses and rows: its final
# cost against the JAX package's
REFINE_COST_RTOL = 1e-2
# the phase runs bench.py's repetitions but one timed headline session
SCALE_HEADLINE_SESSIONS = 1


def load_scale_fixture() -> tuple[dict, dict]:
    """The JAX package's record of the reference's sessions: (the JSON, the
    arrays), with every key phase 17 reads."""
    import numpy as np

    with open(SCALE_FIXTURE + ".json") as f:
        fx = json.load(f)
    for session, keys in SCALE_FIXTURE_KEYS.items():
        missing = [k for k in keys if k not in fx.get(session, {})]
        check(not missing, f"scale fixture: {session} lacks {missing}")
    with np.load(SCALE_FIXTURE + ".npz") as z:
        arrays = {k: z[k] for k in SCALE_FIXTURE_ARRAYS}
    return fx, arrays


class _Counted:
    """While a section runs: the correction cycles it makes (em_scan runs
    twice in each) and the iteration tensors of every LM solve (BCR runs
    once an iteration), with the kernels' counts zeroed on entry: the
    replays of cycle programs, of lone solves and of the solve-only
    rounds (bench_sessions.solve_rounds), and the cycles and solves run
    eagerly (those run while a program is captured launch nothing).
    Nothing is read back while the section runs."""

    def __enter__(self):
        from hitl_slam_torch import bench_sessions as BS
        from hitl_slam_torch.models.hitl import cycle as C, engine as EN
        from hitl_slam_torch.solver import lm as LM
        from hitl_slam_torch.utils.device_loop import replays

        self.cycles, self.iterations = 0, []
        self._saved = (C.cycle_step, EN.cycle_step, C.lm_solve, LM.solve,
                       C.CycleProgram.replay, BS.solve_rounds)
        step, solve, replay = self._saved[0], self._saved[3], self._saved[4]
        rounds = self._saved[5]

        def capturing():
            import torch

            return DEVICE != "cpu" and torch.cuda.is_current_stream_capturing()

        def counted_step(*a, **k):
            self.cycles += 1
            return step(*a, **k)

        def counted_solve(*a, **k):
            out = solve(*a, **k)
            if not capturing():
                self.iterations.append(out.iterations)
            return out

        def counted_replay(prog, ctype):
            out = replay(prog, ctype)
            self.cycles += 1
            self.iterations.append(prog.solve_iterations(ctype).clone())
            return out

        def counted_rounds(poses0, *a, eager=False, **k):
            # a replay's rounds: their solves ran only at its capture
            out = rounds(poses0, *a, eager=eager, **k)
            if replays(poses0, eager):
                self.iterations.append(out[1].sum())
            return out

        C.cycle_step = EN.cycle_step = counted_step
        C.lm_solve = LM.solve = counted_solve
        C.CycleProgram.replay = counted_replay
        BS.solve_rounds = counted_rounds
        _sync()
        _reset_counts()
        return self

    def __exit__(self, *exc):
        from hitl_slam_torch import bench_sessions as BS
        from hitl_slam_torch.models.hitl import cycle as C, engine as EN
        from hitl_slam_torch.solver import lm as LM

        _sync()
        self.launches = _read_counts()
        (C.cycle_step, EN.cycle_step, C.lm_solve, LM.solve,
         C.CycleProgram.replay, BS.solve_rounds) = self._saved
        return False


def _scale_section(name, fn, tag="scale", bcr_needed=True):
    """fn() with its launches counted: returns (its result, em_scan
    launches, BCR launches, seconds) after checking em_scan = 2 x cycles
    and BCR = LM iterations (and, with `bcr_needed`, BCR launched)."""
    t0 = time.perf_counter()
    with _Counted() as c:
        out = fn()
    secs = time.perf_counter() - t0
    n_em, n_bcr = c.launches
    its = sum(int(i) for i in c.iterations)
    check(n_em == 2 * c.cycles,
          f"{name}: em_scan launches {n_em} != 2 x {c.cycles} cycles")
    check(n_bcr == its,
          f"{name}: bcr launches {n_bcr} != LM iterations {its} of "
          f"{len(c.iterations)} solves")
    check(n_bcr > 0 or not bcr_needed, f"{name}: no BCR launch")
    log(f"[{tag}] {name}: {secs:.1f} s, {c.cycles} cycles, "
        f"{len(c.iterations)} LM solves, launches em_scan={n_em} "
        f"bcr={n_bcr}")
    return out, n_em, n_bcr, secs


def _session_gates(name, got, want, gt_key=None):
    check(got["accepted"] == want["accepted"],
          f"{name}: accepted {got['accepted']} != JAX {want['accepted']}")
    check(got["rows"] == want["rows"],
          f"{name}: {got['rows']} constraint rows != JAX {want['rows']}")
    if gt_key:
        g, w = got[gt_key], want[gt_key]
        check(g["after"] < g["before"],
              f"{name}: ground-truth error {g['before']:.4f} -> "
              f"{g['after']:.4f} m did not fall")
        check(abs(g["after"] - w["after"]) <= SCALE_GT_ATOL,
              f"{name}: ground-truth error after {g['after']:.4f} m, JAX "
              f"{w['after']:.4f} m (> {SCALE_GT_ATOL} m apart)")


def _em_scan_at(torch, name, state, sel):
    """em_scan against its plain version on `state`'s world points with
    the clicks `sel`: counts exact, minima bit-equal; then its times, plain
    time and bound."""
    from hitl_slam_torch.ops import em_scan as E

    world = state.world_points().contiguous()
    mask = state.point_mask
    s = torch.as_tensor(sel, dtype=torch.float32, device=DEVICE)
    ck, mk = E.em_scan_cuda(world, mask, s)
    cr, mr = E.em_scan_reference(world, mask, s)
    torch.cuda.synchronize()
    P, N = mask.shape
    check(torch.equal(ck, cr), f"em_scan {name} [{P}, {N}]: counts differ in "
          f"{int((ck != cr).sum())} entries")
    check(torch.equal(mk.view(torch.int32), mr.view(torch.int32)),
          f"em_scan {name} [{P}, {N}]: minima not bit-equal")
    run = lambda: E.em_scan_cuda(world, mask, s)   # noqa: E731
    ms = time_cuda(run, 100)
    dev_ms, _, _ = device_ms(run, "em_scan_kernel")
    plain_ms = time_cuda(lambda: E.em_scan_reference(world, mask, s), 20)
    bytes_moved, flops = em_scan_work(mask)
    bound_ms, bound_by = bound(bytes_moved, flops)
    log(f"[scale] em_scan {name} [{P}, {N}]: counts exact (sum "
        f"{int(ck.sum())}), minima bit-equal; events {ms:.5f} ms, device "
        f"{dev_ms:.5f} ms, plain {plain_ms:.4f} ms, {bytes_moved} B, bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    return dict(P=P, N=N, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bytes=bytes_moved, bound_ms=bound_ms, bound_by=bound_by)


def _bcr_lm_system(torch, state):
    """The first LM step's system of the joint problem at `state`'s poses:
    D damped by the initial mu on its clamped diagonal, U, -g."""
    from hitl_slam_torch.solver import joint, lm

    cfg = lm.LMConfig()
    problem = joint.build_problem(state.poses, state.constraints)
    D, U, g, _ = joint.normal_equations(problem, state.poses)
    diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), cfg.min_diagonal,
                       cfg.max_diagonal)
    return (D + cfg.initial_mu * torch.diag_embed(diag)).contiguous(), \
        U.contiguous(), (-g).contiguous()


def _bcr_at(torch, name, D, U, b):
    from hitl_slam_torch.solver import bcr_kernel as B, tridiag

    n = D.shape[0]
    plan = B.launch_plan(n)
    xk = B.bcr_solve_cuda(D, U, b)
    xt = tridiag.bcr_solve(D, U, b)
    torch.cuda.synchronize()
    scale = max(1.0, float(xt.abs().max()))
    err = float((xk - xt).abs().max())
    check(bool(torch.isfinite(xk).all()), f"bcr {name}: non-finite")
    check(err <= BCR_RTOL * scale,
          f"bcr {name}: kernel vs plain {err:.3e} > {BCR_RTOL * scale:.3e}")
    fn = lambda: B.bcr_solve_cuda(D, U, b)   # noqa: E731
    ms = time_cuda(fn, 100)
    dev_ms, dev_call_ms, _ = device_ms(fn, "bcr_")
    plain_ms = time_cuda(lambda: tridiag.bcr_solve(D, U, b), 10)
    H, rhs = _dense_system(torch, D, U, b)
    library_ms = time_cuda(lambda: torch.linalg.solve(H, rhs), 3, warmup=1)
    del H, rhs
    bytes_moved, flops = bcr_work(n)
    bound_ms, bound_by = bound(bytes_moved, flops)
    log(f"[scale] bcr {name} n={n} ({plan.route} of {plan.blocks}, top "
        f"{plan.top}): max|kernel-plain| {err:.3e} (max|x| {scale:.3f}); "
        f"events {ms:.5f} ms, device {dev_ms:.5f} ms a launch ("
        f"{dev_call_ms:.5f} a call), plain {plain_ms:.4f} "
        f"ms, dense torch.linalg.solve {library_ms:.3f} ms, {bytes_moved} B, "
        f"bound {bound_ms:.6f} ms ({bound_by})")
    return err, dict(n=n, ms=ms, device_ms=dev_ms,
                     device_ms_per_call=dev_call_ms, plain_ms=plain_ms,
                     library_ms=library_ms, bytes=bytes_moved,
                     bound_ms=bound_ms, bound_by=bound_by)


def _busy_share(torch, section):
    """The device's busy share of the heaviest cycle of a session (its last
    accepted one): the cycle replayed on a fresh engine from the state
    before it, once timed, once under the device-only profiler."""
    from hitl_slam_torch.core.state import CorrectionType, SingleInput

    from hitl_slam_torch.bench_sessions import SCALE_CAPACITY
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    sess = section["_session"]
    m = section["_map"]
    eng = HitLSLAM(device=DEVICE)
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             constraint_capacity=SCALE_CAPACITY)
    inputs = [SingleInput(CorrectionType(c), 0, s)
              for c, s in sess["accepted_inputs"]]
    for e in inputs[:-1]:
        check(eng.replay_log(e).accepted, "busy share: a replay rejected")
    st, n = eng.state, eng.num_constraints

    def last():
        eng.state, eng.num_constraints = st, n
        rep = eng.replay_log(inputs[-1])
        torch.cuda.synchronize()
        return rep

    last()
    t0 = time.perf_counter()
    rep = last()
    wall = (time.perf_counter() - t0) * 1e3
    dev, ops = _device_only_profile(torch, last)
    return dict(wall_ms=wall, device_ms=dev, busy=dev / wall, ops=ops,
                lm_iterations=rep.lm_iterations)


def phase_scale(torch, smi):
    """The reference's HitL bench sessions at its sizes on the card
    (hitl_slam_torch/bench_sessions.py), each run with its launches counted,
    against the JAX package's record of the same sessions; then the
    kernels at the shapes these sessions give them."""
    import numpy as np

    from hitl_slam_torch import bench_sessions as S
    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.models.hitl import refine as R

    fx, jx = load_scale_fixture()
    out = {"card": smi}
    tot_em = tot_bcr = 0
    t_phase = time.perf_counter()

    def section(name, fn):
        nonlocal tot_em, tot_bcr
        res, n_em, n_bcr, secs = _scale_section(name, fn)
        tot_em, tot_bcr = tot_em + n_em, tot_bcr + n_bcr
        return res, dict(launches_em_scan=n_em, launches_bcr=n_bcr,
                         seconds=secs)

    # ---- (b) the headline session ----
    head, info = section("headline", lambda: S.headline_section(
        DEVICE, sessions=SCALE_HEADLINE_SESSIONS))
    want = fx["headline"]
    _session_gates("headline", head, want)
    dxy, dth = pose_errors(head["_poses"], jx["headline_poses"])
    check(dxy <= LOOSE[0] and dth <= LOOSE[1],
          f"headline: poses {dxy:.3e} m / {dth:.3e} rad from JAX's (> "
          f"{LOOSE})")
    w = head["cycle_wall_ms"]
    log(f"[scale] headline {head['poses']} poses x {head['padded_points']} "
        f"points: accepted {head['accepted']} (JAX {want['accepted']}), LM "
        f"iterations {head['lm_iterations']} (JAX {want['lm_iterations']}, "
        f"not gated), {head['rows']} rows, poses {dxy:.2e} m / {dth:.2e} rad "
        f"from JAX's; replay_log wall ms median {w['median']:.3f} (q1 "
        f"{w['q1']:.3f}, q3 {w['q3']:.3f}, min {w['min']:.3f}) over "
        f"{w['n']} accepted cycles")
    out["headline"] = {**S.public(head), **info, "pose_error_vs_jax": {
        "xy_m": dxy, "theta_rad": dth}}

    # ---- (c) the pipelined chain ----
    chain, info = section("chain", lambda: S.chain_section(DEVICE, head))
    check(all(chain["accepted"]) and chain["finite"],
          f"chain: accepted {chain['accepted']}, finite {chain['finite']}")
    # the sequential session after the same corrections
    seq = head["_session"]["accepted_poses"][chain["cycles"] - 1]
    dxy, dth = pose_errors(chain["_first_poses"], seq)
    check(dxy <= LOOSE[0] and dth <= LOOSE[1],
          f"chain: first repetition {dxy:.3e} m / {dth:.3e} rad from the "
          f"sequential session (> {LOOSE})")
    log(f"[scale] chain {chain['cycles']} cycles x {chain['j_rep']}: "
        f"{chain['ms_per_cycle']:.3f} ms a cycle (samples "
        f"{[round(t, 3) for t in chain['ms_per_cycle_samples']]}), last "
        f"repetition's LM iterations {chain['lm_iterations']} (JAX "
        f"{want['chain']['lm_iterations']}), first repetition "
        f"{dxy:.2e} m / {dth:.2e} rad from the sequential session, "
        f"{chain['host_reads_per_cycle']:.1f} host reads and "
        f"{chain['device_ops_per_cycle']:.0f} device operations a cycle")
    out["chain"] = {**S.public(chain), **info,
                    "pose_error_vs_sequential": {"xy_m": dxy,
                                                 "theta_rad": dth}}

    # ---- (e) the ~10^4-pose joint solve alone ----
    table = head["_session"]["engine"].state.constraints
    big, info = section("joint solve", lambda: S.joint_solve_section(
        DEVICE, table))
    check(big["finite"] and big["final_cost"] < big["initial_cost"],
          f"joint solve: cost {big['initial_cost']} -> {big['final_cost']}")
    log(f"[scale] joint solve {big['poses']} poses, {big['rows']} rows: "
        f"{big['wall_ms']:.3f} ms (samples "
        f"{[round(t, 3) for t in big['wall_ms_samples']]}), iterations "
        f"{big['iterations']}, cost {big['initial_cost']:.6e} -> "
        f"{big['final_cost']:.6e}")
    out["joint_solve"] = {**S.public(big), **info}

    # ---- (f), (g) the 8192- and 16384-pose sessions ----
    sessions = {}
    for size, key in ((8192, "s8192"), (16384, "s16384")):
        t0 = time.perf_counter()
        m = S.generate_figure8(**S.SCALE_MAPS[size])
        map_s = time.perf_counter() - t0
        res, info = section(f"{size}-pose session", lambda: (
            S.scale_session_section(DEVICE, size, m=m)))
        want = fx[key]
        check(res["accepted_cycles"] == 3, f"{key}: "
              f"{res['accepted_cycles']} cycles accepted, not 3")
        _session_gates(key, res, want, "gt_mean")
        g = res["gt_mean"]
        log(f"[scale] {size} poses x {res['padded_points']} points (map "
            f"{map_s:.1f} s): accepted {res['accepted']}, cycle wall ms "
            f"{[round(t, 3) for t in res['cycle_wall_ms']]}, LM iterations "
            f"{res['lm_iterations']} (JAX {want['lm_iterations']}), "
            f"{res['rows']} rows, ground-truth error {g['before']:.4f} -> "
            f"{g['after']:.4f} m (JAX {want['gt_mean']['after']:.4f} m), "
            f"peak {res['peak_memory_mib']:.0f} MiB")
        rec = {**S.public(res), **info, "map_s": map_s}
        if "f64" in res:
            f = res["f64"]
            check(f["relative"] <= SCALE_F64_RTOL,
                  f"{key}: last-cycle cost {f['last_cycle_cost']:.6e} is "
                  f"{f['relative']:.3e} from the f64 solve's {f['cost']:.6e}"
                  f" (> {SCALE_F64_RTOL})")
            log(f"[scale] {size}: last-cycle cost {f['last_cycle_cost']:.6e}"
                f", f64 cpu_lm_solve {f['cost']:.6e} ({f['ms']:.0f} ms), "
                f"relative {f['relative']:.3e} (JAX "
                f"{want['f64']['relative']:.3e})")
        if "refine" in res:
            r, wr = res["refine"], want["refine"]
            check(r["solver"] == "pcg", f"{key} refine: solver {r['solver']}")
            check(r["finite"] and r["final_cost"] < r["initial_cost"],
                  f"{key} refine: cost {r['initial_cost']} -> "
                  f"{r['final_cost']}, finite {r['finite']}")
            # the same refine from the JAX session's own poses and rows
            st = res["_session"]["engine"].state
            rows = {k: jx[f"s8192_table_{k}"] for k in (
                "ctype", "constrained", "anchor", "delta_parallel",
                "delta_perpendicular", "delta_angle", "penalty_dir",
                "active")}
            pad = S.SCALE_CAPACITY - len(rows["active"])
            rows = {k: np.concatenate([v, np.zeros(pad, v.dtype)])
                    for k, v in rows.items()}
            jp = torch.as_tensor(jx["s8192_poses"], device=DEVICE)
            same = R.post_human_refine(
                st.points, st.normals, st.point_mask, jp,
                table_from_numpy(rows, DEVICE),
                capacity=S.REFINE_AT_SCALE["capacity"],
                config=S.lm.LMConfig(
                    max_iterations=S.REFINE_AT_SCALE["max_iterations"]),
                matcher="pair", max_pairs=S.REFINE_AT_SCALE["max_pairs"])
            c1 = float(same.final_cost)
            rel = abs(c1 - wr["final_cost"]) / abs(wr["final_cost"])
            check(rel <= REFINE_COST_RTOL,
                  f"{key} refine from JAX's state: final cost {c1:.6e}, JAX "
                  f"{wr['final_cost']:.6e} ({rel:.3e} > {REFINE_COST_RTOL})")
            own = abs(r["final_cost"] - wr["final_cost"]) / wr["final_cost"]
            log(f"[scale] {size} refine ({r['matcher']} matcher, "
                f"{r['solver']}): {r['wall_ms']:.1f} ms (samples "
                f"{[round(t, 1) for t in r['wall_ms_samples']]}; match "
                f"{r['match_ms']:.1f} ms, LM {r['lm_ms']:.1f} ms), "
                f"{r['matches']} matches (JAX {wr['matches']}), dropped rows "
                f"{r['match_dropped']} / votes {r['vote_dropped']} / election "
                f"{r['elect_dropped']} (JAX {wr['match_dropped']} / "
                f"{wr['vote_dropped']} / {wr['elect_dropped']}), "
                f"{r['iterations']} iterations ({r['cg_iterations']} CG), "
                f"cost {r['initial_cost']:.4f} -> {r['final_cost']:.4f} "
                f"({own:.3e} from JAX's {wr['final_cost']:.4f}, from another "
                f"start); from JAX's poses and rows: {int(same.num_matches)} "
                f"matches, cost {float(same.initial_cost):.4f} -> {c1:.4f}, "
                f"{rel:.3e} from JAX's; peak {r['peak_memory_mib']:.0f} MiB")
            rec["refine_from_jax_state"] = dict(
                matches=int(same.num_matches),
                initial_cost=float(same.initial_cost), final_cost=c1,
                relative=rel)
            del same
        if size == 16384:
            busy = _busy_share(torch, res)
            log(f"[scale] 16384: last cycle ({busy['lm_iterations']} LM "
                f"iterations) {busy['wall_ms']:.2f} ms wall, device "
                f"{busy['device_ms']:.2f} ms in {busy['ops']} operations: "
                f"busy {100 * busy['busy']:.1f} %")
            rec["busy_last_cycle"] = busy
        sessions[key] = (res, rec)
        out[key] = rec

    # ---- the kernels at the sessions' shapes, against their plain twins ----
    times = {"em_scan": {}, "bcr_solve": {}}
    worst = [0.0, 0.0]
    for name, st, sel in (
            ("headline", head["_session"]["engine"].state,
             head["_session"]["accepted_inputs"][0][1]),
            ("8192", sessions["s8192"][0]["_session"]["engine"].state,
             sessions["s8192"][0]["_session"]["accepted_inputs"][0][1]),
            ("16384", sessions["s16384"][0]["_session"]["engine"].state,
             sessions["s16384"][0]["_session"]["accepted_inputs"][0][1])):
        t = _em_scan_at(torch, name, st, sel)
        times["em_scan"][f"P{t['P']}_N{t['N']}"] = t
    st8 = sessions["s8192"][0]["_session"]["engine"].state
    err, t = _bcr_at(torch, "8192-pose session, first LM step",
                     *_bcr_lm_system(torch, st8))
    worst[1] = err
    times["bcr_solve"]["n8192_lm"] = t
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[scale] phase: {out['seconds']:.1f} s, launches em_scan={tot_em} "
        f"bcr={tot_bcr}")
    sections = {"headline": head, "chain": chain, "joint_solve": big,
                "scale_8192": sessions["s8192"][0],
                "scale_16384": sessions["s16384"][0]}
    return out, tot_em, tot_bcr, worst, times, sections


# ---------------------------------------------------------------- phase 18

# the headline refine's final cost against the f64 cpu_refine_solve of the
# same factors from the same poses (phase 17's bound for the refine at
# scale)
REFERENCE_F64_RTOL = REFINE_COST_RTOL


def enml_scale_from_phases(enml, scale) -> dict:
    """The scale map's part of the reference's record from phases 10 and
    11: the state's footprint, the scans, the sequential sweep's wall
    (phase 10, which must have swept every node) and the checkerboard's
    at W = 10 and W = 80 (phase 11)."""
    from hitl_slam_torch.bench_reference import enml_footprint

    seq, cb = enml["scale"], enml["checkerboard"]["scale"]
    check(seq["swept_nodes"] == seq["nodes"],
          f"reference: the scale sweep was cut to {seq['swept_nodes']} of "
          f"{seq['nodes']} nodes")
    return dict(footprint=enml_footprint(scale["state"]),
                scans=scale["scans"], sequential_ms=seq["wall_s"] * 1e3,
                checkerboard_ms=cb["W10"]["wall_s"] * 1e3,
                w80_ms=cb["W80"]["wall_s"] * 1e3)


def phase_reference(torch, smi, sections, enml_scale, peaks):
    """The rest of the reference's bench record (hitl_slam_torch/
    bench_reference.py) at its full sizes on the card, on phase 17's
    headline session (its final state) and with phase 17's other sessions
    and phases 10-11's scale-map walls: solve-only with the f64 baselines,
    the round trip, speculative cycles and the forced misses, the replica
    batch, the refine with its f64 baseline, EnML on the 160-scan stream
    and the bag's ingest; each section's launches counted. Gates: every
    natural cycle a hit, each bit-equal to a non-speculative replay on the
    card; the forced misses reuse nothing (the section raises) and equal
    their replays; the refine within REFERENCE_F64_RTOL of f64; the native
    bag scanner built and both routes exact; the assembled record holds
    every key of KEY_MAP. Returns (the record, em_scan, BCR and batched
    BCR launches)."""
    from hitl_slam_torch import bench_reference as BR
    from hitl_slam_torch import bench_sessions as S
    from hitl_slam_torch.bench import device_facts, replica_split
    from hitl_slam_torch.solver import bcr_kernel as B

    t_phase = time.perf_counter()
    head = sections["headline"]
    state = head["_session"]["engine"].state
    s = {"device": torch.device(DEVICE), **sections,
         "enml_scale": enml_scale}
    tot = {"em": 0, "bcr": 0, "batched": 0}
    mem = {}

    def section(name, fn, bcr_needed=False):
        S._reset_peak(DEVICE)
        res, n_em, n_bcr, secs = _scale_section(
            name, fn, tag="reference", bcr_needed=bcr_needed)
        batched = B.batched_launches.count
        tot["em"] += n_em
        tot["bcr"] += n_bcr
        tot["batched"] += batched
        mem[name] = {"seconds": secs, "peak_mib": S._peak_mib(DEVICE),
                     "launches": [n_em, n_bcr, batched]}
        s[name] = res
        return res

    so = section("solve_only", lambda: S.solve_only_section(DEVICE, head),
                 bcr_needed=True)
    rtt = section("overhead", lambda: BR.overhead_section(DEVICE))
    spec = section("speculative", lambda: BR.speculative_section(
        DEVICE, head["_map"], head["capacity"]), bcr_needed=True)
    check(spec["hits"] == spec["attempts"] == len(spec["hit"]),
          f"speculative: {spec['hits']} hits of {spec['attempts']} attempts")
    check(all(spec["bit_equal_to_replay"]),
          f"speculative: cycles not bit-equal to their replays: "
          f"{spec['bit_equal_to_replay']}")
    check(spec["accepted"] == [a for a in head["accepted"] if a is not None],
          f"speculative: accepted {spec['accepted']}, the headline "
          f"{head['accepted']}")
    check(set(spec["miss_equal_to_replay"]) == set(BR.MISS_KINDS)
          and all(spec["miss_equal_to_replay"].values()),
          f"forced misses: {spec['miss_equal_to_replay']}")
    log(f"[reference] speculative: {spec['hits']} hits of "
        f"{spec['attempts']}, bit-equal to replays; keypress ms "
        f"{[round(t, 3) for t in spec['ms_accepted']]} (median "
        f"{spec['ms']:.3f}); forced misses {spec['miss_ms_per_kind']} ms "
        f"(hits unchanged, equal to replays); round trip "
        f"{rtt['rtt_ms']:.4f} ms ({smi})")
    rep = section("replicas", lambda: replica_split(_sync, state,
                                                     BR.REPLICAS),
                  bcr_needed=True)
    check(rep["cost_not_up"] and mem["replicas"]["launches"][2] > 0,
          f"replicas: cost not up {rep['cost_not_up']}, batched launches "
          f"{mem['replicas']['launches'][2]}")
    ref = section("refine", lambda: BR.headline_refine_section(DEVICE,
                                                                state))
    check(ref["f64_relative"] <= REFERENCE_F64_RTOL,
          f"refine: final cost {ref['lm_final_cost']:.6e}, f64 "
          f"{ref['cpu_final_cost']:.6e} ({ref['f64_relative']:.3e} > "
          f"{REFERENCE_F64_RTOL})")
    check(mem["refine"]["launches"] == [0, 0, 0],
          f"refine launched a kernel: {mem['refine']['launches']}")
    log(f"[reference] replicas {rep['replicas']}: {rep['wall_ms']:.2f} ms "
        f"({rep['solves_per_s']:.1f} solves/s), iterations "
        f"{rep['iterations']}; refine {ref['refine_ms']:.2f} ms (match "
        f"{ref['match_ms']:.2f}, LM {ref['lm_ms']:.2f} ms, "
        f"{ref['lm_iterations']} iterations), {ref['matches']} matches, "
        f"{ref['match_dropped']} dropped; f64 {ref['cpu_ms']:.1f} ms, "
        f"{ref['cpu_iterations']} iterations, cost {ref['cpu_final_cost']:.6e}"
        f" against the card's {ref['lm_final_cost']:.6e} "
        f"({ref['f64_relative']:.3e})")
    en = section("enml", lambda: BR.enml_section(DEVICE))
    bag = section("bag_ingest", lambda: BR.bag_ingest_section(
        require_native=True))
    check(bag["routes_equal"] is True, "bag ingest: the routes differ")
    log(f"[reference] enml {en['nodes']} nodes: sweep "
        f"{en['sequential_ms']:.1f} ms, checkerboard "
        f"{en['checkerboard_ms']:.1f} ms, W = 80 "
        f"{en['w80_checkerboard_ms']:.1f} ms; bag {bag['bytes']} B: native "
        f"{bag['routes']['native']['mb_s']:.1f} MB/s, Python "
        f"{bag['routes']['python']['mb_s']:.1f} MB/s, "
        f"{bag['written']} messages each")
    peak = max([p for p in peaks if p is not None]
               + [m["peak_mib"] for m in mem.values()])
    s["memory"] = {"peak_mib": peak, "sections": mem}
    pub = S.public(s)
    rec = BR.record(pub, False, device_facts(torch, torch.device(DEVICE)))
    missing = [k for k in BR.KEY_MAP if k not in rec["detail"]]
    check(not missing, f"reference record lacks {missing}")
    seconds = time.perf_counter() - t_phase
    log(f"[reference] record: {len(rec['detail'])} keys, value "
        f"{rec['value']:.3f} ms, peak {peak:.0f} MiB; phase {seconds:.1f} s, "
        f"launches em_scan={tot['em']} bcr={tot['bcr']} "
        f"batched={tot['batched']}")
    rec["notes"]["seconds"] = seconds
    return rec, tot["em"], tot["bcr"], tot["batched"]


# ---------------------------------------------------------------- phase 19

# a replay of the cycle program against eager cycle_step from the same
# state: bit-equal where two eager runs on the card are bit-equal,
# elsewhere within phase 16's card-against-CPU bounds
PROGRAM_POSE_TOL, PROGRAM_COST_RTOL = MESH_CPU_POSE_TOL, MESH_CPU_COST_RTOL
PROGRAM_INTS = ("verified", "order_valid", "num_new_constraints",
                "lm_iterations")
# the phase should finish within this many seconds
PROGRAM_SECONDS = 60.0


def _same_outputs(torch, a, b) -> bool:
    """Every tensor of two CycleOutputs bit-equal."""
    from dataclasses import fields

    for f in fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        pairs = (list(zip(vars(x).values(), vars(y).values()))
                 if f.name == "constraints" else [(x, y)])
        if not all(torch.equal(u, v) for u, v in pairs):
            return False
    return True


def _host_reads(torch, run) -> dict:
    """run()'s reads back to the host under torch.profiler: scalar reads
    (aten::_local_scalar_dense) and device-to-host copies (the card's
    DtoH memcpy records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        _sync()
    ev = prof.key_averages()
    scalar = sum(e.count for e in ev if e.key == "aten::_local_scalar_dense")
    dtoh = sum(e.count for e in ev if e.device_type == DeviceType.CUDA
               and "DtoH" in e.key)
    return dict(scalar=scalar, dtoh=dtoh, total=scalar + dtoh)


def _program_engine(data, capacity, odometry=None):
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    eng = HitLSLAM(device=DEVICE)
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, odometry=odometry,
             constraint_capacity=capacity)
    return eng


def _program_outputs(torch, name, data, capacity, inputs, odometry=None):
    """Each correction of `inputs` ((ctype, [4, 2] clicks)) from the state
    the session reaches before it: eager cycle_step twice and a replay of
    the map's CycleProgram; integers equal, em_scan's inlier counts equal,
    floats bit-equal where the two eager runs are, else within the
    bounds. The session then moves on by replay_log."""
    import numpy as np

    from hitl_slam_torch.core.state import CorrectionType, SingleInput
    from hitl_slam_torch.models.hitl import cycle as C

    eng = _program_engine(data, capacity, odometry)
    rows = []
    for i, (ct, clicks) in enumerate(inputs):
        st, n = eng.state, eng.num_constraints
        sel_np = eng._prepare_sel(CorrectionType(ct),
                                  np.asarray(clicks, np.float32))
        sel = torch.as_tensor(sel_np, device=DEVICE)
        eager = []
        for _ in range(2):
            out, _, counts = C.cycle_solve(
                st.points, st.point_mask, st.poses, st.covariances,
                st.constraints, ct, sel, n, lm_config=eng.lm_config)
            eager.append((C.clone_output(out), counts.clone()))
        prog = eng._program(st)
        rep = prog.run(ct, st.points, st.point_mask, st.poses,
                       st.covariances, st.constraints, sel, n)
        rep_counts = prog.graphs[ct].outputs[2].clone()
        _sync()
        (e1, c1), (e2, c2) = eager
        ints = {k: (int(getattr(rep, k)), int(getattr(e1, k)))
                for k in PROGRAM_INTS}
        check(all(a == b for a, b in ints.values()),
              f"{name} correction {i}: replay integers {ints} (replay, "
              f"eager) differ")
        check(torch.equal(rep_counts, c1),
              f"{name} correction {i}: em_scan counts differ from eager")
        eager_equal = _same_outputs(torch, e1, e2) and torch.equal(c1, c2)
        replay_equal = _same_outputs(torch, rep, e1)
        dpose = float((rep.poses - e1.poses).abs().max())
        dcost = max(abs(float(getattr(rep, k)) - float(getattr(e1, k)))
                    / max(abs(float(getattr(e1, k))), 1e-30)
                    for k in ("lm_initial_cost", "lm_final_cost"))
        if eager_equal:
            check(replay_equal, f"{name} correction {i}: two eager runs are "
                  f"bit-equal, the replay is not (poses {dpose:.3e}, cost "
                  f"{dcost:.3e})")
        else:
            check(dpose <= PROGRAM_POSE_TOL and dcost <= PROGRAM_COST_RTOL,
                  f"{name} correction {i}: replay {dpose:.3e} / {dcost:.3e} "
                  f"from eager (> {PROGRAM_POSE_TOL} / {PROGRAM_COST_RTOL})")
        standard = "bit-equal" if replay_equal else "tolerance"
        rows.append(dict(ctype=ct, standard=standard,
                         eager_bit_equal=eager_equal, max_pose_diff=dpose,
                         cost_rel_diff=dcost, lm_iterations=ints[
                             "lm_iterations"][0],
                         verified=bool(ints["verified"][0]),
                         order_valid=bool(ints["order_valid"][0])))
        eng.replay_log(SingleInput(CorrectionType(ct), 0, clicks))
    log(f"[program] {name}: {len(rows)} corrections, replay against eager "
        f"cycle_step: " + "; ".join(
            f"{r['standard']} (LM {r['lm_iterations']}, poses "
            f"{r['max_pose_diff']:.1e}, eager runs bit-equal "
            f"{r['eager_bit_equal']})" for r in rows))
    return rows


def _program_chain(torch, name, data, capacity, inputs, odometry=None):
    """run_queue through the program against replay_log (per-cycle flags),
    its host reads under the profiler, both kernels' launches from its
    replays, and queue_chain under sync debug mode "error"."""
    import numpy as np

    from hitl_slam_torch.core.state import CorrectionType, SingleInput
    from hitl_slam_torch.models.hitl import cycle as C

    entries = [SingleInput(CorrectionType(c), 0, np.asarray(s, np.float32))
               for c, s in inputs]
    seq = _program_engine(data, capacity, odometry)
    want = [seq.replay_log(e) for e in entries]
    eng = _program_engine(data, capacity, odometry)
    _sync()
    _reset_counts()
    got = eng.run_queue(entries)
    _sync()
    n_em, n_bcr = _read_counts()
    flags = lambda rs: [(r.accepted, r.reason, r.num_new_constraints,   # noqa: E731
                         r.lm_iterations) for r in rs]
    check(flags(got) == flags(want),
          f"{name}: run_queue {flags(got)} != replay_log {flags(want)}")
    check(n_em == 2 * len(entries) and n_em > 0,
          f"{name}: em_scan replay launches {n_em} != 2 x {len(entries)}")
    iters = sum(r.lm_iterations for r in got)
    check(n_bcr == iters and n_bcr > 0,
          f"{name}: bcr replay launches {n_bcr} != LM iterations {iters}")
    check(torch.equal(eng.state.poses, seq.state.poses)
          or float((eng.state.poses - seq.state.poses).abs().max())
          <= PROGRAM_POSE_TOL, f"{name}: run_queue's poses differ from "
          "replay_log's")
    fresh = _program_engine(data, capacity, odometry)
    reads = _host_reads(torch, lambda: fresh.run_queue(entries))
    check(reads["total"] == 1, f"{name}: run_queue read the host "
          f"{reads} times, not once")
    # the chain alone, with a synchronizing call anywhere raising
    st = _program_engine(data, capacity, odometry).state
    sels = torch.as_tensor(np.stack([seq._prepare_sel(e.correction_type,
                                                      e.points)
                                     for e in entries]), device=DEVICE)
    _sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = C.queue_chain(st.points, st.point_mask, st.poses,
                            st.covariances, st.constraints,
                            [int(e.correction_type) for e in entries], sels,
                            0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    accepted = [bool(a) for a in res[4][0].cpu().tolist()]
    check(accepted == [r.accepted for r in want],
          f"{name}: queue_chain under sync debug accepted {accepted}")
    log(f"[program] {name} run_queue: flags equal replay_log's "
        f"({[r.accepted for r in got]}, LM {[r.lm_iterations for r in got]})"
        f", host reads {reads['total']} (scalar {reads['scalar']}, DtoH "
        f"{reads['dtoh']}), replay launches em_scan={n_em} bcr={n_bcr}; "
        f"queue_chain under sync debug mode \"error\": nothing raised")
    return dict(cycles=len(entries), host_reads=reads,
                launches_em_scan=n_em, launches_bcr=n_bcr,
                sync_debug_error_raised=False), n_em, n_bcr


def _program_times(torch, name, data, capacity, inputs, odometry=None):
    """Eager against program at one size: the last correction's wall from
    the state before it (the cycle and its six-scalar read, the best of
    three), the chained cycle over every correction from the start state
    (a checksum read at the end, the best of two), host reads and device
    operations of one cycle and the busy share (profiler device ms over
    the wall), and the programs' capture ms, graph nodes and pool MiB."""
    import numpy as np

    from hitl_slam_torch.bench_reference import device_profile
    from hitl_slam_torch.core.state import CorrectionType, SingleInput
    from hitl_slam_torch.models.hitl import cycle as C
    from hitl_slam_torch.models.hitl.engine import _report_scalars

    eng = _program_engine(data, capacity, odometry)
    for c, clicks in inputs[:-1]:
        eng.replay_log(SingleInput(CorrectionType(c), 0,
                                   np.asarray(clicks, np.float32)))
    st, n = eng.state, eng.num_constraints
    ct, clicks = inputs[-1]
    sel = torch.as_tensor(eng._prepare_sel(CorrectionType(ct), np.asarray(
        clicks, np.float32)), device=DEVICE)
    prog = eng._program(st)
    args = (st.points, st.point_mask, st.poses, st.covariances,
            st.constraints)

    def eager_cycle():
        _report_scalars(C.cycle_step(*args, ct, sel, n,
                                     lm_config=eng.lm_config))

    def program_cycle():
        _report_scalars(prog.run(ct, *args, sel, n))

    start = _program_engine(data, capacity, odometry).state
    ctypes = [c for c, _ in inputs]
    sels = torch.as_tensor(np.stack([np.asarray(
        eng._prepare_sel(CorrectionType(c), np.asarray(s, np.float32)))
        for c, s in inputs]), device=DEVICE)
    cargs = (start.points, start.point_mask, start.poses, start.covariances,
             start.constraints, ctypes, sels, 0)

    def chained(fn):
        def run():
            p, c, _, _, _ = fn(*cargs)
            float(torch.sum(p) + torch.sum(c))
        return run

    def best(fn, k):
        fn()
        walls = []
        for _ in range(k):
            _sync()
            t0 = time.perf_counter()
            fn()
            _sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        return min(walls)

    out = {"poses": int(st.num_poses), "points": int(st.max_points),
           "cycles_chained": len(inputs)}
    for kind, cycle, chain in (
            ("eager", eager_cycle, chained(C.queue_chain_eager)),
            ("program", program_cycle, chained(C.queue_chain))):
        wall = best(cycle, 3)
        chain_ms = best(chain, 2) / len(inputs)
        reads = _host_reads(torch, cycle)
        dev_ms, ops = device_profile(cycle)
        out[kind] = dict(cycle_ms=wall, chained_cycle_ms=chain_ms,
                         host_reads_per_cycle=reads["total"],
                         device_ops_per_cycle=ops, device_ms=dev_ms,
                         busy=dev_ms / wall)
    used = sorted(set(ctypes))
    out["program"].update(
        capture_ms={c: prog.graphs[c].capture_ms for c in used},
        graph_nodes={c: prog.graphs[c].nodes for c in used},
        pool_mib={c: prog.graphs[c].pool_mib for c in used})
    e, p = out["eager"], out["program"]
    log(f"[program] {name} ({out['poses']} poses x {out['points']} points):"
        f" cycle {e['cycle_ms']:.2f} ms eager, {p['cycle_ms']:.2f} ms "
        f"program; chained cycle {e['chained_cycle_ms']:.2f} / "
        f"{p['chained_cycle_ms']:.2f} ms; host reads a cycle "
        f"{e['host_reads_per_cycle']} / {p['host_reads_per_cycle']}; device "
        f"operations {e['device_ops_per_cycle']} / "
        f"{p['device_ops_per_cycle']}; busy {100 * e['busy']:.1f} / "
        f"{100 * p['busy']:.1f} %; capture ms {p['capture_ms']}, graph "
        f"nodes {p['graph_nodes']}, pool MiB "
        f"{ {c: round(v, 1) for c, v in p['pool_mib'].items()} }")
    return out


def phase_program(torch, smi, large, large_log, sections):
    """The correction cycle as a device program (models/hitl/cycle.py::
    CycleProgram, a CUDA graph a correction type whose EM and LM loops are
    WHILE nodes): replays against eager cycle_step on golden_large and the
    headline's corrections; run_queue through the program against
    replay_log, with one host read a chain and both kernels launched from
    replays; queue_chain under sync debug mode "error"; eager against
    program at 1024, 8192 and 16384 poses. Returns (the record, em_scan
    and BCR replay launches)."""
    from hitl_slam_torch import bench_sessions as S

    t_phase = time.perf_counter()
    head = sections["headline"]
    hm = head["_map"]
    large_inputs = [(int(e.correction_type), e.points) for e in large_log]
    head_inputs = head["_session"]["accepted_inputs"]
    out = {"card": smi, "design": "WHILE conditional nodes "
           "(csrc/graph_loop.cu); torch " + torch.__version__}
    out["outputs"] = {
        "golden_large": _program_outputs(torch, "golden_large", large, 16384,
                                         large_inputs),
        "headline": _program_outputs(torch, "headline", hm,
                                     S.HEADLINE_CAPACITY, head_inputs,
                                     hm.odometry)}
    out["chain"] = {}
    n_em = n_bcr = 0
    for name, data, cap, inputs, odo in (
            ("golden_large", large, 16384, large_inputs, None),
            ("headline", hm, S.HEADLINE_CAPACITY, head_inputs, hm.odometry)):
        out["chain"][name], e, b = _program_chain(torch, name, data, cap,
                                                  inputs, odo)
        n_em, n_bcr = n_em + e, n_bcr + b
    out["times"] = {"1024": _program_times(torch, "headline", hm,
                                           S.HEADLINE_CAPACITY, head_inputs,
                                           hm.odometry)}
    for key, size in (("scale_8192", 8192), ("scale_16384", 16384)):
        sec = sections[key]
        out["times"][str(size)] = _program_times(
            torch, f"{size}-pose session", sec["_map"], S.SCALE_CAPACITY,
            sec["_session"]["accepted_inputs"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[program] phase: {out['seconds']:.1f} s (budget "
        f"{PROGRAM_SECONDS:.0f} s), replay launches em_scan={n_em} "
        f"bcr={n_bcr}")
    return out, n_em, n_bcr


# ---------------------------------------------------------------- phase 20

# EnML's programs against the eager functions on the card: the 160-scan
# stream's sweep, the first ENML_PROGRAM_PREFIX nodes of the scale map, the
# session's segments (ENML_PROGRAM_SEGMENT nodes from t0 = 0 until past the
# end of the stream's first ENML_SEGMENT_NODES nodes) and the online window
# (the stream's last W nodes at the online localizer's 384 points)
ENML_PROGRAM_PREFIX = 64
ENML_PROGRAM_SEGMENT = 32
ENML_SEGMENT_NODES = 80
ONLINE_POINTS = 384
# a replay against an eager run that is not bit-equal to a second eager
# run: poses within phase 16's card-against-CPU bound, covariances within
# phase 10's (relative to each pose's largest entry)
ENML_PROGRAM_POSE_TOL, ENML_PROGRAM_COV_RTOL = MESH_CPU_POSE_TOL, ENML_COV_RTOL
# the phase should finish within this many seconds
ENML_PROGRAM_SECONDS = 150.0


def _standard(torch, name, rep, e1, e2, covs=None):
    """`rep` (a replay's tensors) against `e1` (an eager run's): bit-equal
    where a second eager run `e2` is bit-equal to `e1`, else poses (the
    first tensor) within ENML_PROGRAM_POSE_TOL and, where `covs` names the
    index of a covariance tensor, it within ENML_PROGRAM_COV_RTOL. Returns
    the standard that held and the differences."""
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))  # noqa
    eager_equal, replay_equal = same(e1, e2), same(rep, e1)
    dpose = float((rep[0] - e1[0]).abs().max())
    dcov = 0.0
    if covs is not None:
        scale = e1[covs].abs().amax(dim=(-2, -1), keepdim=True).clamp(
            min=1e-30)
        dcov = float(((rep[covs] - e1[covs]).abs() / scale).max())
    if eager_equal:
        check(replay_equal, f"{name}: two eager runs are bit-equal, the "
              f"replay is not (poses {dpose:.3e}, covariances {dcov:.3e})")
    else:
        check(dpose <= ENML_PROGRAM_POSE_TOL
              and dcov <= ENML_PROGRAM_COV_RTOL,
              f"{name}: replay {dpose:.3e} / {dcov:.3e} from eager (> "
              f"{ENML_PROGRAM_POSE_TOL} / {ENML_PROGRAM_COV_RTOL})")
    return dict(standard="bit-equal" if replay_equal else "tolerance",
                eager_bit_equal=eager_equal, max_pose_diff=dpose,
                cov_rel_diff=dcov)


def _dispatched_reads(torch, run) -> dict:
    """run()'s reads back to the host as PyTorch dispatches them: scalar
    reads (aten::_local_scalar_dense, item, nonzero) and copies to the
    host. A program's replay runs outside the dispatcher (one launch of an
    executable graph), so what it could read would show as a synchronising
    call under sync debug mode instead (_no_sync). torch.profiler is not
    used here: CUPTI traces a WHILE node's trips unreliably (a window over
    a long replayed sweep reported one trip's kernels, and after a few
    such windows the process died of an illegal memory access)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    scalar_ops = (aten._local_scalar_dense.default, aten.item.default,
                  aten.nonzero.default)

    class Reads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.scalar = self.to_host = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in scalar_ops:
                self.scalar += 1
            elif ((func is aten._to_copy.default
                   and args[0].device.type != "cpu"
                   and str(kwargs.get("device", args[0].device)) == "cpu")
                  or (func is aten.copy_.default
                      and args[0].device.type == "cpu"
                      and args[1].device.type != "cpu")):
                self.to_host += 1
            return func(*args, **kwargs)

    with Reads() as mode:
        run()
    _sync()
    return dict(scalar=mode.scalar, to_host=mode.to_host,
                total=mode.scalar + mode.to_host)


def _one_read(torch, name, run):
    """run() (a program call and one read of its result): exactly one host
    read."""
    reads = _dispatched_reads(torch, run)
    check(reads["total"] == 1, f"{name}: {reads} host reads, not one")
    return reads


def _no_sync(torch, name, call):
    """call() (a program call without a read) under sync debug mode
    "error": a synchronizing call anywhere raises."""
    _sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _sync()


def _timed_runs(fn, k: int):
    """k runs of fn(), each ending in a synchronise: (their results, the
    best wall ms)."""
    outs, ms = [], []
    for _ in range(k):
        _sync()
        t0 = time.perf_counter()
        outs.append(fn())
        _sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, min(ms)


def _walls(torch, eager_ms, program, prog, trips=0, replays=1, nodes=None,
           scans=None):
    """Eager (its wall given) against program (the best of three runs of
    `replays` replays of `prog`'s graph, `trips` loop trips in all) and
    the graph operations a run executes, counted from the graph's nodes
    (those outside its loop each replay, the body's each trip); ms a node
    and the realtime factor over `scans` scans where given. The busy share
    is not measured (BUSY_NOT_MEASURED): None."""
    out = {"eager_ms": eager_ms, "program_ms": _timed_runs(program, 3)[1]}
    g = prog.graph()
    body = sum(g.body_nodes)
    ops = replays * (g.nodes - body) + body * trips
    out.update(busy=None, graph_ops=ops)
    if nodes:
        out.update(eager_ms_per_node=out["eager_ms"] / nodes,
                   program_ms_per_node=out["program_ms"] / nodes,
                   graph_ops_per_node=ops / nodes)
    if scans:
        stream_s = scans * ENML_SCAN_PERIOD_S
        out.update(eager_realtime=stream_s / (out["eager_ms"] / 1e3),
                   program_realtime=stream_s / (out["program_ms"] / 1e3))
    return out


def _facts(prog) -> dict:
    g = prog.graph()
    return dict(capture_ms=g.capture_ms, graph_nodes=g.nodes,
                body_nodes=sum(g.body_nodes), pool_mib=g.pool_mib)


def _sweep_case(torch, name, st, o, scans=None):
    """batch_localize on `st`: eager twice, the program (its first call
    captures), the standard, one host read a sweep, no synchronising call,
    no kernel launched, and the walls."""
    import numpy as np

    from hitl_slam_torch.models.enml import localizer as L
    from hitl_slam_torch.models.enml.program import sweep_program

    args = (st.points, st.normals, st.point_mask, st.poses, o)
    eager, eager_ms = _timed_runs(
        lambda: L.batch_localize(*args, eager=True), 2)
    _reset_counts()
    rep = L.batch_localize(*args)
    _sync()
    check(_read_counts() == (0, 0), f"{name}: a kernel launched")
    check(np.isfinite(rep[0].cpu().numpy()).all(), f"{name}: poses")
    row = _standard(torch, name, rep, eager[0], eager[1], covs=1)
    prog = sweep_program(st.points, o, None)
    row["host_reads"] = _one_read(torch, name, lambda: torch.cat(
        [x.flatten() for x in L.batch_localize(*args)]).cpu())
    _no_sync(torch, name, lambda: L.batch_localize(*args))
    P = st.num_poses
    row.update(nodes=P, **_walls(
        torch, eager_ms, lambda: L.batch_localize(*args), prog, trips=P,
        nodes=P, scans=scans), **_facts(prog))
    log(f"[program] {name} ({P} nodes x {st.max_points} points): replay "
        f"{row['standard']} to eager (poses {row['max_pose_diff']:.1e}, "
        f"covariances {row['cov_rel_diff']:.1e}, eager runs bit-equal "
        f"{row['eager_bit_equal']}); sweep {row['eager_ms']:.1f} ms eager, "
        f"{row['program_ms']:.1f} ms program ({row['eager_ms_per_node']:.2f}"
        f" / {row['program_ms_per_node']:.3f} ms a node"
        + (f", realtime {row['eager_realtime']:.3f} / "
           f"{row['program_realtime']:.2f}" if scans else "")
        + f"); host reads {row['host_reads']['total']}; "
        f"{BUSY_NOT_MEASURED}; {row['graph_ops']} graph "
        f"operations ({row['graph_ops_per_node']:.0f} a node); capture "
        f"{row['capture_ms']:.1f} ms, {row['graph_nodes']} graph nodes "
        f"({row['body_nodes']} a trip), pool {row['pool_mib']:.1f} MiB")
    return row


def _segment_case(torch, name, st, o):
    """The session's segments: sweep_segment of ENML_PROGRAM_SEGMENT nodes
    from t0 = 0 until past the end of `st`, eager twice and by the
    program; one host read and no synchronising call a segment."""
    from hitl_slam_torch.models.enml import localizer as L
    from hitl_slam_torch.models.enml.program import sweep_program

    P, seg = st.num_poses, ENML_PROGRAM_SEGMENT
    pre = L.sweep_precompute(st.poses, o)
    maps = (st.points, st.normals, st.point_mask)
    cov0 = torch.zeros((P, 3, 3), device=st.poses.device)

    def tiles(eager):
        ps, cv = st.poses, cov0
        for t0 in range(0, P, seg):
            ps, cv = L.sweep_segment(*maps, ps, cv, pre, t0, o, seg,
                                     eager=eager)
        return ps, cv

    eager, eager_ms = _timed_runs(lambda: tiles(True), 2)
    _reset_counts()
    rep = tiles(False)
    _sync()
    check(_read_counts() == (0, 0), f"{name}: a kernel launched")
    row = _standard(torch, name, rep, eager[0], eager[1], covs=1)
    one = lambda: L.sweep_segment(*maps, st.poses, cov0, pre, 0, o, seg)  # noqa
    row["host_reads"] = _one_read(torch, name, lambda: one()[0].cpu())
    _no_sync(torch, name, one)
    prog = sweep_program(st.points, o, seg)
    tiles_n = -(-P // seg)
    row.update(nodes=P, segment=seg, segments=tiles_n,
               **_walls(torch, eager_ms, lambda: tiles(False), prog,
                        trips=tiles_n * seg, replays=tiles_n, nodes=P),
               **_facts(prog))
    log(f"[program] {name} ({P} nodes in segments of {seg}): replays "
        f"{row['standard']} to eager (poses {row['max_pose_diff']:.1e}, "
        f"covariances {row['cov_rel_diff']:.1e}); {row['eager_ms']:.1f} ms "
        f"eager, {row['program_ms']:.1f} ms program; host reads a segment "
        f"{row['host_reads']['total']}; {row['graph_ops']} graph "
        f"operations; capture "
        f"{row['capture_ms']:.1f} ms, {row['graph_nodes']} graph nodes, "
        f"pool {row['pool_mib']:.1f} MiB")
    return row


def _window_case(torch, name, stream, o):
    """The online localizer's window solve on the stream's last W nodes
    padded to ONLINE_POINTS points: eager twice and by the program, one
    host read and no synchronising call a window."""
    import numpy as np

    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.models.enml import localizer as L
    from hitl_slam_torch.models.enml.program import window_program

    _, poses, pcs, ncs = _episode_state(stream, "cpu")
    W = o.max_history
    st = make_map_state(poses[-W:], np.zeros((W, 3, 3), np.float32),
                        pcs[-W:], ncs[-W:], max_points=ONLINE_POINTS,
                        device=DEVICE)
    args = (st.points, st.normals, st.point_mask, st.poses, o)
    eager, eager_ms = _timed_runs(
        lambda: (L.single_window_localize(*args, eager=True),), 2)
    _reset_counts()
    rep = (L.single_window_localize(*args),)
    _sync()
    check(_read_counts() == (0, 0), f"{name}: a kernel launched")
    row = _standard(torch, name, rep, eager[0], eager[1])
    row["host_reads"] = _one_read(
        torch, name, lambda: L.single_window_localize(*args).cpu())
    _no_sync(torch, name, lambda: L.single_window_localize(*args))
    prog = window_program(st.points, o)
    row.update(window=[W, ONLINE_POINTS], **_walls(
        torch, eager_ms, lambda: L.single_window_localize(*args), prog),
        **_facts(prog))
    log(f"[program] {name} ([{W}, {ONLINE_POINTS}]): replay "
        f"{row['standard']} to eager (poses {row['max_pose_diff']:.1e}); "
        f"{row['eager_ms']:.2f} ms eager, {row['program_ms']:.3f} ms "
        f"program; host reads {row['host_reads']['total']}; "
        f"{row['graph_ops']} graph operations; "
        f"capture {row['capture_ms']:.1f} ms, {row['graph_nodes']} graph "
        f"nodes, pool {row['pool_mib']:.1f} MiB")
    return row


def _replica_case(torch, repaired):
    """Phase 15's replicas: batched_solve by its program against the eager
    batched_solve (twice), the batched LM alone (solve_batched, whose
    program has no build) likewise with its accept flags, one host
    read a batched solve, no synchronising call, B' launched once a step
    from the replays and the other kernels not at all, and the walls.
    Returns (the row, B' launches)."""
    import numpy as np

    from hitl_slam_torch.parallel.replicas import (batched_solve,
                                                   build_problems,
                                                   make_perturbed_replicas,
                                                   replica_program)
    from hitl_slam_torch.solver import bcr_kernel as B, lm
    from hitl_slam_torch.solver.lm import LMConfig

    config = LMConfig(max_iterations=REPLICA_ITERS)
    reps, tb = make_perturbed_replicas(repaired.poses.cpu().numpy(),
                                       repaired.constraints, REPLICAS,
                                       seed=0)
    fields = ("poses", "final_cost", "initial_cost", "iterations",
              "converged", "final_mu")
    as_tuple = lambda r: tuple(getattr(r, f) for f in fields)  # noqa: E731
    eager, eager_ms = _timed_runs(lambda: as_tuple(batched_solve(
        reps, tb, config, DEVICE, eager=True)), 2)
    batched_solve(reps, tb, config, DEVICE)         # captures
    _sync()
    _reset_counts()
    B.batched_launches.count = 0
    rep = batched_solve(reps, tb, config, DEVICE)
    _sync()
    steps = int(rep.iterations.max())
    n_batched = B.batched_launches.count
    check(n_batched == steps and _read_counts() == (0, 0),
          f"replica program: batched launches {n_batched} != {steps} steps "
          f"(em_scan, lone bcr {_read_counts()})")
    row = _standard(torch, "replica program", as_tuple(rep), *eager)
    check(int(rep.iterations.min()) >= 1, "replica program: no step")
    # the batched LM alone, with its accept flags
    prob = build_problems(reps, tb)
    acc_e, acc_p = [], []
    lm_e = lm.solve_batched(prob, reps, config, accepts=acc_e, eager=True)
    lm_p = lm.solve_batched(prob, reps, config, accepts=acc_p)
    check(torch.equal(lm_p.iterations, lm_e.iterations)
          and len(acc_p) == len(acc_e)
          and all(torch.equal(a, b) for a, b in zip(acc_p, acc_e)),
          "solve_batched's program: iterations or accept flags differ from "
          "eager")
    row["solve_batched_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(as_tuple(lm_p), as_tuple(lm_e)))
    row["host_reads"] = _one_read(torch, "replica program", lambda:
                                  batched_solve(reps, tb, config,
                                                DEVICE).poses.cpu())
    _no_sync(torch, "replica program",
             lambda: batched_solve(reps, tb, config, DEVICE))
    prog = replica_program(reps, tb, config)
    row.update(B=REPLICAS, n=int(reps.shape[1]), steps=steps,
               launches_bcr_batched=n_batched,
               iterations=np.asarray(rep.iterations.cpu()).tolist(),
               **_walls(torch, eager_ms,
                        lambda: batched_solve(reps, tb, config, DEVICE),
                        prog, trips=steps),
               **_facts(prog))
    log(f"[program] replicas (B={REPLICAS}, n={row['n']}, {steps} steps): "
        f"replay {row['standard']} to eager batched_solve (poses "
        f"{row['max_pose_diff']:.1e}; solve_batched's program bit-equal "
        f"{row['solve_batched_bit_equal']}, accept flags equal); "
        f"{row['eager_ms']:.2f} ms eager, {row['program_ms']:.2f} ms "
        f"program; host reads {row['host_reads']['total']}; B' launches "
        f"{n_batched} = steps; "
        f"{row['graph_ops']} graph operations; capture "
        f"{row['capture_ms']:.1f} ms, {row['graph_nodes']} graph nodes, "
        f"pool {row['pool_mib']:.1f} MiB")
    return row, n_batched


def phase_enml_program(torch, smi, stream, scale_state, repaired):
    """EnML's sweep, segments and online window and the replica batch's LM
    as device programs (models/enml/program.py, parallel/replicas.py,
    solver/lm.py; phases 10-13, 15 and 18 already ran them): each replay
    against the eager function on the same inputs, its host reads under
    the profiler, under sync debug mode "error", its launches, walls, busy
    share, capture ms, graph nodes and pool MiB. Returns (the record, B'
    launches from the replays)."""
    from hitl_slam_torch.models.enml import localizer as L

    t_phase = time.perf_counter()
    o = L.EnmlOptions()
    out = {"card": smi}
    st, _, _, _ = _episode_state(stream, DEVICE)
    out["test_size"] = _sweep_case(torch, "enml test size", st, o,
                                   scans=len(stream[0]))
    K = ENML_PROGRAM_PREFIX
    pre_st = _prefix(scale_state, K)
    out["scale_prefix"] = _sweep_case(torch, f"enml scale map, first {K} "
                                      f"nodes", pre_st, o)
    out["segments"] = _segment_case(torch, "enml session segments",
                                    _prefix(st, ENML_SEGMENT_NODES), o)
    out["window"] = _window_case(torch, "enml online window", stream, o)
    out["replicas"], n_batched = _replica_case(torch, repaired)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[program] EnML and replica programs: {out['seconds']:.1f} s "
        f"(budget {ENML_PROGRAM_SECONDS:.0f} s), B' replay launches "
        f"{n_batched}")
    return out, n_batched


def _prefix(st, K):
    """The first K nodes of a map state."""
    return st.replace(**{f: getattr(st, f)[:K] for f in (
        "poses", "covariances", "points", "normals", "point_mask",
        "odometry")})


# ---------------------------------------------------------------- phase 21

# a replay of the refine's program against eager post_human_refine from the
# same state, where two eager runs differ: poses within phase 5's PCG-
# against-dense bound, costs within phase 17's refine cost bound
REFINE_PROGRAM_POSE_TOL, REFINE_PROGRAM_COST_RTOL = PCG_ATOL, REFINE_COST_RTOL
REFINE_PROGRAM_INTS = ("iterations", "cg_iterations", "num_matches",
                       "pairs_dropped", "match_dropped", "vote_dropped",
                       "elect_dropped")
# the phase should finish within this many seconds
REFINE_PROGRAM_SECONDS = 60.0


def _refine_ints(out) -> dict:
    return {k: None if getattr(out, k) is None else int(getattr(out, k))
            for k in REFINE_PROGRAM_INTS}


def _refine_floats(out) -> tuple:
    return (out.poses, out.initial_cost, out.final_cost)


def _refine_case(torch, name, st, kw, half_kw):
    """post_human_refine(**kw) on `st`: eager (eager=True) twice, then the
    program (its first call captures); the integers equal, the floats
    bit-equal where the two eager runs are, else within the bounds; no
    kernel launched; one host read a refine; no synchronising call under
    sync debug mode "error"; the halves (match_factors, solve_factors with
    `half_kw`) eager and as programs; walls, graph nodes by WHILE level,
    capture ms, pool MiB and peak memory. Returns the row."""
    from hitl_slam_torch.models.hitl import refine as R
    from hitl_slam_torch.solver import bcr_kernel as B

    args = (st.points, st.normals, st.point_mask, st.poses, st.constraints)

    def refine(eager=False):
        return R.post_human_refine(*args, **kw, eager=eager)

    eager, eager_ms = _timed_runs(lambda: refine(eager=True), 2)
    _sync()
    _reset_counts()
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = refine()
    _sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = _peak_memory_mb(torch)
    launches = (*_read_counts(), B.batched_launches.count,
                B.multi_launches.count)
    check(launches == (0, 0, 0, 0),
          f"{name}: kernel launches {launches} on a path with none")
    ints, want = _refine_ints(rep), _refine_ints(eager[0])
    check(ints == want and _refine_ints(eager[1]) == want,
          f"{name}: replay integers {ints}, eager {want}")
    check(ints["num_matches"] > 0 and ints["iterations"] > 0,
          f"{name}: {ints}")
    e1, e2 = _refine_floats(eager[0]), _refine_floats(eager[1])
    got = _refine_floats(rep)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))  # noqa
    eager_equal, replay_equal = same(e1, e2), same(got, e1)
    dpose = float((got[0] - e1[0]).abs().max())
    dcost = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                for a, b in zip(got[1:], e1[1:]))
    if eager_equal:
        check(replay_equal, f"{name}: two eager runs are bit-equal, the "
              f"replay is not (poses {dpose:.3e}, costs {dcost:.3e})")
    else:
        check(dpose <= REFINE_PROGRAM_POSE_TOL
              and dcost <= REFINE_PROGRAM_COST_RTOL,
              f"{name}: replay {dpose:.3e} / {dcost:.3e} from eager (> "
              f"{REFINE_PROGRAM_POSE_TOL} / {REFINE_PROGRAM_COST_RTOL})")
    check(bool(torch.isfinite(got[0]).all())
          and float(got[2]) <= float(got[1]),
          f"{name}: poses not finite or cost rose {float(got[1])} -> "
          f"{float(got[2])}")
    g = R.refine_program(*args, **kw).graph()
    reads = _one_read(torch, name, lambda: refine().poses.cpu())
    _no_sync(torch, name, refine)
    program_ms = _timed_runs(refine, 3)[1]

    # the halves, each eager and as its own program
    def match(eager=False):
        return R.match_factors(*args[:4], **half_kw["match"], eager=eager)

    def solve(stf, eager=False):
        return R.solve_factors(st.poses, st.constraints, stf,
                               **half_kw["solve"], eager=eager)

    stf = match()[0]
    solve(stf)
    halves = {}
    for h, fn in (("match", lambda e: match(eager=e)),
                  ("solve", lambda e: solve(stf, eager=e))):
        halves[f"{h}_eager_ms"] = _timed_runs(lambda: fn(True), 2)[1]
        halves[f"{h}_program_ms"] = _timed_runs(lambda: fn(False), 3)[1]
    row = dict(poses=st.num_poses, points=st.max_points, **ints,
               standard="bit-equal" if replay_equal else "tolerance",
               eager_bit_equal=eager_equal, max_pose_diff=dpose,
               cost_rel_diff=dcost, initial_cost=float(got[1]),
               final_cost=float(got[2]), eager_ms=eager_ms,
               first_call_ms=first_ms, program_ms=program_ms, **halves,
               host_reads=reads, launches=list(launches),
               capture_ms=g.capture_ms, graph_nodes=g.nodes,
               loop_levels=g.levels, body_nodes=g.body_nodes,
               level_nodes=g.level_nodes, pool_mib=g.pool_mib,
               peak_mib=peak)
    log(f"[program] refine {name} ({st.num_poses} poses x "
        f"{st.max_points} points): replay {row['standard']} to eager "
        f"(poses {dpose:.1e}, costs {dcost:.1e}, eager runs bit-equal "
        f"{eager_equal}); LM {ints['iterations']}, CG "
        f"{ints['cg_iterations']}, matches {ints['num_matches']}, dropped "
        f"match {ints['match_dropped']} pairs {ints['pairs_dropped']} vote "
        f"{ints['vote_dropped']} elect {ints['elect_dropped']}; "
        f"{eager_ms:.2f} ms eager, {program_ms:.2f} ms program (first call "
        f"{first_ms:.1f} ms); match {halves['match_eager_ms']:.2f} / "
        f"{halves['match_program_ms']:.2f} ms, solve "
        f"{halves['solve_eager_ms']:.2f} / {halves['solve_program_ms']:.2f}"
        f" ms (eager / program); host reads {reads['total']}; launches "
        f"{launches}; capture {g.capture_ms:.1f} ms, {g.nodes} graph nodes, "
        f"nodes by WHILE level {g.level_nodes}, loops' levels {g.levels}, "
        f"pool {g.pool_mib:.1f} MiB, peak {peak:.0f} MiB")
    return row


def _post_optimize_reads(torch, repaired) -> dict:
    """post_optimize on a fresh engine at `repaired`: one host read with
    the global matcher's matches (auto) and with the pair matcher."""
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    out = {}
    for matcher in ("auto", "pair"):
        eng = HitLSLAM(device=DEVICE)
        eng.init_from_state(repaired)
        eng.post_optimize(matcher=matcher)       # captures
        reads = _dispatched_reads(torch, lambda: out.__setitem__(
            matcher, eng.post_optimize(matcher=matcher)))
        rep = out[matcher]
        check(reads["total"] == 1 and rep.accepted,
              f"post_optimize({matcher}): {reads} host reads, not one")
        out[matcher] = dict(reads=reads, reason=rep.reason,
                            lm_iterations=rep.lm_iterations)
    log(f"[program] post_optimize on the repaired map: host reads "
        + "; ".join(f"{m} {r['reads']['total']} ({r['reason']})"
                    for m, r in out.items()))
    return out


def phase_refine_program(torch, smi, repaired, s8192):
    """The post-human refine as a device program (models/hitl/refine.py:
    one CUDA graph of the match and the LM, the CG loop a WHILE node
    inside the LM's; phases 5, 17 and 18 already ran it): phase 5's
    repaired 1024-pose map (auto, which picks dense_fused, then dense, pcg
    and the pair matcher) and phase 17's 8192-pose session state (pcg, the
    pair matcher, the record's capacities), each replay against eager, its
    host reads and sync, its halves; post_optimize's host reads. Returns
    the record."""
    from hitl_slam_torch import bench_sessions as S
    from hitl_slam_torch.solver.lm import LMConfig

    t_phase = time.perf_counter()
    out = {"card": smi}
    cfg = LMConfig(max_iterations=30)
    cases = {}
    for name, kw in (("dense_fused", dict(config=cfg)),
                     ("dense", dict(config=cfg, solver="dense")),
                     ("pcg", dict(config=cfg, solver="pcg")),
                     ("pair", dict(config=cfg, matcher="pair"))):
        half = dict(match=dict(matcher=kw.get("matcher", "global"),
                               capacity=65536, max_pairs=8192, bucket=64,
                               max_cells=None),
                    solve=dict(config=cfg, include_chain=True,
                               solver=kw.get("solver", "auto"),
                               max_pairs=8192))
        cases[f"1024_{name}"] = _refine_case(torch, f"1024 {name}", repaired,
                                             kw, half)
    big = S.REFINE_AT_SCALE
    cfg8 = LMConfig(max_iterations=big["max_iterations"])
    kw = dict(capacity=big["capacity"], config=cfg8, matcher=big["matcher"],
              max_pairs=big["max_pairs"])
    half = dict(match=dict(matcher=big["matcher"], capacity=big["capacity"],
                           max_pairs=big["max_pairs"], bucket=64,
                           max_cells=None),
                solve=dict(config=cfg8, include_chain=True, solver="auto",
                           max_pairs=big["max_pairs"]))
    cases["8192_pair_pcg"] = _refine_case(torch, "8192 pair pcg", s8192, kw,
                                          half)
    out["cases"] = cases
    out["post_optimize"] = _post_optimize_reads(torch, repaired)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[program] refine programs: {out['seconds']:.1f} s (budget "
        f"{REFINE_PROGRAM_SECONDS:.0f} s)")
    return out


# ---------------------------------------------------------------- phase 22

# the phase should finish within this many seconds
LOOP_PROGRAM_SECONDS = 90.0


def _pose_cov_close(rep, e):
    """(poses, covariances) within phase 11's card-against-CPU bounds:
    (ok, the differences)."""
    dp = float((rep[0] - e[0]).abs().max())
    scale = e[1].abs().amax(dim=(-2, -1), keepdim=True).clamp(min=1e-30)
    dc = float(((rep[1] - e[1]).abs() / scale).max())
    return dp <= CB_POSE_ATOL and dc <= CB_COV_RTOL, f"poses {dp:.2e}, " \
        f"covariances {dc:.2e} (bounds {CB_POSE_ATOL}, {CB_COV_RTOL})"


def _sdf_close(rep, e):
    """(values, weights) within phase 9's card-against-CPU bounds."""
    dv, dw = (rep[0] - e[0]).abs(), (rep[1] - e[1]).abs()
    n_v = int((dv > SDF_VALUE_ATOL).sum())
    n_w = int((dw > SDF_WEIGHT_ATOL).sum())
    allowed = SDF_OUTLIER_SHARE * dv.numel()
    return n_v <= allowed and n_w <= allowed, (
        f"{n_v} values > {SDF_VALUE_ATOL} and {n_w} weights > "
        f"{SDF_WEIGHT_ATOL} of {dv.numel()} pixels (<= {allowed:.0f})")


def _segments_close(rep, e):
    """Segments: counts and valid flags equal, endpoints and centroids
    within phase 7's selection bound, scatters within it relative to their
    largest entry."""
    import torch

    ints = all(torch.equal(a, b) for a, b in zip(rep[2:4], e[2:4]))
    d = max(float((a - b).abs().max()) for a, b in
            ((rep[0], e[0]), (rep[1], e[1]), (rep[5], e[5])))
    ds = float((rep[6] - e[6]).abs().max()
               / e[6].abs().max().clamp(min=1e-30))
    return ints and d <= SEL_ATOL and ds <= SEL_ATOL, (
        f"counts and flags equal {ints}, points {d:.2e}, scatter {ds:.2e} "
        f"(bound {SEL_ATOL})")


def _segment_fields(seg):
    return (seg.p1, seg.p2, seg.count, seg.valid, seg.mass, seg.centroid,
            seg.scatter)


def _loop_case(torch, name, call, fields, prog, close, nodes=None,
               expect=None):
    """`call(eager)` (an entry point with `eager=eager`) on the card: eager
    twice, then the program (its first call captures); `fields(result)`
    bit-equal where the two eager runs are, else `close` (the standard
    that held is printed); the kernels the program's first call launched,
    by the launch counters (device counters in a replay): (em_scan, BCR,
    batched BCR, multi BCR) = `expect(result)`, or none without `expect`;
    one host read a call; no synchronising call under sync debug mode
    "error"; eager and program walls, graph nodes by WHILE level, capture
    ms and pool MiB of `prog()` (its DeviceProgram). Returns the row."""
    from hitl_slam_torch.solver import bcr_kernel as B

    eager, eager_ms = _timed_runs(lambda: call(True), 2)
    _sync()
    _reset_counts()
    t0 = time.perf_counter()
    rep = call(False)
    _sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = (*_read_counts(), B.batched_launches.count,
                B.multi_launches.count)
    want = (0, 0, 0, 0) if expect is None else tuple(expect(rep))
    check(launches == want,
          f"{name}: kernel launches (em_scan, bcr, batched, multi) "
          f"{launches}, not {want}")
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))  # noqa
    e1, e2, got = fields(eager[0]), fields(eager[1]), fields(rep)
    eager_equal, replay_equal = same(e1, e2), same(got, e1)
    ok, diff = close(got, e1)
    if eager_equal:
        check(replay_equal, f"{name}: two eager runs are bit-equal, the "
              f"replay is not ({diff})")
    else:
        check(ok, f"{name}: replay beyond the bounds of eager ({diff})")
    reads = _one_read(torch, name, lambda: fields(call(False))[0].cpu())
    _no_sync(torch, name, lambda: call(False))
    program_ms = _timed_runs(lambda: call(False), 3)[1]
    g = prog().graph()
    row = dict(standard="bit-equal" if replay_equal else "tolerance",
               eager_bit_equal=eager_equal, diff=diff, eager_ms=eager_ms,
               first_call_ms=first_ms, program_ms=program_ms,
               host_reads=reads, launches=list(launches),
               capture_ms=g.capture_ms, graph_nodes=g.nodes,
               loop_levels=g.levels, body_nodes=g.body_nodes,
               level_nodes=g.level_nodes, pool_mib=g.pool_mib)
    if nodes:
        row.update(eager_ms_per_node=eager_ms / nodes,
                   program_ms_per_node=program_ms / nodes)
    log(f"[program] {name}: replay {row['standard']} to eager ({diff}; "
        f"eager runs bit-equal {eager_equal}); {eager_ms:.2f} ms eager, "
        f"{program_ms:.2f} ms program (first call {first_ms:.1f} ms)"
        + (f", {eager_ms / nodes:.3f} / {program_ms / nodes:.3f} ms a node"
           if nodes else "")
        + f"; host reads {reads['total']}; launches {launches}; capture "
        f"{g.capture_ms:.1f} ms, {g.nodes} graph nodes, nodes by WHILE "
        f"level {g.level_nodes}, loops' levels {g.levels}, pool "
        f"{g.pool_mib:.1f} MiB")
    return row


def _checkerboard_cases(torch, stream, scale_state) -> dict:
    from hitl_slam_torch.models.enml import localizer as L
    from hitl_slam_torch.models.enml import parallel_localizer as CB
    from hitl_slam_torch.models.enml.program import checkerboard_program

    st = _episode_state(stream, DEVICE)[0]
    test = (st.points, st.normals, st.point_mask, st.poses)
    grid = tuple(a[:CB_GRID_NODES] for a in test)
    big = (scale_state.points, scale_state.normals, scale_state.point_mask,
           scale_state.poses)
    cases = (("test size, brute", test, {}, dict(chunk=8)),
             ("test size, grid", grid, CB_GRID_OPTS,
              dict(n_passes=1, force_grid=True, chunk=8)),
             *((f"scale map {name}", big, okw, dict(chunk=chunk))
               for name, okw, chunk in CB_SCALE))
    out = {}
    for name, args, okw, kw in cases:
        o = L.EnmlOptions(**okw)
        full = {"n_passes": 2, "force_grid": False, **kw}

        def call(eager, args=args, o=o, kw=kw):
            return CB.checkerboard_localize(*args, o, **kw, eager=eager)

        out[name] = _loop_case(
            torch, f"checkerboard {name}", call, tuple,
            lambda args=args, o=o, full=full: checkerboard_program(
                args[0], o, full["n_passes"], full["chunk"],
                full["force_grid"]),
            _pose_cov_close, nodes=args[0].shape[0])
    return out


def _sdf_and_curate_cases(torch, maps) -> dict:
    import numpy as np

    from hitl_slam_torch.models.ltvm.curator import LongTermVectorMap
    from hitl_slam_torch.ops import ransac, sdf as S
    from hitl_slam_torch.ops.geometry import pose_to_world

    out = {}
    params = S.SdfParams()
    for name, st in maps.items():
        world = pose_to_world(st.poses[:, None, :], st.points)
        lo, hi = S.sdf_bounds(world, st.point_mask, params.image_border)
        res = params.image_resolution
        width = int(np.ceil((hi[0] - lo[0]) / res))
        height = int(np.ceil((hi[1] - lo[1]) / res))
        origin = torch.as_tensor(lo, device=DEVICE)

        def sdf(eager, st=st, origin=origin, height=height, width=width):
            return S.build_sdf(st.poses, st.points, st.point_mask, origin,
                               height, width, params, eager=eager)

        out[f"build_sdf {name}"] = _loop_case(
            torch, f"build_sdf {name} ({st.num_poses} poses, {height} x "
            f"{width})", sdf, lambda img: (img.values, img.weights),
            lambda st=st, height=height, width=width: S.sdf_program(
                st.poses, st.points, height, width, params), _sdf_close,
            nodes=st.num_poses)
        keep = S.filter_points(sdf(False), world, st.point_mask, params)
        rp = ransac.RansacParams()
        u = ransac.uniform_draws(0, rp, DEVICE)
        pts, msk = world.reshape(-1, 2), keep.reshape(-1)

        def segs(eager, pts=pts, msk=msk, u=u, rp=rp):
            return ransac.extract_segments(pts, msk, u, rp, eager=eager)

        out[f"extract_segments curate {name}"] = _loop_case(
            torch, f"extract_segments (curate) {name} ({tuple(pts.shape)})",
            segs, _segment_fields,
            lambda pts=pts, rp=rp: ransac.ransac_program(pts, rp),
            _segments_close)

        def curate(eager, st=st):
            timings = {}
            with eager_loops() if eager else contextlib.nullcontext():
                vectors = LongTermVectorMap(seed=0).curate(
                    st.poses, st.points, st.point_mask, timings_ms=timings)
            return vectors, timings

        runs = {}
        for eager in (True, False):
            curate(eager)
            walls = []
            for _ in range(2):
                _sync()
                t0 = time.perf_counter()
                vectors, timings = curate(eager)
                walls.append(((time.perf_counter() - t0) * 1e3, timings,
                              vectors))
            runs["eager" if eager else "program"] = min(
                walls, key=lambda w: w[0])
        same = _same_vectors(runs["eager"][2], runs["program"][2])
        check(len(runs["eager"][2]) == len(runs["program"][2]),
              f"curate {name}: {len(runs['program'][2])} vectors from the "
              f"programs, {len(runs['eager'][2])} eagerly")
        row = {k: dict(wall_ms=w, **t) for k, (w, t, _) in runs.items()}
        row["vectors_bit_equal"] = same
        split = "; ".join(
            f"{k} {row['eager'][k]:.1f} / {row['program'][k]:.1f}"
            for k in ("wall_ms", "sdf_ms", "filter_ms", "ransac_ms",
                      "merge_ms"))
        log(f"[program] curate {name}: eager / program {split} ms; "
            f"{len(runs['program'][2])} vectors, bit-equal {same}")
        out[f"curate {name}"] = row
    return out


def _proposal_cases(torch) -> dict:
    import numpy as np

    from hitl_slam_torch.io.figure8 import generate_figure8
    from hitl_slam_torch.models.hitl import propose as P
    from hitl_slam_torch.ops import ransac, scan_match

    eng = _fig8_engine(generate_figure8(**DRIFTED_MAP), DEVICE)
    st = eng.state
    poses_np = st.poses.cpu().numpy()
    rp = P.PROPOSAL_RANSAC
    out = {}
    for min_gap, want_B in ((None, 4), (FULL_BATCH_MIN_GAP, 8)):
        chosen = P.candidate_pairs(poses_np, max_proposals=4, min_gap=min_gap)
        B = len(chosen)
        check(B == want_B, f"min_gap={min_gap}: {B} candidates, not {want_B}")
        a_pts, a_mask, centers, scans, scan_masks, guesses = (
            P.candidate_inputs(st, st.world_points(), poses_np, chosen))
        fields = scan_match.build_likelihood_field(a_pts, a_mask, centers)
        matched = scan_match.correlative_match(fields, centers, scans,
                                               scan_masks, guesses)[0]
        scans_w = P.place_scans(scans, matched)
        u = ransac.uniform_draws(0, rp, DEVICE, batch=2 * B)
        for side, pts, msk, uu in (("anchor", a_pts, a_mask, u[:B]),
                                   ("corrected", scans_w, scan_masks, u[B:])):
            def segs(eager, pts=pts, msk=msk, uu=uu):
                return ransac.extract_segments(pts, msk, uu, rp, eager=eager)

            out[f"extract_segments {side} B={B}"] = _loop_case(
                torch, f"extract_segments (propose, {side} side) B={B} "
                f"({tuple(pts.shape)})", segs, _segment_fields,
                lambda pts=pts: ransac.ransac_program(pts, rp),
                _segments_close)

        def propose(eager, min_gap=min_gap):
            with eager_loops() if eager else contextlib.nullcontext():
                return eng.propose_corrections(max_proposals=4, seed=0,
                                               min_gap=min_gap)

        walls = {}
        for eager in (True, False):
            got, ms = _timed_runs(lambda: propose(eager), 3)
            walls["eager" if eager else "program"] = (ms, got[-1])
        _same_proposals(f"propose_corrections B={B}, programs against eager",
                        walls["program"][1], walls["eager"][1])
        for a, b in zip(walls["program"][1], walls["eager"][1]):
            check(np.array_equal(a.input.points, b.input.points)
                  and a.score == b.score,
                  f"propose_corrections B={B}: the programs' proposals are "
                  "not the eager ones")
        ransac_split = {k: sum(out[f"extract_segments {s} B={B}"][f"{k}_ms"]
                               for s in ("anchor", "corrected"))
                        for k in ("eager", "program")}
        out[f"propose_corrections B={B}"] = dict(
            eager_ms=walls["eager"][0], program_ms=walls["program"][0],
            proposals=len(walls["program"][1]),
            ransac_eager_ms=ransac_split["eager"],
            ransac_program_ms=ransac_split["program"])
        log(f"[program] propose_corrections B={B}: eager / program "
            f"{walls['eager'][0]:.2f} / {walls['program'][0]:.2f} ms, of "
            f"which RANSAC (both sides, alone) {ransac_split['eager']:.2f} / "
            f"{ransac_split['program']:.2f} ms; "
            f"{len(walls['program'][1])} proposals, identical")
    return out


def phase_loop_programs(torch, smi, stream, scale_state, repaired, clean):
    """The checkerboard localizer, build_sdf and RANSAC's extract_segments
    as device programs (one CUDA graph each, every loop a WHILE node:
    2 n_passes + 2 chunk loops, with the grid matcher a window loop inside
    each chunk trip; the SDF's pose loop; RANSAC's round loop; phases 7, 9
    and 11 already ran them): each replay against `eager=True` from the
    same inputs, on the test-size stream (both routes), the scale map at
    W = 10 and W = 80, the repaired 1024-pose golden map and the clean
    figure-8 (the SDF, curate's RANSAC, and curate eager against programs
    with its stage split) and phase 7's proposals at B = 4 and 8 (each
    side's RANSAC, and propose_corrections eager against programs); the
    memory the allocator holds after it. Returns the record."""
    from hitl_slam_torch.core.state import make_map_state

    t_phase = time.perf_counter()
    out = {"card": smi}
    out["checkerboard"] = _checkerboard_cases(torch, stream, scale_state)
    maps = {"golden_large (repaired)": repaired,
            "figure-8 (clean)": make_map_state(
                clean.gt_poses, clean.covariances, clean.point_clouds,
                clean.normal_clouds, device=DEVICE)}
    out["ltvm"] = _sdf_and_curate_cases(torch, maps)
    out["propose"] = _proposal_cases(torch)
    _sync()
    out["memory_reserved_mib"] = torch.cuda.memory_reserved() / 2 ** 20
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[program] loop programs: {out['seconds']:.1f} s (budget "
        f"{LOOP_PROGRAM_SECONDS:.0f} s); memory reserved after the phase "
        f"{out['memory_reserved_mib']:.0f} MiB ({smi})")
    return out


# ---------------------------------------------------------------- phase 23

# the phase should finish within this many seconds
SOLVE_PROGRAM_SECONDS = 90.0


def _lm_fields(res):
    return (res.poses, res.final_cost, res.initial_cost, res.iterations,
            res.converged)


def _lm_close(rep, e):
    """An LMResult's fields within phase 16's card-against-CPU bounds:
    poses MESH_CPU_POSE_TOL, final cost MESH_CPU_COST_RTOL relative."""
    dp = float((rep[0] - e[0]).abs().max())
    dc = abs(float(rep[1]) - float(e[1])) / max(abs(float(e[1])), 1e-30)
    return dp <= MESH_CPU_POSE_TOL and dc <= MESH_CPU_COST_RTOL, (
        f"poses {dp:.2e}, cost {dc:.2e} relative (bounds "
        f"{MESH_CPU_POSE_TOL}, {MESH_CPU_COST_RTOL}), iterations "
        f"{int(rep[3])} / {int(e[3])}")


def _repair_fields(out):
    return (out.poses, out.lm.final_cost, out.lm.initial_cost,
            out.lm.iterations, out.lm.converged, out.covariances,
            out.num_new_constraints, out.pre_solve_poses,
            *vars(out.constraints).values())


def _repair_case_args(torch, large, large_log):
    """repair_step's arguments on the map of phases 4-5 after its first
    logged correction (a replay of the engine's cycle program), for its
    second: the selection verified, refit and counted on the card and
    ordered by the host's order_and_filter; and the program's example
    (the scalars as int32 tensors)."""
    import numpy as np

    from hitl_slam_torch.models.hitl import em_input as EI

    eng = _engine(large, 16384)
    rep = eng.replay_log(large_log[0], record=True)
    check(rep.accepted, f"repair_step case: first correction {rep.reason}")
    st, entry = eng.state, large_log[1]
    world = st.world_points()
    raw = torch.as_tensor(np.asarray(entry.points, np.float32),
                          device=DEVICE)
    check(bool(EI.verify_input(world, st.point_mask, raw).all()),
          "repair_step case: the second correction's clicks not verified")
    refit = EI.endpoint_adjust_batch(
        world, st.point_mask, torch.stack([raw[0:2], raw[2:4]])
    ).reshape(4, 2)
    c1, c2 = EI.observation_counts(world, st.point_mask, refit)
    o = EI.order_and_filter(c1.cpu().numpy(), c2.cpu().numpy(),
                            refit.cpu().numpy())
    check(o.valid, "repair_step case: ordering invalid")
    corr, anch = o.corrected_poses, o.anchor_poses
    breaks = np.nonzero(np.diff(corr) > 1)[0]
    group = corr[:breaks[0] + 1] if len(breaks) else corr
    gmask = np.zeros(st.num_poses, bool)
    gmask[group] = True
    pad = lambda ix: np.concatenate(   # noqa: E731
        [ix[:64], np.full(64 - min(len(ix), 64), -1)]).astype(np.int32)
    T = lambda a: torch.as_tensor(a, device=DEVICE)   # noqa: E731
    ints = [torch.as_tensor(v, dtype=torch.int32, device=DEVICE)
            for v in (int(group[-1]), o.backprop_start, o.backprop_end,
                      int(st.constraints.active.sum()))]
    sel, gm, a_ix, c_ix = (T(o.selected_points.astype(np.float32)),
                           T(gmask), T(pad(anch)), T(pad(corr)))
    args = (st.poses, st.covariances, st.constraints,
            int(entry.correction_type), sel, gm, ints[0], a_ix, c_ix,
            ints[1], ints[2], ints[3])
    example = (st.poses, st.covariances, st.constraints, sel, gm, ints[0],
               a_ix, c_ix, ints[1], ints[2], ints[3])
    return args, example, len(group)


def phase_solve_programs(torch, smi, solve_inputs, repaired, large,
                         large_log):
    """The lone LM, repair_step and the pose-sharded LM as device programs
    (solver/lm.py::solve_program, models/hitl/repair.py::repair_program,
    parallel/sharded_solver.py::sharded_program: one CUDA graph each, the
    LM loop a WHILE node; phases 15-18 already ran the first): each replay
    against `eager=True` from the same inputs, for the lone solve at 8192
    poses with BIG_CONFIG (phase 17's joint solve), repair_step on the map
    of phases 4-5 after its first correction (its second correction), and
    the SPIKE at d = 4 and 8 on the repaired 1024-pose map and at d = 8 on
    the 16384-pose chain (MESH_ITERS): bit-equal wherever two eager runs
    are, else within phase 16's card-against-CPU bounds; BCR (the SPIKE:
    its multi route) launched once a trip and no other kernel; one host
    read a call; each under sync debug mode "error"; eager and program
    walls, graph nodes by WHILE level, capture ms, pool MiB. Returns the
    record and the (lone BCR, multi BCR) launches of the programs' first
    calls."""
    from hitl_slam_torch.bench import seeded_chain
    from hitl_slam_torch.bench_sessions import BIG_CONFIG
    from hitl_slam_torch.core.state import ConstraintTable
    from hitl_slam_torch.models.hitl import repair as R
    from hitl_slam_torch.parallel import sharded_solver as S
    from hitl_slam_torch.parallel.mesh import make_mesh
    from hitl_slam_torch.solver import joint, lm
    from hitl_slam_torch.solver.lm import LMConfig

    t_phase = time.perf_counter()
    out = {"card": smi}
    n_bcr = n_multi = 0

    # ---- the lone LM at 8192 poses ----
    chain, *cols = solve_inputs
    problem = joint.build_problem(chain, ConstraintTable(*cols))
    P = int(chain.shape[0])
    out[f"solve {P}"] = row = _loop_case(
        torch, f"lm.solve {P} poses, {BIG_CONFIG.max_iterations} "
        f"iterations at most",
        lambda eager: lm.solve(problem, chain, BIG_CONFIG, eager=eager),
        _lm_fields, lambda: lm.solve_program((problem, chain), BIG_CONFIG),
        _lm_close, expect=lambda r: (0, int(r.iterations), 0, 0))
    n_bcr += row["launches"][1]

    # ---- repair_step ----
    args, example, n_group = _repair_case_args(torch, large, large_log)
    config = LMConfig()
    row = _loop_case(
        torch, f"repair_step {large.poses.shape[0]} poses ({n_group} "
        f"corrected)",
        lambda eager: R.repair_step(*args, lm_config=config, eager=eager),
        _repair_fields,
        lambda: R.repair_program(example, args[3], config), _lm_close,
        expect=lambda r: (0, int(r.lm.iterations), 0, 0))
    out["repair_step"] = row
    n_bcr += row["launches"][1]

    # ---- the SPIKE on one card ----
    card = torch.device(DEVICE, 0)
    config = LMConfig(max_iterations=MESH_ITERS)
    chain_np, table = seeded_chain(MESH_CHAIN_POSES, 0, card)
    long_chain = torch.as_tensor(chain_np, device=card)
    cases = [(f"sharded d={d}, {repaired.num_poses} poses", repaired.poses,
              repaired.constraints, d) for d in MESH_PARTITIONS]
    cases.append((f"sharded d={MESH_CHAIN_PARTITIONS}, {MESH_CHAIN_POSES}-"
                  f"pose chain", long_chain, table, MESH_CHAIN_PARTITIONS))
    for name, poses, tab, d in cases:
        problem = joint.build_problem(poses, tab)
        mesh = make_mesh(1, d, [card] * d)
        row = _loop_case(
            torch, name,
            lambda eager, mesh=mesh, problem=problem, poses=poses:
                S.sharded_lm_solve(mesh, problem, poses, config, eager=eager),
            _lm_fields,
            lambda problem=problem, poses=poses, d=d: S.sharded_program(
                (problem, poses), config, d, card),
            _lm_close, expect=lambda r: (0, 0, 0, int(r.iterations)))
        out[name] = row
        n_multi += row["launches"][3]
    _sync()
    out["memory_reserved_mib"] = torch.cuda.memory_reserved() / 2 ** 20
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[program] solve programs: {out['seconds']:.1f} s (budget "
        f"{SOLVE_PROGRAM_SECONDS:.0f} s); memory reserved after the phase "
        f"{out['memory_reserved_mib']:.0f} MiB ({smi})")
    return out, n_bcr, n_multi


# ---------------------------------------------------------------- phase 24

def phase_times(torch, state, log_entries):
    """Each kernel at the main path's shapes (em_scan on the golden_large
    map, BCR at its 1024 poses), beside its plain version, its bound and
    (BCR) the dense library solve; BCR also at 64, 16384 and 32768 poses."""
    from hitl_slam_torch.ops import em_scan as E
    from hitl_slam_torch.solver import bcr_kernel as B, tridiag

    out = {}
    world = state.world_points().contiguous()
    mask = state.point_mask
    P, N = mask.shape
    s0 = torch.as_tensor(log_entries[0].points, dtype=torch.float32,
                         device=DEVICE)
    run = lambda: E.em_scan_cuda(world, mask, s0)   # noqa: E731
    ms = time_cuda(run, 200)
    dev_ms, _, dev_all = device_ms(run, "em_scan_kernel")
    plain_ms = time_cuda(lambda: E.em_scan_reference(world, mask, s0), 200)
    bound_ms, bound_by = bound(*em_scan_work(mask))
    log(f"[time] em_scan P={P} N={N}: events {ms:.5f} ms, device "
        f"{dev_ms:.5f} ms (all device work a call {dev_all:.5f} ms), plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})")
    out["em_scan"] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)

    for n in (64, 1024, 16384, 32768):
        _, (Dt, Ut, bt) = _bcr_inputs(torch, n)
        fn = lambda: B.bcr_solve_cuda(Dt, Ut, bt)   # noqa: E731
        ms = time_cuda(fn, 100)
        per_launch, dev_ms, dev_all = device_ms(fn, "bcr_")
        plan = B.launch_plan(n)
        log(f"[time] bcr n={n} ({plan.route} of {plan.blocks}, top "
            f"{plan.top}): events {ms:.5f} ms, device {dev_ms:.5f} ms a call "
            f"({per_launch:.5f} ms a launch; all device work a call "
            f"{dev_all:.5f} ms)")
        if n == 1024:
            plain_ms = time_cuda(lambda: tridiag.bcr_solve(Dt, Ut, bt), 20)
            bound_ms, bound_by = bound(*bcr_work(n))
            H, rhs = _dense_system(torch, Dt, Ut, bt)
            library_ms = time_cuda(lambda: torch.linalg.solve(H, rhs), 20)
            log(f"[time] bcr n={n}, the path's: plain {plain_ms:.4f} ms, "
                f"dense torch.linalg.solve {library_ms:.4f} ms, bound "
                f"{bound_ms:.6f} ms ({bound_by})")
            # a launch: the profiler's dropped records deflate the mean a
            # call (all 50 calls, over the records it delivered)
            out["bcr_solve"] = dict(ms=ms, device_ms=per_launch,
                                    device_ms_per_call=dev_ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by=bound_by, library_ms=library_ms)
    return out


# ---------------------------------------------------------------- main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import hitl_slam_torch
    except ImportError as e:
        print(f"chip_smoke: the hitl_slam_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    pkg_dir = os.path.dirname(os.path.abspath(hitl_slam_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE or not os.path.isdir(DATA):
        print(f"chip_smoke: run from a checkout of the repository "
              f"(package at {pkg_dir}, data at {DATA})", file=sys.stderr)
        return 2

    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.utils import cuda_build

    t_start = time.perf_counter()
    # ---- 1. device facts + build ----
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] torch.cuda.get_device_name: {kind}; count "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    cuda_build.library()
    info = cuda_build.build_info
    how = ("cached" if info.cached
           else f"nvcc, {len(cuda_build.SOURCES)} sources in parallel")
    log(f"[build] {info.path} in {time.perf_counter() - t0:.1f} s ({how})")
    log_ptxas("build", info.log)

    small = stfs.load_stfs_covars(os.path.join(DATA, "golden.stfs.covars"))
    small_log = logs.load_log(os.path.join(DATA, "golden.log"))
    large = stfs.load_stfs_covars(
        os.path.join(DATA, "golden_large.stfs.covars.gz"))
    large_log = logs.load_log(os.path.join(DATA, "golden_large.log"))
    check(len(large.poses) == 1024, "golden_large must have 1024 poses")
    state = make_map_state(large.poses, large.covariances, large.point_clouds,
                           large.normal_clouds, device=DEVICE)

    # ---- 2. em_scan kernel vs plain ----
    em_err = phase_em_scan(torch, state, large_log)
    # ---- 3. bcr kernel vs plain vs f64 ----
    bcr_err = phase_bcr(torch)
    # ---- 3b. the LM trip kernel vs plain ----
    n_step, step_gap, step_times = phase_lm_step(torch)
    # ---- 3c. the EM refit kernel vs plain ----
    n_refit, refit_gap, refit_times = phase_em_refit(torch)
    # ---- 4. the main path ----
    (n_em, n_bcr), repaired = phase_main(torch, small, small_log, large,
                                         large_log)
    check(n_em > 0 and n_bcr > 0, "a kernel was not launched on the main path")
    # ---- 5. the refine ----
    refine_map = phase_refine(torch, large, large_log, 16384)
    # ---- 6. one speculative correction ----
    s_em, s_bcr = phase_speculative(torch, large, large_log[0], 16384)
    n_em, n_bcr = n_em + s_em, n_bcr + s_bcr
    # ---- 7. proposals and auto-repair ----
    fig8_eng, clean, a_em, a_bcr = phase_proposals(torch)
    n_em, n_bcr = n_em + a_em, n_bcr + a_bcr
    # ---- 8. render ----
    phase_render(torch, fig8_eng)
    # ---- 9. LTVM ----
    phase_ltvm(torch, large, large_log, clean)
    # ---- 10. EnML ----
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        enml, stream, scale, bag = phase_enml(torch, smi, tmp)
        # ---- 11. the checkerboard localizer ----
        enml["checkerboard"] = phase_checkerboard(torch, smi, stream, scale)
        # ---- 12. an interactive EnML session with loop corrections ----
        enml["session"], s_em, s_bcr = phase_session(torch, smi, tmp)
        n_em, n_bcr = n_em + s_em, n_bcr + s_bcr
        # ---- 13. the online localizer through cli_enml ----
        enml["online"] = phase_online(torch, smi, bag, tmp)
        # ---- 14. one round trip through the GUI bridge ----
        enml["gui"], g_em, g_bcr = phase_gui(torch, smi, small, small_log,
                                             tmp)
        n_em, n_bcr = n_em + g_em, n_bcr + g_bcr
        print(json.dumps({"enml": enml}), flush=True)
        # ---- 15. the replica batch, repair_step, the native libraries ----
        replicas, n_batched, batched_err, batched_times, replica_out = (
            phase_replicas(torch, smi, repaired, small, small_log, bag, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"replicas": replicas}), flush=True)
    # ---- 16. the mesh ----
    mesh, n_multi, multi_err, multi_times = phase_mesh(
        torch, smi, repaired, stream, scale, replica_out)
    enml_scale = enml_scale_from_phases(enml, scale)
    scale_state = scale["state"]
    del scale, replica_out
    print(json.dumps({"mesh": mesh}), flush=True)
    # ---- 17. the reference's sessions at its sizes ----
    scale, s_em, s_bcr, scale_err, scale_times, sections = phase_scale(
        torch, smi)
    print(json.dumps({"scale": scale}), flush=True)
    # ---- 18. the rest of the reference's bench record ----
    peaks = [scale[k].get("peak_memory_mib") for k in ("s8192", "s16384")]
    reference, r_em, r_bcr, r_batched = phase_reference(
        torch, smi, sections, enml_scale, peaks)
    print(json.dumps({"reference": reference}), flush=True)
    # ---- 19. the cycle as a device program ----
    program, p_em, p_bcr = phase_program(torch, smi, large, large_log,
                                         sections)
    s8192 = sections["scale_8192"]["_session"]["engine"].state
    solve_inputs = sections["joint_solve"]["_inputs"]
    del sections
    print(json.dumps({"program": program}), flush=True)
    # ---- 20. EnML and the replica LM as device programs ----
    enml_program, q_batched = phase_enml_program(torch, smi, stream,
                                                 scale_state, repaired)
    print(json.dumps({"enml_program": enml_program}), flush=True)
    # ---- 21. the refine as a device program ----
    refine_program = phase_refine_program(torch, smi, refine_map, s8192)
    del s8192
    print(json.dumps({"refine_program": refine_program}), flush=True)
    # ---- 22. the checkerboard, the SDF and RANSAC as device programs ----
    loop_programs = phase_loop_programs(torch, smi, stream, scale_state,
                                        repaired, clean)
    del scale_state
    print(json.dumps({"loop_programs": loop_programs}), flush=True)
    # ---- 23. the lone LM, repair_step and the SPIKE as device programs ----
    solve_programs, o_bcr, o_multi = phase_solve_programs(
        torch, smi, solve_inputs, repaired, large, large_log)
    del solve_inputs
    print(json.dumps({"solve_programs": solve_programs}), flush=True)
    log(smi)
    # ---- 24. times ----
    times = phase_times(torch, state, large_log)
    # ---- 25. kernels line ----
    kernels = [
        {"name": "em_scan", "route": "cuda",
         "source": "hitl_slam_torch/csrc/em_scan.cu",
         "replaces": "hitl_slam_tpu/ops/pallas_em.py:33",
         "launches": n_em + s_em + r_em + p_em, "scale_launches": s_em,
         "reference_launches": r_em, "program_launches": p_em,
         "max_abs_err": max(em_err, scale_err[0]), **times["em_scan"],
         **scale_times["em_scan"]},
        {"name": "bcr_solve", "route": "cuda",
         "source": "hitl_slam_torch/csrc/bcr.cu",
         "replaces": "hitl_slam_tpu/solver/pallas_bcr.py:94",
         "launches": n_bcr + s_bcr + r_bcr + p_bcr + o_bcr,
         "scale_launches": s_bcr,
         "reference_launches": r_bcr, "program_launches": p_bcr,
         "solve_program_launches": o_bcr,
         "max_abs_err": max(bcr_err, scale_err[1]), **times["bcr_solve"],
         **scale_times["bcr_solve"]},
        {"name": "lm_step", "route": "cuda",
         "source": "hitl_slam_torch/csrc/lm_step.cu",
         "replaces": None,
         "launches": n_step + sum(LM_STEP_LAUNCHES),
         "main_path_launches": sum(LM_STEP_LAUNCHES),
         "max_gap_over_tolerance": step_gap,
         **step_times[1024], "at": "P=1024", "P8192": step_times[8192]},
        {"name": "em_refit", "route": "cuda",
         "source": "hitl_slam_torch/csrc/em_refit.cu",
         "replaces": None,
         "launches": n_refit + sum(EM_REFIT_LAUNCHES),
         "main_path_launches": sum(EM_REFIT_LAUNCHES),
         "max_endpoint_gap_m": refit_gap,
         **refit_times["1024"],
         "at": "{} x {}".format(*refit_times["1024"]["map"]),
         "P8192": refit_times["8192"]},
        {"name": "bcr_solve_batched", "route": "cuda",
         "source": "hitl_slam_torch/csrc/bcr.cu",
         "replaces": "hitl_slam_tpu/solver/pallas_bcr.py:94",
         "launches": n_batched + r_batched + q_batched,
         "reference_launches": r_batched, "program_launches": q_batched,
         "max_abs_err": batched_err,
         **{k: v for k, v in batched_times[1024].items()
            if k not in ("B", "n")},
         "at": f"B={REPLICAS}, n=1024",
         "n64": batched_times[64], "n16384": batched_times[16384]},
        {"name": "bcr_solve_multi", "route": "cuda",
         "source": "hitl_slam_torch/csrc/bcr.cu",
         "replaces": "hitl_slam_tpu/solver/pallas_bcr.py:94",
         "under": "hitl_slam_tpu/parallel/sharded_solver.py:198",
         "launches": n_multi + o_multi, "mesh_launches": n_multi,
         "solve_program_launches": o_multi, "max_abs_err": multi_err,
         **{k: v for k, v in multi_times[8].items()
            if k not in ("S", "n", "rhs")},
         "at": "S=8, n=128, R=7 (the sharded LM at d = 8)",
         "d4": multi_times[4], "chain": multi_times["chain"],
         **{f"n{n}": multi_times[n] for n, _ in MULTI_BCR if n != 32768}},
    ]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    # ---- 26. contract line ----
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
