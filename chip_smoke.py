#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hitl_slam_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):
  1. device facts, then build both CUDA kernels from hitl_slam_torch/csrc/
     (ptxas registers, shared memory and spills are printed);
  2. em_scan kernel vs its plain torch version on the 1024-pose golden map:
     exact counts and bit-equal minima, over threshold and edge cases, an
     odd N, and two calls back to back (the in-kernel reset of the minima);
  3. block-cyclic-reduction kernel vs its plain torch version and an f64
     direct solve, n = 1 .. 65536, each route (one block, clusters of 2 to
     16 blocks, top levels in device memory ahead of a cluster of 16);
  4. the main path, HitLSLAM on cuda: replay_log of the small golden
     session (both tolerances of tests/test_golden.py), replay_log and
     run_queue of the 1024-pose golden session; each run's kernel launch
     counts are zeroed just before it and checked just after
     (em_scan = 2 x cycles, bcr = LM iterations), and the run_queue's
     repaired map is phase 15's;
  5. the post-human STF refine on the repaired 1024-pose map:
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
     stage;
  8. render_map and info_matrix_image on the repaired map (shapes,
     non-empty, bit-equal repeat, the card's image against the CPU's);
  9. the LTVM curator on the repaired 1024-pose golden map and on the clean
     figure-8 map (the figure-8's walls, the prune floors, bit-equal repeat
     from the seed, the SDF against the CPU's); wall and device ms of the
     SDF, the filter and the RANSAC;
 10. EnML batch localization (launches neither kernel; the counts are
     zeroed before it and must stay 0): the sweep on the card against the
     CPU on the test-size stream (pose and covariance differences, match
     counts of every 16th window); the sweep over the reference's scale
     map (1078 nodes, 256 padded points a node) with its wall, ms a node,
     realtime factor, launches a node and busy share from a profiled
     32-node segment, peak memory, consistency and the error against ground
     truth; then a bag through `cli_enml` on the card into HitLSLAM;
 11. the checkerboard localizer (launches neither kernel): card against
     CPU on the test-size stream (both matcher routes, the probe's
     counts), then the scale map at W = 10 (16 windows a batch) and at
     W = 80 (the grid matcher, 8 a batch) with wall, ms a node, realtime
     factor, launches a node and busy share from a device-only profile,
     peak memory, consistency, aligned error and the probe's dropped count;
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
     iterations on the card: costs finite and not up, the batched BCR
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
 16. the mesh: (a) the pose-sharded LM (20 LM iterations) on the repaired
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
     and ends within 0.05 m of JAX's) with the refine at scale (PCG, cost
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
     refine of that state (its final cost within 1e-2 of the f64
     cpu_refine_solve on the same factors), EnML on the reference's
     160-scan stream, the bag's ingest (the native scanner built, both
     routes exact); each section's launches counted (em_scan = 2 x
     cycles, bcr = LM iterations); the assembled record holds every key
     of bench_reference.KEY_MAP; `[reference]` lines and one
     `{"reference": {...}}` line;
 19. times at the main path's shapes: each kernel by CUDA events (host
     overhead included) and by torch.profiler (its own device time), its
     plain version, its bound from the shapes, and for BCR
     torch.linalg.solve on the dense system; BCR also at n = 64, 16384
     and 32768;
 20. a `{"kernels": [...]}` line with launches (phases 17's and 18's also
     apart), agreement, times and bounds (the batched route's launches
     from phases 15 and 18, the multi route's from phase 16; em_scan and
     BCR also at phase 17's shapes);
 21. the last line: {"ok": true, "device": {...}}.

scripts/compare_checkouts.py times two checkouts' kernels and replays
against each other on one card with the helpers here.

Needs a CUDA device, the repository checkout it sits in, nvcc, numpy and
scipy. Imports nothing of JAX.
"""

from __future__ import annotations

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

    E.launches.count = 0
    B.launches.count = 0
    B.batched_launches.count = 0
    B.multi_launches.count = 0


def _read_counts():
    from hitl_slam_torch.ops import em_scan as E
    from hitl_slam_torch.solver import bcr_kernel as B

    return E.launches.count, B.launches.count


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
        f"LM iterations {iters}, launches em_scan={n_em} bcr={n_bcr}, "
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
    return results


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


def stage_ms(name: str, fn, on_device: bool = True):
    """Run fn() on the card: warm, timed by the host clock around a
    synchronise (wall ms), and under torch.profiler (device ms: the sum of
    its device operations, and their number); a stage that works on the
    device must show some. Logs and returns (result, wall_ms, device_ms,
    device_ops)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = device_events(fn) if on_device else []
    dev_ms = sum(us for _, us, _ in events) / 1e3
    ops = sum(n for _, _, n in events)
    check(ops > 0 or not on_device,
          f"{name}: the profiler showed no device operation in three windows")
    log(f"[stage] {name}: wall {wall:.3f} ms, device {dev_ms:.3f} ms in "
        f"{ops} device operations")
    return out, wall, dev_ms, ops


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
        stage_ms(f"propose_corrections, B={B}",
                 lambda: eng.propose_corrections(max_proposals=4, seed=0,
                                                 min_gap=min_gap))
        fields, *_ = stage_ms(
            f"build_likelihood_field, B={B}",
            lambda: scan_match.build_likelihood_field(a_pts, a_mask, centers))
        (matched, _, _), *_ = stage_ms(
            f"correlative_match, B={B}",
            lambda: scan_match.correlative_match(fields, centers, scans,
                                                 scan_masks, guesses))
        u = ransac.uniform_draws(0, rp, DEVICE, batch=2 * B)
        stage_ms(f"extract_segments (anchor side), B={B}",
                 lambda: ransac.extract_segments(a_pts, a_mask, u[:B], rp))
        scans_w = P.place_scans(scans, matched)
        stage_ms(f"extract_segments (corrected side), B={B}",
                 lambda: ransac.extract_segments(scans_w, scan_masks, u[B:],
                                                 rp))
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

    per_call, solved = [], []
    replay, solve = eng.replay_log, C.lm_solve

    def counted_solve(*a, **k):
        out = solve(*a, **k)
        solved.append(int(out.iterations))
        return out

    def counted(entry, record=False):
        em0, bcr0 = _read_counts()
        n0 = len(solved)
        rep = replay(entry, record=record)
        em1, bcr1 = _read_counts()
        per_call.append((rep, em1 - em0, bcr1 - bcr0, solved[n0:]))
        return rep

    eng.replay_log, C.lm_solve = counted, counted_solve
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    tried = auto_repair(eng, 3, torch.device(DEVICE))
    wall = (time.perf_counter() - t0) * 1e3
    n_em, n_bcr = _read_counts()
    eng.replay_log, C.lm_solve = replay, solve
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
                                         lo, H, W, params))
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
                                             keep.reshape(-1), u, rp))
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
    dev_ms, ops = _device_only_profile(torch, lambda: L.sweep_segment(
        st.points, st.normals, st.point_mask, st.poses, cov0, pre, 64, o,
        seg))
    # the device's busy share: its time over the unprofiled segment's wall
    busy = dev_ms / seg_ms
    # the whole sweep, or its first K nodes where the budget forces a cut
    K = P
    if seg_ms / seg * P / 1e3 > ENML_SWEEP_BUDGET_S:
        K = max(ENML_MIN_NODES, int(ENML_SWEEP_BUDGET_S * 1e3 * seg / seg_ms))
        K = min(K, P)
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    _sync()
    t0 = time.perf_counter()
    p_l, c_l = L.batch_localize(st.points[:K], st.normals[:K],
                                st.point_mask[:K], st.poses[:K], o)
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
        f"factor {rtf:.2f} ({steps} scans at {ENML_SCAN_PERIOD_S} s); "
        f"32-node segment: wall {seg_ms:.1f} ms, device {dev_ms:.2f} ms in "
        f"{ops / seg:.0f} device operations a node, busy {100 * busy:.1f} %; "
        f"peak memory {peak:.0f} MiB; consistency "
        f"(every 16th node) {before:.4f} -> {after:.4f}; error against "
        f"ground truth (aligned) odometry {err_odo:.4f} m, localized "
        f"{err_loc:.4f} m ({smi})")
    out["scale"] = dict(nodes=P, padded_points=P * N, real_points=real,
                        swept_nodes=K, wall_s=wall_s,
                        ms_per_node=wall_s * 1e3 / K, realtime_factor=rtf,
                        segment_wall_ms=seg_ms, segment_device_ms=dev_ms,
                        launches_per_node=ops / seg, busy_share=busy,
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
    the scale map at W = 10 and W = 80 with wall, ms a node, realtime
    factor, launches a node and busy share from a device-only profile, peak
    memory, consistency, aligned error and the probe's dropped count."""
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
        # warm the libraries and the allocator on a prefix
        CB.checkerboard_localize(*(a[:4 * W] for a in args), o, chunk=chunk)
        _sync()
        if DEVICE != "cpu":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, c = CB.checkerboard_localize(*args, o, chunk=chunk)
        _sync()
        wall_s = time.perf_counter() - t0
        peak = _peak_memory_mb(torch)
        dev_ms, ops = _device_only_profile(
            torch, lambda: CB.checkerboard_localize(*args, o, chunk=chunk))
        busy = dev_ms / (wall_s * 1e3)
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
            f"{wall_s:.3f} s, {wall_s * 1e3 / P:.3f} ms a node, realtime "
            f"factor {rtf:.1f} ({scale['scans']} scans at "
            f"{ENML_SCAN_PERIOD_S} s); device {dev_ms:.1f} ms in "
            f"{ops / P:.1f} device operations a node, busy "
            f"{100 * busy:.1f} %; peak memory {peak:.0f} MiB; consistency "
            f"(every 16th node) {before:.4f} -> {after:.4f}; error against "
            f"ground truth (aligned) odometry {err_odo:.4f} m, localized "
            f"{err:.4f} m; probe dropped {dropped}; covariances asymmetric "
            f"by {asym:.2e} at most (largest entry {np.abs(c).max():.2e})"
            + ("" if vs_seq is None else
               f"; {vs_seq:.4f} m from the sequential sweep") + f" ({smi})")
        out["scale"][name] = dict(
            nodes=P, W=W, route=route, chunk=chunk, wall_s=wall_s,
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
                                                   make_perturbed_replicas)
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
    dev_ms, ops = _device_only_profile(torch, lambda: batched_solve(
        reps, tb, config, device=DEVICE))
    rec = dict(B=REPLICAS, n=P, max_iterations=REPLICA_ITERS,
               wall_ms=wall_ms, lone_wall_ms=lone_ms,
               solves_per_s=REPLICAS / wall_ms * 1e3,
               iterations=dict(min=int(iters.min()),
                               median=float(np.median(iters)),
                               max=int(iters.max())),
               steps=steps, launches_bcr_batched=n_batched,
               device_ms=dev_ms, device_ops=ops,
               busy_share=dev_ms / wall_ms,
               sampled=picks, lone_vs_batched=worst_pose,
               cost_initial_mean=float(c0.mean()),
               cost_final_mean=float(c1.mean()))
    log(f"[replicas] B={REPLICAS} n={P}: batched {wall_ms:.2f} ms "
        f"({rec['solves_per_s']:.1f} solves/s), {REPLICAS} lone solves "
        f"{lone_ms:.2f} ms; iterations min/median/max "
        f"{int(iters.min())}/{float(np.median(iters))}/{int(iters.max())}; "
        f"batched bcr launches {n_batched} = steps; replicas {picks} equal "
        f"their lone solves (<= {worst_pose:.3e}); device {dev_ms:.2f} ms in "
        f"{ops} operations, busy {100 * dev_ms / wall_ms:.1f} % ({smi})")
    # ---- 2. the batched kernel on the first step's systems and others ----
    first = []

    def record(D, U, b):
        first.append((D.clone(), U.clone(), b.clone()))
        return B.bcr_solve_cuda_batched(D, U, b)

    lm.solve_batched(prob_b, reps, LMConfig(max_iterations=1),
                     linear_solver=record)
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
    """One sharded solve on the card, its counts zeroed just before and read
    just after: (result, wall ms, (multi, batched) BCR launches, lone BCR
    and em_scan launches, collective counts)."""
    from hitl_slam_torch.parallel import mesh as M
    from hitl_slam_torch.parallel.sharded_solver import sharded_lm_solve
    from hitl_slam_torch.solver import bcr_kernel as B

    torch.cuda.synchronize()
    _reset_counts()
    M.collectives.reset()
    t0 = time.perf_counter()
    res = sharded_lm_solve(mesh, problem, poses, config)
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
    current one): read through a spy on the solver's assembly."""
    from hitl_slam_torch.parallel import sharded_solver as S

    seen, real = [], S._local_assemble

    def spy(*args):
        out = real(*args)
        seen.append(out[3][0])
        return out

    S._local_assemble = spy
    try:
        S.sharded_lm_solve(mesh, problem, poses, config)
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
    S.sharded_lm_solve(mesh, problem, repaired.poses, config)    # warm-up
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
                max_iterations=1))
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
        S.sharded_lm_solve(mesh, problem, poses, config)      # warm-up
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
            torch, lambda: S.sharded_lm_solve(mesh, problem, poses, config))
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
    S.sharded_lm_solve(mesh, problem, chain, config)          # warm-up
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
    once an iteration), with the kernels' counts zeroed on entry. Nothing
    is read back while the section runs."""

    def __enter__(self):
        from hitl_slam_torch.models.hitl import cycle as C, engine as EN
        from hitl_slam_torch.solver import lm as LM

        self.cycles, self.iterations = 0, []
        self._saved = (C.cycle_step, EN.cycle_step, C.lm_solve, LM.solve)
        step, solve = self._saved[0], self._saved[3]

        def counted_step(*a, **k):
            self.cycles += 1
            return step(*a, **k)

        def counted_solve(*a, **k):
            out = solve(*a, **k)
            self.iterations.append(out.iterations)
            return out

        C.cycle_step = EN.cycle_step = counted_step
        C.lm_solve = LM.solve = counted_solve
        _sync()
        _reset_counts()
        return self

    def __exit__(self, *exc):
        from hitl_slam_torch.models.hitl import cycle as C, engine as EN
        from hitl_slam_torch.solver import lm as LM

        _sync()
        self.launches = _read_counts()
        C.cycle_step, EN.cycle_step, C.lm_solve, LM.solve = self._saved
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
    log(f"[build] {info.path} in {time.perf_counter() - t0:.1f} s "
        f"({'cached' if info.cached else 'nvcc, 2 sources in parallel'})")
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
    # ---- 4. the main path ----
    (n_em, n_bcr), repaired = phase_main(torch, small, small_log, large,
                                         large_log)
    check(n_em > 0 and n_bcr > 0, "a kernel was not launched on the main path")
    # ---- 5. the refine ----
    phase_refine(torch, large, large_log, 16384)
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
    del sections
    print(json.dumps({"reference": reference}), flush=True)
    log(smi)
    # ---- 19. times ----
    times = phase_times(torch, state, large_log)
    # ---- 20. kernels line ----
    kernels = [
        {"name": "em_scan", "route": "cuda",
         "source": "hitl_slam_torch/csrc/em_scan.cu",
         "replaces": "hitl_slam_tpu/ops/pallas_em.py:33",
         "launches": n_em + s_em + r_em, "scale_launches": s_em,
         "reference_launches": r_em,
         "max_abs_err": max(em_err, scale_err[0]), **times["em_scan"],
         **scale_times["em_scan"]},
        {"name": "bcr_solve", "route": "cuda",
         "source": "hitl_slam_torch/csrc/bcr.cu",
         "replaces": "hitl_slam_tpu/solver/pallas_bcr.py:94",
         "launches": n_bcr + s_bcr + r_bcr, "scale_launches": s_bcr,
         "reference_launches": r_bcr,
         "max_abs_err": max(bcr_err, scale_err[1]), **times["bcr_solve"],
         **scale_times["bcr_solve"]},
        {"name": "bcr_solve_batched", "route": "cuda",
         "source": "hitl_slam_torch/csrc/bcr.cu",
         "replaces": "hitl_slam_tpu/solver/pallas_bcr.py:94",
         "launches": n_batched + r_batched, "reference_launches": r_batched,
         "max_abs_err": batched_err,
         **{k: v for k, v in batched_times[1024].items()
            if k not in ("B", "n")},
         "at": f"B={REPLICAS}, n=1024",
         "n64": batched_times[64], "n16384": batched_times[16384]},
        {"name": "bcr_solve_multi", "route": "cuda",
         "source": "hitl_slam_torch/csrc/bcr.cu",
         "replaces": "hitl_slam_tpu/solver/pallas_bcr.py:94",
         "under": "hitl_slam_tpu/parallel/sharded_solver.py:198",
         "launches": n_multi, "max_abs_err": multi_err,
         **{k: v for k, v in multi_times[8].items()
            if k not in ("S", "n", "rhs")},
         "at": "S=8, n=128, R=7 (the sharded LM at d = 8)",
         "d4": multi_times[4], "chain": multi_times["chain"],
         **{f"n{n}": multi_times[n] for n, _ in MULTI_BCR if n != 32768}},
    ]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    # ---- 21. contract line ----
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
