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
     (em_scan = 2 x cycles, bcr = LM iterations);
  5. times at the main path's shapes: each kernel by CUDA events (host
     overhead included) and by torch.profiler (its own device time), its
     plain version, its bound from the shapes, and for BCR
     torch.linalg.solve on the dense system; BCR also at n = 64, 16384
     and 32768;
  6. a `{"kernels": [...]}` line with launches, agreement, times and bounds;
  7. the last line: {"ok": true, "device": {...}}.

scripts/compare_checkouts.py times two checkouts' kernels and replays
against each other on one card with the helpers here.

Needs a CUDA device, the repository checkout it sits in, nvcc, numpy and
scipy. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def device_ms(fn, kernel: str, iters: int = 50
              ) -> tuple[float, float, float]:
    """From torch.profiler over `iters` calls of fn: (device ms per launch
    of the kernels whose names contain `kernel`, their device ms per call,
    device ms of all device operations per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    mine_us, mine_n, all_us = 0.0, 0, 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        all_us += us
        if kernel in evt.key:
            mine_us += us
            mine_n += evt.count
    # the profiler does not always deliver every kernel record of a window
    # (up to a fifth were missing on the H100 machine), so the means are
    # over the records it delivered
    check(mine_n > 0, f"profiler saw no launch of {kernel} in {iters} calls")
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


def bcr_work(n: int) -> tuple[int, int]:
    """(bytes, flops) of one n-pose solve: D, U, b read once, x written
    once; cyclic reduction of the n-pose system eliminates n - 1 lanes, each
    with one 3x3 adjugate inverse (42 operations), its products Dinv L,
    Dinv U, Dinv b (105), its even neighbour's update (four 3x3 products,
    two matrix-vector products, 24 subtractions, 18 negations: 252) and its
    back-substitution (51); the root adds an inverse and one product."""
    bytes_moved = 4 * (9 * n + 9 * (n - 1) + 3 * n + 3 * n)
    flops = (n - 1) * (42 + 105 + 252 + 51) + 42 + 15
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
    return n_em, n_bcr


def phase_main(torch, small, small_log, large, large_log):
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
        n_em, n_bcr = run_main_path(torch, *args)
        totals[0] += n_em
        totals[1] += n_bcr
    return totals


# ---------------------------------------------------------------- phase 5

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
            out["bcr_solve"] = dict(ms=ms, device_ms=dev_ms,
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
                           large.normal_clouds, DEVICE)

    # ---- 2. em_scan kernel vs plain ----
    em_err = phase_em_scan(torch, state, large_log)
    # ---- 3. bcr kernel vs plain vs f64 ----
    bcr_err = phase_bcr(torch)
    # ---- 4. the main path ----
    n_em, n_bcr = phase_main(torch, small, small_log, large, large_log)
    check(n_em > 0 and n_bcr > 0, "a kernel was not launched on the main path")
    # ---- 5. times ----
    times = phase_times(torch, state, large_log)
    # ---- 6. kernels line ----
    kernels = [
        {"name": "em_scan", "route": "cuda",
         "source": "hitl_slam_torch/csrc/em_scan.cu",
         "replaces": "hitl_slam_tpu/ops/pallas_em.py:33",
         "launches": n_em, "max_abs_err": em_err, **times["em_scan"]},
        {"name": "bcr_solve", "route": "cuda",
         "source": "hitl_slam_torch/csrc/bcr.cu",
         "replaces": "hitl_slam_tpu/solver/pallas_bcr.py:94",
         "launches": n_bcr, "max_abs_err": bcr_err, **times["bcr_solve"]},
    ]
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    # ---- 7. contract line ----
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
