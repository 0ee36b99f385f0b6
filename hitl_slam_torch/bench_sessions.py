"""The reference's HitL bench sessions on the port.

The repository's root bench.py drives the JAX package through a set of
correction sessions; it imports JAX, so the port carries its own copy of
their builders here:

  - correction_specs(P): the headline session's five mixed corrections
    (bench.py:36-63); specs_8192(P) and specs_16384(P): the three COLINEAR
    corrections of the 8192-pose session (bench.py:1110-1116) and of the
    16384-pose session (bench.py:802-812). At the reference's P they give
    exactly its pose ranges; at a smaller P they scale them.
  - run_session: one session on a fresh engine, each correction sketched
    against the poses of the moment and replayed (bench.py:212-247).
  - gt_error_aligned / gt_error_mean: the error against ground truth after
    the optimal rigid alignment (bench.py:249-262), and the plain mean
    position error (bench.py:1118-1121).

and the sections of `python -m hitl_slam_torch.bench --headline` and
`--scale`, each a function of the device that returns a dict:

  headline_section       the 1024-pose, 180-ray session (bench.py:284-298)
  chain_section          queue_chain repeated from the initial state with
                         one host read at the end (bench.py:438-560)
  solve_only_section     build_problem + lm.solve on each accepted cycle's
                         snapshot, S_REP chained rounds as one device
                         program (`solve_rounds`), with the matched f64
                         CPU baselines (bench.py:402-436, :562-631)
  joint_solve_section    the ~10^4-pose joint solve alone (bench.py:648-686)
  scale_session_section  the 8192-pose session with its refine at scale
                         (bench.py:1074-1232) and the 16384-pose session
                         with its f64 parity gate (bench.py:787-896)

Every wall is host time around work that ends in a synchronise. Values that
the gates of chip_smoke.py and the tests need as arrays (final poses) come
back under keys that start with an underscore; `public` drops them.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .core.state import ConstraintTable, CorrectionType, SingleInput
from .io.figure8 import generate_figure8, synthesize_correction
from .models.hitl.engine import HitLSLAM
from .solver import joint, lm
from .utils.device_loop import (DeviceProgram, ProgramCache, device_for,
                                replays, signature)

Tensor = torch.Tensor

HEADLINE_MAP = dict(num_poses=1024, num_rays=180, seed=7,
                    drift_theta_bias=6e-4, num_laps=2)
# the 5-correction session writes ~12k pair-grid rows: the table holds all
HEADLINE_CAPACITY = 16384
SCALE_MAPS = {
    8192: dict(num_poses=8192, num_rays=40, seed=13, drift_theta_bias=1.5e-5,
               num_laps=2),
    16384: dict(num_poses=16384, num_rays=40, seed=17, drift_theta_bias=8e-6,
                num_laps=4),
}
SCALE_CAPACITY = 32768
# repetitions of the chain and of each snapshot's solve (bench.py)
J_REP = 16
S_REP = 8
# the joint solve alone: poses, the seed of its chain, its LM
BIG_P = 8192
BIG_SEED = 3
BIG_CONFIG = lm.LMConfig(max_iterations=20)
# the smoke size of the headline and its sections (bench.py's BENCH_SMOKE):
# a check of the scripts on the CPU, not a measurement
SMOKE_MAP = dict(HEADLINE_MAP, num_poses=128, num_rays=40)
SMOKE_CAPACITY = 2048
SMOKE_REPS = dict(j_rep=2, s_rep=2, samples=1, big=512)
# the refine at scale on the 8192-pose session's result (bench.py:1141)
REFINE_AT_SCALE = dict(capacity=262144, max_iterations=5, matcher="pair",
                       max_pairs=16384)


def _spec(ctype, corrected, anchor, cw, aw, cspan=None, aspan=None,
          min_points=40) -> dict:
    return dict(ctype=ctype, corrected=corrected, anchor=anchor, cw=cw,
                aw=aw, cspan=cspan, aspan=aspan, min_points=min_points)


def correction_specs(P: int) -> list[dict]:
    """A mixed sequence of 'human' corrections between lap 1 and lap 2."""
    lap = P // 2
    h = 10.0
    lap1 = range(0, lap)
    lap2 = range(lap, P)
    return [
        # colinear: bottom wall, right-room span, lap2 vs lap1
        _spec(CorrectionType.COLINEAR, lap2, lap1, (1, 0.0), (1, 0.0),
              (4.0, 16.0), (4.0, 16.0)),
        # perpendicular: late top-left section vs early left wall
        _spec(CorrectionType.PERPENDICULAR, lap2, lap1, (1, h), (0, -20.0),
              (-16.0, -4.0), (2.0, 8.0)),
        # colocation: left wall, lap2 vs lap1
        _spec(CorrectionType.LINE_SEGMENT, lap2, lap1, (0, -20.0),
              (0, -20.0), (2.0, 8.0), (2.0, 8.0)),
        # colinear: top wall left span, lap2 vs lap1
        _spec(CorrectionType.COLINEAR, lap2, lap1, (1, h), (1, h),
              (-16.0, -4.0), (-16.0, -4.0)),
        # parallel: right wall, lap2 vs lap1
        _spec(CorrectionType.PARALLEL, lap2, lap1, (0, 20.0), (0, 20.0),
              (2.0, 8.0), (2.0, 8.0)),
    ]


def _colinear(corrected, anchor, wall_c, wall_a) -> dict:
    return _spec(CorrectionType.COLINEAR, corrected, anchor, wall_c, wall_a,
                 min_points=30)


def specs_8192(P: int = 8192) -> list[dict]:
    """The 8192-pose session's corrections, pose ranges scaled to P."""
    def s(x):
        return x * P // 8192

    return [
        _colinear(range(P - s(2400), P - s(300)), range(s(300), s(2400)),
                  (1, 0.0), (1, 0.0)),
        _colinear(range(s(6144), s(8000)), range(s(2048), s(4000)),
                  (0, -20.0), (0, -20.0)),
        _colinear(range(s(4200), s(5400)), range(s(120), s(1600)),
                  (0, 20.0), (0, 20.0)),
    ]


def specs_16384(P: int = 16384) -> list[dict]:
    """The 16384-pose, four-lap session's corrections (lap 4 vs lap 1 on
    the bottom wall, lap 3 vs lap 2 on the left, lap 4 vs lap 2 on the
    right), pose ranges scaled to P."""
    def s(x):
        return x * P // 16384

    lap = P // 4
    return [
        _colinear(range(3 * lap + s(300), P - s(300)),
                  range(s(300), lap - s(300)), (1, 0.0), (1, 0.0)),
        _colinear(range(2 * lap + s(200), 3 * lap - s(200)),
                  range(lap + s(200), 2 * lap - s(200)), (0, -20.0),
                  (0, -20.0)),
        _colinear(range(3 * lap + s(200), P - s(200)),
                  range(lap + s(200), 2 * lap - s(200)), (0, 20.0),
                  (0, 20.0)),
    ]


SCALE_SPECS = {8192: specs_8192, 16384: specs_16384}


def sketch(m, spec: dict, poses: np.ndarray) -> np.ndarray:
    """The [4, 2] clicks of `spec` on map `m` as it stands at `poses`;
    ValueError where a wall shows too few points."""
    span = {}
    if spec["cspan"] is not None:
        span = dict(corrected_span=spec["cspan"], anchor_span=spec["aspan"])
    return synthesize_correction(m, spec["corrected"], spec["anchor"],
                                 spec["cw"], spec["aw"],
                                 min_points=spec["min_points"], poses=poses,
                                 **span)


def gt_error_aligned(poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Mean position error against ground truth after the optimal rigid
    alignment (the absolute-trajectory-error convention)."""
    a = np.asarray(poses[:, :2], np.float64)
    b = np.asarray(gt_poses[:, :2], np.float64)
    ca, cb = a.mean(0), b.mean(0)
    H = (a - ca).T @ (b - cb)
    Uu, _, Vt = np.linalg.svd(H)
    R = (Uu @ Vt).T
    if np.linalg.det(R) < 0:
        Vt[-1] *= -1
        R = (Uu @ Vt).T
    aligned = (a - ca) @ R.T + cb
    return float(np.linalg.norm(aligned - b, axis=1).mean())


def gt_error_mean(poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Mean position error against ground truth, unaligned."""
    a = np.asarray(poses[:, :2], np.float64)
    b = np.asarray(gt_poses[:, :2], np.float64)
    return float(np.linalg.norm(a - b, axis=1).mean())


def synchronizer(device):
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def summary(xs: list[float]) -> dict:
    """Median, quartiles and minimum of `xs`, and how many."""
    from .bench import quartiles

    return {**quartiles(xs), "min": min(xs), "n": len(xs)}


def public(d: dict) -> dict:
    """`d` without its array entries (keys starting with an underscore),
    recursively: what the JSON line prints."""
    return {k: public(v) if isinstance(v, dict) else v
            for k, v in d.items() if not k.startswith("_")}


def _peak_mib(device) -> float | None:
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 20


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def run_session(m, specs: list[dict], capacity: int, device,
                odometry: bool = True) -> dict:
    """One session on a fresh HitLSLAM on `device`: each spec is sketched
    against the poses of the moment and replayed with replay_log. Returns
    the engine, and per spec its wall ms and report (None where the sketch
    found too few wall points), `solve_snapshots` (the poses each accepted
    cycle handed its LM, in f64, with the constraint rows after it),
    `accepted_inputs` ((ctype, [4, 2] clicks) of each accepted cycle) and
    `accepted_poses` (the poses after each accepted cycle).
    `odometry`: pass the map's odometry to init, as the headline session
    does (the scale sessions do not)."""
    sync = synchronizer(device)
    eng = HitLSLAM(device=device)
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             odometry=m.odometry if odometry else None,
             constraint_capacity=capacity)
    walls, reports, snaps, inputs, after = [], [], [], [], []
    for s in specs:
        try:
            sel = sketch(m, s, eng.get_poses())
        except ValueError:
            walls.append(None)
            reports.append(None)
            continue
        sync()
        t0 = time.perf_counter()
        rep = eng.replay_log(SingleInput(s["ctype"], 0, sel))
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        reports.append(rep)
        if rep.accepted:
            snaps.append((eng.last_pre_solve_poses.detach().cpu().numpy()
                          .astype(np.float64), eng.num_constraints))
            inputs.append((int(s["ctype"]), np.asarray(sel, np.float32)))
            after.append(eng.get_poses())
    return dict(engine=eng, walls=walls, reports=reports,
                solve_snapshots=snaps, accepted_inputs=inputs,
                accepted_poses=after)


def _report_fields(session: dict) -> dict:
    """Per spec: accepted, LM iterations, final cost, dropped rows (None
    where the spec was not sketched); the rows in the table at the end."""
    reps = session["reports"]

    def each(f):
        return [None if r is None else f(r) for r in reps]

    return dict(
        accepted=each(lambda r: bool(r.accepted)),
        lm_iterations=each(lambda r: int(r.lm_iterations)),
        final_cost=each(lambda r: float(r.final_cost)),
        dropped_rows=each(lambda r: int(r.dropped_rows)),
        rows=int(session["engine"].num_constraints),
    )


def _accepted_walls(session: dict) -> list[float]:
    return [w for w, r in zip(session["walls"], session["reports"])
            if r is not None and r.accepted]


def headline_section(device, m=None, capacity: int = HEADLINE_CAPACITY,
                     sessions: int = 3, warmup: int = 1) -> dict:
    """The headline session: `warmup` untimed sessions, then `sessions`
    timed ones on `m` (default: the 1024-pose, 180-ray map of
    HEADLINE_MAP) with correction_specs. The wall summary is over the
    accepted cycles of every timed session; the flags, iterations and rows
    are the last session's. `_session` holds the last session (engine,
    snapshots, accepted inputs), `_poses` its final poses, `_map` the
    map."""
    if m is None:
        m = generate_figure8(**HEADLINE_MAP)
    specs = correction_specs(m.poses.shape[0])
    for _ in range(warmup):
        run_session(m, specs, capacity, device)
    walls, medians = [], []
    for _ in range(sessions):
        sess = run_session(m, specs, capacity, device)
        acc = _accepted_walls(sess)
        walls += acc
        medians.append(float(np.median(acc)))
    poses = sess["engine"].get_poses()
    last = [r for r in sess["reports"] if r is not None and r.accepted][-1]
    return {
        "poses": int(m.poses.shape[0]),
        "points": int(sum(len(pc) for pc in m.point_clouds)),
        "padded_points": int(sess["engine"].state.max_points),
        "capacity": capacity, "sessions": sessions, "warmup": warmup,
        "cycle_wall_ms": summary(walls),
        "cycle_wall_ms_all": walls, "session_medians_ms": medians,
        "last_session_wall_ms": sess["walls"],
        "stage_ms_last_cycle": dict(last.timings_ms),
        **_report_fields(sess),
        "active_rows": int(sess["engine"].state.constraints.active.sum()),
        "gt_aligned": {"before": gt_error_aligned(m.poses, m.gt_poses),
                       "after": gt_error_aligned(poses, m.gt_poses)},
        "_session": sess, "_poses": poses, "_map": m,
    }


def _chained(st, p0, covs, table, ctypes, sels, j_rep: int):
    """j_rep repetitions of queue_chain from (p0, covs, table), each from
    p0 + 1e-6 j plus the previous repetition's checksum times 1e-30, so no
    repetition can be skipped; nothing is read back. Returns the last
    checksum, the first repetition's poses, the last repetition's
    per-cycle stack and every repetition's LM iterations ([j_rep, K])."""
    from .models.hitl.cycle import queue_chain

    chk = torch.zeros((), dtype=p0.dtype, device=p0.device)
    first, per, iters = None, None, []
    for j in range(j_rep):
        pj = p0 + chk * 1e-30 + 1e-6 * j
        poses2, covs2, _, _, per = queue_chain(
            st.points, st.point_mask, pj, covs, table, ctypes, sels, 0,
            warm_start_mu=False)
        chk = torch.sum(poses2) + torch.sum(covs2)
        if j == 0:
            first = poses2
        iters.append(per[4])
    return chk, first, per, torch.stack(iters)


def _host_reads_and_launches(run) -> tuple[int, int | None]:
    """(reads back to the host, device operations) of run() under
    torch.profiler: on a CUDA device its device-to-host copy records (a
    scalar read is one), on the CPU its scalar reads
    (aten::_local_scalar_dense); device operations only on a CUDA device
    (else None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        run()
        if cuda:
            torch.cuda.synchronize()
    events = prof.key_averages()
    reads = sum(e.count for e in events if e.key == "aten::_local_scalar_dense")
    if not cuda:
        return reads, None
    copies = sum(e.count for e in events
                 if e.device_type == DeviceType.CUDA and "DtoH" in e.key)
    return copies, sum(e.count for e in events
                       if e.device_type == DeviceType.CUDA)


def _program_stats(st, capacity: int) -> dict | None:
    """Capture ms, graph nodes and pool MiB of each correction type's graph
    in the CycleProgram that queue_chain replays for this map (None on the
    CPU, which runs the chain eagerly)."""
    from .models.hitl.cycle import cycle_program

    if st.points.device.type != "cuda":
        return None
    prog = cycle_program(st.points, capacity, lm.LMConfig(), False, False)
    return {str(c): {"capture_ms": g.capture_ms, "nodes": g.nodes,
                     "pool_mib": g.pool_mib} for c, g in prog.graphs.items()}


def chain_section(device, headline: dict, j_rep: int = J_REP,
                  samples: int = 3) -> dict:
    """The pipelined chain: queue_chain over the first min(4, accepted)
    accepted corrections of the headline's last session, `j_rep` times
    from the initial drifted state (a fresh table each time), one host read
    (the checksum) at the end. ms a chained cycle is the minimum over
    `samples` timed calls, each from the initial poses moved by
    1e-6 (k + 1); then the host reads and device operations a cycle
    of one repetition under the profiler. `_first_poses`: the first
    repetition's result of the untimed call from the initial poses;
    `_run` reruns one whole call, `_inputs` are its input tensors."""
    sync = synchronizer(device)
    m, sess = headline["_map"], headline["_session"]
    st = sess["engine"].state
    inputs = sess["accepted_inputs"]
    k = min(4, len(inputs))
    if k == 0:
        raise RuntimeError("the headline session accepted no correction")
    ctypes = [c for c, _ in inputs[:k]]
    sels = torch.as_tensor(np.stack([s for _, s in inputs[:k]]),
                           dtype=torch.float32, device=device)
    p0 = torch.as_tensor(m.poses, dtype=torch.float32, device=device)
    covs = torch.as_tensor(m.covariances, dtype=torch.float32, device=device)
    table = ConstraintTable.empty(st.constraints.capacity, device)

    def run(p, reps=j_rep):
        return _chained(st, p, covs, table, ctypes, sels, reps)

    chk, first, per, iters = run(p0)
    float(chk)
    accepted = per[0].cpu().tolist()
    if not all(accepted):
        raise RuntimeError(f"the chain rejected cycles: {accepted}")
    lm_iterations = iters.cpu().tolist()
    times = []
    for s in range(samples):
        pk = p0 + 1e-6 * (s + 1)
        sync()
        t0 = time.perf_counter()
        chk, _, _, its = run(pk)
        float(chk)
        times.append((time.perf_counter() - t0) * 1e3 / (k * j_rep))
        lm_iterations += its.cpu().tolist()
    reads, launches = _host_reads_and_launches(lambda: float(run(p0, 1)[0]))
    return {
        "cycles": k, "j_rep": j_rep, "samples": samples,
        "ms_per_cycle": min(times), "ms_per_cycle_samples": times,
        "accepted": accepted,
        "lm_iterations": lm_iterations[j_rep - 1],
        "first_lm_iterations": lm_iterations[0],
        "rows": int(per[3].sum()),
        "finite": bool(torch.isfinite(first).all()),
        "host_reads_per_cycle": reads / k,
        "device_ops_per_cycle": None if launches is None else launches / k,
        "_first_poses": first.cpu().numpy(),
        "_run": lambda: float(run(p0)[0]),
        "_programs": lambda: _program_stats(st, table.capacity),
        "_inputs": (st.points, st.point_mask, p0, covs, sels, *vars(
            table).values()),
    }


def _np_table(table: ConstraintTable, n_active: int) -> dict:
    """The first n_active rows of `table` in baselines/cpu_lm.py's layout."""
    act = table.active.cpu().numpy().copy()
    act[n_active:] = False
    return dict(ctype=table.ctype.cpu().numpy(),
                constrained=table.constrained.cpu().numpy(),
                anchor=table.anchor.cpu().numpy(),
                dpar=table.delta_parallel.cpu().numpy(),
                dperp=table.delta_perpendicular.cpu().numpy(),
                dth=table.delta_angle.cpu().numpy(),
                pen=table.penalty_dir.cpu().numpy(), active=act)


def _first_rows(table: ConstraintTable, n_active: int) -> ConstraintTable:
    active = table.active.clone()
    active[n_active:] = False
    return dataclasses.replace(table, active=active)


def solve_rounds(poses0: Tensor, table: ConstraintTable,
                 config: lm.LMConfig = lm.LMConfig(), s_rep: int = S_REP,
                 *, eager: bool = False) -> tuple[Tensor, Tensor]:
    """`s_rep` chained rounds of build_problem + lm.solve: round k starts
    from poses0 + 1e-6 (k + 1) + acc * 0, acc the sum of the previous
    round's poses, so that nothing reorders or folds. Returns (acc after
    the last round, each round's LM iterations [s_rep] int32).

    The rounds are a `device_for` over k, as the reference's jitted
    `_solve_only_chain` is a `fori_loop` (bench.py:597-609): on a CUDA
    device one replay of its program (a WHILE node over the rounds, each
    round's LM a WHILE node inside it), unless `eager`, for comparisons
    only."""
    # each round's offset, rounded to the poses' dtype as a Python float
    # added to them is
    offsets = torch.tensor([1e-6 * (k + 1) for k in range(s_rep)],
                           dtype=poses0.dtype).to(poses0.device)
    if replays(poses0, eager):
        return _rounds_program((poses0, table, offsets), config).run(
            poses0, table, offsets)
    return _solve_rounds(poses0, table, offsets, config)


_rounds_programs = ProgramCache(size=1)


def _rounds_program(example: tuple, config: lm.LMConfig) -> DeviceProgram:
    dev = example[0].device
    key = (signature(example), config, dev.index)
    return _rounds_programs.get(key, lambda: DeviceProgram(
        lambda p0, tbl, offs: _solve_rounds(p0, tbl, offs, config),
        example, dev, name="rounds"))


def _solve_rounds(poses0, table, offsets, config):
    """solve_rounds' carry form, eager or captured."""
    acc = torch.zeros((), dtype=poses0.dtype, device=poses0.device)
    its = torch.zeros(offsets.shape, dtype=torch.int32,
                      device=poses0.device)

    def round_(k):
        p = poses0 + offsets.index_select(0, k[None])[0] + acc * 0.0
        r = lm.solve(joint.build_problem(p, table), p, config, eager=True)
        acc.copy_(torch.sum(r.poses))
        its.index_copy_(0, k[None], r.iterations[None])

    device_for(offsets.shape[0], round_, poses0.device, name="round")
    return acc, its


def solve_only_section(device, headline: dict, s_rep: int = S_REP,
                       samples: int = 2, scipy_runs: int = 3) -> dict:
    """The joint solve alone on each accepted cycle's snapshot (its start
    poses, the rows live then): `s_rep` chained rounds of build_problem +
    lm.solve a call (`solve_rounds`, one replayed program on a card), ms
    a solve the minimum over `samples` calls; the median over snapshots.
    Beside it the f64 baselines on the same problems: cpu_lm_solve on
    every snapshot, scipy_generic_solve (min of `scipy_runs`) on the
    last."""
    from .baselines.cpu_lm import cpu_lm_solve, scipy_generic_solve

    sync = synchronizer(device)
    sess = headline["_session"]
    table = sess["engine"].state.constraints
    config = lm.LMConfig()

    per_snapshot, iterations, cpu_ms, cpu_iters = [], [], [], []
    for start, n_active in sess["solve_snapshots"]:
        tbl = _first_rows(table, n_active)
        sp = torch.as_tensor(start, dtype=torch.float32, device=device)
        acc, its = solve_rounds(sp, tbl, config, s_rep)
        float(acc)
        iterations.append(int(its[-1]))
        times = []
        for k in range(samples):
            sync()
            t0 = time.perf_counter()
            acc, _ = solve_rounds(sp + 1e-7 * (k + 1), tbl, config, s_rep)
            float(acc)
            times.append((time.perf_counter() - t0) * 1e3 / s_rep)
        per_snapshot.append(min(times))
        t0 = time.perf_counter()
        _, cpu_cost, its = cpu_lm_solve(start, _np_table(table, n_active))
        cpu_ms.append((time.perf_counter() - t0) * 1e3)
        cpu_iters.append(int(its))
    start, n_active = sess["solve_snapshots"][-1]
    scipy_ms = []
    for _ in range(scipy_runs):
        _, scipy_cost, wall = scipy_generic_solve(
            start, _np_table(table, n_active))
        scipy_ms.append(wall * 1e3)
    return {
        "snapshots": len(per_snapshot), "s_rep": s_rep,
        "ms_per_solve": float(np.median(per_snapshot)),
        "ms_per_solve_each": per_snapshot,
        "lm_iterations": iterations,
        "cpu_lm_ms": float(np.median(cpu_ms)), "cpu_lm_ms_each": cpu_ms,
        "cpu_lm_iterations": cpu_iters,
        "cpu_lm_final_cost_last": float(cpu_cost),
        "scipy_ms": min(scipy_ms), "scipy_cost": float(scipy_cost),
    }


def seeded_big_chain(P: int = BIG_P, seed: int = BIG_SEED) -> np.ndarray:
    """bench.py:659-665: a P-pose chain of 0.4 m steps with headings a
    random walk of N(0, 0.05) increments."""
    rng = np.random.default_rng(seed)
    chain = np.zeros((P, 3), np.float32)
    heads = np.cumsum(rng.normal(0, 0.05, P)).astype(np.float32)
    chain[:, 2] = heads
    chain[1:, 0] = np.cumsum(0.4 * np.cos(heads[:-1]))
    chain[1:, 1] = np.cumsum(0.4 * np.sin(heads[:-1]))
    return chain


def joint_solve_section(device, table: ConstraintTable, P: int = BIG_P,
                        samples: int = 3) -> dict:
    """The ~10^4-pose joint solve alone: seeded_big_chain(P) with `table`
    (the headline session's) remapped to its poses (ids mod P), solved by
    lm.solve with BIG_CONFIG (a replay of its program on a card): one warm
    solve, then `samples` timed ones from starts moved by 1e-6 (k + 1);
    the minimum wall; beside it one timed eager solve (`eager=True`,
    `eager_wall_ms`). `_run` reruns one timed solve, `_eager_run` the same
    solve eagerly (what a profiler traces: it does not trace a replay's
    WHILE trips), `_inputs` are its input tensors."""
    sync = synchronizer(device)
    chain = torch.as_tensor(seeded_big_chain(P), device=device)
    big = dataclasses.replace(table, constrained=table.constrained % P,
                              anchor=table.anchor % P)
    problem = joint.build_problem(chain, big)
    r = lm.solve(problem, chain, BIG_CONFIG)
    iterations = [int(r.iterations)]
    times, costs = [], []
    for k in range(samples):
        pk = chain + 1e-6 * (k + 1)
        sync()
        t0 = time.perf_counter()
        r = lm.solve(problem, pk, BIG_CONFIG)
        costs.append(float(r.final_cost))
        times.append((time.perf_counter() - t0) * 1e3)
        iterations.append(int(r.iterations))

    def eager_run():
        return float(lm.solve(problem, chain + 1e-6, BIG_CONFIG,
                              eager=True).final_cost)

    eager_run()
    sync()
    t0 = time.perf_counter()
    eager_run()
    eager_ms = (time.perf_counter() - t0) * 1e3
    return {
        "poses": P, "rows": int(table.active.sum()),
        "max_iterations": BIG_CONFIG.max_iterations,
        "wall_ms": min(times), "wall_ms_samples": times,
        "eager_wall_ms": eager_ms,
        "iterations": iterations, "initial_cost": float(r.initial_cost),
        "final_cost": costs[-1],
        "finite": bool(torch.isfinite(r.poses).all()),
        "_run": lambda: float(lm.solve(problem, chain + 1e-6,
                                       BIG_CONFIG).final_cost),
        "_eager_run": eager_run,
        "_inputs": (chain, *vars(big).values()),
    }


def headline_run(device, smoke: bool = False) -> dict:
    """The headline session with its chain, solve-only and joint solve at
    the reference's sizes, or at the smoke size (one session, no warm-up,
    two repetitions, a 512-pose joint solve): {"headline", "chain",
    "solve_only", "joint_solve"}, each its section's dict."""
    if smoke:
        head = headline_section(device, m=generate_figure8(**SMOKE_MAP),
                                capacity=SMOKE_CAPACITY, sessions=1,
                                warmup=0)
        reps, n = SMOKE_REPS, {"samples": SMOKE_REPS["samples"]}
    else:
        head = headline_section(device)
        reps, n = dict(j_rep=J_REP, s_rep=S_REP, big=BIG_P), {}
    return {
        "headline": head,
        "chain": chain_section(device, head, j_rep=reps["j_rep"], **n),
        "solve_only": solve_only_section(
            device, head, s_rep=reps["s_rep"], **n,
            **({"scipy_runs": 1} if smoke else {})),
        "joint_solve": joint_solve_section(
            device, head["_session"]["engine"].state.constraints,
            P=reps["big"], **n),
    }


def refine_at_scale(device, state) -> dict:
    """The post-human refine of REFINE_AT_SCALE on `state` through the
    solver `auto` picks (PCG above refine.DENSE_POSE_LIMIT poses): one warm
    run, then two timed runs (points moved by 1e-6 (k + 1)), the minimum
    and both samples; then its two halves timed apart (the pair
    match, then the LM over its factors; on a card each a replay of its
    program, captured by an untimed first run); matches, the drop counters,
    iterations and costs of the untimed run. `_poses`: its refined
    poses; `_run` reruns one timed refine, `_inputs` are its input
    tensors."""
    from .models.hitl import refine as R

    sync = synchronizer(device)
    cfg = lm.LMConfig(max_iterations=REFINE_AT_SCALE["max_iterations"])
    kw = dict(capacity=REFINE_AT_SCALE["capacity"], config=cfg,
              matcher=REFINE_AT_SCALE["matcher"],
              max_pairs=REFINE_AT_SCALE["max_pairs"])
    st = state
    _reset_peak(device)
    out = R.post_human_refine(st.points, st.normals, st.point_mask, st.poses,
                              st.constraints, **kw)
    poses = out.poses.cpu().numpy()
    times = []
    for k in range(2):
        sync()
        t0 = time.perf_counter()
        o = R.post_human_refine(st.points + 1e-6 * (k + 1), st.normals,
                                st.point_mask, st.poses, st.constraints,
                                **kw)
        float(o.final_cost)
        times.append((time.perf_counter() - t0) * 1e3)

    def match():
        return R.match_factors(st.points, st.normals, st.point_mask,
                               st.poses, REFINE_AT_SCALE["matcher"],
                               REFINE_AT_SCALE["capacity"],
                               REFINE_AT_SCALE["max_pairs"], 64, None)[0]

    def solve(stf):
        return R.solve_factors(st.poses, st.constraints, stf, cfg, True,
                               "auto", REFINE_AT_SCALE["max_pairs"])

    if replays(st.poses):
        solve(match())
    sync()
    t0 = time.perf_counter()
    stf = match()
    sync()
    t1 = time.perf_counter()
    solve(stf)
    sync()
    t2 = time.perf_counter()

    def count(v):
        return None if v is None else int(v)

    P = st.num_poses
    return {
        **{k: v for k, v in REFINE_AT_SCALE.items()},
        "solver": "pcg" if P > R.DENSE_POSE_LIMIT else "dense_fused",
        "wall_ms": min(times), "wall_ms_samples": times,
        "match_ms": (t1 - t0) * 1e3, "lm_ms": (t2 - t1) * 1e3,
        "matches": int(out.num_matches),
        "match_dropped": count(out.match_dropped),
        "vote_dropped": count(out.vote_dropped),
        "elect_dropped": count(out.elect_dropped),
        "pairs_dropped": count(out.pairs_dropped),
        "iterations": int(out.iterations),
        "cg_iterations": count(out.cg_iterations),
        "initial_cost": float(out.initial_cost),
        "final_cost": float(out.final_cost),
        "finite": bool(np.isfinite(poses).all()
                       and np.isfinite(float(out.final_cost))),
        "peak_memory_mib": _peak_mib(device),
        "_poses": poses,
        "_run": lambda: float(R.post_human_refine(
            st.points + 1e-6, st.normals, st.point_mask, st.poses,
            st.constraints, **kw).final_cost),
        "_inputs": (st.points, st.normals, st.point_mask, st.poses,
                    *vars(st.constraints).values()),
    }


def scale_session_section(device, size: int, m=None, warmup: bool = True,
                          refine: bool = True) -> dict:
    """The reference's session of `size` poses (8192 or 16384) on `m`
    (default: its map of SCALE_MAPS), capacity SCALE_CAPACITY, the
    corrections of SCALE_SPECS scaled to m's poses: with `warmup`, a
    throw-away engine first replays the first correction; then a fresh
    engine runs the three COLINEAR corrections, timed one by one. Reports
    the flags, walls, iterations, costs and rows, the ground-truth errors
    before and after (the plain mean, as bench.py reports these sessions,
    and the aligned one), and the peak device memory of the session. At
    8192, with `refine`, refine_at_scale on the result; at 16384 the f64
    cpu_lm_solve of the last accepted cycle's problem from the same start
    and its relative gap to the cycle's final cost. `_session` holds the
    session, `_poses` its final poses, `_map` the map."""
    if m is None:
        m = generate_figure8(**SCALE_MAPS[size])
    P = m.poses.shape[0]
    specs = SCALE_SPECS[size](P)
    if warmup:
        run_session(m, specs[:1], SCALE_CAPACITY, device, odometry=False)
    _reset_peak(device)
    sess = run_session(m, specs, SCALE_CAPACITY, device, odometry=False)
    eng = sess["engine"]
    poses = eng.get_poses()
    out = {
        "poses": P, "points": int(sum(len(pc) for pc in m.point_clouds)),
        "padded_points": int(eng.state.max_points),
        "capacity": SCALE_CAPACITY, "warmup": warmup,
        "cycle_wall_ms": sess["walls"],
        "accepted_cycles": len(sess["solve_snapshots"]),
        **_report_fields(sess),
        "gt_mean": {"before": gt_error_mean(m.poses, m.gt_poses),
                    "after": gt_error_mean(poses, m.gt_poses)},
        "gt_aligned": {"before": gt_error_aligned(m.poses, m.gt_poses),
                       "after": gt_error_aligned(poses, m.gt_poses)},
        "peak_memory_mib": _peak_mib(device),
        "_session": sess, "_poses": poses, "_map": m,
    }
    if size == 16384 and sess["solve_snapshots"]:
        from .baselines.cpu_lm import cpu_lm_solve

        start, n_active = sess["solve_snapshots"][-1]
        dev_cost = [c for c in out["final_cost"] if c is not None][-1]
        t0 = time.perf_counter()
        _, f64_cost, f64_iters = cpu_lm_solve(
            start, _np_table(eng.state.constraints, n_active))
        out["f64"] = {
            "cost": float(f64_cost), "iterations": int(f64_iters),
            "ms": (time.perf_counter() - t0) * 1e3,
            "last_cycle_cost": dev_cost,
            "relative": abs(dev_cost - float(f64_cost))
            / max(abs(float(f64_cost)), 1e-9),
        }
    if size == 8192 and refine:
        out["refine"] = refine_at_scale(device, eng.state)
    return out
