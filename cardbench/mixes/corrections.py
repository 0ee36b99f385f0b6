"""One operator repairing a map: sessions of corrections, closed loop, no
think time.

Set-up makes the map from the configuration with the frozen generator,
jitters its poses from the run's seed, loads it into a fresh
`HitLSLAM`, and runs one session in which each of the traffic's specs is
sketched against the poses of the moment and replayed (this captures each
correction type's device program); those clicks are then frozen. Warm
sessions follow until the process is WARM_UNTIL_S seconds old. The window
replays sessions back to back: a session is a fresh engine on the initial
map (the reset, timed apart) and the frozen clicks, each jittered by the
traffic's sub-millimetre amount, submitted one after another through
`HitLSLAM.replay_log`. A correction's latency is the
host clock from that call to a synchronise after it; rejected corrections
count too. The window ends at the first session end after `seconds`.

The check follows the program step by step: for a sample of sessions drawn
from the seed, each correction is recomputed by the plain reference
(reference/hitl_cycle.py) from the state the program had before it (its
poses and its table of earlier rows): verification, EM refit, ordering,
explicit correction, rows, back-propagation, and the LM on the problem
built from the reference's own pre-solve poses and rows.
"""

from __future__ import annotations

import math
import time
from dataclasses import replace

import numpy as np

from cardbench import tracing
from cardbench.frozen import figure8
from cardbench.frozen.sessions import sketch
from cardbench.harness import Check, RunRecord
from cardbench.reference import hitl_cycle as ref
from cardbench.reference.precision import BY_NAME, F64

LABELS = ("cardbench.reset", "cardbench.correction")
# a process on the card's machine runs corrections ~13 % slower until, once,
# 12-53 s after its start, it turns faster, whatever it does meanwhile
# (PERF.md, section 2): set-up replays sessions until the process is this old
WARM_UNTIL_S = 55.0


def decode_specs(specs: list, P: int) -> list[dict]:
    """The traffic's specs with their pose ranges, given as fractions of
    the map's poses, made ranges."""
    def span(f):
        return range(int(round(f[0] * P)), int(round(f[1] * P)))

    out = []
    for s in specs:
        out.append(dict(ctype=int(s["ctype"]), corrected=span(s["corrected"]),
                        anchor=span(s["anchor"]), cw=tuple(s["cw"]),
                        aw=tuple(s["aw"]),
                        cspan=None if s.get("cspan") is None else tuple(s["cspan"]),
                        aspan=None if s.get("aspan") is None else tuple(s["aspan"]),
                        min_points=int(s.get("min_points", 40))))
    return out


def make_map(config: dict, traffic: dict, seed: int):
    """The configuration's figure-8 map, its poses jittered from `seed`."""
    m = figure8.generate_figure8(**config["map"])
    rng = np.random.default_rng([int(seed), 1])
    amp = np.asarray(traffic["pose_jitter"], np.float64)
    poses = (m.poses + rng.uniform(-1.0, 1.0, m.poses.shape) * amp)
    return replace(m, poses=poses.astype(np.float32))


def padded(m) -> tuple[np.ndarray, np.ndarray]:
    """The map's clouds as [P, N, 2] points and a [P, N] mask."""
    P = len(m.point_clouds)
    N = max(len(pc) for pc in m.point_clouds)
    pts = np.zeros((P, N, 2), np.float64)
    mask = np.zeros((P, N), bool)
    for i, pc in enumerate(m.point_clouds):
        pts[i, :len(pc)] = pc
        mask[i, :len(pc)] = True
    return pts, mask


class Sessions:
    """The engine side of the mix: a fresh engine on the initial map, and
    one correction submitted and timed."""

    def __init__(self, ctx, m):
        import torch

        from hitl_slam_torch.core.state import CorrectionType, SingleInput
        from hitl_slam_torch.models.hitl.engine import HitLSLAM
        from hitl_slam_torch.solver.lm import LMConfig

        self.torch = torch
        self.CorrectionType, self.SingleInput = CorrectionType, SingleInput
        self.ctx = ctx
        cfg = ctx.cell.config
        self.HitLSLAM = HitLSLAM
        self.lm_config = LMConfig(**cfg["lm"])
        eng = HitLSLAM(self.lm_config, device=ctx.device)
        eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
                 odometry=m.odometry,
                 constraint_capacity=int(cfg["constraint_capacity"]))
        self.state0 = eng.state
        self.first = eng

    def fresh(self):
        eng = self.HitLSLAM(self.lm_config, device=self.ctx.device)
        eng.init_from_state(self.state0)
        return _recording(eng)

    def submit(self, eng, ctype: int, clicks: np.ndarray):
        """(report, wall ms) of one correction."""
        item = self.SingleInput(self.CorrectionType(ctype), 0, clicks)
        self.ctx.sync()
        t0 = time.perf_counter()
        rep = eng.replay_log(item)
        self.ctx.sync()
        return rep, (time.perf_counter() - t0) * 1e3


def _recording(eng):
    """The engine, keeping each cycle's output as `eng.cycle_out`: the EM
    refit points and the verification flag, which its report does not
    carry. It holds the output's tensors and reads nothing back."""
    inner = eng._run_cycle

    def run_cycle(*args, **kwargs):
        eng.cycle_out = inner(*args, **kwargs)
        return eng.cycle_out

    eng.cycle_out = None
    eng._run_cycle = run_cycle
    return eng


def _plant(ctx, eng):
    """Tests only: break the timed path under the engine. "unchanged": a
    correction leaves the poses as they were; "altered": one pose of the
    answer moves by a centimetre where it is produced."""
    if ctx.fault is None:
        return eng
    inner = eng.replay_log

    def broken(item, record=False):
        before = eng.state
        rep = inner(item, record)
        if ctx.fault == "unchanged":
            eng.state = eng.state.replace(poses=before.poses)
        elif ctx.fault == "altered":
            p = eng.state.poses.clone()
            p[p.shape[0] // 2, 0] += 0.01
            eng.state = eng.state.replace(poses=p)
        return rep

    eng.replay_log = broken
    return eng


def run(ctx) -> RunRecord:
    tr = ctx.cell.traffic
    marks = {"start_s": time.perf_counter() - ctx.t0}
    m = make_map(ctx.cell.config, tr, ctx.seed)
    P = m.poses.shape[0]
    specs = decode_specs(tr["specs"], P)
    marks["map_s"] = time.perf_counter() - ctx.t0
    sess = Sessions(ctx, m)
    marks["loaded_s"] = time.perf_counter() - ctx.t0

    # the sketch session: clicks against the poses of the moment, frozen
    clicks = []
    eng = sess.first
    for s in specs:
        try:
            sel = sketch(m, s, eng.get_poses())
        except ValueError:
            continue
        sess.submit(eng, s["ctype"], sel)
        clicks.append((s["ctype"], np.asarray(sel, np.float32)))
    if not clicks:
        raise RuntimeError("no correction of the traffic could be sketched")
    ctx.sync()
    marks["sketched_s"] = time.perf_counter() - ctx.t0

    rng = np.random.default_rng([ctx.seed, 2])
    pick = np.random.default_rng([ctx.seed, 3])
    amp = float(tr["click_jitter_m"])

    def session(keep: bool):
        """One session; its latencies, LM iterations, failures and, where
        `keep`, each correction's record for the check."""
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(LABELS[0]):
            e = _plant(ctx, sess.fresh())
        reset = time.perf_counter() - t0
        jit = rng.uniform(-amp, amp, (len(clicks), 4, 2))
        lat, its, rec, bad = [], [], [], 0
        for k, (ct, sel) in enumerate(clicks):
            sel_j = (sel + jit[k]).astype(np.float32)
            st, n0 = e.state, e.num_constraints
            e.cycle_out = None
            with torch.profiler.record_function(LABELS[1]):
                rep, ms = sess.submit(e, ct, sel_j)
            lat.append(ms)
            its.append(int(rep.lm_iterations))
            bad += int("diverged" in rep.reason)
            if keep:
                rec.append(dict(ctype=ct, clicks=sel_j, before=st, n0=n0,
                                report=rep, after=e.state, cycle=e.cycle_out,
                                pre=e.last_pre_solve_poses if rep.accepted
                                else None))
        return lat, its, bad, rec, reset

    # warm sessions until the process is WARM_UNTIL_S old (on the card)
    n = 0
    while (ctx.device.startswith("cuda")
           and time.perf_counter() - ctx.t0 < WARM_UNTIL_S):
        session(False)
        n += 1
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0
    marks["warm_sessions"] = n

    # the window: whole sessions; a reservoir of `check_sessions` of them,
    # drawn from the seed, is kept for the check
    k = int(tr["check_sessions"])
    kept: list = []
    lat, its, resets = [], [], []
    failed = 0
    last_reports: list = []
    t_w = time.perf_counter()
    i = 0
    while True:
        slot = i if i < k else int(pick.integers(0, i + 1))
        keep = slot < k
        l_, it_, bad, rec, reset = session(keep)
        last_reports = [r["report"] for r in rec] if keep else last_reports
        lat += l_
        its += it_
        failed += bad
        resets.append(reset)
        if keep:
            if slot < len(kept):
                kept[slot] = rec
            else:
                kept.append(rec)
        i += 1
        if time.perf_counter() - t_w >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_w

    run = RunRecord(setup_s=setup_s, window_s=window_s, attempted=len(lat),
                    failed=failed)
    run.samples = {"correction_ms": lat, "lm_iterations": its,
                   "reset_ms": [r * 1e3 for r in resets]}
    if ctx.device.startswith("cuda"):
        run.memory_peak_bytes = sess.torch.cuda.max_memory_allocated()
    run.notes = {**{"setup_" + k: v for k, v in marks.items()},
                 "sessions": i, "window_s": window_s,
                 "reset_ms_median": float(np.median(run.samples["reset_ms"])),
                 "accepted_a_session": sum(r.accepted for r in last_reports)}

    if ctx.trace:
        run.trace = trace_phase(ctx, sess, session, clicks)
        run.notes["traced_graph_launches"] = run.trace.get("graphs", 0)

    recs = [r for s in kept for r in s]
    pts, mask = padded(m)
    run.checks, notes = check(recs, pts, mask, ctx.cell.workload["limits"],
                              BY_NAME[ctx.control] if ctx.control else None)
    run.notes.update(notes)
    return run


def trace_phase(ctx, sess, session, clicks) -> dict:
    """A traced window of `trace_sessions` sessions, then the two kernels
    launched eagerly at the cell's shapes, each under the profiler."""
    import torch

    tr = ctx.cell.traffic
    out = {}
    win: dict = {}
    with tracing.profiled(ctx.device, win):
        with torch.profiler.record_function(tracing.WINDOW):
            for _ in range(int(tr["trace_sessions"])):
                session(False)
            ctx.sync()
    readings = tracing.window_readings(win["events"], LABELS)
    if readings is not None:
        out.update(readings)
    if not ctx.device.startswith("cuda"):
        return out

    from hitl_slam_torch.ops.em_scan import em_scan
    from hitl_slam_torch.solver.bcr_kernel import bcr_solve_cuda

    st = sess.state0
    n = int(tr["probe_launches"])
    th = st.poses[:, 2:3]
    c, s = torch.cos(th), torch.sin(th)
    x, y = st.points[..., 0], st.points[..., 1]
    world = torch.stack([c * x - s * y + st.poses[:, 0:1],
                         s * x + c * y + st.poses[:, 1:2]], -1).contiguous()
    sel = torch.as_tensor(clicks[0][1], device=ctx.device)
    P = st.poses.shape[0]
    g = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    A = torch.randn((P, 3, 3), generator=g, device=ctx.device)
    D = (A @ A.transpose(-1, -2) + 8.0 * torch.eye(3, device=ctx.device))
    U = 0.1 * torch.randn((P - 1, 3, 3), generator=g, device=ctx.device)
    b = torch.randn((P, 3), generator=g, device=ctx.device)
    em_scan(world, st.point_mask, sel)
    bcr_solve_cuda(D, U, b)
    ctx.sync()
    ev: dict = {}
    with tracing.profiled(ctx.device, ev):
        for _ in range(n):
            em_scan(world, st.point_mask, sel)
    t, launches = tracing.kernel_seconds(ev["events"], "em_scan")
    out["em_scan"] = dict(device_s=t, launches=launches,
                          mask=st.point_mask.cpu().numpy())
    ev = {}
    with tracing.profiled(ctx.device, ev):
        for _ in range(n):
            bcr_solve_cuda(D, U, b)
    t, launches = tracing.kernel_seconds(ev["events"], "bcr")
    out["bcr"] = dict(device_s=t, calls=n, n=P)
    return out


# -- the check ------------------------------------------------------------------

def _table(t) -> dict:
    return {f: getattr(t, f).detach().cpu().numpy()
            for f in ("ctype", "constrained", "anchor", "delta_parallel",
                      "delta_perpendicular", "delta_angle", "penalty_dir",
                      "active")}


def _gap(a, b) -> float:
    """Largest difference of two [P, 3] pose arrays, headings wrapped."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    d[:, 2] = np.abs(ref.angle_mod(np.asarray(a, np.float64)[:, 2]
                                   - np.asarray(b, np.float64)[:, 2]))
    return float(d.max()) if d.size else 0.0


ROW_INTS = ("ctype", "constrained", "anchor")
ROW_LENGTHS = ("delta_parallel", "delta_perpendicular")
ROW_ANGLES = ("delta_angle", "penalty_dir")


def _row_gap(a: dict, b: dict) -> float | None:
    """Largest difference (m or rad) of the offsets and angles of the rows
    that both write for the same (anchor, constrained) pair; None where
    they share none."""
    ka = {(x, y): i for i, (x, y) in enumerate(zip(a["anchor"], a["constrained"]))}
    pairs = [(ka[(x, y)], j) for j, (x, y) in
             enumerate(zip(b["anchor"], b["constrained"])) if (x, y) in ka]
    if not pairs:
        return None
    ia, ib = (np.array(v) for v in zip(*pairs))
    g = 0.0
    for k in ROW_LENGTHS:
        g = max(g, float(np.max(np.abs(a[k][ia] - b[k][ib]))))
    for k in ROW_ANGLES:
        g = max(g, float(np.max(np.abs(ref.angle_mod(a[k][ia] - b[k][ib])))))
    return g


def candidate_program(r: dict) -> dict:
    """What the program produced for one correction, read back."""
    rep = r["report"]
    n = int(rep.num_new_constraints) if rep.accepted else 0
    after = _table(r["after"].constraints)
    rows = {k: v[r["n0"]:r["n0"] + n].astype(np.int64 if k in ROW_INTS
                                               else np.float64)
            for k, v in after.items() if k != "active"}
    cyc = r["cycle"]
    return dict(accepted=bool(rep.accepted), rows=rows,
                verified=cyc is not None and bool(cyc.verified),
                refit=None if cyc is None
                else cyc.refit_sel.detach().cpu().numpy().astype(np.float64),
                pre=None if r["pre"] is None
                else r["pre"].detach().cpu().numpy().astype(np.float64),
                table=after,
                poses=r["after"].poses.detach().cpu().numpy().astype(np.float64),
                final_cost=float(rep.final_cost))


def candidate_control(r: dict, pts, mask, prec) -> dict:
    """The reference computed in `prec`, put in the program's place."""
    st = r["before"]
    poses = st.poses.detach().cpu().numpy().astype(np.float64)
    covs = st.covariances.detach().cpu().numpy().astype(np.float64)
    f = ref.cycle_front(pts, mask, poses, covs, r["ctype"],
                        r["clicks"].astype(np.float64), prec)
    acc = f["verified"] and f["order_valid"]
    table = _table(st.constraints)
    n = len(f["rows"]["ctype"])
    n0 = r["n0"]
    for k, v in f["rows"].items():
        table[k] = table[k].copy()
        table[k][n0:n0 + n] = v
    table["active"] = table["active"].copy()
    table["active"][n0:n0 + n] = True
    common = dict(rows=f["rows"], verified=bool(f["verified"]),
                  refit=f["refit"], table=table)
    if not acc:
        return dict(accepted=False, pre=None, poses=poses,
                    final_cost=math.nan, **common)
    lm = ref.lm_solve(f["pre_solve"], table, prec)
    return dict(accepted=True, pre=f["pre_solve"], poses=lm["poses"],
                final_cost=lm["final_cost"], **common)


# a threshold test within this distance (m) of its threshold is within the
# rounding of the float32 program (world coordinates to 25 m round by
# ~2e-6 m, the refit strokes differ from the reference's by ~1e-6 m): its
# outcome is the program's to decide, and the reference follows it
AMBIGUITY_M = 2e-5

CHECKS = ("decisions", "refit_gap", "pre_solve_gap", "rows_gap",
          "final_excess", "cost_gap")


def _refit_gap(a, b) -> float:
    """Largest distance (m) between the refit points of two [4, 2] stroke
    pairs, taken in whichever order of the two strokes lies closer (the
    ordering swaps them; whether it did is a decision of its own)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return min(float(np.max(np.hypot(*(a - c).T)))
               for c in (b, np.concatenate([b[2:4], b[0:2]])))


def _with_rows(table: dict, n0: int, rows: dict) -> dict:
    """`table` with the offsets and angles of its rows n0.. replaced by
    `rows`' (the same pose pairs: `decisions` holds them equal)."""
    out = dict(table)
    n = len(rows["ctype"])
    for k in ROW_LENGTHS + ROW_ANGLES:
        out[k] = table[k].astype(np.float64)
        out[k][n0:n0 + n] = rows[k]
    return out


def readings(recs: list, pts, mask, control=None) -> dict:
    """The check's numbers over the sampled corrections, and the largest
    final pose difference as a note:

      decisions       corrections whose verification, acceptance, row count
                      or row indices differ from the reference's under
                      every outcome of the threshold tests within
                      AMBIGUITY_M of their thresholds (the reference
                      follows the one that agrees; `followed` counts them,
                      a note)
      refit_gap       largest distance (m) of the EM refit points, where
                      both verify
      pre_solve_gap   largest pose difference (m or rad) of the poses the
                      cycle hands its LM, where both accept: EM refit,
                      ordering, explicit correction and back-propagation
      rows_gap        largest difference (m or rad) of the offsets and
                      angles of the rows both write for the same pose pair
      final_excess    the reference's cost at the candidate's final poses
                      less its own optimum, |.| / (1 + its initial cost):
                      the reference's LM solves its own problem, built from
                      its own pre-solve poses and rows
      cost_gap        |candidate's final cost - reference's optimum| /
                      (1 + reference's initial cost)
      final_gap       (note) largest final pose difference (m or rad)

    A number that no sampled correction could read stays None (and the
    check fails)."""
    out = dict.fromkeys(CHECKS + ("final_gap",))
    out["decisions"] = out["followed"] = 0

    def worst(k, v):
        if v is not None:
            out[k] = v if out[k] is None else max(out[k], v)

    for r in recs:
        cand = (candidate_program(r) if control is None
                else candidate_control(r, pts, mask, control))
        st = r["before"]
        poses = st.poses.detach().cpu().numpy().astype(np.float64)
        covs = st.covariances.detach().cpu().numpy().astype(np.float64)

        def same(f):
            return (bool(f["verified"]) == cand["verified"]
                    and (f["verified"] and f["order_valid"]) == cand["accepted"]
                    and len(f["rows"]["ctype"]) == len(cand["rows"]["ctype"])
                    and all(np.array_equal(f["rows"][k], cand["rows"][k])
                            for k in ROW_INTS))

        fronts = ref.cycle_fronts(pts, mask, poses, covs, r["ctype"],
                                  r["clicks"].astype(np.float64), F64,
                                  AMBIGUITY_M)
        first = f = next(fronts)
        if not same(f):
            f = next((g for g in fronts if same(g)), first)
            out["decisions"] += int(not same(f))
            out["followed"] += int(same(f))
        if f["verified"] and cand["verified"]:
            worst("refit_gap", _refit_gap(cand["refit"], f["refit"]))
        if not (f["verified"] and f["order_valid"] and cand["accepted"]):
            continue
        worst("pre_solve_gap", _gap(cand["pre"], f["pre_solve"]))
        worst("rows_gap", _row_gap(cand["rows"], f["rows"]))
        if len(f["rows"]["ctype"]) != len(cand["rows"]["ctype"]):
            continue
        table = _with_rows(cand["table"], r["n0"], f["rows"])
        lm = ref.lm_solve(f["pre_solve"], table, F64)
        scale = 1.0 + lm["initial_cost"]
        mine = cand["poses"].copy()
        mine[:, 2] = lm["unwrapped"][:, 2] + ref.angle_mod(
            mine[:, 2] - lm["unwrapped"][:, 2])
        at = ref.joint_cost(f["pre_solve"], table, mine)
        worst("final_excess", abs(at - lm["final_cost"]) / scale)
        worst("cost_gap", abs(cand["final_cost"] - lm["final_cost"]) / scale)
        worst("final_gap", _gap(cand["poses"], lm["poses"]))
    return out


def check(recs: list, pts, mask, limits: dict, control=None
          ) -> tuple[list, dict]:
    """The checks against `limits`, and the notes (the final pose gap)."""
    vals = readings(recs, pts, mask, control)
    return ([Check(k, vals[k], float(limits[k])) for k in CHECKS],
            {"final_gap": vals["final_gap"], "followed": vals["followed"]})
