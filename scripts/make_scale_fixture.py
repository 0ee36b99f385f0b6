"""Record the JAX package's results for the reference's HitL bench sessions.

    JAX_PLATFORMS=cpu python scripts/make_scale_fixture.py [--out tests/data]

Runs, with the JAX package on the CPU, the sessions of the root bench.py
that the port's `python -m hitl_slam_torch.bench --headline --scale` and
chip_smoke.py's [scale] phase reproduce:

  headline  the 1024-pose, 180-ray two-lap figure-8 (seed 7), capacity
            16384, the five mixed corrections of bench.py::correction_specs,
            replayed one by one; then the pipelined chain (queue_chain over
            the first min(4, accepted) accepted corrections, 16 repetitions
            from the initial state, as bench.py times it);
  s8192     the 8192-pose, 40-ray two-lap map (seed 13), capacity 32768, the
            three COLINEAR corrections of bench.py's 8192 session, then the
            post-human refine on its result (pair matcher, PCG, capacity
            262144, 5 LM iterations, max_pairs 16384);
  s16384    the 16384-pose, 40-ray four-lap map (seed 17), capacity 32768,
            the three corrections of bench.py's 16k session, and the f64
            cpu_lm_solve of the last cycle's problem from the same start.

Writes scale_sessions_jax.json (per session: the specs as run, accepted
flags, LM iterations, final costs, dropped rows, constraint rows, the
ground-truth errors, and for the refine its matches, drop counters,
iterations and costs; the chain's flags and LM iterations; the commit and
the command) and scale_sessions_jax.npz (the final poses of each session,
of the chain's first repetition and of the refine, and the 8192-pose
session's constraint rows the refine ran on). The port's machine has no JAX: these two files carry
the JAX result there. Takes a few minutes on 8 CPU threads.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def headline_specs(P):
    """bench.py:36-63, as dicts of plain values."""
    from bench import correction_specs

    return [dict(ctype=int(s["ctype"]),
                 corrected=[s["corrected"].start, s["corrected"].stop],
                 anchor=[s["anchor"].start, s["anchor"].stop],
                 cw=list(s["cw"]), aw=list(s["aw"]),
                 cspan=list(s["cspan"]), aspan=list(s["aspan"]),
                 min_points=40)
            for s in correction_specs(P)]


def _colinear(corrected, anchor, cw, aw):
    return dict(ctype=4, corrected=[corrected.start, corrected.stop],
                anchor=[anchor.start, anchor.stop], cw=list(cw),
                aw=list(aw), cspan=None, aspan=None, min_points=30)


def specs_8192():
    """bench.py:1110-1116."""
    P8 = 8192
    return [
        _colinear(range(P8 - 2400, P8 - 300), range(300, 2400), (1, 0.0),
                  (1, 0.0)),
        _colinear(range(6144, 8000), range(2048, 4000), (0, -20.0),
                  (0, -20.0)),
        _colinear(range(4200, 5400), range(120, 1600), (0, 20.0),
                  (0, 20.0)),
    ]


def specs_16384():
    """bench.py:802-812."""
    P16 = 16384
    lap16 = P16 // 4
    return [
        _colinear(range(3 * lap16 + 300, P16 - 300), range(300, lap16 - 300),
                  (1, 0.0), (1, 0.0)),
        _colinear(range(2 * lap16 + 200, 3 * lap16 - 200),
                  range(lap16 + 200, 2 * lap16 - 200), (0, -20.0),
                  (0, -20.0)),
        _colinear(range(3 * lap16 + 200, P16 - 200),
                  range(lap16 + 200, 2 * lap16 - 200), (0, 20.0),
                  (0, 20.0)),
    ]


def gt_aligned(poses, gt):
    """bench.py:249-262: mean position error after the optimal rigid
    alignment."""
    a = np.asarray(poses[:, :2], np.float64)
    b = np.asarray(gt[:, :2], np.float64)
    ca, cb = a.mean(0), b.mean(0)
    H = (a - ca).T @ (b - cb)
    Uu, _, Vt = np.linalg.svd(H)
    R = (Uu @ Vt).T
    if np.linalg.det(R) < 0:
        Vt[-1] *= -1
        R = (Uu @ Vt).T
    aligned = (a - ca) @ R.T + cb
    return float(np.linalg.norm(aligned - b, axis=1).mean())


def gt_mean(poses, gt):
    """bench.py:1118-1121: the plain mean position error."""
    a = np.asarray(poses[:, :2], np.float64)
    b = np.asarray(gt[:, :2], np.float64)
    return float(np.linalg.norm(a - b, axis=1).mean())


def run_session(m, specs, capacity, odometry):
    """bench.py:212-247 on a JAX HitLSLAM: each spec sketched against the
    poses of the moment and replayed. The headline session passes the map's
    odometry to init; the 8192- and 16384-pose sessions do not."""
    from hitl_slam_tpu.core.state import CorrectionType, SingleInput
    from hitl_slam_tpu.io.figure8 import synthesize_correction
    from hitl_slam_tpu.models.hitl.engine import HitLSLAM

    eng = HitLSLAM()
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             odometry=m.odometry if odometry else None,
             constraint_capacity=capacity)
    out = dict(accepted=[], lm_iterations=[], final_cost=[], dropped_rows=[],
               rows_after=[])
    snaps, inputs = [], []
    for s in specs:
        span = {}
        if s["cspan"] is not None:
            span = dict(corrected_span=tuple(s["cspan"]),
                        anchor_span=tuple(s["aspan"]))
        try:
            sel = synthesize_correction(
                m, range(*s["corrected"]), range(*s["anchor"]),
                tuple(s["cw"]), tuple(s["aw"]), min_points=s["min_points"],
                poses=eng.get_poses(), **span)
        except ValueError:
            for k in out:
                out[k].append(None)
            continue
        rep = eng.replay_log(SingleInput(CorrectionType(s["ctype"]), 0, sel))
        out["accepted"].append(bool(rep.accepted))
        out["lm_iterations"].append(int(rep.lm_iterations))
        out["final_cost"].append(float(rep.final_cost))
        out["dropped_rows"].append(int(rep.dropped_rows))
        out["rows_after"].append(int(eng.num_constraints))
        if rep.accepted:
            snaps.append((np.asarray(eng.last_pre_solve_poses, np.float64),
                          int(eng.num_constraints)))
            inputs.append((s["ctype"], np.asarray(sel, np.float32)))
    out["rows"] = int(eng.num_constraints)
    return eng, out, snaps, inputs


def np_table(tbl, n_active):
    t = dict(ctype=np.asarray(tbl.ctype),
             constrained=np.asarray(tbl.constrained),
             anchor=np.asarray(tbl.anchor),
             dpar=np.asarray(tbl.delta_parallel),
             dperp=np.asarray(tbl.delta_perpendicular),
             dth=np.asarray(tbl.delta_angle), pen=np.asarray(tbl.penalty_dir),
             active=np.asarray(tbl.active).copy())
    t["active"][n_active:] = False
    return t


def chain(m, eng, inputs, capacity, j_rep):
    """bench.py:438-560: queue_chain over the first min(4, accepted)
    accepted corrections, j_rep repetitions from the initial state."""
    import jax
    import jax.numpy as jnp

    from hitl_slam_tpu.core.state import ConstraintTable
    from hitl_slam_tpu.models.hitl.cycle import queue_chain

    st = eng.state
    k = min(4, len(inputs))
    ctypes = jnp.asarray([c for c, _ in inputs[:k]], jnp.int32)
    sels = jnp.stack([jnp.asarray(s, jnp.float32) for _, s in inputs[:k]])

    @jax.jit
    def chained(poses, covs, table, n0):
        per0 = (jnp.zeros((k,), bool), jnp.zeros((k,), bool),
                jnp.zeros((k,), bool), jnp.zeros((k,), jnp.int32),
                jnp.zeros((k,), jnp.int32), jnp.zeros((k,), jnp.float32),
                jnp.zeros((k,), jnp.float32))

        def rep(j, carry):
            chk_prev, p_first, _, _ = carry
            pj = (poses + chk_prev * jnp.float32(1e-30)
                  + jnp.float32(1e-6) * j)
            poses2, covs2, _t, n_end, per = queue_chain(
                st.points, st.point_mask, pj, covs, table, ctypes, sels, n0,
                warm_start_mu=False)
            p_first = jnp.where(j == 0, poses2, p_first)
            return (jnp.sum(poses2) + jnp.sum(covs2), p_first, n_end, per)

        return jax.lax.fori_loop(0, j_rep, rep,
                                 (jnp.float32(0.0), poses, n0, per0))

    _, p_first, _, per = chained(
        jnp.asarray(m.poses, jnp.float32),
        jnp.asarray(m.covariances, jnp.float32),
        ConstraintTable.empty(capacity), jnp.asarray(0, jnp.int32))
    return dict(cycles=k, j_rep=j_rep,
                accepted=np.asarray(per[0]).tolist(),
                lm_iterations=np.asarray(per[4]).tolist(),
                rows=int(np.asarray(per[3]).sum())), np.asarray(p_first)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "data"))
    args = ap.parse_args(argv)

    import jax

    from hitl_slam_tpu.baselines.cpu_lm import cpu_lm_solve
    from hitl_slam_tpu.io.figure8 import generate_figure8
    from hitl_slam_tpu.models.hitl.refine import post_human_refine
    from hitl_slam_tpu.solver.lm import LMConfig

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                            stdout=subprocess.PIPE, text=True).stdout.strip()
    record = {
        "made_by": "scripts/make_scale_fixture.py",
        "command": "JAX_PLATFORMS=cpu python scripts/make_scale_fixture.py",
        "commit": commit, "jax": jax.__version__, "numpy": np.__version__,
        "backend": jax.default_backend(),
    }
    arrays = {}
    t_all = time.perf_counter()

    # ---- headline + chain ----
    t0 = time.perf_counter()
    hmap = dict(num_poses=1024, num_rays=180, seed=7, drift_theta_bias=6e-4,
                num_laps=2)
    m = generate_figure8(**hmap)
    specs = headline_specs(1024)
    eng, out, _, inputs = run_session(m, specs, 16384, True)
    poses = eng.get_poses()
    out.update(map=hmap, capacity=16384, specs=specs,
               gt_aligned={"before": gt_aligned(m.poses, m.gt_poses),
                           "after": gt_aligned(poses, m.gt_poses)})
    arrays["headline_poses"] = poses
    ch, ch_poses = chain(m, eng, inputs, 16384, 16)
    arrays["chain_first_poses"] = ch_poses
    out["chain"] = ch
    out["seconds"] = time.perf_counter() - t0
    record["headline"] = out
    print(f"headline: {out}", flush=True)

    # ---- the 8192-pose session and its refine ----
    t0 = time.perf_counter()
    smap = dict(num_poses=8192, num_rays=40, seed=13, drift_theta_bias=1.5e-5,
                num_laps=2)
    m8 = generate_figure8(**smap)
    eng8, out, _, _ = run_session(m8, specs_8192(), 32768, False)
    poses = eng8.get_poses()
    out.update(map=smap, capacity=32768, specs=specs_8192(),
               gt_mean={"before": gt_mean(m8.poses, m8.gt_poses),
                        "after": gt_mean(poses, m8.gt_poses)},
               gt_aligned={"before": gt_aligned(m8.poses, m8.gt_poses),
                           "after": gt_aligned(poses, m8.gt_poses)})
    arrays["s8192_poses"] = poses
    st = eng8.state
    # the session's rows, so the refine can be run on the port from the
    # very state it ran from here
    n = out["rows"]
    for name in ("ctype", "constrained", "anchor", "delta_parallel",
                 "delta_perpendicular", "delta_angle", "penalty_dir",
                 "active"):
        arrays[f"s8192_table_{name}"] = np.asarray(getattr(st.constraints,
                                                           name))[:n]
    t1 = time.perf_counter()
    r = post_human_refine(st.points, st.normals, st.point_mask, st.poses,
                          st.constraints, capacity=262144,
                          config=LMConfig(max_iterations=5), matcher="pair",
                          max_pairs=16384)
    arrays["s8192_refine_poses"] = np.asarray(r.poses)

    def opt(v):
        return None if v is None else int(np.asarray(v))

    out["refine"] = dict(
        capacity=262144, max_iterations=5, matcher="pair", max_pairs=16384,
        matches=int(np.asarray(r.num_matches)),
        match_dropped=opt(r.match_dropped), vote_dropped=opt(r.vote_dropped),
        elect_dropped=opt(r.elect_dropped),
        pairs_dropped=opt(r.pairs_dropped),
        iterations=int(np.asarray(r.iterations)),
        initial_cost=float(r.initial_cost), final_cost=float(r.final_cost),
        seconds=time.perf_counter() - t1)
    out["seconds"] = time.perf_counter() - t0
    record["s8192"] = out
    print(f"s8192: {out}", flush=True)
    del eng8, st, r

    # ---- the 16384-pose session and its f64 parity ----
    t0 = time.perf_counter()
    smap = dict(num_poses=16384, num_rays=40, seed=17, drift_theta_bias=8e-6,
                num_laps=4)
    m16 = generate_figure8(**smap)
    eng16, out, snaps, _ = run_session(m16, specs_16384(), 32768, False)
    poses = eng16.get_poses()
    out.update(map=smap, capacity=32768, specs=specs_16384(),
               gt_mean={"before": gt_mean(m16.poses, m16.gt_poses),
                        "after": gt_mean(poses, m16.gt_poses)},
               gt_aligned={"before": gt_aligned(m16.poses, m16.gt_poses),
                           "after": gt_aligned(poses, m16.gt_poses)})
    arrays["s16384_poses"] = poses
    start, n_active = snaps[-1]
    last = [c for c in out["final_cost"] if c is not None][-1]
    _, f64_cost, f64_iters = cpu_lm_solve(
        start, np_table(eng16.state.constraints, n_active))
    out["f64"] = dict(cost=float(f64_cost), iterations=int(f64_iters),
                      last_cycle_cost=last,
                      relative=abs(last - float(f64_cost))
                      / max(abs(float(f64_cost)), 1e-9))
    out["seconds"] = time.perf_counter() - t0
    record["s16384"] = out
    print(f"s16384: {out}", flush=True)

    record["seconds"] = time.perf_counter() - t_all
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "scale_sessions_jax.json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    np.savez_compressed(os.path.join(args.out, "scale_sessions_jax.npz"),
                        **arrays)
    print(f"wrote {args.out}/scale_sessions_jax.json and .npz in "
          f"{record['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
