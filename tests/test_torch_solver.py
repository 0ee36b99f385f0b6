"""Port parity: block-tridiagonal solve (plain version of the BCR kernel),
factor residuals/Jacobians, normal-equation assembly, and LM, against the
JAX package on the CPU. The CUDA kernel itself is held against its plain
version on the card in tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (banded_solve_f64, chain_poses as _chain, n,
                                random_spd_tridiag, t)

torch.set_num_threads(2)


# ------------------------------------------------------------ tridiagonal

def test_inv3_matches(rng):
    from hitl_slam_torch.solver.tridiag import inv3
    from hitl_slam_tpu.solver.tridiag import inv3 as jinv3

    m = rng.normal(size=(64, 3, 3))
    m = (m @ np.swapaxes(m, -1, -2) + 3 * np.eye(3)).astype(np.float32)
    got = n(inv3(t(m)))
    # f32 adjugate inverses of well-conditioned SPD blocks: identical
    # formulas, so agreement is to a few f32 ulps of the entries (<= 1)
    np.testing.assert_allclose(got, np.asarray(jinv3(jnp.asarray(m))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.linalg.inv(m.astype(np.float64)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("num", [1, 2, 127, 128, 129, 1000, 4097])
def test_bcr_plain_matches_jax_and_f64(num):
    from hitl_slam_torch.solver.tridiag import bcr_solve
    from hitl_slam_tpu.solver.tridiag import bcr_solve as jbcr

    D, U, b = random_spd_tridiag(np.random.default_rng(num), num)
    D32, U32, b32 = (a.astype(np.float32) for a in (D, U, b))
    got = n(bcr_solve(t(D32), t(U32), t(b32)))
    ref = np.asarray(jbcr(jnp.asarray(D32), jnp.asarray(U32),
                          jnp.asarray(b32)))
    x64 = banded_solve_f64(D32.astype(np.float64), U32.astype(np.float64),
                           b32.astype(np.float64))
    scale = max(1.0, float(np.abs(x64).max()))
    # same algorithm in f32 on both sides; only the 3-term sum order of the
    # batched 3x3 products differs. These systems have cond(H) < ~20, so
    # both sit within ~1e-6 of the f64 solution; bounds leave 10x margin.
    assert np.abs(got - ref).max() <= 1e-5 * scale
    assert np.abs(got - x64).max() <= 1e-5 * scale


def test_bcr_wrapper_cpu_runs_plain_version():
    from hitl_slam_torch.solver import bcr_kernel, tridiag

    D, U, b = (t(a.astype(np.float32)) for a in
               random_spd_tridiag(np.random.default_rng(0), 37))
    before = bcr_kernel.launches.count
    x = bcr_kernel.bcr_solve(D, U, b)
    assert torch.equal(x, tridiag.bcr_solve(D, U, b))
    assert bcr_kernel.launches.count == before   # no kernel on the CPU
    with pytest.raises(ValueError):
        bcr_kernel.bcr_solve_cuda(D, U, b)


def test_default_linear_solver_selection():
    from hitl_slam_torch.solver import bcr_kernel, tridiag
    from hitl_slam_torch.solver.lm import _default_linear_solver

    assert _default_linear_solver("cpu") is tridiag.bcr_solve
    assert _default_linear_solver(torch.device("cuda")) is bcr_kernel.bcr_solve_cuda
    assert _default_linear_solver("cuda:0") is bcr_kernel.bcr_solve_cuda
    with pytest.raises(ValueError):
        _default_linear_solver("meta")


# ------------------------------------------------------------ residuals

def test_geometry_matches(rng):
    from hitl_slam_torch.ops import geometry as TG
    from hitl_slam_tpu.ops import geometry as JG

    th = rng.uniform(-8, 8, 50).astype(np.float32)
    v = rng.normal(0, 5, (50, 2)).astype(np.float32)
    w = rng.normal(0, 5, (50, 2)).astype(np.float32)
    pose = np.concatenate([rng.normal(0, 5, (50, 2)), th[:, None]],
                          1).astype(np.float32)
    p1, p2 = v[:1], w[:1]
    # single f32 trig/atan2 calls of the two libraries: ~1 ulp apart
    cases = [
        (TG.angle_mod(t(th)), JG.angle_mod(jnp.asarray(th))),
        (TG.rotate(t(th), t(v)), JG.rotate(jnp.asarray(th), jnp.asarray(v))),
        (TG.perp(t(v)), JG.perp(jnp.asarray(v))),
        (TG.scalar_cross(t(v), t(w)),
         JG.scalar_cross(jnp.asarray(v), jnp.asarray(w))),
        (TG.pose_to_world(t(pose), t(v)),
         JG.pose_to_world(jnp.asarray(pose), jnp.asarray(v))),
        (TG.world_to_robot(t(pose), t(v)),
         JG.world_to_robot(jnp.asarray(pose), jnp.asarray(v))),
        (TG.dist_to_segment(t(p1), t(p2), t(v)),
         JG.dist_to_segment(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(v))),
    ]
    for a, b in cases:
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    # a round trip through the robot frame is the identity
    torch.testing.assert_close(
        TG.pose_to_world(t(pose), TG.world_to_robot(t(pose), t(v))), t(v),
        rtol=0, atol=1e-5)


def _table_arrays(rng, capacity, num_poses, rows):
    """A constraint table with `rows` active rows cycling over all six
    correction types, the rest inactive (numpy, the converter's layout)."""
    tab = {
        "ctype": np.zeros(capacity, np.int32),
        "constrained": np.zeros(capacity, np.int32),
        "anchor": np.zeros(capacity, np.int32),
        "delta_parallel": np.zeros(capacity, np.float32),
        "delta_perpendicular": np.zeros(capacity, np.float32),
        "delta_angle": np.zeros(capacity, np.float32),
        "penalty_dir": np.zeros(capacity, np.float32),
        "active": np.zeros(capacity, bool),
    }
    for r in range(rows):
        tab["ctype"][r] = 1 + r % 6
        tab["constrained"][r] = rng.integers(num_poses // 2, num_poses)
        tab["anchor"][r] = rng.integers(0, num_poses // 2)
        tab["delta_parallel"][r] = rng.normal(0, 1)
        tab["delta_perpendicular"][r] = rng.normal(0, 0.5)
        tab["delta_angle"][r] = rng.normal(0, 0.2)
        tab["penalty_dir"][r] = rng.normal(0, 1)
        tab["active"][r] = True
    return tab


def _jax_table(tab):
    from hitl_slam_tpu.core.state import ConstraintTable

    return ConstraintTable(**{k: jnp.asarray(v) for k, v in tab.items()})


def _problem_pair(seed=7, num=40, capacity=32, rows=18):
    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.solver import joint as TJ
    from hitl_slam_tpu.solver import joint as JJ

    rng = np.random.default_rng(seed)
    poses = _chain(rng, num)
    tab = _table_arrays(rng, capacity, num, rows)
    jp = JJ.build_problem(jnp.asarray(poses), _jax_table(tab))
    tp = TJ.build_problem(t(poses), table_from_numpy(tab, "cpu"))
    poses1 = (poses + rng.normal(0, 0.05, poses.shape)).astype(np.float32)
    return jp, tp, poses, poses1


def test_factors_and_residuals_match():
    from hitl_slam_torch.ops import residuals as TR
    from hitl_slam_tpu.ops import residuals as JR

    jp, tp, poses, poses1 = _problem_pair()
    # f32 trig/atan2 of the two libraries differ by ~1 ulp; residuals carry
    # 1/sigma = 100 on the angular term, so atol 1e-4 is ~10 ulp of O(1)
    for name in ("axis", "radial", "rotation", "inv_sigma"):
        np.testing.assert_allclose(n(getattr(tp.odom, name)),
                                   np.asarray(getattr(jp.odom, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(n(tp.human.M), np.asarray(jp.human.M),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(tp.human.target), np.asarray(jp.human.target),
                               rtol=1e-5, atol=1e-5)
    for p in (poses, poses1):
        np.testing.assert_allclose(
            n(TR.odometry_residuals(tp.odom, t(p))),
            np.asarray(JR.odometry_residuals(jp.odom, jnp.asarray(p))),
            rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            n(TR.human_residuals(tp.human, t(p))),
            np.asarray(JR.human_residuals(jp.human, jnp.asarray(p))),
            rtol=1e-5, atol=1e-5)
        for a, b in zip(TR.odometry_jacobians(tp.odom, t(p)),
                        JR.odometry_jacobians(jp.odom, jnp.asarray(p))):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5,
                                       atol=1e-3)
        for a, b in zip(TR.compact_human_terms(tp.compact, t(p)),
                        JR.compact_human_terms(jp.compact, jnp.asarray(p))):
            np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-4,
                                       atol=1e-4)
    np.testing.assert_allclose(n(tp.compact.A), np.asarray(jp.compact.A),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tp.compact.c), np.asarray(jp.compact.c),
                               rtol=1e-5, atol=1e-5)


def test_compact_reduction_onehot_equals_index_add(monkeypatch):
    """The one-hot matmul reduction and the scatter-add (an accumulating
    index_put_) that takes over past ONEHOT_BUDGET give the same per-pose
    terms."""
    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.solver import joint as TJ

    rng = np.random.default_rng(3)
    poses = t(_chain(rng, 30))
    table = table_from_numpy(_table_arrays(rng, 24, 30, 20), "cpu")
    a = TJ.build_problem(poses, table).compact
    monkeypatch.setattr(TJ, "ONEHOT_BUDGET", 0)
    b = TJ.build_problem(poses, table).compact
    # one matmul vs sequential adds: f32 reassociation of <= 20 terms
    torch.testing.assert_close(a.A, b.A, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a.c, b.c, rtol=1e-5, atol=1e-5)


def test_jacobians_match_autograd():
    """The analytic odometry Jacobians equal torch.autograd's (in f64, away
    from the angle wrap), as tests/test_residuals.py checks for JAX."""
    from hitl_slam_torch.ops import residuals as TR

    rng = np.random.default_rng(11)
    poses = torch.as_tensor(_chain(rng, 12), dtype=torch.float64)
    f = TR.build_odometry_factors(poses)
    p1 = poses + torch.as_tensor(rng.normal(0, 0.05, (12, 3)))
    jac = torch.autograd.functional.jacobian(
        lambda p: TR.odometry_residuals(f, p), p1)      # [F,3,P,3]
    J1, J2 = TR.odometry_jacobians(f, p1)
    F = J1.shape[0]
    for k in range(F):
        torch.testing.assert_close(jac[k, :, k, :], J1[k], rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(jac[k, :, k + 1, :], J2[k], rtol=1e-9,
                                   atol=1e-9)


def test_soa_assembly_matches_both_jax_assemblies():
    from hitl_slam_torch.solver import assembly_soa as TS
    from hitl_slam_tpu.solver import assembly_soa as JS, joint as JJ

    jp, tp, poses, poses1 = _problem_pair(seed=5)
    sc = TS.soa_constants(tp)
    for p in (poses, poses1):
        got = TS.normal_equations_soa(tp, sc, t(p))
        ref_aos = JJ.normal_equations(jp, jnp.asarray(p))
        ref_soa = JS.normal_equations_soa(jp, JS.soa_constants(jp),
                                          jnp.asarray(p))
        for i, name in enumerate(("D", "U", "g", "cost")):
            scale = max(1.0, float(np.abs(np.asarray(ref_aos[i])).max()))
            # entries reach 1/sigma^2 = 1e4; f32 reassociation and ~1 ulp
            # trig differences stay below 1e-5 of the largest entry
            for ref in (ref_aos, ref_soa):
                np.testing.assert_allclose(n(got[i]), np.asarray(ref[i]),
                                           rtol=1e-5, atol=1e-5 * scale,
                                           err_msg=name)


# ------------------------------------------------------------ LM

class _Recorder:
    """Wraps a linear solver and records each call's rhs (= -g) and step:
    g changes only on an accepted step, so the rhs sequence gives the
    accept/reject sequence."""

    def __init__(self, solver, to_np):
        self.solver, self.to_np = solver, to_np
        self.rhs, self.steps = [], []

    def __call__(self, D, U, b):
        x = self.solver(D, U, b)
        self.rhs.append(np.array(self.to_np(b)))
        self.steps.append(np.array(self.to_np(x)))
        return x

    def accepts(self, poses0, final_poses):
        acc = [not np.array_equal(a, b)
               for a, b in zip(self.rhs[:-1], self.rhs[1:])]
        x = np.asarray(poses0, np.float32)
        for a, s in zip(acc, self.steps):
            if a:
                x = x + s
        # the last step was accepted iff the result moved off x_{K-1}
        acc.append(not np.array_equal(np.asarray(final_poses), x))
        return acc


def _lm_problem(kind, seed):
    from hitl_slam_tpu.core.state import CorrectionType

    rng = np.random.default_rng(seed)
    if kind == "noop":
        poses = _chain(rng, 20)
        return poses, None, 100
    if kind == "pulls":
        poses = _chain(rng, 30)
        return poses, (int(CorrectionType.LINE_SEGMENT), 25, 5, 1.0, 0.5,
                       0.1, 0.0), 100
    poses = _chain(rng, 25)
    return poses, (int(CorrectionType[kind]), 20, 4, 0.8, 0.3, 0.15, 0.4), 200


def _one_row_table(row, capacity=16):
    tab = {
        "ctype": np.zeros(capacity, np.int32),
        "constrained": np.zeros(capacity, np.int32),
        "anchor": np.zeros(capacity, np.int32),
        "delta_parallel": np.zeros(capacity, np.float32),
        "delta_perpendicular": np.zeros(capacity, np.float32),
        "delta_angle": np.zeros(capacity, np.float32),
        "penalty_dir": np.zeros(capacity, np.float32),
        "active": np.zeros(capacity, bool),
    }
    if row is not None:
        ct, c, a, dpar, dperp, dth, pen = row
        tab["ctype"][0], tab["constrained"][0], tab["anchor"][0] = ct, c, a
        tab["delta_parallel"][0] = dpar
        tab["delta_perpendicular"][0] = dperp
        tab["delta_angle"][0] = dth
        tab["penalty_dir"][0] = pen
        tab["active"][0] = True
    return tab


def _true_relative_change(poses, tab, accepted, steps) -> float:
    """|c(x + s_k) - c(x)| / c(x) in f64, where x replays the accepted
    steps before step k = len(accepted)."""
    from hitl_slam_torch.core.state import ConstraintTable
    from hitl_slam_torch.solver import joint as TJ

    table = ConstraintTable(**{
        k: torch.as_tensor(v).double() if v.dtype == np.float32
        else torch.as_tensor(v) for k, v in tab.items()})
    x = np.asarray(poses, np.float32)
    for a, s in zip(accepted, steps):
        if a:
            x = x + s
    prob = TJ.build_problem(torch.as_tensor(poses).double(), table)
    c0 = float(TJ.cost(prob, torch.as_tensor(x).double()))
    c1 = float(TJ.cost(prob, torch.as_tensor(x + steps[-1]).double()))
    return abs(c1 - c0) / max(c0, 1e-30)


@pytest.mark.parametrize("kind", ["noop", "pulls", "LINE_SEGMENT", "COLINEAR",
                                  "PERPENDICULAR", "PARALLEL"])
def test_lm_parity(kind):
    """The tests/test_lm.py problems: equal iteration counts, an equal
    accept/reject sequence and the same final cost. The JAX solve runs with
    jit disabled so its per-iteration solver calls can be recorded."""
    _lm_parity(kind, use_soa=True)


def _lm_parity(kind, use_soa):
    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.solver import joint as TJ, lm as TL, tridiag as TT
    from hitl_slam_tpu.solver import joint as JJ, lm as JL
    from hitl_slam_tpu.solver.tridiag import bcr_solve as jbcr

    poses, row, iters = _lm_problem(kind, seed=len(kind))
    tab = _one_row_table(row)
    jrec = _Recorder(jbcr, np.asarray)
    with jax.disable_jit():
        jres = JL.solve(JJ.build_problem(jnp.asarray(poses), _jax_table(tab)),
                        jnp.asarray(poses), JL.LMConfig(max_iterations=iters),
                        linear_solver=jrec, use_soa=use_soa)
        jres = jax.tree_util.tree_map(np.asarray, jres)
    trec = _Recorder(TT.bcr_solve, n)
    config = TL.LMConfig(max_iterations=iters)
    tres = TL.solve(TJ.build_problem(t(poses), table_from_numpy(tab, "cpu")),
                    t(poses), config, linear_solver=trec, use_soa=use_soa)
    t_acc = trec.accepts(poses, n(tres.poses))
    j_acc = jrec.accepts(poses, jres.poses)
    if int(tres.iterations) != int(jres.iterations) or t_acc != j_acc:
        # Allowed only as a boundary case: at the first step where the
        # packages decide differently, the step's TRUE (f64) relative cost
        # change is below the function tolerance, i.e. below what the two
        # f32 cost sums (summed in different orders) can resolve, so the
        # accept test rho > 0 and the termination tests decide on rounding.
        k = next((i for i, (a, b) in enumerate(zip(t_acc, j_acc)) if a != b),
                 min(len(t_acc), len(j_acc)))
        rel = _true_relative_change(poses, tab, t_acc[:k], trec.steps[:k + 1])
        assert rel <= config.function_tolerance, (kind, k, rel, t_acc, j_acc)
        # the two results may then differ by that (noise-level) step
        pose_atol = 1e-4 + float(np.abs(trec.steps[k]).max())
    else:
        assert bool(tres.converged) == bool(jres.converged)
        pose_atol = 1e-4
    # costs are sums of ~100 f32 squares; relative agreement to ~1e-5,
    # with an absolute floor for the near-zero optimum of "noop"
    np.testing.assert_allclose(float(tres.final_cost), float(jres.final_cost),
                               rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(float(tres.initial_cost),
                               float(jres.initial_cost), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(n(tres.poses), jres.poses, atol=pose_atol)


def test_lm_mu_warm_start_clip():
    """mu0 is clipped into [1e-6, 1e-1], as in the reference."""
    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.solver import joint as TJ, lm as TL

    poses, row, _ = _lm_problem("pulls", seed=5)
    prob = TJ.build_problem(t(poses), table_from_numpy(_one_row_table(row),
                                                       "cpu"))
    seen = []

    def rec(D, U, b):
        seen.append(D)
        return TL._default_linear_solver("cpu")(D, U, b)

    D0 = TL.normal_equations_soa(prob, TL.soa_constants(prob), t(poses))[0]
    for mu0, want in ((1e3, 1e-1), (1e-12, 1e-6)):
        seen.clear()
        TL.solve(prob, t(poses), TL.LMConfig(max_iterations=1),
                 linear_solver=rec, mu0=torch.tensor(mu0))
        diag = torch.clamp(torch.diagonal(D0, dim1=-2, dim2=-1), 1e-6, 1e32)
        got = torch.diagonal(seen[0], dim1=-2, dim2=-1) - torch.diagonal(
            D0, dim1=-2, dim2=-1)
        # D + mu*diag rounds at the f32 ulp of D (entries up to ~2e4), so
        # the recovered damping is good to a few ulps of max(diag)
        torch.testing.assert_close(got, torch.tensor(want, dtype=torch.float32)
                                   * diag, rtol=1e-4,
                                   atol=4 * 1.2e-7 * float(diag.max()))


# ------------------------------------------------------------ leftovers

@pytest.mark.parametrize("num", [1, 2, 31, 32, 33, 100])
def test_thomas_and_schur_match_jax(num):
    """thomas_solve and schur_solve(chunk=16) against the JAX functions and
    an f64 direct solve (below 2 * chunk poses schur_solve is bcr_solve)."""
    from hitl_slam_torch.solver import tridiag as TT
    from hitl_slam_tpu.solver import tridiag as JT

    D, U, b = (a.astype(np.float32) for a in
               random_spd_tridiag(np.random.default_rng(100 + num), num))
    x64 = banded_solve_f64(*(a.astype(np.float64) for a in (D, U, b)))
    scale = max(1.0, float(np.abs(x64).max()))
    for tf, jf in ((TT.thomas_solve, JT.thomas_solve),
                   (TT.schur_solve, JT.schur_solve)):
        got = n(tf(t(D), t(U), t(b)))
        ref = np.asarray(jf(jnp.asarray(D), jnp.asarray(U), jnp.asarray(b)))
        # f32 eliminations of systems with cond(H) < ~20: within ~1e-6 of
        # f64 each; 1e-5 leaves an order of magnitude
        assert np.abs(got - ref).max() <= 1e-5 * scale, tf.__name__
        assert np.abs(got - x64).max() <= 1e-5 * scale, tf.__name__


def test_normal_equations_aos_matches_jax_and_soa():
    """joint.normal_equations (the block-array assembly) against the JAX
    function and the port's own SoA assembly, at the build poses and off
    them; build_problem(use_onehot=False) reduces the table by the
    scatter-add to the same compact terms."""
    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.solver import assembly_soa as TS, joint as TJ
    from hitl_slam_tpu.solver import joint as JJ

    jp, tp, poses, poses1 = _problem_pair(seed=9)
    sc = TS.soa_constants(tp)
    for p in (poses, poses1):
        got = TJ.normal_equations(tp, t(p))
        ref = JJ.normal_equations(jp, jnp.asarray(p))
        soa = TS.normal_equations_soa(tp, sc, t(p))
        for i, name in enumerate(("D", "U", "g", "cost")):
            scale = max(1.0, float(np.abs(np.asarray(ref[i])).max()))
            # entries reach 1/sigma^2 = 1e4: f32 reassociation and ~1 ulp
            # trig differences stay below 1e-5 of the largest entry
            for want in (np.asarray(ref[i]), n(soa[i])):
                np.testing.assert_allclose(n(got[i]), want, rtol=1e-5,
                                           atol=1e-5 * scale, err_msg=name)
    rng = np.random.default_rng(9)          # _problem_pair's draws
    _chain(rng, 40)
    tab = _table_arrays(rng, 32, 40, 18)
    scat = TJ.build_problem(t(poses), table_from_numpy(tab, "cpu"),
                            use_onehot=False)
    assert scat.num_poses == tp.num_poses
    np.testing.assert_allclose(n(scat.compact.A), n(tp.compact.A),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("kind", ["pulls", "COLINEAR", "PARALLEL"])
def test_lm_aos_parity(kind):
    """lm.solve(use_soa=False), the block-array assembly, against the JAX
    solve(use_soa=False) on the tests/test_lm.py problems, as
    test_lm_parity holds the SoA solves."""
    _lm_parity(kind, use_soa=False)


def test_relative_pose_factors_match_jax():
    """The relative-pose parameterization: chain_poses, the factor
    constants (a degenerate pair included), perp_rows, the residuals, and
    the chain Jacobian by torch.func.jacrev against jax.jacfwd."""
    from hitl_slam_torch.ops import residuals as TR
    from hitl_slam_tpu.ops import residuals as JR

    rng = np.random.default_rng(4)
    base = np.array([0.5, -0.2, 0.3], np.float32)
    rels = rng.normal(0, 0.3, (15, 3)).astype(np.float32)
    rels[7, :2] = 0.0                                   # a still step
    pose0 = np.array([0, 3, 7, 2, 10], np.int32)
    pose1 = np.array([1, 9, 8, 14, 15], np.int32)
    j_poses = JR.chain_poses(jnp.asarray(base), jnp.asarray(rels))
    t_poses = TR.chain_poses(t(base), t(rels))
    np.testing.assert_allclose(n(t_poses), np.asarray(j_poses), atol=1e-6)
    jf = JR.build_relative_pose_factors(j_poses, jnp.asarray(pose0),
                                        jnp.asarray(pose1))
    tf = TR.build_relative_pose_factors(t_poses, t(pose0), t(pose1))
    for name in ("axis", "radial", "rotation", "inv_sigma"):
        np.testing.assert_allclose(n(getattr(tf, name)),
                                   np.asarray(getattr(jf, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    v = rng.normal(size=(6, 2)).astype(np.float32)
    assert np.array_equal(n(TR.perp_rows(t(v))),
                          np.asarray(JR.perp_rows(jnp.asarray(v))))
    rels1 = (rels + rng.normal(0, 0.02, rels.shape)).astype(np.float32)
    got = TR.relative_pose_residuals(tf, t(base), t(rels1))
    ref = JR.relative_pose_residuals(jf, jnp.asarray(base), jnp.asarray(rels1))
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=1e-4, atol=1e-4)
    jac = torch.func.jacrev(
        lambda r: TR.relative_pose_residuals(tf, t(base), r))(t(rels1))
    jref = jax.jacfwd(
        lambda r: JR.relative_pose_residuals(jf, jnp.asarray(base), r))(
        jnp.asarray(rels1))
    # entries reach 1/sigma = 100 per metre of lever arm
    scale = float(np.abs(np.asarray(jref)).max())
    np.testing.assert_allclose(n(jac), np.asarray(jref), rtol=1e-4,
                               atol=1e-5 * scale)


# ------------------------------------------------------------ repair_step

def test_repair_step_eager_matches_jax():
    """repair_step(eager=True), the code its program captures, on the
    64-pose golden map's first logged correction (refit and counts by the
    JAX package, ordering by order_and_filter), against the JAX package's
    jitted repair_step with LMConfig(max_iterations=20): integers exact,
    poses to 1e-4, costs to 1e-5 relative above an absolute floor of 1e-8
    (the step starts at its optimum: its costs are ~1e-9, f32 round-off
    of the two packages' sums)."""
    import os

    from test_torch_cycle import _check_table, _repair_args

    from hitl_slam_torch.core.state import make_map_state as tmake
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.models.hitl import em_input as TE
    from hitl_slam_torch.models.hitl.repair import repair_step
    from hitl_slam_torch.solver.lm import LMConfig as TCfg
    from hitl_slam_tpu.core.state import make_map_state
    from hitl_slam_tpu.models.hitl import em_input as JE
    from hitl_slam_tpu.models.hitl.repair import repair_step as jrepair
    from hitl_slam_tpu.solver.lm import LMConfig as JCfg
    from torch_port_helpers import np_fields

    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    data = stfs.load_stfs_covars(os.path.join(data_dir, "golden.stfs.covars"))
    entry = logs.load_log(os.path.join(data_dir, "golden.log"))[0]
    assert len(data.poses) == 64
    jst = make_map_state(data.poses, data.covariances, data.point_clouds,
                         data.normal_clouds, constraint_capacity=256)
    tst = tmake(data.poses, data.covariances, data.point_clouds,
                data.normal_clouds, constraint_capacity=256, device="cpu")
    world = jnp.asarray(jst.world_points())
    mask = jnp.asarray(jst.point_mask)
    raw = np.asarray(entry.points, np.float32)
    refit = np.asarray(JE.endpoint_adjust_batch(
        world, mask, jnp.asarray(np.stack([raw[0:2], raw[2:4]])))
    ).reshape(4, 2)
    c1, c2 = (np.asarray(c) for c in JE.observation_counts(
        world, mask, jnp.asarray(refit)))
    o = TE.order_and_filter(c1, c2, refit)
    group, last, anch, corr = _repair_args(o)
    gmask = np.zeros(len(data.poses), bool)
    gmask[group] = True
    ctype = int(entry.correction_type)
    sel = o.selected_points.astype(np.float32)
    offset = 3
    got = repair_step(tst.poses, tst.covariances, tst.constraints, ctype,
                      t(sel), t(gmask), last, t(anch), t(corr),
                      o.backprop_start, o.backprop_end, offset,
                      lm_config=TCfg(max_iterations=20), eager=True)
    i32 = lambda v: jnp.asarray(v, jnp.int32)   # noqa: E731
    ref = jrepair(jst.poses, jst.covariances, jst.constraints, i32(ctype),
                  jnp.asarray(sel), jnp.asarray(gmask), i32(last),
                  jnp.asarray(anch), jnp.asarray(corr),
                  i32(o.backprop_start), i32(o.backprop_end), i32(offset),
                  lm_config=JCfg(max_iterations=20))
    assert int(got.num_new_constraints) == int(ref.num_new_constraints) > 0
    assert int(got.lm.iterations) == int(ref.lm.iterations)
    assert bool(got.lm.converged) == bool(ref.lm.converged)
    for k in ("pre_solve_poses", "poses"):
        np.testing.assert_allclose(n(getattr(got, k)),
                                   np.asarray(getattr(ref, k)), atol=1e-4,
                                   err_msg=k)
    for k in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(got.lm, k)),
                                   float(getattr(ref.lm, k)), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    _check_table(got.constraints, np_fields(ref.constraints))
