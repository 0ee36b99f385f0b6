"""CPU reference solver: the f64 oracle of the joint solve.

Host copy of hitl_slam_tpu/baselines/cpu_lm.py (numpy and scipy only; it
launches nothing). It is a faithful CPU implementation of the reference
system's joint solve (Ceres LM + sparse Cholesky over the odometry-chain +
unary-human-factor graph, JointOptimization.cpp:1064-1138):

  - identical factor semantics (same residuals/Jacobians as ops/residuals.py,
    re-expressed in vectorized NumPy, f64 like Ceres),
  - Madsen-Nielsen-Tingleff LM damping (what Ceres's LEVENBERG_MARQUARDT
    strategy implements),
  - scipy.linalg.solveh_banded (LAPACK pbsv) for the banded normal equations
    — C-speed sparse Cholesky, the moral equivalent of Ceres+SuiteSparse on
    a block-tridiagonal problem.

No Python-level per-pose loops: this is an optimized CPU baseline.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import solveh_banded


def _angle_mod(a):
    return np.arctan2(np.sin(a), np.cos(a))


def build_odometry_factors_np(poses: np.ndarray):
    p0, p1 = poses[:-1], poses[1:]
    trans = p1[:, :2] - p0[:, :2]
    norm = np.linalg.norm(trans, axis=-1)
    degenerate = (np.abs(trans[:, 0]) < 1e-6) & (np.abs(trans[:, 1]) < 1e-6)
    c, s = np.cos(-p0[:, 2]), np.sin(-p0[:, 2])
    local = np.stack([c * trans[:, 0] - s * trans[:, 1],
                      s * trans[:, 0] + c * trans[:, 1]], -1)
    radial = local / np.maximum(norm, 1e-6)[:, None]
    still = np.stack([np.cos(p1[:, 2]), np.sin(p1[:, 2])], -1)
    radial = np.where(degenerate[:, None], still, radial)
    tang = np.stack([-radial[:, 1], radial[:, 0]], -1)
    axis = np.stack([radial, tang], axis=-2)
    d = np.where(degenerate, 0.0, norm)
    rot = _angle_mod(p1[:, 2] - p0[:, 2])
    return axis, d, rot


def odometry_residuals_jacobians_np(axis, d, rot, poses, inv_sigma):
    p0, p1 = poses[:-1], poses[1:]
    dt = p1[:, :2] - p0[:, :2]
    c, s = np.cos(-p0[:, 2]), np.sin(-p0[:, 2])
    Rn = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    v = np.einsum("fij,fj->fi", Rn, dt)
    u = np.einsum("fij,fj->fi", axis, v)
    r = np.stack([
        (u[:, 0] - d) * inv_sigma[0],
        u[:, 1] * inv_sigma[1],
        _angle_mod(p1[:, 2] - p0[:, 2] - rot) * inv_sigma[2],
    ], -1)
    B = axis * np.array(inv_sigma[:2])[None, :, None]
    ARot = np.einsum("fij,fjk->fik", B, Rn)
    dv = np.stack([v[:, 1], -v[:, 0]], -1)
    du = np.einsum("fij,fj->fi", B, dv)
    F = len(d)
    J1 = np.zeros((F, 3, 3))
    J2 = np.zeros((F, 3, 3))
    J1[:, :2, :2] = -ARot
    J1[:, :2, 2] = du
    J1[:, 2, 2] = -inv_sigma[2]
    J2[:, :2, :2] = ARot
    J2[:, 2, 2] = inv_sigma[2]
    return r, J1, J2


def build_human_factors_np(poses, table):
    """table: dict of numpy arrays (ctype, constrained, anchor, dpar, dperp,
    dth, pen, active). Returns (idx, M, target) for active rows."""
    act = table["active"].astype(bool)
    ct = table["ctype"][act]
    con = table["constrained"][act]
    anc = table["anchor"][act]
    a = poses[anc]
    ath = a[:, 2]
    para = np.stack([np.cos(ath), np.sin(ath)], -1)
    perp = np.stack([-para[:, 1], para[:, 0]], -1)
    tloc = (a[:, :2] + table["dpar"][act, None] * para
            + table["dperp"][act, None] * perp)
    tth = _angle_mod(ath + table["dth"][act])
    target = np.concatenate([tloc, tth[:, None]], -1)
    pd = ath + table["pen"][act]
    n = len(ct)
    M = np.zeros((n, 3, 3))
    # mirror ops/residuals.py build_human_factors exactly: CORNER (3)
    # constrains the full pose like colocation (2); POINT (1) constrains
    # position only
    coloc = (ct == 2) | (ct == 3)
    point = ct == 1
    colin = ct == 4
    ang = (ct == 5) | (ct == 6)
    M[coloc] = np.eye(3)
    M[point, 0, 0] = 1.0
    M[point, 1, 1] = 1.0
    M[colin, 0, 0] = np.cos(pd[colin])
    M[colin, 0, 1] = np.sin(pd[colin])
    M[colin, 1, 2] = 1.0
    M[ang, 0, 2] = 1.0
    return con, M, target


def _assemble_banded(D, U):
    """Pack block-tridiag (D [P,3,3], U [P-1,3,3]) into LAPACK upper-banded
    storage ab[6, 3P] (bandwidth 5) — vectorized."""
    P = D.shape[0]
    n = 3 * P
    ab = np.zeros((6, n))
    # within-diagonal-block entries: H[3i+a, 3i+b] for b>=a
    for a in range(3):
        for b in range(a, 3):
            col = np.arange(P) * 3 + b
            ab[5 - (b - a), col] = D[:, a, b]
    # off-block entries: H[3i+a, 3(i+1)+b] = U[i, a, b], band = 3 + b - a
    for a in range(3):
        for b in range(3):
            band = 3 + b - a
            col = np.arange(P - 1) * 3 + 3 + b
            ab[5 - band, col] = U[:, a, b]
    return ab


def cpu_lm_solve(
    poses0: np.ndarray,
    table: dict,
    max_iterations: int = 100,
    function_tolerance: float = 1e-6,
    inv_sigma=(1.0 / 0.03, 1.0 / 0.03, 1.0 / 0.01),
):
    """Full LM solve; returns (poses, final_cost, iterations)."""
    poses = poses0.astype(np.float64).copy()
    axis, d, rot = build_odometry_factors_np(poses)
    hidx, hM, htarget = build_human_factors_np(poses, table)
    P = len(poses)

    def cost_res(p):
        r_o, J1, J2 = odometry_residuals_jacobians_np(axis, d, rot, p, inv_sigma)
        r_h = np.einsum("cij,cj->ci", hM, htarget - p[hidx])
        c = 0.5 * (np.sum(r_o**2) + np.sum(r_h**2))
        return c, r_o, J1, J2, r_h

    def assemble(p):
        c, r_o, J1, J2, r_h = cost_res(p)
        D = np.zeros((P, 3, 3))
        U = np.zeros((P - 1, 3, 3))
        g = np.zeros((P, 3))
        J1T = np.swapaxes(J1, -1, -2)
        J2T = np.swapaxes(J2, -1, -2)
        # unique contiguous indices: plain slice adds, ~10x faster than the
        # unbuffered np.add.at (this is the measured CPU-baseline
        # denominator — it must be honestly fast)
        D[: P - 1] += J1T @ J1
        D[1:] += J2T @ J2
        U[:] = J1T @ J2
        g[: P - 1] += np.einsum("fij,fj->fi", J1T, r_o)
        g[1:] += np.einsum("fij,fj->fi", J2T, r_o)
        JhT = np.swapaxes(hM, -1, -2)  # J = -M, JT r = -MT r
        np.add.at(D, hidx, JhT @ hM)
        np.add.at(g, hidx, -np.einsum("cij,cj->ci", JhT, r_h))
        D[0] = np.eye(3)
        U[0] = 0.0
        g[0] = 0.0
        return c, D, U, g

    mu, nu = 1e-4, 2.0
    c, D, U, g = assemble(poses)
    it = 0
    while it < max_iterations:
        it += 1
        diag = np.clip(np.einsum("pii->pi", D), 1e-6, 1e32)
        Dd = D.copy()
        Dd[:, [0, 1, 2], [0, 1, 2]] += mu * diag
        ab = _assemble_banded(Dd, U)
        try:
            step = solveh_banded(ab, -g.reshape(-1)).reshape(P, 3)
        except np.linalg.LinAlgError:
            mu *= nu
            nu *= 2
            continue
        trial = poses + step
        c_new = cost_res(trial)[0]
        pred = 0.5 * np.sum(step * (mu * diag * step - g))
        rho = (c - c_new) / max(pred, 1e-30)
        # termination semantics mirror solver/lm.py exactly (DEVIATIONS #22):
        # relative function decrease on accepted steps; relative step size
        # on EVERY iteration (rejected steps included — a rejected tiny step
        # means the damped system already moves x by noise); trust-region
        # collapse. Same parameter_tolerance (1e-7) as LMConfig.
        ptol = 1e-7
        if rho > 0 and np.isfinite(c_new):
            converged = abs(c - c_new) <= function_tolerance * c
            poses = trial
            c, D, U, g = assemble(poses)
            mu *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            step_small = np.linalg.norm(step) <= ptol * (
                np.linalg.norm(poses) + ptol
            )
            if converged or step_small:
                break
        else:
            mu *= nu
            nu *= 2
            step_small = np.linalg.norm(step) <= ptol * (
                np.linalg.norm(poses) + ptol
            )
            if step_small or mu >= 1e10:
                break
    return poses, c, it


def scipy_generic_solve(poses0: np.ndarray, table: dict,
                        max_nfev: int | None = None):
    """Generic-NLLS CPU baseline: scipy.optimize.least_squares (TRF) with
    finite-difference Jacobians over a banded+constraint sparsity pattern.

    This is the closer stand-in for the reference's actual solver stack —
    Ceres autodiff jets + general sparse machinery — whereas cpu_lm_solve is
    a hand-specialized best-case CPU implementation. Returns
    (poses, cost, wall_seconds).
    """
    import time

    from scipy.optimize import least_squares
    from scipy.sparse import lil_matrix

    poses0 = poses0.astype(np.float64)
    P = len(poses0)
    axis, d, rot = build_odometry_factors_np(poses0)
    hidx, hM, htarget = build_human_factors_np(poses0, table)
    inv_sigma = (1.0 / 0.03, 1.0 / 0.03, 1.0 / 0.01)
    x0 = poses0.reshape(-1)

    def residuals(x):
        p = x.reshape(P, 3)
        p = p.copy()
        p[0] = poses0[0]  # gauge
        r_o, _, _ = odometry_residuals_jacobians_np(axis, d, rot, p, inv_sigma)
        r_h = np.einsum("cij,cj->ci", hM, htarget - p[hidx])
        return np.concatenate([r_o.reshape(-1), r_h.reshape(-1)])

    n_res = 3 * (P - 1) + 3 * len(hidx)
    S = lil_matrix((n_res, 3 * P), dtype=np.int8)
    for i in range(P - 1):
        S[3 * i : 3 * i + 3, 3 * i : 3 * i + 6] = 1
    base = 3 * (P - 1)
    for k, c in enumerate(hidx):
        S[base + 3 * k : base + 3 * k + 3, 3 * c : 3 * c + 3] = 1

    t0 = time.perf_counter()
    out = least_squares(residuals, x0, method="trf", jac_sparsity=S,
                        xtol=1e-8, ftol=1e-6, max_nfev=max_nfev)
    wall = time.perf_counter() - t0
    return out.x.reshape(P, 3), 0.5 * float(np.sum(out.fun**2)), wall
