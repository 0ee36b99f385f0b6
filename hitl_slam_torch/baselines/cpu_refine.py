"""CPU reference solver for the post-human STF refinement stage.

Host copy of hitl_slam_tpu/baselines/cpu_refine.py (numpy and scipy only;
it launches nothing): the f64 oracle of the refine, over the same factor
graph (odometry chain + compact human factors + STF pair factors), with
vectorized NumPy residual/Jacobian passes (no Python per-factor loops),
dense normal equations factored by LAPACK Cholesky (scipy cho_factor —
what Ceres's DENSE_NORMAL_CHOLESKY does on this problem) and
Madsen-Nielsen-Tingleff LM damping.

Chain/human factor math is imported from baselines.cpu_lm (the joint-solve
baseline); the STF residuals mirror ops/correspond.py stf_residuals /
stf_jacobians in f64.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import cho_factor, cho_solve

from .cpu_lm import (build_human_factors_np, build_odometry_factors_np,
                     odometry_residuals_jacobians_np)


def stf_residuals_jacobians_np(stf: dict, poses: np.ndarray):
    """f64 mirror of ops/correspond.py stf_residuals/stf_jacobians:
    returns (r [C,2], J0 [C,2,3], J1 [C,2,3]) with invalid rows zeroed."""
    i0 = stf["pose0"]
    i1 = stf["pose1"]
    q0, q1 = poses[i0], poses[i1]
    c0, s0 = np.cos(q0[:, 2]), np.sin(q0[:, 2])
    c1, s1 = np.cos(q1[:, 2]), np.sin(q1[:, 2])

    def rot(c, s, v):
        return np.stack([c * v[:, 0] - s * v[:, 1],
                         s * v[:, 0] + c * v[:, 1]], -1)

    r0p = rot(c0, s0, stf["p0"])
    r1p = rot(c1, s1, stf["p1"])
    p0w = r0p + q0[:, :2]
    p1w = r1p + q1[:, :2]
    n0w = rot(c0, s0, stf["n0"])
    n1w = rot(c1, s1, stf["n1"])
    dp = p1w - p0w
    w = stf["weight"]
    r = np.stack([np.sum(n0w * dp, -1), np.sum(n1w * dp, -1)], -1) * w[:, None]

    def perp(v):
        return np.stack([-v[:, 1], v[:, 0]], -1)

    dp0 = perp(r0p)
    dp1 = perp(r1p)
    dn0 = perp(n0w)
    dn1 = perp(n1w)
    r0_th0 = w * (np.sum(dn0 * dp, -1) - np.sum(n0w * dp0, -1))
    r0_th1 = w * np.sum(n0w * dp1, -1)
    r1_th0 = -w * np.sum(n1w * dp0, -1)
    r1_th1 = w * (np.sum(dn1 * dp, -1) + np.sum(n1w * dp1, -1))
    wn0 = w[:, None] * n0w
    wn1 = w[:, None] * n1w
    J0 = np.stack([
        np.concatenate([-wn0, r0_th0[:, None]], -1),
        np.concatenate([-wn1, r1_th0[:, None]], -1),
    ], axis=1)
    J1 = np.stack([
        np.concatenate([wn0, r0_th1[:, None]], -1),
        np.concatenate([wn1, r1_th1[:, None]], -1),
    ], axis=1)
    v = stf["valid"].astype(bool)
    r[~v] = 0.0
    J0[~v] = 0.0
    J1[~v] = 0.0
    return r, J0, J1


def cpu_refine_solve(
    poses0: np.ndarray,
    table: dict,
    stf: dict,
    max_iterations: int = 30,
    function_tolerance: float = 1e-6,
    inv_sigma=(1.0 / 0.03, 1.0 / 0.03, 1.0 / 0.01),
):
    """Dense LM over chain + human + STF factors; returns
    (poses, final_cost, iterations)."""
    poses = poses0.astype(np.float64).copy()
    P = len(poses)
    n = 3 * P
    axis, d, rot_t = build_odometry_factors_np(poses)
    hidx, hM, htarget = build_human_factors_np(poses, table)
    i0 = stf["pose0"]
    i1 = stf["pose1"]

    def cost_res(p):
        r_o, J1o, J2o = odometry_residuals_jacobians_np(
            axis, d, rot_t, p, inv_sigma)
        r_h = np.einsum("cij,cj->ci", hM, htarget - p[hidx])
        r_s, J0s, J1s = stf_residuals_jacobians_np(stf, p)
        c = 0.5 * (np.sum(r_o**2) + np.sum(r_h**2) + np.sum(r_s**2))
        return c, (r_o, J1o, J2o), (r_h,), (r_s, J0s, J1s)

    def assemble(p):
        c, (r_o, J1o, J2o), (r_h,), (r_s, J0s, J1s) = cost_res(p)
        H = np.zeros((n, n))
        g = np.zeros((P, 3))
        # chain blocks
        J1T, J2T = np.swapaxes(J1o, -1, -2), np.swapaxes(J2o, -1, -2)
        ii = np.arange(P - 1)
        blk = lambda i, j, B: np.add.at(  # noqa: E731
            H, (3 * i[:, None, None] + np.arange(3)[None, :, None],
                3 * j[:, None, None] + np.arange(3)[None, None, :]), B)
        blk(ii, ii, J1T @ J1o)
        blk(ii + 1, ii + 1, J2T @ J2o)
        blk(ii, ii + 1, J1T @ J2o)
        blk(ii + 1, ii, J2T @ J1o)
        g[:-1] += np.einsum("fij,fj->fi", J1T, r_o)
        g[1:] += np.einsum("fij,fj->fi", J2T, r_o)
        # human (unary, J = -M)
        JhT = np.swapaxes(hM, -1, -2)
        blk(hidx, hidx, JhT @ hM)
        np.add.at(g, hidx, -np.einsum("cij,cj->ci", JhT, r_h))
        # STF pair blocks
        J0T, J1sT = np.swapaxes(J0s, -1, -2), np.swapaxes(J1s, -1, -2)
        blk(i0, i0, J0T @ J0s)
        blk(i1, i1, J1sT @ J1s)
        blk(i0, i1, J0T @ J1s)
        blk(i1, i0, J1sT @ J0s)
        np.add.at(g, i0, np.einsum("cij,cj->ci", J0T, r_s))
        np.add.at(g, i1, np.einsum("cij,cj->ci", J1sT, r_s))
        # gauge: pin pose 0
        H[:3, :] = 0.0
        H[:, :3] = 0.0
        H[:3, :3] = np.eye(3)
        g[0] = 0.0
        return c, H, g.reshape(n)

    mu, nu = 1e-4, 2.0
    c, H, g = assemble(poses)
    it = 0
    while it < max_iterations:
        it += 1
        diag = np.clip(np.diag(H), 1e-6, 1e32)
        Hd = H + mu * np.diag(diag)
        try:
            step = cho_solve(cho_factor(Hd, lower=True), -g)
        except np.linalg.LinAlgError:
            mu *= nu
            nu *= 2
            continue
        trial = poses + step.reshape(P, 3)
        c_new = cost_res(trial)[0]
        pred = 0.5 * np.sum(step * (mu * diag * step - g))
        rho = (c - c_new) / max(pred, 1e-30)
        if rho > 0 and np.isfinite(c_new):
            converged = abs(c - c_new) <= function_tolerance * c
            poses = trial
            c, H, g = assemble(poses)
            mu *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            if converged:
                break
        else:
            mu *= nu
            nu *= 2
            if mu >= 1e10:
                break
    return poses, c, it


def _host(a, dtype=None) -> np.ndarray:
    """A numpy copy of an array or of a tensor on any device."""
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a, dtype)


def stf_to_numpy(stf) -> dict:
    """Convert an ops.correspond.STFFactors (of tensors, on any device) to
    the dict this module consumes (f64)."""
    return dict(
        pose0=_host(stf.pose0), pose1=_host(stf.pose1),
        p0=_host(stf.p0, np.float64), p1=_host(stf.p1, np.float64),
        n0=_host(stf.n0, np.float64), n1=_host(stf.n1, np.float64),
        weight=_host(stf.weight, np.float64),
        valid=_host(stf.valid),
    )
