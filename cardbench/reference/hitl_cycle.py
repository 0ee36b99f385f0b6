"""Plain reference of one HitL correction cycle, in NumPy.

The cycle's semantics as HitL-SLAM states them (arXiv:1711.08566) and the
port's engine documents them: verify the four clicks against the map, refit
both sketched segments by EM, count each pose's inliers, order the two pose
sets, apply the explicit rigid correction, write the human constraint rows,
back-propagate the correction over the open window, and re-solve the joint
pose graph by Levenberg-Marquardt. Every step is written out here in
float64 (or, for the control, with each stored array rounded to TF32;
reference/precision.py); it shares no code with the program.

The LM is the f64 oracle of hitl_slam_torch/baselines/cpu_lm.py at commit
455be22 (`cpu_lm_solve` and its factor builders), copied and given the
precision hook; its damping and exit tests are those of the program's
LMConfig defaults.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.linalg import solveh_banded

from .precision import F64, Precision

VERIFY_THRESHOLD = 0.05     # m: a click must lie this near a map point
INLIER_THRESHOLD = 0.03     # m: a point this near a refit segment is an inlier
ENDPOINT_STABLE = 0.05      # m: EM stops once no endpoint moves more
SEGFIT_ITERS = 25
MAX_ADJUST_ROUNDS = 32
MIN_POSE_INLIERS = 5        # a pose takes part with more inliers than this
MAX_ANCHORS = 64
MAX_CORRECTED = 64
DEST_ROT_VARIANCE = 1e-4
DEST_TRANS_VARIANCE = 1e-3
ODOM_INV_SIGMA = (1.0 / 0.03, 1.0 / 0.03, 1.0 / 0.01)
POINT, LINE_SEGMENT, CORNER, COLINEAR, PERPENDICULAR, PARALLEL = 1, 2, 3, 4, 5, 6


def angle_mod(a):
    return np.arctan2(np.sin(a), np.cos(a))


def rotate(theta, v):
    c, s = np.cos(theta), np.sin(theta)
    return np.stack([c * v[..., 0] - s * v[..., 1],
                     s * v[..., 0] + c * v[..., 1]], -1)


def world_points(poses, points):
    """[P, N, 2] robot-frame points in the world frame."""
    return rotate(poses[:, None, 2], points) + poses[:, None, :2]


def dist_to_segment(p1, p2, p):
    d = p2 - p1
    denom = max(float(d @ d), 1e-20)
    t = np.clip(((p - p1) @ d) / denom, 0.0, 1.0)
    e = p - (p1 + t[..., None] * d)
    return np.sqrt(np.sum(e * e, -1))


# -- verification and EM refit ----------------------------------------------

def verify(flat, ctype, sel) -> bool:
    """Every click within VERIFY_THRESHOLD of a map point; a non-point
    correction also needs two non-degenerate strokes."""
    near = all(float(np.min(np.sum((flat - c) ** 2, -1)))
               < VERIFY_THRESHOLD ** 2 for c in sel)
    if ctype == POINT:
        return near
    degenerate = (np.all(sel[0] == sel[1]) or np.all(sel[2] == sel[3]))
    return near and not degenerate


def _segfit_theta(rel, half_len, theta):
    """Newton steps on the orientation of a segment of fixed centre and
    half length `half_len` that minimise the summed squared distance of the
    inliers `rel` (relative to the centre) to it."""
    for _ in range(SEGFIT_ITERS):
        c, s = math.cos(theta), math.sin(theta)
        t = rel[:, 0] * c + rel[:, 1] * s
        perp = rel[:, 1] * c - rel[:, 0] * s
        tc = np.clip(t, -half_len, half_len)
        num = float(np.sum(-perp * tc))
        den = float(np.sum(np.abs(t * tc)))
        theta = theta - num / max(den, 1e-9)
    return theta


def refit(flat, seg, prec: Precision = F64):
    """EM refit of one stroke [2, 2]: gather the points within
    INLIER_THRESHOLD, refit the orientation about the fixed midpoint, until
    neither endpoint moves more than ENDPOINT_STABLE."""
    s = prec.q(seg)
    for _ in range(MAX_ADJUST_ROUNDS):
        p1, p2 = s[0], s[1]
        w = dist_to_segment(p1, p2, flat) < INLIER_THRESHOLD
        cm = 0.5 * (p1 + p2)
        delta = p1 - p2
        half_len = 0.5 * float(np.hypot(delta[0], delta[1]))
        theta = _segfit_theta(flat[w] - cm, half_len,
                              math.atan2(delta[1], delta[0]))
        a = np.array([math.cos(theta), math.sin(theta)])
        new = prec.q(np.stack([cm + half_len * a, cm - half_len * a]))
        moved = max(float(np.hypot(*(new[0] - p1))),
                    float(np.hypot(*(new[1] - p2))))
        s = new
        if moved <= ENDPOINT_STABLE:
            break
    return s


def inlier_counts(world, mask, sel, band: float = 0.0):
    """[P, 2] inliers of each pose within INLIER_THRESHOLD + `band` of each
    stroke (squared distance against the squared threshold)."""
    out = []
    t2 = (INLIER_THRESHOLD + band) ** 2
    for a, b in ((sel[0], sel[1]), (sel[2], sel[3])):
        d = b - a
        denom = max(float(d @ d), 1e-20)
        t = np.clip(((world - a) @ d) / denom, 0.0, 1.0)
        e = world - (a + t[..., None] * d)
        d2 = np.sum(e * e, -1)
        out.append(np.sum((d2 < t2) & mask, 1))
    return np.stack(out, 1)


# -- ordering -----------------------------------------------------------------

def order(c1, c2, sel, min_inliers=MIN_POSE_INLIERS) -> dict:
    """The two pose sets of the strokes, overlap removed, the later set the
    corrected one (the strokes swapped where the first was drawn on the
    earlier poses), the open back-propagation window between them, the
    first contiguous run of corrected poses and its last pose."""
    P = len(c1)
    idx = np.arange(P)
    first, second = c1 > min_inliers, c2 > min_inliers
    overlap = first & second
    n_f, n_s, n_o = first.sum(), second.sum(), overlap.sum()
    complete = (n_o == n_f) and (n_o == n_s) and n_o > 0
    from_second = (n_o == n_f) and not complete
    from_first = (n_o == n_s) and not complete and not from_second
    both = n_o > 0 and not (complete or from_second or from_first)
    if from_first or both:
        first = first & ~overlap
    if from_second or both:
        second = second & ~overlap

    def lo(m):
        return int(idx[m].min()) if m.any() else P

    def hi(m):
        return int(idx[m].max()) if m.any() else -1

    f_min, f_max, s_min, s_max = lo(first), hi(first), lo(second), hi(second)
    first_corrected = f_min > s_max
    swapped = f_max < s_min and not first_corrected
    corrected = first if first_corrected else second
    anchors = second if first_corrected else first
    bp_min = s_max + 1 if first_corrected else f_max + 1
    bp_max = f_min - 1 if first_corrected else s_min - 1
    sel = np.concatenate([sel[2:4], sel[0:2]]) if swapped else sel
    valid = (not complete and first.any() and second.any()
             and (first_corrected or swapped) and bp_min >= 0 and bp_max >= 1)
    start = int(np.argmax(corrected))
    broken = ~corrected & (idx >= start)
    group = corrected & (np.cumsum(broken) == 0)
    return dict(valid=bool(valid), sel=sel, group=group, last_pose=hi(group),
                corrected_idx=idx[corrected][:MAX_CORRECTED],
                anchor_idx=idx[anchors][:MAX_ANCHORS],
                bp_min=bp_min, bp_max=bp_max)


# -- explicit correction, constraint rows, back-propagation --------------------

def _signed_angle(A, B):
    theta = math.acos(min(max(float(A @ B), -1.0), 1.0))
    return -theta if A[0] * B[1] - A[1] * B[0] < 0.0 else theta


def correction_transform(ctype, sel):
    """(theta, centre, target): corrected poses move as
    p' = target + R(theta) (p - centre)."""
    cmA, cmB = 0.5 * (sel[0] + sel[1]), 0.5 * (sel[2] + sel[3])
    A, B = sel[1] - sel[0], sel[3] - sel[2]
    A = A / max(float(np.hypot(*A)), 1e-12)
    B = B / max(float(np.hypot(*B)), 1e-12)
    th = _signed_angle(A, B)
    kind = min(max(int(ctype), 1), 6)
    if kind == POINT:
        return 0.0, sel[0], sel[2]
    if kind == LINE_SEGMENT:
        return th, cmA, cmB
    if kind == CORNER:
        return th, sel[0], sel[2]
    if kind == COLINEAR:
        return th, cmA, cmB + float((cmA - cmB) @ B) * B
    if kind == PERPENDICULAR:
        if abs(abs(th) - math.pi / 2) < 1e-7:
            return 0.0, cmA, cmA
        return (th - math.pi / 2 if th > 0 else th + math.pi / 2), cmA, cmA
    return th, cmA, cmA


def apply_explicit(poses, ctype, o):
    """The rigid correction on the first corrected run and every later
    pose; returns (poses, the run's first pose's correction [3])."""
    theta, centre, target = correction_transform(ctype, o["sel"])
    xy = poses[:, :2]
    T = target + rotate(theta, xy - centre) - xy
    P = len(poses)
    moved = o["group"] | (np.arange(P) > o["last_pose"])
    out = poses.copy()
    out[moved, :2] += T[moved]
    out[moved, 2] += theta
    first = int(np.argmax(o["group"]))
    return out, np.array([T[first, 0], T[first, 1], theta])


def constraint_rows(poses, ctype, o) -> dict:
    """One row for each (anchor, corrected) pair, anchor-major: the
    corrected pose's offset in the anchor's frame and the penalty direction
    of the anchor stroke."""
    sel = o["sel"]
    corr_angle = math.atan2(sel[3, 1] - sel[2, 1], sel[3, 0] - sel[2, 0])
    a, c = o["anchor_idx"], o["corrected_idx"]
    A, C = poses[a], poses[c]
    ath = A[:, 2]
    para = np.stack([np.cos(ath), np.sin(ath)], -1)
    perp = np.stack([-para[:, 1], para[:, 0]], -1)
    rel = C[None, :, :2] - A[:, None, :2]
    n = len(a) * len(c)
    return dict(
        ctype=np.full(n, int(ctype)),
        constrained=np.tile(c, len(a)),
        anchor=np.repeat(a, len(c)),
        delta_parallel=np.einsum("ak,ack->ac", para, rel).reshape(-1),
        delta_perpendicular=np.einsum("ak,ack->ac", perp, rel).reshape(-1),
        delta_angle=angle_mod(C[None, :, 2] - ath[:, None]).reshape(-1),
        penalty_dir=np.repeat(angle_mod(corr_angle - ath) + math.pi / 2,
                              len(c)),
    )


def backprop(poses, covs, corr, bp_min, bp_max):
    """Spread the correction over the poses bp_min..bp_max by their
    covariances (rotation by the heading variances, then translation by the
    mean position variances), rotating each later pose of the window about
    the ones before it."""
    if bp_min >= bp_max:
        return poses
    P = len(poses)
    idx = np.arange(P)
    win = (idx >= bp_min) & (idx <= bp_max)
    wmask = (idx >= bp_min) & (idx < bp_max)
    rot_s = covs[:, 2, 2]
    tr_s = 0.5 * (covs[:, 0, 0] + covs[:, 1, 1])
    w_rot = np.where(wmask, rot_s / (rot_s[win].sum() + DEST_ROT_VARIANCE), 0)
    w_tr = np.where(wmask, tr_s / (tr_s[win].sum() + DEST_TRANS_VARIANCE), 0)
    xy = poses[:, :2]
    dth = w_rot * corr[2]
    th_pre = np.cumsum(dth) - dth
    rp = rotate(th_pre, xy)
    b_inc = rp - rotate(dth, rp)
    new_xy = np.where(win[:, None], rp + np.cumsum(b_inc, 0) - b_inc, xy)
    new_th = np.where(win, poses[:, 2] + th_pre + dth, poses[:, 2])
    k = bp_max % P
    trans = xy[k] + corr[:2] - new_xy[k]
    dtr = w_tr[:, None] * trans[None]
    new_xy = np.where(win[:, None], new_xy + np.cumsum(dtr, 0) - dtr, new_xy)
    return np.concatenate([new_xy, new_th[:, None]], 1)


def _front_from(poses, covs, ctype, verified, strokes, counts, prec) -> dict:
    """The cycle after its inlier counts: order, explicit correction, rows
    (none where the cycle is rejected), back-propagation."""
    q = prec.q
    o = order(counts[:, 0], counts[:, 1], strokes,
              0 if ctype == POINT else MIN_POSE_INLIERS)
    valid = verified and o["valid"]
    poses1, corr = apply_explicit(poses, ctype, o)
    poses1, corr = q(poses1), q(corr)
    rows = constraint_rows(poses1, ctype, o)
    if not valid:
        rows = {k: v[:0] for k, v in rows.items()}
    rows = {k: (q(v) if v.dtype.kind == "f" else v) for k, v in rows.items()}
    pre = backprop(poses1, covs, corr, o["bp_min"], o["bp_max"])
    pre[:, 2] = angle_mod(pre[:, 2])
    return dict(verified=verified, order_valid=o["valid"], refit=o["sel"],
                rows=rows, pre_solve=q(pre))


def cycle_fronts(points, mask, poses, covs, ctype, clicks,
                 prec: Precision = F64, band: float = 0.0):
    """Everything of a cycle before its LM, from the state it starts from:
    verified, order_valid, the refit strokes, the new constraint rows and
    the poses handed to the LM.

    Yields the cycle as computed first. With `band` > 0 it then yields the
    cycle under each other outcome of the threshold tests that lie within
    `band` (m) of their threshold: a click's verification, and a pose's
    taking part (more than MIN_POSE_INLIERS inliers) where points within
    `band` of INLIER_THRESHOLD decide it. Such a test is within the
    rounding of a float32 program, whose decision is its own to make;
    every combination of up to 4 of them, or each alone where there are
    more."""
    q = prec.q
    poses, covs, clicks = q(poses), q(covs), q(clicks)
    world = q(world_points(poses, q(points)))
    flat = world[mask]
    ok = verify(flat, ctype, clicks)
    if ctype in (POINT, CORNER):
        strokes = clicks
    else:
        strokes = np.concatenate([refit(flat, clicks[0:2], prec),
                                  refit(flat, clicks[2:4], prec)])
    counts = inlier_counts(world, mask, strokes)
    yield _front_from(poses, covs, ctype, ok, strokes, counts, prec)
    if band <= 0.0:
        return
    gate = 0 if ctype == POINT else MIN_POSE_INLIERS
    lo = np.stack([counts, inlier_counts(world, mask, strokes, -band)]).min(0)
    hi = inlier_counts(world, mask, strokes, band)
    amb = list(zip(*np.nonzero((lo <= gate) & (hi > gate))))
    d2min = [float(np.min(np.sum((flat - c) ** 2, -1))) for c in clicks]
    oks = [ok]
    if any((VERIFY_THRESHOLD - band) ** 2 <= d < (VERIFY_THRESHOLD + band) ** 2
           for d in d2min):
        oks.append(not ok)
    if len(amb) <= 4:
        flips = [[a for j, a in enumerate(amb) if m >> j & 1]
                 for m in range(1 << len(amb))]
    else:
        flips = [[]] + [[a] for a in amb]
    for v in oks:
        for fl in flips:
            if v == ok and not fl:
                continue
            c = counts.copy()
            for p, k in fl:
                c[p, k] = gate if c[p, k] > gate else gate + 1
            yield _front_from(poses, covs, ctype, v, strokes, c, prec)


def cycle_front(points, mask, poses, covs, ctype, clicks,
                prec: Precision = F64) -> dict:
    """The cycle before its LM, as computed (cycle_fronts' first)."""
    return next(cycle_fronts(points, mask, poses, covs, ctype, clicks, prec))


# -- the joint LM (the f64 oracle, with the precision hook) ------------------

def _odometry_factors(poses):
    p0, p1 = poses[:-1], poses[1:]
    trans = p1[:, :2] - p0[:, :2]
    norm = np.linalg.norm(trans, axis=-1)
    degenerate = (np.abs(trans[:, 0]) < 1e-6) & (np.abs(trans[:, 1]) < 1e-6)
    local = rotate(-p0[:, 2], trans)
    radial = local / np.maximum(norm, 1e-6)[:, None]
    still = np.stack([np.cos(p1[:, 2]), np.sin(p1[:, 2])], -1)
    radial = np.where(degenerate[:, None], still, radial)
    tang = np.stack([-radial[:, 1], radial[:, 0]], -1)
    return (np.stack([radial, tang], axis=-2), np.where(degenerate, 0.0, norm),
            angle_mod(p1[:, 2] - p0[:, 2]))


def _odometry_terms(axis, d, rot, poses, isig):
    p0, p1 = poses[:-1], poses[1:]
    dt = p1[:, :2] - p0[:, :2]
    c, s = np.cos(-p0[:, 2]), np.sin(-p0[:, 2])
    Rn = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    v = np.einsum("fij,fj->fi", Rn, dt)
    u = np.einsum("fij,fj->fi", axis, v)
    r = np.stack([(u[:, 0] - d) * isig[0], u[:, 1] * isig[1],
                  angle_mod(p1[:, 2] - p0[:, 2] - rot) * isig[2]], -1)
    B = axis * np.array(isig[:2])[None, :, None]
    ARot = np.einsum("fij,fjk->fik", B, Rn)
    du = np.einsum("fij,fj->fi", B, np.stack([v[:, 1], -v[:, 0]], -1))
    F = len(d)
    J1, J2 = np.zeros((F, 3, 3)), np.zeros((F, 3, 3))
    J1[:, :2, :2] = -ARot
    J1[:, :2, 2] = du
    J1[:, 2, 2] = -isig[2]
    J2[:, :2, :2] = ARot
    J2[:, 2, 2] = isig[2]
    return r, J1, J2


def _human_factors(poses, table):
    """(pose index, selector M [C, 3, 3], target [C, 3]) of the active
    rows: colocation and corner constrain the whole pose, a point its
    position, colinear its offset along the penalty direction and its
    heading, perpendicular and parallel its heading."""
    act = table["active"].astype(bool)
    ct = table["ctype"][act]
    a = poses[table["anchor"][act]]
    ath = a[:, 2]
    para = np.stack([np.cos(ath), np.sin(ath)], -1)
    perp = np.stack([-para[:, 1], para[:, 0]], -1)
    tloc = (a[:, :2] + table["delta_parallel"][act, None] * para
            + table["delta_perpendicular"][act, None] * perp)
    tth = angle_mod(ath + table["delta_angle"][act])
    pd = ath + table["penalty_dir"][act]
    M = np.zeros((len(ct), 3, 3))
    coloc, point = (ct == 2) | (ct == 3), ct == 1
    colin, ang = ct == 4, (ct == 5) | (ct == 6)
    M[coloc] = np.eye(3)
    M[point, 0, 0] = M[point, 1, 1] = 1.0
    M[colin, 0, 0] = np.cos(pd[colin])
    M[colin, 0, 1] = np.sin(pd[colin])
    M[colin, 1, 2] = 1.0
    M[ang, 0, 2] = 1.0
    return table["constrained"][act], M, np.concatenate([tloc, tth[:, None]], -1)


def _banded(D, U):
    """Block-tridiagonal (D [P,3,3], U [P-1,3,3]) in LAPACK upper-banded
    storage [6, 3P]."""
    P = D.shape[0]
    ab = np.zeros((6, 3 * P))
    for a in range(3):
        for b in range(a, 3):
            ab[5 - (b - a), np.arange(P) * 3 + b] = D[:, a, b]
        for b in range(3):
            ab[5 - (3 + b - a), np.arange(P - 1) * 3 + 3 + b] = U[:, a, b]
    return ab


def joint_cost(poses0, table, poses, isig=ODOM_INV_SIGMA) -> float:
    """The joint cost at `poses` of the problem built at `poses0` (the
    odometry targets from `poses0`, the human rows of `table`)."""
    axis, d, rot = _odometry_factors(poses0)
    hidx, hM, htarget = _human_factors(poses0, table)
    r_o = _odometry_terms(axis, d, rot, poses, isig)[0]
    r_h = np.einsum("cij,cj->ci", hM, htarget - poses[hidx])
    return 0.5 * float(np.sum(r_o ** 2) + np.sum(r_h ** 2))


def lm_solve(poses0, table, prec: Precision = F64, max_iterations=100,
             function_tolerance=1e-6, parameter_tolerance=1e-7,
             initial_mu=1e-4, mu_collapse=1e10, isig=ODOM_INV_SIGMA) -> dict:
    """The joint LM over the odometry chain (targets from `poses0`) and the
    human rows, pose 0 held; Madsen-Nielsen-Tingleff damping on
    mu * clip(diag H); exit on the relative decrease of an accepted step, a
    relative step under `parameter_tolerance` (rejected steps too) or a
    collapsed trust region. Returns the poses (headings wrapped), the
    unwrapped iterate, the initial and final cost and the iterations."""
    q = prec.q
    poses = q(poses0)
    axis, d, rot = _odometry_factors(poses)
    hidx, hM, htarget = _human_factors(poses, table)
    hM, htarget = q(hM), q(htarget)
    P = len(poses)

    def cost_res(p):
        r_o, J1, J2 = _odometry_terms(axis, d, rot, p, isig)
        r_h = np.einsum("cij,cj->ci", hM, htarget - p[hidx])
        return 0.5 * (np.sum(r_o ** 2) + np.sum(r_h ** 2)), r_o, J1, J2, r_h

    def assemble(p):
        c, r_o, J1, J2, r_h = cost_res(p)
        r_o, J1, J2, r_h = q(r_o), q(J1), q(J2), q(r_h)
        D, U, g = np.zeros((P, 3, 3)), np.zeros((P - 1, 3, 3)), np.zeros((P, 3))
        J1T, J2T = np.swapaxes(J1, -1, -2), np.swapaxes(J2, -1, -2)
        D[:P - 1] += J1T @ J1
        D[1:] += J2T @ J2
        U[:] = J1T @ J2
        g[:P - 1] += np.einsum("fij,fj->fi", J1T, r_o)
        g[1:] += np.einsum("fij,fj->fi", J2T, r_o)
        JhT = np.swapaxes(hM, -1, -2)
        np.add.at(D, hidx, JhT @ hM)
        np.add.at(g, hidx, -np.einsum("cij,cj->ci", JhT, r_h))
        D[0], U[0], g[0] = np.eye(3), 0.0, 0.0
        return q(c), q(D), q(U), q(g)

    mu, nu = initial_mu, 2.0
    c, D, U, g = assemble(poses)
    c0 = c
    it = 0
    while it < max_iterations:
        it += 1
        diag = np.clip(np.einsum("pii->pi", D), 1e-6, 1e32)
        Dd = D.copy()
        Dd[:, [0, 1, 2], [0, 1, 2]] += mu * diag
        try:
            step = q(solveh_banded(_banded(Dd, U), -g.reshape(-1)).reshape(P, 3))
        except np.linalg.LinAlgError:
            mu *= nu
            nu *= 2
            continue
        trial = q(poses + step)
        c_new = q(cost_res(trial)[0])
        pred = 0.5 * np.sum(step * (mu * diag * step - g))
        rho = (c - c_new) / max(pred, 1e-30)
        small = (np.linalg.norm(step) <= parameter_tolerance
                 * (np.linalg.norm(trial if rho > 0 and np.isfinite(c_new)
                                   else poses) + parameter_tolerance))
        if rho > 0 and np.isfinite(c_new):
            converged = abs(c - c_new) <= function_tolerance * c
            poses = trial
            c, D, U, g = assemble(poses)
            mu *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            nu = 2.0
            if converged or small:
                break
        else:
            mu *= nu
            nu *= 2
            if small or mu >= mu_collapse:
                break
    out = poses.copy()
    out[:, 2] = angle_mod(out[:, 2])
    return dict(poses=q(out), unwrapped=poses, initial_cost=float(c0),
                final_cost=float(c), iterations=it)
