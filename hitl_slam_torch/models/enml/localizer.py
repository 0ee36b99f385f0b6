"""EnML batch localizer: the sliding-episode-window SLAM front end that
produces the `.stfs.covars` pose graphs HitL repairs.

Port of hitl_slam_tpu/models/enml/localizer.py, in plain PyTorch. The same
semantics:

  - an episode window of `max_history` poses advanced one node at a time;
  - odometry factors target the INITIAL (odometry-integrated) relative
    poses with rate-bounded sigmas, the window-first pose held constant;
  - STF factors: symmetric point-to-plane over in-window cross-pose nearest
    neighbours with distance and normal gates;
  - the newest pose's 3x3 marginal covariance from its window's GN Hessian,
    rotated into the pose frame;
  - a new pose is seeded from the optimized previous pose composed with the
    initial relative transform.

The reference sweeps the trajectory as one `lax.scan`; here the sweep is a
Python loop over node indices that slices each window with Python ints. It
reads nothing back from the device inside the loop: no `.item()`, no
`bool(tensor)`, no `nonzero`, and the factorizations skip their host-side
info checks (`cholesky_ex`, `inv_ex`), so a failed factor gives non-finite
values, as in the reference, instead of a raise or a sync.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.geometry import angle_mod, norm2, perp, rotate

Tensor = torch.Tensor


@dataclass(frozen=True)
class EnmlOptions:
    """The reference's VectorMappingOptions / NonMarkovLocalization names."""

    max_history: int = 10
    pose_increment: int = 1
    gn_iterations: int = 12
    match_rounds: int = 2                  # re-match + re-solve per window
    point_match_threshold: float = 0.15
    max_stf_angle_error: float = 25.0 * 3.14159265 / 180.0
    laser_std_dev: float = 0.05
    point_correlation_factor: float = 1.0 / 40.0
    odometry_radial_stddev_rate: float = 0.1
    odometry_tangential_stddev_rate: float = 0.1
    odometry_angular_stddev_rate: float = 0.1
    odometry_translation_min_stddev: float = 0.001
    odometry_translation_max_stddev: float = 0.5
    odometry_angular_min_stddev: float = 0.0001
    odometry_angular_max_stddev: float = 0.5
    damping: float = 1e-4
    # The reference's GN-step loop lowering (None: fully unrolled; k: a
    # fori_loop unrolled k times). Kept for config and CLI parity; eager
    # torch runs the GN steps as a Python loop, so it has no effect here.
    gn_unroll: int | None = None
    # LTF classification: a point within this distance of a vector-map
    # segment is a long-term feature, constrained to the MAP by a
    # point-to-line factor and excluded as an STF source. Only used when a
    # vector map is passed to the localizer.
    map_match_threshold: float = 0.25


def _odometry_targets(initial_poses: Tensor, o: EnmlOptions):
    """Per-chain-factor constants from the initial pose estimates:
    (axis [P-1, 2, 2], d [P-1], rot [P-1], inverse sigmas [P-1, 3])."""
    p0, p1 = initial_poses[:-1], initial_poses[1:]
    trans = p1[:, :2] - p0[:, :2]
    norm = norm2(trans)
    degenerate = (torch.abs(trans[:, 0]) < 1e-6) & (torch.abs(trans[:, 1]) < 1e-6)
    local = rotate(-p0[:, 2], trans)
    radial = torch.where(
        degenerate[:, None],
        torch.stack([torch.cos(p1[:, 2]), torch.sin(p1[:, 2])], -1),
        local / torch.clamp(norm, min=1e-6)[:, None],
    )
    tangential = perp(radial)
    axis = torch.stack([radial, tangential], dim=-2)
    d = torch.where(degenerate, 0.0, norm)
    rot = angle_mod(p1[:, 2] - p0[:, 2])
    sr = torch.clamp(o.odometry_radial_stddev_rate * d,
                     o.odometry_translation_min_stddev,
                     o.odometry_translation_max_stddev)
    st = torch.clamp(o.odometry_tangential_stddev_rate * d,
                     o.odometry_translation_min_stddev,
                     o.odometry_translation_max_stddev)
    sa = torch.clamp(o.odometry_angular_stddev_rate * torch.abs(rot),
                     o.odometry_angular_min_stddev,
                     o.odometry_angular_max_stddev)
    return axis, d, rot, torch.stack([1.0 / sr, 1.0 / st, 1.0 / sa], -1)


def _match_gates(o: EnmlOptions, device) -> tuple[float, Tensor]:
    """(t2, min_cos) of the STF match. min_cos is the cosine of the f32
    angle, rounded to f32: the reference's jnp.cos gives that correctly
    rounded value, where torch's f32 cos on the CPU is an ulp above it
    (0.90630782 against 0.90630776 at 25 degrees), which would move the
    normal gate. So it is taken in f64 and rounded once."""
    angle = torch.tensor(o.max_stf_angle_error, dtype=torch.float32)
    min_cos = torch.cos(angle.double()).float().to(device)
    return o.point_match_threshold ** 2, min_cos


# rows of the [M, M] match computed together on the CPU
_CPU_MATCH_ROWS = 256


def _pair_mask(flat_mask: Tensor, pose_of: Tensor) -> Tensor:
    """[..., M, M] pairs that may match: both points real, on different
    poses (flat_mask [..., M], with any leading batch dims)."""
    return (flat_mask[..., :, None] & flat_mask[..., None, :]
            & (pose_of[:, None] != pose_of[None, :]))


def _brute_window_match(poses, flat_pts, flat_nrm, flat_mask, pose_of,
                        t2, min_cos, pair_ok=None):
    """Best cross-pose nearest neighbour per point in the world frame ->
    (tgt_idx [..., M] int64, valid [..., M]); tgt is 0 where no candidate
    passes. O(M^2) distances: the right shape for a window of a few
    thousand points. Any leading batch dims of `poses` [..., W, 3] and the
    flat point arrays [..., M, ...] are windows matched each on its own;
    `pose_of` [M] is shared. `pair_ok` is `_pair_mask(flat_mask, pose_of)`,
    if the caller has it."""
    M = flat_pts.shape[-2]
    q = poses[..., pose_of, :]
    pw = rotate(q[..., 2], flat_pts) + q[..., :2]
    nw = rotate(q[..., 2], flat_nrm)
    if pair_ok is None:
        pair_ok = _pair_mask(flat_mask, pose_of)
    # Rows in blocks on the CPU, where an [M, M] pass runs out of cache (3x
    # slower at M = 2560); all rows at once on the card, in fewest launches.
    # Every row's arithmetic is the same either way.
    rows = M if pw.is_cuda else _CPU_MATCH_ROWS
    best, tgt = [], []
    for r in range(0, M, rows):
        p, nr = pw[..., r:r + rows, :], nw[..., r:r + rows, :]
        # the sum of squared coordinate differences, as the reference: the
        # matmul form of cdist rounds otherwise and flips matches at the gate
        d2 = p[..., :, None, 0] - pw[..., None, :, 0]
        dy = p[..., :, None, 1] - pw[..., None, :, 1]
        d2.mul_(d2).add_(dy.mul_(dy))
        # normal agreement elementwise: no matmul, so no TF32 question
        cos = nr[..., :, None, 0] * nw[..., None, :, 0]
        cos.add_(nr[..., :, None, 1] * nw[..., None, :, 1])
        ok = (cos > min_cos) & pair_ok[..., r:r + rows, :]
        # The distance gate is applied to the row minimum: the nearest
        # candidate passes d2 < t2 exactly when some candidate does, and
        # the entries equal to the minimum are then the same, so the first
        # of them is the reference's argmin. Where none passes, the
        # reference's row is all inf and its argmin 0.
        b, i = torch.min(torch.where(ok, d2, torch.inf), dim=-1)
        best.append(b)
        tgt.append(i)
    best, tgt = (torch.cat(best, -1), torch.cat(tgt, -1)) if len(best) > 1 \
        else (best[0], tgt[0])
    valid = best < t2
    return torch.where(valid, tgt, 0), valid


def _window_gn(
    w_poses: Tensor,     # [W, 3] current window poses
    w_pts: Tensor,       # [W, N, 2]
    w_nrm: Tensor,       # [W, N, 2]
    w_mask: Tensor,      # [W, N] (invalid rows fully masked)
    w_axis: Tensor,      # [W-1, 2, 2] odometry constants of the window chain
    w_d: Tensor, w_rot: Tensor, w_isig: Tensor,  # [W-1, ...]
    w_chain_valid: Tensor,  # [W-1] chain factor exists
    o: EnmlOptions,
    match_fn=None,       # (poses) -> (tgt, valid) override; default brute
    w_pin: Tensor | None = None,  # [W] bool: poses to pin besides pose 0
    eval_only: bool = False,  # one match + one Hessian, no GN step
    ltf_segs: Tensor | None = None,  # [S, 4] world vector map -> LTF factors
    need_hessian: bool = True,  # False: skip the final Hessian
    gates=None,          # (t2, min_cos) from _match_gates, to reuse
):
    """`match_rounds` x (window NN match -> gn_iterations damped GN steps on
    the dense [3W, 3W] window system); pose 0 of the window fixed.
    Returns (poses, H) with H the final Hessian (for the covariance).

    `eval_only=True` returns the input poses with the Hessian evaluated AT
    them (a fresh match, no GN step).

    One window: `window_gn_batched` with a batch of one (leading dims of
    size 1 are views, so it launches what an unbatched solve would)."""
    if match_fn is not None:
        inner = match_fn

        def match_fn(poses):
            tgt, valid = inner(poses[0])
            return tgt[None], valid[None]

    poses, H = window_gn_batched(
        w_poses[None], w_pts[None], w_nrm[None], w_mask[None], w_axis[None],
        w_d[None], w_rot[None], w_isig[None], w_chain_valid[None], o,
        match_fn=match_fn, w_pin=None if w_pin is None else w_pin[None],
        eval_only=eval_only, ltf_segs=ltf_segs, need_hessian=need_hessian,
        gates=gates)
    return poses[0], H[0]


def window_gn_batched(
    w_poses: Tensor,     # [B, W, 3] current window poses
    w_pts: Tensor,       # [B, W, N, 2]
    w_nrm: Tensor,       # [B, W, N, 2]
    w_mask: Tensor,      # [B, W, N] (invalid rows fully masked)
    w_axis: Tensor,      # [B, W-1, 2, 2] odometry constants of each chain
    w_d: Tensor, w_rot: Tensor, w_isig: Tensor,  # [B, W-1, ...]
    w_chain_valid: Tensor,  # [B, W-1] chain factor exists
    o: EnmlOptions,
    match_fn=None,       # (poses [B, W, 3]) -> (tgt [B, M], valid [B, M])
    w_pin: Tensor | None = None,  # [B, W] bool: poses to pin besides pose 0
    eval_only: bool = False,  # one match + one Hessian, no GN step
    ltf_segs: Tensor | None = None,  # [S, 4] world vector map -> LTF factors
    need_hessian: bool = True,  # False: skip the final Hessian
    gates=None,          # (t2, min_cos) from _match_gates, to reuse
):
    """B independent window solves as one problem: `_window_gn` with a
    leading batch dim on every window tensor (the reference vmaps
    `_window_gn` over a chunk of windows). The dense window systems are
    [B, 3W, 3W], factored by one batched Cholesky; a failed factor makes
    its own window's step NaN and no other's. Returns (poses [B, W, 3],
    H [B, 3W, 3W]).

    The point lanes keep a [B, W, N] layout: point (i, n) belongs to window
    pose i, so a source-side per-pose value (its pose, cos and sin) is a
    broadcast of a [B, W] vector, the same floats as the reference's
    gather."""
    Bw, W, N, _ = w_pts.shape
    M = W * N
    dev, dtype = w_pts.device, w_pts.dtype
    flat_pts = w_pts.reshape(Bw, M, 2)
    flat_nrm = w_nrm.reshape(Bw, M, 2)
    flat_mask = w_mask.reshape(Bw, M)
    wi = torch.arange(W, device=dev)
    pose_of = wi[:, None].expand(W, N).reshape(M)
    t2, min_cos = gates if gates is not None else _match_gates(o, dev)
    pair_ok = _pair_mask(flat_mask, pose_of) if match_fn is None else None
    wgt = o.point_correlation_factor / o.laser_std_dev
    pin = torch.zeros((Bw, W), dtype=torch.bool, device=dev) \
        if w_pin is None else w_pin.clone()
    pin[:, 0] = True
    pin3 = pin[:, :, None].expand(Bw, W, 3).reshape(Bw, 3 * W)
    free3 = ~pin3
    free_2d = free3[:, :, None] & free3[:, None, :]
    pin_diag = torch.diag_embed(pin3.to(dtype))
    n3 = 3 * W
    eye_n3 = torch.eye(n3, dtype=dtype, device=dev).expand(Bw, n3, n3)
    spx, spy = w_pts[..., 0], w_pts[..., 1]          # [B, W, N]
    snx, sny = w_nrm[..., 0], w_nrm[..., 1]
    z1 = torch.zeros((Bw, 1, 3, 3), dtype=dtype, device=dev)
    # odometry factor constants, fixed over the window solve
    Bo = w_axis * w_isig[..., :2, None]
    isa = w_isig[..., 2]
    zc = torch.zeros_like(w_d)
    cv3 = w_chain_valid[..., None, None]

    def match(poses):
        if match_fn is not None:
            return match_fn(poses)
        return _brute_window_match(poses, flat_pts, flat_nrm, flat_mask,
                                   pose_of, t2, min_cos, pair_ok)

    def odometry(poses):
        """The chain factors: (diag [B, W, 3, 3], upper [B, W-1, 3, 3],
        g [B, W, 3])."""
        p0, p1 = poses[:, :-1], poses[:, 1:]
        v = rotate(-p0[..., 2], p1[..., :2] - p0[..., :2])
        u = (w_axis * v[..., None, :]).sum(-1)
        r_o = torch.stack([
            (u[..., 0] - w_d) * w_isig[..., 0],
            u[..., 1] * w_isig[..., 1],
            angle_mod(p1[..., 2] - p0[..., 2] - w_rot) * w_isig[..., 2],
        ], -1) * w_chain_valid[..., None]
        c, s = torch.cos(-p0[..., 2]), torch.sin(-p0[..., 2])
        Rn = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
        ARot = Bo @ Rn
        dv = torch.stack([v[..., 1], -v[..., 0]], -1)
        du = (Bo * dv[..., None, :]).sum(-1)
        last2 = torch.stack([zc, zc, isa], -1)[..., None, :]
        J2 = torch.cat([torch.cat([ARot, torch.zeros_like(du)[..., None]], -1),
                        last2], dim=-2) * cv3
        J1 = torch.cat([torch.cat([-ARot, du[..., None]], -1),
                        -last2], dim=-2) * cv3
        J1T = J1.transpose(-1, -2)
        J2T = J2.transpose(-1, -2)
        diag_odo = (torch.cat([J1T @ J1, z1], 1)
                    + torch.cat([z1, J2T @ J2], 1))
        g = torch.zeros((Bw, W, 3), dtype=dtype, device=dev)
        g[:, :-1] += (J1T @ r_o[..., None])[..., 0]
        g[:, 1:] += (J2T @ r_o[..., None])[..., 0]
        return diag_odo, J1T @ J2, g

    def system(poses, rnd):
        """The windows' GN systems (H [B, 3W, 3W], g [B, 3W]) at `poses`,
        with the round's matches `rnd`."""
        t_pose, oh_tT, tpx, tpy, tnx, tny, vm, ltf_idx, ltf_valid = rnd
        diag_odo, U_odo, g = odometry(poses)

        # symmetric point-to-plane STF residuals/jacobians, [B, W, N] lanes
        cW, sW = torch.cos(poses[..., 2]), torch.sin(poses[..., 2])
        cs_, ss_ = cW[..., None], sW[..., None]
        qt = torch.stack([poses[..., 0], poses[..., 1], cW, sW], -1).gather(
            1, t_pose.reshape(Bw, M, 1).expand(Bw, M, 4)).reshape(Bw, W, N, 4)
        qtx, qty, ct_, st_ = qt.unbind(-1)
        rsx = cs_ * spx - ss_ * spy          # R(th_s) sp
        rsy = ss_ * spx + cs_ * spy
        rtx = ct_ * tpx - st_ * tpy
        rty = st_ * tpx + ct_ * tpy
        spwx, spwy = rsx + poses[..., 0, None], rsy + poses[..., 1, None]
        tpwx, tpwy = rtx + qtx, rty + qty
        snwx = cs_ * snx - ss_ * sny
        snwy = ss_ * snx + cs_ * sny
        tnwx = ct_ * tnx - st_ * tny
        tnwy = st_ * tnx + ct_ * tny
        dpx, dpy = tpwx - spwx, tpwy - spwy
        r0 = (snwx * dpx + snwy * dpy) * vm
        r1 = (tnwx * dpx + tnwy * dpy) * vm
        snw_dsp = -snwx * rsy + snwy * rsx
        tnw_dsp = -tnwx * rsy + tnwy * rsx
        snw_dtp = -snwx * rty + snwy * rtx
        tnw_dtp = -tnwx * rty + tnwy * rtx
        dsn_dp = -snwy * dpx + snwx * dpy
        dtn_dp = -tnwy * dpx + tnwx * dpy
        # rows of j0 = d(r0, r1)/d(pose_s) and j1 = d(r0, r1)/d(pose_t)
        # as [B, W, N, 3]: a / a1 are j0's rows, b / b1 are j1's
        a = torch.stack([-vm * snwx, -vm * snwy, vm * (dsn_dp - snw_dsp)], -1)
        a1 = torch.stack([-vm * tnwx, -vm * tnwy, -vm * tnw_dsp], -1)
        b = torch.stack([vm * snwx, vm * snwy, vm * snw_dtp], -1)
        b1 = torch.stack([vm * tnwx, vm * tnwy, vm * (dtn_dp + tnw_dtp)], -1)

        def outer(x, y, x1, y1):
            # entry p*3+q: x[p] y[q] + x1[p] y1[q]
            return (x[..., :, None] * y[..., None, :]
                    + x1[..., :, None] * y1[..., None, :]).reshape(Bw, W, N, 9)

        # STF reductions: the source side is a sum over each pose's N
        # lanes; the target side contracts the one-hot [B, W, M] of the
        # matched poses in full f32 (TF32 is off package-wide)
        X1 = outer(b, b, b1, b1).reshape(Bw, M, 9)
        D_st = (outer(a, a, a1, a1).sum(2) + oh_tT @ X1).reshape(Bw, W, 3, 3)

        if ltf_segs is not None:
            # unary point-to-line LTF factors: r = n . (world - a_seg),
            # J = [n | n . perp(R p)], block diagonal in the pose
            sa = ltf_segs[ltf_idx, 0:2]
            sd = ltf_segs[ltf_idx, 2:4] - sa
            inv_len = 1.0 / torch.clamp(norm2(sd), min=1e-12)
            nx = -sd[..., 1] * inv_len
            ny = sd[..., 0] * inv_len
            wl = ltf_valid.to(dtype) * wgt
            rl = (nx * (spwx - sa[..., 0]) + ny * (spwy - sa[..., 1])) * wl
            jrow = torch.stack([nx * wl, ny * wl,
                                (nx * (-rsy) + ny * rsx) * wl], -1)
            XL = (jrow[..., :, None] * jrow[..., None, :]).reshape(Bw, W, N, 9)
            D_st = D_st + XL.sum(2).reshape(Bw, W, 3, 3)
            g = g + (jrow * rl[..., None]).sum(2)

        # Cst[i, j] = sum_n [t_pose(i, n) = j] X2[i, n, :]: a batched matmul
        # over the source pose (for B = 1 a strided view, no copy)
        Cst = torch.matmul(oh_tT.reshape(Bw, W, W, N).transpose(1, 2),
                           outer(a, b, a1, b1)).reshape(Bw, W, W, 3, 3)
        Hb = Cst + Cst.permute(0, 2, 1, 4, 3)           # + (t, s) term
        Hb[:, wi, wi] += D_st + diag_odo
        Hb[:, wi[:-1], wi[1:]] += U_odo
        Hb[:, wi[1:], wi[:-1]] += U_odo.transpose(-1, -2)
        H = Hb.permute(0, 1, 3, 2, 4).reshape(Bw, n3, n3)
        ga = a * r0[..., None] + a1 * r1[..., None]
        gb = b * r0[..., None] + b1 * r1[..., None]
        g = g + ga.sum(2) + oh_tT @ gb.reshape(Bw, M, 3)

        # pin the window-first pose and any caller-pinned pose: zero rows
        # and columns, identity diagonal, zero gradient
        H = torch.where(free_2d, H, 0.0) + pin_diag
        g = torch.where(free3, g.reshape(Bw, n3), 0.0)
        return H, g

    def gn_step(poses, rnd):
        H, g = system(poses, rnd)
        diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-6, 1e32)
        Hd = H + o.damping * torch.diag_embed(diag)
        # SPD by construction (normal matrix + damping + identity rows of
        # pinned poses); a failed factor becomes NaN, as jnp's does
        L, info = torch.linalg.cholesky_ex(Hd)
        L = torch.where((info == 0)[:, None, None], L, torch.nan)
        step = torch.cholesky_solve(-g[..., None], L).reshape(Bw, W, 3)
        return poses + step

    def gn_round(poses, n_iter, want_hessian):
        tgt, valid = match(poses)
        tgt = tgt.long()
        ltf_idx = ltf_valid = None
        if ltf_segs is not None:
            # classify long-term features: points the vector map explains
            # become point-to-line factors and stop being STF sources
            from ...ops.ltf import match_segments

            q_ = poses[:, pose_of]
            world = rotate(q_[..., 2], flat_pts) + q_[..., :2]
            ltf_idx, ltf_valid = match_segments(
                ltf_segs, world, flat_mask, o.map_match_threshold)
            valid = valid & ~ltf_valid
            ltf_idx = ltf_idx.long().reshape(Bw, W, N)
            ltf_valid = ltf_valid.reshape(Bw, W, N)
        # what the round's matches fix for all of its GN steps
        t_pose = pose_of[tgt].reshape(Bw, W, N)
        tgt2 = tgt[..., None].expand(Bw, M, 2)
        tp = flat_pts.gather(1, tgt2).reshape(Bw, W, N, 2)
        tn = flat_nrm.gather(1, tgt2).reshape(Bw, W, N, 2)
        rnd = (t_pose, (wi[:, None] == t_pose.reshape(Bw, 1, M)).to(dtype),
               tp[..., 0], tp[..., 1], tn[..., 0], tn[..., 1],
               valid.reshape(Bw, W, N).to(dtype) * wgt, ltf_idx, ltf_valid)
        for _ in range(n_iter):
            poses = gn_step(poses, rnd)
        if not want_hessian:
            return poses, eye_n3
        return poses, system(poses, rnd)[0]

    if eval_only:
        return gn_round(w_poses, 0, True)

    H = eye_n3
    poses = w_poses
    for rnd in range(o.match_rounds):
        # only the last round's final Hessian is read, and only when the
        # caller wants it
        poses, H = gn_round(poses, o.gn_iterations,
                            need_hessian and rnd == o.match_rounds - 1)
    return poses, H


def single_window_localize(
    points: Tensor,       # [W, N, 2] robot frame
    normals: Tensor,      # [W, N, 2]
    point_mask: Tensor,   # [W, N]
    poses: Tensor,        # [W, 3] current estimates
    options: EnmlOptions = EnmlOptions(),
    ltf_segs: Tensor | None = None,  # [S, 4] vector map -> LTF factors
) -> Tensor:
    """One window GN solve over exactly these W poses (first pose fixed):
    the online re-localization step, O(1) work per new node."""
    o = options
    W = poses.shape[0]
    axis, d, rot, isig = _odometry_targets(poses, o)
    new_poses, _H = _window_gn(
        poses, points, normals, point_mask, axis, d, rot, isig,
        torch.ones(W - 1, dtype=poses.dtype, device=poses.device), o,
        ltf_segs=ltf_segs,
    )
    return torch.cat([new_poses[:, :2], angle_mod(new_poses[:, 2:])], -1)


def sweep_precompute(initial_poses: Tensor, options: EnmlOptions):
    """Per-trajectory constants of the window sweep: odometry factor
    targets from the INITIAL (odometry-integrated) poses, and the relative
    seed transforms for window advance. Corrections that move poses
    mid-session do not change them."""
    axis, d, rot, isig = _odometry_targets(initial_poses, options)
    rel_t = rotate(-initial_poses[:-1, 2],
                   initial_poses[1:, :2] - initial_poses[:-1, :2])
    rel_th = initial_poses[1:, 2] - initial_poses[:-1, 2]
    return (axis, d, rot, isig, rel_t, rel_th)


def _make_sweep_step(points, normals, point_mask, pre, o: EnmlOptions,
                     ltf_segs=None):
    """The per-node window solve shared by the full sweep (batch_localize)
    and the segmented sweep (sweep_segment): step(poses, t) updates the
    running estimates `poses` [P, 3] IN PLACE for node t (a Python int) and
    returns the newest pose's covariance [3, 3]."""
    axis, d, rot, isig, rel_t, rel_th = pre
    P = points.shape[0]
    W = min(o.max_history, P)
    dev, dtype = points.device, points.dtype
    gates = _match_gates(o, dev)
    ar = torch.arange(W, device=dev)
    # row k: the window rows live when the newest node sits at row k
    live_rows = ar[None, :] <= ar[:, None]                       # [W, W]
    live_chain = (ar[None, :-1] < ar[:, None]).to(dtype)          # [W, W-1]
    live3 = live_rows[:, :, None].expand(W, W, 3).reshape(W, 3 * W)
    # pin factor-free (future-masked) window poses to identity so the
    # inverse is well conditioned; they are decoupled from live poses
    cov_diag = torch.where(live3, 1e-9, 1.0).to(dtype)            # [W, 3W]

    def step(poses, t: int) -> Tensor:
        if t > 0:
            # seed pose t from optimized pose t-1 (ResetGlobalPoses)
            prev = poses[t - 1]
            poses[t, :2] = prev[:2] + rotate(prev[2], rel_t[t - 1])
            poses[t, 2] = prev[2] + rel_th[t - 1]

        # the reference's dynamic slices clamp their start to [0, P - W]
        a = min(max(t - W + 1, 0), P - W)
        k = t - a                        # the newest node's window row
        w_poses = poses[a:a + W]
        w_mask = point_mask[a:a + W]
        if k < W - 1:
            # rows beyond pose t are future poses: mask them out
            w_mask = w_mask & live_rows[k][:, None]
        new_w_poses, H = _window_gn(
            w_poses, points[a:a + W], normals[a:a + W], w_mask,
            axis[a:a + W - 1], d[a:a + W - 1], rot[a:a + W - 1],
            isig[a:a + W - 1], live_chain[k], o, ltf_segs=ltf_segs,
            gates=gates,
        )
        poses[a:a + W] = new_w_poses

        # marginal covariance of the NEWEST pose (t) from this window's
        # Hessian, rotated into its pose frame; every pose gets the value
        # of the window it arrived in (the reference's documented choice)
        if k < W - 1:
            m3 = live3[k]
            H = torch.where(m3[:, None] & m3[None, :], H, 0.0)
        H = H + torch.diag(cov_diag[k])
        cov_full = torch.linalg.inv_ex(H)[0]
        blk = cov_full[3 * k:3 * k + 3, 3 * k:3 * k + 3]
        th = poses[t, 2]
        c, s = torch.cos(-th), torch.sin(-th)
        one, zero = torch.ones_like(c), torch.zeros_like(c)
        T = torch.stack([torch.stack([c, -s, zero]),
                         torch.stack([s, c, zero]),
                         torch.stack([zero, zero, one])])
        return T @ blk @ T.T

    return step


def batch_localize(
    points: Tensor,        # [P, N, 2] robot frame
    normals: Tensor,       # [P, N, 2]
    point_mask: Tensor,    # [P, N]
    initial_poses: Tensor,  # [P, 3] odometry-integrated estimates
    options: EnmlOptions = EnmlOptions(),
    ltf_segs: Tensor | None = None,  # [S, 4] vector map -> LTF factors
) -> tuple[Tensor, Tensor]:
    """Full-trajectory sweep. Returns (poses [P, 3], covariances [P, 3, 3]).
    With `ltf_segs`, observations the map explains become long-term
    features anchored to it (point-to-line factors in every window)."""
    o = options
    P = initial_poses.shape[0]
    dtype, dev = initial_poses.dtype, initial_poses.device

    pre = sweep_precompute(initial_poses, o)
    step = _make_sweep_step(points, normals, point_mask, pre, o,
                            ltf_segs=ltf_segs)
    poses = initial_poses.clone()
    covariances = torch.empty((P, 3, 3), dtype=dtype, device=dev)
    for t in range(P):
        covariances[t] = step(poses, t)
    # pose 0 is the gauge
    covariances[0] = torch.eye(3, dtype=dtype, device=dev) * 1e-6
    poses[:, 2] = angle_mod(poses[:, 2])
    return poses, covariances


def sweep_segment(
    points: Tensor,        # [P, N, 2] robot frame
    normals: Tensor,       # [P, N, 2]
    point_mask: Tensor,    # [P, N]
    poses: Tensor,         # [P, 3] running estimates (prefix < t0 localized)
    covs: Tensor,          # [P, 3, 3] running covariance buffer
    pre,                   # sweep_precompute(initial_poses, options)
    t0: int,               # first node index of this segment
    options: EnmlOptions = EnmlOptions(),
    segment: int = 16,
    ltf_segs: Tensor | None = None,  # [S, 4] vector map -> LTF factors
) -> tuple[Tensor, Tensor]:
    """`segment` consecutive window solves of the trajectory sweep: the
    interactive form of batch_localize, called in a loop by a host that
    publishes progress or applies corrections between segments.

    The reference computes node indices past P-1 against a clamped window
    and masks their updates out; here they are skipped, which gives the
    same result, so any t0 tiling of [0, P) reproduces the full sweep."""
    P = points.shape[0]
    step = _make_sweep_step(points, normals, point_mask, pre, options,
                            ltf_segs=ltf_segs)
    poses = poses.clone()
    covs = covs.clone()
    for t in range(int(t0), min(int(t0) + segment, P)):
        covs[t] = step(poses, t)
    poses[:, 2] = angle_mod(poses[:, 2])
    return poses, covs


def window_correspondences(
    points: Tensor,        # [P, N, 2] robot frame
    normals: Tensor,       # [P, N, 2]
    point_mask: Tensor,    # [P, N]
    poses: Tensor,         # [P, 3]
    t: int,                # newest node of the window
    options: EnmlOptions = EnmlOptions(),
) -> tuple[Tensor, Tensor, Tensor]:
    """STF correspondence endpoints of the window ending at node `t`, in
    the WORLD frame. Returns (src [W*N, 2], tgt [W*N, 2], valid [W*N]);
    invalid rows are garbage and must be masked by `valid`."""
    o = options
    P = points.shape[0]
    W = min(o.max_history, P)
    t = int(t)
    a = min(max(t - W + 1, 0), P - W)
    w_pts = points[a:a + W]
    w_nrm = normals[a:a + W]
    w_poses = poses[a:a + W]
    widx = a + torch.arange(W, device=points.device)
    w_mask = point_mask[a:a + W] & (widx <= t)[:, None]

    N = w_pts.shape[1]
    M = W * N
    flat_pts = w_pts.reshape(M, 2)
    flat_nrm = w_nrm.reshape(M, 2)
    flat_mask = w_mask.reshape(M)
    pose_of = torch.arange(W, device=points.device)[:, None].expand(
        W, N).reshape(M)
    tgt, valid = _brute_window_match(
        w_poses, flat_pts, flat_nrm, flat_mask, pose_of,
        *_match_gates(o, points.device))
    q = w_poses[pose_of]
    src_world = rotate(q[:, 2], flat_pts) + q[:, :2]
    qt = w_poses[pose_of[tgt]]
    tgt_world = rotate(qt[:, 2], flat_pts[tgt]) + qt[:, :2]
    return src_world, tgt_world, valid
