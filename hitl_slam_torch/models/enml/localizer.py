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
`device_while` over node indices held on the device, each window gathered
at a device index (utils/device_loop.py). A trip reads nothing back: no
`.item()`, no `bool(tensor)`, no `nonzero`, no index by a 0-dim tensor,
and the factorizations skip their host-side info checks (`cholesky_ex`,
`inv_ex`), so a failed factor gives non-finite values, as in the
reference, instead of a raise or a sync. On a CUDA device the sweep, a
segment of it and the online window solve replay captured programs
(models/enml/program.py); eagerly, on the CPU, the sweep reads one loop
flag a node.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.geometry import angle_mod, norm2, perp, rotate
from ...utils.device_loop import device_while, replays

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
        step = cholesky_solve(-g[..., None], L).reshape(Bw, W, 3)
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
    *,
    eager: bool = False,
) -> Tensor:
    """One window GN solve over exactly these W poses (first pose fixed):
    the online re-localization step, O(1) work per new node. On a CUDA
    device a replay of the shape's WindowProgram (models/enml/program.py),
    unless `eager`."""
    if replays(poses, eager):
        from .program import window_program

        return window_program(points, options, ltf_segs).run(
            points, normals, point_mask, poses, ltf_segs)
    return _single_window(points, normals, point_mask, poses, options,
                          ltf_segs)


def _single_window(points, normals, point_mask, poses, o: EnmlOptions,
                   ltf_segs=None, gates=None) -> Tensor:
    """single_window_localize's solve, eager or captured."""
    W = poses.shape[0]
    axis, d, rot, isig = _odometry_targets(poses, o)
    new_poses, _H = _window_gn(
        poses, points, normals, point_mask, axis, d, rot, isig,
        torch.ones(W - 1, dtype=poses.dtype, device=poses.device), o,
        ltf_segs=ltf_segs, gates=gates,
    )
    return torch.cat([new_poses[:, :2], angle_mod(new_poses[:, 2:])], -1)


def cholesky_solve(b: Tensor, L: Tensor) -> Tensor:
    """torch.cholesky_solve(b, L) for lower L, as its two triangular
    solves: the same BLAS calls as LAPACK's potrs on the CPU (bit-equal),
    and on the card cuBLAS triangular solves, which a CUDA graph captures
    on any stream. cuSOLVER's potrs allocates scratch inside a capture on
    every stream but the one that made the process's first cuSOLVER call
    (scripts/linalg_capture_probe.py), and a graph's loop body may hold no
    allocation."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


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
                     ltf_segs=None, gates=None):
    """The per-node window solve shared by the full sweep (batch_localize)
    and the segmented sweep (sweep_segment): step(poses, covs, t, live)
    updates the running estimates `poses` [P, 3] and covariances `covs`
    [P, 3, 3] IN PLACE for node t, a 0-dim int64 tensor on their device
    (the reference's scan index). Every index is computed on the device
    (the window start a and the newest node's row k as the reference's
    dynamic slices clamp them; gathers and index copies in place of
    slices), so a trip reads nothing back and one capture serves every t.
    With `live` (a 0-dim bool), the node's updates are kept only where it
    holds, as the reference's seg_step masks its trips past P - 1."""
    axis, d, rot, isig, rel_t, rel_th = pre
    P = points.shape[0]
    W = min(o.max_history, P)
    dev, dtype = points.device, points.dtype
    if gates is None:
        gates = _match_gates(o, dev)
    ar = torch.arange(W, device=dev)
    ar3 = torch.arange(3, device=dev)
    ar3w = torch.arange(3 * W, device=dev)

    def step(poses, covs, t: Tensor, live: Tensor | None = None) -> None:
        t1 = t.reshape(1)
        cur = poses.index_select(0, t1)[0]
        if P > 1:
            # seed pose t from optimized pose t-1 (ResetGlobalPoses)
            tp = torch.clamp(t1 - 1, min=0)
            prev = poses.index_select(0, tp)[0]
            seeded = torch.cat([
                prev[:2] + rotate(prev[2], rel_t.index_select(0, tp)[0]),
                (prev[2] + rel_th.index_select(0, tp)[0])[None]])
            cur = torch.where(t > 0, seeded, cur)

        # the reference's dynamic slices clamp their start to [0, P - W]
        a = torch.clamp(t - (W - 1), 0, P - W)
        k = t - a                        # the newest node's window row
        widx = a + ar
        w_old = poses.index_select(0, widx)
        w_poses = torch.where((ar == k)[:, None], cur, w_old)
        # rows beyond pose t are future poses: mask them out
        live_rows = widx <= t
        w_mask = point_mask.index_select(0, widx) & live_rows[:, None]
        cidx = widx[:-1]
        new_w_poses, H = _window_gn(
            w_poses, points.index_select(0, widx),
            normals.index_select(0, widx), w_mask,
            axis.index_select(0, cidx), d.index_select(0, cidx),
            rot.index_select(0, cidx), isig.index_select(0, cidx),
            (cidx < t).to(dtype), o, ltf_segs=ltf_segs, gates=gates,
        )
        if live is not None:
            new_w_poses = torch.where(live, new_w_poses, w_old)
        poses.index_copy_(0, widx, new_w_poses)

        # marginal covariance of the NEWEST pose (t) from this window's
        # Hessian, rotated into its pose frame; every pose gets the value
        # of the window it arrived in (the reference's documented choice).
        # Factor-free (future-masked) window poses are pinned to identity
        # so the inverse is well conditioned; they are decoupled from live
        # poses.
        m3 = live_rows[:, None].expand(W, 3).reshape(3 * W)
        H = torch.where(m3[:, None] & m3[None, :], H, 0.0)
        H = H + torch.diag(torch.where(m3, 1e-9, 1.0).to(dtype))
        cov_full = torch.linalg.inv_ex(H)[0]
        # the block at rows and columns 3k..3k+2, gathered with the layout
        # a slice of cov_full has (inv_ex returns LAPACK's column-major
        # inverse, and the CPU's 3x3 products round by their operands'
        # layout): the first three columns of a column-rolled slab of the
        # transpose, transposed back
        blk = cov_full.mT.index_select(0, 3 * k + ar3).index_select(
            1, torch.remainder(3 * k + ar3w, 3 * W))[:, :3].mT
        th = poses.index_select(0, t1)[0, 2]
        c, s = torch.cos(-th), torch.sin(-th)
        one, zero = torch.ones_like(c), torch.zeros_like(c)
        T = torch.stack([torch.stack([c, -s, zero]),
                         torch.stack([s, c, zero]),
                         torch.stack([zero, zero, one])])
        cov = T @ blk @ T.T
        if live is not None:
            cov = torch.where(live, cov, covs.index_select(0, t1)[0])
        covs.index_copy_(0, t1, cov[None])

    return step


def batch_localize(
    points: Tensor,        # [P, N, 2] robot frame
    normals: Tensor,       # [P, N, 2]
    point_mask: Tensor,    # [P, N]
    initial_poses: Tensor,  # [P, 3] odometry-integrated estimates
    options: EnmlOptions = EnmlOptions(),
    ltf_segs: Tensor | None = None,  # [S, 4] vector map -> LTF factors
    *,
    eager: bool = False,
) -> tuple[Tensor, Tensor]:
    """Full-trajectory sweep. Returns (poses [P, 3], covariances [P, 3, 3]).
    With `ltf_segs`, observations the map explains become long-term
    features anchored to it (point-to-line factors in every window).

    The sweep is one `device_while` over the nodes, as the reference's one
    `lax.scan`: on a CUDA device a replay of the map's SweepProgram
    (models/enml/program.py), one WHILE node, unless `eager`; eagerly (the
    CPU) a loop that reads one flag a node."""
    if replays(initial_poses, eager):
        from .program import sweep_program

        return sweep_program(points, options, None, ltf_segs).run(
            points, normals, point_mask, initial_poses, ltf_segs)
    return _sweep(points, normals, point_mask, initial_poses, options,
                  ltf_segs)


def _sweep(points, normals, point_mask, initial_poses, o: EnmlOptions,
           ltf_segs=None, gates=None):
    """batch_localize's sweep, eager or captured."""
    P = initial_poses.shape[0]
    dtype, dev = initial_poses.dtype, initial_poses.device
    step = _make_sweep_step(points, normals, point_mask,
                            sweep_precompute(initial_poses, o), o,
                            ltf_segs=ltf_segs, gates=gates)
    poses = initial_poses.clone()
    covariances = torch.empty((P, 3, 3), dtype=dtype, device=dev)
    t = torch.zeros((), dtype=torch.int64, device=dev)
    go = t < P

    def node():
        step(poses, covariances, t)
        t.add_(1)
        torch.lt(t, P, out=go)

    device_while(go, node, P, name="node")
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
    t0,                    # first node index of this segment (an int or a
                           # 0-dim integer tensor)
    options: EnmlOptions = EnmlOptions(),
    segment: int = 16,
    ltf_segs: Tensor | None = None,  # [S, 4] vector map -> LTF factors
    *,
    eager: bool = False,
) -> tuple[Tensor, Tensor]:
    """`segment` consecutive window solves of the trajectory sweep: the
    interactive form of batch_localize, called in a loop by a host that
    publishes progress or applies corrections between segments.

    Node indices past P-1 are computed against the clamped last window and
    their updates masked out, as the reference's, so any t0 tiling of
    [0, P) reproduces the full sweep. One `device_while` of `segment` trips:
    on a CUDA device a replay of the SweepProgram of this segment length,
    unless `eager`."""
    if replays(poses, eager):
        from .program import sweep_program

        return sweep_program(points, options, segment, ltf_segs).run(
            points, normals, point_mask, poses, covs, tuple(pre), t0,
            ltf_segs)
    t0 = torch.as_tensor(t0, dtype=torch.int64, device=poses.device)
    return _sweep_segment(points, normals, point_mask, poses, covs, pre, t0,
                          options, segment, ltf_segs)


def _sweep_segment(points, normals, point_mask, poses, covs, pre, t0,
                   o: EnmlOptions, segment: int, ltf_segs=None, gates=None):
    """sweep_segment's trips from the 0-dim int64 `t0`, eager or
    captured."""
    P = points.shape[0]
    step = _make_sweep_step(points, normals, point_mask, pre, o,
                            ltf_segs=ltf_segs, gates=gates)
    poses = poses.clone()
    covs = covs.clone()
    j = torch.zeros((), dtype=torch.int64, device=poses.device)
    go = j < segment

    def node():
        t = t0 + j
        step(poses, covs, torch.clamp(t, max=P - 1), t < P)
        j.add_(1)
        torch.lt(j, segment, out=go)

    device_while(go, node, segment, name="node")
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
