"""Synthetic Figure8-style dataset generator. Host numpy only.

Frozen copy of hitl_slam_torch/io/figure8.py at commit 455be22 (itself a
copy of hitl_slam_tpu/io/figure8.py), unchanged but for this paragraph. It
is the benchmark's own input maker and is never re-synced with the port:
the yardstick does not move when the program does. tests/test_frozen.py
pins a hash of its output.

The reference is exercised on the UMass Figure8 map
(`2016-02-16-16-01-46.bag.stfs.covars`, README.md:99-103), which does not ship
with the repo. This module raycasts a 2D lidar against a figure-8 arrangement
of walls along a ground-truth trajectory, corrupts the poses with drifting
odometry noise (the same 4-wheel-style noise idea as the reference's
ApplyNoiseModel fault injector, vector_mapping_main.cpp:369-405), and grows
per-pose covariances with accumulated drift — producing .stfs.covars-equivalent
data at any scale for tests and benchmarks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticMap:
    poses: np.ndarray          # [P, 3] noisy (drifted) poses
    gt_poses: np.ndarray       # [P, 3] ground truth
    covariances: np.ndarray    # [P, 3, 3]
    point_clouds: list[np.ndarray]   # robot frame
    normal_clouds: list[np.ndarray]  # robot frame
    odometry: np.ndarray       # [P, 3] noisy relative-integrated odometry
    walls: np.ndarray          # [W, 4] world segments (x1,y1,x2,y2)


def _figure8_walls(w: float = 20.0, h: float = 10.0, gap: float = 1.5) -> np.ndarray:
    """Two w x h rooms side by side sharing a wall with a door gap: an '8'."""
    segs = [
        # outer boundary of the 2w x h figure
        (-w, 0.0, w, 0.0),
        (-w, h, w, h),
        (-w, 0.0, -w, h),
        (w, 0.0, w, h),
        # center dividing wall with a gap in the middle
        (0.0, 0.0, 0.0, h / 2 - gap),
        (0.0, h / 2 + gap, 0.0, h),
    ]
    return np.array(segs, np.float64)


def _figure8_trajectory(num_poses: int, w: float, h: float,
                        num_laps: int = 1) -> np.ndarray:
    """Lissajous figure-8 path visiting both rooms, with heading = tangent."""
    t = np.linspace(0.0, num_laps * 2.0 * np.pi, num_poses, endpoint=False)
    m = 0.62
    x = w * m * np.sin(t)
    y = h / 2 + h / 2 * m * np.sin(2.0 * t)
    dx = np.gradient(x)
    dy = np.gradient(y)
    theta = np.unwrap(np.arctan2(dy, dx))
    return np.stack([x, y, theta], axis=-1)


def _raycast(pose: np.ndarray, walls: np.ndarray, num_rays: int,
             max_range: float, fov: float) -> tuple[np.ndarray, np.ndarray]:
    """Cast `num_rays` rays from pose against wall segments.

    Returns robot-frame hit points [K, 2] and normals [K, 2] (normals face the
    robot). Vectorized ray x segment intersection over [R, W].
    """
    angles = pose[2] + np.linspace(-fov / 2, fov / 2, num_rays)
    d = np.stack([np.cos(angles), np.sin(angles)], -1)        # [R, 2]
    o = pose[:2]

    a = walls[:, 0:2]                                         # [W, 2]
    b = walls[:, 2:4]
    e = b - a                                                 # [W, 2]
    # Solve o + t*d = a + s*e  for t, s via 2x2 cross products.
    denom = d[:, None, 0] * (-e[None, :, 1]) - d[:, None, 1] * (-e[None, :, 0])
    ao = np.broadcast_to(a[None, :, :] - o[None, :], (num_rays, len(walls), 2))
    t = (ao[..., 0] * (-e[None, :, 1]) - ao[..., 1] * (-e[None, :, 0])) / np.where(
        np.abs(denom) < 1e-12, np.inf, denom)
    s = (d[:, None, 0] * ao[..., 1] - d[:, None, 1] * ao[..., 0]) / np.where(
        np.abs(denom) < 1e-12, np.inf, denom)
    valid = (t > 0.05) & (s >= 0.0) & (s <= 1.0)
    t = np.where(valid, t, np.inf)
    ti = np.argmin(t, axis=1)                                 # nearest wall per ray
    tmin = t[np.arange(num_rays), ti]
    hit = np.isfinite(tmin) & (tmin < max_range)

    tmin_h = tmin[hit]
    d_h = d[hit]
    world_pts = o + tmin_h[:, None] * d_h
    seg = walls[ti[hit]]
    tang = seg[:, 2:4] - seg[:, 0:2]
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
    nrm = np.stack([-tang[:, 1], tang[:, 0]], -1)
    # orient normals to face the robot
    flip = np.sum(nrm * d_h, axis=-1) > 0
    nrm[flip] *= -1.0

    c, s_ = np.cos(-pose[2]), np.sin(-pose[2])
    R_inv = np.array([[c, -s_], [s_, c]])
    robot_pts = (world_pts - o) @ R_inv.T
    robot_nrm = nrm @ R_inv.T
    return robot_pts.astype(np.float32), robot_nrm.astype(np.float32)


def generate_figure8(
    num_poses: int = 1024,
    num_rays: int = 180,
    max_range: float = 12.0,
    fov: float = 2.0 * np.pi * 0.75,
    drift_theta_bias: float = 2e-4,
    noise_trans: float = 1e-3,
    noise_theta: float = 3e-4,
    seed: int = 0,
    width: float = 20.0,
    height: float = 10.0,
    num_laps: int = 1,
) -> SyntheticMap:
    rng = np.random.default_rng(seed)
    walls = _figure8_walls(width, height)
    gt = _figure8_trajectory(num_poses, width, height, num_laps)

    # Relative odometry from ground truth, then corrupt + integrate -> drifted
    # poses. Covariances grow with accumulated noise, mimicking the
    # ceres::Covariance output EnML writes (vector_mapping.cpp:2772-2812).
    poses = np.zeros_like(gt)
    poses[0] = gt[0]
    covs = np.zeros((num_poses, 3, 3))
    covs[0] = np.diag([1e-6, 1e-6, 1e-6])
    acc = np.array([1e-6, 1e-6, 1e-6])
    for i in range(1, num_poses):
        c, s = np.cos(gt[i - 1, 2]), np.sin(gt[i - 1, 2])
        R_inv = np.array([[c, s], [-s, c]])
        dt_local = R_inv @ (gt[i, :2] - gt[i - 1, :2])
        dth = gt[i, 2] - gt[i - 1, 2]
        dt_local += rng.normal(0.0, noise_trans, 2)
        dth += rng.normal(0.0, noise_theta) + drift_theta_bias
        c2, s2 = np.cos(poses[i - 1, 2]), np.sin(poses[i - 1, 2])
        R = np.array([[c2, -s2], [s2, c2]])
        poses[i, :2] = poses[i - 1, :2] + R @ dt_local
        poses[i, 2] = poses[i - 1, 2] + dth
        step = np.linalg.norm(dt_local)
        acc = acc + np.array(
            [ (0.03 * step) ** 2 + 1e-8,
              (0.03 * step) ** 2 + 1e-8,
              (0.01 * abs(dth)) ** 2 + 4e-9 ])
        covs[i] = np.diag(acc)

    # Scans are raycast from the GROUND-TRUTH poses (the world is real) but
    # attached to the drifted pose estimates — exactly the SLAM failure mode
    # HitL repairs.
    pcs, ncs = [], []
    for i in range(num_poses):
        p, n = _raycast(gt[i], walls, num_rays, max_range, fov)
        if len(p) == 0:
            p = np.zeros((1, 2), np.float32)
            n = np.tile(np.array([[1.0, 0.0]], np.float32), (1, 1))
        pcs.append(p)
        ncs.append(n)

    odom = poses.copy()
    return SyntheticMap(
        poses=poses.astype(np.float32),
        gt_poses=gt.astype(np.float32),
        covariances=covs.astype(np.float32),
        point_clouds=pcs,
        normal_clouds=ncs,
        odometry=odom.astype(np.float32),
        walls=walls,
    )


def wall_points_drifted(
    m: SyntheticMap, pose_range, axis: int = 1, value: float = 0.0,
    tol: float = 0.25, span: tuple | None = None,
    poses: np.ndarray | None = None,
) -> np.ndarray:
    """Drifted world-frame positions of points that in GROUND TRUTH lie on the
    wall {coord[axis] == value}, for poses in pose_range. This is how tests
    and benches synthesize 'human' sketches: the same physical wall seen at
    two trajectory epochs, in the drifted frame. `poses` overrides the map's
    stored (original drifted) poses — pass the session's current estimates to
    sketch on the map as the user currently sees it."""
    est = m.poses if poses is None else poses
    pts = []
    for i in pose_range:
        gt = m.gt_poses[i]
        c, s = np.cos(gt[2]), np.sin(gt[2])
        world_gt = m.point_clouds[i] @ np.array([[c, -s], [s, c]]).T + gt[:2]
        on_wall = np.abs(world_gt[:, axis] - value) < tol
        if span is not None:
            along = world_gt[:, 1 - axis]
            on_wall &= (along >= span[0]) & (along <= span[1])
        dp = est[i]
        c2, s2 = np.cos(dp[2]), np.sin(dp[2])
        pts.append(
            m.point_clouds[i][on_wall] @ np.array([[c2, -s2], [s2, c2]]).T
            + dp[:2]
        )
    return np.concatenate(pts, axis=0)


def fit_clicked_segment(pts: np.ndarray) -> np.ndarray:
    """PCA segment through a point blob with endpoints snapped to actual
    points (a human clicks on rendered observations).

    The direction sign is canonicalized (positive x, tie-broken by positive
    y): the correction types interpret the two drawn segments' ORDER as an
    orientation, and a human sketching the same wall twice draws both in a
    consistent direction — anti-parallel sketches legitimately command a
    ~180-degree rotation (in the reference too)."""
    cm = pts.mean(axis=0)
    _, _, vt = np.linalg.svd(pts - cm, full_matrices=False)
    d = vt[0]
    if d[0] < 0 or (abs(d[0]) < 1e-9 and d[1] < 0):
        d = -d
    t = (pts - cm) @ d
    lo, hi = np.quantile(t, 0.02), np.quantile(t, 0.98)
    ends = np.stack([cm + lo * d, cm + hi * d])
    snapped = np.stack(
        [pts[np.argmin(np.linalg.norm(pts - e, axis=1))] for e in ends]
    )
    return snapped.astype(np.float32)


def synthesize_correction(
    m: SyntheticMap,
    corrected_range,
    anchor_range,
    corrected_wall=(1, 0.0),
    anchor_wall=(1, 0.0),
    min_points: int = 40,
    corrected_span: tuple | None = None,
    anchor_span: tuple | None = None,
    poses: np.ndarray | None = None,
) -> np.ndarray:
    """[4,2] selected points: corrected-epoch segment pair first, anchor pair
    second (the reference's expected ordering; EMinput reorders otherwise)."""
    late = wall_points_drifted(m, corrected_range, *corrected_wall,
                               span=corrected_span, poses=poses)
    early = wall_points_drifted(m, anchor_range, *anchor_wall,
                                span=anchor_span, poses=poses)
    if len(late) < min_points or len(early) < min_points:
        raise ValueError(
            f"not enough wall points: {len(late)}, {len(early)}"
        )
    seg_c = fit_clicked_segment(late)
    seg_a = fit_clicked_segment(early)
    # a human sketches the same wall twice in the same stroke direction;
    # fit_clicked_segment's positive-x canonicalization is noise-conditioned
    # for near-vertical walls (its x-component is ~0), and an accidental
    # anti-parallel pair commands a ~180-degree rotation (caught at 16k
    # scale, round 5: one flipped left-wall anchor turned a 0.29 m map into
    # a 13.8 m one). Orient the anchor stroke along the corrected stroke.
    if float(np.dot(seg_c[1] - seg_c[0], seg_a[1] - seg_a[0])) < 0.0:
        seg_a = seg_a[::-1].copy()
    return np.concatenate([seg_c, seg_a], axis=0)


def _raycast_ranges(pose, walls, num_rays, max_range, fov):
    """Per-beam range readings (np.inf on miss) — raw-scan form of _raycast."""
    angles = pose[2] + np.linspace(-fov / 2, fov / 2, num_rays)
    d = np.stack([np.cos(angles), np.sin(angles)], -1)
    o = pose[:2]
    a = walls[:, 0:2]
    e = walls[:, 2:4] - a
    denom = d[:, None, 0] * (-e[None, :, 1]) - d[:, None, 1] * (-e[None, :, 0])
    ao = np.broadcast_to(a[None, :, :] - o[None, :], (num_rays, len(walls), 2))
    t = (ao[..., 0] * (-e[None, :, 1]) - ao[..., 1] * (-e[None, :, 0])) / np.where(
        np.abs(denom) < 1e-12, np.inf, denom)
    s = (d[:, None, 0] * ao[..., 1] - d[:, None, 1] * ao[..., 0]) / np.where(
        np.abs(denom) < 1e-12, np.inf, denom)
    valid = (t > 0.05) & (s >= 0.0) & (s <= 1.0)
    t = np.where(valid, t, np.inf)
    tmin = t.min(axis=1)
    return np.where(tmin < max_range, tmin, np.inf).astype(np.float32)


def generate_raw_stream(
    num_steps: int = 256,
    num_rays: int = 360,
    max_range: float = 12.0,
    fov: float = 2.0 * np.pi * 0.75,
    noise_trans: float = 2e-3,
    noise_theta: float = 1e-3,
    range_noise: float = 5e-3,
    seed: int = 0,
    width: float = 20.0,
    height: float = 10.0,
    num_laps: int = 1,
):
    """Raw sensor stream for the EnML front end: per-step laser ranges + noisy
    relative odometry (the synthetic analog of a ROS bag). Returns
    (scans T x [R], beam_angles [R], rel_odometry [T,3], gt_poses [T,3],
    walls)."""
    rng = np.random.default_rng(seed)
    walls = _figure8_walls(width, height)
    gt = _figure8_trajectory(num_steps, width, height, num_laps)
    beam_angles = np.linspace(-fov / 2, fov / 2, num_rays).astype(np.float32)
    scans, rels = [], []
    for i in range(num_steps):
        r = _raycast_ranges(gt[i], walls, num_rays, max_range, fov)
        r = r + rng.normal(0.0, range_noise, r.shape).astype(np.float32)
        scans.append(r)
        if i == 0:
            rels.append(np.zeros(3, np.float32))
        else:
            c, s = np.cos(gt[i - 1, 2]), np.sin(gt[i - 1, 2])
            R_inv = np.array([[c, s], [-s, c]])
            dt = R_inv @ (gt[i, :2] - gt[i - 1, :2])
            dth = gt[i, 2] - gt[i - 1, 2]
            dt = dt + rng.normal(0.0, noise_trans, 2)
            dth = dth + rng.normal(0.0, noise_theta)
            rels.append(np.array([dt[0], dt[1], dth], np.float32))
    return scans, beam_angles, np.stack(rels), gt.astype(np.float32), walls
