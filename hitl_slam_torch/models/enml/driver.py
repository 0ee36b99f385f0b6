"""EnML driver: raw scan/odometry streams -> pose graph -> batch localize ->
`.stfs.covars`.

Port of hitl_slam_tpu/models/enml/driver.py: the host numpy pipeline is a
copy; `localize_and_save` runs the port's sweep on a torch device.

Host-side pipeline mirroring the reference's vector_mapping_main.cpp:
  - `build_episodes`   AddPose (:1072-1168): odometry accumulation with
                       minimum-translation/rotation node gating, laser index
                       clipping, range/angular-margin filtering, sensor
                       offset, ordered-scan normal generation;
  - `apply_noise_model` the 4-omniwheel encoder noise fault injector used by
                       --noise statistical tests (:369-405);
  - `consistency_metric` a vectorized stand-in for EvaluateConsistency
                       (:1742-1830): mean nearest-neighbor disagreement
                       between overlapping scans instead of pairwise SDF
                       rasters (same monotone signal, no CImg);
  - `localize_and_save` run the batch localizer and write the
                       .stfs.covars / .poses outputs (SaveStfsandCovars
                       :1855-1928, SaveLoggedPoses :1830).

Scans come in as plain arrays (ranges [T, R] + per-scan odometry), not ROS
bags; io/figure8.py synthesizes compatible streams.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...io import stfs


@dataclass
class EpisodeOptions:
    """Reference names from config/*.cfg `NonMarkovLocalization`."""

    minimum_node_translation: float = 0.3
    minimum_node_rotation: float = np.deg2rad(5.0)
    min_point_cloud_range: float = 0.02
    max_point_cloud_range: float = 70.0
    max_normal_point_distance: float = 0.5
    angular_margin: float = 0.0
    clip_low: int = 60
    clip_high: int = 60
    sensor_offset: tuple = (0.0, 0.0)


def options_from_table(table: dict):
    """(EnmlOptions, EpisodeOptions) from a resolved NonMarkovLocalization
    parameter table (reference names, config/non_markov_localization.cfg —
    the table may come from the Lua interpreter with domain/robot blocks
    already applied, or from a TOML mirror).

    Name translations (documented deviations):
      - min_rotation/min_translation -> minimum_node_rotation/_translation
        (AddPose gating, vector_mapping_main.cpp:1120-1140); the orebro
        domain's -1 sentinels mean "no gating" -> 0.0
      - max_solver_iterations -> gn_iterations (Ceres iteration budget ->
        GN sweep budget)
      - num_repeat_iterations -> match_rounds (re-match + re-solve rounds)
      - robot_laser_offset {x,y} -> sensor_offset tuple
    Unknown keys are ignored (the reference carries many dormant-subsystem
    parameters: visibility/object constraints, LTF map params)."""
    import dataclasses

    from .localizer import EnmlOptions

    eo_fields = {f.name for f in dataclasses.fields(EnmlOptions)}
    ep_fields = {f.name for f in dataclasses.fields(EpisodeOptions)}
    eo_kw = {k: v for k, v in table.items() if k in eo_fields}
    ep_kw = {k: v for k, v in table.items() if k in ep_fields}
    if "max_solver_iterations" in table:
        eo_kw["gn_iterations"] = int(table["max_solver_iterations"])
    if "num_repeat_iterations" in table:
        eo_kw["match_rounds"] = max(1, int(table["num_repeat_iterations"]))
    if "odometry_rotation_min_stddev" in table:
        eo_kw["odometry_angular_min_stddev"] = float(
            table["odometry_rotation_min_stddev"])
    if "odometry_rotation_max_stddev" in table:
        eo_kw["odometry_angular_max_stddev"] = float(
            table["odometry_rotation_max_stddev"])
    if "min_translation" in table:
        ep_kw["minimum_node_translation"] = max(
            0.0, float(table["min_translation"]))
    if "min_rotation" in table:
        ep_kw["minimum_node_rotation"] = max(
            0.0, float(table["min_rotation"]))
    off = table.get("robot_laser_offset")
    if isinstance(off, dict):
        ep_kw["sensor_offset"] = (float(off.get("x", 0.0)),
                                  float(off.get("y", 0.0)))
    elif isinstance(off, (list, tuple)):
        ep_kw["sensor_offset"] = (float(off[0]), float(off[1]))
    return EnmlOptions(**eo_kw), EpisodeOptions(**ep_kw)


def _rot(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s], [s, c]])


def generate_normals_np(points: np.ndarray, max_dist: float) -> tuple[np.ndarray, np.ndarray]:
    """Ordered-scan normals (perception_2d.cpp:34-65); returns (points,
    normals) with no-neighbor points dropped, like the reference's erase."""
    n = len(points)
    if n == 0:
        return points, points
    prev_d = points - np.roll(points, 1, axis=0)
    next_d = np.roll(points, -1, axis=0) - points
    idx = np.arange(n)
    prev_ok = (idx > 0) & (np.linalg.norm(prev_d, axis=1) < max_dist)
    next_ok = (idx < n - 1) & (np.linalg.norm(next_d, axis=1) < max_dist)

    def unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)

    def perp(v):
        return np.stack([-v[:, 1], v[:, 0]], -1)

    contrib = (np.where(prev_ok[:, None], perp(unit(prev_d)), 0)
               + np.where(next_ok[:, None], perp(unit(next_d)), 0))
    count = prev_ok.astype(float) + next_ok.astype(float)
    keep = count > 0
    normals = unit(contrib[keep] / count[keep, None])
    return points[keep], normals.astype(np.float32)


def build_episodes(
    scans: list[np.ndarray],          # T x [R] ranges
    scan_angles: np.ndarray,          # [R] beam angles
    rel_odometry: np.ndarray,         # [T, 3] per-scan relative (dx, dy, dth)
    options: EpisodeOptions = EpisodeOptions(),
    keyframes: set[int] | None = None,
    laser_corrections: np.ndarray | None = None,
):
    """Node gating + cloud construction. Returns (poses [P,3] odometry-
    integrated, point_clouds, normal_clouds, rel_poses [P,3]).

    `keyframes` (scan indices) force node creation regardless of motion
    gating, like the reference's keyframe timestamp list (AddPose :1091-1095).
    `laser_corrections` is an optional per-angle multiplicative range
    calibration table over [-pi, pi) (use_laser_corrections_, :1148-1154).
    """
    o = options
    acc_t = np.zeros(2)
    acc_th = 0.0
    glob_t = np.zeros(2)
    glob_th = 0.0
    poses, pcs, ncs, rels = [], [], [], []
    first = True
    for scan_idx, (ranges, rel) in enumerate(zip(scans, rel_odometry)):
        acc_t = acc_t + _rot(acc_th) @ rel[:2]
        acc_th = acc_th + rel[2]
        keyframe = keyframes is not None and scan_idx in keyframes
        if (not first and not keyframe
                and np.linalg.norm(acc_t) < o.minimum_node_translation
                and abs(acc_th) < o.minimum_node_rotation):
            continue
        glob_t = _rot(glob_th) @ acc_t + glob_t
        glob_th = glob_th + acc_th

        r = np.asarray(ranges, np.float32)
        a = np.asarray(scan_angles, np.float32)
        if laser_corrections is not None:
            idx = np.floor((a + np.pi) / (2 * np.pi)
                           * len(laser_corrections)).astype(int)
            r = r * laser_corrections[np.clip(idx, 0,
                                              len(laser_corrections) - 1)]
        lo, hi = o.clip_low, max(o.clip_low, len(r) - o.clip_high)
        r, a = r[lo:hi], a[lo:hi]
        ok = (np.isfinite(r) & (r > o.min_point_cloud_range)
              & (r < o.max_point_cloud_range)
              & (a >= a.min() + o.angular_margin)
              & (a <= a.max() - o.angular_margin))
        pts = (np.asarray(o.sensor_offset, np.float32)
               + np.stack([r[ok] * np.cos(a[ok]), r[ok] * np.sin(a[ok])], -1))
        pts, nrm = generate_normals_np(pts, o.max_normal_point_distance)
        if len(pts) == 0:
            pts = np.zeros((1, 2), np.float32)
            nrm = np.array([[1.0, 0.0]], np.float32)
        poses.append([glob_t[0], glob_t[1], glob_th])
        pcs.append(pts.astype(np.float32))
        ncs.append(nrm)
        rels.append([acc_t[0], acc_t[1], acc_th])
        acc_t = np.zeros(2)
        acc_th = 0.0
        first = False
    return (np.asarray(poses, np.float32), pcs, ncs,
            np.asarray(rels, np.float32))


def apply_noise_model(dx: float, dy: float, da: float, e: float,
                      rng: np.random.Generator) -> tuple[float, float, float]:
    """4-omniwheel encoder noise injection (vector_mapping_main.cpp:369-405):
    project the motion into wheel-encoder space, perturb each encoder with
    gaussian noise proportional to its reading, project back."""
    R = 0.1
    C = np.cos(np.deg2rad(45.0))
    M_vel_to_enc = np.array([
        [C, C, R], [-C, C, R], [-C, -C, R], [C, -C, R]])
    k = np.sqrt(2.0)
    M_enc_to_vel = np.array([
        [k, -k, -k, k], [k, k, -k, -k], [1 / R, 1 / R, 1 / R, 1 / R]]) / 4.0
    enc = M_vel_to_enc @ np.array([dx, dy, da])
    enc_noisy = enc + rng.normal(0.0, np.abs(e * enc))
    out = M_enc_to_vel @ enc_noisy
    return float(out[0]), float(out[1]), float(out[2])


def consistency_metric(poses: np.ndarray, point_clouds: list[np.ndarray],
                       max_pair_dist: float = 10.0,
                       sample: int = 64) -> float:
    """Mean cross-pose nearest-neighbor distance between overlapping scans —
    the scalar core of EvaluateConsistency without the SDF rasters. Lower is
    more self-consistent."""
    P = len(poses)
    worlds = []
    for i in range(P):
        pc = point_clouds[i]
        if len(pc) > sample:
            pc = pc[np.linspace(0, len(pc) - 1, sample).astype(int)]
        worlds.append(pc @ _rot(poses[i, 2]).T + poses[i, :2])
    total, count = 0.0, 0
    for i in range(P):
        for j in range(i + 1, P):
            if np.linalg.norm(poses[i, :2] - poses[j, :2]) > max_pair_dist:
                continue
            d = np.linalg.norm(
                worlds[i][:, None, :] - worlds[j][None, :, :], axis=-1)
            nn = d.min(axis=1)
            close = nn[nn < 0.5]
            if len(close):
                total += float(close.sum())
                count += len(close)
    return total / max(count, 1)


def localize_and_save(
    poses: np.ndarray,
    point_clouds: list[np.ndarray],
    normal_clouds: list[np.ndarray],
    out_prefix: str,
    map_name: str = "EnML",
    timestamp: float = 0.0,
    options=None,
    parallel_windows: bool = False,
    ltf_segs=None,
    device="cuda",
):
    """Run the batch localizer on `device` and write <prefix>.stfs.covars,
    <prefix>.poses and <prefix>.stfs (SaveStfsandCovars / SaveLoggedPoses /
    SaveStfs formats).

    parallel_windows=True uses the checkerboard (red/black) batched window
    solver instead of the sequential sliding-window sweep: the same
    factors, the windows of one parity solved as one batched GN problem.

    ltf_segs [S, 4] is a world-frame vector map (LTVM curator output):
    observations it explains become long-term features anchored to the map
    (point-to-line factors joining every window GN) — the reference's
    LTF observation class (vector_mapping.h:470-474,
    residual_functors.h:480-622), closing the LTVM curate -> localize loop."""
    from ...core.state import make_map_state
    from .localizer import EnmlOptions, batch_localize

    st = make_map_state(poses, np.zeros((len(poses), 3, 3), np.float32),
                        point_clouds, normal_clouds, device=device)
    opts = options or EnmlOptions()
    if ltf_segs is not None and parallel_windows:
        raise ValueError("ltf_segs is not supported with parallel_windows "
                         "(the checkerboard solver has no LTF term yet)")
    if parallel_windows:
        from .parallel_localizer import (
            BRUTE_MATCH_LIMIT, checkerboard_localize, probe_match_capacity)

        new_poses, covs = checkerboard_localize(
            st.points, st.normals, st.point_mask, st.poses, opts)
        W = min(opts.max_history, st.num_poses)
        if W * st.points.shape[1] > BRUTE_MATCH_LIMIT:
            # surface grid-matcher capacity violations on new datasets
            dropped = int(probe_match_capacity(
                st.points, st.normals, st.point_mask, new_poses, opts))
            if dropped:
                print(f"WARNING: grid matcher dropped {dropped} points "
                      f"(per-cell/occupied-cell capacity) — results may "
                      f"miss correspondences on this map density")
    else:
        segs = (None if ltf_segs is None
                else torch.as_tensor(np.asarray(ltf_segs),
                                     dtype=st.poses.dtype,
                                     device=st.poses.device))
        # on a card one replay of the map's sweep program
        new_poses, covs = batch_localize(
            st.points, st.normals, st.point_mask, st.poses, opts,
            ltf_segs=segs)
    new_poses = new_poses.cpu().numpy()
    covs = covs.cpu().numpy()
    stfs.save_stfs_covars(out_prefix + ".stfs.covars", map_name, timestamp,
                          new_poses, covs, point_clouds, normal_clouds)
    stfs.save_results_poses(out_prefix + ".poses", new_poses)
    stfs.save_stfs(out_prefix + ".stfs", map_name, timestamp, new_poses,
                   point_clouds)
    return new_poses, covs


def consistency_image(poses: np.ndarray, point_clouds: list[np.ndarray],
                      path: str | None = None,
                      max_pair_dist: float = 10.0,
                      sample: int = 48) -> np.ndarray:
    """[P, P] pairwise inconsistency matrix normalized to uint8 — the
    consistency%d.png observability artifact (EvaluateConsistency,
    vector_mapping_main.cpp:1742-1830), with mean cross-scan NN distance in
    place of the reference's SDF-overlap count."""
    P = len(poses)
    worlds = []
    for i in range(P):
        pc = point_clouds[i]
        if len(pc) > sample:
            pc = pc[np.linspace(0, len(pc) - 1, sample).astype(int)]
        worlds.append(pc @ _rot(poses[i, 2]).T + poses[i, :2])
    img = np.zeros((P, P), np.float64)
    for i in range(P):
        for j in range(i + 1, P):
            if np.linalg.norm(poses[i, :2] - poses[j, :2]) > max_pair_dist:
                continue
            d = np.linalg.norm(
                worlds[i][:, None, :] - worlds[j][None, :, :], axis=-1)
            nn = d.min(axis=1)
            close = nn[nn < 0.5]
            v = close.mean() if len(close) else 0.0
            img[i, j] = img[j, i] = v
    out = (255.0 * img / max(img.max(), 1e-9)).astype(np.uint8)
    if path:
        from ...utils.image import write_png

        write_png(path, out)
    return out
