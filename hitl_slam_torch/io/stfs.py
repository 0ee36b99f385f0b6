"""Reader for the `.stfs.covars` pose-graph text format, and the writers
of the results, `.stfs`, odometry and test-set files. Host numpy only.

Port of hitl_slam_tpu/io/stfs.py (the numpy parser, the native parser of
native/ where it builds, and the .stfs.covars writer). Format: a map-name
line, a timestamp line, then one CSV row per lidar point with 16 fields:

  pose_x, pose_y, pose_theta, obs_x, obs_y, normal_x, normal_y, cov(9 row-major)

Rows are grouped into poses wherever the pose fields change; observations and
normals are stored in the WORLD frame and are inverse-transformed into the
robot frame on load. A path ending in `.gz` is read through gzip.
"""

from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass

import numpy as np


@dataclass
class PoseGraphData:
    """Host-side parse result, robot-frame clouds, ready for make_map_state."""

    map_name: str
    timestamp: float
    poses: np.ndarray          # [P, 3]
    covariances: np.ndarray    # [P, 3, 3]
    point_clouds: list[np.ndarray]   # P x [n_i, 2] robot frame
    normal_clouds: list[np.ndarray]  # P x [n_i, 2] robot frame


def _rot(theta: np.ndarray) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)


def parse_rows(header_and_rows: str) -> tuple[str, float, np.ndarray]:
    lines = header_and_rows.splitlines()
    map_name = lines[0].strip()
    timestamp = float(lines[1].strip())
    body = "\n".join(lines[2:])
    rows = np.genfromtxt(_io.StringIO(body), delimiter=",", dtype=np.float64)
    rows = np.atleast_2d(rows)
    if rows.size == 0:
        rows = np.zeros((0, 16))
    if rows.shape[1] != 16:
        raise ValueError(f"expected 16 fields, got {rows.shape[1]}")
    return map_name, timestamp, rows


def load_stfs_covars(path: str, use_native: bool = True) -> PoseGraphData:
    """Read a .stfs.covars file (gzip-compressed when its name ends in .gz),
    with the native parser where it builds (not for .gz), else the numpy
    one; both give the same rows in f64."""
    if use_native and not path.endswith(".gz"):
        from .. import native

        parsed = native.parse_stfs_file(path)
        if parsed is not None:
            return _group_rows(*parsed)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        text = f.read()
    return _group_rows(*parse_rows(text))


def _group_rows(map_name: str, timestamp: float, rows: np.ndarray) -> PoseGraphData:
    """Group rows by pose change and inverse-transform clouds to robot frame:
    a new pose starts whenever any of the three pose fields differs from the
    previous row's. World->robot: p_r = R(-theta) (p_w - t); normals rotate
    only."""
    pose_fields = rows[:, 0:3]
    if len(rows) == 0:
        return PoseGraphData(map_name, timestamp, np.zeros((0, 3), np.float32),
                             np.zeros((0, 3, 3), np.float32), [], [])
    change = np.any(pose_fields[1:] != pose_fields[:-1], axis=1)
    boundaries = np.concatenate([[0], np.nonzero(change)[0] + 1, [len(rows)]])

    poses, covs, pcs, ncs = [], [], [], []
    for a, b in zip(boundaries[:-1], boundaries[1:]):
        pose = rows[a, 0:3]
        R_inv = _rot(-pose[2])
        world_pts = rows[a:b, 3:5]
        world_nrm = rows[a:b, 5:7]
        pcs.append(((world_pts - pose[0:2]) @ R_inv.T).astype(np.float32))
        ncs.append((world_nrm @ R_inv.T).astype(np.float32))
        poses.append(pose.astype(np.float32))
        covs.append(rows[a, 7:16].reshape(3, 3).astype(np.float32))

    return PoseGraphData(
        map_name, timestamp,
        np.stack(poses), np.stack(covs), pcs, ncs,
    )


def save_stfs_covars(
    path: str,
    map_name: str,
    timestamp: float,
    poses: np.ndarray,
    covariances: np.ndarray,
    point_clouds: list[np.ndarray],
    normal_clouds: list[np.ndarray],
) -> None:
    """Write robot-frame clouds as world-frame rows, 16 CSV fields per point
    (%.4f for poses, points and normals, %f for the covariance)."""
    with open(path, "w") as f:
        f.write(f"{map_name}\n{timestamp:f}\n")
        for i in range(len(poses)):
            x, y, th = (float(v) for v in poses[i])
            R = _rot(np.float64(th))
            wp = point_clouds[i] @ R.T + np.array([x, y])
            wn = normal_clouds[i] @ R.T
            c = np.asarray(covariances[i]).reshape(-1)
            for j in range(len(wp)):
                f.write(
                    f"{x:.4f},{y:.4f},{th:.4f},{wp[j,0]:.4f},{wp[j,1]:.4f}, "
                    f"{wn[j,0]:.4f},{wn[j,1]:.4f},"
                    + ", ".join(f"{v:f}" for v in c)
                    + "\n"
                )


def save_results_poses(path: str, poses: np.ndarray) -> None:
    """Write final poses, one `x y theta` row each (`hitl_results.txt`)."""
    with open(path, "w") as f:
        for p in poses:
            f.write(f"{p[0]:f} {p[1]:f} {p[2]:f}\n")


def append_test_set_poses(test_set_index: int, poses: np.ndarray,
                          directory: str = ".") -> str:
    """APPEND one line of result poses to `non_markov_test_<N>.txt` — the
    reference's test-set evaluation hook (vector_mapping_main.cpp:736-744
    inside SaveResults :719): every pose as `x,y,theta, ` (comma-space
    separated, trailing separator kept), one line per run, append mode so
    a batch of runs accumulates into one offline-comparison file.

    Returns the file path written."""
    import os

    path = os.path.join(directory, f"non_markov_test_{test_set_index}.txt")
    with open(path, "a") as f:
        for p in poses:
            f.write(f"{p[0]:f},{p[1]:f},{p[2]:f}, ")
        f.write("\n")
    return path


def save_stfs(
    path: str,
    map_name: str,
    timestamp: float,
    poses: np.ndarray,
    point_clouds: list[np.ndarray],
) -> None:
    """Covariance-free variant (`SaveStfs`, vector_mapping_main.cpp:1930-1987):
    map name, timestamp, then `pose_x,pose_y,pose_theta, px,py` world-frame
    rows."""
    with open(path, "w") as f:
        f.write(f"{map_name}\n{timestamp:f}\n")
        for i in range(len(poses)):
            x, y, th = (float(v) for v in poses[i])
            R = _rot(np.float64(th))
            wp = point_clouds[i] @ R.T + np.array([x, y])
            for j in range(len(wp)):
                f.write(f"{x:.4f},{y:.4f},{th:.4f}, {wp[j,0]:.4f},{wp[j,1]:.4f}\n")


def save_odometry(path: str, rel_poses: np.ndarray) -> None:
    """Relative odometry dump (`Odom.txt`, vector_mapping_main.cpp:2386-2395):
    one `dx dy dtheta` row per pose node."""
    with open(path, "w") as f:
        for r in rel_poses:
            f.write(f"{r[0]:f} {r[1]:f} {r[2]:f}\n")
