"""Build GUI draw-lists from a map state — the reference's DisplayPoses
(HitLSLAM_main.cpp:323-565) redone: trajectory lines, pose markers, world
frame scan points, and the pending correction sketch, appended to a DrawList
that a websocket bridge ships to a viewer.

Port of hitl_slam_tpu/gui/display.py. Host numpy: the state's tensors are
read to the host once each (poses, world points, mask).
"""

from __future__ import annotations

import numpy as np

from ..core.state import MapState
from .drawlist import (
    DrawList,
    POINT_COLOR,
    POSE_COLOR,
    TRAJECTORY_COLOR,
)


def display_poses(state: MapState, max_points: int | None = 200_000) -> DrawList:
    dl = DrawList()
    poses = state.poses.cpu().numpy()
    dl.draw_lines(poses[:-1, :2], poses[1:, :2], TRAJECTORY_COLOR)
    dl.draw_points(poses[:, :2], POSE_COLOR)

    world = state.world_points().cpu().numpy()
    mask = state.point_mask.cpu().numpy()
    pts = world[mask]
    if max_points is not None and len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[idx]
    dl.draw_points(pts, POINT_COLOR)

    if len(poses):
        dl.robot_pose = (float(poses[-1, 0]), float(poses[-1, 1]),
                         float(poses[-1, 2]))
    return dl


def display_selection(dl: DrawList, selected_points: list,
                      color: int = 0x2F36DE) -> DrawList:
    """Overlay the in-progress correction sketch (pairs of points as lines)."""
    pts = list(selected_points)
    for i in range(0, len(pts) - 1, 2):
        dl.draw_line(pts[i], pts[i + 1], color)
    for p in pts:
        dl.draw_circle(p, color)
    return dl


def display_proposals(dl: DrawList, proposals: list,
                      color: int = 0xF5A623) -> DrawList:
    """Overlay auto-proposed corrections (models/hitl/propose.py) as paired
    suggestion segments with their scores; proposal 0 is the accept target."""
    for k, p in enumerate(proposals):
        sel = np.asarray(p.input.points)
        dl.draw_line(sel[0], sel[1], color)
        dl.draw_line(sel[2], sel[3], color)
        dl.draw_circle(sel[0], color)
        dl.draw_circle(sel[2], color)
        mid = 0.5 * (sel[0] + sel[2])
        dl.draw_text(mid, f"#{k} score {p.score:.2f}", 0.6, color)
    return dl


def display_covariances(dl: DrawList, poses, covariances,
                        n_sigma: float = 3.0, stride: int = 1,
                        segments: int = 24,
                        color: int = 0x39B54A) -> DrawList:
    """Per-pose position-uncertainty ellipses — the DrawPoseCovariance3D
    analog (HitLSLAM_main.cpp:821-950; vector_mapping_main.cpp:1501):
    the n-sigma level set of the 2x2 position block, drawn as a polyline."""
    poses = np.asarray(poses)
    covariances = np.asarray(covariances)
    th = np.linspace(0.0, 2 * np.pi, segments + 1)
    circle = np.stack([np.cos(th), np.sin(th)], -1)          # [S+1, 2]
    for i in range(0, len(poses), max(stride, 1)):
        c2 = covariances[i][:2, :2]
        # eigendecomposition of the symmetric 2x2 -> ellipse axes
        w, v = np.linalg.eigh(0.5 * (c2 + c2.T))
        w = np.sqrt(np.maximum(w, 0.0)) * n_sigma
        if not np.isfinite(w).all() or w.max() <= 1e-6:
            continue
        ring = (circle * w[None, :]) @ v.T + poses[i, :2]
        dl.draw_lines(ring[:-1], ring[1:], color)
    return dl
