"""2D geometry ops shared by every stage of the cycle.

Port of hitl_slam_tpu/ops/geometry.py: angle wrapping, rotations, pose
transforms and point-to-segment distance, all broadcasting over leading
dims and dtype-preserving.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def angle_mod(a: Tensor) -> Tensor:
    """Wrap angle(s) to (-pi, pi] via atan2(sin, cos)."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def rotate(theta: Tensor, v: Tensor) -> Tensor:
    """Rotate 2-vector(s) v by angle(s) theta. Broadcasts over leading dims."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def perp(v: Tensor) -> Tensor:
    """90-degree CCW rotation of 2-vector(s): (x, y) -> (-y, x)."""
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def scalar_cross(a: Tensor, b: Tensor) -> Tensor:
    """z-component of the 3D cross product of two 2-vectors."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def pose_to_world(pose: Tensor, pts: Tensor) -> Tensor:
    """world = R(theta) p + t for pose [..., 3] = (x, y, theta)."""
    return rotate(pose[..., 2], pts) + pose[..., :2]


def world_to_robot(pose: Tensor, pts: Tensor) -> Tensor:
    """Inverse of pose_to_world: p = R(-theta) (world - t)."""
    return rotate(-pose[..., 2], pts - pose[..., :2])


def norm2(v: Tensor) -> Tensor:
    """Euclidean norm over the last axis, as sqrt(sum(v*v))."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def dist_to_segment(p1: Tensor, p2: Tensor, p: Tensor) -> Tensor:
    """Euclidean distance from point(s) p to segment [p1, p2], with the
    projection parameter clamped to [0, 1]. Broadcasts over leading dims."""
    d = p2 - p1
    denom = torch.clamp(torch.sum(d * d, dim=-1), min=1e-20)
    t = torch.sum((p - p1) * d, dim=-1) / denom
    t = torch.clamp(t, 0.0, 1.0)
    proj = p1 + t[..., None] * d
    return norm2(p - proj)
