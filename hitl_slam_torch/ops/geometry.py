"""2D geometry ops shared by every stage of the cycle.

Port of hitl_slam_tpu/ops/geometry.py: angle wrapping, rotations, pose
transforms, point-to-segment distance and ordered-scan normals, all
broadcasting over leading dims and dtype-preserving.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def f32_reciprocal(c: float) -> float:
    """1 / c rounded to f32, both ways. The reference's compiled programs
    divide by a constant as a multiplication by this value (XLA rewrites
    x / const so), and a cell index at a bin edge depends on which of the
    two is done."""
    return float(np.float32(1.0) / np.float32(c))


def angle_mod(a: Tensor) -> Tensor:
    """Wrap angle(s) to (-pi, pi] via atan2(sin, cos)."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def rot2(theta: Tensor) -> Tensor:
    """2x2 rotation matrix(es) for angle(s); output shape theta.shape + (2, 2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


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


def generate_normals(points: Tensor, mask: Tensor,
                     max_neighbor_dist: float = 0.5) -> tuple[Tensor, Tensor]:
    """Normals of an ordered 2D scan: the mean of the 90-degree-rotated unit
    tangents to valid neighbours. A point with no valid neighbour has its
    mask bit cleared (static shapes). points [N, 2], mask [N] bool ->
    (normals [N, 2], new_mask [N])."""
    prev_d = points - torch.roll(points, 1, dims=0)
    next_d = torch.roll(points, -1, dims=0) - points
    n = points.shape[0]
    idx = torch.arange(n, device=points.device)
    prev_ok = ((idx > 0) & mask & torch.roll(mask, 1)
               & (norm2(prev_d) < max_neighbor_dist))
    next_ok = ((idx < n - 1) & mask & torch.roll(mask, -1)
               & (norm2(next_d) < max_neighbor_dist))

    def unit(v):
        return v / torch.clamp(norm2(v), min=1e-12)[..., None]

    zero = torch.zeros((), dtype=points.dtype, device=points.device)
    contrib = (torch.where(prev_ok[:, None], perp(unit(prev_d)), zero)
               + torch.where(next_ok[:, None], perp(unit(next_d)), zero))
    count = prev_ok.to(points.dtype) + next_ok.to(points.dtype)
    normal = unit(contrib / torch.clamp(count, min=1.0)[:, None])
    new_mask = mask & (count > 0)
    return torch.where(new_mask[:, None], normal, zero), new_mask
