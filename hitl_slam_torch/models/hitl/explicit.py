"""Explicit rigid correction implied by the sketch pair.

Port of hitl_slam_tpu/models/hitl/explicit.py:

  - the per-type rigid transform is computed once from the two refit
    segments; the reference's `lax.switch` on a traced type becomes a
    Python dispatch on the host-known correction type;
  - the group of corrected poses and every pose after it move by the one
    rigid map p -> target + R(theta) (p - center);
  - constraint targets are the (delta_parallel, delta_perpendicular,
    delta_angle, penalty_dir) offsets of every (anchor, corrected) pair in
    the anchor frame, from the post-explicit poses.
"""

from __future__ import annotations

import math

import torch

from ...core.state import CorrectionType
from ...ops.geometry import angle_mod, norm2, rotate, scalar_cross

Tensor = torch.Tensor


def _seg_dirs(sel: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    cmA = 0.5 * (sel[0] + sel[1])
    cmB = 0.5 * (sel[2] + sel[3])
    A = sel[1] - sel[0]
    A = A / torch.clamp(norm2(A), min=1e-12)
    B = sel[3] - sel[2]
    B = B / torch.clamp(norm2(B), min=1e-12)
    return cmA, cmB, A, B


def _signed_angle(A: Tensor, B: Tensor) -> Tensor:
    dot = torch.clamp(torch.sum(A * B), -1.0, 1.0)
    theta = torch.arccos(dot)
    return torch.where(scalar_cross(A, B) < 0.0, -theta, theta)


def correction_transform(ctype: int, sel: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """-> (theta, center, target_center): corrected poses move as
    p' = target_center + R(theta) (p - center).

    point:         translate the clicked point onto the anchor point
    line-to-line:  rotate A onto B about cmA, then translate cmA -> cmB
    corner:        rotate A onto B about the drag-start vertex
    colinear:      same rotation; cmA translates to its projection on B
    perpendicular: rotate so A is perpendicular to B, about cmA
    parallel:      rotate A parallel to B, about cmA
    Types outside 1..6 clamp to the nearest, as the reference's switch does.
    """
    cmA, cmB, A, B = _seg_dirs(sel)
    theta_ab = _signed_angle(A, B)
    branch = min(max(int(ctype), 1), 6)
    if branch == CorrectionType.POINT:
        return torch.zeros_like(theta_ab), sel[0], sel[2]
    if branch == CorrectionType.LINE_SEGMENT:
        return theta_ab, cmA, cmB
    if branch == CorrectionType.CORNER:
        return theta_ab, sel[0], sel[2]
    if branch == CorrectionType.COLINEAR:
        alpha = torch.sum((cmA - cmB) * B)
        return theta_ab, cmA, cmB + alpha * B
    if branch == CorrectionType.PERPENDICULAR:
        # already perpendicular -> 0; otherwise rotate by theta -/+ pi/2
        t = theta_ab
        half_pi = math.pi / 2
        t = torch.where(
            torch.abs(torch.abs(t) - half_pi) < 1e-7,
            torch.zeros_like(t),
            torch.where(t > 0.0, t - half_pi, t + half_pi),
        )
        return t, cmA, cmA
    return theta_ab, cmA, cmA   # PARALLEL


def apply_explicit(poses: Tensor, ctype: int, sel: Tensor, group_mask: Tensor,
                   last_pose: Tensor) -> tuple[Tensor, Tensor]:
    """Apply the rigid correction to the first contiguous corrected group
    and carry the tail.

    Returns (new_poses [P,3], correction C [3] = the group-first pose's
    delta, which backprop consumes)."""
    theta, center, target = correction_transform(ctype, sel)
    p = poses[:, :2]
    moved = target + rotate(theta, p - center)
    T = moved - p                              # per-pose translation delta

    idx = torch.arange(poses.shape[0], device=poses.device)
    affected = group_mask | (idx > last_pose)  # group + rigid tail carry
    new_xy = torch.where(affected[:, None], p + T, p)
    new_th = torch.where(affected, poses[:, 2] + theta, poses[:, 2])

    first_idx = torch.argmax(group_mask.to(torch.int32))
    # index_select: indexing with a 0-dim tensor reads it back to the host
    C = torch.cat([torch.index_select(T, 0, first_idx.reshape(1))[0],
                   theta[None]])
    return torch.cat([new_xy, new_th[:, None]], dim=1), C


def constraint_deltas(poses: Tensor, sel: Tensor, anchor_idx: Tensor,
                      corr_idx: Tensor
                      ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Per-(anchor, corrected) pair offsets in the anchor frame.

    anchor_idx [MA], corr_idx [MC] int32 (pad -1). Returns (delta_parallel,
    delta_perpendicular, delta_angle, penalty_dir, valid), each [MA, MC]."""
    corr_dir = sel[3] - sel[2]
    corr_angle = torch.atan2(corr_dir[1], corr_dir[0])

    a_valid = anchor_idx >= 0
    c_valid = corr_idx >= 0
    a = poses[torch.clamp(anchor_idx, min=0).long()]      # [MA,3]
    c = poses[torch.clamp(corr_idx, min=0).long()]        # [MC,3]

    ath = a[:, 2]
    pen = angle_mod(corr_angle - ath) + math.pi / 2.0      # [MA]
    para = torch.stack([torch.cos(ath), torch.sin(ath)], -1)
    perp = torch.stack([-para[:, 1], para[:, 0]], -1)

    rel = c[None, :, :2] - a[:, None, :2]                  # [MA,MC,2]
    dpar = torch.einsum("ak,ack->ac", para, rel)
    dperp = torch.einsum("ak,ack->ac", perp, rel)
    dth = angle_mod(c[None, :, 2] - ath[:, None])
    valid = a_valid[:, None] & c_valid[None, :]
    pen2 = pen[:, None].expand(dpar.shape)
    return dpar, dperp, dth, pen2, valid
