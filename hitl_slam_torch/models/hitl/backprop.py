"""COP-SLAM-style covariance-weighted error backpropagation, O(P).

Port of hitl_slam_tpu/models/hitl/backprop.py: the reference's O(W^2)
nested rotate-the-rest loops close under prefix sums, so the rotation stage
is two cumsums and the translation stage a third, with the window
[bp_min, bp_max] expressed as masks (no host read of the bounds).

  rot_sigma_i   = cov[i][2,2]
  trans_sigma_i = (cov[i][0,0] + cov[i][1,1]) / 2
  weights       = sigma_i / (sum over window + destination variance)
  destination variances: rot 1e-4, trans 1e-3
  beta blend uses sigma[bp_max - 1]
The covariance update scales the symmetric pairs (0,2),(2,0),(1,2),(2,1)
once each, as the JAX package does.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

DEST_ROT_VARIANCE = 1e-4    # rad^2
DEST_TRANS_VARIANCE = 1e-3  # m^2


def _rot(phi: Tensor, v: Tensor) -> Tensor:
    c, s = torch.cos(phi), torch.sin(phi)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def _row(t: Tensor, i: Tensor) -> Tensor:
    """t[i] for a 0-dim index tensor, negative indices wrapping as Python's
    do, read on the device (indexing with a 0-dim tensor reads the index
    back to the host)."""
    return torch.index_select(t, 0, torch.remainder(i, t.shape[0])
                              .reshape(1))[0]


def backprop(poses: Tensor, covariances: Tensor, correction: Tensor,
             bp_min: Tensor, bp_max: Tensor) -> tuple[Tensor, Tensor]:
    """correction [3] = (dx, dy, dtheta); bp_min/bp_max scalar int tensors.
    Returns (new_poses, new_covariances); a no-op when bp_min >= bp_max."""
    P = poses.shape[0]
    idx = torch.arange(P, device=poses.device)
    in_window = (idx >= bp_min) & (idx <= bp_max)       # [min, max]
    weight_mask = (idx >= bp_min) & (idx < bp_max)      # i in [min, max)
    zero = torch.zeros((), dtype=poses.dtype, device=poses.device)

    rot_sigma = covariances[:, 2, 2]
    trans_sigma = 0.5 * (covariances[:, 0, 0] + covariances[:, 1, 1])

    sum_rot = torch.sum(torch.where(in_window, rot_sigma, zero)) + DEST_ROT_VARIANCE
    sum_trans = (torch.sum(torch.where(in_window, trans_sigma, zero))
                 + DEST_TRANS_VARIANCE)
    w_rot = torch.where(weight_mask, rot_sigma / sum_rot, zero)
    w_trans = torch.where(weight_mask, trans_sigma / sum_trans, zero)

    # ---- covariance scaling (applied to poses [min, max)) ----
    prev = torch.clamp(bp_max - 1, min=0).long()
    rot_beta = 1.0 / (1.0 + _row(rot_sigma, prev) / DEST_ROT_VARIANCE)
    trans_beta = 1.0 / (1.0 + _row(trans_sigma, prev) / DEST_TRANS_VARIANCE)
    one = torch.ones((), dtype=poses.dtype, device=poses.device)
    scale = torch.stack([
        torch.stack([trans_beta, trans_beta, rot_beta]),
        torch.stack([trans_beta, trans_beta, rot_beta]),
        torch.stack([rot_beta, rot_beta, rot_beta]),
    ]) * one
    new_cov = torch.where(weight_mask[:, None, None],
                          covariances * scale[None], covariances)

    # ---- rotation stage: A_i.R = R(cumsum(dtheta)_i), and
    # A_i.b - A_{i-1}.b = (I - R(dtheta_i)) R(Theta_{i-1}) p_i ----
    dtheta = w_rot * correction[2]                      # [P], zero outside
    xy = poses[:, :2]

    theta_inc = torch.cumsum(dtheta, 0)                 # Theta_i
    theta_pre = theta_inc - dtheta                      # Theta_{i-1}
    rot_pre_p = _rot(theta_pre, xy)                     # R(Theta_{i-1}) p_i
    b_inc = rot_pre_p - _rot(dtheta, rot_pre_p)
    bs = torch.cumsum(b_inc, 0) - b_inc                 # A_{k-1}.b
    new_xy = torch.where(in_window[:, None], _rot(theta_pre, xy) + bs, xy)
    own = torch.where(weight_mask, dtheta, zero)        # own increment
    ang_inc = theta_pre + own
    new_th = torch.where(in_window, poses[:, 2] + ang_inc, poses[:, 2])

    # ---- translation stage ----
    bmax = bp_max.long()
    destination = _row(xy, bmax) + correction[:2]
    trans = destination - _row(new_xy, bmax)
    dtrans = w_trans[:, None] * trans[None]             # [P,2]
    t_prefix = torch.cumsum(dtrans, 0) - dtrans         # sum_{i<k}
    new_xy = torch.where(in_window[:, None], new_xy + t_prefix, new_xy)

    new_poses = torch.cat([new_xy, new_th[:, None]], dim=1)
    valid = bp_min < bp_max
    return (
        torch.where(valid, new_poses, poses),
        torch.where(valid, new_cov, covariances),
    )
