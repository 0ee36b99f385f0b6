"""EM interpretation of the human's sketched corrections: the endpoint refit.

Port of the device half of hitl_slam_tpu/models/hitl/em_input.py:

  - `endpoint_adjust_batch`: the repeat-until-stable loop over {gather
    inliers within 0.03 m, 1-parameter orientation re-fit about the fixed
    midpoint}, for all segments at once, with converged segments frozen;
  - `_segfit_theta`: 25 reduced Gauss-Newton steps on the exact clamped
    point-to-segment objective, with no sqrt or division per point.

The loop reads one flag from the device per round (the reference's
`lax.while_loop` condition).
"""

from __future__ import annotations

import torch

from ...ops.geometry import dist_to_segment, norm2

Tensor = torch.Tensor

VERIFY_THRESHOLD = 0.05     # m
INLIER_THRESHOLD = 0.03     # m
ENDPOINT_STABLE = 0.05      # m
MIN_POSE_INLIERS = 5        # strictly-greater gate
SEGFIT_ITERS = 25
MAX_ADJUST_ROUNDS = 32      # safety bound on the outer loop


def _segfit_theta(pts: Tensor, w: Tensor, cm: Tensor, half_len: Tensor,
                  theta0: Tensor) -> Tensor:
    """25 Newton steps on theta for the fixed-center, fixed-length segment
    fit, minimizing sum_i w_i dist(p_i, seg(theta))^2 with
    seg(theta) = [cm - L a, cm + L a], a = (cos theta, sin theta).

    Batched over leading dims: pts [M, 2], w [..., M], cm [..., 2],
    half_len [...], theta0 [...]. With t = rel.a, perp = rel.n,
    tc = clip(t, -L, L): gradient sum -perp*tc, curvature sum |t*tc|.
    Weights (in {0, 1}) fold in by pre-zeroing rel.
    """
    relw = (pts - cm[..., None, :]) * w[..., None]     # [..., M, 2]
    rx, ry = relw[..., 0], relw[..., 1]
    lo, hi = -half_len[..., None], half_len[..., None]
    theta = theta0
    for _ in range(SEGFIT_ITERS):
        c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
        t = rx * c + ry * s           # rel . a
        perp = ry * c - rx * s        # rel . n
        tc = torch.minimum(torch.maximum(t, lo), hi)
        num = torch.sum(-perp * tc, dim=-1)
        den = torch.sum(torch.abs(t * tc), dim=-1)
        theta = theta - num / torch.clamp(den, min=1e-9)
    return theta


def endpoint_adjust_batch(world_pts: Tensor, mask: Tensor, segs: Tensor) -> Tensor:
    """Refit S segments segs=[S,2,2] against the map until each segment's
    endpoints move less than 0.05 m (or MAX_ADJUST_ROUNDS rounds). Returns
    the refit [S, 2, 2] endpoints."""
    flat = world_pts.reshape(-1, 2)
    fmask = mask.reshape(-1)
    dtype = segs.dtype
    S = segs.shape[0]
    s = segs
    moved = torch.full((S,), float("inf"), dtype=dtype, device=segs.device)
    for _ in range(MAX_ADJUST_ROUNDS):
        active = moved > ENDPOINT_STABLE               # [S]
        if not bool(torch.any(active)):
            break
        p1, p2 = s[:, 0], s[:, 1]                       # [S,2]
        d = dist_to_segment(p1[:, None], p2[:, None], flat[None])  # [S,M]
        w = (fmask[None] & (d < INLIER_THRESHOLD)).to(dtype)
        cm = 0.5 * (p1 + p2)
        delta = p1 - p2            # axis oriented cm -> p1
        half_len = 0.5 * norm2(delta)
        theta0 = torch.atan2(delta[:, 1], delta[:, 0])
        theta = _segfit_theta(flat, w, cm, half_len, theta0)
        a = torch.stack([torch.cos(theta), torch.sin(theta)], -1)  # [S,2]
        new1 = cm + half_len[:, None] * a
        new2 = cm - half_len[:, None] * a
        moved_now = torch.maximum(norm2(new1 - p1), norm2(new2 - p2))
        new_s = torch.stack([new1, new2], dim=1)
        s = torch.where(active[:, None, None], new_s, s)
        moved = torch.where(active, moved_now, torch.zeros_like(moved_now))
    return s
