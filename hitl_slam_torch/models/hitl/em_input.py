"""EM interpretation of the human's sketched corrections.

Port of hitl_slam_tpu/models/hitl/em_input.py:

  - `verify_input`: the 0.05 m proximity check of every clicked point
    against the world-frame map (the plain twin of em_scan's minima);
  - `endpoint_adjust_batch` / `endpoint_adjust`: the repeat-until-stable
    loop over {gather inliers within 0.03 m, 1-parameter orientation re-fit
    about the fixed midpoint}, for all segments at once, with converged
    segments frozen;
  - `_segfit_theta`: 25 reduced Gauss-Newton steps on the exact clamped
    point-to-segment objective, with no sqrt or division per point;
  - `observation_counts`: per-pose inlier counts of the two refit
    selections by point-to-segment distance (a sqrt against 0.03 m, where
    em_scan compares squared distances);
  - `order_and_filter`: the host (numpy) ordering and filtering of the two
    pose sets, the twin of ordering.py::order_on_device.

The refit loop reads one flag from the device per round (the reference's
`lax.while_loop` condition).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...ops.geometry import dist_to_segment, norm2

Tensor = torch.Tensor

VERIFY_THRESHOLD = 0.05     # m
INLIER_THRESHOLD = 0.03     # m
ENDPOINT_STABLE = 0.05      # m
MIN_POSE_INLIERS = 5        # strictly-greater gate
SEGFIT_ITERS = 25
MAX_ADJUST_ROUNDS = 32      # safety bound on the outer loop


def verify_input(world_pts: Tensor, mask: Tensor, selected: Tensor) -> Tensor:
    """For each of the K selected points, is some map point within 0.05 m?

    world_pts: [P, N, 2], mask: [P, N], selected: [K, 2] -> [K] bool.
    """
    d2 = torch.sum((world_pts[None] - selected[:, None, None, :]) ** 2,
                   dim=-1)                                   # [K, P, N]
    d2 = torch.where(mask[None], d2, torch.full_like(d2, float("inf")))
    return torch.amin(d2, dim=(1, 2)) < VERIFY_THRESHOLD ** 2


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


def endpoint_adjust(world_pts: Tensor, mask: Tensor, seg: Tensor) -> Tensor:
    """One segment [2, 2]: endpoint_adjust_batch of a batch of one."""
    return endpoint_adjust_batch(world_pts, mask, seg[None])[0]


def observation_counts(world_pts: Tensor, mask: Tensor, sel: Tensor
                       ) -> tuple[Tensor, Tensor]:
    """Per-pose inlier counts against the two refit selections.

    world_pts [P,N,2], sel [4,2] -> (count_first [P], count_second [P]).
    """
    d1 = dist_to_segment(sel[0], sel[1], world_pts)
    d2 = dist_to_segment(sel[2], sel[3], world_pts)
    c1 = torch.sum((d1 < INLIER_THRESHOLD) & mask, dim=1, dtype=torch.int32)
    c2 = torch.sum((d2 < INLIER_THRESHOLD) & mask, dim=1, dtype=torch.int32)
    return c1, c2


@dataclass
class OrderedSelection:
    """Host-side result of order_and_filter."""

    corrected_poses: np.ndarray   # ascending pose ids (first selection)
    anchor_poses: np.ndarray      # ascending pose ids (second selection)
    selected_points: np.ndarray   # [4,2], possibly swapped so anchors second
    backprop_start: int
    backprop_end: int

    @property
    def valid(self) -> bool:
        return self.backprop_start >= 0 and self.backprop_end >= 1


def order_and_filter(count_first: np.ndarray, count_second: np.ndarray,
                     selected: np.ndarray) -> OrderedSelection:
    """The ordering and filtering of the two selections' pose sets:

    - participation gate: count > 5;
    - overlap poses are removed from one or both sides;
    - if the first selection covers LATER poses than the second, it is the
      corrected set and the second anchors; otherwise the roles (and the
      selected-point pairs) are swapped;
    - backprop bounds = the open interval between the anchors' max and the
      corrected set's min.
    """
    first = np.nonzero(count_first > MIN_POSE_INLIERS)[0]
    second = np.nonzero(count_second > MIN_POSE_INLIERS)[0]
    sel = selected.copy()

    invalid = OrderedSelection(first, second, sel, -1, -1)
    if len(first) == 0 or len(second) == 0:
        return invalid

    overlap = np.intersect1d(first, second)
    if len(overlap) == len(first) and len(overlap) == len(second):
        return invalid  # complete overlap
    elif len(overlap) == len(first):
        second = np.setdiff1d(second, overlap)
    elif len(overlap) == len(second):
        first = np.setdiff1d(first, overlap)
    elif len(overlap) > 0:
        first = np.setdiff1d(first, overlap)
        second = np.setdiff1d(second, overlap)

    if len(first) == 0 or len(second) == 0:
        return invalid

    if first.min() > second.max():
        corrected, anchors = first, second
        bp = (int(second.max()) + 1, int(first.min()) - 1)
    elif first.max() < second.min():
        # drawn in the other order: swap the pairs' roles
        sel = np.concatenate([selected[2:4], selected[0:2]], axis=0)
        corrected, anchors = second, first
        bp = (int(first.max()) + 1, int(second.min()) - 1)
    else:
        return invalid  # interleaved selections

    return OrderedSelection(corrected, anchors, sel, bp[0], bp[1])
