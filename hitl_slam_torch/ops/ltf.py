"""Long-term-feature (LTF) factors: scan-to-vector-map localization.

Port of hitl_slam_tpu/ops/ltf.py. Points a known vector map explains are
long-term features, constrained to the map by point-to-line factors:

  - `match_segments`: the nearest map segment within a threshold for every
    world point, from one [N, S] distance matrix (maps hold O(100)
    segments; no spatial index);
  - `localize_against_map`: point-to-line Gauss-Newton over one pose, or
    over a leading batch of poses where the reference vmaps it.

Every function broadcasts over leading dims of the points.
"""

from __future__ import annotations

import torch

from .geometry import norm2, perp, rotate

Tensor = torch.Tensor

LTF_STD_DEV = 0.05                 # kLaserStdDev
LTF_CORRELATION = 1.0 / 40.0       # point_correlation_factor


def point_segment_geometry(segs: Tensor, pts: Tensor):
    """segs [S, 4], pts [..., N, 2] -> (dist [..., N, S], normal [S, 2],
    t [..., N, S])."""
    a = segs[:, 0:2]
    d = segs[:, 2:4] - a
    denom = torch.clamp(torch.sum(d * d, -1), min=1e-12)
    t = ((pts[..., :, None, :] - a) * d).sum(-1) / denom
    tc = torch.clamp(t, 0.0, 1.0)
    proj = a + tc[..., None] * d
    dist = norm2(pts[..., :, None, :] - proj)
    n = perp(d / torch.sqrt(denom)[:, None])
    return dist, n, t


def match_segments(segs: Tensor, world_pts: Tensor, mask: Tensor,
                   threshold: float = 0.25) -> tuple[Tensor, Tensor]:
    """Nearest map segment per point -> (seg_idx [..., N] int32,
    valid [..., N])."""
    dist, _, t = point_segment_geometry(segs, world_pts)
    # only interior projections count as line evidence (a point-to-LINE
    # factor has no endpoint pull)
    interior = (t >= 0.0) & (t <= 1.0)
    dist = torch.where(interior, dist, torch.inf)
    best, idx = torch.min(dist, dim=-1)
    return idx.to(torch.int32), mask & (best < threshold)


def _ltf_system(segs, pts, pose, seg_idx, valid, w):
    """GN normal equations of each pose's point-to-line factors:
    pts [..., N, 2], pose [..., 3] -> (H [..., 3, 3], g [..., 3], cost [...])."""
    th = pose[..., 2:3]
    world = rotate(th, pts) + pose[..., None, :2]
    idx = seg_idx.long()
    a = segs[idx, 0:2]
    d = segs[idx, 2:4] - a
    n = perp(d / torch.clamp(norm2(d), min=1e-12)[..., None])
    r = torch.sum(n * (world - a), -1) * w          # signed line distance
    r = torch.where(valid, r, 0.0)
    # d world / d pose = [I | perp(R p)]
    dth = perp(rotate(th, pts))
    J = torch.cat([n, torch.sum(n * dth, -1)[..., None]], -1) * w
    J = torch.where(valid[..., None], J, 0.0)
    H = J.mT @ J
    g = (J.mT @ r[..., None])[..., 0]
    cost = 0.5 * torch.sum(r * r, -1)
    return H, g, cost


def localize_against_map(
    segs: Tensor,        # [S, 4] vector map (world frame)
    pts: Tensor,         # [..., N, 2] robot-frame scan(s)
    mask: Tensor,        # [..., N]
    pose0: Tensor,       # [..., 3] initial pose(s)
    iterations: int = 10,
    rematch_every: int = 3,
    threshold: float = 0.25,
    damping: float = 1e-3,
) -> tuple[Tensor, Tensor, Tensor]:
    """Refine pose(s) against the vector map. Returns (pose, cost,
    num_inliers), each with pose0's leading dims. A leading batch dim on
    pts, mask and pose0 takes the place of the reference's vmap."""
    w = LTF_CORRELATION / LTF_STD_DEV
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)

    pose = pose0
    seg_idx = torch.zeros(mask.shape, dtype=torch.int32, device=pts.device)
    valid = torch.zeros_like(mask)
    cost = torch.zeros(pose0.shape[:-1], dtype=pts.dtype, device=pts.device)
    for it in range(iterations):
        if it % rematch_every == 0:
            world = rotate(pose[..., 2:3], pts) + pose[..., None, :2]
            seg_idx, valid = match_segments(segs, world, mask, threshold)
        H, g, cost = _ltf_system(segs, pts, pose, seg_idx, valid, w)
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        Hd = H + damping * eye * torch.clamp(tr, min=1.0)[..., None, None]
        # no info check on the host: a singular system gives non-finite
        # steps, as the reference's solve does, instead of a raise
        step = torch.linalg.solve_ex(Hd, -g)[0]
        pose = pose + step
    return pose, cost, torch.sum(valid, -1)
