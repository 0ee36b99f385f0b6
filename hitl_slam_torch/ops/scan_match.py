"""Correlative scan matching.

Port of hitl_slam_tpu/ops/scan_match.py. Olson-style correlative matching:
the map becomes a Gaussian-likelihood raster; the query scan becomes a
sparse 0/1 raster per candidate rotation; the score of every candidate
translation is then exactly a 2D cross-correlation of the two. The full
(theta, dx, dy) search volume is scored at once and reduced with one argmax.

Both functions take a leading batch dimension on every argument (B
independent fields and scans, what the reference does with `vmap`).

The scan raster holds at most N cells out of K x K, so the scores are
computed as a sum of N shifted W x W windows of the field
(`correlate_gather`) and not as the reference's dense `conv2d` over K x K
kernels. The two sum in different orders and agree to f32 round-off.

Uses: global relocalization, loop-closure proposals.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .geometry import f32_reciprocal

Tensor = torch.Tensor


@dataclass(frozen=True)
class ScanMatchParams:
    resolution: float = 0.05      # m / cell
    window: float = 1.0           # +- translation search (m)
    angle_window: float = 0.35    # +- rotation search (rad)
    num_angles: int = 29          # rotation candidates
    sigma: float = 0.1            # map likelihood smoothing (m)
    map_extent: float = 14.0      # half-extent of the local map raster (m)


def _gaussian_kernel(sigma_cells: float, dtype, device) -> Tensor:
    r = max(1, int(3 * sigma_cells))
    x = torch.arange(-r, r + 1, dtype=dtype, device=device)
    g = torch.exp(-0.5 * (x / sigma_cells) ** 2)
    return g / torch.sum(g)


def build_likelihood_field(
    map_pts: Tensor,     # [M, 2] world-frame map points, or [B, M, 2]
    map_mask: Tensor,    # [M], or [B, M]
    center: Tensor,      # [2] raster center (world), or [B, 2]
    params: ScanMatchParams = ScanMatchParams(),
) -> Tensor:
    """[H, H] (or [B, H, H]) Gaussian-blurred occupancy raster around
    `center`, scaled to a maximum of 1."""
    p = params
    batched = map_pts.dim() == 3
    if not batched:
        map_pts, map_mask, center = map_pts[None], map_mask[None], center[None]
    B = map_pts.shape[0]
    H = int(2 * p.map_extent / p.resolution)
    # truncation toward zero, as the reference casts: a coordinate in
    # (-1, 0) lands in cell 0
    ij = ((map_pts - (center - p.map_extent)[:, None, :])
          * f32_reciprocal(p.resolution)).to(torch.int32)
    ok = (map_mask & (ij[..., 0] >= 0) & (ij[..., 0] < H)
          & (ij[..., 1] >= 0) & (ij[..., 1] < H))
    # every written value is 1.0, so a plain indexed write is the
    # reference's scatter-max; points outside go to a spare last slot
    b_idx = torch.arange(B, device=map_pts.device)[:, None]
    flat = (b_idx * H + ij[..., 1].long()) * H + ij[..., 0].long()
    flat = torch.where(ok, flat, B * H * H)
    grid = torch.zeros((B * H * H + 1,), dtype=map_pts.dtype,
                       device=map_pts.device)
    grid[flat.reshape(-1)] = 1.0
    grid4 = grid[:-1].view(B, 1, H, H)
    # separable Gaussian blur as two 1-D correlations
    g = _gaussian_kernel(p.sigma / p.resolution, map_pts.dtype,
                         map_pts.device)
    k = g.shape[0]
    blurred = F.conv2d(grid4, g.view(1, 1, 1, k), padding=(0, k // 2))
    blurred = F.conv2d(blurred, g.view(1, 1, k, 1), padding=(k // 2, 0))
    out = blurred[:, 0]
    out = out / out.amax(dim=(1, 2), keepdim=True).clamp(min=1e-9)
    return out if batched else out[0]


def correlate_gather(field: Tensor, ki: Tensor, kj: Tensor, ok: Tensor,
                     W: int) -> Tensor:
    """scores[b, t, r, c] = sum over the distinct occupied cells (kj, ki) of
    rotation t of field[b, r + kj, c + ki]: [B, T, W, W].
    field [B, H, H]; ki, kj [B, T, N] int cells; ok [B, T, N] bool."""
    B, T, N = ki.shape
    # a cell that several points fall into counts once (the raster is 0/1)
    cell = kj * (field.shape[1]) + ki
    same = (cell[..., :, None] == cell[..., None, :]) & ok[..., None, :]
    earlier = torch.ones((N, N), dtype=torch.bool,
                         device=field.device).tril(-1)
    weight = (ok & ~(same & earlier).any(-1)).to(field.dtype)
    # windows[b, i, j] is the W x W block of field[b] with corner (i, j)
    windows = field.unfold(1, W, 1).unfold(2, W, 1)          # [B, K, K, W, W]
    b_idx = torch.arange(B, device=field.device)[:, None, None]
    scores = torch.empty((B, T, W, W), dtype=field.dtype, device=field.device)
    # a few rotations at a time: at most 2^26 gathered elements alive
    step = max(1, 2 ** 26 // (B * N * W * W))
    for t in range(0, T, step):
        win = windows[b_idx, kj[:, t:t + step].long(),
                      ki[:, t:t + step].long()]              # [B, t, N, W, W]
        scores[:, t:t + step] = (
            win * weight[:, t:t + step, :, None, None]).sum(2)
    return scores


def correlative_match(
    field: Tensor,       # [H, H] likelihood raster, or [B, H, H]
    center: Tensor,      # [2] its world center, or [B, 2]
    scan_pts: Tensor,    # [N, 2] robot-frame query scan, or [B, N, 2]
    scan_mask: Tensor,   # [N], or [B, N]
    pose_guess: Tensor,  # [3] initial (x, y, theta), or [B, 3]
    params: ScanMatchParams = ScanMatchParams(),
) -> tuple[Tensor, Tensor, Tensor]:
    """-> (pose [3], score, ambiguity): the (theta, dx, dy) in the search
    window around `pose_guess` maximizing scan/map correlation. `ambiguity`
    is the ratio of the best score outside a 0.3 m translation ball around
    the winner to the winning score (1.0 = a second equally good alignment
    exists, e.g. a wrong but parallel wall; near 0 = unambiguous). With a
    batch dimension: ([B, 3], [B], [B])."""
    p = params
    batched = field.dim() == 3
    if not batched:
        field, center, scan_pts, scan_mask, pose_guess = (
            field[None], center[None], scan_pts[None], scan_mask[None],
            pose_guess[None])
    B, H, _ = field.shape
    W = (int(2 * p.window / p.resolution) | 1)   # odd translation window
    # Olson's construction: the kernel is the full-extent scan raster; the
    # valid cross-correlation output then scores exactly the W x W candidate
    # translations centered on the field center. Requires K = H - W + 1.
    K = H - W + 1
    if K < 3:
        raise ValueError("translation window larger than the map raster")
    T = p.num_angles
    dtype, dev = field.dtype, field.device

    angles = pose_guess[:, 2:3] + torch.linspace(
        -p.angle_window, p.angle_window, T, dtype=dtype, device=dev)  # [B, T]
    c, s = torch.cos(angles)[..., None], torch.sin(angles)[..., None]
    # scan offsets from the robot for each candidate rotation [B, T, N]
    x, y = scan_pts[:, None, :, 0], scan_pts[:, None, :, 1]
    rx = c * x - s * y
    ry = s * x + c * y

    # cells of the [K, K] kernels centered on the robot (floor, not a cast)
    kc = (K - 1) / 2.0
    inv_res = f32_reciprocal(p.resolution)
    ki = torch.floor(rx * inv_res + kc).to(torch.int32)
    kj = torch.floor(ry * inv_res + kc).to(torch.int32)
    ok = (scan_mask[:, None, :] & (ki >= 0) & (ki < K) & (kj >= 0) & (kj < K))
    ki = torch.where(ok, ki, 0)
    kj = torch.where(ok, kj, 0)

    scores = correlate_gather(field, ki, kj, ok, W)

    flat = scores.reshape(B, -1)
    top, best = torch.max(flat, dim=1)           # first index on ties
    bt = best // (W * W)
    brc = best % (W * W)
    br = brc // W
    bc = brc % W
    # output (br, bc) places the robot at field cell (br + kc, bc + kc);
    # cell (H-1)/2 is the field center's world position
    half_field = (H - 1) / 2.0
    bx = center[:, 0] + (bc.to(dtype) + kc - half_field) * p.resolution
    by = center[:, 1] + (br.to(dtype) + kc - half_field) * p.resolution
    pose = torch.stack([bx, by, torch.gather(angles, 1, bt[:, None])[:, 0]],
                       dim=-1)
    n_valid = scan_mask.to(dtype).sum(1).clamp(min=1.0)

    # second peak outside a 0.3 m translation ball around the winner (over
    # all rotations): detects aliasing onto parallel structure
    r_sup = 0.3 / p.resolution
    rr = torch.arange(W, dtype=dtype, device=dev)
    far = ((rr[None, :, None] - br.to(dtype)[:, None, None]) ** 2
           + (rr[None, None, :] - bc.to(dtype)[:, None, None]) ** 2
           ) > r_sup * r_sup
    second = torch.where(far[:, None], scores,
                         float("-inf")).amax(dim=(1, 2, 3))
    ambiguity = second / top.clamp(min=1e-9)
    score = top / n_valid
    if not batched:
        return pose[0], score[0], ambiguity[0]
    return pose, score, ambiguity
