"""Truncated signed-distance field (TSDF) of a map.

Port of hitl_slam_tpu/ops/sdf.py, a projective TSDF: every scan is binned by
bearing once (all poses in one pass), and each pixel gathers the
interpolated beam range at its own bearing, one O(HW) pass per scan, pose
after pose in the map's order (the running weighted mean's f32 rounding
depends on that order, so it is kept): a `device_for` over a pose index
held on the device, so that on a CUDA device build_sdf replays one
captured program, as the reference's jitted `lax.scan`. Weight/value semantics: truncation to
[min_sdf_value, max_sdf_value], exponential weight exp(-sigma (d - eps)^2)
with the maximum weight inside eps, running weighted mean, and the
T_dynamic * max-weight binarized mask used to filter dynamic objects.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device_loop import (DeviceProgram, ProgramCache, device_for,
                                 replays)
from .geometry import f32_reciprocal

Tensor = torch.Tensor


@dataclass(frozen=True)
class SdfParams:
    image_resolution: float = 0.04   # m / pixel
    min_sdf_weight: float = 0.01
    max_sdf_weight: float = 1.0
    min_sdf_value: float = -0.2
    max_sdf_value: float = 0.2
    image_border: float = 0.3
    eps: float = 0.02
    sigma: float = 0.02
    t_dynamic: float = 0.2
    num_bearing_bins: int = 1024
    max_range: float = 12.0


@dataclass(frozen=True)
class SdfImage:
    values: Tensor    # [H, W] f32
    weights: Tensor   # [H, W] f32
    origin: Tensor    # [2] world coords of pixel (0, 0) (col, row=y-up grid)
    resolution: Tensor  # scalar


# (bearing + pi) / (2 pi) as the reference's compiled program does it: a
# multiplication by the f32 reciprocal of the constant
_INV_TWO_PI = f32_reciprocal(2 * math.pi)


def _bin_scans(pts: Tensor, mask: Tensor, nbins: int,
               max_range: float) -> Tensor:
    """[P, nbins] per-bearing-bin minimum range of each robot-frame scan
    (inf where a bin saw nothing). pts [P, N, 2], mask [P, N]."""
    P = pts.shape[0]
    r = torch.sqrt(torch.sum(pts * pts, -1))
    bearing = torch.atan2(pts[..., 1], pts[..., 0])
    # a cast (truncation), then the modulus
    b = ((bearing + math.pi) * _INV_TWO_PI * nbins).to(torch.int32) % nbins
    valid = mask & (r > 1e-3) & (r < max_range)
    row = torch.arange(P, device=pts.device)[:, None] * nbins
    idx = torch.where(valid, b.long(), 0) + row
    ranges = torch.full((P * nbins,), float("inf"), dtype=pts.dtype,
                        device=pts.device)
    # a true minimum over repeated bins; exact, so in any order
    ranges.scatter_reduce_(
        0, idx.reshape(-1),
        torch.where(valid, r, float("inf")).reshape(-1), "amin",
        include_self=True)
    return ranges.view(P, nbins)


def build_sdf(
    poses: Tensor,        # [P, 3]
    points: Tensor,       # [P, N, 2] robot frame
    point_mask: Tensor,   # [P, N]
    origin: Tensor,       # [2] world coords of pixel (0,0)
    height: int,
    width: int,
    params: SdfParams = SdfParams(),
    *,
    eager: bool = False,
) -> SdfImage:
    """The TSDF of the map, one `device_for` over the poses in the map's
    order (the reference's `lax.scan`). On a CUDA device a replay of the
    shape's program (one CUDA graph, one WHILE node; `sdf_program`),
    unless `eager`, which runs the same code eagerly there, for
    comparisons only."""
    if replays(poses, eager):
        return sdf_program(poses, points, height, width, params).run(
            poses, points, point_mask, origin)
    return _build_sdf(poses, points, point_mask, origin, height, width,
                      params)


def _build_sdf(poses, points, point_mask, origin, height: int, width: int,
               p: SdfParams) -> SdfImage:
    """build_sdf's pose loop, eager or captured: a trip reads pose k and
    its binned ranges at the device index k and updates the running mean
    in place, in the reference's order of operations."""
    res = p.image_resolution
    nbins = p.num_bearing_bins
    dtype, dev = poses.dtype, poses.device
    gx = origin[0] + res * torch.arange(width, dtype=dtype, device=dev)
    gy = origin[1] + res * torch.arange(height, dtype=dtype, device=dev)
    pix_x = gx[None, :].expand(height, width)
    pix_y = gy[:, None].expand(height, width)
    all_ranges = _bin_scans(points, point_mask, nbins, p.max_range)

    values = torch.zeros((height, width), dtype=dtype, device=dev)
    weights = torch.zeros((height, width), dtype=dtype, device=dev)

    def pose_update(k):
        k1 = k.reshape(1)
        pose = poses.index_select(0, k1)[0]
        ranges = all_ranges.index_select(0, k1)[0]
        dx = pix_x - pose[0]
        dy = pix_y - pose[1]
        r_pix = torch.sqrt(dx * dx + dy * dy)
        bearing = torch.atan2(dy, dx) - pose[2]
        bearing = torch.atan2(torch.sin(bearing), torch.cos(bearing))
        fb = (bearing + math.pi) * _INV_TWO_PI * nbins
        fb_floor = torch.floor(fb)
        b0 = fb_floor.to(torch.int32) % nbins
        b1 = (b0 + 1) % nbins
        r0 = ranges[b0.long()]
        r1 = ranges[b1.long()]
        both = torch.isfinite(r0) & torch.isfinite(r1)
        frac = fb - fb_floor
        beam = torch.where(both, (1 - frac) * r0 + frac * r1,
                           torch.minimum(r0, r1))   # one-sided fallback

        sdf = beam - r_pix                          # + free space, - behind
        tsdf = sdf.clamp(max=p.max_sdf_value)
        w = torch.where(
            tsdf.abs() <= p.eps,
            p.max_sdf_weight,
            torch.exp(-p.sigma * (tsdf - p.eps) ** 2),
        )
        update = (
            torch.isfinite(beam)
            & (sdf >= p.min_sdf_value)
            & (r_pix < p.max_range)
        )
        w = torch.where(update, w, 0.0)
        values.copy_((values * weights + w * torch.where(update, tsdf, 0.0))
                     / ((weights + w).clamp(min=1e-12)))
        weights.add_(w)

    device_for(poses.shape[0], pose_update, dev, name="pose")
    # never-observed pixels read min_sdf_value ("behind surface"), not the
    # accumulator's 0 / eps = 0 ("at surface")
    values = torch.where(weights > 0, values, p.min_sdf_value)
    # a fill, not a copy from the host, so that a capture may hold it
    resolution = torch.full((), res, dtype=dtype, device=dev)
    return SdfImage(values=values, weights=weights, origin=origin,
                    resolution=resolution)


# build_sdf's programs: a new map shape is a new capture, a curator's
# repeat on one map reuses its program
_programs = ProgramCache(size=2)


def sdf_program(poses: Tensor, points: Tensor, height: int, width: int,
                params: SdfParams = SdfParams()) -> DeviceProgram:
    """The program build_sdf replays for a map of poses [P, 3] and points
    [P, N, 2] (on a CUDA device), this image size and these parameters:
    run(poses, points, point_mask, origin) -> SdfImage. The one made
    before, or a new one, captured at its first run."""
    P, N = points.shape[:2]
    dev, dtype = poses.device, poses.dtype
    example = (torch.empty((P, 3), dtype=dtype),
               torch.empty((P, N, 2), dtype=dtype),
               torch.empty((P, N), dtype=torch.bool),
               torch.empty((2,), dtype=dtype))

    def fn(poses, points, point_mask, origin):
        return _build_sdf(poses, points, point_mask, origin, height, width,
                          params)

    return _programs.get(
        (P, N, dtype, height, width, params, dev.type, dev.index),
        lambda: DeviceProgram(fn, example, dev, name="sdf"))


def dynamic_mask(sdf: SdfImage, params: SdfParams = SdfParams()) -> Tensor:
    """[H, W] bool: static-world pixels (weights above T_dynamic * max)."""
    return sdf.weights > params.t_dynamic * torch.max(sdf.weights)


def filter_points(
    sdf: SdfImage,
    world_pts: Tensor,     # [..., 2]
    mask: Tensor,          # [...]
    params: SdfParams = SdfParams(),
) -> Tensor:
    """Keep points that fall on static, near-surface pixels of the SDF: the
    curator's dynamic-object filter. Returns the refined mask."""
    ok_static = dynamic_mask(sdf, params)
    # casts (truncation toward zero), as in the reference
    col = ((world_pts[..., 0] - sdf.origin[0]) / sdf.resolution
           ).to(torch.int32)
    row = ((world_pts[..., 1] - sdf.origin[1]) / sdf.resolution
           ).to(torch.int32)
    H, W = sdf.values.shape
    inb = (col >= 0) & (col < W) & (row >= 0) & (row < H)
    colc = col.clamp(0, W - 1).long()
    rowc = row.clamp(0, H - 1).long()
    near_surface = sdf.values[rowc, colc].abs() < params.eps * 4
    return mask & inb & ok_static[rowc, colc] & near_surface


def sdf_bounds(world_pts: Tensor, mask: Tensor, border: float):
    """(lo, hi) f32 numpy corners of the box covering the masked points plus
    `border`, reduced on the points' device and read to the host once."""
    pts = world_pts.reshape(-1, 2)
    m = mask.reshape(-1, 1)
    lo = torch.where(m, pts, float("inf")).amin(0) - border
    hi = torch.where(m, pts, float("-inf")).amax(0) + border
    both = torch.stack([lo, hi]).cpu().numpy().astype(np.float32)
    return both[0], both[1]
