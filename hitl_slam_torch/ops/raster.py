"""Headless map rasterization on the device.

Port of hitl_slam_tpu/ops/raster.py. Points and polylines are scattered into
an RGB framebuffer (coordinate transform -> pixel indices -> per-channel
scatter-max), so a re-render after a solve stays on the device. Also the
factor-adjacency ("information matrix") image written after a solve.

Where several points of different colours land on one pixel, each channel
keeps its maximum: an integer `scatter_reduce_("amax")`, which gives the
same image whatever order the writes land in.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _unpack_color(col: int) -> tuple[int, int, int]:
    return ((col >> 16) & 0xFF, (col >> 8) & 0xFF, col & 0xFF)


def rasterize_points(
    pts: Tensor,          # [N, 2] world coords
    mask: Tensor,         # [N] bool
    colors: Tensor,       # [N, 3] uint8
    origin: Tensor,       # [2] world coords of pixel (0, 0)
    scale: Tensor,        # pixels per meter
    height: int = 1024,
    width: int = 1024,
) -> Tensor:
    """Scatter masked points into an RGB image [H, W, 3] (uint8).

    y axis points up (world) -> row 0 is the top of the image. Pixel indices
    are cast (truncated toward zero), as in the reference.
    """
    px = ((pts[:, 0] - origin[0]) * scale).to(torch.int32)
    py = (height - 1 - (pts[:, 1] - origin[1]) * scale).to(torch.int32)
    ok = mask & (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pixel = torch.where(ok, py.long() * width + px.long(), 0)
    col = torch.where(ok[:, None], colors.to(torch.int32), 0)
    idx = (pixel[:, None] * 3
           + torch.arange(3, device=pts.device)).reshape(-1)
    # channel-wise max in int32 (an integer max has no order dependence)
    img = torch.zeros((height * width * 3,), dtype=torch.int32,
                      device=pts.device)
    img.scatter_reduce_(0, idx, col.reshape(-1), "amax", include_self=True)
    return img.to(torch.uint8).view(height, width, 3)


def rasterize_lines(
    p1: Tensor,           # [L, 2]
    p2: Tensor,           # [L, 2]
    mask: Tensor,         # [L]
    colors: Tensor,       # [L, 3] uint8
    origin: Tensor,
    scale: Tensor,
    height: int = 1024,
    width: int = 1024,
    samples: int = 256,
) -> Tensor:
    """Sample each segment at `samples` points and scatter (static shapes)."""
    t = torch.linspace(0.0, 1.0, samples, dtype=p1.dtype,
                       device=p1.device)[None, :, None]
    pts = p1[:, None, :] + t * (p2 - p1)[:, None, :]        # [L, S, 2]
    pts = pts.reshape(-1, 2)
    m = mask[:, None].expand(mask.shape[0], samples).reshape(-1)
    c = colors[:, None, :].expand(colors.shape[0], samples, 3).reshape(-1, 3)
    return rasterize_points(pts, m, c, origin, scale, height, width)


def compose(*layers: Tensor) -> Tensor:
    """Pixelwise max-composite of RGB layers."""
    out = layers[0]
    for layer in layers[1:]:
        out = torch.maximum(out, layer)
    return out


def render_map(
    world_points: Tensor,   # [P, N, 2]
    point_mask: Tensor,     # [P, N]
    poses: Tensor,          # [P, 3]
    height: int = 1024,
    width: int = 1024,
    margin: float = 1.0,
    point_color: int = 0xDE2352,
    trajectory_color: int = 0x6B6B6B,
) -> Tensor:
    """Full map render: scans + trajectory polyline. Returns [H, W, 3] u8.

    The fit (origin and scale) is computed on the device from the data
    bounds.
    """
    dev = world_points.device
    flat = world_points.reshape(-1, 2)
    fmask = point_mask.reshape(-1)
    big = torch.where(fmask[:, None], flat, float("-inf"))
    small = torch.where(fmask[:, None], flat, float("inf"))
    lo = torch.minimum(small.amin(0), poses[:, :2].amin(0))
    hi = torch.maximum(big.amax(0), poses[:, :2].amax(0))
    lo = lo - margin
    hi = hi + margin
    scale = torch.min(
        torch.tensor([width, height], dtype=torch.float32, device=dev)
        / (hi - lo).clamp(min=1e-6))

    pc = torch.tensor(_unpack_color(point_color), dtype=torch.uint8,
                      device=dev).expand(flat.shape[0], 3)
    img_pts = rasterize_points(flat, fmask, pc, lo, scale, height, width)

    p1 = poses[:-1, :2]
    p2 = poses[1:, :2]
    lmask = torch.ones(p1.shape[0], dtype=torch.bool, device=dev)
    lc = torch.tensor(_unpack_color(trajectory_color), dtype=torch.uint8,
                      device=dev).expand(p1.shape[0], 3)
    img_traj = rasterize_lines(p1, p2, lmask, lc, lo, scale, height, width,
                               samples=64)
    return compose(img_pts, img_traj)


def info_matrix_image(num_poses_arr: Tensor, anchor: Tensor,
                      constrained: Tensor, active: Tensor) -> Tensor:
    """[P, P] uint8 factor-adjacency image: 255 where poses share a factor
    (odometry band + human constraint pairs). `num_poses_arr` is any tensor
    with P entries along its first axis."""
    P = num_poses_arr.shape[0]
    dev = anchor.device
    # one spare slot at the end takes the writes of inactive rows
    img = torch.zeros((P * P + 1,), dtype=torch.uint8, device=dev)
    i = torch.arange(P - 1, device=dev)
    img[i * P + i + 1] = 255
    img[(i + 1) * P + i] = 255
    a, c = anchor.long(), constrained.long()
    img[torch.where(active, a * P + c, P * P)] = 255
    img[torch.where(active, c * P + a, P * P)] = 255
    return img[:-1].view(P, P)
