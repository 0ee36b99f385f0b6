"""The EM selection sweep: wrapper of the CUDA kernel (csrc/em_scan.cu) and
its plain torch version.

Replaces hitl_slam_tpu/ops/pallas_em.py::em_scan. One pass over the padded
point map computes everything the verification and EM stages need:

  - per-pose inlier counts against both selected segments: masked points
    whose squared point-to-segment distance is < inlier_threshold**2;
  - the global minimum squared distance from each of the 4 clicked points
    to any masked map point (masked-out points count as 1e30).

`em_scan_reference` transcribes pallas_em.py:40-62 operation by operation
(it compares the SQUARED distance with the squared threshold, unlike
em_input's observation counts, which take a sqrt first), so on the card the
kernel's counts are exact and its minima bit-equal to it.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build

Tensor = torch.Tensor

BIG = 1e30

launches = cuda_build.LaunchCounter("em_scan")


def _threshold2(inlier_threshold: float, device) -> Tensor:
    # the squared threshold is formed in double precision, then rounded to
    # f32 once, as the reference does with its Python-float threshold
    return torch.tensor(inlier_threshold ** 2, dtype=torch.float32,
                        device=device)


def _seg_dist2(x: Tensor, y: Tensor, x1: Tensor, y1: Tensor, x2: Tensor,
               y2: Tensor) -> Tensor:
    dx = x2 - x1
    dy = y2 - y1
    denom = torch.clamp(dx * dx + dy * dy, min=1e-20)
    t = ((x - x1) * dx + (y - y1) * dy) / denom
    t = torch.clamp(t, 0.0, 1.0)
    px = x1 + t * dx
    py = y1 + t * dy
    ex = x - px
    ey = y - py
    return ex * ex + ey * ey


def em_scan_reference(world: Tensor, mask: Tensor, sel: Tensor,
                      inlier_threshold: float = 0.03
                      ) -> tuple[Tensor, Tensor]:
    """Plain torch version: -> (counts [P, 2] int32, min_d2 [4])."""
    x = world[..., 0]
    y = world[..., 1]
    m = mask.bool()
    t2 = _threshold2(inlier_threshold, world.device)
    d2a = _seg_dist2(x, y, sel[0, 0], sel[0, 1], sel[1, 0], sel[1, 1])
    d2b = _seg_dist2(x, y, sel[2, 0], sel[2, 1], sel[3, 0], sel[3, 1])
    ca = ((d2a < t2) & m).sum(dim=1, dtype=torch.int32)
    cb = ((d2b < t2) & m).sum(dim=1, dtype=torch.int32)
    counts = torch.stack([ca, cb], dim=1)
    big = torch.tensor(BIG, dtype=world.dtype, device=world.device)
    mins = []
    for k in range(4):
        ex = x - sel[k, 0]
        ey = y - sel[k, 1]
        d2 = torch.where(m, ex * ex + ey * ey, big)
        mins.append(torch.min(d2))
    return counts, torch.stack(mins)


def em_scan_cuda(world: Tensor, mask: Tensor, sel: Tensor,
                 inlier_threshold: float = 0.03) -> tuple[Tensor, Tensor]:
    """Launch the kernel on CUDA tensors: world [P,N,2] f32, mask [P,N]
    bool, sel [4,2] f32, all contiguous on one device."""
    dev = world.device
    if dev.type != "cuda":
        raise ValueError(f"em_scan_cuda needs CUDA tensors, got {dev}")
    if world.dim() != 3:
        raise ValueError(f"em_scan: world must be [P, N, 2], got {tuple(world.shape)}")
    P, N = world.shape[0], world.shape[1]
    cuda_build.require("em_scan", "world", world, (P, N, 2), torch.float32, dev)
    cuda_build.require("em_scan", "mask", mask, (P, N), torch.bool, dev)
    cuda_build.require("em_scan", "sel", sel, (4, 2), torch.float32, dev)
    if world.data_ptr() % 8:
        raise ValueError("em_scan: world must be 8-byte aligned (float2 loads)")
    lib = cuda_build.library()
    counts = torch.empty((P, 2), dtype=torch.int32, device=dev)
    min_d2 = torch.full((4,), BIG, dtype=torch.float32, device=dev)
    t2 = float(_threshold2(inlier_threshold, "cpu"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.hitl_em_scan(world.data_ptr(), mask.data_ptr(), sel.data_ptr(),
                            t2, P, N, counts.data_ptr(), min_d2.data_ptr(),
                            stream)
    cuda_build.check(code, "em_scan")
    launches.count += 1
    return counts, min_d2


def em_scan(world: Tensor, mask: Tensor, sel: Tensor,
            inlier_threshold: float = 0.03) -> tuple[Tensor, Tensor]:
    """-> (counts [P, 2] int32, min_d2 [4]): the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if world.device.type == "cpu":
        return em_scan_reference(world, mask, sel, inlier_threshold)
    if world.device.type == "cuda":
        return em_scan_cuda(world.contiguous(), mask.contiguous(),
                            sel.contiguous(), inlier_threshold)
    raise ValueError(f"em_scan: unsupported device {world.device}")
