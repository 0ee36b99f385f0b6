"""One round of the EM endpoint refit: the CUDA kernel (csrc/em_refit.cu)
and its plain version.

models/hitl/em_input.py::endpoint_adjust_batch refits S sketched segments
against the map until no endpoint moves more than ENDPOINT_STABLE: a
`device_while` whose carry is the endpoints s [S, 2, 2], how far each
moved in the last round, `moved` [S], and the loop's `go`. A round, for
each active stroke (moved > ENDPOINT_STABLE):

  1. its inliers: the masked slots within INLIER_THRESHOLD of it, by
     dist_to_segment;
  2. its midpoint cm, half length and start angle;
  3. SEGFIT_ITERS Newton steps on the angle about cm over the inliers
     (`segfit_theta`);
  4. the new endpoints and how far they moved; an inactive stroke keeps
     its endpoints and moves 0; go = any(moved > ENDPOINT_STABLE).

`round_body` gives the round as device_while's body, in place on the
carry: on the CPU the plain version, `round_reference`, the loop's body as
it was before the kernel, op for op; on a CUDA tensor one launch of the
kernel, or it raises (nothing falls back). Every slot that is not an
inlier adds an exact zero to the plain version's sums, so the kernel sums
over the inliers alone: only the order of the sums' non-zero terms differs
(tests/test_torch_em_refit.py holds the kernel to the plain version within
1e-5 m on the card, and checks that exactness on the CPU).

The kernel's launch shape follows from P*N alone (`launch_plan`): a
thread-block cluster of one block for each SLOTS_PER_BLOCK slots, up to 16.
Where its Newton steps read the inliers from follows from their count,
read on the device: each block's share in shared memory while the shares
fit there, else the L2-resident scratch (`scratch`, sized for every slot
an inlier, so that no count overflows it). The kernel writes each active
stroke's inlier count and that route (an index into ROUTES) to `stats`
[S, 2] int32 on the device, where a caller gives one; nothing reads it in
a correction's path.

`launches` counts one a launch on a card without marking the stage clock
(cuda_build.LaunchCounter): the cycle's edge em_refit -> em_refit stays
one refit round. Only the correction cycle runs the refit; the refine,
EnML and the LM do not.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable

import torch

from ..utils import cuda_build
from .geometry import dist_to_segment, norm2

Tensor = torch.Tensor

INLIER_THRESHOLD = 0.03     # m
ENDPOINT_STABLE = 0.05      # m
SEGFIT_ITERS = 25

# em_refit.cu: kMaxCluster, kMaxStrokes, kGroup (the slots a warp tests at
# once, two a lane), kMaxSlots
MAX_CLUSTER = 16
MAX_STROKES = 2
GROUP = 64
MAX_SLOTS = 1 << 30
# the slots a block takes before the launch spreads over a cluster
SLOTS_PER_BLOCK = 8192
# where the kernel's Newton steps read the inliers from (its stats)
ROUTES = ("shared", "scratch")

launches = cuda_build.LaunchCounter("em_refit", mark=False)


@dataclass(frozen=True)
class LaunchPlan:
    M: int
    blocks: int    # the thread-block cluster's


@lru_cache(maxsize=64)
def launch_plan(M: int) -> LaunchPlan:
    """The kernel's launch for M point slots: a cluster of a block for
    each SLOTS_PER_BLOCK of them, up to MAX_CLUSTER. Raises where the
    kernel takes no such map."""
    if not 1 <= M <= MAX_SLOTS:
        raise ValueError(f"em_refit: {M} slots outside [1, {MAX_SLOTS}]")
    return LaunchPlan(M, min(MAX_CLUSTER, -(-M // SLOTS_PER_BLOCK)))


# ------------------------------------------------------------ plain version

def segfit_theta(pts: Tensor, w: Tensor, cm: Tensor, half_len: Tensor,
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


def round_reference(flat: Tensor, fmask: Tensor, s: Tensor, moved: Tensor,
                    go: Tensor) -> None:
    """One round of the carry (s [S, 2, 2], moved [S], go) in place, over
    the map's slots flat [M, 2] and fmask [M]: the plain version."""
    dtype = s.dtype
    active = moved > ENDPOINT_STABLE               # [S]
    p1, p2 = s[:, 0], s[:, 1]                       # [S,2]
    d = dist_to_segment(p1[:, None], p2[:, None], flat[None])  # [S,M]
    w = (fmask[None] & (d < INLIER_THRESHOLD)).to(dtype)
    cm = 0.5 * (p1 + p2)
    delta = p1 - p2            # axis oriented cm -> p1
    half_len = 0.5 * norm2(delta)
    theta0 = torch.atan2(delta[:, 1], delta[:, 0])
    theta = segfit_theta(flat, w, cm, half_len, theta0)
    a = torch.stack([torch.cos(theta), torch.sin(theta)], -1)  # [S,2]
    new1 = cm + half_len[:, None] * a
    new2 = cm - half_len[:, None] * a
    moved_now = torch.maximum(norm2(new1 - p1), norm2(new2 - p2))
    new_s = torch.stack([new1, new2], dim=1)
    s.copy_(torch.where(active[:, None, None], new_s, s))
    moved.copy_(torch.where(active, moved_now,
                            torch.zeros_like(moved_now)))
    go.copy_(torch.any(moved > ENDPOINT_STABLE))


# ------------------------------------------------------------ the kernel

def scratch(M: int, S: int, device) -> tuple[Tensor, Tensor]:
    """The kernel's scratch for M slots and S strokes, sized for every slot
    an inlier: each 64-slot group's two ballots a stroke [S, groups, 2]
    int32, and each stroke's inliers less its midpoint [S, M, 2] f32."""
    return (torch.empty((S, -(-M // GROUP), 2), dtype=torch.int32,
                        device=device),
            torch.empty((S, M, 2), dtype=torch.float32, device=device))


def round_cuda(flat: Tensor, fmask: Tensor, s: Tensor, moved: Tensor,
               go: Tensor, stats: Tensor | None,
               buffers: tuple[Tensor, Tensor]) -> None:
    """One round on a card: one launch on the carry, with the scratch
    `buffers` (`scratch`'s). Everything the kernel does not take raises
    ValueError before anything launches, CPU tensors last."""
    dev = flat.device
    M, S = flat.shape[0], s.shape[0]
    plan = launch_plan(M)
    if not 1 <= S <= MAX_STROKES:
        raise ValueError(f"em_refit: {S} strokes outside [1, {MAX_STROKES}]")
    f32 = torch.float32
    req = cuda_build.require
    req("em_refit", "flat", flat, (M, 2), f32, dev)
    req("em_refit", "fmask", fmask, (M,), torch.bool, dev)
    req("em_refit", "s", s, (S, 2, 2), f32, dev)
    req("em_refit", "moved", moved, (S,), f32, dev)
    req("em_refit", "go", go, (), torch.bool, dev)
    if stats is not None:
        req("em_refit", "stats", stats, (S, 2), torch.int32, dev)
    bits, rel = buffers
    req("em_refit", "bits", bits, (S, -(-M // GROUP), 2), torch.int32, dev)
    req("em_refit", "rel", rel, (S, M, 2), f32, dev)
    if flat.data_ptr() % 16 or fmask.data_ptr() % 2:
        raise ValueError("em_refit: flat must be 16-byte and fmask 2-byte "
                         "aligned (float4 and mask-pair loads)")
    if dev.type != "cuda":
        raise ValueError(f"em_refit: round_cuda needs CUDA tensors, got {dev}")
    tensors = (flat, fmask, s, moved, go, stats, bits, rel)
    ptrs = (ctypes.c_void_p * len(tensors))(*(
        None if t is None else t.data_ptr() for t in tensors))
    fparams = (ctypes.c_float * 2)(INLIER_THRESHOLD, ENDPOINT_STABLE)
    iparams = (ctypes.c_int * 4)(M, S, SEGFIT_ITERS, plan.blocks)
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        code = lib.hitl_em_refit(
            ptrs, fparams, iparams, torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(code, "em_refit")
        launches.bump(dev)


# ------------------------------------------------------------ entry point

def round_body(flat: Tensor, fmask: Tensor, s: Tensor, moved: Tensor,
               go: Tensor, stats: Tensor | None = None) -> Callable[[], None]:
    """One round of the carry (s, moved, go) in place, as device_while's
    body: the plain version for CPU tensors (`stats` left as it is), the
    kernel for CUDA tensors, its scratch made here, before the loop (in
    the capture's memory when captured)."""
    if flat.device.type == "cpu":
        return lambda: round_reference(flat, fmask, s, moved, go)
    if flat.device.type != "cuda":
        raise ValueError(f"em_refit: unsupported device {flat.device}")
    flat, fmask = flat.contiguous(), fmask.contiguous()
    buffers = scratch(flat.shape[0], s.shape[0], flat.device)
    return lambda: round_cuda(flat, fmask, s, moved, go, stats, buffers)
