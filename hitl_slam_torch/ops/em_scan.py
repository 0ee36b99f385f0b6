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

import struct
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from functools import lru_cache

import torch

from ..utils import cuda_build

Tensor = torch.Tensor

BIG = 1e30
THREADS = 256         # em_scan.cu kThreads: 8 warps a block
WARP = 32
CHUNK = 4             # points a lane reads at once: two float4 + one mask word

launches = cuda_build.LaunchCounter("em_scan")


def threshold2(inlier_threshold: float) -> float:
    """The squared threshold, formed in double precision and rounded to f32
    once, as the reference does with its Python-float threshold."""
    return struct.unpack("f", struct.pack("f", inlier_threshold ** 2))[0]


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
    t2 = torch.full((), threshold2(inlier_threshold), dtype=torch.float32,
                    device=world.device)
    d2a = _seg_dist2(x, y, sel[0, 0], sel[0, 1], sel[1, 0], sel[1, 1])
    d2b = _seg_dist2(x, y, sel[2, 0], sel[2, 1], sel[3, 0], sel[3, 1])
    ca = ((d2a < t2) & m).sum(dim=1, dtype=torch.int32)
    cb = ((d2b < t2) & m).sum(dim=1, dtype=torch.int32)
    counts = torch.stack([ca, cb], dim=1)
    big = torch.full((), BIG, dtype=world.dtype, device=world.device)
    mins = []
    for k in range(4):
        ex = x - sel[k, 0]
        ey = y - sel[k, 1]
        d2 = torch.where(m, ex * ex + ey * ey, big)
        mins.append(torch.min(d2))
    return counts, torch.stack(mins)


# ------------------------------------------------------------ launch plan

def row_chunks(p: int, N: int) -> range:
    """The 4-point chunks that row p of a [P, N] map spans. Chunks sit on
    multiples of 4 of the flat point index p*N + j (em_scan.cu), so a chunk
    is two aligned float4 loads and one mask word; a chunk that a row only
    partly covers is read point by point."""
    q0 = p * N
    return range(q0 // CHUNK, (q0 + N + CHUNK - 1) // CHUNK)


@dataclass(frozen=True)
class EmScanPlan:
    P: int
    N: int
    lanes_per_pose: int    # a power of two <= 32
    poses_per_block: int
    blocks: int

    def poses(self, block: int) -> range:
        first = block * self.poses_per_block
        return range(first, min(first + self.poses_per_block, self.P))


@lru_cache(maxsize=64)
def launch_plan(P: int, N: int) -> EmScanPlan:
    """Lanes per pose: enough for one chunk each (up to a warp); a block of
    8 warps holds 8 * 32 / lanes poses; at least one block, which writes
    the minima (1e30) even when P = 0."""
    if P < 0 or N < 0:
        raise ValueError(f"em_scan: bad map shape [{P}, {N}]")
    # p*N mod 4 repeats with period 4 in p: rows 0..3 cover every offset
    most = max((len(row_chunks(p, N)) for p in range(min(P, CHUNK))),
               default=0)
    lanes = 1
    while lanes < min(most, WARP):
        lanes *= 2
    per_block = (THREADS // WARP) * (WARP // lanes)
    return EmScanPlan(P, N, lanes, per_block, max(1, -(-P // per_block)))


# ------------------------------------------------------------ the kernel

# one ticket counter for each (device index, stream): the kernel's blocks
# draw tickets from it and the last one sets it back to 0, so it is zeroed
# once, when the stream first calls; launches on one stream run in turn. A
# launch captured into a CUDA graph draws from the ticket of its program
# (`capture_ticket`), made outside the capture: one made inside would live
# in the graph's memory, and its zeroing would be part of every replay
_tickets: dict = {}
_capture = threading.local()


def _ticket(dev: torch.device, stream: int) -> Tensor:
    if torch.cuda.is_current_stream_capturing():
        t = getattr(_capture, "ticket", None)
        if t is None:
            raise RuntimeError("em_scan: a launch captured into a CUDA graph "
                               "needs a ticket made before the capture "
                               "(em_scan.capture_ticket)")
        return t
    key = (dev.index, stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return t


def new_ticket(device) -> Tensor:
    """A ticket counter for one program's captured launches."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


@contextmanager
def capture_ticket(ticket: Tensor):
    """Launches captured on this thread inside the block draw from
    `ticket` (from `new_ticket`); the program's replays run one at a time."""
    prev = getattr(_capture, "ticket", None)
    _capture.ticket = ticket
    try:
        yield
    finally:
        _capture.ticket = prev


def em_scan_cuda(world: Tensor, mask: Tensor, sel: Tensor,
                 inlier_threshold: float = 0.03) -> tuple[Tensor, Tensor]:
    """Launch the kernel on CUDA tensors: world [P,N,2] f32, mask [P,N]
    bool, sel [4,2] f32, all contiguous on one device; world 16-byte and
    mask 4-byte aligned."""
    dev = world.device
    if dev.type != "cuda":
        raise ValueError(f"em_scan_cuda needs CUDA tensors, got {dev}")
    if world.dim() != 3:
        raise ValueError(f"em_scan: world must be [P, N, 2], got {tuple(world.shape)}")
    P, N = world.shape[0], world.shape[1]
    cuda_build.require("em_scan", "world", world, (P, N, 2), torch.float32, dev)
    cuda_build.require("em_scan", "mask", mask, (P, N), torch.bool, dev)
    cuda_build.require("em_scan", "sel", sel, (4, 2), torch.float32, dev)
    if world.numel() and (world.data_ptr() % 16 or mask.data_ptr() % 4):
        raise ValueError("em_scan: world must be 16-byte and mask 4-byte "
                         "aligned (float4 and mask-word loads)")
    plan = launch_plan(P, N)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # one buffer, 16-byte aligned: each block's 4 minima, min_d2 [4],
    # counts [P, 2]
    rows = 4 * plan.blocks
    out = torch.empty((rows + 4 + 2 * P,), dtype=torch.int32, device=dev)
    min_d2 = out[rows:rows + 4].view(torch.float32)
    counts = out[rows + 4:].view(P, 2)
    code = cuda_build.library().hitl_em_scan(
        world.data_ptr(), mask.data_ptr(), sel.data_ptr(),
        threshold2(inlier_threshold), P, N, plan.lanes_per_pose, plan.blocks,
        counts.data_ptr(), min_d2.data_ptr(), out.data_ptr(),
        _ticket(dev, stream).data_ptr(), stream)
    cuda_build.check(code, "em_scan")
    launches.bump(dev)
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
