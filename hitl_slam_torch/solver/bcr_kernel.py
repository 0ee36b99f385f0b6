"""Wrapper of the CUDA block-cyclic-reduction kernel (csrc/bcr.cu).

The kernel replaces hitl_slam_tpu/solver/pallas_bcr.py::bcr_solve_pallas:
it solves the whole symmetric block-tridiagonal LM system, with its state
in shared memory. Its plain version is solver/tridiag.py::bcr_solve, which
this wrapper runs for CPU tensors only; a CUDA tensor launches the kernel or
raises.

The route follows from n alone (`launch_plan`), over m = next_pow2(n) lanes
of 51 floats in shared memory: up to 1024 lanes in one block, m = 2048 ..
16384 as a thread-block cluster of m / 1024 blocks, both one launch. Above
16384 lanes the top log2(m / 16384) levels run first over device memory (a
few many-block launches), then the cluster of 16 solves the rest. Above
2^25 lanes there is no route, and the wrapper raises.

`bcr_solve_cuda_batched` solves B stacked systems of the same n with the
same route and the same number of launches, the batch in the grid's second
dimension: each system's x is bit-equal to a lone launch on it. Its plain
version is tridiag.bcr_solve with a leading batch dimension. One batched
call counts one launch on `batched_launches`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from ..utils import cuda_build
from . import tridiag

Tensor = torch.Tensor

# bcr.cu: kMaxLanesPerBlock, kMaxCluster, kMaxLanes, kMaxThreads, kPlanes
MAX_LANES_PER_BLOCK = 1024
MAX_CLUSTER = 16
MAX_SHARED_LANES = MAX_LANES_PER_BLOCK * MAX_CLUSTER
MAX_LANES = 1 << 25
MAX_THREADS = 512
# floats a lane keeps: D (then Dinv), L, U, b (then x), and an eliminated
# lane's Dinv L, Dinv U, Dinv b
LANE_FLOATS = 51
# bcr.cu kStride: floats a shared-memory plane holds; lane i at i + i // 32
PLANE_STRIDE = MAX_LANES_PER_BLOCK + MAX_LANES_PER_BLOCK // 32

launches = cuda_build.LaunchCounter("bcr_solve")
batched_launches = cuda_build.LaunchCounter("bcr_solve_batched")
# gridDim.y of the batched launches
MAX_BATCH = 65535


@dataclass(frozen=True)
class LaunchPlan:
    n: int
    m: int                 # lanes: next_pow2(n)
    top: int               # levels run in device memory before shared memory
    lanes_per_block: int   # a power of two
    blocks: int            # (m >> top) // lanes_per_block; > 1: a cluster
    threads: int
    smem_bytes: int        # dynamic shared memory per block

    @property
    def route(self) -> str:
        if self.top:
            return "levels+cluster"
        return "cluster" if self.blocks > 1 else "block"

    @property
    def state_floats(self) -> int:
        """Device memory the top levels of one system work in (0 without
        top levels)."""
        return self.m * LANE_FLOATS if self.top else 0

    def lanes(self, block: int) -> range:
        """The lanes of m that block `block` holds in its shared memory:
        every 2^top-th one; the others are eliminated in device memory, lane
        g at level (number of trailing zeros of g) + 1 <= top."""
        step = 1 << self.top
        return range(block * self.lanes_per_block * step,
                     (block + 1) * self.lanes_per_block * step, step)


@lru_cache(maxsize=64)
def launch_plan(n: int) -> LaunchPlan:
    """The kernel's route for an n-pose system; raises where none exists."""
    if n < 1:
        raise ValueError("bcr_solve: empty system")
    m = tridiag.next_pow2(n)
    if m > MAX_LANES:
        raise ValueError(f"bcr_solve: n = {n} needs {m} lanes; the kernel "
                         f"indexes at most {MAX_LANES} with int32 offsets")
    top = max(0, (m // MAX_SHARED_LANES).bit_length() - 1)
    tail = m >> top
    lanes = min(tail, MAX_LANES_PER_BLOCK)
    threads = max(32, min(MAX_THREADS, lanes // 2))
    return LaunchPlan(n, m, top, lanes, tail // lanes, threads,
                      LANE_FLOATS * PLANE_STRIDE * 4)


def launch(D: Tensor, U: Tensor, b: Tensor, plan: LaunchPlan,
           batch: int | None = None) -> Tensor:
    """One solve with `plan` on validated CUDA tensors: of one system, or
    with `batch` of that many stacked systems (the batched entry)."""
    lead = () if batch is None else (batch,)
    x = torch.empty((*lead, plan.n, 3), dtype=torch.float32, device=D.device)
    state = (torch.empty(((batch or 1) * plan.state_floats,),
                         dtype=torch.float32, device=D.device)
             if plan.top else None)
    args = (plan.n, plan.m, plan.lanes_per_block.bit_length() - 1, plan.top,
            plan.threads, plan.smem_bytes,
            torch.cuda.current_stream(D.device).cuda_stream)
    ptrs = (D.data_ptr(), U.data_ptr(), b.data_ptr(), x.data_ptr(),
            None if state is None else state.data_ptr())
    lib = cuda_build.library()
    # the launch goes to the current device: the tensors' (a mesh spreads a
    # solve over several cards)
    with torch.cuda.device(D.device):
        if batch is None:
            code = lib.hitl_bcr_solve(*ptrs, *args)
            cuda_build.check(code, "bcr_solve")
            launches.count += 1
        else:
            code = lib.hitl_bcr_solve_batched(*ptrs, batch, *args)
            cuda_build.check(code, "bcr_solve_batched")
            batched_launches.count += 1
    return x


def check_inputs(D: Tensor, U: Tensor, b: Tensor,
                 batched: bool = False) -> tuple[int, ...]:
    """Validate the kernel's inputs; return n, or (B, n) when `batched`."""
    what = "bcr_solve_batched" if batched else "bcr_solve"
    dev = D.device
    if dev.type != "cuda":
        raise ValueError(f"{what}_cuda needs CUDA tensors, got {dev}")
    if D.dim() != (4 if batched else 3):
        raise ValueError(f"{what}: D must be {'[B, ' if batched else '['}"
                         f"n, 3, 3], got {tuple(D.shape)}")
    lead = tuple(D.shape[:-3])
    n = D.shape[-3]
    if batched and not 1 <= lead[0] <= MAX_BATCH:
        raise ValueError(f"{what}: B = {lead[0]} outside [1, {MAX_BATCH}]")
    f32 = torch.float32
    cuda_build.require(what, "D", D, (*lead, n, 3, 3), f32, dev)
    cuda_build.require(what, "U", U, (*lead, max(n - 1, 0), 3, 3), f32, dev)
    cuda_build.require(what, "b", b, (*lead, n, 3), f32, dev)
    return (*lead, n) if batched else n


def bcr_solve_cuda(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Launch the kernel: D [n,3,3], U [n-1,3,3], b [n,3] f32 CUDA -> x."""
    return launch(D, U, b, launch_plan(check_inputs(D, U, b)))


def bcr_solve_cuda_batched(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Launch the kernel once for B stacked systems: D [B,n,3,3],
    U [B,n-1,3,3], b [B,n,3] f32 CUDA -> x [B,n,3]."""
    batch, n = check_inputs(D, U, b, batched=True)
    return launch(D, U, b, launch_plan(n), batch)


def bcr_solve(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Same signature and semantics as tridiag.bcr_solve, one system or a
    batch [B, n, ...]: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if D.device.type == "cpu":
        return tridiag.bcr_solve(D, U, b)
    if D.device.type == "cuda":
        D, U, b = D.contiguous(), U.contiguous(), b.contiguous()
        if D.dim() == 4:
            return bcr_solve_cuda_batched(D, U, b)
        return bcr_solve_cuda(D, U, b)
    raise ValueError(f"bcr_solve: unsupported device {D.device}")
