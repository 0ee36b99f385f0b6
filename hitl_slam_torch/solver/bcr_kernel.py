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

`bcr_solve_cuda_multi` (the multi route, `hitl_bcr_solve_multi`) solves S
systems of the same n, each against R <= 8 right-hand sides, in one launch
(more only on the levels route): a block or a cluster a system factors it
once, and its R columns run beside the factorization on threads of their
own. A lane holds 27 floats of matrices and 3 a column, so a block holds
1024 lanes at every R and the routes are the lone route's; a cluster
spreads over more, smaller blocks. D, U and b may have any system stride
(the SPIKE hands it a view of U), the rest of a system contiguous.
Its plain version `bcr_solve_multi_reference` runs each column through
tridiag.bcr_solve; each column of the kernel's x follows a lone launch's
arithmetic. One call counts one launch on `multi_launches`.
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
multi_launches = cuda_build.LaunchCounter("bcr_solve_multi")
# gridDim.y of the batched and multi launches
MAX_BATCH = 65535

# the multi route, bcr.cu kMaxRhs: a lane there holds D, L, U and 3 floats
# a right-hand side, laid out for PLANE_STRIDE lanes as the lone route's
MAX_RHS = 8
MULTI_MATRIX_FLOATS = 27
# the fewest lanes a block of a multi-route cluster holds
MULTI_MIN_LANES = 256


def multi_floats(rhs: int) -> int:
    """Floats a lane of the multi route holds at `rhs` right-hand sides."""
    return MULTI_MATRIX_FLOATS + 3 * rhs


@dataclass(frozen=True)
class LaunchPlan:
    n: int
    m: int                 # lanes: next_pow2(n)
    top: int               # levels run in device memory before shared memory
    lanes_per_block: int   # a power of two
    blocks: int            # (m >> top) // lanes_per_block; > 1: a cluster
    threads: int
    smem_bytes: int        # dynamic shared memory per block
    rhs: int = 1           # right-hand sides a system; 1: the lone plan

    @property
    def route(self) -> str:
        if self.top:
            return "levels+cluster"
        return "cluster" if self.blocks > 1 else "block"

    @property
    def lane_floats(self) -> int:
        """Floats a lane takes in the top levels' state (the multi route at
        R = 1 uses 30 of the lone layout's 51)."""
        return LANE_FLOATS if self.rhs == 1 else multi_floats(self.rhs)

    @property
    def state_floats(self) -> int:
        """Device memory the top levels of one system work in (0 without
        top levels)."""
        return self.m * self.lane_floats if self.top else 0

    def lanes(self, block: int) -> range:
        """The lanes of m that block `block` holds in its shared memory:
        every 2^top-th one; the others are eliminated in device memory, lane
        g at level (number of trailing zeros of g) + 1 <= top."""
        step = 1 << self.top
        return range(block * self.lanes_per_block * step,
                     (block + 1) * self.lanes_per_block * step, step)


@lru_cache(maxsize=64)
def launch_plan(n: int, rhs: int = 1) -> LaunchPlan:
    """The kernel's route for an n-pose system against `rhs` right-hand
    sides; raises where none exists. The routes follow from n alone; rhs =
    1 is the lone and batched routes' plan (the multi route takes it as
    well), 2 <= rhs <= MAX_RHS the multi route's. There a cluster spreads
    its lanes over as many blocks as it may, of at least MULTI_MIN_LANES
    lanes (its wide levels carry R columns a lane, and a cluster's syncs
    cost the same whatever its size), and a block has R + 1 warps (a deep
    level's matrix warp and its columns side by side), or a thread for
    each even lane of the first level where that is more."""
    if not 1 <= rhs <= MAX_RHS:
        raise ValueError(f"bcr_solve: {rhs} right-hand sides outside "
                         f"[1, {MAX_RHS}]")
    if n < 1:
        raise ValueError("bcr_solve: empty system")
    m = tridiag.next_pow2(n)
    if m > MAX_LANES:
        raise ValueError(f"bcr_solve: n = {n} needs {m} lanes; the kernel "
                         f"indexes at most {MAX_LANES} with int32 offsets")
    top = max(0, (m // MAX_SHARED_LANES).bit_length() - 1)
    tail = m >> top
    lanes = min(tail, MAX_LANES_PER_BLOCK)
    if rhs > 1 and tail > lanes:
        lanes = max(MULTI_MIN_LANES, tail // MAX_CLUSTER)
    if rhs == 1:
        threads = max(32, min(MAX_THREADS, lanes // 2))
        smem = LANE_FLOATS * PLANE_STRIDE * 4
    else:
        half = -(-(lanes // 2) // 32) * 32
        threads = min(MAX_THREADS, max(32 * (rhs + 1), half))
        smem = multi_floats(rhs) * PLANE_STRIDE * 4
    return LaunchPlan(n, m, top, lanes, tail // lanes, threads, smem, rhs)


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
            launches.bump(D.device)
        else:
            code = lib.hitl_bcr_solve_batched(*ptrs, batch, *args)
            cuda_build.check(code, "bcr_solve_batched")
            batched_launches.bump(D.device)
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


def check_multi_inputs(D: Tensor, U: Tensor, b: Tensor
                       ) -> tuple[int, int, int]:
    """Validate the multi route's inputs; return (S, n, R). Each tensor may
    have any stride between systems but must be contiguous within one."""
    what = "bcr_solve_multi"
    dev = D.device
    if dev.type != "cuda":
        raise ValueError(f"{what}_cuda needs CUDA tensors, got {dev}")
    if D.dim() != 4 or b.dim() != 4:
        raise ValueError(f"{what}: D must be [S, n, 3, 3] and b [S, n, 3, "
                         f"R], got {tuple(D.shape)} and {tuple(b.shape)}")
    S, n, R = D.shape[0], D.shape[1], b.shape[-1]
    if not 1 <= S <= MAX_BATCH:
        raise ValueError(f"{what}: S = {S} outside [1, {MAX_BATCH}]")
    if not 1 <= R <= MAX_RHS:
        raise ValueError(f"{what}: R = {R} outside [1, {MAX_RHS}]")
    f32 = torch.float32
    for name, t, shape in (("D", D, (S, n, 3, 3)),
                           ("U", U, (S, max(n - 1, 0), 3, 3)),
                           ("b", b, (S, n, 3, R))):
        cuda_build.require(what, name, t, shape, f32, dev, per_system=True)
    return S, n, R


def bcr_solve_cuda_multi(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Launch the multi route once for S systems, each against R
    right-hand sides: D [S,n,3,3], U [S,n-1,3,3], b [S,n,3,R] f32 CUDA, each
    contiguous within a system -> x [S,n,3,R] contiguous."""
    S, n, R = check_multi_inputs(D, U, b)
    plan = launch_plan(n, R)
    x = torch.empty((S, n, 3, R), dtype=torch.float32, device=D.device)
    state = (torch.empty((S * plan.state_floats,), dtype=torch.float32,
                         device=D.device) if plan.top else None)
    strides = [t.stride(0) if S > 1 else 0 for t in (D, U, b)]
    lib = cuda_build.library()
    with torch.cuda.device(D.device):
        code = lib.hitl_bcr_solve_multi(
            D.data_ptr(), U.data_ptr(), b.data_ptr(), x.data_ptr(),
            None if state is None else state.data_ptr(), *strides, S, n, R,
            plan.m, plan.lanes_per_block.bit_length() - 1, plan.top,
            plan.threads, plan.smem_bytes,
            torch.cuda.current_stream(D.device).cuda_stream)
        cuda_build.check(code, "bcr_solve_multi")
        multi_launches.bump(D.device)
    return x


def bcr_solve_multi_reference(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """The multi route's plain version: every column of every system
    through tridiag.bcr_solve, as one batch of S * R systems with D and U
    repeated for each column (a batched solve rounds as its lone ones).
    D [S,n,3,3], U [S,n-1,3,3], b [S,n,3,R] -> x [S,n,3,R]."""
    S, n, R = D.shape[0], D.shape[1], b.shape[-1]
    x = tridiag.bcr_solve(
        D[:, None].expand(S, R, n, 3, 3).reshape(S * R, n, 3, 3),
        U[:, None].expand(S, R, *U.shape[1:]).reshape(S * R, *U.shape[1:]),
        b.permute(0, 3, 1, 2).reshape(S * R, n, 3))
    return x.reshape(S, R, n, 3).permute(0, 2, 3, 1)


def bcr_solve_multi(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """S systems, each against R right-hand sides (D [S,n,3,3],
    U [S,n-1,3,3], b [S,n,3,R] -> x [S,n,3,R]): the multi route for CUDA
    tensors, its plain version for CPU tensors."""
    if D.device.type == "cpu":
        return bcr_solve_multi_reference(D, U, b)
    if D.device.type == "cuda":
        return bcr_solve_cuda_multi(D, U, b)
    raise ValueError(f"bcr_solve_multi: unsupported device {D.device}")


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
