"""Launch plans of the port's CUDA kernels, on the CPU.

The kernels run only on a card, but the way each call is cut into blocks is
pure Python (solver/bcr_kernel.py::launch_plan, ops/em_scan.py::launch_plan
and row_chunks) and is checked here: the resources a plan asks for stay
within one H100 block and cluster, every lane or pose belongs to exactly one
block, the ragged end of a row is covered, and sizes no route takes raise.
Imports neither jax nor the JAX package.
"""

import struct

import pytest
import torch

from hitl_slam_torch.ops import em_scan as E
from hitl_slam_torch.solver import bcr_kernel as B

SMEM_PER_BLOCK = 232_448     # the most dynamic shared memory an H100 block may use
MAX_CLUSTER = 16             # the largest (non-portable) cluster on an H100


@pytest.mark.parametrize("n", [1, 2, 3, 64, 127, 1024, 1025, 2048, 4097,
                               16384, 16385, 32768, 65537, 1 << 18])
def test_bcr_launch_plan(n):
    plan = B.launch_plan(n)
    assert plan.m == B.tridiag.next_pow2(n) and plan.m >= n
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert 1 <= plan.blocks <= MAX_CLUSTER
    assert 32 <= plan.threads <= 512 and plan.threads % 32 == 0
    # the shared-memory planes hold every lane of a block, bank-padded
    assert plan.smem_bytes == B.LANE_FLOATS * B.PLANE_STRIDE * 4
    assert B.PLANE_STRIDE >= plan.lanes_per_block + plan.lanes_per_block // 32
    # every lane of m in exactly one place: one block's shared memory
    # (every 2^top-th lane), or eliminated at one top level in device memory
    held = [g for blk in range(plan.blocks) for g in plan.lanes(blk)]
    assert held == list(range(0, plan.m, 1 << plan.top))
    level = [(g & -g).bit_length() for g in range(1, plan.m) if g % (1 << plan.top)]
    assert len(held) + len(level) == plan.m
    assert all(1 <= k <= plan.top for k in level)
    assert plan.state_floats == (plan.m * B.LANE_FLOATS if plan.top else 0)


@pytest.mark.parametrize("n,route,blocks,top", [
    (1, "block", 1, 0), (1024, "block", 1, 0), (1025, "cluster", 2, 0),
    (2048, "cluster", 2, 0), (4097, "cluster", 8, 0),
    (16384, "cluster", 16, 0), (16385, "levels+cluster", 16, 1),
    (32768, "levels+cluster", 16, 1), (65537, "levels+cluster", 16, 3),
    (1 << 25, "levels+cluster", 16, 11)])
def test_bcr_launch_plan_route(n, route, blocks, top):
    # one block up to 1024 lanes, a cluster up to 16384, then top levels in
    # device memory until 16384 lanes are left for a full cluster
    plan = B.launch_plan(n)
    assert (plan.route, plan.blocks, plan.top) == (route, blocks, top)
    assert plan.m >> plan.top == plan.blocks * plan.lanes_per_block


@pytest.mark.parametrize("n", [0, -3, (1 << 25) + 1])
def test_bcr_launch_plan_refuses_sizes_without_a_route(n):
    with pytest.raises(ValueError):
        B.launch_plan(n)


_MULTI_N = [1, 2, 3, 64, 127, 512, 513, 1024, 1025, 2048, 8192, 8193,
            16384, 16385, 32768, 1 << 18, 1 << 25]


def _lone_plan_of_today(n):
    """launch_plan(n) as the lone and batched routes have had it since
    their redesign: 51-float lanes, 1024 a block, clusters to 16384 lanes."""
    m = B.tridiag.next_pow2(n)
    top = max(0, (m // 16384).bit_length() - 1)
    lanes = min(m >> top, 1024)
    return B.LaunchPlan(n, m, top, lanes, (m >> top) // lanes,
                        max(32, min(512, lanes // 2)), 51 * 1056 * 4)


@pytest.mark.parametrize("rhs", [1, 2, 7, 8])
@pytest.mark.parametrize("n", _MULTI_N)
def test_bcr_multi_launch_plan(n, rhs):
    plan = B.launch_plan(n, rhs)
    assert plan.rhs == rhs and plan.m == B.tridiag.next_pow2(n)
    lanes = plan.lanes_per_block
    assert lanes & (lanes - 1) == 0
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert 1 <= plan.blocks <= MAX_CLUSTER
    assert plan.threads <= 512 and plan.threads % 32 == 0
    # the multi kernel's planes for R columns fit the plan's shared memory
    assert B.multi_floats(rhs) * B.PLANE_STRIDE * 4 <= plan.smem_bytes
    # a thread for each even lane of the first level (the multi kernel
    # holds one lane's new L, U in registers across a barrier)
    assert plan.threads >= -(-(lanes // 2) // 32) * 32
    assert lanes <= 1024 and plan.m >> plan.top == plan.blocks * lanes
    route = ("block" if plan.m <= 1024 else
             "cluster" if plan.m <= 1024 * MAX_CLUSTER else "levels+cluster")
    assert plan.route == route
    if plan.top:
        assert plan.m >> plan.top == 1024 * MAX_CLUSTER
        assert plan.state_floats >= plan.m * B.multi_floats(rhs)
    if rhs == 1:
        assert plan == _lone_plan_of_today(n) == B.launch_plan(n)
    else:
        # a deep level's matrix warp and its R column threads side by side
        assert plan.threads >= 32 * (rhs + 1)
        # the routes are the lone route's at every R; a cluster spreads over
        # up to 16 blocks of at least 256 lanes
        lone = B.launch_plan(n)
        assert (plan.route, plan.top) == (lone.route, lone.top)
        tail = plan.m >> plan.top
        assert lanes == (tail if tail <= 1024 else max(256, tail // 16))


@pytest.mark.parametrize("rhs,smem", [(2, 139_392), (7, 202_752),
                                      (8, 215_424)])
def test_bcr_multi_shared_memory(rhs, smem):
    # 27 floats of matrices and 3 a column, laid out for 1056 lane slots: a
    # block holds 1024 lanes up to R = 8
    plan = B.launch_plan(1024, rhs)
    assert plan.smem_bytes == smem <= SMEM_PER_BLOCK
    assert (plan.route, plan.blocks) == ("block", 1)


@pytest.mark.parametrize("n,blocks,lanes", [(1025, 8, 256), (2048, 8, 256),
                                            (4096, 16, 256), (8192, 16, 512),
                                            (16384, 16, 1024),
                                            (16385, 16, 1024)])
def test_bcr_multi_cluster_spreads_over_blocks(n, blocks, lanes):
    # the SPIKE's 16384-pose chain at d = 8 is n = 2048: 8 blocks, not 2
    plan = B.launch_plan(n, 7)
    assert (plan.blocks, plan.lanes_per_block) == (blocks, lanes)
    assert plan.threads == 256 if lanes <= 512 else plan.threads == 512


@pytest.mark.parametrize("n,rhs", [(16, 0), (16, 9), (16, -1),
                                   ((1 << 25) + 1, 7), ((1 << 25) + 1, 1),
                                   (0, 7)])
def test_bcr_multi_launch_plan_refuses_what_has_no_route(n, rhs):
    with pytest.raises(ValueError):
        B.launch_plan(n, rhs)


def _kernel_points(plan, p):
    """The flat points lane `sub` of pose p visits, for every sub, as the
    kernel's chunk loop walks them (em_scan.cu)."""
    q0, q1 = p * plan.N, p * plan.N + plan.N
    chunks = E.row_chunks(p, plan.N)
    seen = []
    for sub in range(plan.lanes_per_pose):
        for c in range(chunks.start + sub, chunks.stop, plan.lanes_per_pose):
            seen += [q for q in range(4 * c, 4 * c + 4) if q0 <= q < q1]
    return seen


@pytest.mark.parametrize("N", [1, 3, 128])
@pytest.mark.parametrize("P", [1, 7, 8, 9, 1021, 1024])
def test_em_scan_launch_plan(P, N):
    plan = E.launch_plan(P, N)
    assert plan.lanes_per_pose in (1, 2, 4, 8, 16, 32)
    assert plan.poses_per_block * plan.lanes_per_pose == E.THREADS
    # the grid covers every pose once, with no empty block
    owned = [p for blk in range(plan.blocks) for p in plan.poses(blk)]
    assert owned == list(range(P))
    assert all(len(plan.poses(blk)) > 0 for blk in range(plan.blocks))
    # every point of every row visited exactly once, ragged ends included
    for p in {q for q in (0, 1, 2, 3, P // 2, P - 1) if q < P}:
        assert sorted(_kernel_points(plan, p)) == list(range(p * N, p * N + N))
    # one chunk a lane when a row fits in a warp's chunks
    most = max(len(E.row_chunks(p, N)) for p in range(min(P, 4)))
    assert plan.lanes_per_pose >= min(most, E.WARP)


def test_em_scan_launch_plan_empty_map_still_launches_one_block():
    # a block must run to write the minima (1e30)
    assert E.launch_plan(0, 128).blocks == 1
    with pytest.raises(ValueError):
        E.launch_plan(-1, 4)


@pytest.mark.parametrize("thr", [0.03, 0.05, 0.1, 1 / 3])
def test_threshold2_is_the_f32_rounding_of_the_square(thr):
    want = torch.tensor(thr ** 2, dtype=torch.float32).item()
    got = E.threshold2(thr)
    assert got == want
    assert struct.pack("f", got) == struct.pack("f", want)
