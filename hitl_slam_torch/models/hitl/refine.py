"""Post-human STF refinement: world transform -> correspondence search ->
factor compaction -> LM refine over odometry + human + STF factors.

Port of hitl_slam_tpu/models/hitl/refine.py.
"""

from __future__ import annotations

import dataclasses

import torch

from ...core.state import ConstraintTable
from ...ops import correspond as C
from ...ops.geometry import pose_to_world, rotate
from ...solver.lm import LMConfig
from ...solver.stf_solve import (STFSolveResult, stf_lm_solve,
                                 stf_pcg_lm_solve)

Tensor = torch.Tensor

# above this pose count the dense [3P,3P] refine Hessian gives way to the
# matrix-free PCG solve
DENSE_POSE_LIMIT = 2048


def match_factors_global(
    points: Tensor,
    normals: Tensor,
    point_mask: Tensor,
    poses: Tensor,
    capacity: int = 65536,
    bucket: int = 64,
    max_cells: int | None = None,
):
    """The global 1-NN correspondence half of the refine (world transform,
    grid_match, factor compaction). Returns (STFFactors, Matches)."""
    world = pose_to_world(poses[:, None, :], points)
    world_nrm = rotate(poses[:, 2][:, None], normals)
    matches = C.grid_match(world, world_nrm, point_mask,
                           bucket=bucket, max_cells=max_cells)
    stf = C.build_stf_factors(points, normals, matches, capacity=capacity)
    return stf, matches


def match_factors(points, normals, point_mask, poses, matcher: str,
                  capacity: int, max_pairs: int, bucket: int,
                  max_cells: int | None):
    """The refine's correspondence search by either matcher. Returns
    (STFFactors, match_dropped, vote_dropped, elect_dropped); the last two
    are None for the global matcher."""
    if matcher == "pair":
        stf, info = C.pair_match_factors(points, normals, point_mask, poses,
                                         max_pairs=max_pairs,
                                         capacity=capacity, bucket=bucket,
                                         max_cells=max_cells)
        return stf, info.rows_overflow, info.grid_dropped, info.pairs_overflow
    if matcher != "global":
        raise ValueError(f"unknown matcher {matcher!r}")
    stf, matches = match_factors_global(points, normals, point_mask, poses,
                                        capacity=capacity, bucket=bucket,
                                        max_cells=max_cells)
    return stf, matches.dropped, None, None


def solve_factors(poses, table, stf, config: LMConfig, include_chain: bool,
                  solver: str, max_pairs: int) -> STFSolveResult:
    """The refine's LM solve over a factor table, by solver name ("dense",
    "dense_fused", "pcg", or "auto": dense_fused up to DENSE_POSE_LIMIT
    poses, pcg above)."""
    if solver == "auto":
        solver = "pcg" if poses.shape[0] > DENSE_POSE_LIMIT else "dense_fused"
    # the solvers' off-diagonal pair compact must hold every pair the
    # matcher can emit: never smaller than the election capacity
    solver_pairs = max(max_pairs, 16384)
    if solver == "pcg":
        return stf_pcg_lm_solve(poses, table, stf, config=config,
                                include_chain=include_chain,
                                max_pairs=solver_pairs)
    if solver not in ("dense", "dense_fused"):
        raise ValueError(f"unknown solver {solver!r}")
    return stf_lm_solve(poses, table, stf, config=config,
                        include_chain=include_chain,
                        fused_eval=solver == "dense_fused",
                        max_pairs=solver_pairs)


def post_human_refine(
    points: Tensor,       # [P, N, 2] robot frame
    normals: Tensor,      # [P, N, 2]
    point_mask: Tensor,   # [P, N]
    poses: Tensor,        # [P, 3]
    table: ConstraintTable,
    capacity: int = 65536,
    config: LMConfig = LMConfig(max_iterations=30),
    include_chain: bool = True,
    solver: str = "auto",   # "dense" | "dense_fused" | "pcg" | "auto"
    matcher: str = "global",  # "global" (1-NN grid) | "pair" (per-pair NN)
    max_pairs: int = 8192,    # pair-matcher election capacity
    match_bucket: int = 64,   # grid per-cell capacity (density cap)
    match_max_cells: int | None = None,  # occupied-cell capacity; the
    # default clamp (M//32, at most 16384) is sized for building-scale maps
) -> STFSolveResult:
    """matcher="pair" selects the per-pair correspondence search
    (C.pair_match_factors), needed on heavily re-traversed maps where the
    global 1-NN fragments bundles below the >= 10-per-pair gate and yields
    zero factors.

    Drop diagnostics on the result: `match_dropped` counts factor rows lost
    (matcher-table overflow, or the global matcher's grid drops);
    `vote_dropped` / `elect_dropped` (pair mode) count stage-1 grid drops
    that may have silenced votes, and voted pairs beyond the election
    capacity; `pairs_dropped` counts pose pairs beyond the solvers'
    off-diagonal compact capacity (kept >= max_pairs here, so 0 unless the
    global matcher emits more distinct pairs than that)."""
    stf, match_dropped, vote_dropped, elect_dropped = match_factors(
        points, normals, point_mask, poses, matcher, capacity, max_pairs,
        match_bucket, match_max_cells)
    out = solve_factors(poses, table, stf, config, include_chain, solver,
                        max_pairs)
    return dataclasses.replace(out, match_dropped=match_dropped,
                               vote_dropped=vote_dropped,
                               elect_dropped=elect_dropped)
