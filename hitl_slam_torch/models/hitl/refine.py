"""Post-human STF refinement: world transform -> correspondence search ->
factor compaction -> LM refine over odometry + human + STF factors.

Port of hitl_slam_tpu/models/hitl/refine.py. The reference jits
`post_human_refine` whole: one compiled program holds the match, the LM
`lax.while_loop`, the CG `lax.while_loop` inside it and the reassembly
`lax.cond`. On a CUDA device the port replays a device program
(utils/device_loop.py::DeviceProgram) of the same function: one CUDA graph,
captured at its first use, in which every loop is a WHILE node (the CG
loop inside the LM loop's body), so a call reads nothing back and the
caller's read of the result is the refine's one host read.
`match_factors` and `solve_factors`, the refine's two halves, are
programs of their own. `eager=True` runs the same code eagerly on the card
(for comparisons only); on the CPU the code always runs eagerly, one host
read a loop test.

Programs are kept by shape, dtype and static arguments in a cache of two,
apart from the correction cycle's: a refine's memory pool at 8192 poses is
a few GiB, and a third map's program drops the least recently used.
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
from ...utils.device_loop import (DeviceProgram, ProgramCache, replays,
                                  signature)

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
                  max_cells: int | None, *, eager: bool = False):
    """The refine's correspondence search by either matcher. Returns
    (STFFactors, match_dropped, vote_dropped, elect_dropped); the last two
    are None for the global matcher. On a CUDA device a replay of its
    program unless `eager`."""
    if matcher not in ("global", "pair"):
        raise ValueError(f"unknown matcher {matcher!r}")
    args = (points, normals, point_mask, poses)
    if replays(poses, eager):
        return _program(_match, args, (matcher, capacity, max_pairs, bucket,
                                       max_cells)).run(*args)
    return _match(*args, matcher, capacity, max_pairs, bucket, max_cells)


def _match(points, normals, point_mask, poses, matcher, capacity, max_pairs,
           bucket, max_cells):
    if matcher == "pair":
        stf, info = C.pair_match_factors(points, normals, point_mask, poses,
                                         max_pairs=max_pairs,
                                         capacity=capacity, bucket=bucket,
                                         max_cells=max_cells)
        return stf, info.rows_overflow, info.grid_dropped, info.pairs_overflow
    stf, matches = match_factors_global(points, normals, point_mask, poses,
                                        capacity=capacity, bucket=bucket,
                                        max_cells=max_cells)
    return stf, matches.dropped, None, None


def _resolve(solver: str, P: int) -> str:
    """The solver "auto" picks for P poses (dense_fused up to
    DENSE_POSE_LIMIT, pcg above); a name it does not know raises."""
    if solver == "auto":
        solver = "pcg" if P > DENSE_POSE_LIMIT else "dense_fused"
    if solver not in ("dense", "dense_fused", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    return solver


def solve_factors(poses, table, stf, config: LMConfig, include_chain: bool,
                  solver: str, max_pairs: int, *,
                  eager: bool = False) -> STFSolveResult:
    """The refine's LM solve over a factor table, by solver name ("dense",
    "dense_fused", "pcg", or "auto": dense_fused up to DENSE_POSE_LIMIT
    poses, pcg above). On a CUDA device a replay of its program unless
    `eager`."""
    solver = _resolve(solver, poses.shape[0])
    args = (poses, table, stf)
    if replays(poses, eager):
        return _program(_solve, args, (config, include_chain, solver,
                                       max_pairs), solver).run(*args)
    return _solve(*args, config, include_chain, solver, max_pairs)


def _solve(poses, table, stf, config, include_chain, solver, max_pairs):
    # the solvers' off-diagonal pair compact must hold every pair the
    # matcher can emit: never smaller than the election capacity
    solver_pairs = max(max_pairs, 16384)
    if solver == "pcg":
        return stf_pcg_lm_solve(poses, table, stf, config=config,
                                include_chain=include_chain,
                                max_pairs=solver_pairs)
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
    *,
    eager: bool = False,
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
    global matcher emits more distinct pairs than that).

    On a CUDA device the call replays the refine's program (one CUDA graph
    of the match and the solve, every loop a WHILE node), unless `eager`,
    which runs the same code eagerly there, for comparisons only."""
    if matcher not in ("global", "pair"):
        raise ValueError(f"unknown matcher {matcher!r}")
    args = (points, normals, point_mask, poses, table)
    static = (capacity, config, include_chain, solver, matcher, max_pairs,
              match_bucket, match_max_cells)
    if replays(poses, eager):
        return refine_program(*args, *static).run(*args)
    return _refine(*args, capacity, config, include_chain,
                   _resolve(solver, poses.shape[0]), *static[4:])


def refine_program(points, normals, point_mask, poses, table,
                   capacity: int = 65536,
                   config: LMConfig = LMConfig(max_iterations=30),
                   include_chain: bool = True, solver: str = "auto",
                   matcher: str = "global", max_pairs: int = 8192,
                   match_bucket: int = 64,
                   match_max_cells: int | None = None) -> DeviceProgram:
    """The program post_human_refine replays for inputs shaped as these
    (on a CUDA device) and these arguments: the one made before, or a new
    one, captured at its first run (its `graph()` holds the capture's
    facts)."""
    solver = _resolve(solver, poses.shape[0])
    return _program(_refine, (points, normals, point_mask, poses, table),
                    (capacity, config, include_chain, solver, matcher,
                     max_pairs, match_bucket, match_max_cells), solver)


def _refine(points, normals, point_mask, poses, table, capacity, config,
            include_chain, solver, matcher, max_pairs, match_bucket,
            match_max_cells) -> STFSolveResult:
    stf, match_dropped, vote_dropped, elect_dropped = _match(
        points, normals, point_mask, poses, matcher, capacity, max_pairs,
        match_bucket, match_max_cells)
    out = _solve(poses, table, stf, config, include_chain, solver, max_pairs)
    return dataclasses.replace(out, match_dropped=match_dropped,
                               vote_dropped=vote_dropped,
                               elect_dropped=elect_dropped)


# the refine's programs, apart from the cycle's (models/hitl/cycle.py)
_programs = ProgramCache(size=2)


def _program(fn, example: tuple, static: tuple,
             solver: str | None = None) -> DeviceProgram:
    """The program of `fn` (_match, _solve or _refine) for inputs shaped
    as `example` (on a CUDA device), its static arguments and the solver
    it runs (None: none): the one made before, or a new one, captured at
    its first run."""
    dev = example[0].device
    dtype = example[0].dtype
    P = example[0].shape[0]
    # the matcher's points [P, N, 2] come first; the solve's poses [P, 3]
    M = P * example[0].shape[1] if example[0].dim() == 3 else 0

    def warm():
        # made before the capture: the grid matcher's permutation (a copy
        # from the host), and the dense step's library handles and
        # workspaces on the program's stream
        if M:
            C.preshuffle_on(M, dev)
        if solver in ("dense", "dense_fused"):
            n = 3 * P
            L = torch.linalg.cholesky_ex(
                torch.eye(n, dtype=dtype, device=dev))[0]
            torch.linalg.solve_triangular(
                L, torch.ones((n, 1), dtype=dtype, device=dev), upper=False)

    key = (fn, signature(example), static, dev.index)
    return _programs.get(key, lambda: DeviceProgram(
        lambda *a: fn(*a, *static), example, dev, warm=warm, name="refine"))
