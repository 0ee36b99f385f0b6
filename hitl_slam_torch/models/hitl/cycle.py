"""The correction cycle: verify -> world transform -> EM endpoint refit ->
inlier counts -> ordering -> explicit correction -> constraint rows ->
backprop -> joint LM solve.

Port of hitl_slam_tpu/models/hitl/cycle.py (`cycle_step`, `queue_chain`).
The correction type is host-known, so the reference's `lax.cond` on it
becomes a Python branch; everything data-dependent (validity, ordering,
backprop bounds, the table write cursor) stays on the device and gates the
state update there, so a cycle reads back to the host only inside the EM
refit loop and the LM loop (one flag per round / iteration). Invalid or
unverified inputs leave the state as it was; the solve still runs for them,
as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core.state import ConstraintTable, CorrectionType
from ...ops.em_scan import em_scan
from ...ops.geometry import pose_to_world
from ...solver.joint import build_problem
from ...solver.lm import LMConfig, solve as lm_solve
from . import em_input
from .backprop import backprop
from .explicit import apply_explicit, constraint_deltas
from .ordering import MIN_POSE_INLIERS, order_on_device
from .repair import _scatter_constraints, _wrap_theta

Tensor = torch.Tensor


@dataclass(frozen=True)
class CycleOutput:
    poses: Tensor
    covariances: Tensor
    constraints: ConstraintTable
    verified: Tensor             # scalar bool: all clicked points near map
    order_valid: Tensor          # scalar bool: ordering/backprop bounds OK
    num_new_constraints: Tensor  # scalar int32
    refit_sel: Tensor            # [4,2] EM-refit (and possibly swapped) points
    lm_iterations: Tensor
    lm_initial_cost: Tensor
    lm_final_cost: Tensor
    lm_final_mu: Tensor          # damping at exit (chain warm-start source)
    pre_solve_poses: Tensor


def cycle_step(
    points: Tensor,        # [P,N,2] robot frame
    point_mask: Tensor,    # [P,N]
    poses: Tensor,         # [P,3]
    covariances: Tensor,   # [P,3,3]
    constraints: ConstraintTable,
    ctype: int,            # CorrectionType value
    sel_raw: Tensor,       # [4,2] clicked points, world frame
    write_offset,          # int or scalar int tensor
    lm_config: LMConfig = LMConfig(),
    odom_inv_sigma: Tensor | None = None,  # [P-1,3] loop-closure weighting
    mu0: Tensor | None = None,             # warm-start damping
) -> CycleOutput:
    ctype = int(ctype)
    world = pose_to_world(poses[:, None, :], points)

    # POINT selections are degenerate segments [p,p,q,q]; CORNER drags are
    # anchored at a feature vertex: neither gets the segment refit
    is_point = ctype == int(CorrectionType.POINT)
    is_corner = ctype == int(CorrectionType.CORNER)

    # --- verification: em_scan's minima ---
    _, min_d2 = em_scan(world, point_mask, sel_raw)
    degenerate = (torch.all(sel_raw[0] == sel_raw[1])
                  | torch.all(sel_raw[2] == sel_raw[3]))
    verified = torch.all(min_d2 < em_input.VERIFY_THRESHOLD ** 2)
    if not is_point:
        verified = verified & ~degenerate

    # --- EM: refit both sketched segments, then count inliers ---
    if is_point or is_corner:
        refit = sel_raw
    else:
        segs = em_input.endpoint_adjust_batch(
            world, point_mask, torch.stack([sel_raw[0:2], sel_raw[2:4]]))
        refit = segs.reshape(4, 2)
    # POINT selections count inliers in the wider verify-radius disc
    threshold = (em_input.VERIFY_THRESHOLD if is_point
                 else em_input.INLIER_THRESHOLD)
    counts, _ = em_scan(world, point_mask, refit.contiguous(),
                        inlier_threshold=threshold)

    # --- ordering / filtering ---
    o = order_on_device(counts[:, 0], counts[:, 1], refit,
                        min_inliers=0 if is_point else MIN_POSE_INLIERS)
    valid = verified & o.valid

    # --- explicit correction + constraint targets ---
    poses1, C = apply_explicit(poses, ctype, o.sel, o.group_mask, o.last_pose)
    dpar, dperp, dth, pen, pair_valid = constraint_deltas(
        poses1, o.sel, o.anchor_idx, o.corrected_idx)
    table, n_new = _scatter_constraints(
        constraints, ctype, o.anchor_idx, o.corrected_idx,
        dpar, dperp, dth, pen, pair_valid & valid, write_offset)

    # --- backprop + angle wrap ---
    poses2, cov2 = backprop(poses1, covariances, C, o.bp_min, o.bp_max)
    poses2 = _wrap_theta(poses2)

    # --- joint LM solve over odometry + all human factors ---
    problem = build_problem(poses2, table, odom_inv_sigma=odom_inv_sigma)
    lm = lm_solve(problem, poses2, lm_config, mu0=mu0)
    poses3 = _wrap_theta(lm.poses)

    # --- gate the state update on validity ---
    zero = torch.zeros((), dtype=torch.int32, device=poses.device)
    return CycleOutput(
        poses=torch.where(valid, poses3, poses),
        covariances=torch.where(valid, cov2, covariances),
        constraints=table,
        verified=verified,
        order_valid=o.valid,
        num_new_constraints=torch.where(valid, n_new, zero),
        refit_sel=o.sel,
        lm_iterations=torch.where(valid, lm.iterations, zero),
        lm_initial_cost=lm.initial_cost,
        lm_final_cost=lm.final_cost,
        lm_final_mu=lm.final_mu,
        pre_solve_poses=poses2,
    )


def _select_table(ok: Tensor, a: ConstraintTable,
                  b: ConstraintTable) -> ConstraintTable:
    return ConstraintTable(**{
        name: torch.where(ok, getattr(a, name), getattr(b, name))
        for name in ConstraintTable.__dataclass_fields__
    })


def queue_chain(
    points: Tensor,
    point_mask: Tensor,
    poses: Tensor,
    covariances: Tensor,
    constraints: ConstraintTable,
    ctypes,                # [K] host ints, per-cycle correction types
    sels: Tensor,          # [K,4,2] per-cycle clicked points (world frame)
    n0,                    # int or scalar int tensor: table write cursor
    lm_config: LMConfig = LMConfig(),
    odom_inv_sigma: Tensor | None = None,
    warm_start_mu: bool = False,
):
    """K correction cycles in sequence, carried on the device.

    A cycle's outputs are adopted only when it verified, ordered, and solved
    finite; otherwise the carried poses, covariances and table stay as they
    were (the table drops the rows the rejected cycle wrote). With
    `warm_start_mu`, an accepted cycle's exit damping seeds the next solve.

    Returns (poses, covariances, constraints, n_end, per_cycle) where
    per_cycle stacks [K] tensors: (accepted, verified, order_valid, n_new,
    lm_iterations, lm_initial_cost, lm_final_cost).
    """
    dev = poses.device
    n = torch.as_tensor(n0, dtype=torch.int32, device=dev)
    mu = torch.tensor(lm_config.initial_mu, dtype=poses.dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    ys = []
    for k, ctype in enumerate(ctypes):
        out = cycle_step(points, point_mask, poses, covariances, constraints,
                         int(ctype), sels[k], n, lm_config=lm_config,
                         mu0=mu if warm_start_mu else None,
                         odom_inv_sigma=odom_inv_sigma)
        ok = (out.verified & out.order_valid
              & torch.isfinite(out.lm_final_cost))
        poses = torch.where(ok, out.poses, poses)
        covariances = torch.where(ok, out.covariances, covariances)
        constraints = _select_table(ok, out.constraints, constraints)
        n_new = torch.where(ok, out.num_new_constraints, zero)
        mu = torch.where(ok, out.lm_final_mu, mu)
        n = n + n_new
        ys.append((ok, out.verified, out.order_valid, n_new,
                   out.lm_iterations, out.lm_initial_cost, out.lm_final_cost))
    per_cycle = tuple(torch.stack(col) for col in zip(*ys)) if ys else ()
    return poses, covariances, constraints, n, per_cycle
