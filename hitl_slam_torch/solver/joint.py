"""Joint pose-graph problem: factor constants, cost and the normal
equations. Port of hitl_slam_tpu/solver/joint.py. `normal_equations` is the
block-array (AoS) assembly, `lm.solve(use_soa=False)`; LM's default is the
lane-major assembly of assembly_soa.py. Cost convention: 0.5 * sum(r_i^2).
The first pose is gauge-fixed: its couplings are zeroed and its diagonal
block pinned to the identity.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.state import ConstraintTable
from ..ops import residuals as res

Tensor = torch.Tensor

# max elements of the dense [C, P] selector before falling back to a
# scatter-add (an accumulating index_put_)
ONEHOT_BUDGET = 64 * 1024 * 1024


@dataclass(frozen=True)
class JointProblem:
    """All factor constants for one solve, fixed at build time; `compact` is
    the once-per-solve per-pose reduction of the human table."""

    odom: res.OdometryFactors
    human: res.HumanFactors
    compact: res.CompactHuman
    num_poses: int = 0


def build_problem(poses: Tensor, table: ConstraintTable,
                  use_onehot: bool = True,
                  odom_inv_sigma: Tensor | None = None) -> JointProblem:
    """`odom_inv_sigma` [P-1, 3] replaces the fixed odometry noise by
    per-factor inverse standard deviations. `use_onehot=False` reduces the
    human table to poses by the scatter-add at every size."""
    P = poses.shape[0]
    human = res.build_human_factors(poses, table)
    C = human.pose_idx.shape[0]
    onehot = None
    # the dense selector makes the table -> pose reduction a matmul; past
    # the budget its memory outweighs that, and the scatter-add, whose sum
    # order is fixed too, takes over
    if use_onehot and P * C <= ONEHOT_BUDGET:
        onehot = (human.pose_idx.long()[:, None]
                  == torch.arange(P, device=poses.device)[None, :]
                  ).to(poses.dtype)
    return JointProblem(
        odom=res.build_odometry_factors(poses, odom_inv_sigma),
        human=human,
        compact=res.compact_human_factors(human, poses, onehot),
        num_poses=P,
    )


def cost(problem: JointProblem, poses: Tensor) -> Tensor:
    """0.5 * sum of squared residuals."""
    r_o = res.odometry_residuals(problem.odom, poses)
    _, _, c_h = res.compact_human_terms(problem.compact, poses)
    return 0.5 * torch.sum(r_o * r_o) + c_h



def normal_equations(problem: JointProblem, poses: Tensor
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """H (block-tridiagonal: D [P,3,3], U [P-1,3,3]), the gradient g = J^T r
    [P,3] and the cost, from the factors' Jacobian blocks, gauge-fixed at
    pose 0: its couplings are zeroed and D[0] = I, g[0] = 0."""
    r_o = res.odometry_residuals(problem.odom, poses)        # [F,3]
    J1, J2 = res.odometry_jacobians(problem.odom, poses)     # [F,3,3] each
    J1T, J2T = J1.transpose(-1, -2), J2.transpose(-1, -2)
    A_h, g_h, c_h = res.compact_human_terms(problem.compact, poses)
    D = A_h.clone()
    D[:-1] += J1T @ J1
    D[1:] += J2T @ J2
    U = J1T @ J2                                             # couples (i-1, i)
    g = g_h.clone()
    g[:-1] += (J1T @ r_o[..., None])[..., 0]
    g[1:] += (J2T @ r_o[..., None])[..., 0]

    # gauge fix pose 0
    D[0] = torch.eye(3, dtype=poses.dtype, device=poses.device)
    U[0] = 0.0
    g[0] = 0.0
    c = 0.5 * torch.sum(r_o * r_o) + c_h
    return D, U, g, c
