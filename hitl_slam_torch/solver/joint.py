"""Joint pose-graph problem: factor constants and cost. Port of
build_problem and cost in hitl_slam_tpu/solver/joint.py; the normal
equations LM uses are assembled in assembly_soa.py. Cost convention:
0.5 * sum(r_i^2).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.state import ConstraintTable
from ..ops import residuals as res

Tensor = torch.Tensor

# max elements of the dense [C, P] selector before falling back to index_add_
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
                  odom_inv_sigma: Tensor | None = None) -> JointProblem:
    """`odom_inv_sigma` [P-1, 3] replaces the fixed odometry noise by
    per-factor inverse standard deviations."""
    P = poses.shape[0]
    human = res.build_human_factors(poses, table)
    C = human.pose_idx.shape[0]
    onehot = None
    # the dense selector makes the table -> pose reduction a matmul with a
    # fixed sum order (index_add_ on CUDA sums with atomics); past the
    # budget the selector's memory outweighs that
    if P * C <= ONEHOT_BUDGET:
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

