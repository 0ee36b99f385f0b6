"""Factor residuals + analytic Jacobians for the joint pose-graph solve.

Port of hitl_slam_tpu/ops/residuals.py (odometry factors, human factors,
the relative-pose parameterization and the CompactHuman per-pose
reduction):

  - odometry factor constants (axis transform, radial translation, relative
    rotation) are computed from the CURRENT poses when the problem is
    built, with sigmas radial/tangential=0.03, angular=0.01 and an
    atan2-wrapped angular error;
  - human factors are UNARY, in one parametric form r = M (q_target - q)
    with a type-dependent 3x3 row selector M;
  - the [C]-row human table reduces once per solve to per-pose quadratic
    forms (CompactHuman), so no LM iteration touches the table.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.state import ConstraintTable, CorrectionType
from .geometry import angle_mod, norm2, rotate

Tensor = torch.Tensor

ODOM_RADIAL_STD = 0.03
ODOM_TANGENTIAL_STD = 0.03
ODOM_ANGULAR_STD = 0.01
_EPS = 1e-6


@dataclass(frozen=True)
class OdometryFactors:
    """Fixed per-factor constants for the P-1 chain factors (i-1, i)."""

    axis: Tensor      # [F, 2, 2] rows = (radial, tangential) directions
    radial: Tensor    # [F] radial translation target
    rotation: Tensor  # [F] relative rotation target
    inv_sigma: Tensor  # [F, 3] 1/std for (radial, tangential, angular)


@dataclass(frozen=True)
class HumanFactors:
    """Unary human factors in unified form r = M (q_target - q)."""

    pose_idx: Tensor  # [C] int32 constrained pose
    M: Tensor         # [C, 3, 3] row-selector / direction matrix
    target: Tensor    # [C, 3] target (x, y, theta)
    active: Tensor    # [C] bool


def build_odometry_factors(poses: Tensor,
                           inv_sigma: Tensor | None = None
                           ) -> OdometryFactors:
    """Factor constants from the current poses, vectorized over the chain.

    `inv_sigma` replaces the fixed noise model by per-factor [F, 3] inverse
    standard deviations (the EnML loop-closure mode weights each chain
    factor by its pose covariance ellipse)."""
    p0, p1 = poses[:-1], poses[1:]
    trans = p1[:, :2] - p0[:, :2]
    norm = norm2(trans)
    degenerate = (torch.abs(trans[:, 0]) < _EPS) & (torch.abs(trans[:, 1]) < _EPS)

    local = rotate(-p0[:, 2], trans)
    radial_moving = local / torch.clamp(norm, min=_EPS)[:, None]
    radial_still = torch.stack([torch.cos(p1[:, 2]), torch.sin(p1[:, 2])], -1)
    radial_dir = torch.where(degenerate[:, None], radial_still, radial_moving)
    tangential_dir = torch.stack([-radial_dir[:, 1], radial_dir[:, 0]], -1)

    axis = torch.stack([radial_dir, tangential_dir], dim=-2)  # rows
    radial = torch.where(degenerate, torch.zeros_like(norm), norm)
    rotation = angle_mod(p1[:, 2] - p0[:, 2])
    if inv_sigma is None:
        inv_sigma = torch.tensor(
            [1.0 / ODOM_RADIAL_STD, 1.0 / ODOM_TANGENTIAL_STD,
             1.0 / ODOM_ANGULAR_STD], dtype=poses.dtype,
            device=poses.device).expand(axis.shape[0], 3)
    else:
        inv_sigma = torch.as_tensor(inv_sigma, dtype=poses.dtype,
                                    device=poses.device)
    return OdometryFactors(axis=axis, radial=radial, rotation=rotation,
                           inv_sigma=inv_sigma)


def odometry_residuals(f: OdometryFactors, poses: Tensor) -> Tensor:
    """[F, 3] residuals of all chain factors at `poses`."""
    p0, p1 = poses[:-1], poses[1:]
    v = rotate(-p0[:, 2], p1[:, :2] - p0[:, :2])
    u = torch.einsum("fij,fj->fi", f.axis, v)
    r0 = (u[:, 0] - f.radial) * f.inv_sigma[:, 0]
    r1 = u[:, 1] * f.inv_sigma[:, 1]
    r2 = angle_mod(p1[:, 2] - p0[:, 2] - f.rotation) * f.inv_sigma[:, 2]
    return torch.stack([r0, r1, r2], dim=-1)


def _rot_neg(theta: Tensor) -> Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)],
                       dim=-2)


def odometry_jacobians(f: OdometryFactors, poses: Tensor) -> tuple[Tensor, Tensor]:
    """Analytic Jacobians (J1 wrt pose i-1, J2 wrt pose i), each [F, 3, 3]."""
    p0, p1 = poses[:-1], poses[1:]
    dt = p1[:, :2] - p0[:, :2]
    v = rotate(-p0[:, 2], dt)
    B = f.axis * f.inv_sigma[:, :2, None]             # scaled rows [F,2,2]
    ARot = torch.einsum("fij,fjk->fik", B, _rot_neg(p0[:, 2]))
    dv_dth1 = torch.stack([v[:, 1], -v[:, 0]], -1)
    du_dth1 = torch.einsum("fij,fj->fi", B, dv_dth1)

    zeros = torch.zeros_like(f.radial)
    isa = f.inv_sigma[:, 2]
    J2 = torch.cat(
        [
            torch.cat([ARot, torch.zeros_like(du_dth1)[..., None]], -1),
            torch.stack([zeros, zeros, isa], -1)[:, None, :],
        ],
        dim=1,
    )
    J1 = torch.cat(
        [
            torch.cat([-ARot, du_dth1[..., None]], -1),
            torch.stack([zeros, zeros, -isa], -1)[:, None, :],
        ],
        dim=1,
    )
    return J1, J2


def build_human_factors(poses: Tensor, table: ConstraintTable) -> HumanFactors:
    """All human factors from the constraint table at the current anchor
    poses (targets fixed for one solve).

      colocation    M = I            (CORNER too)
      point         M = diag(1,1,0)
      colinear      M rows = [(cos pd, sin pd, 0), (0,0,1), 0]
      perpendicular M rows = [(0,0,1), 0, 0]   (PARALLEL too)
    with target = (anchor_loc + dpar*para + dperp*perp, wrap(anchor_th + dth)).
    """
    anchor = poses[table.anchor.long()]                  # [C, 3]
    ath = anchor[:, 2]
    para = torch.stack([torch.cos(ath), torch.sin(ath)], -1)
    perp_d = torch.stack([-para[:, 1], para[:, 0]], -1)
    target_loc = (
        anchor[:, :2]
        + table.delta_parallel[:, None] * para
        + table.delta_perpendicular[:, None] * perp_d
    )
    target_angle = angle_mod(ath + table.delta_angle)
    target = torch.cat([target_loc, target_angle[:, None]], -1)

    pd = ath + table.penalty_dir
    cpd, spd = torch.cos(pd), torch.sin(pd)
    zeros = torch.zeros_like(cpd)
    ones = torch.ones_like(cpd)

    t = table.ctype
    is_coloc = (t == int(CorrectionType.LINE_SEGMENT)) | (
        t == int(CorrectionType.CORNER))
    is_point = t == int(CorrectionType.POINT)
    is_colin = t == int(CorrectionType.COLINEAR)
    is_angle_only = (t == int(CorrectionType.PERPENDICULAR)) | (
        t == int(CorrectionType.PARALLEL))

    def rows(r0, r1, r2):
        return torch.stack([torch.stack(r0, -1), torch.stack(r1, -1),
                            torch.stack(r2, -1)], dim=-2)

    M_coloc = rows((ones, zeros, zeros), (zeros, ones, zeros), (zeros, zeros, ones))
    M_point = rows((ones, zeros, zeros), (zeros, ones, zeros), (zeros, zeros, zeros))
    M_colin = rows((cpd, spd, zeros), (zeros, zeros, ones), (zeros, zeros, zeros))
    M_angle = rows((zeros, zeros, ones), (zeros, zeros, zeros), (zeros, zeros, zeros))

    def sel(mask):
        return mask[:, None, None]

    M = torch.where(sel(is_coloc), M_coloc,
                    torch.where(sel(is_point), M_point,
                                torch.where(sel(is_colin), M_colin,
                                            torch.where(sel(is_angle_only),
                                                        M_angle,
                                                        torch.zeros_like(M_coloc)))))
    M = M * table.active[:, None, None].to(M.dtype)
    return HumanFactors(pose_idx=table.constrained, M=M, target=target,
                        active=table.active)


def human_residuals(f: HumanFactors, poses: Tensor) -> Tensor:
    """[C, 3] residuals r = M (target - q_constrained); inactive rows are 0."""
    q = poses[f.pose_idx.long()]
    return torch.einsum("cij,cj->ci", f.M, f.target - q)


def human_jacobians(f: HumanFactors) -> Tensor:
    """[C, 3, 3] Jacobian wrt the constrained pose: J = -M (constant)."""
    return -f.M


@dataclass(frozen=True)
class RelativePoseFactors:
    """Chained relative-pose factors (the reference's dormant relative-pose
    parameterization): a BASE pose plus per-step relative (dx, dy, dtheta)
    triples, absolute poses their running sums (additive, not on SE(2), as
    in the reference). Each factor constrains the pair (pose0, pose1) of the
    summed chain with the odometry factor's radial/tangential/angular error,
    except that the angular residual is the raw difference (no wrap)."""

    pose0: Tensor      # [K] int pose ids
    pose1: Tensor      # [K]
    axis: Tensor       # [K, 2, 2] principal-axis transform rows
    radial: Tensor     # [K] radial translation target
    rotation: Tensor   # [K] rotation target
    inv_sigma: Tensor  # [K, 3]


def chain_poses(base_pose: Tensor, rels: Tensor) -> Tensor:
    """[3], [P-1, 3] -> [P, 3] absolute poses by prefix sum."""
    return torch.cumsum(torch.cat([base_pose[None], rels], dim=0), dim=0)


def perp_rows(v: Tensor) -> Tensor:
    return torch.stack([-v[..., 1], v[..., 0]], -1)


def build_relative_pose_factors(
    poses: Tensor, pose0: Tensor, pose1: Tensor,
    radial_std: float = ODOM_RADIAL_STD,
    tangential_std: float = ODOM_TANGENTIAL_STD,
    angular_std: float = ODOM_ANGULAR_STD,
) -> RelativePoseFactors:
    """Factor constants from the current absolute poses for arbitrary
    (pose0, pose1) pairs: the chained-relative analogue of
    build_odometry_factors."""
    p0, p1 = poses[pose0.long()], poses[pose1.long()]
    trans = p1[:, :2] - p0[:, :2]
    norm = norm2(trans)
    degenerate = norm < _EPS
    local = rotate(-p0[:, 2], trans)
    radial_dir = torch.where(
        degenerate[:, None],
        torch.stack([torch.cos(p1[:, 2]), torch.sin(p1[:, 2])], -1),
        local / torch.clamp(norm, min=_EPS)[:, None])
    axis = torch.stack([radial_dir, perp_rows(radial_dir)], dim=-2)
    inv_sigma = torch.tensor(
        [1.0 / radial_std, 1.0 / tangential_std, 1.0 / angular_std],
        dtype=poses.dtype, device=poses.device).expand(len(p0), 3)
    return RelativePoseFactors(
        pose0=pose0, pose1=pose1, axis=axis,
        radial=torch.where(degenerate, torch.zeros_like(norm), norm),
        rotation=p1[:, 2] - p0[:, 2],
        inv_sigma=inv_sigma,
    )


def relative_pose_residuals(f: RelativePoseFactors, base_pose: Tensor,
                            rels: Tensor) -> Tensor:
    """[K, 3] residuals over the relative-pose parameterization. They depend
    on every rel up to each factor's poses (through the prefix sum); the
    chain Jacobian is autograd's (`torch.func.jacrev`)."""
    poses = chain_poses(base_pose, rels)
    p0, p1 = poses[f.pose0.long()], poses[f.pose1.long()]
    t = rotate(-p0[:, 2], p1[:, :2] - p0[:, :2])
    u = torch.einsum("kij,kj->ki", f.axis, t)
    r0 = (u[:, 0] - f.radial) * f.inv_sigma[:, 0]
    r1 = u[:, 1] * f.inv_sigma[:, 1]
    # raw (unwrapped) angular difference, as in the reference
    r2 = (p1[:, 2] - p0[:, 2] - f.rotation) * f.inv_sigma[:, 2]
    return torch.stack([r0, r1, r2], dim=-1)


@dataclass(frozen=True)
class CompactHuman:
    """Per-pose pre-reduction of the human-constraint table, about the
    build-time poses q0 (e = q0 - q):

        A_p = sum_a M_a^T M_a,  c_p = sum_a M_a^T d_a,  k = sum_a d_a^T d_a
        H_h[p] = A_p,  g_h[p] = -(c_p + A_p e_p),
        cost_h = 0.5 (k + sum_p 2 e_p.c_p + e_p.A_p e_p)
    """

    q0: Tensor  # [P, 3] build-time poses (linearization reference)
    A: Tensor   # [P, 3, 3]
    c: Tensor   # [P, 3]
    k: Tensor   # scalar


def compact_human_factors(f: HumanFactors, poses0: Tensor,
                          onehot: Tensor | None = None) -> CompactHuman:
    """Reduce the [C]-row factor table to CompactHuman at poses0.

    With `onehot` ([C, P]) the table -> pose reduction is one matmul, whose
    sum order does not depend on the run; without it, an index_add_, which
    on CUDA sums colliding rows with atomics in a run-dependent order.
    """
    P = poses0.shape[0]
    idx = f.pose_idx.long()
    d = torch.einsum("cij,cj->ci", f.M, f.target - poses0[idx])   # [C,3]
    MTM = torch.einsum("cki,ckj->cij", f.M, f.M)                  # [C,3,3]
    MTd = torch.einsum("cki,ck->ci", f.M, d)                      # [C,3]
    if onehot is not None:
        A = (onehot.T @ MTM.reshape(-1, 9)).reshape(P, 3, 3)
        c = onehot.T @ MTd
    else:
        A = torch.zeros((P, 3, 3), dtype=poses0.dtype,
                        device=poses0.device).index_add_(0, idx, MTM)
        c = torch.zeros((P, 3), dtype=poses0.dtype,
                        device=poses0.device).index_add_(0, idx, MTd)
    k = torch.sum(d * d)
    return CompactHuman(q0=poses0, A=A, c=c, k=k)


def compact_human_terms(ch: CompactHuman, poses: Tensor
                        ) -> tuple[Tensor, Tensor, Tensor]:
    """(H_blocks [P,3,3], g [P,3], cost scalar) of all human factors at
    `poses`, from the per-pose pre-reduction."""
    e = ch.q0 - poses
    Ae = torch.einsum("pij,pj->pi", ch.A, e)
    g = -(ch.c + Ae)
    cost = 0.5 * (ch.k + torch.sum(e * (2.0 * ch.c + Ae)))
    return ch.A, g, cost
