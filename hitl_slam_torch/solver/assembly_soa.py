"""Structure-of-arrays normal-equations assembly for the joint LM solve.

Port of hitl_slam_tpu/solver/assembly_soa.py: the normal equations of the
joint problem (the reference's joint.normal_equations, up to f32
reassociation), with every intermediate a flat [P]-length vector. With

    p = ax*cos(th0) - ay*sin(th0),  q = ax*sin(th0) + ay*cos(th0)
    ARot = [[i0*p, i0*q], [-i1*q, i1*p]]      (B @ R(-th0))

the factor blocks reduce to

    S   = ARot^T ARot
    t   = ARot^T du   (du = d(scaled residual)/dth0)
    J1^T J1 = [[S, -t], [-t^T, du.du + i2^2]]
    J2^T J2 = [[S, 0], [0, i2^2]]
    U = J1^T J2 = [[-S, 0], [t^T, -i2^2]]

Human factors enter through the CompactHuman per-pose reduction, converted
to SoA once per solve by `soa_constants`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.geometry import angle_mod
from .joint import JointProblem

Tensor = torch.Tensor


@dataclass(frozen=True)
class SoaConstants:
    """Per-solve constants in flat [P]/[F] layout."""

    ax: Tensor   # [F] radial direction x
    ay: Tensor   # [F] radial direction y
    d: Tensor    # [F] radial translation target
    w: Tensor    # [F] rotation target
    A00: Tensor  # compact human terms, [P] each (A symmetric)
    A01: Tensor
    A02: Tensor
    A11: Tensor
    A12: Tensor
    A22: Tensor
    c0: Tensor
    c1: Tensor
    c2: Tensor
    q00: Tensor
    q01: Tensor
    q02: Tensor
    k: Tensor    # scalar cost offset


def soa_constants(problem: JointProblem) -> SoaConstants:
    """Unpack the problem's factor constants into SoA vectors (once per
    solve)."""
    od = problem.odom
    ch = problem.compact
    A = ch.A.reshape(-1, 9).T.contiguous()  # [9, P]
    c = ch.c.T.contiguous()                 # [3, P]
    q0 = ch.q0.T.contiguous()
    return SoaConstants(
        ax=od.axis[:, 0, 0].contiguous(), ay=od.axis[:, 0, 1].contiguous(),
        d=od.radial, w=od.rotation,
        A00=A[0], A01=A[1], A02=A[2], A11=A[4], A12=A[5], A22=A[8],
        c0=c[0], c1=c[1], c2=c[2], q00=q0[0], q01=q0[1], q02=q0[2],
        k=ch.k,
    )


def normal_equations_soa(problem: JointProblem, sc: SoaConstants,
                         poses: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Returns (D [P,3,3], U [P-1,3,3], g [P,3], cost), gauge-fixed at
    pose 0: its couplings are zeroed and D[0] = I, g[0] = 0."""
    dtype, dev = poses.dtype, poses.device
    P = problem.num_poses
    inv = problem.odom.inv_sigma
    i0, i1, i2 = inv[:, 0], inv[:, 1], inv[:, 2]
    pt = poses.T                       # [3, P]
    x, y, th = pt[0], pt[1], pt[2]
    x0, y0, th0 = x[:-1], y[:-1], th[:-1]
    x1, y1, th1 = x[1:], y[1:], th[1:]

    cth, sth = torch.cos(th0), torch.sin(th0)
    dtx, dty = x1 - x0, y1 - y0
    vx = cth * dtx + sth * dty         # v = R(-th0) dt
    vy = -sth * dtx + cth * dty

    # residuals
    u0 = sc.ax * vx + sc.ay * vy
    u1 = -sc.ay * vx + sc.ax * vy
    r0 = (u0 - sc.d) * i0
    r1 = u1 * i1
    r2 = angle_mod(th1 - th0 - sc.w) * i2

    # Jacobian scalars
    p = sc.ax * cth - sc.ay * sth
    q = sc.ax * sth + sc.ay * cth
    du0 = i0 * (sc.ax * vy - sc.ay * vx)
    du1 = -i1 * (sc.ay * vy + sc.ax * vx)

    i0sq, i1sq, i2sq = i0 * i0, i1 * i1, i2 * i2
    S00 = i0sq * p * p + i1sq * q * q
    S01 = (i0sq - i1sq) * p * q
    S11 = i0sq * q * q + i1sq * p * p
    t0 = i0 * p * du0 - i1 * q * du1
    t1 = i0 * q * du0 + i1 * p * du1
    e22 = du0 * du0 + du1 * du1 + i2sq

    gv0 = i0 * p * r0 - i1 * q * r1
    gv1 = i0 * q * r0 + i1 * p * r1
    g2a = du0 * r0 + du1 * r1 - i2 * r2   # J1^T r third component
    g2b = i2 * r2                          # J2^T r third component

    # human factors (CompactHuman in SoA): e = q0 - poses
    e0, e1, e2 = sc.q00 - x, sc.q01 - y, sc.q02 - th
    Ae0 = sc.A00 * e0 + sc.A01 * e1 + sc.A02 * e2
    Ae1 = sc.A01 * e0 + sc.A11 * e1 + sc.A12 * e2
    Ae2 = sc.A02 * e0 + sc.A12 * e1 + sc.A22 * e2
    gh0, gh1, gh2 = -(sc.c0 + Ae0), -(sc.c1 + Ae1), -(sc.c2 + Ae2)
    cost_h = 0.5 * (sc.k + torch.sum(e0 * (2.0 * sc.c0 + Ae0)
                                     + e1 * (2.0 * sc.c1 + Ae1)
                                     + e2 * (2.0 * sc.c2 + Ae2)))

    z1 = torch.zeros((1,), dtype=dtype, device=dev)

    def padl(a):   # contribution of factor f to pose f+1 (J2 side)
        return torch.cat([z1, a])

    def padr(a):   # contribution of factor f to pose f (J1 side)
        return torch.cat([a, z1])

    D00 = sc.A00 + padr(S00) + padl(S00)
    D01 = sc.A01 + padr(S01) + padl(S01)
    D02 = sc.A02 + padr(-t0)
    D11 = sc.A11 + padr(S11) + padl(S11)
    D12 = sc.A12 + padr(-t1)
    D22 = sc.A22 + padr(e22) + padl(i2sq)

    g0 = gh0 + padr(-gv0) + padl(gv0)
    g1 = gh1 + padr(-gv1) + padl(gv1)
    g2 = gh2 + padr(g2a) + padl(g2b)

    # gauge fix pose 0
    gate = torch.cat([z1, torch.ones((P - 1,), dtype=dtype, device=dev)])
    D00 = D00 * gate + (1.0 - gate)
    D11 = D11 * gate + (1.0 - gate)
    D22 = D22 * gate + (1.0 - gate)
    D01, D02, D12 = D01 * gate, D02 * gate, D12 * gate
    g0, g1, g2 = g0 * gate, g1 * gate, g2 * gate
    if P > 2:
        uz = torch.cat([z1, torch.ones((P - 2,), dtype=dtype, device=dev)])
    else:
        uz = torch.zeros((P - 1,), dtype=dtype, device=dev)

    zF = torch.zeros((P - 1,), dtype=dtype, device=dev)

    # [3,3,P] stack -> [P,3,3]
    D = torch.stack([
        torch.stack([D00, D01, D02]),
        torch.stack([D01, D11, D12]),
        torch.stack([D02, D12, D22]),
    ]).permute(2, 0, 1).contiguous()
    U = (torch.stack([
        torch.stack([-S00, -S01, zF]),
        torch.stack([-S01, -S11, zF]),
        torch.stack([t0, t1, -i2sq]),
    ]) * uz).permute(2, 0, 1).contiguous()
    g = torch.stack([g0, g1, g2]).T.contiguous()

    cost = 0.5 * torch.sum(r0 * r0 + r1 * r1 + r2 * r2) + cost_h
    return D, U, g, cost
