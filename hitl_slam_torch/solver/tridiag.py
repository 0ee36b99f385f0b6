"""Block-tridiagonal solve of the Gauss-Newton normal equations, in torch.

Port of hitl_slam_tpu/solver/tridiag.py (`inv3`, `bcr_solve`, `bcr_factor`,
`bcr_apply`). The joint problem's Hessian is block-tridiagonal with 3x3
blocks; `bcr_solve` is block cyclic reduction: pad to a power of two with
decoupled identity rows, then log2(n) levels of batched 3x3 algebra over
halved arrays, then back-substitution. It is the plain version of the CUDA
kernel in csrc/bcr.cu (same padding, elimination order and adjugate
inverses), and the solver LM uses on CPU tensors. `bcr_factor` keeps the
matrix-dependent half of that elimination so that `bcr_apply` solves many
right-hand sides with matrix-vector products only (the PCG preconditioner
of solver/cg.py).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def inv3(m: Tensor) -> Tensor:
    """Closed-form inverse of batched 3x3 matrices via the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = torch.stack(
        [
            torch.stack([A, D, G], -1),
            torch.stack([B, E, H], -1),
            torch.stack([C, F, I], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _mv(A: Tensor, v: Tensor) -> Tensor:
    return (A @ v[..., None])[..., 0]


def bcr_solve(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Solve H x = b with H[i,i] = D[i], H[i,i+1] = U[i], H[i+1,i] = U[i]^T.

    D: [n,3,3], U: [n-1,3,3], b: [n,3]. Returns x: [n,3].
    """
    n = D.shape[0]
    m = next_pow2(n)
    dt, dev = D.dtype, D.device
    # general (L, U) representation; start symmetric: L[i] = U[i-1]^T
    Df, Lf, Uf = _pad_system(D, U)
    bf = torch.cat([b, torch.zeros((m - n, 3), dtype=dt, device=dev)], 0)
    z3 = torch.zeros((1, 3, 3), dtype=dt, device=dev)
    z1 = torch.zeros((1, 3), dtype=dt, device=dev)

    levels = []
    while Df.shape[0] > 1:
        De, Do = Df[0::2], Df[1::2]
        Le, Lo = Lf[0::2], Lf[1::2]
        Ue, Uo = Uf[0::2], Uf[1::2]
        be, bo = bf[0::2], bf[1::2]

        Do_inv = inv3(Do)
        DinvL = Do_inv @ Lo
        DinvU = Do_inv @ Uo
        Dinvb = _mv(Do_inv, bo)

        # left odd neighbour of even k is odd k-1 (zero-padded at k=0)
        DinvL_l = torch.cat([z3, DinvL[:-1]], 0)
        DinvU_l = torch.cat([z3, DinvU[:-1]], 0)
        Dinvb_l = torch.cat([z1, Dinvb[:-1]], 0)

        D_new = De - Le @ DinvU_l - Ue @ DinvL
        L_new = -(Le @ DinvL_l)
        U_new = -(Ue @ DinvU)
        b_new = be - _mv(Le, Dinvb_l) - _mv(Ue, Dinvb)

        levels.append((Lo, Uo, bo, Do_inv))
        Df, Lf, Uf, bf = D_new, L_new, U_new, b_new

    x = _mv(inv3(Df[0]), bf[0])[None]  # [1,3]

    for Lo, Uo, bo, Do_inv in reversed(levels):
        h = Lo.shape[0]
        x_even = x
        x_even_r = torch.cat([x[1:], z1], 0)
        rhs = bo - _mv(Lo, x_even) - _mv(Uo, x_even_r)
        x_odd = _mv(Do_inv, rhs)
        x = torch.stack([x_even, x_odd], dim=1).reshape(2 * h, 3)

    return x[:n]


def _pad_system(D: Tensor, U: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(Df, Lf, Uf), each [next_pow2(n), 3, 3]: D padded with identity
    blocks, U with zeros, and L[i] = U[i-1]^T."""
    n = D.shape[0]
    m = next_pow2(n)
    dt, dev = D.dtype, D.device
    eye = torch.eye(3, dtype=dt, device=dev).expand(m - n, 3, 3)
    Df = torch.cat([D, eye], 0)
    Uf = torch.cat([U, torch.zeros((m - n + 1, 3, 3), dtype=dt, device=dev)], 0)
    Lf = torch.cat([torch.zeros((1, 3, 3), dtype=dt, device=dev),
                    Uf[:-1].transpose(-1, -2)], 0)
    return Df, Lf, Uf


def bcr_factor(D: Tensor, U: Tensor):
    """The matrix-dependent half of `bcr_solve`, reusable across right-hand
    sides: per level the elimination operators (Le, Ue, Lo, Uo, Do_inv), and
    the root inverse. Returns (levels, root_inv, n)."""
    n = D.shape[0]
    Df, Lf, Uf = _pad_system(D, U)
    z3 = torch.zeros((1, 3, 3), dtype=D.dtype, device=D.device)

    levels = []
    while Df.shape[0] > 1:
        De, Do = Df[0::2], Df[1::2]
        Le, Lo = Lf[0::2], Lf[1::2]
        Ue, Uo = Uf[0::2], Uf[1::2]

        Do_inv = inv3(Do)
        DinvL = Do_inv @ Lo
        DinvU = Do_inv @ Uo
        DinvL_l = torch.cat([z3, DinvL[:-1]], 0)
        DinvU_l = torch.cat([z3, DinvU[:-1]], 0)

        D_new = De - Le @ DinvU_l - Ue @ DinvL
        L_new = -(Le @ DinvL_l)
        U_new = -(Ue @ DinvU)

        levels.append((Le, Ue, Lo, Uo, Do_inv))
        Df, Lf, Uf = D_new, L_new, U_new

    return tuple(levels), inv3(Df[0]), n


def bcr_apply(factor, b: Tensor) -> Tensor:
    """Solve with a `bcr_factor` factorization: the right-hand side's
    reduction and the back-substitution only. Same result as
    `bcr_solve(D, U, b)` for the factored (D, U)."""
    levels, root_inv, n = factor
    m = next_pow2(n)
    dt, dev = b.dtype, b.device
    bf = torch.cat([b, torch.zeros((m - n, 3), dtype=dt, device=dev)], 0)
    z1 = torch.zeros((1, 3), dtype=dt, device=dev)

    rhs_stack = []
    for Le, Ue, _, _, Do_inv in levels:
        be, bo = bf[0::2], bf[1::2]
        Dinvb = _mv(Do_inv, bo)
        Dinvb_l = torch.cat([z1, Dinvb[:-1]], 0)
        bf = be - _mv(Le, Dinvb_l) - _mv(Ue, Dinvb)
        rhs_stack.append(bo)

    x = _mv(root_inv, bf[0])[None]  # [1,3]

    for (_, _, Lo, Uo, Do_inv), bo in zip(reversed(levels),
                                          reversed(rhs_stack)):
        x_even = x
        x_even_r = torch.cat([x[1:], z1], 0)
        rhs = bo - _mv(Lo, x_even) - _mv(Uo, x_even_r)
        x_odd = _mv(Do_inv, rhs)
        x = torch.stack([x_even, x_odd], dim=1).reshape(-1, 3)

    return x[:n]
