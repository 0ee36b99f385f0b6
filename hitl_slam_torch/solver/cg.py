"""Matrix-free preconditioned conjugate gradient for the Gauss-Newton
normal equations.

Port of hitl_slam_tpu/solver/cg.py. The Hessian is applied without being
formed: H v = D v + U v_+ + U^T v_- for the block-tridiagonal part, plus an
optional callable for further terms (the STF pair blocks of
solver/stf_solve.py). Two preconditioners: the closed-form 3x3 block-diagonal
inverse, or an exact solve of the block-tridiagonal part (factored once per
linear solve by `bcr_factor`, applied once per iteration by `bcr_apply`).
The reference's `lax.while_loop` becomes a Python loop that reads the
relative residual from the device once per iteration.
"""

from __future__ import annotations

from typing import Callable

import torch

from .tridiag import _mv, bcr_apply, bcr_factor, inv3

Tensor = torch.Tensor


def tridiag_matvec(D: Tensor, U: Tensor, v: Tensor) -> Tensor:
    """H v for the symmetric block-tridiagonal H (H[i,i] = D[i],
    H[i,i+1] = U[i], H[i+1,i] = U[i]^T): [n,3] -> [n,3]."""
    out = _mv(D, v)
    out[:-1] += _mv(U, v[1:])
    out[1:] += _mv(U.transpose(-1, -2), v[:-1])
    return out


def pcg_solve(
    D: Tensor,
    U: Tensor,
    b: Tensor,
    extra_matvec: Callable[[Tensor], Tensor] | None = None,
    max_iterations: int = 256,
    tolerance: float = 1e-6,
    x0: Tensor | None = None,
    preconditioner: str = "jacobi",
) -> tuple[Tensor, Tensor, int]:
    """Solve (H_tridiag + extra) x = b. Returns (x, final relative
    residual, iterations).

    preconditioner:
      - "jacobi": closed-form 3x3 block-diagonal inverse.
      - "tridiag": exact solve of the block-tridiagonal part, so the
        iteration count depends only on the strength of `extra`.
    """
    def A(v):
        out = tridiag_matvec(D, U, v)
        if extra_matvec is not None:
            out = out + extra_matvec(v)
        return out

    if preconditioner == "tridiag":
        fac = bcr_factor(D, U)

        def prec(r):
            return bcr_apply(fac, r)
    elif preconditioner == "jacobi":
        Minv = inv3(D)

        def prec(r):
            return _mv(Minv, r)
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = prec(r)
    p = z
    rz = torch.sum(r * z)
    b_norm = torch.clamp(torch.linalg.vector_norm(b), min=1e-30)

    it = 0
    while it < max_iterations and bool(
            torch.linalg.vector_norm(r) / b_norm > tolerance):
        Ap = A(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, torch.linalg.vector_norm(r) / b_norm, it


def pcg_tridiag(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Drop-in linear_solver for solver/lm.py (same signature as
    bcr_solve)."""
    x, _, _ = pcg_solve(D, U, b)
    return x
