"""Matrix-free preconditioned conjugate gradient for the Gauss-Newton
normal equations.

Port of hitl_slam_tpu/solver/cg.py. The Hessian is applied without being
formed: H v = D v + U v_+ + U^T v_- for the block-tridiagonal part, plus an
optional callable for further terms (the STF pair blocks of
solver/stf_solve.py). Two preconditioners: the closed-form 3x3 block-diagonal
inverse, or an exact solve of the block-tridiagonal part (factored once per
linear solve by `bcr_factor`, applied once per iteration by `bcr_apply`).
The reference's `lax.while_loop` becomes a `device_while` over a carry of
buffers (utils/device_loop.py): eagerly one host read of the relative
residual test an iteration, inside a LoopGraph capture a WHILE node (inside
the LM loop's, for the STF refine of solver/stf_solve.py).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.device_loop import device_while
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
) -> tuple[Tensor, Tensor, Tensor]:
    """Solve (H_tridiag + extra) x = b. Returns (x, final relative
    residual, iterations: a 0-dim int32 tensor).

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

    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - A(x)
    p = prec(r)
    rz = torch.sum(r * p)
    b_norm = torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    go = torch.linalg.vector_norm(r) / b_norm > tolerance

    def iteration():
        Ap = A(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x.copy_(x + alpha * p)
        r.copy_(r - alpha * Ap)
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p.copy_(z + beta * p)
        rz.copy_(rz_new)
        it.add_(1)
        torch.gt(torch.linalg.vector_norm(r) / b_norm, tolerance, out=go)

    device_while(go, iteration, max_iterations, name="cg")
    return x, torch.linalg.vector_norm(r) / b_norm, it


def pcg_tridiag(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Drop-in linear_solver for solver/lm.py (same signature as
    bcr_solve)."""
    x, _, _ = pcg_solve(D, U, b)
    return x
