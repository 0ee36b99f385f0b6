"""Levenberg-Marquardt minimizer for the joint HitL problem.

Port of hitl_slam_tpu/solver/lm.py with the same semantics:

  - Madsen-Nielsen-Tingleff damping on mu * clip(diag(H)) (Jacobi-scaled,
    diagonal clamped to [min_diagonal, max_diagonal]);
  - termination on the relative function decrease of an accepted step, the
    relative step size (checked on rejected steps too), or trust-region
    collapse (mu >= mu_collapse); rejected steps count as iterations;
  - the optional `mu0` warm start, clipped into [1e-6, 1e-1].

Each iteration does one residual+Jacobian pass at the trial point. The
on-device `lax.while_loop` of the reference becomes a Python loop that reads
one flag (`done`) from the device per iteration.

Default linear solver: the CUDA block-cyclic-reduction kernel for CUDA
tensors, its plain torch version for CPU tensors (solver/bcr_kernel.py),
at every pose count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .assembly_soa import normal_equations_soa, soa_constants
from .joint import JointProblem

Tensor = torch.Tensor


def _default_linear_solver(device) -> Callable[[Tensor, Tensor, Tensor], Tensor]:
    """The block-tridiagonal solver LM uses on `device`: the CUDA kernel
    on a CUDA device, the plain version on the CPU."""
    from . import bcr_kernel, tridiag

    kind = torch.device(device).type
    if kind == "cuda":
        return bcr_kernel.bcr_solve_cuda
    if kind == "cpu":
        return tridiag.bcr_solve
    raise ValueError(f"no block-tridiagonal solver for device {device}")


@dataclass(frozen=True)
class LMConfig:
    max_iterations: int = 100
    function_tolerance: float = 1e-6
    parameter_tolerance: float = 1e-7
    initial_mu: float = 1e-4        # damping = mu * diag(H)
    mu_collapse: float = 1e10       # trust region collapsed -> converged
    min_diagonal: float = 1e-6      # clamp for Jacobi scaling
    max_diagonal: float = 1e32


@dataclass(frozen=True)
class LMResult:
    poses: Tensor        # [P, 3] optimized
    final_cost: Tensor   # scalar
    initial_cost: Tensor
    iterations: Tensor   # scalar int32
    converged: Tensor    # scalar bool
    final_mu: Tensor     # scalar, damping at exit (warm-start source)


def _scalar(v: float, like: Tensor) -> Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def solve(
    problem: JointProblem,
    poses0: Tensor,
    config: LMConfig = LMConfig(),
    linear_solver: Callable[[Tensor, Tensor, Tensor], Tensor] | None = None,
    mu0: Tensor | None = None,
) -> LMResult:
    """Run LM from poses0."""
    if linear_solver is None:
        linear_solver = _default_linear_solver(poses0.device)
    sc = soa_constants(problem)

    def assemble(x):
        return normal_equations_soa(problem, sc, x)

    D, U, g, c = assemble(poses0)
    c0 = c
    x = poses0
    if mu0 is None:
        mu = _scalar(config.initial_mu, poses0)
    else:
        mu = torch.clamp(torch.as_tensor(mu0, dtype=poses0.dtype,
                                         device=poses0.device), 1e-6, 1e-1)
    nu = _scalar(2.0, poses0)
    two = _scalar(2.0, poses0)
    third = _scalar(1.0 / 3.0, poses0)
    it = 0
    done = torch.zeros((), dtype=torch.bool, device=poses0.device)
    while it < config.max_iterations:
        diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1),
                           config.min_diagonal, config.max_diagonal)
        D_damped = D + mu * torch.diag_embed(diag)
        step = linear_solver(D_damped, U, -g)
        x_new = x + step
        D_new, U_new, g_new, c_new = assemble(x_new)

        # model decrease L(0) - L(step) in the MNT form
        pred = 0.5 * torch.sum(step * (mu * diag * step - g))
        rho = (c - c_new) / torch.clamp(pred, min=1e-30)

        accept = (rho > 0) & torch.isfinite(c_new)
        x = torch.where(accept, x_new, x)
        D = torch.where(accept, D_new, D)
        U = torch.where(accept, U_new, U)
        g = torch.where(accept, g_new, g)
        c_next = torch.where(accept, c_new, c)

        t = 2.0 * rho - 1.0
        factor = torch.maximum(third, 1.0 - t * (t * t))
        mu = torch.where(accept, mu * factor, mu * nu)
        nu = torch.where(accept, two, nu * 2.0)
        mu = torch.clamp(mu, 1e-32, 1e32)

        # relative function decrease (accepted steps only), relative step
        # size (every step), or trust-region collapse
        fdone = accept & (torch.abs(c - c_new) <= config.function_tolerance * c)
        xnorm = torch.sqrt(torch.sum(x * x))
        sdone = (torch.sqrt(torch.sum(step * step))
                 <= config.parameter_tolerance
                 * (xnorm + config.parameter_tolerance))
        mdone = mu >= config.mu_collapse
        c = c_next
        it += 1
        done = done | fdone | sdone | mdone
        if bool(done):
            break
    return LMResult(
        poses=x, final_cost=c, initial_cost=c0,
        iterations=torch.tensor(it, dtype=torch.int32, device=poses0.device),
        converged=done, final_mu=mu,
    )
