"""Levenberg-Marquardt minimizer for the joint HitL problem.

Port of hitl_slam_tpu/solver/lm.py with the same semantics:

  - Madsen-Nielsen-Tingleff damping on mu * clip(diag(H)) (Jacobi-scaled,
    diagonal clamped to [min_diagonal, max_diagonal]);
  - termination on the relative function decrease of an accepted step, the
    relative step size (checked on rejected steps too), or trust-region
    collapse (mu >= mu_collapse); rejected steps count as iterations;
  - the optional `mu0` warm start, clipped into [1e-6, 1e-1].

Each iteration does one residual+Jacobian pass at the trial point. Outside
the linear solve an iteration is solver/lm_step.py's `trip`: on a card one
launch of its kernel (the trial point's assembly, accept, the damping
update, the exit tests and the next damped system), on the CPU its plain
version, which is the SoA assembly and the tail below, op for op. The
on-device `lax.while_loop` of the reference becomes
`utils/device_loop.py::device_while`: eagerly a Python loop that reads one
flag from the device an iteration, inside a CUDA graph capture
(`LoopGraph`) a WHILE node that reads nothing. On a CUDA device a call of
`solve` outside a capture replays the captured program of its shapes
(`solve_program`), as the reference runs its jitted `solve_jit`.

`solve_batched` is the LM of B independent problems stacked on a leading
replica dimension, what the reference computes as a `vmap` of `solve`
(parallel/replicas.py): every replica keeps its own damping, iteration count
and exit, and a step updates the state of the replicas that are still
active (not done, under the iteration cap) only. The whole batch stays in
every step, so one batched linear solve runs a step. Its steps are a
`device_while` too: eagerly one host read (any replica active) a step, on
a CUDA device a replay of a captured program (`DeviceProgram`) that reads
nothing back.

Default linear solver: the CUDA block-cyclic-reduction kernel for CUDA
tensors (its batched route for `solve_batched`), its plain torch version for
CPU tensors (solver/bcr_kernel.py), at every pose count.

The reference's `solve_jit` is `jax.jit` of `solve`; the port's `solve`
already replays a device program on a card, so its `solve_jit` is `solve`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..utils.device_loop import (DeviceProgram, ProgramCache, device_while,
                                 replays, signature)
from . import lm_step
from .assembly_soa import normal_equations_soa, soa_constants
from .joint import JointProblem, normal_equations

Tensor = torch.Tensor


def _default_linear_solver(device, batched: bool = False
                           ) -> Callable[[Tensor, Tensor, Tensor], Tensor]:
    """The block-tridiagonal solver LM uses on `device`: the CUDA kernel
    (its batched route for stacked systems) on a CUDA device, the plain
    version on the CPU."""
    from . import bcr_kernel, tridiag

    kind = torch.device(device).type
    if kind == "cuda":
        return (bcr_kernel.bcr_solve_cuda_batched if batched
                else bcr_kernel.bcr_solve_cuda)
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
    """A scalar of like's dtype on its device, made there (no host copy,
    so it may be made inside a CUDA graph capture)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _assembler(problem: JointProblem, use_soa: bool):
    """x -> (D, U, g, cost): the lane-major assembly, or the block-array
    one of joint.normal_equations."""
    if not use_soa:
        return lambda x: normal_equations(problem, x)
    sc = soa_constants(problem)
    return lambda x: normal_equations_soa(problem, sc, x)


def solve(
    problem: JointProblem,
    poses0: Tensor,
    config: LMConfig = LMConfig(),
    linear_solver: Callable[[Tensor, Tensor, Tensor], Tensor] | None = None,
    use_soa: bool = True,
    mu0: Tensor | None = None,
    *,
    accepts: list | None = None,
    eager: bool = False,
) -> LMResult:
    """Run LM from poses0. `use_soa=False` assembles with
    joint.normal_equations. A list passed as `accepts` receives each
    iteration's accept flag (a bool tensor); inside a LoopGraph capture it
    receives one [max_iterations] bool buffer instead, whose first
    `iterations` entries a replay writes.

    The iteration is the body of a `device_while` over a carry of buffers
    (x, D, U, g, c, mu, nu, done and the iteration count), each written
    with `copy_`: eagerly a loop with one host read an iteration, inside a
    LoopGraph a WHILE node of the graph. On a CUDA device, outside a
    capture, the call replays the program of its shapes, config,
    assembly, linear solver and warm start (`solve_program`: one WHILE
    node) unless `eager`, which runs the same code eagerly there, for
    comparisons only; a replay reads the host only where `accepts` asks
    for the flags."""
    if replays(poses0, eager):
        args = (problem, poses0)
        if mu0 is not None:
            args += (torch.as_tensor(mu0, dtype=poses0.dtype,
                                     device=poses0.device),)
        out, flags = solve_program(args, config, linear_solver,
                                   use_soa).run(*args)
        if accepts is not None:
            accepts.extend(flags[:int(out.iterations)].unbind(0))
        return out
    return _solve(problem, poses0, config, linear_solver, use_soa, mu0,
                  accepts=accepts)


_solve_programs = ProgramCache(size=2)


def solve_program(example: tuple, config: LMConfig = LMConfig(),
                  linear_solver: Callable | None = None,
                  use_soa: bool = True) -> DeviceProgram:
    """The lone LM's program on a CUDA device for inputs shaped as
    `example` ((problem, poses0) or, with a warm start, (problem, poses0,
    mu0)), `config`, the assembly and `linear_solver` (None: the device's
    default): the one made before, or a new one (captured at its first
    run). A run returns (the LMResult, the [max_iterations] accept
    flags)."""
    dev = example[1].device
    # resolved before the capture, which may then count its launches
    solver = linear_solver or _default_linear_solver(dev)

    def fn(problem, poses0, *mu0):
        flags = []
        out = _solve(problem, poses0, config, solver, use_soa,
                     mu0[0] if mu0 else None, accepts=flags)
        return out, flags[0]

    key = (signature(example), config, solver, use_soa, dev.index)
    return _solve_programs.get(key, lambda: DeviceProgram(fn, example, dev,
                                                          name="lm"))


def _solve(problem, poses0, config, linear_solver=None, use_soa=True,
           mu0=None, *, accepts=None) -> LMResult:
    """solve's carry form, eager or captured. A trip is the linear solve
    and lm_step.trip: on a card, one launch of the BCR kernel and one of
    the trip kernel (the first assembly one more before the loop); on the
    CPU, and with the AoS assembly, the plain version."""
    if linear_solver is None:
        linear_solver = _default_linear_solver(poses0.device)
    dev = poses0.device
    if use_soa:
        s = lm_step.begin(problem, poses0, config, mu0)
    else:
        s = lm_step.begin_reference(_assembler(problem, False), poses0,
                                    config, mu0)
    captured = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    # the plain version hands back each accept flag; the kernel writes them
    # into its [max_iterations] flags
    flags = s.accepted
    if flags is None and accepts is not None and captured:
        flags = torch.zeros((config.max_iterations,), dtype=torch.bool,
                            device=dev)

    def iteration():
        step = linear_solver(*lm_step.system(s, config))
        accept = lm_step.trip(s, step, config)
        if accept is None:
            return
        if flags is not None:
            flags.index_put_((s.it.long()[None] - 1,), accept[None])
        elif accepts is not None:
            accepts.append(accept)

    trips = device_while(s.go, iteration, config.max_iterations, name="lm")
    if accepts is not None and flags is not None:
        if trips is None:
            accepts.append(flags)
        else:
            accepts.extend(flags[:trips].unbind(0))
    return LMResult(
        poses=s.x, final_cost=s.c, initial_cost=s.c0, iterations=s.it,
        converged=s.done, final_mu=s.mu,
    )


def solve_jit(problem: JointProblem, poses0: Tensor,
              config: LMConfig = LMConfig(),
              use_soa: bool = True) -> LMResult:
    """`solve` under the reference's name for its jitted form."""
    return solve(problem, poses0, config, use_soa=use_soa)


def solve_batched(
    problem_b: JointProblem,
    poses0_b: Tensor,
    config: LMConfig = LMConfig(),
    linear_solver: Callable[[Tensor, Tensor, Tensor], Tensor] | None = None,
    *,
    accepts: list | None = None,
    eager: bool = False,
) -> LMResult:
    """LM of B problems at once: `problem_b` holds B problems stacked on a
    leading dimension (every tensor [B, ...]), poses0_b is [B, P, 3]. Each
    replica goes through `solve`'s iteration with its own mu, nu, count and
    exit; a step changes only the replicas still active, as a `vmap` of the
    reference's `lax.while_loop` does. Returns an LMResult of [B] (and
    [B, P, 3]) tensors. A list passed as `accepts` receives each step's
    [B] accept flags, False where a replica was not active, so replica r's
    accept sequence is the first iterations[r] entries of its column.

    The steps are the body of a `device_while` over a [B] carry (x, D, U,
    g, c, mu, nu, iterations, done, active), its condition `active.any()`
    kept on the device. On a CUDA device a call replays the captured
    program of its shapes, config and linear solver (one WHILE node),
    unless `eager`; eagerly a loop that reads one flag a step. Inside a
    LoopGraph capture `accepts` receives one [max_iterations, B] buffer
    instead, whose first max(iterations) rows a replay writes."""
    if replays(poses0_b, eager):
        out, flags = batched_program((problem_b, poses0_b), config,
                                     linear_solver).run(problem_b, poses0_b)
        if accepts is not None:
            accepts.extend(flags[:int(out.iterations.max())].unbind(0))
        return out
    return _solve_batched(problem_b, poses0_b, config, linear_solver,
                          accepts=accepts)


_batched_programs = ProgramCache()


def batched_program(example: tuple, config: LMConfig = LMConfig(),
                    linear_solver: Callable | None = None,
                    build: Callable | None = None) -> DeviceProgram:
    """The batched LM's program on a CUDA device for inputs shaped as
    `example`, `config` and `linear_solver` (None: the device's default):
    the one made before, or a new one (captured at its first run). Its
    inputs are (problem_b, poses0_b), or with `build` (poses0_b, table_b),
    the problems built in the graph by build(poses0_b, table_b). A run
    returns (the LMResult, the [max_iterations, B] accept flags)."""
    dev = (example[1] if build is None else example[0]).device
    # resolved before the capture, which may then count its launches
    solver = linear_solver or _default_linear_solver(dev, batched=True)
    if build is None:
        def fn(problem_b, poses0_b):
            return _solve_batched_captured(problem_b, poses0_b, config,
                                           solver)
    else:
        def fn(poses0_b, table_b):
            return _solve_batched_captured(build(poses0_b, table_b),
                                           poses0_b, config, solver)
    key = (signature(example), config, solver, build, dev.index)
    return _batched_programs.get(key, lambda: DeviceProgram(
        fn, example, dev, name="lm_batched"))


def _solve_batched_captured(problem_b, poses0_b, config, linear_solver):
    """solve_batched's program: its result and the accept buffer."""
    flags = []
    out = _solve_batched(problem_b, poses0_b, config, linear_solver,
                         accepts=flags)
    return out, flags[0]


def _solve_batched(problem_b, poses0_b, config, linear_solver=None, *,
                   accepts=None) -> LMResult:
    """solve_batched's carry form, eager or captured."""
    if linear_solver is None:
        linear_solver = _default_linear_solver(poses0_b.device, batched=True)
    assemble = _assembler(problem_b, True)
    B = poses0_b.shape[0]
    dev = poses0_b.device

    def full(v: float) -> Tensor:
        return torch.full((B,), v, dtype=poses0_b.dtype, device=dev)

    def rows(m: Tensor, t: Tensor) -> Tensor:
        return m.reshape(B, *([1] * (t.dim() - 1)))

    D, U, g, c = assemble(poses0_b)
    c0 = c
    x = poses0_b.clone()
    c = c.clone()
    mu, nu = full(config.initial_mu), full(2.0)
    two = _scalar(2.0, poses0_b)
    third = _scalar(1.0 / 3.0, poses0_b)
    it = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    active = ~done & (it < config.max_iterations)
    go = active.any()
    # row s: step s's accept flags (the steps a replica was active in)
    flags = torch.zeros((config.max_iterations, B), dtype=torch.bool,
                        device=dev)
    step_no = torch.zeros((), dtype=torch.int64, device=dev)

    def step_():
        diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1),
                           config.min_diagonal, config.max_diagonal)
        D_damped = D + rows(mu, D) * torch.diag_embed(diag)
        step = linear_solver(D_damped, U, -g)
        x_new = x + step
        D_new, U_new, g_new, c_new = assemble(x_new)

        # model decrease L(0) - L(step) in the MNT form, per replica
        pred = 0.5 * torch.sum(
            (step * (rows(mu, step) * diag * step - g)).flatten(-2), dim=-1)
        rho = (c - c_new) / torch.clamp(pred, min=1e-30)

        accept = (rho > 0) & torch.isfinite(c_new)
        acc = accept & active          # adopt the trial point
        flags.index_copy_(0, step_no[None], acc[None])
        x.copy_(torch.where(rows(acc, x), x_new, x))
        D.copy_(torch.where(rows(acc, D), D_new, D))
        U.copy_(torch.where(rows(acc, U), U_new, U))
        g.copy_(torch.where(rows(acc, g), g_new, g))
        c_next = torch.where(accept, c_new, c)

        t = 2.0 * rho - 1.0
        factor = torch.maximum(third, 1.0 - t * (t * t))
        mu_next = torch.clamp(torch.where(accept, mu * factor, mu * nu),
                              1e-32, 1e32)
        nu_next = torch.where(accept, two, nu * 2.0)

        fdone = accept & (torch.abs(c - c_new)
                          <= config.function_tolerance * c)
        xnorm = torch.sqrt(torch.sum((x * x).flatten(-2), dim=-1))
        sdone = (torch.sqrt(torch.sum((step * step).flatten(-2), dim=-1))
                 <= config.parameter_tolerance
                 * (xnorm + config.parameter_tolerance))
        mdone = mu_next >= config.mu_collapse
        c.copy_(torch.where(active, c_next, c))
        mu.copy_(torch.where(active, mu_next, mu))
        nu.copy_(torch.where(active, nu_next, nu))
        done.copy_(torch.where(active, done | fdone | sdone | mdone, done))
        it.copy_(torch.where(active, it + 1, it))
        active.copy_(~done & (it < config.max_iterations))
        torch.any(active, out=go)
        step_no.add_(1)

    steps = device_while(go, step_, config.max_iterations)
    if accepts is not None:
        if steps is None:
            accepts.append(flags)
        else:
            accepts.extend(flags[:steps].unbind(0))
    return LMResult(poses=x, final_cost=c, initial_cost=c0, iterations=it,
                    converged=done, final_mu=mu)
