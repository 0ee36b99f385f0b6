"""One trip of the LM loop outside its linear solve: the CUDA kernel
(csrc/lm_step.cu) and its plain version.

solver/lm.py's loop carries x, the normal equations D, U, g at x, the cost
c, the damping mu and its growth nu, the iteration count, `done` and the
loop's `go`; the kernel's carry also holds the next linear system (D
damped by mu, and -g: `system`). Given the linear solve's step, a trip

  1. forms the trial point x + step;
  2. assembles D, U, g and the cost there, as assembly_soa's
     normal_equations_soa does (gauge-fixed at pose 0, the compact human
     terms);
  3. forms the model decrease `pred` of the step;
  4. reduces the sums it needs: the new cost, pred, |x + step|^2, |x|^2,
     |step|^2;
  5. decides rho and accept, and records accept in the [max_iterations]
     flags at the iteration's index;
  6. keeps x, D, U, g and c, or takes the trial point's;
  7. updates mu and nu;
  8. runs the three exit tests and advances the count, `done` and `go`;
  9. (the kernel) damps the next trip's system: D + mu * diag(clamp(diag
     D)), and -g; the plain version forms it at the top of the next trip.

`begin` makes the carry from poses0: the first assembly and the damping
(mu0 clamped into [1e-6, 1e-1], or the config's); the kernel's also the
first damped system. `trip` runs one trip in place, `system` gives the
linear system a trip solves. On a CUDA tensor each is one launch
of the kernel (two above 16384 poses) or raises; nothing falls back. On the
CPU they run the plain version, `begin_reference` and `trip_reference`:
normal_equations_soa and the loop's tail as lm.py ran them, op for op, and
the AoS assembly (`lm.solve(use_soa=False)`) takes them on any device.

The route follows from P alone (`launch_plan`): up to 128 poses one block,
129 .. 16384 a thread-block cluster of up to 16 blocks, more two launches
(many blocks, then up to 128 that each sum their partials in block order). The sums
are fixed-order reductions, so a launch repeats bit for bit; the kernel's
elements round as the plain version's, and only the order of the sums
differs.

`launches` counts one a `begin` or `trip` call on a card, without a mark on
the stage clock (cuda_build.LaunchCounter): the cycle's LM loop keeps its
marks `lm` and `bcr_solve`, and its edge bcr_solve -> lm is this kernel's
trip. The batched LM (lm.solve_batched), the pose-sharded SPIKE LM and the
refine's stf_solve assemble on their own paths and do not call it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable

import torch

from ..utils import cuda_build
from .assembly_soa import normal_equations_soa, soa_constants

Tensor = torch.Tensor

# lm_step.cu: kMaxThreads, kMaxCluster, kMaxPoses, kSums, and the scalars
# the two-launch route keeps beside the blocks' sums
MAX_THREADS = 1024
MAX_CLUSTER = 16
MAX_POSES = 1 << 25
SUMS = 6
HELD = 5
WARP = 32
# the poses a block of a cluster takes where the cluster has blocks to
# spare: a thread's chain, not its SM's schedulers, then bounds a launch
CLUSTER_POSES = 128

launches = cuda_build.LaunchCounter("lm_step", mark=False)


@dataclass(frozen=True)
class LaunchPlan:
    P: int
    blocks: int    # > 1: a cluster; > MAX_CLUSTER: two launches
    threads: int   # a multiple of a warp, one a pose

    @property
    def route(self) -> str:
        if self.blocks == 1:
            return "block"
        return "cluster" if self.blocks <= MAX_CLUSTER else "two launches"


@lru_cache(maxsize=64)
def launch_plan(P: int) -> LaunchPlan:
    """The kernel's route for P poses, one pose a thread, the poses spread
    evenly over the blocks: up to CLUSTER_POSES poses one block; up to
    MAX_CLUSTER * MAX_THREADS a cluster of blocks of about CLUSTER_POSES
    poses, as many as a cluster holds (lm_step.cu says why); more, blocks
    of MAX_THREADS. Raises where no route exists."""
    if not 1 <= P <= MAX_POSES:
        raise ValueError(f"lm_step: {P} poses outside [1, {MAX_POSES}]")
    if P <= MAX_CLUSTER * MAX_THREADS:
        blocks = min(MAX_CLUSTER, -(-P // CLUSTER_POSES))
    else:
        blocks = -(-P // MAX_THREADS)
    threads = -(-(-(-P // blocks)) // WARP) * WARP
    return LaunchPlan(P, -(-P // threads), threads)


class Carry:
    """The LM loop's carry (module docstring): x [P, 3], D [P, 3, 3],
    U [P-1, 3, 3], g [P, 3], the scalars c, c0 (the first cost), mu, nu,
    it (int32), done and go (bool). The kernel's also holds the next
    linear system Dd and b, its [max(max_iterations, 1)] accept flags
    (`accepted`) and what its launches read; the plain version's its
    assembly (`assemble`), with `accepted` None."""

    def __init__(self, **fields):
        self.accepted = None
        self.assemble = None
        self.__dict__.update(fields)


def _scalar(v: float, like: Tensor) -> Tensor:
    """A scalar of like's dtype on its device, made there (no host copy)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def damped(D: Tensor, mu: Tensor, config) -> Tensor:
    """D + mu * diag(diag(D) clamped to [min_diagonal, max_diagonal])."""
    diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1),
                       config.min_diagonal, config.max_diagonal)
    return D + mu * torch.diag_embed(diag)


def soa_assembler(problem) -> Callable:
    """x -> (D, U, g, cost) by normal_equations_soa."""
    sc = soa_constants(problem)
    return lambda x: normal_equations_soa(problem, sc, x)


# ------------------------------------------------------------ plain version

def begin_reference(assemble: Callable, poses0: Tensor, config,
                    mu0: Tensor | None = None) -> Carry:
    """The carry at poses0, by `assemble` (x -> D, U, g, cost)."""
    D, U, g, c = assemble(poses0)
    c0 = c
    x = poses0.clone()
    c = c.clone()
    if mu0 is None:
        mu = _scalar(config.initial_mu, poses0)
    else:
        mu = torch.clamp(torch.as_tensor(mu0, dtype=poses0.dtype,
                                         device=poses0.device), 1e-6, 1e-1)
    it = torch.zeros((), dtype=torch.int32, device=poses0.device)
    done = torch.zeros((), dtype=torch.bool, device=poses0.device)
    return Carry(x=x, D=D, U=U, g=g, c=c, c0=c0, mu=mu,
                 nu=_scalar(2.0, poses0), it=it, done=done,
                 go=~done & (it < config.max_iterations), assemble=assemble,
                 two=_scalar(2.0, poses0), third=_scalar(1.0 / 3.0, poses0))


def trip_reference(s: Carry, step: Tensor, config) -> Tensor:
    """One trip of the plain carry `s` (begin_reference's) by `step`, in
    place; returns the accept flag."""
    D, U, g, x, c, mu, nu = s.D, s.U, s.g, s.x, s.c, s.mu, s.nu
    diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1),
                       config.min_diagonal, config.max_diagonal)
    x_new = x + step
    D_new, U_new, g_new, c_new = s.assemble(x_new)

    # model decrease L(0) - L(step) in the MNT form
    pred = 0.5 * torch.sum(step * (mu * diag * step - g))
    rho = (c - c_new) / torch.clamp(pred, min=1e-30)

    accept = (rho > 0) & torch.isfinite(c_new)
    x_next = torch.where(accept, x_new, x)
    D.copy_(torch.where(accept, D_new, D))
    U.copy_(torch.where(accept, U_new, U))
    g.copy_(torch.where(accept, g_new, g))
    c_next = torch.where(accept, c_new, c)

    t = 2.0 * rho - 1.0
    factor = torch.maximum(s.third, 1.0 - t * (t * t))
    mu_next = torch.where(accept, mu * factor, mu * nu)
    nu.copy_(torch.where(accept, s.two, nu * 2.0))
    mu_next = torch.clamp(mu_next, 1e-32, 1e32)

    # relative function decrease (accepted steps only), relative step
    # size (every step), or trust-region collapse
    fdone = accept & (torch.abs(c - c_new) <= config.function_tolerance * c)
    xnorm = torch.sqrt(torch.sum(x_next * x_next))
    sdone = (torch.sqrt(torch.sum(step * step))
             <= config.parameter_tolerance
             * (xnorm + config.parameter_tolerance))
    mdone = mu_next >= config.mu_collapse
    x.copy_(x_next)
    c.copy_(c_next)
    mu.copy_(mu_next)
    s.it.add_(1)
    s.done.copy_(s.done | fdone | sdone | mdone)
    s.go.copy_(~s.done & (s.it < config.max_iterations))
    return accept


# ------------------------------------------------------------ the kernel

def _constants(problem, P: int, dev) -> tuple[tuple, int]:
    """The problem's constants as the kernel reads them (contiguous f32 on
    `dev`) and inv_sigma's row stride: 0 where one row, expanded, serves
    every factor (the fixed noise model), else 3."""
    od, ch = problem.odom, problem.compact
    F = P - 1
    inv = od.inv_sigma
    stride = 0 if F > 0 and inv.stride() == (0, 1) else 3
    shapes = (("axis", od.axis, (F, 2, 2)), ("radial", od.radial, (F,)),
              ("rotation", od.rotation, (F,)),
              ("inv_sigma", inv[:1] if stride == 0 else inv,
               (1, 3) if stride == 0 else (F, 3)),
              ("A", ch.A, (P, 3, 3)), ("c", ch.c, (P, 3)),
              ("q0", ch.q0, (P, 3)), ("k", ch.k, ()))
    out = []
    for name, t, shape in shapes:
        t = t.contiguous()
        cuda_build.require("lm_step", name, t, shape, torch.float32, dev)
        out.append(t)
    return tuple(out), stride


def _launch(s: Carry, x_in: Tensor, step: Tensor | None,
            mu0: Tensor | None, config) -> None:
    """One launch on the kernel's carry `s`: the first assembly at x_in
    (no step) or a trip by `step` (x_in the carry's x)."""
    plan = s.plan
    tensors = (*s.consts, x_in, step, mu0, s.x, s.D, s.U, s.g, s.Dd, s.b,
               s.c, s.c0, s.mu, s.nu, s.it, s.done, s.go, s.accepted,
               *s.scratch)
    ptrs = (ctypes.c_void_p * len(tensors))(*(
        None if t is None or t.numel() == 0 else t.data_ptr()
        for t in tensors))
    fparams = (ctypes.c_float * 7)(
        config.initial_mu, config.function_tolerance,
        config.parameter_tolerance, config.mu_collapse, config.min_diagonal,
        config.max_diagonal, 1.0 / 3.0)
    iparams = (ctypes.c_int * 5)(plan.P, config.max_iterations, s.inv_stride,
                                 plan.blocks, plan.threads)
    dev = s.x.device
    lib = cuda_build.library()
    with torch.cuda.device(dev):
        code = lib.hitl_lm_step(
            ptrs, fparams, iparams, torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(code, "lm_step")
        launches.bump(dev)


def begin_cuda(problem, poses0: Tensor, config,
               mu0: Tensor | None = None) -> Carry:
    """begin on a card: the carry's buffers and one launch."""
    dev = poses0.device
    if dev.type != "cuda":
        raise ValueError(f"lm_step: begin_cuda needs CUDA tensors, got {dev}")
    P = poses0.shape[0]
    f32 = torch.float32
    cuda_build.require("lm_step", "poses0", poses0, (P, 3), f32, dev)
    plan = launch_plan(P)
    consts, stride = _constants(problem, P, dev)
    if mu0 is not None:
        mu0 = torch.as_tensor(mu0, dtype=f32, device=dev)
        cuda_build.require("lm_step", "mu0", mu0, (), f32, dev)

    def e(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)

    scratch = ((e(P, 3), e(P, 6), e(P - 1, 9), e(P, 3),
                e(plan.blocks * SUMS + HELD)) if plan.route == "two launches"
               else (None,) * 5)
    s = Carry(x=e(P, 3), D=e(P, 3, 3), U=e(P - 1, 3, 3), g=e(P, 3), c=e(),
              c0=e(), mu=e(), nu=e(), it=e(dtype=torch.int32),
              done=e(dtype=torch.bool), go=e(dtype=torch.bool),
              Dd=e(P, 3, 3), b=e(P, 3),
              accepted=e(max(config.max_iterations, 1), dtype=torch.bool),
              plan=plan, consts=consts, inv_stride=stride, scratch=scratch)
    _launch(s, poses0, None, mu0, config)
    return s


def trip_cuda(s: Carry, step: Tensor, config) -> None:
    """trip on a card: one launch (two above 16384 poses)."""
    dev = s.x.device
    cuda_build.require("lm_step", "step", step, tuple(s.x.shape),
                       torch.float32, dev)
    _launch(s, s.x, step, None, config)


# ------------------------------------------------------------ entry points

def begin(problem, poses0: Tensor, config,
          mu0: Tensor | None = None) -> Carry:
    """The carry at poses0 with the SoA assembly: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if poses0.device.type == "cpu":
        return begin_reference(soa_assembler(problem), poses0, config, mu0)
    if poses0.device.type == "cuda":
        return begin_cuda(problem, poses0, config, mu0)
    raise ValueError(f"lm_step: unsupported device {poses0.device}")


def system(s: Carry, config) -> tuple[Tensor, Tensor, Tensor]:
    """The next trip's linear system (D damped by mu, U, -g): the kernel's
    buffers, which its last launch wrote, or for the plain carry new
    tensors, formed as the loop formed them at the top of a trip."""
    if s.assemble is not None:
        return damped(s.D, s.mu, config), s.U, -s.g
    return s.Dd, s.U, s.b


def trip(s: Carry, step: Tensor, config) -> Tensor | None:
    """One trip of `s` by `step`, in place: the plain version's for its
    carry (returning the accept flag), else the kernel's (which records it
    in `s.accepted`; returns None)."""
    if s.assemble is not None:
        return trip_reference(s, step, config)
    trip_cuda(s, step, config)
    return None
