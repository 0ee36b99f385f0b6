"""Pose-sharded LM solve: the trajectory cut into d partitions along a
mesh's 'pose' axis, coupled by a few small collectives a step.

Port of hitl_slam_tpu/parallel/sharded_solver.py, where a `shard_map` runs
the LM body on each of d devices with explicit collectives. Here the d
partitions are stacked on a leading dimension, one stack a device group of
the mesh (parallel/mesh.py), and the collectives move data between the
groups; on a mesh that repeats one device every step is one batch.

  - Residuals, Jacobians and the normal-equation assembly are local to a
    partition of Pl = P / d poses. The chain factor at a partition's end
    needs the next partition's first pose: one shift (the halo); the
    factor's contributions to the next partition's first pose come back by
    two shifts (the carries). The human factors enter through the
    CompactHuman per-pose terms, partitioned like the poses.
  - The block-tridiagonal system is solved by a SPIKE partition: each
    partition solves its local Pl-block system against 7 right-hand sides
    (the gradient, and identity columns at its first and last rows),
    reduces to 42 floats of boundary coefficients, all-gathers them, solves
    the [6d, 6d] reduced system (an LU solve and one step of iterative
    refinement: the reduced matrix is nonsymmetric) and back-substitutes.
    The local solves of a group are one multi-right-hand-side
    block-cyclic-reduction call: on the card one launch of csrc/bcr.cu's
    multi route, which factors each of the group's partitions (n = Pl
    poses) once against its 7 columns, as the reference's `vmap` over the
    right-hand sides does; on the CPU its plain version
    (solver/bcr_kernel.py::bcr_solve_multi_reference).
  - A step's communication: the three assembly shifts, one shift of the
    interface block, one gather of 42 floats a partition, and four
    one-float sums (cost, model decrease, two norms), counted by
    `mesh.collectives` when Python runs them: once at a program's capture,
    never at its replays (count an `eager=True` solve).

The LM iteration is the reference's: the system rides the loop and is
re-assembled only at accepted trial points; the gauge fix of pose 0 (on
partition 0), the clipped diagonal in both the damping and the model
decrease, Madsen-Nielsen-Tingleff damping and the three exits of
solver/lm.py. The loop is a `device_while` (utils/device_loop.py): on a
one-group CUDA mesh a WHILE node of a replayed graph that reads nothing
back, eagerly one host read (`done`) a step.

Deviation: the reference's exit damping is not returned (its LMResult
carries `config.initial_mu`); the port returns the same.
"""

from __future__ import annotations

import torch

from ..core.state import ConstraintTable
from ..ops import residuals as res
from ..solver import bcr_kernel
from ..solver.assembly_soa import _angle_mod_rows, _rows
from ..solver.joint import JointProblem, build_problem
from ..solver.lm import LMConfig, LMResult
from ..utils.device_loop import (DeviceProgram, ProgramCache, device_while,
                                 signature)
from . import mesh as M

Tensor = torch.Tensor


def _rowwise(fn, a: Tensor) -> Tensor:
    """fn(a) on [n, Pl] with each partition's row its own vector run on the
    CPU (assembly_soa._angle_mod_rows says why), so that a group of n
    partitions rounds as n groups of one."""
    return fn(_rows(a)) if a.device.type == "cpu" else fn(a)


def _rotate(theta: Tensor, v: Tensor) -> Tensor:
    c, s = _rowwise(torch.cos, theta), _rowwise(torch.sin, theta)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def _rot_neg(theta: Tensor) -> Tensor:
    c, s = _rowwise(torch.cos, theta), _rowwise(torch.sin, theta)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)],
                       dim=-2)


def _pair_residuals(f: res.OdometryFactors, p0: Tensor, p1: Tensor
                    ) -> Tensor:
    """[..., 3] chain residuals of the factors f between p0 and p1."""
    v = _rotate(-p0[..., 2], p1[..., :2] - p0[..., :2])
    u = torch.einsum("...ij,...j->...i", f.axis, v)
    r0 = (u[..., 0] - f.radial) * f.inv_sigma[..., 0]
    r1 = u[..., 1] * f.inv_sigma[..., 1]
    r2 = _angle_mod_rows(p1[..., 2] - p0[..., 2] - f.rotation) \
        * f.inv_sigma[..., 2]
    return torch.stack([r0, r1, r2], dim=-1)


def _pair_jacobians(f: res.OdometryFactors, p0: Tensor, p1: Tensor
                    ) -> tuple[Tensor, Tensor]:
    """(J1 wrt p0, J2 wrt p1), each [..., 3, 3]."""
    v = _rotate(-p0[..., 2], p1[..., :2] - p0[..., :2])
    B = f.axis * f.inv_sigma[..., :2, None]
    ARot = torch.einsum("...ij,...jk->...ik", B, _rot_neg(p0[..., 2]))
    dv = torch.stack([v[..., 1], -v[..., 0]], -1)
    du = torch.einsum("...ij,...j->...i", B, dv)
    zeros = torch.zeros_like(f.radial)
    isa = f.inv_sigma[..., 2]
    J2 = torch.cat([torch.cat([ARot, torch.zeros_like(du)[..., None]], -1),
                    torch.stack([zeros, zeros, isa], -1)[..., None, :]], -2)
    J1 = torch.cat([torch.cat([-ARot, du[..., None]], -1),
                    torch.stack([zeros, zeros, -isa], -1)[..., None, :]], -2)
    return J1, J2


def _pad_factors(odom: res.OdometryFactors) -> res.OdometryFactors:
    """Pad the [P-1] factor arrays to [P] with an inert trailing entry."""
    def pad(a, v):
        return torch.cat([a, torch.full((1, *a.shape[1:]), v, dtype=a.dtype,
                                        device=a.device)])

    eye = torch.eye(2, dtype=odom.axis.dtype, device=odom.axis.device)
    return res.OdometryFactors(
        axis=torch.cat([odom.axis, eye[None]]),
        radial=pad(odom.radial, 0.0), rotation=pad(odom.rotation, 0.0),
        inv_sigma=pad(odom.inv_sigma, 1.0))


def _local_odometry_assembly(odom: list, poses: list, groups: list, d: int):
    """The chain factors' share of each partition's system: per group
    (D [n, Pl, 3, 3], U [n, Pl, 3, 3], g [n, Pl, 3], cost [n]). Factor j of
    a partition joins its pose j to pose j + 1, the last one to the next
    partition's first pose (the halo); the global last factor is inert.
    U's last row couples to the next partition (zero on the last)."""
    halo = M.shift([p[:, :1] for p in poses], groups, -1)
    own, nxt, U, cost = [], [], [], []
    for f, p, h, grp in zip(odom, poses, halo, groups):
        Pl = p.shape[1]
        p1 = torch.cat([p[:, 1:], h], 1)
        gidx = grp.index()[:, None] * Pl + torch.arange(Pl, device=p.device)
        valid = (gidx < d * Pl - 1).to(p.dtype)
        r = _pair_residuals(f, p, p1) * valid[..., None]
        J1, J2 = _pair_jacobians(f, p, p1)
        J1 = J1 * valid[..., None, None]
        J2 = J2 * valid[..., None, None]
        J1T, J2T = J1.transpose(-1, -2), J2.transpose(-1, -2)
        own.append((J1T @ J1, (J1T @ r[..., None])[..., 0]))
        nxt.append((J2T @ J2, (J2T @ r[..., None])[..., 0]))
        U.append(J1T @ J2)
        cost.append(0.5 * (r * r).flatten(1).sum(1))
    # the 'next' terms belong to pose j + 1: shifted down one pose, the
    # partition's last one to the next partition's first pose
    D_carry = M.shift([Dn[:, -1:] for Dn, _ in nxt], groups, 1)
    g_carry = M.shift([gn[:, -1:] for _, gn in nxt], groups, 1)
    D, g = [], []
    for (Do, go), (Dn, gn), Dc, gc, grp in zip(own, nxt, D_carry, g_carry,
                                                groups):
        first = (grp.index() > 0).to(Do.dtype)     # partition 0 gets no wrap
        D.append(Do + torch.cat([first[:, None, None, None] * Dc,
                                 Dn[:, :-1]], 1))
        g.append(go + torch.cat([first[:, None, None] * gc, gn[:, :-1]], 1))
    return D, U, g, cost


def _reduced_system(coef: Tensor, d: int) -> tuple[Tensor, Tensor]:
    """The [6d, 6d] boundary system over u = [t_0, b_0, t_1, b_1, ...]
    (each partition's first and last step) from the gathered [d, 42]
    coefficients: (matrix, right-hand side [6d, 1])."""
    dt, dev = coef.dtype, coef.device
    V0, Vl, W0, Wl = (coef[:, 9 * k:9 * k + 9].reshape(d, 3, 3)
                      for k in range(4))
    blocks = torch.zeros((d, 2, d, 2, 3, 3), dtype=dt, device=dev)
    s = torch.arange(1, d, device=dev)
    blocks[s, 0, s - 1, 1] = V0[1:]      # t_s couples to b_{s-1}
    blocks[s, 1, s - 1, 1] = Vl[1:]
    s = torch.arange(d - 1, device=dev)
    blocks[s, 0, s + 1, 0] = W0[:-1]     # ... and to t_{s+1}
    blocks[s, 1, s + 1, 0] = Wl[:-1]
    Mr = (torch.eye(6 * d, dtype=dt, device=dev)
          + blocks.permute(0, 1, 4, 2, 3, 5).reshape(6 * d, 6 * d))
    rhs = torch.stack([coef[:, 36:39], coef[:, 39:42]], 1).reshape(6 * d, 1)
    return Mr, rhs


def _reduced_solve(coef: Tensor, d: int) -> Tensor:
    """Solve the [6d, 6d] boundary system over u = [t_0, b_0, t_1, b_1,
    ...] (each partition's first and last step) from the gathered [d, 42]
    coefficients: an LU solve and one step of iterative refinement.

    The LU is `lu_factor_ex`'s (partial pivoting, LAPACK's or cuSOLVER's
    getrf); each solve with it is the row permutation and two triangular
    solves. `lu_solve` is not used: on the card it goes to cuSOLVER's
    getrs, which puts allocation nodes into a CUDA graph at d = 8, nodes a
    WHILE body may not hold (scripts/linalg_capture_probe.py --reduced)."""
    Mr, rhs = _reduced_system(coef, d)
    LU, piv, _ = torch.linalg.lu_factor_ex(Mr)
    P = torch.lu_unpack(LU, piv, unpack_data=False)[0]

    def apply(b):
        y = torch.linalg.solve_triangular(LU, P.mT @ b, upper=False,
                                          unitriangular=True)
        return torch.linalg.solve_triangular(LU, y, upper=True)

    u = apply(rhs)
    u = u + apply(rhs - Mr @ u)
    return u[:, 0]


def _spike_solve(Dd: list, U: list, g: list, groups: list, d: int) -> list:
    """The step of the global damped system, per group [n, Pl, 3].

    Dd: damped, gauge-fixed diagonal blocks; U: upper couplings, the last
    row to the next partition; g: gradient. SPIKE: x_s = Y_s - V_s b_{s-1}
    - W_s t_{s+1} with Y = T^-1 (-g), V = (T^-1 E_first) L and
    W = (T^-1 E_last) R (T the partition's own block-tridiagonal system),
    where the boundary steps t_s = x_s[0], b_s = x_s[-1] solve the reduced
    system."""
    R_prev = M.shift([u[:, -1:] for u in U], groups, 1)
    parts, coef = [], []
    for Ddi, Ui, gi, Rp, grp in zip(Dd, U, g, R_prev, groups):
        n, Pl = gi.shape[:2]
        dt, dev = gi.dtype, gi.device
        lmask = (grp.index() > 0).to(dt)
        L = Rp[:, 0].transpose(-1, -2) * lmask[:, None, None]
        R = Ui[:, -1]
        eye = torch.eye(3, dtype=dt, device=dev)
        E = torch.zeros((n, Pl, 3, 6), dtype=dt, device=dev)
        E[:, 0, :, :3] = eye
        E[:, -1, :, 3:] = eye
        rhs = torch.cat([-gi[..., None], E], -1)            # [n, Pl, 3, 7]
        sol = bcr_kernel.bcr_solve_multi(Ddi, Ui[:, :-1], rhs)  # [n, Pl, 3, 7]
        Y = sol[..., 0]
        V = sol[..., 1:4] @ L[:, None]
        W = sol[..., 4:7] @ R[:, None]
        parts.append((Y, V, W, lmask))
        # only the first and last rows couple partitions
        coef.append(torch.cat([V[:, 0].flatten(1), V[:, -1].flatten(1),
                               W[:, 0].flatten(1), W[:, -1].flatten(1),
                               Y[:, 0], Y[:, -1]], 1))      # [n, 42]
    out = []
    for (Y, V, W, lmask), cg, grp in zip(parts, M.all_gather(coef, groups),
                                         groups):
        ur = _reduced_solve(cg, d).reshape(d, 2, 3)
        # partition s needs b_{s-1} and t_{s+1}, zero at the ends
        b_prev = torch.cat([ur[:1, 0], ur[:-1, 1]])[grp.lo:grp.hi] \
            * lmask[:, None]
        nmask = (grp.index() < d - 1).to(Y.dtype)
        t_next = torch.cat([ur[1:, 0], torch.zeros_like(ur[:1, 0])])[
            grp.lo:grp.hi] * nmask[:, None]
        out.append(Y - (V @ b_prev[:, None, :, None])[..., 0]
                   - (W @ t_next[:, None, :, None])[..., 0])
    return out


def _local_assemble(x: list, odom: list, compact: list, k: list,
                    groups: list, d: int):
    """Each partition's (D, U, g) and the GLOBAL cost at x: the chain
    factors with their shifts, plus the CompactHuman per-pose terms."""
    D, U, g, cost = _local_odometry_assembly(odom, x, groups, d)
    Dh, gh, local = [], [], []
    for xi, (q0, A, c), Di, gi, ci in zip(x, compact, D, g, cost):
        e = q0 - xi
        Ae = torch.einsum("...ij,...j->...i", A, e)
        Dh.append(Di + A)
        gh.append(gi - (c + Ae))
        local.append(ci + 0.5 * (e * (2.0 * c + Ae)).flatten(1).sum(1))
    total = M.psum(local, groups)
    return Dh, U, gh, [t + 0.5 * ki for t, ki in zip(total, k)]


def sharded_lm_solve(
    mesh: M.Mesh,
    problem: JointProblem,
    poses0: Tensor,
    config: LMConfig = LMConfig(),
    *,
    eager: bool = False,
) -> LMResult:
    """Pose-sharded LM from poses0 [P, 3], P divisible by the mesh's 'pose'
    axis. On a 2-D mesh the pose axis of replica row 0 runs: every row
    would compute the same thing. The inputs go to each group's device;
    the result is on the device of partition 0.

    The iteration is the body of a `device_while` over a carry of buffers,
    one tensor a device group each (x, D, U, g, c, mu, nu, the iteration
    count and done), updated with `copy_`. Where the pose axis is one
    group on a CUDA device (`[cuda:0] * d`), the call replays the captured
    program of its shapes, config and d (`sharded_program`: the assembly,
    the SPIKE with one multi BCR launch a trip and the LM's WHILE node in
    one graph), as the reference runs its jitted `shard_map`, unless
    `eager`, which runs the same code eagerly there, for comparisons only.
    Where the groups sit on several devices, the carry form runs eagerly,
    one host read (done) an iteration: one graph on one device cannot hold
    the `.to()` copies between the groups. On the CPU it runs eagerly."""
    groups = M.groups_of(mesh.axis("pose"))
    d = groups[-1].hi
    P = poses0.shape[0]
    if P % d:
        raise ValueError(f"sharded_lm_solve: {P} poses do not divide over "
                         f"the {d} entries of the 'pose' axis")
    dev0 = groups[0].device
    if (len(groups) == 1 and dev0.type == "cuda" and not eager
            and not torch.cuda.is_current_stream_capturing()):
        return sharded_program((problem, poses0), config, d,
                               dev0).run(problem, poses0)
    return _sharded(problem, poses0, config, groups)


_programs = ProgramCache(size=2)


def sharded_program(example: tuple, config: LMConfig, d: int,
                    device) -> DeviceProgram:
    """The pose-sharded LM's program for `example` (problem, poses0) on a
    mesh whose pose axis is d entries of CUDA `device` (one group), and
    `config`: the one made before, or a new one (captured at its first
    run)."""
    dev = torch.device(device)
    groups = [M.Group(dev, 0, d)]
    key = (signature(example), config, d, dev.index)
    return _programs.get(key, lambda: DeviceProgram(
        lambda problem, poses0: _sharded(problem, poses0, config, groups),
        example, dev, name="spike"))


def _sharded(problem: JointProblem, poses0: Tensor, config: LMConfig,
             groups: list) -> LMResult:
    """sharded_lm_solve's carry form over `groups`, eager or captured."""
    d = groups[-1].hi
    Pl = poses0.shape[0] // d
    dtype = poses0.dtype
    dev0 = groups[0].device

    def parts(t: Tensor) -> list:
        return M.split(t.reshape(d, Pl, *t.shape[1:]), groups)

    odom = _pad_factors(problem.odom)
    odom = [res.OdometryFactors(*f) for f in zip(
        parts(odom.axis), parts(odom.radial), parts(odom.rotation),
        parts(odom.inv_sigma))]
    ch = problem.compact
    compact = list(zip(parts(ch.q0), parts(ch.A), parts(ch.c)))
    k = [ch.k.to(grp.device) for grp in groups]

    def assemble(x):
        return _local_assemble(x, odom, compact, k, groups, d)

    def scalars(v, dt=dtype):
        return [torch.full((), v, dtype=dt, device=grp.device)
                for grp in groups]

    x = [xi.clone() for xi in parts(poses0)]
    D, U, g, c = assemble(x)
    c0 = c[0]
    c = [ci.clone() for ci in c]
    mu, nu, two = scalars(config.initial_mu), scalars(2.0), scalars(2.0)
    it = scalars(0, torch.int32)
    done = scalars(False, torch.bool)
    go = ~done[0] & (it[0] < config.max_iterations)

    def iteration():
        Dd, Ug, gg, diag = [], [], [], []
        for Di, Ui, gi, mi, grp in zip(D, U, g, mu, groups):
            if grp.lo == 0:
                # gauge fix: global pose 0 is partition 0's row 0
                Di, Ui, gi = Di.clone(), Ui.clone(), gi.clone()
                Di[0, 0].copy_(torch.eye(3, dtype=dtype, device=grp.device))
                Ui[0, 0].zero_()
                gi[0, 0].zero_()
            # the clipped diagonal in both the damping and the model
            # decrease, as solver/lm.py
            dg = torch.clamp(torch.diagonal(Di, dim1=-2, dim2=-1),
                             config.min_diagonal, config.max_diagonal)
            Dd.append(Di + mi * torch.diag_embed(dg))
            Ug.append(Ui)
            gg.append(gi)
            diag.append(dg)
        step = _spike_solve(Dd, Ug, gg, groups, d)
        x_new = [xi + si for xi, si in zip(x, step)]
        Dn, Un, gn, c_new = assemble(x_new)
        pred = M.psum([(si * (mi * dg * si - gi)).flatten(1).sum(1)
                       for si, mi, dg, gi in zip(step, mu, diag, gg)],
                      groups)
        for i in range(len(groups)):
            rho = (c[i] - c_new[i]) / torch.clamp(0.5 * pred[i], min=1e-30)
            acc = (rho > 0) & torch.isfinite(c_new[i])
            x[i].copy_(torch.where(acc, x_new[i], x[i]))
            D[i].copy_(torch.where(acc, Dn[i], D[i]))
            U[i].copy_(torch.where(acc, Un[i], U[i]))
            g[i].copy_(torch.where(acc, gn[i], g[i]))
            t = 2.0 * rho - 1.0
            factor = torch.clamp(1.0 - t * (t * t), min=1.0 / 3.0)
            mu_next = torch.clamp(torch.where(acc, mu[i] * factor,
                                              mu[i] * nu[i]), 1e-32, 1e32)
            nu[i].copy_(torch.where(acc, two[i], nu[i] * 2.0))
            mu[i].copy_(mu_next)
            fdone = acc & (torch.abs(c[i] - c_new[i])
                           <= config.function_tolerance * c[i])
            c[i].copy_(torch.where(acc, c_new[i], c[i]))
            done[i].copy_(done[i] | fdone | (mu[i] >= config.mu_collapse))
        # the step-size exit applies to rejected steps too (solver/lm.py)
        xnorm = M.psum([(xi * xi).flatten(1).sum(1) for xi in x], groups)
        snorm = M.psum([(si * si).flatten(1).sum(1) for si in step], groups)
        for i in range(len(groups)):
            done[i].copy_(done[i] | (
                torch.sqrt(snorm[i]) <= config.parameter_tolerance
                * (torch.sqrt(xnorm[i]) + config.parameter_tolerance)))
            it[i].add_(1)
        go.copy_(~done[0] & (it[0] < config.max_iterations))

    device_while(go, iteration, config.max_iterations)
    return LMResult(
        poses=torch.cat([xi.reshape(-1, 3).to(dev0) for xi in x]),
        final_cost=c[0], initial_cost=c0, iterations=it[0],
        converged=done[0],
        final_mu=torch.full((), config.initial_mu, dtype=dtype,
                            device=dev0))


def make_sharded_solver(mesh: M.Mesh, config: LMConfig = LMConfig()):
    """(poses, table) -> LMResult: the problem built at `poses`, then the
    pose-sharded solve."""

    def run(poses: Tensor, table: ConstraintTable) -> LMResult:
        problem = build_problem(poses, table)
        return sharded_lm_solve(mesh, problem, poses, config)

    return run
