"""Port parity of the replica batch (parallel/replicas.py) and the batched LM
and linear solve under it (solver/lm.py::solve_batched, the batched
tridiag.bcr_solve), against the JAX package's batched_solve on one CPU
device (no mesh) and against the port's own lone solves. The batched CUDA
route is held against lone launches on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_parallel import _chain_poses, _table
from torch_port_helpers import n, random_spd_tridiag, t, table_to_torch

torch.set_num_threads(2)

B, NUM = 8, 40


@pytest.fixture(scope="module")
def replicas():
    """tests/test_parallel.py's inputs: a 40-pose chain, 3 LINE_SEGMENT
    rows, 8 replicas; the JAX package's batched_solve at 40 iterations
    (compiled once for the module)."""
    from hitl_slam_tpu.parallel import replicas as JR
    from hitl_slam_tpu.solver.lm import LMConfig

    rng = np.random.default_rng(23)
    poses = _chain_poses(rng, NUM)
    table = _table(jnp.asarray(poses), rng)
    jreps, jtable = JR.make_perturbed_replicas(poses, table, num_replicas=B)
    jout = JR.batched_solve(jreps, jtable, LMConfig(max_iterations=40))
    jout = jax.tree_util.tree_map(np.asarray, jout)
    return poses, table, np.asarray(jreps), jout


def test_perturbed_replicas_bit_equal(replicas):
    """The same numpy draws: bit-equal replicas, pose 0 kept, and the table
    broadcast as a view of the one table."""
    from hitl_slam_torch.parallel.replicas import make_perturbed_replicas

    poses, table, jreps, _ = replicas
    tt = table_to_torch(table)
    reps, tb = make_perturbed_replicas(poses, tt, num_replicas=B)
    assert reps.dtype == torch.float32 and reps.shape == (B, NUM, 3)
    assert np.array_equal(n(reps), jreps)
    assert torch.equal(reps[:, 0], t(poses[0]).expand(B, 3))
    for name in ("ctype", "anchor", "delta_angle", "active"):
        col = getattr(tb, name)
        assert col.shape == (B, tt.capacity) and col.stride(0) == 0
        assert torch.equal(col[3], getattr(tt, name))


def test_batched_solve_matches_jax(replicas):
    """Per-replica iteration counts equal; costs within rtol 1e-4 and poses
    within 1e-4 (the tolerance of tests/test_parallel.py's batched
    repair)."""
    from hitl_slam_torch.parallel.replicas import (batched_solve,
                                                   make_perturbed_replicas)
    from hitl_slam_torch.solver.lm import LMConfig

    poses, table, _, jout = replicas
    reps, tb = make_perturbed_replicas(poses, table_to_torch(table), B)
    out = batched_solve(reps, tb, LMConfig(max_iterations=40), device="cpu")
    assert out.poses.shape == (B, NUM, 3)
    np.testing.assert_array_equal(n(out.iterations), jout.iterations)
    np.testing.assert_array_equal(n(out.converged), jout.converged)
    np.testing.assert_allclose(n(out.initial_cost), jout.initial_cost,
                               rtol=1e-5)
    np.testing.assert_allclose(n(out.final_cost), jout.final_cost, rtol=1e-4)
    np.testing.assert_allclose(n(out.poses), jout.poses, atol=1e-4)
    assert (n(out.final_cost) <= n(out.initial_cost)).all()


def test_batched_solve_matches_lone_solves(replicas):
    """Each replica of the batch gets the iteration count, accept sequence
    and poses of a lone solve of it (the same operations a step: poses
    within 1e-6, and on the CPU bit-equal)."""
    from hitl_slam_torch.parallel.replicas import (build_problems,
                                                   make_perturbed_replicas,
                                                   replica_table)
    from hitl_slam_torch.solver import joint as TJ, lm as TL

    poses, table, _, _ = replicas
    reps, tb = make_perturbed_replicas(poses, table_to_torch(table), B)
    config = TL.LMConfig(max_iterations=40)
    accepts = []
    out = TL.solve_batched(build_problems(reps, tb), reps, config,
                           accepts=accepts)
    acc = torch.stack(accepts)                     # [steps, B]
    assert acc.shape[0] == int(out.iterations.max())
    for r in range(B):
        lone_acc = []
        lone = TL.solve(TJ.build_problem(reps[r], replica_table(tb, r)),
                        reps[r], config, accepts=lone_acc)
        k = int(lone.iterations)
        assert int(out.iterations[r]) == k
        assert acc[:k, r].tolist() == [bool(a) for a in lone_acc]
        assert not acc[k:, r].any()
        assert bool(out.converged[r]) == bool(lone.converged)
        assert float((out.poses[r] - lone.poses).abs().max()) <= 1e-6
        assert torch.equal(out.poses[r], lone.poses)
        assert float(out.final_cost[r]) == float(lone.final_cost)
        assert float(out.final_mu[r]) == float(lone.final_mu)


def test_solve_batched_freezes_finished_replicas():
    """Replicas that stop at different steps: one without human rows (at
    its optimum from the start) stops first while the others go on; each
    ends where its lone solve ends. max_iterations = 0 runs no step."""
    from hitl_slam_torch.core.state import ConstraintTable
    from hitl_slam_torch.parallel.replicas import build_problems, _stack
    from hitl_slam_torch.solver import joint as TJ, lm as TL

    rng = np.random.default_rng(5)
    poses = _chain_poses(rng, 24)
    pulled = table_to_torch(_table(jnp.asarray(poses), rng))
    tables = [ConstraintTable.empty(16, "cpu"), pulled, pulled]
    reps = np.stack([poses, poses, poses + rng.normal(0, 0.1, poses.shape)])
    reps[:, 0] = poses[0]
    reps = t(reps.astype(np.float32))
    prob = build_problems(reps, _stack(tables))
    config = TL.LMConfig(max_iterations=30)
    out = TL.solve_batched(prob, reps, config)
    its = n(out.iterations)
    assert its[0] < its.max() and (its <= 30).all()
    for r in range(3):
        lone = TL.solve(TJ.build_problem(reps[r], tables[r]), reps[r],
                        config)
        assert int(lone.iterations) == its[r]
        assert torch.equal(out.poses[r], lone.poses)
    none = TL.solve_batched(prob, reps, TL.LMConfig(max_iterations=0))
    assert n(none.iterations).tolist() == [0, 0, 0]
    assert torch.equal(none.poses, reps)
    assert torch.equal(none.final_cost, none.initial_cost)


@pytest.mark.parametrize("num", [1, 2, 40, 129])
def test_batched_bcr_twin(num):
    """The batched plain BCR: bit-equal to B lone calls on the CPU, and
    within f32 round-off of the JAX bcr_solve under vmap."""
    from hitl_slam_torch.solver import bcr_kernel, tridiag
    from hitl_slam_tpu.solver.tridiag import bcr_solve as jbcr

    rng = np.random.default_rng(num)
    systems = [random_spd_tridiag(rng, num) for _ in range(5)]
    D, U, b = (np.stack([s[i] for s in systems]).astype(np.float32)
               for i in range(3))
    got = tridiag.bcr_solve(t(D), t(U), t(b))
    lone = torch.stack([tridiag.bcr_solve(t(D[i]), t(U[i]), t(b[i]))
                        for i in range(5)])
    assert torch.equal(got, lone)
    ref = np.asarray(jax.vmap(jbcr)(jnp.asarray(D), jnp.asarray(U),
                                    jnp.asarray(b)))
    scale = max(1.0, float(np.abs(ref).max()))
    # the same algorithm in f32; cond(H) < ~20 (torch_port_helpers)
    assert np.abs(n(got) - ref).max() <= 1e-5 * scale
    # the wrapper dispatches a batch to the twin on the CPU, launching
    # nothing, and the batched CUDA entry refuses CPU tensors
    before = (bcr_kernel.launches.count, bcr_kernel.batched_launches.count)
    assert torch.equal(bcr_kernel.bcr_solve(t(D), t(U), t(b)), got)
    with pytest.raises(ValueError):
        bcr_kernel.bcr_solve_cuda_batched(t(D), t(U), t(b))
    assert (bcr_kernel.launches.count,
            bcr_kernel.batched_launches.count) == before


def test_batched_bcr_factor_apply():
    """bcr_factor / bcr_apply with a batch dimension: each system's x is
    its lone factor/apply's, and bcr_solve's."""
    from hitl_slam_torch.solver import tridiag

    rng = np.random.default_rng(3)
    systems = [random_spd_tridiag(rng, 37) for _ in range(4)]
    D, U, b = (t(np.stack([s[i] for s in systems]).astype(np.float32))
               for i in range(3))
    got = tridiag.bcr_apply(tridiag.bcr_factor(D, U), b)
    for i in range(4):
        lone = tridiag.bcr_apply(tridiag.bcr_factor(D[i], U[i]), b[i])
        assert torch.equal(got[i], lone)
        assert torch.equal(lone, tridiag.bcr_solve(D[i], U[i], b[i]))


def test_default_batched_linear_solver():
    from hitl_slam_torch.solver import bcr_kernel, tridiag
    from hitl_slam_torch.solver.lm import _default_linear_solver

    assert _default_linear_solver("cpu", batched=True) is tridiag.bcr_solve
    assert (_default_linear_solver("cuda", batched=True)
            is bcr_kernel.bcr_solve_cuda_batched)


# ------------------------------------------------------------ carry form

def _batched_loop(problem_b, poses0_b, config, accepts):
    """solve_batched as its step loop was before the carry form (a host
    read of `active.any()` a step)."""
    from hitl_slam_torch.solver import lm as L, tridiag

    assemble = L._assembler(problem_b, True)
    B = poses0_b.shape[0]

    def full(v):
        return torch.full((B,), v, dtype=poses0_b.dtype)

    def rows(m, x):
        return m.reshape(B, *([1] * (x.dim() - 1)))

    D, U, g, c = assemble(poses0_b)
    c0, x = c, poses0_b
    mu, nu = full(config.initial_mu), full(2.0)
    two = torch.full((), 2.0)
    third = torch.full((), 1.0 / 3.0)
    it = torch.zeros((B,), dtype=torch.int32)
    done = torch.zeros((B,), dtype=torch.bool)
    active = ~done & (it < config.max_iterations)
    while bool(active.any()):
        diag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1),
                           config.min_diagonal, config.max_diagonal)
        D_damped = D + rows(mu, D) * torch.diag_embed(diag)
        step = tridiag.bcr_solve(D_damped, U, -g)
        x_new = x + step
        D_new, U_new, g_new, c_new = assemble(x_new)
        pred = 0.5 * torch.sum(
            (step * (rows(mu, step) * diag * step - g)).flatten(-2), dim=-1)
        rho = (c - c_new) / torch.clamp(pred, min=1e-30)
        accept = (rho > 0) & torch.isfinite(c_new)
        acc = accept & active
        accepts.append(acc)
        x = torch.where(rows(acc, x), x_new, x)
        D = torch.where(rows(acc, D), D_new, D)
        U = torch.where(rows(acc, U), U_new, U)
        g = torch.where(rows(acc, g), g_new, g)
        c_next = torch.where(accept, c_new, c)
        tt = 2.0 * rho - 1.0
        factor = torch.maximum(third, 1.0 - tt * (tt * tt))
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
        c = torch.where(active, c_next, c)
        mu = torch.where(active, mu_next, mu)
        nu = torch.where(active, nu_next, nu)
        done = torch.where(active, done | fdone | sdone | mdone, done)
        it = torch.where(active, it + 1, it)
        active = ~done & (it < config.max_iterations)
    return x, c, c0, it, done, mu


@pytest.mark.parametrize("max_iterations", [40, 4, 0])
def test_solve_batched_carry_form_bit_equal_to_loop(replicas,
                                                    max_iterations):
    """The carry-form solve_batched against its step loop before (kept
    above): poses, costs, damping, iterations, convergence and the accept
    list bit-equal on the CPU, with an iteration cap that stops every
    replica (4) and none (0); its host reads are device_while's exit
    tests, one a step and the failing one."""
    from test_torch_device_program import _HostReads

    from hitl_slam_torch.parallel.replicas import (build_problems,
                                                   make_perturbed_replicas)
    from hitl_slam_torch.solver import lm as TL

    poses, table, _, _ = replicas
    reps, tb = make_perturbed_replicas(poses, table_to_torch(table), B)
    prob = build_problems(reps, tb)
    config = TL.LMConfig(max_iterations=max_iterations)
    acc_new, acc_old = [], []
    with _HostReads() as mode:
        got = TL.solve_batched(prob, reps, config, accepts=acc_new)
    x, c, c0, it, done, mu = _batched_loop(prob, reps, config, acc_old)
    assert torch.equal(got.poses, x) and torch.equal(got.final_cost, c)
    assert torch.equal(got.initial_cost, c0)
    assert torch.equal(got.iterations, it) and torch.equal(got.converged,
                                                           done)
    assert torch.equal(got.final_mu, mu)
    assert len(acc_new) == len(acc_old)
    assert all(torch.equal(a, b) for a, b in zip(acc_new, acc_old))
    steps = len(acc_old)
    assert len(mode.reads) == steps + (steps < max_iterations)
    assert all(inside for _, inside in mode.reads)


def test_solve_batched_carry_form_matches_jax_at_a_cap(replicas):
    """At a cap of 6 iterations, which stops replicas mid-descent: the
    carry form against the JAX package's batched_solve at the same cap
    (iteration counts and convergence equal, costs and poses within
    test_batched_solve_matches_jax's tolerances)."""
    from hitl_slam_torch.parallel.replicas import (batched_solve,
                                                   make_perturbed_replicas)
    from hitl_slam_torch.solver.lm import LMConfig
    from hitl_slam_tpu.parallel import replicas as JR
    from hitl_slam_tpu.solver.lm import LMConfig as JConfig

    poses, table, jreps, _ = replicas
    jout = JR.batched_solve(jnp.asarray(jreps), JR.make_perturbed_replicas(
        poses, table, num_replicas=B)[1], JConfig(max_iterations=6))
    jout = jax.tree_util.tree_map(np.asarray, jout)
    reps, tb = make_perturbed_replicas(poses, table_to_torch(table), B)
    out = batched_solve(reps, tb, LMConfig(max_iterations=6), device="cpu")
    np.testing.assert_array_equal(n(out.iterations), jout.iterations)
    np.testing.assert_array_equal(n(out.converged), jout.converged)
    np.testing.assert_allclose(n(out.final_cost), jout.final_cost, rtol=1e-4)
    np.testing.assert_allclose(n(out.poses), jout.poses, atol=1e-4)


def test_solve_batched_step_reads_nothing_back(replicas):
    """One step of the carry form, run as device_while's body outside the
    loop: no read back to the host."""
    from test_torch_device_program import _HostReads

    from hitl_slam_torch.parallel.replicas import (build_problems,
                                                   make_perturbed_replicas)
    from hitl_slam_torch.solver import lm as TL
    from hitl_slam_torch.utils import device_loop

    poses, table, _, _ = replicas
    reps, tb = make_perturbed_replicas(poses, table_to_torch(table), B)
    prob = build_problems(reps, tb)
    bodies = []

    def one_trip(cond, body, max_trips):
        bodies.append(body)
        return 0

    orig = TL.device_while
    TL.device_while = one_trip
    try:
        TL.solve_batched(prob, reps, TL.LMConfig(max_iterations=5))
    finally:
        TL.device_while = orig
    assert device_loop.device_while is orig and len(bodies) == 1
    with _HostReads() as mode:
        bodies[0]()
    assert mode.reads == []
