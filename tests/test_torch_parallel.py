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
