"""The multi-right-hand-side BCR route (solver/bcr_kernel.py::
bcr_solve_multi, csrc/bcr.cu's hitl_bcr_solve_multi) on the CPU: its plain
version against per-column solves of solver/tridiag.py::bcr_solve and of the
JAX package's tridiag.bcr_solve, and the SPIKE's local solve handing it one
system a partition with its 7 columns. The kernel itself runs only on the
card (tests/test_torch_kernels.py, marker `cuda`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t

torch.set_num_threads(2)


def _systems(S, num, R, seed):
    """S SPD block-tridiagonal systems of `num` poses and R right-hand
    sides, made with numpy: (D [S,num,3,3], U [S,num-1,3,3], b [S,num,3,R])
    as float32 arrays."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, num, 3, 3))
    D = A @ np.swapaxes(A, -1, -2) + 4.0 * np.eye(3)
    U = rng.normal(size=(S, max(num - 1, 0), 3, 3)) * 0.3
    b = rng.normal(size=(S, num, 3, R))
    return tuple(a.astype(np.float32) for a in (D, U, b))


@pytest.mark.parametrize("R", [1, 7])
@pytest.mark.parametrize("num", [1, 2, 127, 128, 129])
def test_twin_equals_per_column_solves(num, R):
    """Each column of the twin is bit-equal to a lone tridiag.bcr_solve on
    it, and within f32 round-off of the JAX package's bcr_solve."""
    from hitl_slam_torch.solver import bcr_kernel, tridiag
    from hitl_slam_tpu.solver import tridiag as JT

    D, U, b = _systems(3, num, R, seed=10 * num + R)
    x = bcr_kernel.bcr_solve_multi(t(D), t(U), t(b))
    assert x.shape == (3, num, 3, R)
    scale = max(1.0, float(x.abs().max()))
    for s in range(3):
        for c in range(R):
            lone = tridiag.bcr_solve(t(D[s]), t(U[s]),
                                     t(np.ascontiguousarray(b[s, :, :, c])))
            assert torch.equal(x[s, :, :, c], lone)
            ref = np.asarray(JT.bcr_solve(jnp.asarray(D[s]),
                                          jnp.asarray(U[s]),
                                          jnp.asarray(b[s, :, :, c])))
            assert np.abs(x[s, :, :, c].numpy() - ref).max() <= 1e-5 * scale


def test_twin_takes_a_strided_u():
    """U as a view [:, :-1] of an [S, n, 3, 3] tensor (the SPIKE's) gives
    the twin's answer on a contiguous copy, bit for bit."""
    from hitl_slam_torch.solver import bcr_kernel

    D, U, b = _systems(4, 33, 7, seed=3)
    Ufull = torch.cat([t(U), torch.ones((4, 1, 3, 3))], 1)
    view = Ufull[:, :-1]
    assert not view.is_contiguous()
    assert torch.equal(bcr_kernel.bcr_solve_multi(t(D), view, t(b)),
                       bcr_kernel.bcr_solve_multi(t(D), t(U), t(b)))


def test_spike_solve_hands_the_route_one_system_a_partition(monkeypatch):
    """_spike_solve calls the multi route once a device group with the
    group's n partitions as they are: D [n, Pl, 3, 3], U [n, Pl - 1, 3, 3]
    (a view, no copy) and b [n, Pl, 3, 7], never 7n systems, and the
    sharded LM's result is unchanged."""
    from hitl_slam_torch.parallel import mesh as M
    from hitl_slam_torch.parallel import sharded_solver as S
    from hitl_slam_torch.solver import bcr_kernel, joint
    from hitl_slam_torch.solver.lm import LMConfig

    rng = np.random.default_rng(5)
    P, d = 32, 4
    poses = np.cumsum(rng.normal(scale=[0.5, 0.5, 0.1], size=(P, 3)), 0)
    from torch_port_helpers import table_to_torch
    from test_parallel import _table
    table = table_to_torch(_table(jnp.asarray(poses, jnp.float32), rng))
    problem = joint.build_problem(t(poses), table)
    config = LMConfig(max_iterations=3)
    want = S.sharded_lm_solve(M.make_mesh(1, d, [torch.device("cpu")] * d),
                              problem, t(poses), config)

    calls, real = [], bcr_kernel.bcr_solve_multi

    def spy(D, U, b):
        calls.append((tuple(D.shape), tuple(U.shape), tuple(b.shape),
                      U._base is not None, U.stride(0)))
        return real(D, U, b)

    monkeypatch.setattr(bcr_kernel, "bcr_solve_multi", spy)
    batched = []
    monkeypatch.setattr(bcr_kernel, "bcr_solve",
                        lambda *a: batched.append(a) or None)
    for devices, groups in (([torch.device("cpu")] * d, 1),
                            ([torch.device("cpu", i) for i in range(d)], d)):
        calls.clear()
        got = S.sharded_lm_solve(M.make_mesh(1, d, devices), problem,
                                 t(poses), config)
        it = int(got.iterations)
        assert len(calls) == it * groups and not batched
        n, Pl = d // groups, P // d
        for Dshape, Ushape, bshape, is_view, stride in calls:
            assert Dshape == (n, Pl, 3, 3)
            assert Ushape == (n, Pl - 1, 3, 3)
            assert bshape == (n, Pl, 3, 7)
            # the view of the partition's U, not a copy
            assert is_view and (n == 1 or stride == 9 * Pl)
        assert torch.equal(got.poses, want.poses)
        assert int(got.iterations) == int(want.iterations)
