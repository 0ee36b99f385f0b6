"""The port's host copies of the f64 oracles (hitl_slam_torch/baselines/)
against the JAX package's (hitl_slam_tpu/baselines/): the same numpy and
scipy arithmetic on the same inputs, so the same floats."""

import numpy as np
import pytest
import torch

from torch_port_helpers import chain_poses


def _np_table(rng, P, rows=4):
    """A constraint table in the baselines' dict form: one row of each of
    colocation, colinear, perpendicular and point, on random poses."""
    return dict(
        ctype=np.array([2, 4, 5, 1][:rows], np.int32),
        constrained=rng.integers(P // 2, P, rows).astype(np.int32),
        anchor=rng.integers(0, P // 4, rows).astype(np.int32),
        dpar=rng.normal(0, 0.5, rows).astype(np.float32),
        dperp=rng.normal(0, 0.5, rows).astype(np.float32),
        dth=rng.normal(0, 0.2, rows).astype(np.float32),
        pen=rng.normal(0, 0.5, rows).astype(np.float32),
        active=np.array([True, True, True, False][:rows]))


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("seed", [0, 1])
def test_cpu_lm_solve_equals_reference(seed):
    from hitl_slam_torch.baselines import cpu_lm as T
    from hitl_slam_tpu.baselines import cpu_lm as J

    rng = np.random.default_rng(seed)
    poses = chain_poses(rng, 60)
    table = _np_table(rng, 60)
    got = T.cpu_lm_solve(poses, table, max_iterations=50)
    want = J.cpu_lm_solve(poses, table, max_iterations=50)
    assert got[2] > 1
    _same(got, want)
    _same(T.build_odometry_factors_np(poses.astype(np.float64)),
          J.build_odometry_factors_np(poses.astype(np.float64)))
    _same(T.build_human_factors_np(poses.astype(np.float64), table),
          J.build_human_factors_np(poses.astype(np.float64), table))


def test_scipy_generic_solve_equals_reference():
    from hitl_slam_torch.baselines import cpu_lm as T
    from hitl_slam_tpu.baselines import cpu_lm as J

    rng = np.random.default_rng(2)
    poses = chain_poses(rng, 16)
    table = _np_table(rng, 16)
    got = T.scipy_generic_solve(poses, table, max_nfev=20)
    want = J.scipy_generic_solve(poses, table, max_nfev=20)
    _same(got[:2], want[:2])


@pytest.mark.parametrize("seed", [0, 1])
def test_cpu_refine_solve_equals_reference(seed):
    """cpu_refine_solve on a chain with STF pair factors between random
    pose pairs, the factors handed over as the port's STFFactors of tensors
    (its stf_to_numpy) and as numpy arrays (the reference's)."""
    from hitl_slam_torch.baselines import cpu_refine as T
    from hitl_slam_torch.ops.correspond import STFFactors
    from hitl_slam_tpu.baselines import cpu_refine as J

    rng = np.random.default_rng(seed)
    P, C = 12, 48
    poses = chain_poses(rng, P)
    table = _np_table(rng, P)
    p0 = rng.integers(0, P - 1, C)
    stf = dict(
        pose0=p0.astype(np.int32),
        pose1=(p0 + rng.integers(1, 3, C)).clip(max=P - 1).astype(np.int32),
        p0=rng.normal(0, 2, (C, 2)).astype(np.float32),
        p1=rng.normal(0, 2, (C, 2)).astype(np.float32),
        n0=rng.normal(size=(C, 2)).astype(np.float32),
        n1=rng.normal(size=(C, 2)).astype(np.float32),
        weight=rng.uniform(1, 10, C).astype(np.float32),
        valid=rng.uniform(size=C) < 0.8)
    for k in ("n0", "n1"):
        stf[k] /= np.linalg.norm(stf[k], axis=1, keepdims=True)
    port = T.stf_to_numpy(STFFactors(**{k: torch.as_tensor(v)
                                        for k, v in stf.items()}))
    ref = J.stf_to_numpy(STFFactors(**stf))
    assert port.keys() == ref.keys()
    _same(port.values(), ref.values())
    got = T.cpu_refine_solve(poses, table, port, max_iterations=20)
    want = J.cpu_refine_solve(poses, table, ref, max_iterations=20)
    assert got[2] > 1
    _same(got, want)
    _same(T.stf_residuals_jacobians_np(port, poses.astype(np.float64)),
          J.stf_residuals_jacobians_np(ref, poses.astype(np.float64)))
