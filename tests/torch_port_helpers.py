"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: numpy views of JAX pytrees, and f64 reference solves."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def np_fields(obj) -> dict:
    """{field: np.ndarray} of a JAX dataclass pytree (nested dataclasses
    become nested dicts)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = (np_fields(v) if dataclasses.is_dataclass(v)
                       else np.asarray(v))
    return out


def t(a, dtype=None) -> torch.Tensor:
    """CPU tensor (a copy) from a numpy/JAX array (f32 unless given)."""
    a = np.array(a)
    if dtype is None:
        dtype = {np.dtype(bool): torch.bool, np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64}.get(a.dtype, torch.float32)
    return torch.as_tensor(a, dtype=dtype)


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def random_spd_tridiag(rng, num):
    """Random symmetric positive-definite block-tridiagonal system (f64)."""
    A = rng.normal(size=(num, 3, 3))
    D = A @ np.swapaxes(A, -1, -2) + 4.0 * np.eye(3)
    U = rng.normal(size=(max(num - 1, 0), 3, 3)) * 0.3
    b = rng.normal(size=(num, 3))
    return D, U, b


def banded_solve_f64(D, U, b):
    """f64 direct solve of the block-tridiagonal system by banded LU
    (bandwidth 5: 3x3 blocks on three block diagonals)."""
    from scipy.linalg import solve_banded

    num = D.shape[0]
    ab = np.zeros((11, 3 * num))
    i = np.arange(num)
    j = np.arange(num - 1)
    for r in range(3):
        for c in range(3):
            ab[5 + r - c, 3 * i + c] = D[:, r, c]
            ab[2 + r - c, 3 * (j + 1) + c] = U[:, r, c]      # H[i, i+1]
            ab[8 + r - c, 3 * j + c] = U[:, c, r]            # H[i+1, i]
    return solve_banded((5, 5), ab, b.reshape(-1)).reshape(num, 3)


def chain_poses(rng, num):
    """A drifting chain of f32 poses with small headings (the problems of
    tests/test_lm.py)."""
    p = np.zeros((num, 3), np.float32)
    for i in range(1, num):
        p[i, 2] = p[i - 1, 2] + rng.normal(0, 0.1)
        step = np.array([np.cos(p[i - 1, 2]), np.sin(p[i - 1, 2])]) * 0.5
        p[i, :2] = p[i - 1, :2] + step + rng.normal(0, 0.02, 2)
    return p


def table_to_torch(table):
    """The port's ConstraintTable from the JAX package's."""
    from hitl_slam_torch.core.state import table_from_numpy

    return table_from_numpy(np_fields(table), "cpu")


def matches_to_torch(m):
    """The port's Matches from the JAX package's."""
    from hitl_slam_torch.ops.correspond import Matches

    return Matches(**{k: t(v) for k, v in np_fields(m).items()})


def factors_to_torch(f):
    """The port's STFFactors from the JAX package's."""
    from hitl_slam_torch.ops.correspond import STFFactors

    return STFFactors(**{k: t(v) for k, v in np_fields(f).items()})


def assert_fields_match(got, ref, atol=1e-6, rtol=0.0):
    """Field by field: integer and boolean fields of the port's dataclass
    `got` equal the JAX dataclass `ref`'s, floats agree to the tolerance."""
    for name, want in np_fields(ref).items():
        have = n(getattr(got, name))
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            np.testing.assert_allclose(have, want, atol=atol, rtol=rtol,
                                       err_msg=name)
