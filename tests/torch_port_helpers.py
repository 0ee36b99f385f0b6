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


def reference_draws(keys, num_segments: int, num_hypotheses: int):
    """A `draws` callable for the port's extract_segments that draws with
    the JAX package's own key tree: `keys` is one jax.random key (as
    ops/ransac.py::extract_segments takes it) or a stack of B keys (as
    propose.py vmaps it). Round r splits its key in two and calls
    jax.random.choice over the availability mask the port hands over, so
    both packages score the same index pairs."""
    import jax
    import jax.numpy as jnp

    keys = np.asarray(keys)
    batched = keys.ndim == 2
    per_round = [jax.random.split(jnp.asarray(k), num_segments)
                 for k in (keys if batched else keys[None])]

    def draw(r, avail):
        av = n(avail) if batched else n(avail)[None]
        M = av.shape[1]
        ia, ib = [], []
        for b, rk in enumerate(per_round):
            k1, k2 = jax.random.split(rk[r])
            p_av = jnp.asarray(av[b]).astype(jnp.float32)
            p_av = p_av / jnp.maximum(jnp.sum(p_av), 1.0)
            ia.append(np.array(jax.random.choice(
                k1, M, (num_hypotheses,), p=p_av)))
            ib.append(np.array(jax.random.choice(
                k2, M, (num_hypotheses,), p=p_av)))
        ia, ib = np.stack(ia), np.stack(ib)
        if not batched:
            ia, ib = ia[0], ib[0]
        return torch.as_tensor(ia), torch.as_tensor(ib)

    return draw


def dense_correlation(field, ki, kj, ok, W: int):
    """The reference's formulation of the scan matcher's scores: each field
    [B, H, H] against its T rasterized 0/1 kernels [K, K] (K = H - W + 1,
    cells ki, kj [B, T, N] where ok) by one dense VALID cross-correlation
    -> [B, T, W, W]."""
    import torch.nn.functional as F

    B, T, _ = ki.shape
    K = field.shape[1] - W + 1
    bt = torch.arange(B * T, device=field.device).view(B, T, 1)
    flat = (bt * K + kj.long()) * K + ki.long()
    flat = torch.where(ok, flat, B * T * K * K)
    kern = torch.zeros((B * T * K * K + 1,), dtype=field.dtype,
                       device=field.device)
    kern[flat.reshape(-1)] = 1.0
    kern = kern[:-1].view(B * T, 1, K, K)
    return F.conv2d(field[None], kern, groups=B)[0].view(B, T, W, W)


def procrustes_error(poses, gt_poses) -> float:
    """Mean position error after the best rigid alignment onto gt_poses
    (the measure of tests/test_scan_match.py)."""
    a = np.asarray(poses[:, :2], np.float64)
    b = np.asarray(gt_poses[:, :2], np.float64)
    ca, cb = a.mean(0), b.mean(0)
    H = (a - ca).T @ (b - cb)
    U, _, Vt = np.linalg.svd(H)
    R = (U @ Vt).T
    if np.linalg.det(R) < 0:
        Vt[-1] *= -1
        R = (U @ Vt).T
    return float(np.linalg.norm((a - ca) @ R.T + cb - b, axis=1).mean())


def _rot(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s], [s, c]])


def _seg_dist(a, b, pts):
    ab = b - a
    t = np.clip(((pts - a) @ ab) / max(ab @ ab, 1e-12), 0.0, 1.0)
    proj = a + t[:, None] * ab
    return np.linalg.norm(pts - proj, axis=1)


def synth_wall_correction(poses, pcs, walls, late, early,
                           capture=0.35, min_pts=40):
    """[4, 2] selection from a localized map (tests/test_enml_session.py):
    the wall both pose ranges observe best, the LATE range's observed
    segment first (corrected) and the EARLY range's second (anchor)."""
    from hitl_slam_torch.io.figure8 import fit_clicked_segment

    def range_pts_near(idx, wall):
        a, b = np.asarray(wall[:2]), np.asarray(wall[2:])
        out = []
        for i in idx:
            w = pcs[i] @ _rot(poses[i, 2]).T + poses[i, :2]
            out.append(w[_seg_dist(a, b, w) < capture])
        return np.concatenate(out) if out else np.zeros((0, 2))

    best, best_n = None, -1
    for wall in walls:
        lp = range_pts_near(late, wall)
        ep = range_pts_near(early, wall)
        n = min(len(lp), len(ep))
        if n > best_n:
            best, best_n = (lp, ep), n
    lp, ep = best
    assert best_n >= min_pts, f"only {best_n} shared wall points"
    return np.concatenate([fit_clicked_segment(lp),
                           fit_clicked_segment(ep)], axis=0)
