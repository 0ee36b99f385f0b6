"""Port parity of the post-human STF refine on the CPU: the PCG solver, the
correspondence engine, the dense and matrix-free STF solves and the refine
end to end, each against the JAX package on the same inputs (made from a
numpy seed, f32). Integer and boolean outputs (match targets, valid masks,
drop counters, iteration counts) are compared for equality; float
tolerances are stated where they are used."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hitl_slam_tpu.core.state import ConstraintTable as JTable
from hitl_slam_tpu.core.state import make_map_state as j_make_map_state
from hitl_slam_tpu.models.hitl import refine as JR
from hitl_slam_tpu.ops import correspond as JC
from hitl_slam_tpu.solver import cg as JCG
from hitl_slam_tpu.solver import stf_solve as JS
from hitl_slam_tpu.solver import tridiag as JT
from hitl_slam_tpu.solver.joint import build_problem as j_build_problem
from hitl_slam_tpu.solver.lm import LMConfig as JLMConfig

from hitl_slam_torch.core import state as TState
from hitl_slam_torch.models.hitl import refine as TR
from hitl_slam_torch.ops import correspond as TC
from hitl_slam_torch.solver import cg as TCG
from hitl_slam_torch.solver import stf_solve as TS
from hitl_slam_torch.solver import tridiag as TT
from hitl_slam_torch.solver.joint import build_problem as t_build_problem
from hitl_slam_torch.solver.lm import LMConfig as TLMConfig

from torch_port_helpers import (assert_fields_match, factors_to_torch,
                                matches_to_torch, n, np_fields,
                                random_spd_tridiag, t, table_to_torch)

torch.set_num_threads(2)


# ------------------------------------------------------------ tridiag / cg

@pytest.mark.parametrize("num", [1, 2, 127, 128, 129, 1000])
def test_bcr_factor_apply_parity(num):
    """bcr_apply(bcr_factor(D, U), b) against the JAX pair, against the
    port's own bcr_solve (f32 round-off) and against a dense f64 solve."""
    rng = np.random.default_rng(num)
    D, U, b = (a.astype(np.float32) for a in random_spd_tridiag(rng, num))
    want = np.asarray(JT.bcr_apply(JT.bcr_factor(jnp.asarray(D),
                                                 jnp.asarray(U)),
                                   jnp.asarray(b)))
    fac = TT.bcr_factor(t(D), t(U))
    got = n(TT.bcr_apply(fac, t(b)))
    assert len(fac[0]) == len(JT.bcr_factor(jnp.asarray(D),
                                            jnp.asarray(U))[0])
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    np.testing.assert_allclose(got, n(TT.bcr_solve(t(D), t(U), t(b))),
                               atol=1e-5 * scale)
    # a second right-hand side through the same factorization
    b2 = rng.normal(size=(num, 3)).astype(np.float32)
    np.testing.assert_allclose(n(TT.bcr_apply(fac, t(b2))),
                               n(TT.bcr_solve(t(D), t(U), t(b2))),
                               atol=1e-5 * scale)


def _pcg_problem(rng, num=64, pairs=24):
    D, U, b = (a.astype(np.float32) for a in random_spd_tridiag(rng, num))
    # a symmetric positive semi-definite coupling of random pose pairs
    bi = rng.integers(0, num, pairs)
    bj = (bi + 1 + rng.integers(0, num - 1, pairs)) % num
    J = rng.normal(size=(pairs, 2, 3, 3)).astype(np.float32) * 0.3
    return D, U, b, bi, bj, J


def test_tridiag_matvec_parity(rng):
    D, U, b, *_ = _pcg_problem(rng)
    np.testing.assert_allclose(
        n(TCG.tridiag_matvec(t(D), t(U), t(b))),
        np.asarray(JCG.tridiag_matvec(jnp.asarray(D), jnp.asarray(U),
                                      jnp.asarray(b))), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("preconditioner", ["jacobi", "tridiag"])
@pytest.mark.parametrize("extra", [False, True])
def test_pcg_solve_parity(rng, preconditioner, extra):
    """x to 1e-5 relative to max|x|; the iteration counts are equal or
    differ by one (the loop test compares an f32 residual norm with the
    tolerance, and the two packages sum that norm in another order)."""
    D, U, b, bi, bj, J = _pcg_problem(rng)
    j_extra = t_extra = None
    if extra:
        def j_extra(v):
            # sum over pairs of [Ja Jb]^T [Ja Jb] applied to (v[bi], v[bj])
            u = (jnp.einsum("kab,kb->ka", J[:, 0], v[bi])
                 + jnp.einsum("kab,kb->ka", J[:, 1], v[bj]))
            out = jnp.zeros_like(v).at[bi].add(
                jnp.einsum("kab,ka->kb", J[:, 0], u))
            return out.at[bj].add(jnp.einsum("kab,ka->kb", J[:, 1], u))

        Jt, bit, bjt = t(J), t(bi, torch.int64), t(bj, torch.int64)

        def t_extra(v):
            u = (torch.einsum("kab,kb->ka", Jt[:, 0], v[bit])
                 + torch.einsum("kab,kb->ka", Jt[:, 1], v[bjt]))
            out = torch.zeros_like(v).index_add_(
                0, bit, torch.einsum("kab,ka->kb", Jt[:, 0], u))
            return out.index_add_(
                0, bjt, torch.einsum("kab,ka->kb", Jt[:, 1], u))

    xj, rj, itj = JCG.pcg_solve(jnp.asarray(D), jnp.asarray(U),
                                jnp.asarray(b), extra_matvec=j_extra,
                                preconditioner=preconditioner)
    xt, rt, itt = TCG.pcg_solve(t(D), t(U), t(b), extra_matvec=t_extra,
                                preconditioner=preconditioner)
    scale = float(np.abs(np.asarray(xj)).max())
    np.testing.assert_allclose(n(xt), np.asarray(xj), atol=1e-5 * scale)
    assert abs(itt - int(itj)) <= 1, (itt, int(itj))
    assert 0 < itt < 256 and float(rt) <= 1e-6
    if not extra and preconditioner == "tridiag":
        assert itt <= 2       # the preconditioner is the exact inverse


def test_pcg_x0_and_tridiag_solver(rng):
    D, U, b, *_ = _pcg_problem(rng)
    x = TCG.pcg_tridiag(t(D), t(U), t(b))
    np.testing.assert_allclose(
        n(x), np.asarray(JCG.pcg_tridiag(jnp.asarray(D), jnp.asarray(U),
                                         jnp.asarray(b))), atol=1e-5)
    # started from the solution, no iteration is needed
    _, res, it = TCG.pcg_solve(t(D), t(U), t(b), x0=x, tolerance=1e-5)
    assert it == 0 and float(res) <= 1e-5
    with pytest.raises(ValueError):
        TCG.pcg_solve(t(D), t(U), t(b), preconditioner="none")


# -------------------------------------------------------------- grid_match

def _random_cloud(rng, P=4, N=48, extent=4.0, masked=0.1):
    pts = rng.uniform(0, extent, (P, N, 2)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, (P, N))
    nrm = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    mask = rng.uniform(size=(P, N)) > masked
    return pts, nrm, mask


def _wall(nn=64, offset=0.05):
    x = np.linspace(0.0, 3.0, nn)
    pts0 = np.stack([x, np.zeros(nn)], -1).astype(np.float32)
    pts1 = pts0 + np.array([0.0, offset], np.float32)
    nrm = np.tile(np.array([[0.0, 1.0]], np.float32), (2, nn, 1))
    return np.stack([pts0, pts1]), nrm, np.ones((2, nn), bool)


def _grid_cases():
    """The fixtures of tests/test_stf.py's grid_match tests."""
    rng = np.random.default_rng(1234)
    cases = {}
    cases["random"] = (*_random_cloud(rng), dict(threshold=0.3))
    nn = 48
    base = np.stack([np.linspace(0.0, 2.0, nn), np.zeros(nn)],
                    -1).astype(np.float32)
    jit_ = rng.normal(0, 2e-6, (nn, 2)).astype(np.float32)
    up = np.tile(np.array([[0.0, 1.0]], np.float32), (2, nn, 1))
    cases["near_coincident"] = (np.stack([base, base + jit_]), up,
                                np.ones((2, nn), bool), {})
    nn = 96
    cases["density_cap"] = (
        rng.uniform(0, 0.05, (2, nn, 2)).astype(np.float32),
        np.tile(np.array([[0.0, 1.0]], np.float32), (2, nn, 1)),
        np.ones((2, nn), bool), dict(threshold=0.15, bucket=64))
    nn = 8
    far = np.zeros((2, nn, 2), np.float32)
    far[0, :, 0] = np.linspace(0, 0.5, nn)
    far[1, :, 0] = 3000.0 + np.linspace(0, 0.01, nn)
    far[1, :2, 0] = -5000.0
    cases["out_of_span"] = (
        far, np.tile(np.array([[0.0, 1.0]], np.float32), (2, nn, 1)),
        np.ones((2, nn), bool), dict(threshold=0.15))
    cases["wall"] = (*_wall(), dict(threshold=0.2))
    # more occupied cells than max_cells: whole cells are dropped
    cases["cell_cap"] = (*_random_cloud(rng, P=3, N=64, extent=6.0),
                         dict(threshold=0.3, max_cells=16))
    return cases


_GRID_DROPPED = {"random": 0, "near_coincident": 0, "density_cap": 192 - 64,
                 "out_of_span": 8, "wall": 0}


@pytest.mark.parametrize("case", list(_grid_cases()))
def test_grid_match_parity(case):
    """target, valid and dropped equal; dist to 1e-6. Between
    near-coincident points the expanded squared distance is all round-off
    (~1e-9 of coordinates of ~0.1), and the two packages round it
    differently, so there the squared distance is held to 1e-8 and the
    distance itself to its square root."""
    pts, nrm, mask, kw = _grid_cases()[case]
    ref = JC.grid_match(jnp.asarray(pts), jnp.asarray(nrm),
                        jnp.asarray(mask), **kw)
    got = TC.grid_match(t(pts), t(nrm), t(mask), **kw)
    assert got.target.dtype == torch.int32 and got.valid.dtype == torch.bool
    if case == "near_coincident":
        np.testing.assert_allclose(n(got.dist) ** 2,
                                   np.asarray(ref.dist) ** 2, atol=1e-8)
        assert np.isfinite(n(got.dist)).all()
    assert_fields_match(got, ref,
                        atol=1e-4 if case == "near_coincident" else 1e-6)
    if case in _GRID_DROPPED:
        assert int(got.dropped) == _GRID_DROPPED[case]
    else:
        assert int(got.dropped) > 0
    if case != "out_of_span":
        assert int(got.valid.sum()) > 0


def test_grid_match_vs_bruteforce(rng):
    """The port's matches are the brute-force nearest gated neighbours."""
    P, N = 4, 48
    pts, nrm, mask = _random_cloud(rng, P, N)
    m = TC.grid_match(t(pts), t(nrm), t(mask), threshold=0.3)
    flat, fnrm, fmask = pts.reshape(-1, 2), nrm.reshape(-1, 2), mask.reshape(-1)
    pose = np.repeat(np.arange(P), N)
    min_cos = float(np.cos(25 * np.pi / 180))
    got_t, got_v = n(m.target), n(m.valid)
    for i in range(P * N):
        d2 = np.sum((flat - flat[i]) ** 2, -1)
        ok = (fmask & fmask[i] & (pose != pose[i]) & (d2 < 0.09)
              & (fnrm @ fnrm[i] > min_cos))
        assert got_v[i] == ok.any(), i
        if ok.any():
            assert got_t[i] == np.flatnonzero(ok)[np.argmin(d2[ok])], i


def test_nonzero_fixed():
    mask = t(np.array([0, 1, 1, 0, 1, 0, 1], bool))
    assert TC.nonzero_fixed(mask, 6, 7).tolist() == [1, 2, 4, 6, 7, 7]
    assert TC.nonzero_fixed(mask, 2, 7).tolist() == [1, 2]
    assert TC.nonzero_fixed(torch.zeros(4, dtype=torch.bool), 3,
                            9).tolist() == [9, 9, 9]


# ------------------------------------------------------------------ factors

def test_build_stf_factors_parity(rng):
    """Fed the reference's Matches: integer fields and `valid` equal, floats
    to 1e-6; also with a capacity below the number of valid matches."""
    pts, nrm, mask = _random_cloud(rng, P=5, N=64, extent=1.5, masked=0.05)
    mj = JC.grid_match(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(mask),
                       threshold=0.3, min_cos=-1.0)
    mt = matches_to_torch(mj)
    for capacity, min_pair in ((512, 5), (512, 10), (40, 2)):
        ref = JC.build_stf_factors(jnp.asarray(pts), jnp.asarray(nrm), mj,
                                   capacity=capacity,
                                   min_pair_matches=min_pair)
        got = TC.build_stf_factors(t(pts), t(nrm), mt, capacity=capacity,
                                   min_pair_matches=min_pair)
        assert got.pose0.dtype == torch.int32
        assert_fields_match(got, ref, atol=1e-6)
        assert int(got.valid.sum()) > 0
    assert int(got.valid.sum()) == 40    # the table overflowed


def _pair_inputs(rng, P, N):
    pts, nrm, mask = _random_cloud(rng, P, N, extent=2.0, masked=0.15)
    poses = rng.uniform(-0.05, 0.05, (P, 3)).astype(np.float32)
    return pts, nrm, mask, poses


@pytest.mark.parametrize("elect_impl", ["top_k", "argsort"])
@pytest.mark.parametrize("max_pairs", [4, 32])
def test_pair_match_factors_parity(rng, elect_impl, max_pairs):
    """Both ways of electing, under election overflow (4) and with headroom
    (32): every field and every PairMatchInfo count as in the reference."""
    pts, nrm, mask, poses = _pair_inputs(rng, 6, 24)
    kw = dict(max_pairs=max_pairs, capacity=512, pair_chunk=8,
              min_pair_matches=2, threshold=0.5, elect_impl=elect_impl)
    fj, ij = JC.pair_match_factors(jnp.asarray(pts), jnp.asarray(nrm),
                                   jnp.asarray(mask), jnp.asarray(poses),
                                   **kw)
    ft, it = TC.pair_match_factors(t(pts), t(nrm), t(mask), t(poses), **kw)
    assert_fields_match(ft, fj, atol=1e-6)
    assert_fields_match(it, ij)
    assert int(it.n_pairs) > 0 and int(it.n_matches) > 0
    assert (int(it.pairs_overflow) > 0) == (max_pairs == 4)


def test_pair_match_factors_edge_cases(rng):
    """Empty masks, an election capacity below the voted pairs, a factor
    table below the emitted rows, and P*N below the default election
    capacity: counts as in the reference."""
    P, N = 4, 16
    pts = rng.uniform(0, 1.0, (P, N, 2)).astype(np.float32)
    nrm = np.tile(np.array([[0.0, 1.0]], np.float32), (P, N, 1))
    poses = np.zeros((P, 3), np.float32)
    for mask, kw in (
        (np.zeros((P, N), bool), dict(max_pairs=8, capacity=64, pair_chunk=4,
                                      min_pair_matches=1, threshold=0.5)),
        (np.ones((P, N), bool), dict(max_pairs=2, capacity=16, pair_chunk=2,
                                     min_pair_matches=1, threshold=2.0)),
        (np.ones((P, N), bool), dict(capacity=64, pair_chunk=8,
                                     min_pair_matches=1, threshold=2.0)),
    ):
        fj, ij = JC.pair_match_factors(jnp.asarray(pts), jnp.asarray(nrm),
                                       jnp.asarray(mask), jnp.asarray(poses),
                                       **kw)
        ft, it = TC.pair_match_factors(t(pts), t(nrm), t(mask), t(poses),
                                       **kw)
        assert_fields_match(ft, fj, atol=1e-6)
        assert_fields_match(it, ij)
    with pytest.raises(ValueError):
        TC.pair_match_factors(t(pts), t(nrm), t(mask), t(poses),
                              elect_impl="heap")


def _wall_factors(poses):
    """The two-scan wall of tests/test_stf.py: (reference factors, the
    port's copy, poses as a tensor)."""
    world, normals, mask = _wall()
    m = JC.grid_match(jnp.asarray(world), jnp.asarray(normals),
                      jnp.asarray(mask), threshold=0.2)
    f = JC.build_stf_factors(jnp.asarray(world), jnp.asarray(normals), m,
                             capacity=256, min_pair_matches=5)
    assert int(jnp.sum(f.valid)) > 50
    return f, factors_to_torch(f), t(np.asarray(poses, np.float32))


def test_stf_residuals_jacobians_parity_and_autograd():
    poses = [[0, 0, 0], [0.1, -0.02, 0.03]]
    fj, ft, pt = _wall_factors(poses)
    pj = jnp.asarray(np.asarray(poses, np.float32))
    np.testing.assert_allclose(n(TC.stf_residuals(ft, pt)),
                               np.asarray(JC.stf_residuals(fj, pj)),
                               atol=1e-6)
    J0, J1 = TC.stf_jacobians(ft, pt)
    J0j, J1j = JC.stf_jacobians(fj, pj)
    np.testing.assert_allclose(n(J0), np.asarray(J0j), atol=1e-5)
    np.testing.assert_allclose(n(J1), np.asarray(J1j), atol=1e-5)

    Jfull = torch.autograd.functional.jacobian(
        lambda flat: TC.stf_residuals(ft, flat.reshape(2, 3)).reshape(-1),
        pt.reshape(-1))
    Cn = ft.pose0.shape[0]
    Jfull = n(Jfull).reshape(Cn, 2, 6)
    p0, p1 = n(ft.pose0), n(ft.pose1)
    for k in np.flatnonzero(n(ft.valid))[:40]:
        np.testing.assert_allclose(Jfull[k][:, 3 * p0[k]:3 * p0[k] + 3],
                                   n(J0[k]), atol=1e-4, err_msg=f"J0 {k}")
        np.testing.assert_allclose(Jfull[k][:, 3 * p1[k]:3 * p1[k] + 3],
                                   n(J1[k]), atol=1e-4, err_msg=f"J1 {k}")


def test_stf_scalar_products_match_aos():
    """The flat-lane products against the port's own J^T J / J^T r blocks
    and against the reference's products."""
    poses = [[0.02, -0.01, 0.01], [0.1, -0.02, 0.03]]
    fj, ft, pt = _wall_factors(poses)
    r = n(TC.stf_residuals(ft, pt))
    J0, J1 = (n(a) for a in TC.stf_jacobians(ft, pt))
    got = [n(a) for a in TS._stf_scalar_products(ft, pt)]
    X0, X1, X2, sq = got
    Cn = ft.pose0.shape[0]
    J0T, J1T = np.swapaxes(J0, -1, -2), np.swapaxes(J1, -1, -2)
    for have, want in (
        (X0[:, :9], (J0T @ J0).reshape(Cn, 9)),
        (X1[:, :9], (J1T @ J1).reshape(Cn, 9)),
        (X2, (J0T @ J1).reshape(Cn, 9)),
        (X0[:, 9:], (J0T @ r[..., None])[..., 0]),
        (X1[:, 9:], (J1T @ r[..., None])[..., 0]),
    ):
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sq, np.sum(r * r, -1), rtol=1e-5, atol=1e-6)
    ref = JS._stf_scalar_products(fj, jnp.asarray(np.asarray(poses,
                                                             np.float32)))
    for have, want in zip(got, ref):
        np.testing.assert_allclose(have, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_segmented_pair_sums_large_capacity_precision(rng):
    """Port of the reference's test: at the full 65536-row capacity small
    late runs keep their digits (a plain cumsum difference would lose
    ~4e-3 relative). torch.cumsum and XLA's scan sum in another order, so
    the two packages agree to round-off of the local block, not bit for
    bit."""
    Cn = 65536
    X = rng.uniform(0.1, 0.5, (Cn, 9)).astype(np.float32)
    bounds = [0]
    i = 0
    while i < Cn - 256:
        i += int(rng.integers(8, 200))
        bounds.append(min(i, Cn - 256))
    i = Cn - 256
    while i < Cn:
        bounds.append(i)
        i += 2
    bounds = np.unique(np.asarray(bounds + [Cn]))
    run_start = np.zeros(Cn, np.int32)
    for s, e in zip(bounds[:-1], bounds[1:]):
        run_start[s:e] = s
    got = n(TS._segmented_pair_sums(t(X), t(run_start)))
    cs64 = np.cumsum(X.astype(np.float64), axis=0)
    a = run_start - 1
    want = cs64 - np.where((a >= 0)[:, None], cs64[np.maximum(a, 0)], 0)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-12)
    assert float(rel.max()) < 5e-4, float(rel.max())
    ref = np.asarray(JS._segmented_pair_sums(jnp.asarray(X),
                                             jnp.asarray(run_start)))
    np.testing.assert_allclose(got, ref, rtol=2e-4)


# ----------------------------------------------------------------- assembly

def _random_factors(rng, P=6, Cn=96):
    """Random valid-masked factors over P poses with unit normals and
    pose0 < pose1 (tests/test_stf.py::_random_factors), as numpy."""
    pose0 = rng.integers(0, P - 1, Cn).astype(np.int32)
    pose1 = (pose0 + 1 + rng.integers(0, P - 1, Cn) % (P - 1 - pose0
             ).clip(min=1)).clip(max=P - 1).astype(np.int32)
    ang0 = rng.uniform(0, 2 * np.pi, Cn)
    ang1 = rng.uniform(0, 2 * np.pi, Cn)
    return dict(
        pose0=pose0, pose1=pose1,
        p0=rng.uniform(-2, 2, (Cn, 2)).astype(np.float32),
        p1=rng.uniform(-2, 2, (Cn, 2)).astype(np.float32),
        n0=np.stack([np.cos(ang0), np.sin(ang0)], -1).astype(np.float32),
        n1=np.stack([np.cos(ang1), np.sin(ang1)], -1).astype(np.float32),
        weight=rng.uniform(0.5, 2.0, Cn).astype(np.float32),
        valid=rng.uniform(size=Cn) > 0.2)


def _both_factors(arrays):
    return (JC.STFFactors(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            TC.STFFactors(**{k: t(v) for k, v in arrays.items()}))


def _constrained_table(P):
    """A table with three active human constraints (the rows of
    tests/test_cpu_baseline.py, pose ids scaled into P)."""
    tab = {k: v.copy() for k, v in np_fields(JTable.empty(8)).items()}
    tab["ctype"][:3] = [2, 4, 5]
    tab["constrained"][:3] = [P - 2, P - 1, P - 3]
    tab["anchor"][:3] = [0, 1, 2]
    tab["delta_parallel"][:3] = [0.5, 0.2, 0.0]
    tab["delta_perpendicular"][:3] = [-0.2, 0.4, 0.0]
    tab["delta_angle"][:3] = [0.1, -0.1, 0.2]
    tab["penalty_dir"][:3] = [0.0, 0.7, 0.0]
    tab["active"][:3] = True
    return (JTable(**{k: jnp.asarray(v) for k, v in tab.items()}),
            TState.table_from_numpy(tab, "cpu"))


def test_sort_and_compact_pair_rows_parity(rng):
    P = 6
    fj, ft = _both_factors(_random_factors(rng, P))
    sj, lastj, startj = JS.sort_factors_by_pair(fj, P)
    st, lastt, startt = TS.sort_factors_by_pair(ft, P)
    assert_fields_match(st, sj, atol=0)
    np.testing.assert_array_equal(n(lastt), np.asarray(lastj))
    np.testing.assert_array_equal(n(startt), np.asarray(startj))
    for max_pairs in (16384, 32, 3):
        outj = JS.compact_pair_rows(sj, lastj, P, max_pairs=max_pairs)
        outt = TS.compact_pair_rows(st, lastt, P, max_pairs=max_pairs)
        for a, b in zip(outt, outj):
            np.testing.assert_array_equal(n(a), np.asarray(b))
    assert int(outt[3]) == int(lastt.sum()) - 3    # overflow is counted


@pytest.mark.parametrize("branch", ["aos", "onehot", "pair_runs",
                                    "pair_compact"])
@pytest.mark.parametrize("include_chain", [True, False])
def test_assemble_dense_parity(rng, branch, include_chain):
    """H, g and cost on every branch of assemble_dense, to 1e-5 relative to
    the largest entry."""
    P = 6
    fj, ft = _both_factors(_random_factors(rng, P))
    poses = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    tj, tt = _constrained_table(P)
    pj, pt = jnp.asarray(poses), t(poses)
    probj, probt = j_build_problem(pj, tj), t_build_problem(pt, tt)
    argsj, argst = [None, None, None], [None, None, None]
    if branch != "aos":
        if branch != "onehot":
            fj, lastj, startj = JS.sort_factors_by_pair(fj, P)
            ft, lastt, startt = TS.sort_factors_by_pair(ft, P)
            argsj[1], argst[1] = (lastj, startj), (lastt, startt)
        argsj[0] = JS.stf_onehots(fj, P, jnp.float32)
        argst[0] = TS.stf_onehots(ft, P, torch.float32)
        if branch == "pair_compact":
            argsj[2] = JS.compact_pair_rows(fj, lastj, P, max_pairs=64)[:3]
            argst[2] = TS.compact_pair_rows(ft, lastt, P, max_pairs=64)[:3]
    Hj, gj, cj = JS.assemble_dense(probj, fj, pj, include_chain, *argsj)
    Ht, gt, ct = TS.assemble_dense(probt, ft, pt, include_chain, *argst)
    Hj, gj = np.asarray(Hj), np.asarray(gj)
    np.testing.assert_allclose(n(Ht), Hj, atol=1e-5 * np.abs(Hj).max())
    np.testing.assert_allclose(n(gt), gj, atol=1e-5 * np.abs(gj).max())
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-5)
    np.testing.assert_array_equal(n(Ht)[:3, :3], np.eye(3))
    assert not n(Ht)[:3, 3:].any() and not n(gt)[:3].any()


def test_stf_onehots_budget(rng, monkeypatch):
    fj, ft = _both_factors(_random_factors(rng))
    monkeypatch.setattr(TS, "STF_ONEHOT_BUDGET", 96 * 6 - 1)
    assert TS.stf_onehots(ft, 6, torch.float32) is None
    monkeypatch.setattr(TS, "STF_ONEHOT_BUDGET", 96 * 6)
    oh = TS.stf_onehots(ft, 6, torch.float32)
    np.testing.assert_array_equal(
        n(oh[0]), np.asarray(JS.stf_onehots(fj, 6, jnp.float32)[0]))


def test_pcg_compact_system_parity(rng):
    """_stf_system_compact and _pair_block_matvec against the reference's,
    and against brute-force scatters of the port's own Jacobians."""
    P, Cn = 6, 96
    fj, ft = _both_factors(_random_factors(rng, P, Cn))
    poses = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    v = rng.uniform(-1, 1, (P, 3)).astype(np.float32)

    sj, lastj, startj = JS.sort_factors_by_pair(fj, P)
    pcj = JS.compact_pair_rows(sj, lastj, P)
    redj = JS._pcg_reductions(sj, startj, pcj[:3], P)
    outj = JS._stf_system_compact(sj, jnp.asarray(poses), redj)
    mvj = JS._pair_block_matvec(outj[3], redj, P)(jnp.asarray(v))

    st, lastt, startt = TS.sort_factors_by_pair(ft, P)
    pct = TS.compact_pair_rows(st, lastt, P)
    assert int(pct[3]) == 0
    redt = TS._pcg_reductions(st, startt, pct[:3], P)
    outt = TS._stf_system_compact(st, t(poses), redt)
    mvt = TS._pair_block_matvec(outt[3], redt, P)(t(v))
    for have, want in zip((*outt, mvt), (*outj, mvj)):
        np.testing.assert_allclose(n(have), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)

    r = TC.stf_residuals(ft, t(poses))
    J0, J1 = TC.stf_jacobians(ft, t(poses))
    J0T, J1T = J0.transpose(-1, -2), J1.transpose(-1, -2)
    i0, i1 = ft.pose0.long(), ft.pose1.long()
    Dref = torch.zeros(P, 3, 3).index_add_(0, i0, J0T @ J0).index_add_(
        0, i1, J1T @ J1)
    Dref[0] = 0
    np.testing.assert_allclose(n(outt[0]), n(Dref), rtol=2e-4, atol=2e-4)
    vz = t(v)
    vz[0] = 0
    ref = torch.zeros(P, 3).index_add_(
        0, i0, (J0T @ (J1 @ vz[i1][..., None]))[..., 0]).index_add_(
        0, i1, (J1T @ (J0 @ vz[i0][..., None]))[..., 0])
    ref[0] = 0
    np.testing.assert_allclose(n(mvt), n(ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(outt[2]), float(0.5 * torch.sum(r * r)),
                               rtol=1e-5)


# ------------------------------------------------------------------- solves
#
# LM iteration counts. The refine polishes a map that is already nearly
# consistent against a stiff odometry chain, so after the first steps the
# cost moves by less than f32 can resolve (the two packages' costs differ by
# ~1e-5 relative at the same poses: residuals are differences of O(10 m)
# coordinates). Whether such a step counts as accepted, and so when the loop
# ends, is then decided by round-off, and the counts of the two packages
# differ (e.g. 6 against 5 on small_map) while cost and poses agree. So the
# iteration counts are compared on a problem and at a function tolerance
# (1e-3) that f32 resolves, where every step before the last is accepted by a
# clear margin; at the default tolerance the final cost and the poses are
# compared.

RESOLVED = dict(max_iterations=20, function_tolerance=1e-3)


def _corner_room(seed=5, P=8, N=64):
    """P poses looking at one L-shaped corner (two walls, so every degree of
    freedom is observed), the pose estimates off by ~3 cm and ~0.02 rad.
    Returns robot-frame points and normals, the mask and the estimates."""
    rng = np.random.default_rng(seed)
    half = N // 2
    s = np.linspace(0.2, 3.0, half)
    wall = np.concatenate([np.stack([s, np.zeros(half)], -1),
                           np.stack([np.zeros(half), s], -1)])
    nrm = np.concatenate([np.tile([[0.0, 1.0]], (half, 1)),
                          np.tile([[1.0, 0.0]], (half, 1))])
    true = np.stack([np.linspace(1.0, 2.0, P), np.linspace(1.0, 1.6, P),
                     np.linspace(-0.3, 0.3, P)], -1)
    pts = np.zeros((P, N, 2), np.float32)
    nr = np.zeros((P, N, 2), np.float32)
    for i, (x, y, th) in enumerate(true):
        c, s_ = np.cos(-th), np.sin(-th)
        R = np.array([[c, -s_], [s_, c]])
        jitter = rng.normal(0, 0.002, (N, 2))
        w = wall + np.stack([rng.uniform(-0.02, 0.02, N) * nrm[:, 1],
                             rng.uniform(-0.02, 0.02, N) * nrm[:, 0]], -1)
        pts[i] = (w + jitter - [x, y]) @ R.T
        nr[i] = nrm @ R.T
    est = true.copy()
    est[1:] += rng.normal(0, [0.03, 0.03, 0.02], (P - 1, 3))
    return pts, nr, np.ones((P, N), bool), est.astype(np.float32)


@pytest.fixture(scope="module")
def room():
    """The corner room in both packages, with the reference's factor table
    (global matcher) and its copy in the port."""
    pts, nr, mask, est = _corner_room()
    fj, _ = JR.match_factors_global(jnp.asarray(pts), jnp.asarray(nr),
                                    jnp.asarray(mask), jnp.asarray(est),
                                    capacity=1024)
    assert int(fj.valid.sum()) > 300
    tj = JTable.empty(8)
    return dict(j=(jnp.asarray(pts), jnp.asarray(nr), jnp.asarray(mask),
                   jnp.asarray(est), tj),
                t=(t(pts), t(nr), t(mask), t(est), table_to_torch(tj)),
                fj=fj, ft=factors_to_torch(fj))


@pytest.fixture(scope="module")
def small_problem(small_map):
    """small_map's state in both packages, and the reference's factor table
    (global matcher) with its copy in the port."""
    m = small_map
    stj = j_make_map_state(m.poses, m.covariances, m.point_clouds,
                           m.normal_clouds, constraint_capacity=64)
    stt = TState.from_numpy(np_fields(stj), "cpu")
    stf, matches = JR.match_factors_global(stj.points, stj.normals,
                                           stj.point_mask, stj.poses,
                                           capacity=8192)
    assert int(stf.valid.sum()) > 300
    return stj, stt, stf, factors_to_torch(stf), matches


def _assert_solve_parity(got, ref, poses0, iterations=True):
    """Final cost rtol 1e-4, poses atol 1e-4, the counts equal, pose 0
    unmoved; the LM iteration counts equal where `iterations`."""
    if iterations:
        assert int(got.iterations) == int(ref.iterations)
    assert 0 < int(got.iterations) <= 20
    assert int(got.num_matches) == int(ref.num_matches) > 0
    assert int(got.pairs_dropped) == int(ref.pairs_dropped) == 0
    np.testing.assert_allclose(float(got.initial_cost),
                               float(ref.initial_cost), rtol=1e-4)
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(n(got.poses), np.asarray(ref.poses), atol=1e-4)
    np.testing.assert_allclose(n(got.poses[0]), n(poses0[0]), atol=1e-6)
    assert float(got.final_cost) < float(got.initial_cost)
    for name in ("match_dropped", "vote_dropped", "elect_dropped"):
        a, b = getattr(got, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert int(a) == int(b), name


@pytest.mark.parametrize("fused_eval", [False, True])
@pytest.mark.parametrize("include_chain", [True, False])
def test_stf_lm_solve_parity(room, fused_eval, include_chain):
    """The dense solve fed the reference's factor table: iterations equal."""
    kw = dict(include_chain=include_chain, fused_eval=fused_eval)
    ref = JS.stf_lm_solve(room["j"][3], room["j"][4], room["fj"],
                          config=JLMConfig(**RESOLVED), **kw)
    got = TS.stf_lm_solve(room["t"][3], room["t"][4], room["ft"],
                          config=TLMConfig(**RESOLVED), **kw)
    _assert_solve_parity(got, ref, room["t"][3])
    if not include_chain:      # the STF factors alone: the cost falls 30x
        assert float(got.final_cost) < 0.1 * float(got.initial_cost)


@pytest.mark.parametrize("precondition", ["tridiag", "jacobi"])
@pytest.mark.parametrize("include_chain", [True, False])
def test_stf_pcg_lm_solve_parity(room, precondition, include_chain):
    """The matrix-free solve fed the reference's factor table: iterations
    equal."""
    kw = dict(include_chain=include_chain, precondition=precondition)
    ref = JS.stf_pcg_lm_solve(room["j"][3], room["j"][4], room["fj"],
                              config=JLMConfig(**RESOLVED), **kw)
    got = TS.stf_pcg_lm_solve(room["t"][3], room["t"][4], room["ft"],
                              config=TLMConfig(**RESOLVED), **kw)
    _assert_solve_parity(got, ref, room["t"][3])
    assert got.cg_iterations >= int(got.iterations)


@pytest.mark.parametrize("solver", ["dense", "dense_fused", "pcg"])
def test_solves_on_small_map(small_problem, solver):
    """The three solvers on small_map's reference factor table at the
    default tolerances: cost and poses (the iteration counts are decided by
    round-off there, see above)."""
    stj, stt, fj, ft, _ = small_problem
    cfgj, cfgt = JLMConfig(max_iterations=12), TLMConfig(max_iterations=12)
    if solver == "pcg":
        ref = JS.stf_pcg_lm_solve(stj.poses, stj.constraints, fj, config=cfgj)
        got = TS.stf_pcg_lm_solve(stt.poses, stt.constraints, ft, config=cfgt)
    else:
        fused = solver == "dense_fused"
        ref = JS.stf_lm_solve(stj.poses, stj.constraints, fj, config=cfgj,
                              fused_eval=fused)
        got = TS.stf_lm_solve(stt.poses, stt.constraints, ft, config=cfgt,
                              fused_eval=fused)
    _assert_solve_parity(got, ref, stt.poses, iterations=False)


def test_dense_solve_without_onehots(small_problem, monkeypatch):
    """Over the one-hot budget assemble_dense takes its scatter branch: the
    same refinement as with the selectors."""
    _, stt, _, ft, _ = small_problem
    cfg = TLMConfig(max_iterations=12)
    want = TS.stf_lm_solve(stt.poses, stt.constraints, ft, config=cfg)
    monkeypatch.setattr(TS, "STF_ONEHOT_BUDGET", 0)
    got = TS.stf_lm_solve(stt.poses, stt.constraints, ft, config=cfg)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(n(got.poses), n(want.poses), atol=1e-4)


def test_dense_solve_matches_f64_cpu_refine():
    """The port's dense solve against hitl_slam_tpu/baselines/cpu_refine.py
    (f64 dense LM) on the two-scan wall, at the tolerances of
    tests/test_stf.py::test_cpu_refine_baseline_matches_tpu_path."""
    from hitl_slam_tpu.baselines.cpu_refine import (cpu_refine_solve,
                                                    stf_to_numpy)

    wall, nrm, mask = _wall(offset=0.0)
    poses = np.array([[0, 0, 0], [0.0, 0.05, 0.0]], np.float32)
    stf, matches = JR.match_factors_global(
        jnp.asarray(wall), jnp.asarray(nrm), jnp.asarray(mask),
        jnp.asarray(poses), capacity=512)
    table = JTable.empty(8)
    got = TS.stf_lm_solve(t(poses), table_to_torch(table),
                          factors_to_torch(stf),
                          config=TLMConfig(max_iterations=20))
    tab = np_fields(table)
    np_table = dict(ctype=tab["ctype"], constrained=tab["constrained"],
                    anchor=tab["anchor"], dpar=tab["delta_parallel"],
                    dperp=tab["delta_perpendicular"], dth=tab["delta_angle"],
                    pen=tab["penalty_dir"], active=tab["active"])
    cpu_poses, cpu_cost, cpu_iters = cpu_refine_solve(
        poses, np_table, stf_to_numpy(stf), max_iterations=20)
    assert cpu_iters > 0
    np.testing.assert_allclose(float(got.final_cost), cpu_cost, rtol=2e-3,
                               atol=1e-7)
    np.testing.assert_allclose(n(got.poses), cpu_poses, atol=2e-4)


# --------------------------------------------------------- refine end to end

@pytest.mark.parametrize("solver", ["dense", "dense_fused", "pcg", "auto"])
@pytest.mark.parametrize("matcher", ["global", "pair"])
def test_post_human_refine_parity(room, solver, matcher):
    """post_human_refine end to end (the port's own matcher and solver) on
    the corner room: match counts, drop counters and iterations equal."""
    kw = dict(capacity=1024, solver=solver, matcher=matcher, max_pairs=64)
    ref = JR.post_human_refine(*room["j"], config=JLMConfig(**RESOLVED), **kw)
    got = TR.post_human_refine(*room["t"], config=TLMConfig(**RESOLVED), **kw)
    _assert_solve_parity(got, ref, room["t"][3])


@pytest.mark.parametrize("solver", ["dense", "dense_fused", "pcg", "auto"])
@pytest.mark.parametrize("matcher", ["global", "pair"])
def test_post_human_refine_small_map(small_problem, solver, matcher):
    """post_human_refine end to end on small_map at the default tolerances:
    match counts and drop counters equal, cost and poses to tolerance (the
    iteration counts are decided by round-off there, see above)."""
    stj, stt, *_ = small_problem
    kw = dict(capacity=8192, solver=solver, matcher=matcher, max_pairs=1024)
    ref = JR.post_human_refine(stj.points, stj.normals, stj.point_mask,
                               stj.poses, stj.constraints,
                               config=JLMConfig(max_iterations=12), **kw)
    got = TR.post_human_refine(stt.points, stt.normals, stt.point_mask,
                               stt.poses, stt.constraints,
                               config=TLMConfig(max_iterations=12), **kw)
    _assert_solve_parity(got, ref, stt.poses, iterations=False)


def test_match_factors_global_parity(small_problem):
    """The global matcher's half of the refine on small_map: the match set
    and the factor table as the reference's. The coordinates reach ~12 m
    here, where the recentring on the cell rounds at ~5e-7: the squared
    distance is held to 5e-7 and not the distance to 1e-6."""
    stj, stt, fj, _, mj = small_problem
    ft, mt = TR.match_factors_global(stt.points, stt.normals, stt.point_mask,
                                     stt.poses, capacity=8192)
    np.testing.assert_array_equal(n(mt.target), np.asarray(mj.target))
    np.testing.assert_array_equal(n(mt.valid), np.asarray(mj.valid))
    assert int(mt.dropped) == int(mj.dropped) == 0
    np.testing.assert_allclose(n(mt.dist) ** 2, np.asarray(mj.dist) ** 2,
                               atol=5e-7)
    assert_fields_match(ft, fj, atol=1e-6)


def test_grid_match_near_ties_resolve_within_round_off():
    """On a drifted 96-pose map one point has two candidates whose squared
    distances differ by 6e-9, below the round-off of the expanded distance
    at these coordinates (~1e-7), and the two packages choose differently.
    Every target that differs must be such a near-tie (in f64), and `valid`
    is equal."""
    from hitl_slam_tpu.io.figure8 import generate_figure8

    m = generate_figure8(num_poses=96, num_rays=90, seed=3,
                         drift_theta_bias=4e-4)
    stj = j_make_map_state(m.poses, m.covariances, m.point_clouds,
                           m.normal_clouds, constraint_capacity=64)
    stt = TState.from_numpy(np_fields(stj), "cpu")
    _, mj = JR.match_factors_global(stj.points, stj.normals, stj.point_mask,
                                    stj.poses, capacity=8192)
    _, mt = TR.match_factors_global(stt.points, stt.normals, stt.point_mask,
                                    stt.poses, capacity=8192)
    np.testing.assert_array_equal(n(mt.valid), np.asarray(mj.valid))
    assert int(mt.dropped) == int(mj.dropped)
    a, b = n(mt.target), np.asarray(mj.target)
    w = n(stt.world_points()).reshape(-1, 2).astype(np.float64)
    differ = np.flatnonzero(a != b)
    assert len(differ) <= 3
    for i in differ:
        da = np.sum((w[i] - w[a[i]]) ** 2)
        db = np.sum((w[i] - w[b[i]]) ** 2)
        assert abs(da - db) < 3e-7, (i, da, db)


def test_pcg_refine_matches_dense(small_problem):
    """tests/test_stf.py::test_pcg_refine_matches_dense in the port."""
    _, stt, *_ = small_problem
    cfg = TLMConfig(max_iterations=12)
    args = (stt.points, stt.normals, stt.point_mask, stt.poses,
            stt.constraints)
    dense = TR.post_human_refine(*args, capacity=8192, config=cfg,
                                 solver="dense")
    pcg = TR.post_human_refine(*args, capacity=8192, config=cfg,
                               solver="pcg")
    assert int(dense.num_matches) == int(pcg.num_matches) > 0
    np.testing.assert_allclose(n(pcg.poses), n(dense.poses), atol=2e-3)
    assert float(pcg.final_cost) <= float(dense.final_cost) * 1.05 + 1e-6


def test_refine_rejects_unknown_names(small_problem):
    _, stt, *_ = small_problem
    args = (stt.points, stt.normals, stt.point_mask, stt.poses,
            stt.constraints)
    with pytest.raises(ValueError):
        TR.post_human_refine(*args, matcher="tree")
    with pytest.raises(ValueError):
        TR.post_human_refine(*args, capacity=8192, solver="lu")
    assert TR.DENSE_POSE_LIMIT == JR.DENSE_POSE_LIMIT
    assert TS.STF_ONEHOT_BUDGET == JS.STF_ONEHOT_BUDGET
    for name in ("POINT_MATCH_THRESHOLD", "MAX_STF_ANGLE_ERROR",
                 "LASER_STD_DEV", "POINT_CORRELATION_FACTOR",
                 "MIN_PAIR_MATCHES"):
        assert float(getattr(TC, name)) == float(getattr(JC, name)), name


def test_refine_results_repeat_bit_equal(small_problem):
    """Two runs from the same state give the same bits (fixed summation
    orders, no atomics)."""
    _, stt, *_ = small_problem
    args = (stt.points, stt.normals, stt.point_mask, stt.poses,
            stt.constraints)
    cfg = TLMConfig(max_iterations=6)
    a = TR.post_human_refine(*args, capacity=8192, config=cfg)
    b = TR.post_human_refine(*args, capacity=8192, config=cfg)
    assert torch.equal(a.poses, b.poses)
    assert dataclasses.is_dataclass(a)
