"""The post-human STF refine in carry form: the PCG solve and the three STF
LM routes against copies of the loops they replaced (bit-equal on the CPU)
and against the JAX package, the host traffic of an eager refine (every
read one of device_while's tests, no data made on the host), post_optimize's
reads outside the loops (one, two when the pair matcher runs again), and,
on a card only (marker `cuda`), replays of the refine's programs against
eager runs on the card.

The card's inputs are made by the port's own generator, and JAX is
imported only by the tests that call it, so the card's tests run where JAX
is not installed: python -m pytest -p no:cacheprovider --noconftest -m cuda
tests/test_torch_refine_program.py (chip_smoke.py phase 21 runs the same
comparisons at full size)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_helpers import n, t

torch.set_num_threads(2)

# tests/test_torch_refine.py's PCG tolerance (relative to max |x|)
PCG_RTOL = 1e-5
# a figure-8 map small enough for the CPU (P * N of a few thousand)
SMALL_MAP = dict(num_poses=48, num_rays=60, seed=3, drift_theta_bias=4e-4)


# ------------------------------------------------------------ today's loops

def _pcg_loop(D, U, b, extra_matvec, max_iterations, tolerance,
              preconditioner):
    """cg.pcg_solve as its loop was before the carry form."""
    from hitl_slam_torch.solver.cg import tridiag_matvec
    from hitl_slam_torch.solver.tridiag import _mv, bcr_apply, bcr_factor, inv3

    def A(v):
        out = tridiag_matvec(D, U, v)
        return out if extra_matvec is None else out + extra_matvec(v)

    if preconditioner == "tridiag":
        fac = bcr_factor(D, U)

        def prec(r):
            return bcr_apply(fac, r)
    else:
        Minv = inv3(D)

        def prec(r):
            return _mv(Minv, r)

    x = torch.zeros_like(b)
    r = b - A(x)
    z = prec(r)
    p = z
    rz = torch.sum(r * z)
    b_norm = torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
    it = 0
    while it < max_iterations and bool(
            torch.linalg.vector_norm(r) / b_norm > tolerance):
        Ap = A(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, torch.linalg.vector_norm(r) / b_norm, it


def _stf_loop(poses0, table, stf, config, route):
    """The three STF LM routes ("dense", "dense_fused", "pcg") as their
    loops were before the carry form (one host read of the loop flags an
    iteration): (poses, final cost, initial cost, iterations, CG
    iterations)."""
    from hitl_slam_torch.solver import stf_solve as S
    from hitl_slam_torch.solver.assembly_soa import (normal_equations_soa,
                                                     soa_constants)
    from hitl_slam_torch.solver.joint import build_problem, cost

    P = poses0.shape[0]
    problem = build_problem(poses0, table)
    sc = soa_constants(problem)
    stf, run_last, run_start = S.sort_factors_by_pair(stf, P)
    cidx, cbi, cbj, _ = S.compact_pair_rows(stf, run_last, P, max_pairs=16384)

    def cost_only(x):
        r = S.C.stf_residuals(stf, x)
        return cost(problem, x) + 0.5 * torch.sum(r * r)

    if route == "pcg":
        red = S._pcg_reductions(stf, run_start, (cidx, cbi, cbj), P)

        def assemble(x):
            D, U, g, _ = normal_equations_soa(problem, sc, x)
            Dh, gh, _, B = S._stf_system_compact(stf, x, red)
            return D + Dh, U, g + gh, B
    else:
        onehots = S.stf_onehots(stf, P, poses0.dtype)

        def assemble(x):
            return S.assemble_dense(problem, stf, x, True, onehots,
                                    (run_last, run_start), (cidx, cbi, cbj),
                                    chain_soa=sc)

    if route == "dense_fused":
        system = assemble(poses0)
        c = c0 = system[2]
    else:
        c = c0 = cost_only(poses0)
        system = assemble(poses0)
    x = poses0
    mu = torch.tensor(config.initial_mu)
    nu = torch.tensor(2.0)
    it = cg_total = 0
    done = False
    while it < config.max_iterations and not done:
        if route == "pcg":
            D_aug, U, g, B = system
            diag = torch.clamp(torch.diagonal(D_aug, dim1=-2, dim2=-1),
                               config.min_diagonal, config.max_diagonal)
            step, _, cg_it = _pcg_loop(
                D_aug + mu * torch.diag_embed(diag), U, -g,
                S._pair_block_matvec(B, red, P), 64, 1e-2, "tridiag")
            cg_total += cg_it
            x_new = x + step
        else:
            H, g = system[:2]
            diag = torch.clamp(torch.diagonal(H), config.min_diagonal,
                               config.max_diagonal)
            L, info = torch.linalg.cholesky_ex(H + mu * torch.diag(diag))
            y = torch.linalg.solve_triangular(L, -g[:, None], upper=False)
            step = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
            step = torch.where(info > 0, torch.full_like(step, float("nan")),
                               step)
            x_new = x + step.reshape(-1, 3)
        if route == "dense_fused":
            trial = assemble(x_new)
            c_new = trial[2]
        else:
            c_new = cost_only(x_new)
        accept, mu, nu, done_new = S._mnt_updates(
            config, c, c_new, step, diag, g, mu, nu, x)
        x = torch.where(accept, x_new, x)
        c = torch.where(accept, c_new, c)
        it += 1
        accepted, done = torch.stack([accept, done_new]).tolist()
        if route == "dense_fused":
            if accepted:
                system = trial
        elif accepted and not done:
            system = assemble(x)
    return x, c, c0, it, cg_total


# ------------------------------------------------------------ the inputs

def _pcg_inputs(seed):
    """tests/test_torch_refine.py's PCG problem with its pair coupling, in
    numpy and as the port's extra_matvec."""
    from test_torch_refine import _pcg_problem

    D, U, b, bi, bj, J = _pcg_problem(np.random.default_rng(seed))
    Jt, bit, bjt = t(J), t(bi, torch.int64), t(bj, torch.int64)

    def extra(v):
        u = (torch.einsum("kab,kb->ka", Jt[:, 0], v[bit])
             + torch.einsum("kab,kb->ka", Jt[:, 1], v[bjt]))
        out = torch.zeros_like(v).index_add_(
            0, bit, torch.einsum("kab,ka->kb", Jt[:, 0], u))
        return out.index_add_(0, bjt, torch.einsum("kab,ka->kb", Jt[:, 1],
                                                   u))

    return (D, U, b, bi, bj, J), extra


@pytest.fixture(scope="module")
def room():
    """tests/test_torch_refine.py's corner room in both packages, with the
    reference's factor table (global matcher) and its copy in the port."""
    import jax.numpy as jnp

    from hitl_slam_tpu.core.state import ConstraintTable as JTable
    from hitl_slam_tpu.models.hitl import refine as JR
    from test_torch_refine import _corner_room
    from torch_port_helpers import factors_to_torch, table_to_torch

    pts, nr, mask, est = _corner_room()
    fj, _ = JR.match_factors_global(jnp.asarray(pts), jnp.asarray(nr),
                                    jnp.asarray(mask), jnp.asarray(est),
                                    capacity=1024)
    tj = JTable.empty(8)
    return dict(j=(jnp.asarray(pts), jnp.asarray(nr), jnp.asarray(mask),
                   jnp.asarray(est), tj),
                t=(t(pts), t(nr), t(mask), t(est), table_to_torch(tj)),
                fj=fj, ft=factors_to_torch(fj))


def _small_state(device):
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.io.figure8 import generate_figure8

    m = generate_figure8(**SMALL_MAP)
    return make_map_state(m.poses, m.covariances, m.point_clouds,
                          m.normal_clouds, constraint_capacity=16,
                          device=device)


# ------------------------------------------------------------ the CPU

@pytest.mark.parametrize("preconditioner", ["jacobi", "tridiag"])
def test_pcg_carry_form_bit_equal_and_matches_jax(preconditioner):
    """The carry-form pcg_solve against today's loop (kept above):
    solution, residual and iterations bit-equal on the CPU, the iteration
    count a 0-dim int32 tensor; against the JAX pcg_solve x within
    tests/test_torch_refine.py's tolerance and the iteration counts
    equal, at the default tolerance and at the refine's 1e-2."""
    import jax.numpy as jnp

    from hitl_slam_tpu.solver import cg as JCG
    from hitl_slam_torch.solver import cg as TCG

    (D, U, b, bi, bj, J), extra = _pcg_inputs(1234)

    def j_extra(v):
        u = (jnp.einsum("kab,kb->ka", J[:, 0], v[bi])
             + jnp.einsum("kab,kb->ka", J[:, 1], v[bj]))
        out = jnp.zeros_like(v).at[bi].add(
            jnp.einsum("kab,ka->kb", J[:, 0], u))
        return out.at[bj].add(jnp.einsum("kab,ka->kb", J[:, 1], u))

    for tol in (1e-6, 1e-2):
        xt, rt, itt = TCG.pcg_solve(t(D), t(U), t(b), extra_matvec=extra,
                                    tolerance=tol,
                                    preconditioner=preconditioner)
        xo, ro, ito = _pcg_loop(t(D), t(U), t(b), extra, 256, tol,
                                preconditioner)
        assert itt.dtype == torch.int32 and itt.dim() == 0
        assert torch.equal(xt, xo) and torch.equal(rt, ro) and int(itt) == ito
        xj, _, itj = JCG.pcg_solve(jnp.asarray(D), jnp.asarray(U),
                                   jnp.asarray(b), extra_matvec=j_extra,
                                   tolerance=tol,
                                   preconditioner=preconditioner)
        scale = float(np.abs(np.asarray(xj)).max())
        np.testing.assert_allclose(n(xt), np.asarray(xj),
                                   atol=PCG_RTOL * scale)
        assert int(itt) == int(itj) > 0


@pytest.mark.parametrize("route", ["dense", "dense_fused", "pcg"])
def test_stf_routes_carry_form_bit_equal_and_match_jax(room, route):
    """Each STF LM route in carry form against today's loop (kept above):
    poses, costs and the LM and CG iteration counts bit-equal on the CPU;
    against the JAX solve on the corner room, tests/test_torch_refine.py's
    standard (poses to 1e-4, costs to 1e-4 relative, LM iterations
    equal)."""
    from hitl_slam_tpu.solver import stf_solve as JS
    from hitl_slam_tpu.solver.lm import LMConfig as JLMConfig
    from test_torch_refine import RESOLVED, _assert_solve_parity

    from hitl_slam_torch.solver import stf_solve as TS
    from hitl_slam_torch.solver.lm import LMConfig

    poses, table = room["t"][3], room["t"][4]
    cfg = LMConfig(**RESOLVED)
    if route == "pcg":
        got = TS.stf_pcg_lm_solve(poses, table, room["ft"], config=cfg)
        ref = JS.stf_pcg_lm_solve(room["j"][3], room["j"][4], room["fj"],
                                  config=JLMConfig(**RESOLVED))
        assert got.cg_iterations.dtype == torch.int32
    else:
        fused = route == "dense_fused"
        got = TS.stf_lm_solve(poses, table, room["ft"], config=cfg,
                              fused_eval=fused)
        ref = JS.stf_lm_solve(room["j"][3], room["j"][4], room["fj"],
                              config=JLMConfig(**RESOLVED), fused_eval=fused)
        assert got.cg_iterations is None
    x, c, c0, it, cg = _stf_loop(poses, table, room["ft"], cfg, route)
    assert torch.equal(got.poses, x) and torch.equal(got.final_cost, c)
    assert torch.equal(got.initial_cost, c0)
    assert got.iterations.dtype == torch.int32 and int(got.iterations) == it
    if route == "pcg":
        assert int(got.cg_iterations) == cg >= it
    _assert_solve_parity(got, ref, poses)


@pytest.mark.parametrize("matcher", ["global", "pair"])
def test_post_human_refine_carry_form_matches_jax(room, matcher):
    """post_human_refine (solver auto: dense_fused here) in carry form on
    the corner room against the JAX refine: match counts, drop counters
    and LM iterations equal, poses and costs to 1e-4; and `eager=True`
    changes nothing on the CPU, where every call runs eagerly."""
    from hitl_slam_tpu.models.hitl import refine as JR
    from hitl_slam_tpu.solver.lm import LMConfig as JLMConfig
    from test_torch_refine import RESOLVED, _assert_solve_parity

    from hitl_slam_torch.models.hitl import refine as TR
    from hitl_slam_torch.solver.lm import LMConfig

    kw = dict(capacity=1024, matcher=matcher, max_pairs=64)
    ref = JR.post_human_refine(*room["j"], config=JLMConfig(**RESOLVED), **kw)
    got = TR.post_human_refine(*room["t"], config=LMConfig(**RESOLVED), **kw)
    _assert_solve_parity(got, ref, room["t"][3])
    again = TR.post_human_refine(*room["t"], config=LMConfig(**RESOLVED),
                                 **kw, eager=True)
    assert torch.equal(again.poses, got.poses)


class _Traffic:
    """Host reads (each with whether device_while made it) and data made
    on the host that reaches a device operation, under
    tests/test_torch_enml_program.py's dispatch mode."""

    def __enter__(self):
        from test_torch_enml_program import _HostTraffic

        self.mode = _HostTraffic()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        self.reads = self.mode.reads.reads
        self.copies = self.mode.copies


@pytest.mark.parametrize("solver", ["dense", "dense_fused", "pcg"])
@pytest.mark.parametrize("matcher", ["global", "pair"])
def test_refine_host_traffic_is_loop_tests(solver, matcher):
    """An eager refine of the small map: every host read is one of
    device_while's tests and no data is made on the host. With one LM
    trip (max_iterations=1) the reads are exactly its tests: the LM loop's
    first test, the reassembly's (two-pass and PCG), and each CG trip's
    (the PCG route, its iterations and the failing test unless the cap
    was reached)."""
    from hitl_slam_torch.models.hitl import refine as R
    from hitl_slam_torch.solver.lm import LMConfig

    st = _small_state("cpu")
    args = (st.points, st.normals, st.point_mask, st.poses, st.constraints)
    kw = dict(capacity=4096, solver=solver, matcher=matcher, max_pairs=256)
    R.post_human_refine(*args, config=LMConfig(max_iterations=1), **kw)
    for iters in (1, 12):
        with _Traffic() as tr:
            out = R.post_human_refine(
                *args, config=LMConfig(max_iterations=iters), **kw)
        assert tr.copies == [], tr.copies
        assert all(inside for _, inside in tr.reads), tr.reads
        assert int(out.num_matches) > 0
        it = int(out.iterations)
        if iters == 1:
            want = 1 + (solver != "dense_fused")
            if solver == "pcg":
                cg = int(out.cg_iterations)
                want += cg + (cg < 64)
            assert it == 1 and len(tr.reads) == want, (len(tr.reads), want)
        elif solver == "dense_fused":
            assert len(tr.reads) == it + (it < iters)


def test_post_optimize_reads_once_and_twice_with_fallback(monkeypatch):
    """post_optimize's reads beyond its loops' tests: the report's scalars,
    the match count that decides the fallback among them, in one read
    (engine._read_scalars; on the CPU the tensors are already on the
    host), and a second one when the global matcher finds nothing and the
    pair matcher runs again (here it finds nothing either: the scans are
    100 m apart). Every other host read is one of device_while's tests."""
    from test_torch_device_program import _HostReads

    from hitl_slam_torch.models.hitl import engine as E

    calls = []
    read = E._read_scalars

    def counting(*ts):
        calls.append(len(ts))
        return read(*ts)

    monkeypatch.setattr(E, "_read_scalars", counting)
    for far, want in ((False, 1), (True, 2)):
        calls.clear()
        eng = E.HitLSLAM(device="cpu")
        eng.init(*_small_map_np(far), constraint_capacity=16)
        with _HostReads() as mode:
            rep = eng.post_optimize(max_iterations=4)
        assert all(inside for _, inside in mode.reads), mode.reads
        assert len(calls) == want, calls
        assert rep.accepted and ("pair matcher" in rep.reason) == far
        assert eng.undo()


def _small_map_np(far: bool):
    """SMALL_MAP's poses, covariances, points and normals; with `far`,
    each scan's points pushed 100 m apart from the others', so that no
    two scans match."""
    from hitl_slam_torch.io.figure8 import generate_figure8

    m = generate_figure8(**SMALL_MAP)
    poses = np.array(m.poses)
    if far:
        poses[:, 0] += 100.0 * np.arange(len(poses))
    return poses, m.covariances, m.point_clouds, m.normal_clouds


# ------------------------------------------------------------ on the card

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the programs are CUDA graphs")
    return torch.device("cuda")


class _CardReads(TorchDispatchMode):
    """Counts reads back to the host: scalar reads, nonzero and copies to
    the host (a replay itself runs outside the dispatcher)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        aten = torch.ops.aten
        if func in (aten._local_scalar_dense.default, aten.item.default,
                    aten.nonzero.default) or (
                func is aten._to_copy.default
                and args[0].device.type != "cpu"
                and str(kwargs.get("device", args[0].device)) == "cpu") or (
                func is aten.copy_.default and args[0].device.type == "cpu"
                and args[1].device.type != "cpu"):
            self.reads += 1
        return func(*args, **kwargs)


def _fields(out):
    return (out.poses, out.initial_cost, out.final_cost)


def _ints(out):
    return [None if v is None else int(v) for v in (
        out.iterations, out.cg_iterations, out.num_matches,
        out.pairs_dropped, out.match_dropped, out.vote_dropped,
        out.elect_dropped)]


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "dense_fused", "pcg"])
@pytest.mark.parametrize("matcher", ["global", "pair"])
def test_refine_program_matches_eager(cuda_device, solver, matcher):
    """A replay of the refine's program on the card, and of its two
    halves: bit-equal to `eager=True` there (integers equal), launching no
    kernel, and one host read a refine."""
    from hitl_slam_torch.models.hitl import refine as R
    from hitl_slam_torch.solver.lm import LMConfig

    st = _small_state(cuda_device)
    args = (st.points, st.normals, st.point_mask, st.poses, st.constraints)
    kw = dict(capacity=4096, solver=solver, matcher=matcher, max_pairs=256,
              config=LMConfig(max_iterations=12))
    want = R.post_human_refine(*args, **kw, eager=True)
    got = R.post_human_refine(*args, **kw)
    assert _ints(got) == _ints(want)
    assert all(torch.equal(a, b) for a, b in zip(_fields(got),
                                                 _fields(want)))
    with _CardReads() as mode:
        R.post_human_refine(*args, **kw).poses.cpu()
    assert mode.reads == 1
    half = (matcher, 4096, 256, 64, None)
    stf = R.match_factors(*args[:4], *half)
    stf_e = R.match_factors(*args[:4], *half, eager=True)
    for a, b in zip(vars(stf[0]).values(), vars(stf_e[0]).values()):
        assert torch.equal(a, b)
    solve = (kw["config"], True, solver, 256)
    got = R.solve_factors(st.poses, st.constraints, stf[0], *solve)
    want = R.solve_factors(st.poses, st.constraints, stf[0], *solve,
                           eager=True)
    assert all(torch.equal(a, b) for a, b in zip(_fields(got),
                                                 _fields(want)))

