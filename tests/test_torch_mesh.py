"""Port parity of the device mesh (parallel/mesh.py), the pose-sharded LM
solve (parallel/sharded_solver.py) and the replicas placed on a mesh
(parallel/replicas.py::shard_replicas), against the JAX package on its 8
virtual CPU devices (tests/conftest.py) and against the port's own
unsharded solves, on tests/test_parallel.py's inputs made from a numpy
seed. The JAX side runs once, in the module-scoped `jax_runs` fixture.

Meshes of the port on the CPU: `[cpu] * d` is one device group (every
partition stacked in one batch), `cpu:0 ... cpu:{d-1}` are d groups of one
(the cross-group path, data moved by `.to()` between them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_parallel import _chain_poses, _table
from torch_port_helpers import n, t, table_to_torch

torch.set_num_threads(2)

NUM, ITERS = 64, 60
MESHES = {"1x8": (1, 8), "2x4": (2, 4)}


def _stacked(d):
    return [torch.device("cpu")] * d


def _cross(d):
    return [torch.device("cpu", i) for i in range(d)]


def _mesh(shape, devices):
    from hitl_slam_torch.parallel.mesh import make_mesh

    return make_mesh(*shape, devices=devices(shape[0] * shape[1]))


@pytest.fixture(scope="module")
def chain():
    """A 64-pose chain with 3 LINE_SEGMENT rows (tests/test_parallel.py's
    generators, seed 7), the JAX problem and the port's."""
    from hitl_slam_torch.solver import joint as TJ
    from hitl_slam_tpu.solver import joint as JJ

    rng = np.random.default_rng(7)
    poses = _chain_poses(rng, NUM)
    table = _table(jnp.asarray(poses), rng)
    return (poses, JJ.build_problem(jnp.asarray(poses), table),
            TJ.build_problem(t(poses), table_to_torch(table)))


@pytest.fixture(scope="module")
def jax_runs(chain):
    """The JAX package's sharded_lm_solve on both meshes (8 virtual CPU
    devices), compiled once for the module."""
    import jax

    from hitl_slam_tpu.parallel.mesh import make_mesh
    from hitl_slam_tpu.parallel.sharded_solver import sharded_lm_solve
    from hitl_slam_tpu.solver.lm import LMConfig

    poses, jprob, _ = chain
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    out = {}
    for name, shape in MESHES.items():
        r = sharded_lm_solve(make_mesh(*shape), jprob, jnp.asarray(poses),
                             LMConfig(max_iterations=ITERS))
        out[name] = jax.tree_util.tree_map(np.asarray, r)
    return out


def _sharded(chain, shape, devices, iters=ITERS):
    from hitl_slam_torch.parallel.sharded_solver import sharded_lm_solve
    from hitl_slam_torch.solver.lm import LMConfig

    poses, _, tprob = chain
    return sharded_lm_solve(_mesh(shape, devices), tprob, t(poses),
                            LMConfig(max_iterations=iters))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_lm_matches_jax(chain, jax_runs, mesh):
    """Iteration counts equal, final cost within 1e-4 relative, poses
    within 1e-4 of the JAX sharded solve on the same mesh shape."""
    got = _sharded(chain, MESHES[mesh], _stacked)
    want = jax_runs[mesh]
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(got.initial_cost),
                               float(want.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost),
                               rtol=1e-4)
    np.testing.assert_allclose(n(got.poses), want.poses, atol=1e-4)
    assert float(got.final_mu) == float(want.final_mu)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_lm_matches_lone_solve(chain, mesh):
    """The reference's own criteria (tests/test_parallel.py) against the
    port's unsharded lm.solve: cost at most 1.05x + 1e-4, poses within
    2e-2."""
    from hitl_slam_torch.solver.lm import LMConfig, solve_jit

    poses, _, tprob = chain
    ref = solve_jit(tprob, t(poses), LMConfig(max_iterations=ITERS))
    got = _sharded(chain, MESHES[mesh], _stacked)
    assert float(got.final_cost) <= float(ref.final_cost) * 1.05 + 1e-4
    np.testing.assert_allclose(n(got.poses), n(ref.poses), atol=2e-2)


@pytest.mark.parametrize("devices", [
    _cross,
    # runs of adjacent entries of one device: groups of 3, 2, 1 and 2
    lambda d: [torch.device("cpu", i) for i in (0, 0, 0, 1, 1, 2, 3, 3)],
], ids=["cross", "runs"])
def test_sharded_lm_groupings_bit_equal(chain, devices):
    """One group of 8 stacked partitions and other groupings of the same 8
    partitions give the same floats: every partition's row runs its own
    vector loop on the CPU, every collective moves data only, and each
    group sums the gathered [d] vector in partition order."""
    a = _sharded(chain, (1, 8), _stacked)
    b = _sharded(chain, (1, 8), devices)
    assert int(a.iterations) == int(b.iterations)
    assert torch.equal(a.poses, b.poses)
    assert torch.equal(a.final_cost, b.final_cost)


def test_sharded_lm_collective_volume():
    """The SPIKE partition gathers O(partitions) floats an LM iteration, never
    the O(P) system: at n = 256 on 8 partitions, at most 64 gathered floats
    a partition an iteration and at most 16 a shift, by the mesh's counter
    (tests/test_parallel.py's bounds, counted there over the jaxpr)."""
    from hitl_slam_torch.parallel import mesh as M
    from hitl_slam_torch.solver import joint as TJ
    from hitl_slam_torch.solver.lm import LMConfig, solve

    rng = np.random.default_rng(11)
    poses = _chain_poses(rng, 256)
    tprob = TJ.build_problem(t(poses), table_to_torch(
        _table(jnp.asarray(poses), rng)))
    M.collectives.reset()
    got = _sharded((poses, None, tprob), (1, 8), _cross, iters=10)
    it = int(got.iterations)
    c = M.collectives
    assert it >= 1
    # per iteration: 4 shifts (halo, two carries, interface block), one
    # gather, 4 sums; the initial assembly adds 3 shifts and a sum
    assert c.calls == {"shift": 4 * it + 3, "gather": it, "sum": 4 * it + 1}
    assert (c.floats["gather"] + c.floats["sum"]) / it <= 64
    assert c.largest["gather"] == 42 and c.largest["shift"] <= 16
    ref = solve(tprob, t(poses), LMConfig(max_iterations=10))
    assert float(got.final_cost) <= float(ref.final_cost) * 1.05 + 1e-4


def test_make_sharded_solver(chain):
    """make_sharded_solver builds the problem at the poses and runs the
    sharded solve: the same floats as building it by hand."""
    from hitl_slam_torch.parallel.sharded_solver import make_sharded_solver
    from hitl_slam_torch.solver.lm import LMConfig

    rng = np.random.default_rng(7)
    poses = _chain_poses(rng, NUM)
    table = table_to_torch(_table(jnp.asarray(poses), rng))
    run = make_sharded_solver(_mesh((1, 8), _stacked),
                              LMConfig(max_iterations=ITERS))
    got = run(t(poses), table)
    want = _sharded(chain, (1, 8), _stacked)
    assert torch.equal(got.poses, want.poses)


def test_sharded_lm_refuses_uneven_partitions(chain):
    from hitl_slam_torch.parallel.sharded_solver import sharded_lm_solve

    poses, _, tprob = chain
    with pytest.raises(ValueError, match="divide"):
        sharded_lm_solve(_mesh((1, 3), _stacked), tprob, t(poses))


@pytest.mark.parametrize("shape, devices", [
    ((4, 1), _stacked), ((4, 1), _cross), ((2, 4), _cross)],
    ids=["stacked", "cross", "2x4"])
def test_shard_replicas_bit_equal(shape, devices):
    """8 replicas placed on the mesh's replica axis (contiguous chunks a
    device group), then batched_solve: bit-equal to the unsharded batch."""
    from hitl_slam_torch.parallel import mesh as M
    from hitl_slam_torch.parallel.replicas import (batched_solve,
                                                   make_perturbed_replicas,
                                                   shard_replicas)
    from hitl_slam_torch.solver.lm import LMConfig

    rng = np.random.default_rng(23)
    poses = _chain_poses(rng, 40)
    tt = table_to_torch(_table(jnp.asarray(poses), rng))
    reps, tb = make_perturbed_replicas(poses, tt, num_replicas=8)
    config = LMConfig(max_iterations=40)
    want = batched_solve(reps, tb, config, device="cpu")
    pr, pt = shard_replicas(_mesh(shape, devices), reps, tb)
    assert isinstance(pr, M.Placed)
    assert [g.hi - g.lo for g in pr.groups] == (
        [shape[0]] if devices is _stacked else [1] * shape[0])
    assert sum(s.shape[0] for s in pr.shares) == 8
    got = batched_solve(pr, pt, config, device="cpu")
    for name in ("poses", "final_cost", "initial_cost", "iterations",
                 "converged", "final_mu"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_mesh_placements_and_errors():
    """make_mesh's grid and axes, the three placements, grouping by runs of
    one device, uneven placement and too few devices refused."""
    from hitl_slam_torch.parallel import mesh as M

    mesh = M.make_mesh(2, 4, _cross(8))
    assert mesh.axis_names == ("replica", "pose")
    assert mesh.shape == {"replica": 2, "pose": 4}
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis("pose") == _cross(4)
    assert mesh.axis("replica") == [torch.device("cpu", 0),
                                    torch.device("cpu", 4)]
    assert M.replica_sharding(mesh).spec == ("replica",)
    assert M.pose_sharding(mesh).spec == ("pose",)
    assert M.batched_pose_sharding(mesh).spec == ("replica", "pose")
    groups = M.groups_of([torch.device("cpu", i) for i in (0, 0, 1, 0)])
    assert [(g.lo, g.hi) for g in groups] == [(0, 2), (2, 3), (3, 4)]
    assert all(g.device == torch.device("cpu") for g in groups)
    with pytest.raises(ValueError, match="divide"):
        M.device_put(torch.zeros(5, 3), M.pose_sharding(mesh))
    with pytest.raises(RuntimeError, match=r"torch.device\('cuda', 0\)"):
        M.make_mesh(1, 9, _cross(8))
    with pytest.raises(RuntimeError, match="need 4 devices"):
        M.make_mesh(2, 2, devices=[])


@pytest.mark.parametrize("devices", [_stacked, _cross, lambda d: [
    torch.device("cpu", i) for i in (0, 0, 1, 1, 1, 2)]],
    ids=["stacked", "cross", "runs"])
def test_collectives(devices):
    """shift, all_gather and psum over any grouping: the cyclic shift is a
    roll of the partition stack, the gather the stack, the sum its sum."""
    from hitl_slam_torch.parallel import mesh as M

    d = 6
    x = torch.arange(d * 4, dtype=torch.float32).reshape(d, 2, 2)
    groups = M.groups_of(devices(d))
    xs = M.split(x, groups)
    M.collectives.reset()
    for off in (1, -1):
        got = torch.cat(M.shift(xs, groups, off))
        assert torch.equal(got, torch.roll(x, off, 0))
    for full in M.all_gather(xs, groups):
        assert torch.equal(full, x)
    for s in M.psum([v.flatten(1).sum(1) for v in xs], groups):
        assert float(s) == float(x.sum())
    assert M.collectives.calls == {"shift": 2, "gather": 1, "sum": 1}
    assert M.collectives.largest == {"shift": 4, "gather": 4, "sum": 1}


@pytest.mark.parametrize("route", ["brute", "grid"])
def test_checkerboard_mesh_device_groups(route):
    """checkerboard_localize's mesh branch with each of 4 replica entries
    its own device group (cpu:0 ... cpu:3), both matcher routes, on
    tests/test_parallel.py's mesh input: within 1e-4 of mesh=None (on the
    CPU the floats come out equal). The grid route, slow on the CPU, runs
    on the first 20 nodes (4 windows a parity, one a share)."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.io.figure8 import generate_raw_stream
    from hitl_slam_torch.models.enml.driver import (EpisodeOptions,
                                                     build_episodes)
    from hitl_slam_torch.models.enml.localizer import EnmlOptions
    from hitl_slam_torch.models.enml.parallel_localizer import (
        checkerboard_localize)
    from hitl_slam_torch.parallel.mesh import make_mesh

    scans, angles, rel, _, _ = generate_raw_stream(num_steps=64, num_rays=90,
                                                   seed=2)
    poses, pcs, ncs, _ = build_episodes(
        scans, angles, rel, EpisodeOptions(clip_low=10, clip_high=10))
    st = make_map_state(poses, np.zeros((len(poses), 3, 3), np.float32),
                        pcs, ncs, device="cpu")
    args = (st.points, st.normals, st.point_mask, st.poses)
    if route == "grid":
        args = tuple(a[:20] for a in args)
    o = EnmlOptions(max_history=6, gn_iterations=6, match_rounds=1)
    kw = dict(n_passes=1, force_grid=route == "grid")
    p4, c4 = checkerboard_localize(*args, o, mesh=_mesh((4, 1), _cross),
                                   **kw)
    p1, c1 = checkerboard_localize(*args, o, **kw)
    np.testing.assert_allclose(n(p4), n(p1), atol=1e-4)
    np.testing.assert_allclose(n(c4), n(c1), atol=1e-4)


# ------------------------------------------------------------ carry form

def _old_sharded_loop(mesh, problem, poses0, config):
    """sharded_lm_solve as its LM loop was before the carry form: a Python
    loop that reads `done` after each iteration, the state rebound to new
    tensors (the helpers are the module's)."""
    from hitl_slam_torch.ops import residuals as res
    from hitl_slam_torch.parallel import mesh as M
    from hitl_slam_torch.parallel import sharded_solver as S
    from hitl_slam_torch.solver.lm import LMResult

    groups = M.groups_of(mesh.axis("pose"))
    d = groups[-1].hi
    Pl = poses0.shape[0] // d
    dtype = poses0.dtype
    dev0 = groups[0].device

    def parts(t_):
        return M.split(t_.reshape(d, Pl, *t_.shape[1:]), groups)

    odom = S._pad_factors(problem.odom)
    odom = [res.OdometryFactors(*f) for f in zip(
        parts(odom.axis), parts(odom.radial), parts(odom.rotation),
        parts(odom.inv_sigma))]
    ch = problem.compact
    compact = list(zip(parts(ch.q0), parts(ch.A), parts(ch.c)))
    k = [ch.k.to(grp.device) for grp in groups]

    def assemble(x):
        return S._local_assemble(x, odom, compact, k, groups, d)

    def scalars(v):
        return [torch.tensor(v, dtype=dtype, device=grp.device)
                for grp in groups]

    x = parts(poses0)
    D, U, g, c = assemble(x)
    c0 = c[0]
    mu, nu = scalars(config.initial_mu), scalars(2.0)
    done = [torch.zeros((), dtype=torch.bool, device=grp.device)
            for grp in groups]
    it = 0
    while it < config.max_iterations:
        Dd, Ug, gg, diag = [], [], [], []
        for Di, Ui, gi, mi, grp in zip(D, U, g, mu, groups):
            if grp.lo == 0:
                Di, Ui, gi = Di.clone(), Ui.clone(), gi.clone()
                Di[0, 0] = torch.eye(3, dtype=dtype, device=grp.device)
                Ui[0, 0] = 0.0
                gi[0, 0] = 0.0
            dg = torch.clamp(torch.diagonal(Di, dim1=-2, dim2=-1),
                             config.min_diagonal, config.max_diagonal)
            Dd.append(Di + mi * torch.diag_embed(dg))
            Ug.append(Ui)
            gg.append(gi)
            diag.append(dg)
        step = S._spike_solve(Dd, Ug, gg, groups, d)
        x_new = [xi + si for xi, si in zip(x, step)]
        Dn, Un, gn, c_new = assemble(x_new)
        pred = M.psum([(si * (mi * dg * si - gi)).flatten(1).sum(1)
                       for si, mi, dg, gi in zip(step, mu, diag, gg)],
                      groups)
        for i in range(len(groups)):
            rho = (c[i] - c_new[i]) / torch.clamp(0.5 * pred[i], min=1e-30)
            acc = (rho > 0) & torch.isfinite(c_new[i])
            x[i] = torch.where(acc, x_new[i], x[i])
            D[i] = torch.where(acc, Dn[i], D[i])
            U[i] = torch.where(acc, Un[i], U[i])
            g[i] = torch.where(acc, gn[i], g[i])
            t_ = 2.0 * rho - 1.0
            factor = torch.clamp(1.0 - t_ * (t_ * t_), min=1.0 / 3.0)
            mu[i] = torch.clamp(torch.where(acc, mu[i] * factor,
                                            mu[i] * nu[i]), 1e-32, 1e32)
            nu[i] = torch.where(acc, 2.0, nu[i] * 2.0)
            fdone = acc & (torch.abs(c[i] - c_new[i])
                           <= config.function_tolerance * c[i])
            c[i] = torch.where(acc, c_new[i], c[i])
            done[i] = done[i] | fdone | (mu[i] >= config.mu_collapse)
        xnorm = M.psum([(xi * xi).flatten(1).sum(1) for xi in x], groups)
        snorm = M.psum([(si * si).flatten(1).sum(1) for si in step], groups)
        for i in range(len(groups)):
            done[i] = done[i] | (
                torch.sqrt(snorm[i]) <= config.parameter_tolerance
                * (torch.sqrt(xnorm[i]) + config.parameter_tolerance))
        it += 1
        if bool(done[0]):
            break
    return LMResult(
        poses=torch.cat([xi.reshape(-1, 3).to(dev0) for xi in x]),
        final_cost=c[0], initial_cost=c0,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev0),
        converged=done[0],
        final_mu=torch.tensor(config.initial_mu, dtype=dtype, device=dev0))


@pytest.mark.parametrize("devices", [_stacked, _cross],
                         ids=["stacked", "cross"])
@pytest.mark.parametrize("iters", [ITERS, 3])
def test_sharded_carry_form_bit_equal_to_old_loop(chain, devices, iters):
    """The carry form (device_while over buffers written with copy_) and
    the Python loop it replaced, kept above: bit-equal on one group of 8
    stacked partitions and on 8 groups of one, run to convergence and cut
    by the iteration cap."""
    from hitl_slam_torch.solver.lm import LMConfig

    poses, _, tprob = chain
    mesh = _mesh((1, 8), devices)
    config = LMConfig(max_iterations=iters)
    got = _sharded(chain, (1, 8), devices, iters=iters)
    want = _old_sharded_loop(mesh, tprob, t(poses), config)
    for name in ("poses", "final_cost", "initial_cost", "iterations",
                 "converged", "final_mu"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.iterations.dtype == torch.int32
    assert int(got.iterations) == (iters if iters == 3 else
                                   int(want.iterations))


def test_sharded_trip_brings_no_host_tensor(chain):
    """One trip of the sharded LM's carry form, run as device_while's body
    outside the loop, on one group and on 8: no read back to the host and
    no data made on the host reaching the carry (what a CUDA graph could
    not hold); the detector sees the old loop's host-made scalars."""
    from test_torch_enml_program import _HostTraffic

    from hitl_slam_torch.parallel import sharded_solver as S
    from hitl_slam_torch.solver.lm import LMConfig

    poses, _, tprob = chain
    for devices in (_stacked, _cross):
        bodies = []

        def one_trip(cond, body, max_trips):
            bodies.append(body)
            return 0

        orig = S.device_while
        S.device_while = one_trip
        try:
            S.sharded_lm_solve(_mesh((1, 8), devices), tprob, t(poses),
                               LMConfig(max_iterations=5))
        finally:
            S.device_while = orig
        assert len(bodies) == 1
        with _HostTraffic() as mode:
            bodies[0]()
        assert mode.reads.reads == [] and mode.copies == [], devices
    with _HostTraffic() as mode:
        _old_sharded_loop(_mesh((1, 8), _stacked), tprob, t(poses),
                          LMConfig(max_iterations=1))
    assert mode.copies
