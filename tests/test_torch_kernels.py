"""The port's CUDA kernels against their plain torch versions, and the
refine's plain-torch path on the card against the same path on the CPU.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
This file imports neither jax nor the JAX package, so it also runs on a
machine with the port alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def golden_large():
    from hitl_slam_torch.io import logs, stfs

    data = stfs.load_stfs_covars(os.path.join(DATA,
                                              "golden_large.stfs.covars.gz"))
    return data, logs.load_log(os.path.join(DATA, "golden_large.log"))


def _spd_system(num, seed, device):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(num, 3, 3))
    D = A @ np.swapaxes(A, -1, -2) + 4.0 * np.eye(3)
    U = rng.normal(size=(max(num - 1, 0), 3, 3)) * 0.3
    b = rng.normal(size=(num, 3))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (D, U, b))


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 2, 127, 128, 129, 1000, 4097, 16384])
def test_bcr_kernel_matches_plain(cuda_device, num):
    from hitl_slam_torch.solver import bcr_kernel, tridiag

    D, U, b = _spd_system(num, num, cuda_device)
    before = bcr_kernel.launches.count
    xk = bcr_kernel.bcr_solve(D, U, b)
    assert bcr_kernel.launches.count == before + 1
    xt = tridiag.bcr_solve(D, U, b)
    torch.cuda.synchronize()
    # same algorithm in f32; the systems have cond(H) < ~20, so FMA
    # contraction and sum order move the result by ~1e-7 of max|x|
    scale = max(1.0, float(xt.abs().max()))
    assert float((xk - xt).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1024, 1025, 2048, 2049, 8193, 16384, 16385,
                                 32768])
def test_bcr_kernel_route_boundaries(cuda_device, num):
    """Each side of each route boundary (one block up to 1024 lanes, then
    clusters of 2, 4, 16 blocks, then top levels in device memory ahead of a
    cluster of 16), against the plain version and an f64 banded solve."""
    from torch_port_helpers import banded_solve_f64

    from hitl_slam_torch.solver import bcr_kernel, tridiag

    D, U, b = _spd_system(num, num, cuda_device)
    before = bcr_kernel.launches.count
    xk = bcr_kernel.bcr_solve_cuda(D, U, b)
    assert bcr_kernel.launches.count == before + 1
    xt = tridiag.bcr_solve(D, U, b)
    torch.cuda.synchronize()
    x64 = banded_solve_f64(*(a.double().cpu().numpy() for a in (D, U, b)))
    scale = max(1.0, float(np.abs(x64).max()))
    assert float((xk - xt).abs().max()) <= 1e-4 * scale
    assert float(np.abs(xk.double().cpu().numpy() - x64).max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("num,batch", [(1, 3), (64, 32), (1024, 32),
                                       (2049, 4), (16384, 4), (32768, 2)])
def test_bcr_batched_route_equals_lone_launches(cuda_device, num, batch):
    """The batched route on every route (one block, clusters, top levels in
    device memory): each system's x bit-equal to a lone launch on it, one
    batched launch counted, and within the bound of the batched twin."""
    from hitl_slam_torch.solver import bcr_kernel, tridiag

    systems = [_spd_system(num, 100 * num + i, cuda_device)
               for i in range(batch)]
    D, U, b = (torch.stack([s[k] for s in systems]) for k in range(3))
    before = bcr_kernel.batched_launches.count
    xb = bcr_kernel.bcr_solve(D, U, b)
    assert bcr_kernel.batched_launches.count == before + 1
    lone = torch.stack([bcr_kernel.bcr_solve_cuda(*s) for s in systems])
    xt = tridiag.bcr_solve(D, U, b)
    torch.cuda.synchronize()
    assert torch.equal(xb, lone)
    scale = max(1.0, float(xt.abs().max()))
    assert float((xb - xt).abs().max()) <= 1e-4 * scale


def _multi_system(S, num, R, seed, device):
    """S systems of `num` poses and R right-hand sides each, U handed as
    the view [:, :-1] of an [S, num, 3, 3] array (the SPIKE's layout)."""
    systems = [_spd_system(num + 1, seed + s, device) for s in range(S)]
    D = torch.stack([s[0][:num] for s in systems])
    U = torch.stack([s[1] for s in systems])[:, :-1]
    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.normal(size=(S, num, 3, R)), dtype=torch.float32,
                        device=device)
    return D, U, b


@pytest.mark.cuda
@pytest.mark.parametrize("num,S,R", [(1, 2, 7), (2, 1, 2), (128, 8, 7),
                                     (256, 4, 7), (1024, 3, 1), (2048, 8, 7),
                                     (8193, 2, 8), (16384, 2, 7)])
def test_bcr_multi_route_equals_lone_launches(cuda_device, num, S, R):
    """The multi route on each of its routes (one block, clusters, top
    levels in device memory), U a strided view: one launch counted, each
    column of x bit-equal to a lone launch on it, and within the bound of
    the plain twin."""
    from hitl_slam_torch.solver import bcr_kernel

    D, U, b = _multi_system(S, num, R, 7 * num + R, cuda_device)
    assert not U.is_contiguous() or S == 1 or num == 1
    before = bcr_kernel.multi_launches.count
    x = bcr_kernel.bcr_solve_multi(D, U, b)
    assert bcr_kernel.multi_launches.count == before + 1
    lone = torch.stack([torch.stack([
        bcr_kernel.bcr_solve_cuda(D[s], U[s].contiguous(),
                                  b[s, :, :, c].contiguous())
        for c in range(R)], -1) for s in range(S)])
    twin = bcr_kernel.bcr_solve_multi_reference(D, U, b)
    torch.cuda.synchronize()
    assert x.shape == (S, num, 3, R) and x.is_contiguous()
    assert torch.equal(x, lone)
    scale = max(1.0, float(twin.abs().max()))
    assert float((x - twin).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_bcr_multi_rejects_layouts_it_does_not_take(cuda_device):
    from hitl_slam_torch.solver import bcr_kernel

    D, U, b = _multi_system(2, 16, 7, 0, cuda_device)
    with pytest.raises(ValueError):     # not contiguous within a system
        bcr_kernel.bcr_solve_cuda_multi(D, U, b.transpose(1, 2).contiguous()
                                        .transpose(1, 2))
    with pytest.raises(ValueError):     # R = 9
        bcr_kernel.bcr_solve_cuda_multi(D, U, torch.cat([b, b[..., :2]], -1))
    with pytest.raises(ValueError):
        bcr_kernel.bcr_solve_cuda_multi(D.double(), U, b)
    with pytest.raises(ValueError):
        bcr_kernel.bcr_solve_cuda_multi(D.cpu(), U.cpu(), b.cpu())


@pytest.mark.cuda
def test_em_scan_kernel_matches_plain(cuda_device, golden_large):
    """Exact counts and bit-equal minima on the 1024-pose map, for both
    logged selections, a POINT selection at 0.05 m, a P that is not a
    multiple of the 8-pose tile, and fully masked rows."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.ops import em_scan as E

    data, entries = golden_large
    st = make_map_state(data.poses, data.covariances, data.point_clouds,
                        data.normal_clouds, device=cuda_device)
    world = st.world_points().contiguous()
    mask = st.point_mask
    holes = mask.clone()
    holes[::7] = False
    P = world.shape[0]
    p, q = world[10, 0], world[700, 0]
    cases = [(world, mask, torch.as_tensor(e.points, device=cuda_device), 0.03)
             for e in entries]
    cases += [
        (world, mask, torch.stack([p, p, q, q]), 0.05),
        (world[:P - 3].contiguous(), mask[:P - 3].contiguous(),
         cases[0][2], 0.03),
        (world, holes, cases[1][2], 0.03),
    ]
    for w, m, s, thr in cases:
        ck, mk = E.em_scan(w, m, s.contiguous(), thr)
        cr, mr = E.em_scan_reference(w, m, s, thr)
        torch.cuda.synchronize()
        assert torch.equal(ck, cr)
        assert torch.equal(mk.view(torch.int32), mr.view(torch.int32))


@pytest.mark.cuda
def test_em_scan_back_to_back_calls_leave_no_state(cuda_device, golden_large):
    """Two calls with no synchronise between them, other selections and
    other P: the second call's minima and counts owe nothing to the first
    (the last block of each call folds the minima and resets the ticket
    counter for the next call)."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.ops import em_scan as E

    data, entries = golden_large
    st = make_map_state(data.poses, data.covariances, data.point_clouds,
                        data.normal_clouds, device=cuda_device)
    world = st.world_points().contiguous()
    mask = st.point_mask
    s0, s1 = (torch.as_tensor(e.points, device=cuda_device) for e in entries)
    w1, m1 = world[:517].contiguous(), mask[:517].contiguous()
    runs = [(world, mask, s0), (w1, m1, s1), (world, mask, s1), (w1, m1, s0)]
    before = E.launches.count
    outs = [E.em_scan_cuda(w, m, s) for w, m, s in runs]
    assert E.launches.count == before + len(runs)
    for (w, m, s), (ck, mk) in zip(runs, outs):
        cr, mr = E.em_scan_reference(w, m, s)
        torch.cuda.synchronize()
        assert torch.equal(ck, cr)
        assert torch.equal(mk.view(torch.int32), mr.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("P,N", [(1021, 127), (9, 3), (7, 1), (33, 130)])
def test_em_scan_ragged_shapes(cuda_device, P, N):
    """P not a multiple of a block's poses, N odd or past one chunk a lane."""
    from hitl_slam_torch.ops import em_scan as E

    rng = np.random.default_rng(P * 1000 + N)
    world = torch.as_tensor(rng.normal(0, 1, (P, N, 2)), dtype=torch.float32,
                            device=cuda_device)
    mask = torch.as_tensor(rng.random((P, N)) < 0.8, device=cuda_device)
    sel = torch.as_tensor(rng.normal(0, 1, (4, 2)), dtype=torch.float32,
                          device=cuda_device)
    ck, mk = E.em_scan_cuda(world, mask, sel, 0.3)
    cr, mr = E.em_scan_reference(world, mask, sel, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(ck, cr)
    assert torch.equal(mk.view(torch.int32), mr.view(torch.int32))


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda_device):
    from hitl_slam_torch.ops import em_scan as E
    from hitl_slam_torch.solver import bcr_kernel

    w = torch.zeros((16, 128, 2), device=cuda_device)
    m = torch.ones((16, 128), dtype=torch.bool, device=cuda_device)
    s = torch.zeros((4, 2), device=cuda_device)
    with pytest.raises(ValueError):
        E.em_scan_cuda(w.double(), m, s)
    with pytest.raises(ValueError):
        E.em_scan_cuda(w, m[:, :64].contiguous(), s)
    with pytest.raises(ValueError):
        E.em_scan_cuda(w, m.cpu(), s)
    with pytest.raises(ValueError):   # not 16-byte aligned
        E.em_scan_cuda(w.view(-1)[2:].view(-1)[:16 * 127 * 2].view(16, 127, 2),
                       m[:, :127].contiguous(), s)
    D, U, b = _spd_system(8, 0, cuda_device)
    with pytest.raises(ValueError):
        bcr_kernel.bcr_solve_cuda(D, U[:-1], b)
    with pytest.raises(ValueError):
        bcr_kernel.bcr_solve_cuda(D.transpose(-1, -2), U, b)


# ------------------------------------------------- the refine, card vs CPU

@pytest.mark.cuda
def test_grid_match_card_equals_cpu(cuda_device, golden_large):
    """The matcher at the full width of the 1024-pose map, fed the same
    world points on both devices: its arithmetic is IEEE adds, multiplies
    and compares in a fixed order, and its sorts are stable, so targets,
    valid mask, drop count and the factor table are equal bit for bit, and
    the distances to one ulp."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.ops import correspond as C
    from hitl_slam_torch.ops.geometry import rotate

    data, _ = golden_large
    st = make_map_state(data.poses, data.covariances, data.point_clouds,
                        data.normal_clouds, device="cpu")
    world = st.world_points()
    wnrm = rotate(st.poses[:, 2][:, None], st.normals)
    cpu = C.grid_match(world, wnrm, st.point_mask)
    card = C.grid_match(world.to(cuda_device), wnrm.to(cuda_device),
                        st.point_mask.to(cuda_device))
    assert int(cpu.valid.sum()) > 1000
    assert torch.equal(card.valid.cpu(), cpu.valid)
    assert torch.equal(card.target.cpu(), cpu.target)
    assert int(card.dropped) == int(cpu.dropped)
    # torch's square root differs by one ulp between the devices
    assert float((card.dist.cpu() - cpu.dist).abs().max()) <= 2e-8
    stf_cpu = C.build_stf_factors(st.points, st.normals, cpu)
    stf_card = C.build_stf_factors(st.points.to(cuda_device),
                                   st.normals.to(cuda_device), card)
    for name in ("pose0", "pose1", "p0", "p1", "n0", "n1", "weight", "valid"):
        assert torch.equal(getattr(stf_card, name).cpu(),
                           getattr(stf_cpu, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["dense", "dense_fused", "pcg"])
def test_refine_solvers_card_close_to_cpu(cuda_device, solver):
    """Each refine solver on the small golden map, from one factor table:
    the card's result within f32 round-off of the CPU's (cost rtol 1e-3,
    poses 1e-4), and two runs on the card bit-equal."""
    import dataclasses

    from hitl_slam_torch.core.state import ConstraintTable, make_map_state
    from hitl_slam_torch.io import stfs
    from hitl_slam_torch.models.hitl import refine as R
    from hitl_slam_torch.solver.lm import LMConfig

    data = stfs.load_stfs_covars(os.path.join(DATA, "golden.stfs.covars"))
    st = make_map_state(data.poses, data.covariances, data.point_clouds,
                        data.normal_clouds, constraint_capacity=64,
                        device="cpu")
    stf, *_ = R.match_factors(st.points, st.normals, st.point_mask, st.poses,
                              "pair", 65536, 1024, 64, None)
    assert int(stf.valid.sum()) > 1000

    def to(obj, dev):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(dev)
            for f in dataclasses.fields(obj)})

    cfg = LMConfig(max_iterations=8)
    cpu = R.solve_factors(st.poses, st.constraints, stf, cfg, True, solver,
                          1024)
    args = (st.poses.to(cuda_device), to(st.constraints, cuda_device),
            to(stf, cuda_device), cfg, True, solver, 1024)
    assert isinstance(args[1], ConstraintTable)
    card = R.solve_factors(*args)
    again = R.solve_factors(*args)
    assert torch.equal(card.poses, again.poses)
    assert float(card.final_cost) < float(card.initial_cost)
    np.testing.assert_allclose(float(card.final_cost), float(cpu.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(card.poses.cpu().numpy(), cpu.poses.numpy(),
                               atol=1e-4)


# ------------------------- proposals, rendering and LTVM, card vs CPU

@pytest.fixture(scope="module")
def drifted_state():
    """A drifted two-lap 256-pose figure-8 map as a CPU MapState."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.io.figure8 import generate_figure8

    m = generate_figure8(num_poses=256, num_rays=120, seed=7,
                         drift_theta_bias=6e-4, num_laps=2)
    return make_map_state(m.poses, m.covariances, m.point_clouds,
                          m.normal_clouds, device="cpu")


def _candidates(st, device):
    """Fields, scans and guesses of 4 loop candidates of the map (anchor
    neighbourhoods of 11 poses), on `device`."""
    ii = torch.tensor([20, 40, 67, 100])
    jj = torch.tensor([150, 170, 195, 230])
    win = (ii[:, None] + torch.arange(-5, 6)[None])
    world = st.world_points()
    a_pts = world[win].reshape(4, -1, 2)
    a_mask = st.point_mask[win].reshape(4, -1)
    out = (a_pts, a_mask, st.poses[ii, :2].contiguous(), st.points[jj],
           st.point_mask[jj], st.poses[jj])
    return tuple(x.to(device) for x in out)


@pytest.mark.cuda
def test_correlative_match_card_equals_cpu(cuda_device, drifted_state):
    """Four candidates at the default parameters (0.05 m cells, 29 angles):
    the likelihood fields agree to 1e-6, the winning pose is the same cell
    and angle (1e-6), score and ambiguity agree to 1e-5, and the
    gathered correlation agrees with the reference's dense conv2d on the
    card."""
    from torch_port_helpers import dense_correlation

    from hitl_slam_torch.ops import scan_match as S

    res = {}
    for dev in ("cpu", cuda_device):
        a_pts, a_mask, centers, scans, smask, guess = _candidates(
            drifted_state, dev)
        field = S.build_likelihood_field(a_pts, a_mask, centers)
        res[str(dev)] = (field, *S.correlative_match(field, centers, scans,
                                                     smask, guess))
    cpu, card = res["cpu"], res[str(cuda_device)]
    assert float((card[0].cpu() - cpu[0]).abs().max()) <= 1e-6
    assert float((card[1].cpu() - cpu[1]).abs().max()) <= 1e-6
    assert float((card[2].cpu() - cpu[2]).abs().max()) <= 1e-5
    assert float((card[3].cpu() - cpu[3]).abs().max()) <= 1e-5
    assert float(cpu[2].min()) > 0.3

    field = card[0]
    g = torch.Generator().manual_seed(0)
    ki = torch.randint(0, 520, (4, 29, 128), generator=g, dtype=torch.int32)
    kj = torch.randint(0, 520, (4, 29, 128), generator=g, dtype=torch.int32)
    ok = torch.rand((4, 29, 128), generator=g) > 0.1
    ki, kj, ok = (x.to(cuda_device) for x in (ki, kj, ok))
    a = S.correlate_gather(field, ki, kj, ok, 41)
    b = dense_correlation(field, ki, kj, ok, 41)
    assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_extract_segments_card_equals_cpu(cuda_device, drifted_state):
    """Fixed uniforms, the same points: inlier counts and valid equal on
    both devices, endpoints within 1e-5 m, batched (4 neighbourhoods) and
    on the whole map at once (32 rounds of 256 hypotheses)."""
    from hitl_slam_torch.ops import ransac as R

    rp = R.RansacParams(num_segments=8, min_inliers=10, min_length=0.8)
    out = {}
    for dev in ("cpu", cuda_device):
        a_pts, a_mask, *_ = _candidates(drifted_state, dev)
        batched = R.extract_segments(a_pts, a_mask,
                                     R.uniform_draws(1, rp, dev, batch=4), rp)
        st = drifted_state
        whole = R.extract_segments(
            st.world_points().reshape(-1, 2).to(dev),
            st.point_mask.reshape(-1).to(dev),
            R.uniform_draws(2, R.RansacParams(), dev))
        out[str(dev)] = (batched, whole)
    for cpu, card in zip(out["cpu"], out[str(cuda_device)]):
        assert int(cpu.valid.sum()) >= 2
        assert torch.equal(card.count.cpu(), cpu.count)
        assert torch.equal(card.valid.cpu(), cpu.valid)
        for name in ("p1", "p2", "centroid"):
            d = (getattr(card, name).cpu() - getattr(cpu, name)).abs().max()
            assert float(d) <= 1e-5, (name, float(d))


@pytest.mark.cuda
def test_render_map_card_equals_cpu(cuda_device, drifted_state):
    """The same world points rendered on both devices: equal images (the
    pixel arithmetic is one subtraction, one multiplication and a cast),
    and two renders on the card bit-equal."""
    from hitl_slam_torch.ops import raster as T

    st = drifted_state
    world = st.world_points()
    cpu = T.render_map(world, st.point_mask, st.poses)
    card = T.render_map(world.to(cuda_device), st.point_mask.to(cuda_device),
                        st.poses.to(cuda_device))
    again = T.render_map(world.to(cuda_device), st.point_mask.to(cuda_device),
                         st.poses.to(cuda_device))
    assert card.shape == (1024, 1024, 3) and card.dtype == torch.uint8
    assert torch.equal(card, again)
    assert int((card.cpu() != cpu).any(-1).sum()) <= 4
    assert int((cpu > 0).sum()) > 10000
    tab = st.constraints
    a = T.info_matrix_image(st.poses[:, 0], tab.anchor, tab.constrained,
                            tab.active)
    b = T.info_matrix_image(st.poses[:, 0].to(cuda_device),
                            tab.anchor.to(cuda_device),
                            tab.constrained.to(cuda_device),
                            tab.active.to(cuda_device))
    assert torch.equal(a, b.cpu())


@pytest.mark.cuda
def test_build_sdf_card_close_to_cpu(cuda_device, drifted_state):
    """The SDF of the first 64 poses at 0.1 m: values within 1e-5 and
    weights within 1e-4 of the CPU's but for at most 0.05 % of the pixels
    (a bearing within an ulp of a bin edge reads the neighbouring beam);
    two builds on the card bit-equal; the filter keeps the same points from
    the same image."""
    from hitl_slam_torch.ops import sdf as S

    st = drifted_state
    params = S.SdfParams(image_resolution=0.1)
    args = (st.poses[:64], st.points[:64], st.point_mask[:64],
            torch.tensor([-22.0, -3.0]))
    cpu = S.build_sdf(*args, 160, 440, params)
    cargs = tuple(x.to(cuda_device) for x in args)
    card = S.build_sdf(*cargs, 160, 440, params)
    again = S.build_sdf(*cargs, 160, 440, params)
    assert torch.equal(card.values, again.values)
    assert torch.equal(card.weights, again.weights)
    dv = (card.values.cpu() - cpu.values).abs()
    dw = (card.weights.cpu() - cpu.weights).abs()
    allowed = 5e-4 * dv.numel()
    assert int((dv > 1e-5).sum()) <= allowed, int((dv > 1e-5).sum())
    assert int((dw > 1e-4).sum()) <= allowed, int((dw > 1e-4).sum())
    world = st.world_points()[:64]
    same = S.SdfImage(values=cpu.values.to(cuda_device),
                      weights=cpu.weights.to(cuda_device),
                      origin=cargs[3], resolution=cpu.resolution.to(cuda_device))
    keep_cpu = S.filter_points(cpu, world, st.point_mask[:64], params)
    keep_card = S.filter_points(same, world.to(cuda_device), cargs[2], params)
    assert torch.equal(keep_card.cpu(), keep_cpu)
    assert 0 < int(keep_cpu.sum()) < int(st.point_mask[:64].sum())
