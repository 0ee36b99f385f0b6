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
def test_em_scan_kernel_matches_plain(cuda_device, golden_large):
    """Exact counts and bit-equal minima on the 1024-pose map, for both
    logged selections, a POINT selection at 0.05 m, a P that is not a
    multiple of the 8-pose tile, and fully masked rows."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.ops import em_scan as E

    data, entries = golden_large
    st = make_map_state(data.poses, data.covariances, data.point_clouds,
                        data.normal_clouds, cuda_device)
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
                        data.normal_clouds, cuda_device)
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
                        data.normal_clouds, "cpu")
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
                        data.normal_clouds, "cpu", constraint_capacity=64)
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
