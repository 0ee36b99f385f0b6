"""The port's CUDA kernels against their plain torch versions, on the card.

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
    D, U, b = _spd_system(8, 0, cuda_device)
    with pytest.raises(ValueError):
        bcr_kernel.bcr_solve_cuda(D, U[:-1], b)
    with pytest.raises(ValueError):
        bcr_kernel.bcr_solve_cuda(D.transpose(-1, -2), U, b)
