"""EnML's sweep as a device loop: the device-index sweep step against a
copy of the Python-int step it replaced (bit-equal on the CPU, at every
node), the sweep and a segment tiling against the JAX package, and the
host traffic of one trip (none: no read back, no constant made on the
host). On a card only (marker `cuda`): replays of the sweep, segment and
window programs against the eager functions.

The inputs are made by the port's own generator and episode builder, and
JAX is imported only by the tests that call it, so the card's tests run
where JAX is not installed: python -m pytest -p no:cacheprovider
--noconftest -m cuda tests/test_torch_enml_program.py (chip_smoke.py runs
the same comparisons at full size)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_helpers import n, t

torch.set_num_threads(2)

aten = torch.ops.aten
# a sub-map of tests/test_torch_enml.py's stream: the first K episode
# nodes, every STRIDE-th padded point (a window is then 640 matcher rows,
# 16x cheaper than the full fixture's)
K, STRIDE = 24, 4
# tests/test_torch_enml.py's whole-sweep tolerances
POSE_ATOL, COV_RTOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def stream():
    from hitl_slam_torch.io.figure8 import generate_raw_stream

    return generate_raw_stream(num_steps=160, num_rays=240, seed=11,
                               noise_trans=4e-3, noise_theta=2e-3)


@pytest.fixture(scope="module")
def sub(stream):
    """(points, normals, mask, poses) of the sub-map as numpy arrays, and
    the stream's walls as a vector map in node 0's odometry frame."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.models.enml.driver import (EpisodeOptions,
                                                     build_episodes)

    scans, angles, rel, gt, walls = stream
    poses, pcs, ncs, _ = build_episodes(
        scans[:80], angles, rel[:80], EpisodeOptions(clip_low=10, clip_high=10))
    st = make_map_state(poses, np.zeros((len(poses), 3, 3), np.float32),
                        pcs, ncs, device="cpu")
    arrays = tuple(np.ascontiguousarray(n(a)[:K, ::STRIDE])
                   for a in (st.points, st.normals, st.point_mask))
    gt0 = gt[0]
    c, s = np.cos(-gt0[2]), np.sin(-gt0[2])
    R = np.array([[c, -s], [s, c]])
    w = np.asarray(walls, np.float64).reshape(-1, 2, 2)
    segs = ((w - gt0[:2]) @ R.T).reshape(-1, 4).astype(np.float32)
    return (*arrays, n(st.poses)[:K]), segs


def _jopts(**kw):
    from hitl_slam_tpu.models.enml.localizer import EnmlOptions

    return EnmlOptions(gn_unroll=2, **kw)


def _pose_diff(a, b):
    dth = np.arctan2(np.sin(a[..., 2] - b[..., 2]),
                     np.cos(a[..., 2] - b[..., 2]))
    return max(float(np.abs(a[..., :2] - b[..., :2]).max()),
               float(np.abs(dth).max()))


def _cov_rel(a, b):
    scale = np.maximum(np.abs(b).max(axis=(-2, -1), keepdims=True), 1e-30)
    return float((np.abs(a - b) / scale).max())


def _old_step(points, normals, point_mask, pre, o, ltf_segs=None):
    """The sweep step as it was before the device-index form: step(poses,
    t) for a Python int t, slicing with Python ints and branching on the
    newest node's window row."""
    from hitl_slam_torch.models.enml.localizer import (_match_gates,
                                                        _window_gn)
    from hitl_slam_torch.ops.geometry import rotate

    axis, d, rot, isig, rel_t, rel_th = pre
    P = points.shape[0]
    W = min(o.max_history, P)
    dtype = points.dtype
    gates = _match_gates(o, points.device)
    ar = torch.arange(W)
    live_rows = ar[None, :] <= ar[:, None]
    live_chain = (ar[None, :-1] < ar[:, None]).to(dtype)
    live3 = live_rows[:, :, None].expand(W, W, 3).reshape(W, 3 * W)
    cov_diag = torch.where(live3, 1e-9, 1.0).to(dtype)

    def step(poses, t: int):
        if t > 0:
            prev = poses[t - 1]
            poses[t, :2] = prev[:2] + rotate(prev[2], rel_t[t - 1])
            poses[t, 2] = prev[2] + rel_th[t - 1]
        a = min(max(t - W + 1, 0), P - W)
        k = t - a
        w_poses = poses[a:a + W]
        w_mask = point_mask[a:a + W]
        if k < W - 1:
            w_mask = w_mask & live_rows[k][:, None]
        new_w_poses, H = _window_gn(
            w_poses, points[a:a + W], normals[a:a + W], w_mask,
            axis[a:a + W - 1], d[a:a + W - 1], rot[a:a + W - 1],
            isig[a:a + W - 1], live_chain[k], o, ltf_segs=ltf_segs,
            gates=gates)
        poses[a:a + W] = new_w_poses
        if k < W - 1:
            m3 = live3[k]
            H = torch.where(m3[:, None] & m3[None, :], H, 0.0)
        H = H + torch.diag(cov_diag[k])
        cov_full = torch.linalg.inv_ex(H)[0]
        blk = cov_full[3 * k:3 * k + 3, 3 * k:3 * k + 3]
        th = poses[t, 2]
        c, s = torch.cos(-th), torch.sin(-th)
        one, zero = torch.ones_like(c), torch.zeros_like(c)
        T = torch.stack([torch.stack([c, -s, zero]),
                         torch.stack([s, c, zero]),
                         torch.stack([zero, zero, one])])
        return T @ blk @ T.T

    return step


# ------------------------------------------------------------ the step

@pytest.mark.parametrize("history,ltf", [(10, False), (6, True)])
def test_device_index_step_bit_equal_to_python_int_step(sub, history, ltf):
    """Both steps from the same running estimates at every node t of the
    sub-map (the first W - 1 with future rows masked, full windows, the
    window clamped at P - W, t = P - 1): poses and the newest covariance
    bit-equal after each; a masked trip (live False) changes nothing."""
    from hitl_slam_torch.models.enml import localizer as L

    (pts, nrm, msk, poses), segs = sub
    o = L.EnmlOptions(max_history=history, gn_iterations=3)
    pts, nrm, msk, poses = t(pts), t(nrm), torch.as_tensor(msk), t(poses)
    ltf_segs = t(segs) if ltf else None
    pre = L.sweep_precompute(poses, o)
    old = _old_step(pts, nrm, msk, pre, o, ltf_segs)
    new = L._make_sweep_step(pts, nrm, msk, pre, o, ltf_segs)
    p_old, p_new = poses.clone(), poses.clone()
    covs = torch.zeros((K, 3, 3))
    for ti in range(K):
        cov = old(p_old, ti)
        new(p_new, covs, torch.tensor(ti))
        assert torch.equal(p_new, p_old), ti
        assert torch.equal(covs[ti], cov), ti
    before = (p_new.clone(), covs.clone())
    new(p_new, covs, torch.tensor(K - 1), torch.tensor(False))
    assert torch.equal(p_new, before[0]) and torch.equal(covs, before[1])


# ------------------------------------------------------------ against JAX

@pytest.fixture(scope="module")
def jax_sweep(sub):
    import jax.numpy as jnp

    from hitl_slam_tpu.models.enml.localizer import batch_localize

    arrays, _ = sub
    p, c = batch_localize(*(jnp.asarray(a) for a in arrays), _jopts())
    return np.asarray(p), np.asarray(c)


def test_batch_localize_matches_jax(sub, jax_sweep):
    """The device-loop sweep against the JAX sweep at tests/
    test_torch_enml.py's tolerances; pose 0's covariance is the gauge."""
    from hitl_slam_torch.models.enml.localizer import batch_localize

    arrays, _ = sub
    p, c = batch_localize(t(arrays[0]), t(arrays[1]),
                          torch.as_tensor(arrays[2]), t(arrays[3]))
    jp, jc = jax_sweep
    assert _pose_diff(n(p), jp) <= POSE_ATOL
    assert _cov_rel(n(c), jc) <= COV_RTOL
    np.testing.assert_array_equal(n(c)[0], np.eye(3, dtype=np.float32) * 1e-6)


@pytest.mark.parametrize("segment", [10, 7])
def test_sweep_segment_tiling_matches_jax(sub, segment):
    """Tiles of `segment` from t0 = 0 until past the end (the last tile
    runs past P - 1, its extra trips masked): the same tiling of the JAX
    sweep_segment, and an extra tile wholly past the end changes no
    covariance."""
    import jax.numpy as jnp

    from hitl_slam_torch.models.enml import localizer as L
    from hitl_slam_tpu.models.enml import localizer as JL

    arrays, _ = sub
    jarr = tuple(jnp.asarray(a) for a in arrays)
    tarr = (t(arrays[0]), t(arrays[1]), torch.as_tensor(arrays[2]),
            t(arrays[3]))
    jpre = JL.sweep_precompute(jarr[3], _jopts())
    tpre = L.sweep_precompute(tarr[3], L.EnmlOptions())
    jps, jcv = jarr[3], jnp.zeros((K, 3, 3), jnp.float32)
    tps, tcv = tarr[3], torch.zeros((K, 3, 3))
    starts = list(range(0, K, segment))
    assert starts[-1] + segment > K
    for t0 in starts:
        jps, jcv = JL.sweep_segment(*jarr[:3], jps, jcv, jpre,
                                    jnp.int32(t0), _jopts(), segment)
        tps, tcv = L.sweep_segment(*tarr[:3], tps, tcv, tpre, t0,
                                   L.EnmlOptions(), segment)
    assert _pose_diff(n(tps), np.asarray(jps)) <= POSE_ATOL
    assert _cov_rel(n(tcv)[1:], np.asarray(jcv)[1:]) <= COV_RTOL
    ps2, cv2 = L.sweep_segment(*tarr[:3], tps, tcv, tpre, K,
                               L.EnmlOptions(), segment)
    assert torch.equal(cv2, tcv)
    assert _pose_diff(n(ps2), n(tps)) <= 1e-6


# ------------------------------------------------------------ host traffic

class _HostTraffic(TorchDispatchMode):
    """What a CUDA graph could not capture, seen on the CPU: reads back to
    the host (_HostReads' kinds), and data made on the host that reaches a
    device operation (a `torch.tensor` or Python-scalar constant, which on
    a card is a host-to-device copy). A Python scalar stored by `fill_`
    is a kernel argument, not a copy, and passes."""

    def __init__(self):
        from test_torch_device_program import _HostReads

        super().__init__()
        self.reads = _HostReads()
        self.host_made = []     # kept alive, so no id is reused
        self.copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self.reads.__torch_dispatch__(func, types, args, kwargs)
        if func is aten.lift_fresh.default:
            self.host_made.append(out)
        elif func is not aten.fill_.Tensor and any(
                a is h for a in args for h in self.host_made):
            self.copies.append(str(func))
        return out


def _trip_traffic(sub, ltf, segment):
    from hitl_slam_torch.models.enml import localizer as L

    (pts, nrm, msk, poses), segs = sub
    o = L.EnmlOptions()
    pts, nrm, msk, poses = t(pts), t(nrm), torch.as_tensor(msk), t(poses)
    step = L._make_sweep_step(pts, nrm, msk, L.sweep_precompute(poses, o), o,
                              t(segs) if ltf else None,
                              gates=L._match_gates(o, "cpu"))
    covs = torch.zeros((K, 3, 3))
    ti, live = torch.tensor(5), torch.tensor(True)
    with _HostTraffic() as mode:
        step(poses, covs, ti, live if segment else None)
    return mode


@pytest.mark.parametrize("ltf,segment", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_sweep_trip_reads_nothing_back(sub, ltf, segment):
    """One trip of the sweep (and of a segment, with its live mask), with
    and without LTF segments: no host read and no host-made data."""
    mode = _trip_traffic(sub, ltf, segment)
    assert mode.reads.reads == [] and mode.copies == []


def test_window_solve_reads_nothing_back(sub):
    """The online window solve with its gates made before it: no host read
    and no host-made data."""
    from hitl_slam_torch.models.enml import localizer as L

    (pts, nrm, msk, poses), _ = sub
    o = L.EnmlOptions()
    gates = L._match_gates(o, "cpu")
    args = (t(pts[:10]), t(nrm[:10]), torch.as_tensor(msk[:10]),
            t(poses[:10]))
    with _HostTraffic() as mode:
        L._single_window(*args, o, gates=gates)
    assert mode.reads.reads == [] and mode.copies == []


def test_host_traffic_finds_the_gates():
    """The detector sees the host-made constant of the match gates, which
    is why the programs make them before their captures."""
    from hitl_slam_torch.models.enml import localizer as L

    with _HostTraffic() as mode:
        L._match_gates(L.EnmlOptions(), "cpu")
    assert mode.copies


def test_sweep_reads_host_only_at_loop_exits(sub):
    """An eager sweep's host reads are device_while's exit tests, one a
    node: P in all (the loop ends at its trip cap without a last test)."""
    from test_torch_device_program import _HostReads

    from hitl_slam_torch.models.enml import localizer as L

    (pts, nrm, msk, poses), _ = sub
    o = L.EnmlOptions(gn_iterations=1, match_rounds=1)
    with _HostReads() as mode:
        L.batch_localize(t(pts), t(nrm), torch.as_tensor(msk), t(poses), o)
    assert len(mode.reads) == K
    assert all(inside for _, inside in mode.reads)


# ------------------------------------------------------------ on the card

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the programs are CUDA graphs")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sweep_program_matches_eager(sub, cuda_device):
    """A replay of the sweep program, of a segment tiling and of the
    window program on the card: bit-equal to the eager functions there."""
    from hitl_slam_torch.models.enml import localizer as L

    (pts, nrm, msk, poses), _ = sub
    dev = cuda_device
    args = (torch.as_tensor(pts, device=dev), torch.as_tensor(nrm, device=dev),
            torch.as_tensor(msk, device=dev),
            torch.as_tensor(poses, device=dev))
    o = L.EnmlOptions()
    for got, want in zip(L.batch_localize(*args, o),
                         L.batch_localize(*args, o, eager=True)):
        assert torch.equal(got, want)
    pre = L.sweep_precompute(args[3], o)
    runs = []
    for eager in (False, True):
        ps, cv = args[3], torch.zeros((K, 3, 3), device=dev)
        for t0 in range(0, K, 10):
            ps, cv = L.sweep_segment(*args[:3], ps, cv, pre, t0, o, 10,
                                     eager=eager)
        runs.append((ps, cv))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    w = [L.single_window_localize(*(a[:10] for a in args), o, eager=e)
         for e in (False, True)]
    assert torch.equal(w[0], w[1])


@pytest.mark.cuda
def test_programs_keep_the_input_dtype(sub, cuda_device):
    """f64 inputs get f64 programs: the sweep's and the window's replays
    return f64 results bit-equal to the eager f64 functions."""
    from hitl_slam_torch.models.enml import localizer as L

    (pts, nrm, msk, poses), _ = sub
    dev, f64 = cuda_device, torch.float64
    args = (torch.as_tensor(pts[:10], dtype=f64, device=dev),
            torch.as_tensor(nrm[:10], dtype=f64, device=dev),
            torch.as_tensor(msk[:10], device=dev),
            torch.as_tensor(poses[:10], dtype=f64, device=dev))
    o = L.EnmlOptions()
    for got, want in zip(L.batch_localize(*args, o),
                         L.batch_localize(*args, o, eager=True)):
        assert got.dtype == f64 and torch.equal(got, want)
    w = [L.single_window_localize(*args, o, eager=e) for e in (False, True)]
    assert w[0].dtype == f64 and torch.equal(w[0], w[1])
