"""The checkerboard localizer, build_sdf and RANSAC's extract_segments in
carry form (each loop a `device_for` over an index held on the device, so
that a CUDA graph can hold it as one WHILE node): each against a copy of
the Python loop it replaced, kept here, bit for bit on the CPU; the host
traffic of each after its warm-up (no read back, no data made on the
host); the defaults of the reference's public functions and methods in
the port; and, on a card only (marker `cuda`), replays of the three
programs against `eager=True`.

The inputs are made by the port's own generators, and nothing here
imports JAX (the defaults walk reads the reference's sources), so the
card's tests run where JAX is not installed: python -m pytest -p no:cacheprovider
--noconftest -m cuda tests/test_torch_loop_programs.py (chip_smoke.py
runs the same comparisons at full size). The JAX parity of the three
functions is held by tests/test_torch_checkerboard.py,
tests/test_torch_ltvm.py and tests/test_torch_propose.py, which now run
the carry form."""

import ast
import dataclasses
import glob
import math
import os

import numpy as np
import pytest
import torch

from test_torch_enml_program import _HostTraffic
from test_torch_refine_program import _CardReads, cuda_device  # noqa: F401
from torch_port_helpers import n, t

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_torch_checkerboard.py's stream, its grid route's options and
# node count
STREAM = dict(num_steps=160, num_rays=240, seed=11, noise_trans=4e-3,
              noise_theta=2e-3)
GRID_OPTS = dict(gn_iterations=6, match_rounds=1)
GRID_NODES = 20
# tests/test_torch_ltvm.py's SDF image
ORIGIN = np.array([-21.3, -1.2], np.float32)
H, W = 125, 425


# ------------------------------------------------------------ inputs

@pytest.fixture(scope="module")
def small():
    """(points, normals, mask, poses) CPU tensors of the 64-node episode
    map of tests/test_torch_checkerboard.py (80 scans, 256 padded points a
    node), made by the port's generator and episode builder."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.io.figure8 import generate_raw_stream
    from hitl_slam_torch.models.enml.driver import (EpisodeOptions,
                                                     build_episodes)

    scans, angles, rel, _, _ = generate_raw_stream(**STREAM)
    poses, pcs, ncs, _ = build_episodes(
        scans[:80], angles, rel[:80], EpisodeOptions(clip_low=10, clip_high=10))
    st = make_map_state(poses, np.zeros((len(poses), 3, 3), np.float32),
                        pcs, ncs, device="cpu")
    return st.points, st.normals, st.point_mask, st.poses


@pytest.fixture(scope="module")
def noisy_48():
    """tests/test_torch_ltvm.py's 48-pose figure-8 (poses, points, mask)."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.io.figure8 import generate_figure8

    m = generate_figure8(num_poses=48, num_rays=120, seed=4)
    st = make_map_state(m.poses, m.covariances, m.point_clouds,
                        m.normal_clouds, device="cpu")
    return st.poses, st.points, st.point_mask


def _three_walls(seed):
    """tests/test_torch_propose.py's three noisy walls with clutter."""
    rng = np.random.default_rng(seed)
    u = np.linspace(0, 1, 150)
    pts = np.concatenate([
        np.stack([u * 8.0, np.zeros_like(u)], -1),
        np.stack([np.zeros_like(u), u * 5.0], -1),
        np.stack([u * 6.0 + 2.0, np.full_like(u, 7.0)], -1)], 0)
    pts += rng.normal(0, 0.01, pts.shape)
    pts = np.concatenate([pts, rng.uniform(-1, 9, (60, 2))], 0)
    mask = np.ones(len(pts), bool)
    mask[::17] = False
    return pts.astype(np.float32), mask


# ------------------------------------------------------------ today's loops

def _old_checkerboard(points, normals, point_mask, initial_poses, o,
                      n_passes=2, chunk=8, force_grid=False):
    """checkerboard_localize (without a mesh or stage clock) as it was
    before the carry form: Python loops over the chunks and, with the grid
    matcher, over a chunk's windows; each tiling gathered from numpy
    starts."""
    from hitl_slam_torch.models.enml import parallel_localizer as CB
    from hitl_slam_torch.models.enml.localizer import (
        _brute_window_match, _match_gates, _odometry_targets, _pair_mask,
        window_gn_batched)
    from hitl_slam_torch.ops.geometry import angle_mod

    P, N, _ = points.shape
    W = min(o.max_history, P)
    M = W * N
    half = max(W // 2, 1)
    dev, dtype = initial_poses.device, initial_poses.dtype
    o_one_round = dataclasses.replace(o, match_rounds=1)
    gates = _match_gates(o, dev)
    use_grid = force_grid or (W * N > CB.BRUTE_MATCH_LIMIT)
    pose_of = torch.arange(W, device=dev)[:, None].expand(W, N).reshape(M)
    eye = torch.eye(3, dtype=dtype, device=dev)
    odo = _odometry_targets(initial_poses, o)

    def gather_windows(arr, starts, fill_clamp):
        idx = starts[:, None] + torch.arange(W, device=starts.device)[None, :]
        return arr[torch.clamp(idx, 0, fill_clamp)], idx

    def tiling(parity):
        first = parity * half
        n_win = -(-(P - first) // W) if P > first else 0
        B = max(n_win, 1)
        starts = first + W * np.arange(B)
        ck = max(min(chunk, B), 1)
        Bpad = -(-B // ck) * ck
        starts = np.concatenate([starts, np.full(Bpad - B, P + W)])
        idx = starts[:, None] + np.arange(W)[None, :]
        active = idx < P
        starts_d = torch.as_tensor(starts, device=dev)
        pts, idx_d = gather_windows(points, starts_d, P - 1)
        act = torch.as_tensor(active, device=dev)
        cidx = torch.as_tensor(np.clip(idx[:, :-1], 0, max(P - 2, 0)),
                               device=dev)
        axis, d, rot, isig = odo
        chain = (axis[cidx], d[cidx], rot[cidx], isig[cidx],
                 torch.as_tensor(idx[:, :-1] < P - 1, device=dev).to(dtype))
        last_j = np.maximum(active[:B].sum(1) - 1, 0)
        fill = active & (idx % W == 0) & (np.arange(W)[None, :] != 0)
        return dict(
            B=B, ck=ck, n_chunked=-(-B // ck) * ck,
            idx=torch.clamp(idx_d, 0, P - 1), active=act, pin=~act, pts=pts,
            nrm=gather_windows(normals, starts_d, P - 1)[0],
            mask=gather_windows(point_mask, starts_d, P - 1)[0]
            & act[..., None], chain=chain,
            rows=torch.as_tensor(np.where(active[:B], idx[:B], P).reshape(-1)),
            old_last=torch.as_tensor(np.clip(starts[:B] + last_j, 0, P - 1)),
            last_j=torch.as_tensor(last_j), any_active=active[:B].any(1),
            fill_odd=torch.as_tensor(np.where(fill, idx, P).reshape(-1)))

    tilings = [tiling(0)] + ([tiling(1)] if P > half else [])

    def match_chunk(tl, sl, wposes):
        pts = tl["pts"][sl].reshape(-1, M, 2)
        nrm = tl["nrm"][sl].reshape(-1, M, 2)
        msk = tl["mask"][sl].reshape(-1, M)
        if not use_grid:
            return _brute_window_match(wposes, pts, nrm, msk, pose_of,
                                       *gates, _pair_mask(msk, pose_of))
        tv = [CB._make_match_fn(pts[k], nrm[k], msk[k], W, N, o)(wposes[k])
              for k in range(wposes.shape[0])]
        return (torch.stack([a for a, _ in tv]),
                torch.stack([b for _, b in tv]))

    def gn_chunk(tl, sl, wposes, tgt, valid, eval_only=False):
        return window_gn_batched(
            wposes, tl["pts"][sl], tl["nrm"][sl], tl["mask"][sl],
            *(c[sl] for c in tl["chain"]), o_one_round,
            match_fn=lambda _p: (tgt, valid), w_pin=tl["pin"][sl],
            eval_only=eval_only, need_hessian=eval_only, gates=gates)

    def half_pass(poses, tl):
        new_w = []
        for lo in range(0, tl["n_chunked"], tl["ck"]):
            sl = slice(lo, lo + tl["ck"])
            w0 = poses[tl["idx"][sl]]
            wp = w0
            for _ in range(o.match_rounds):
                tgt, valid = match_chunk(tl, sl, wp)
                wp = gn_chunk(tl, sl, wp, tgt, valid)[0]
            new_w.append(torch.where(tl["active"][sl, :, None], wp, w0))
        new_w = torch.cat(new_w)[:tl["B"]]
        old_last = poses[tl["old_last"]]
        new_last = new_w[torch.arange(tl["B"]), tl["last_j"]]
        dT = (CB._se2_mat(new_last)
              @ torch.linalg.inv_ex(CB._se2_mat(old_last))[0])
        if not tl["any_active"].all():
            dT = torch.where(torch.as_tensor(tl["any_active"])[:, None, None],
                             dT, eye)
        carry = torch.cat([eye[None], CB._prefix_matmul(dT)[:-1]], 0)
        carried = CB._se2_apply(carry[:, None], new_w)
        out = torch.cat([poses, poses.new_zeros((1, 3))])
        out.index_put_((tl["rows"],), carried.reshape(-1, 3))
        return out[:P]

    poses = initial_poses
    for _ in range(n_passes):
        for tl in tilings:
            poses = half_pass(poses, tl)

    def eval_tiling(tl):
        covs = []
        for lo in range(0, tl["n_chunked"], tl["ck"]):
            sl = slice(lo, lo + tl["ck"])
            w0 = poses[tl["idx"][sl]]
            tgt, valid = match_chunk(tl, sl, w0)
            np_, Hs = gn_chunk(tl, sl, w0, tgt, valid, eval_only=True)
            covs.append(CB.window_covariances(Hs, tl["active"][sl],
                                              np_[..., 2]))
        return torch.cat(covs).reshape(-1, 3, 3)

    even = tilings[0]
    pinned = torch.arange(W) == 0
    rows = torch.where(even["active"] & ~pinned, even["idx"],
                       P)[:even["n_chunked"]]
    covariances = torch.zeros((P + 1, 3, 3), dtype=dtype)
    covariances.index_put_((rows.reshape(-1),), eval_tiling(even))
    if len(tilings) > 1:
        odd = tilings[1]
        covariances.index_put_((odd["fill_odd"][:odd["n_chunked"] * W],),
                               eval_tiling(odd))
    covariances = covariances[:P]
    covariances[0] = eye * 1e-6
    poses = torch.cat([poses[:, :2], angle_mod(poses[:, 2:])], -1)
    return poses, covariances


def _old_build_sdf(poses, points, point_mask, origin, height, width, p):
    """build_sdf as it was before the carry form: a Python loop over the
    poses, each update a new tensor."""
    from hitl_slam_torch.ops.sdf import _INV_TWO_PI, _bin_scans

    res = p.image_resolution
    nbins = p.num_bearing_bins
    dtype = poses.dtype
    gx = origin[0] + res * torch.arange(width, dtype=dtype)
    gy = origin[1] + res * torch.arange(height, dtype=dtype)
    pix_x = gx[None, :].expand(height, width)
    pix_y = gy[:, None].expand(height, width)
    all_ranges = _bin_scans(points, point_mask, nbins, p.max_range)
    values = torch.zeros((height, width), dtype=dtype)
    weights = torch.zeros((height, width), dtype=dtype)
    for k in range(poses.shape[0]):
        pose = poses[k]
        ranges = all_ranges[k]
        dx = pix_x - pose[0]
        dy = pix_y - pose[1]
        r_pix = torch.sqrt(dx * dx + dy * dy)
        bearing = torch.atan2(dy, dx) - pose[2]
        bearing = torch.atan2(torch.sin(bearing), torch.cos(bearing))
        fb = (bearing + math.pi) * _INV_TWO_PI * nbins
        fb_floor = torch.floor(fb)
        b0 = fb_floor.to(torch.int32) % nbins
        b1 = (b0 + 1) % nbins
        r0 = ranges[b0.long()]
        r1 = ranges[b1.long()]
        both = torch.isfinite(r0) & torch.isfinite(r1)
        frac = fb - fb_floor
        beam = torch.where(both, (1 - frac) * r0 + frac * r1,
                           torch.minimum(r0, r1))
        sdf = beam - r_pix
        tsdf = sdf.clamp(max=p.max_sdf_value)
        w = torch.where(tsdf.abs() <= p.eps, p.max_sdf_weight,
                        torch.exp(-p.sigma * (tsdf - p.eps) ** 2))
        update = (torch.isfinite(beam) & (sdf >= p.min_sdf_value)
                  & (r_pix < p.max_range))
        w = torch.where(update, w, 0.0)
        values = (values * weights + w * torch.where(update, tsdf, 0.0)) / (
            (weights + w).clamp(min=1e-12))
        weights = weights + w
    values = torch.where(weights > 0, values, p.min_sdf_value)
    return values, weights, torch.tensor(res, dtype=dtype)


def _old_extract_segments(pts, mask, draws, p):
    """extract_segments as it was before the carry form: a Python loop
    over the rounds, the segments stacked at the end."""
    from hitl_slam_torch.ops.ransac import (_pick_available,
                                            principal_direction)

    batched = pts.dim() == 3
    if not batched:
        pts, mask = pts[None], mask[None]
    B = pts.shape[0]
    dtype = pts.dtype
    thr = p.inlier_threshold
    ptsT = pts.transpose(1, 2)
    from_uniforms = isinstance(draws, torch.Tensor)
    if from_uniforms:
        u_all = draws if batched else draws[None]

    def take(x, idx):
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, 2).long())

    def line_fit(inliers):
        wsum = inliers.sum(1).clamp(min=1).to(dtype)
        sel = inliers[..., None]
        cm = torch.where(sel, pts, 0.0).sum(1) / wsum[:, None]
        rel = torch.where(sel, pts - cm[:, None, :], 0.0)
        return cm, rel, rel.transpose(1, 2) @ rel

    avail = mask
    out = []
    for r in range(p.num_segments):
        if from_uniforms:
            csum = torch.cumsum(avail, 1, dtype=torch.int32)
            ia = _pick_available(avail, csum, u_all[:, r, 0])
            ib = _pick_available(avail, csum, u_all[:, r, 1])
        else:
            ia, ib = draws(r, avail if batched else avail[0])
            ia = torch.as_tensor(ia).reshape(B, -1)
            ib = torch.as_tensor(ib).reshape(B, -1)
        a = take(pts, ia)
        b = take(pts, ib)
        d = b - a
        nrm = torch.stack([-d[..., 1], d[..., 0]], -1)
        nlen = torch.sqrt(torch.sum(nrm * nrm, -1, keepdim=True))
        nv = nrm / nlen.clamp(min=1e-9)
        c = torch.sum(nv * a, -1)
        ok_h = (torch.gather(avail, 1, ia.long())
                & torch.gather(avail, 1, ib.long()) & (nlen[..., 0] > 1e-6))
        dist = (nv @ ptsT - c[..., None]).abs_()
        inl = (dist < thr) & avail[:, None, :]
        counts = inl.sum(2) * ok_h
        best = torch.argmax(counts, dim=1, keepdim=True)
        best_ok = torch.gather(counts, 1, best) > 0
        n_b = take(nv, best)
        c_b = torch.gather(c, 1, best)
        inliers = (((n_b @ ptsT)[:, 0] - c_b).abs() < thr) & avail & best_ok
        cm, rel, S = line_fit(inliers)
        direction = principal_direction(S[:, 0, 0], S[:, 0, 1], S[:, 1, 1])
        n_ref = torch.stack([-direction[:, 1], direction[:, 0]], -1)
        d_ref = ((pts - cm[:, None, :]) @ n_ref[..., None])[..., 0].abs()
        inliers = (d_ref < thr) & avail & best_ok
        cm, rel, S = line_fit(inliers)
        tt = (rel @ direction[..., None])[..., 0]
        count = inliers.sum(1)
        some = count > 0
        inf = torch.full_like(tt, float("inf"))
        t_lo = torch.where(some, torch.where(inliers, tt, inf).amin(1), 0.0)
        t_hi = torch.where(some, torch.where(inliers, tt, -inf).amax(1), 0.0)
        p1 = cm + t_lo[:, None] * direction
        p2 = cm + t_hi[:, None] * direction
        valid = ((count >= p.min_inliers) & ((t_hi - t_lo) >= p.min_length)
                 & best_ok[:, 0])
        avail = avail & ~(inliers & valid[:, None])
        out.append((p1, p2, count.to(torch.int32), valid, count.to(dtype),
                    cm, S))
    fields = [torch.stack(f, dim=1) for f in zip(*out)]
    if not batched:
        fields = [f[0] for f in fields]
    return fields


# ------------------------------------------------------------ bit for bit

@pytest.mark.parametrize("route", ["brute", "grid"])
def test_checkerboard_carry_form_matches_old_loop(small, route):
    """One even/odd pass of the brute route on the 64-node map, and of the
    grid route on its first 20 nodes (the grid matcher's windows a loop
    inside the chunk loop): poses and covariances bit-equal to the Python
    loops."""
    from hitl_slam_torch.models.enml.localizer import EnmlOptions
    from hitl_slam_torch.models.enml.parallel_localizer import (
        checkerboard_localize)

    args, kw, o = small, {}, EnmlOptions()
    if route == "grid":
        args = tuple(a[:GRID_NODES] for a in small)
        kw, o = dict(force_grid=True), EnmlOptions(**GRID_OPTS)
    got = checkerboard_localize(*args, o, n_passes=1, **kw)
    want = _old_checkerboard(*args, o, n_passes=1, **kw)
    assert np.isfinite(n(got[0])).all()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_checkerboard_carry_form_two_passes_and_padding(small):
    """The default two passes on 36 nodes with chunks of 3 (the even
    tiling's 4 windows padded to 6, so a chunk holds padding windows):
    bit-equal to the Python loops."""
    from hitl_slam_torch.models.enml.localizer import EnmlOptions
    from hitl_slam_torch.models.enml.parallel_localizer import (
        checkerboard_localize)

    args = tuple(a[:36] for a in small)
    o = EnmlOptions(gn_iterations=3, match_rounds=2)
    got = checkerboard_localize(*args, o, chunk=3)
    want = _old_checkerboard(*args, o, chunk=3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_build_sdf_carry_form_matches_old_loop(noisy_48):
    """The SDF of the 48-pose figure-8 at 0.1 m: values, weights and the
    resolution bit-equal to the Python loop over the poses."""
    from hitl_slam_torch.ops.sdf import SdfParams, build_sdf

    p = SdfParams(image_resolution=0.1)
    got = build_sdf(*noisy_48, t(ORIGIN), H, W, p)
    want = _old_build_sdf(*noisy_48, t(ORIGIN), H, W, p)
    assert torch.equal(got.values, want[0])
    assert torch.equal(got.weights, want[1])
    assert torch.equal(got.resolution, want[2])
    assert int((got.weights > 0).sum()) > 1000


@pytest.mark.parametrize("route", ["lone", "batched", "callable"])
def test_extract_segments_carry_form_matches_old_loop(route):
    """Uniform draws from one seed, lone and batched (two maps side by
    side), and a callable's draws: every field bit-equal to the Python
    loop over the rounds."""
    from hitl_slam_torch.ops import ransac as TR

    rp = TR.RansacParams(num_segments=8, inlier_threshold=0.05,
                         min_inliers=40)
    pts, mask = _three_walls(5)
    pts, mask = t(pts), t(mask)
    draws = TR.uniform_draws(3, rp, "cpu")
    if route == "batched":
        other = _three_walls(6)
        pts = torch.stack([pts, t(other[0])])
        mask = torch.stack([mask, t(other[1])])
        draws = TR.uniform_draws(3, rp, "cpu", batch=2)
    elif route == "callable":
        rng = np.random.default_rng(9)

        def draws(r, avail):
            idx = np.flatnonzero(n(avail))
            return (torch.as_tensor(rng.choice(idx, 256)),
                    torch.as_tensor(rng.choice(idx, 256)))

        rng_old = np.random.default_rng(9)

        def old_draws(r, avail):
            idx = np.flatnonzero(n(avail))
            return (torch.as_tensor(rng_old.choice(idx, 256)),
                    torch.as_tensor(rng_old.choice(idx, 256)))
    got = TR.extract_segments(pts, mask, draws, rp)
    want = _old_extract_segments(
        pts, mask, old_draws if route == "callable" else draws, rp)
    names = ("p1", "p2", "count", "valid", "mass", "centroid", "scatter")
    for name, w in zip(names, want):
        assert torch.equal(getattr(got, name), w), name
    assert int(got.valid.sum()) >= 3 * (2 if route == "batched" else 1)


# ------------------------------------------------------------ host traffic

@pytest.mark.parametrize("route", ["brute", "grid"])
def test_checkerboard_passes_read_nothing_back(small, route):
    """The checkerboard's passes after what its program's warm() makes (the
    tilings' plans, the match gates, the grid matcher's permutation), on
    a map of every 4th point (24 nodes and two passes by the brute
    matcher; 12 nodes, W = 6 and one pass by the grid matcher): no host
    read and no host-made data."""
    from hitl_slam_torch.models.enml import parallel_localizer as CB
    from hitl_slam_torch.models.enml.localizer import (EnmlOptions,
                                                       _match_gates)
    from hitl_slam_torch.ops.correspond import preshuffle_on

    P, passes, o = 24, 2, EnmlOptions(gn_iterations=2, match_rounds=2)
    if route == "grid":
        P, passes = 12, 1
        o = EnmlOptions(max_history=6, gn_iterations=2, match_rounds=1)
    args = (small[0][:P, ::4].contiguous(), small[1][:P, ::4].contiguous(),
            small[2][:P, ::4].contiguous(), small[3][:P])
    W = o.max_history
    plans = CB._plans(P, W, 2, 1, "cpu")
    gates = _match_gates(o, "cpu")
    preshuffle_on(W * args[0].shape[1], "cpu")
    with _HostTraffic() as mode:
        p, c = CB._checkerboard(*args, o, passes, route == "grid", plans,
                                gates)
    assert mode.reads.reads == [] and mode.copies == []
    assert np.isfinite(n(p)).all() and np.isfinite(n(c)).all()


def test_build_sdf_reads_nothing_back(noisy_48):
    """The SDF's pose loop and what follows it: no host read and no
    host-made data (the resolution is a fill, not a copy)."""
    from hitl_slam_torch.ops.sdf import SdfParams, _build_sdf

    origin = t(ORIGIN)
    with _HostTraffic() as mode:
        _build_sdf(*noisy_48, origin, H, W, SdfParams(image_resolution=0.1))
    assert mode.reads.reads == [] and mode.host_made == []


@pytest.mark.parametrize("batched", [False, True])
def test_extract_segments_reads_nothing_back(batched):
    """RANSAC's rounds from uniform draws: no host read and no host-made
    data."""
    from hitl_slam_torch.ops import ransac as TR

    rp = TR.RansacParams(num_segments=4)
    pts, mask = (t(a) for a in _three_walls(2))
    u = TR.uniform_draws(0, rp, "cpu", batch=2 if batched else None)
    if batched:
        pts, mask = pts[None].repeat(2, 1, 1), mask[None].repeat(2, 1)
    with _HostTraffic() as mode:
        TR._extract(pts, mask, u, rp)
    assert mode.reads.reads == [] and mode.copies == []


def test_device_for_runs_its_trips_without_reads():
    """device_for eagerly: `trips` trips with the index 0 .. trips - 1,
    no host read; none for trips = 0."""
    from hitl_slam_torch.utils.device_loop import device_for

    seen = torch.zeros(5, dtype=torch.int64)
    with _HostTraffic() as mode:
        device_for(5, lambda i: seen.index_copy_(0, i.reshape(1),
                                                 (i * 10).reshape(1)), "cpu")
        device_for(0, lambda i: seen.zero_(), "cpu")
    assert mode.reads.reads == []
    assert seen.tolist() == [0, 10, 20, 30, 40]


# ------------------------------------------------------------ defaults

# the reference's modules ported under other names
RENAMED = {"ops/pallas_em": "ops/em_scan",
           "solver/pallas_bcr": "solver/bcr_kernel"}
RENAMED_NAMES = {"bcr_solve_pallas": "bcr_solve_cuda"}
# (module, function or Class.method, parameter): the reference's default
# and the port's, where they differ by design: the trace directory names
# its profiler, and the dtype its package
DEFAULT_RENAMES = {
    ("utils/timing", "device_trace", "logdir"): ("/tmp/jax-trace",
                                                 "/tmp/torch-trace"),
    ("core/state", "make_map_state", "dtype"): ("jnp.float32",
                                                "torch.float32"),
}


def _literal(node):
    """(True, value) for a str, number, bool or None default (a negated
    number too), else (False, its source)."""
    if isinstance(node, ast.Constant):
        return True, node.value
    if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)
            and isinstance(node.operand.value, (int, float))):
        return True, -node.operand.value
    return False, ast.unparse(node)


def _defaults(fn: ast.FunctionDef) -> dict:
    """Parameter name -> its default node, for every parameter that has
    one."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = dict(zip((p.arg for p in pos[len(pos) - len(a.defaults):]),
                   a.defaults))
    out.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults)
                if d is not None})
    return out


def _functions(path) -> dict:
    """name -> FunctionDef of a module's public functions and its public
    classes' public methods (and __init__), as "Class.method"."""
    tree = ast.parse(open(path).read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out[node.name] = node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        not m.name.startswith("_") or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = m
    return out


def test_defaults_follow_the_reference():
    """Every default of a public function or method of hitl_slam_tpu/ that
    is a str, a number, a bool or None is the port's default of that
    parameter, of the same type, but for DEFAULT_RENAMES, which must hold
    as named (read from the sources: the reference's modules import
    jax)."""
    ref_root = os.path.join(REPO, "hitl_slam_tpu")
    port_root = os.path.join(REPO, "hitl_slam_torch")
    wrong, compared, renamed = [], 0, set()
    for path in sorted(glob.glob(os.path.join(ref_root, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, ref_root)[:-3]
        port = os.path.join(port_root, RENAMED.get(rel, rel) + ".py")
        if not os.path.exists(port):
            continue
        theirs = _functions(port)
        for name, fn in _functions(path).items():
            mine = theirs.get(RENAMED_NAMES.get(name, name))
            if mine is None:
                continue
            port_defaults = _defaults(mine)
            for arg, node in _defaults(fn).items():
                key = (rel, name, arg)
                is_lit, want = _literal(node)
                if key in DEFAULT_RENAMES:
                    assert want == DEFAULT_RENAMES[key][0], (key, want)
                    want = DEFAULT_RENAMES[key][1]
                    renamed.add(key)
                elif not is_lit:
                    continue
                compared += 1
                got = (_literal(port_defaults[arg])[1]
                       if arg in port_defaults else "missing")
                if type(got) is not type(want) or got != want:
                    wrong.append((rel, name, arg, want, got))
    assert wrong == [], wrong
    assert renamed == set(DEFAULT_RENAMES)
    assert compared > 200, compared


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("route", ["brute", "grid"])
def test_checkerboard_program_matches_eager(small, cuda_device, route):
    """A replay of the checkerboard's program on the card: bit-equal to
    `eager=True` there, one host read a call."""
    from hitl_slam_torch.models.enml.localizer import EnmlOptions
    from hitl_slam_torch.models.enml.parallel_localizer import (
        checkerboard_localize)

    args = tuple(a.to(cuda_device) for a in small)
    kw, o = dict(n_passes=1), EnmlOptions()
    if route == "grid":
        args = tuple(a[:GRID_NODES] for a in args)
        kw, o = dict(n_passes=1, force_grid=True), EnmlOptions(**GRID_OPTS)
    want = checkerboard_localize(*args, o, **kw, eager=True)
    got = checkerboard_localize(*args, o, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with _CardReads() as mode:
        checkerboard_localize(*args, o, **kw)[0].cpu()
    assert mode.reads == 1


@pytest.mark.cuda
def test_sdf_and_ransac_programs_match_eager(noisy_48, cuda_device):
    """Replays of build_sdf's and extract_segments' programs on the card:
    bit-equal to `eager=True` there, one host read a call."""
    from hitl_slam_torch.ops import ransac as TR
    from hitl_slam_torch.ops.sdf import SdfParams, build_sdf

    dev = cuda_device
    args = tuple(a.to(dev) for a in noisy_48)
    p = SdfParams(image_resolution=0.1)
    origin = t(ORIGIN).to(dev)
    got = build_sdf(*args, origin, H, W, p)
    want = build_sdf(*args, origin, H, W, p, eager=True)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.weights, want.weights)
    with _CardReads() as mode:
        build_sdf(*args, origin, H, W, p).values.cpu()
    assert mode.reads == 1
    rp = TR.RansacParams(num_segments=8, inlier_threshold=0.05,
                         min_inliers=40)
    pts, mask = (t(a).to(dev) for a in _three_walls(5))
    u = TR.uniform_draws(3, rp, dev)
    got = TR.extract_segments(pts, mask, u, rp)
    want = TR.extract_segments(pts, mask, u, rp, eager=True)
    for name in ("p1", "p2", "count", "valid", "mass", "centroid",
                 "scatter"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    with _CardReads() as mode:
        TR.extract_segments(pts, mask, u, rp).p1.cpu()
    assert mode.reads == 1
