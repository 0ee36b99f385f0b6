"""Port parity: RANSAC segments, the correlative scan matcher, auto-proposed
corrections, the engine's propose_corrections and the CLI's --auto-repair,
--render and --info-mat, each against the JAX package on the same numpy
inputs (JAX and torch both on the CPU, f32).

The JAX package draws its RANSAC hypotheses with jax.random; the port takes
the draws as an input, and these tests hand it the reference's own
(torch_port_helpers.reference_draws), so both score the same index pairs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import (dense_correlation, n, procrustes_error,
                                reference_draws, t)

torch.set_num_threads(2)


# ---------------------------------------------------------------- RANSAC

def _eigh_cases():
    rng = np.random.default_rng(0)
    cases = []
    for k in range(400):
        th = rng.uniform(-np.pi, np.pi)
        l1 = rng.uniform(0, 1)
        l2 = l1 + rng.uniform(0.01, 5)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        S = (R @ np.diag([l2, l1]) @ R.T).astype(np.float32)
        S = (S + S.T) / 2
        if k % 11 == 0:
            S[0, 1] = S[1, 0] = 0.0
        if k % 13 == 0:
            S[0, 1] = S[1, 0] = np.float32(1e-9)
        cases.append(S)
    cases += [np.zeros((2, 2), np.float32), np.eye(2, dtype=np.float32),
              np.diag([2.0, 1.0]).astype(np.float32),
              np.diag([1.0, 2.0]).astype(np.float32)]
    return np.stack(cases)


def test_principal_direction_matches_eigh_with_its_sign():
    """The closed-form eigenvector of the 2x2 scatter equals
    eigh(S)[1][:, 1] of the reference, sign included, to 2e-6 (unit
    vectors in f32), on rotated, diagonal, nearly diagonal, zero and
    identity matrices."""
    from hitl_slam_torch.ops.ransac import principal_direction

    S = _eigh_cases()
    want = np.stack([np.asarray(jnp.linalg.eigh(jnp.asarray(s))[1])[:, 1]
                     for s in S])
    got = principal_direction(t(S[:, 0, 0]), t(S[:, 0, 1]), t(S[:, 1, 1]))
    np.testing.assert_allclose(n(got), want, atol=2e-6, rtol=0)


def _three_walls(seed):
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


def _assert_segments_match(got, ref, atol):
    """count and valid exact; endpoints, centroid to `atol`; scatter to
    `atol` relative to its largest entry."""
    np.testing.assert_array_equal(n(got.count), np.asarray(ref.count))
    np.testing.assert_array_equal(n(got.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(n(got.mass), np.asarray(ref.mass))
    for name in ("p1", "p2", "centroid"):
        np.testing.assert_allclose(n(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=0, err_msg=name)
    scale = max(1.0, float(np.abs(np.asarray(ref.scatter)).max()))
    np.testing.assert_allclose(n(got.scatter), np.asarray(ref.scatter),
                               atol=atol * scale, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_segments_parity_with_reference_draws(seed):
    """Same points, same index pairs: inlier counts, valid and mass equal;
    endpoints (p1/p2 in the reference's order, so the eigenvector's sign
    matches), centroid and scatter to f32 round-off (5e-6 m; the scatter
    5e-6 of its largest entry)."""
    from hitl_slam_torch.ops import ransac as TR
    from hitl_slam_tpu.ops import ransac as JR

    pts, mask = _three_walls(seed)
    kw = dict(num_segments=8, inlier_threshold=0.05, min_inliers=40)
    key = jax.random.PRNGKey(seed)
    ref = JR.extract_segments(jnp.asarray(pts), jnp.asarray(mask), key,
                              JR.RansacParams(**kw))
    got = TR.extract_segments(t(pts), t(mask), reference_draws(key, 8, 256),
                              TR.RansacParams(**kw))
    assert int(np.asarray(ref.valid).sum()) >= 3
    _assert_segments_match(got, ref, 5e-6)


def test_extract_segments_uniform_draws_batched_and_repeatable():
    """Uniform draws: a batch of two extractions equals the two run alone,
    bit for bit; the same seed gives the same segments; the three walls are
    found."""
    from hitl_slam_torch.ops import ransac as TR

    pts, mask = _three_walls(5)
    rp = TR.RansacParams(num_segments=8, inlier_threshold=0.05,
                         min_inliers=40)
    u0 = TR.uniform_draws(3, rp, "cpu")
    u1 = TR.uniform_draws(4, rp, "cpu")
    assert torch.equal(u0, TR.uniform_draws(3, rp, "cpu"))
    assert u0.shape == (8, 2, 256) and float(u0.min()) >= 0 and float(u0.max()) < 1
    # a caller's own generator advances from draw to draw
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(u0, TR.uniform_draws(None, rp, "cpu", generator=gen))
    assert not torch.equal(u0, TR.uniform_draws(None, rp, "cpu", generator=gen))
    one = [TR.extract_segments(t(pts), t(mask), u, rp) for u in (u0, u1)]
    both = TR.extract_segments(t(pts)[None].repeat(2, 1, 1),
                               t(mask)[None].repeat(2, 1),
                               torch.stack([u0, u1]), rp)
    for b in range(2):
        for name in ("p1", "p2", "count", "valid", "centroid", "scatter"):
            assert torch.equal(getattr(both, name)[b], getattr(one[b], name)), name
    assert int(one[0].valid.sum()) == 3
    lengths = (one[0].p2 - one[0].p1).norm(dim=1)[one[0].valid]
    assert sorted(lengths.tolist())[-1] > 6.0
    with pytest.raises(ValueError):
        TR.extract_segments(t(pts), t(mask), u0[:4], rp)


def test_uniform_draws_pick_available_points_by_rank():
    """A uniform u picks the available point of rank floor(u * n_available):
    every pick is available, ranks cover the available points evenly, and
    an empty mask picks nothing available (the round is then gated)."""
    from hitl_slam_torch.ops.ransac import _pick_available

    avail = torch.tensor([[False, True, True, False, True, False, True, True]])
    csum = torch.cumsum(avail, 1, dtype=torch.int32)
    u = torch.tensor([[0.0, 0.19, 0.2, 0.5, 0.79, 0.8, 0.999999]])
    got = _pick_available(avail, csum, u)
    assert got.tolist() == [[1, 1, 2, 4, 6, 7, 7]]
    none = torch.zeros((1, 8), dtype=torch.bool)
    got = _pick_available(none, torch.cumsum(none, 1, dtype=torch.int32), u)
    assert bool(((got >= 0) & (got < 8)).all())


# ---------------------------------------------------------------- scan match

@pytest.fixture(scope="module")
def clean_48():
    """The map of tests/test_scan_match.py: 48 noise-free poses, all scans
    in the world frame."""
    from hitl_slam_tpu.io.figure8 import generate_figure8

    m = generate_figure8(num_poses=48, num_rays=180, seed=9,
                         drift_theta_bias=0.0, noise_trans=0.0,
                         noise_theta=0.0)
    pts = []
    for i in range(48):
        c, s = np.cos(m.gt_poses[i, 2]), np.sin(m.gt_poses[i, 2])
        pts.append(m.point_clouds[i] @ np.array([[c, -s], [s, c]]).T
                   + m.gt_poses[i, :2])
    return m, np.concatenate(pts, 0).astype(np.float32)


def _params(mod):
    return mod.ScanMatchParams(resolution=0.1, window=1.0, angle_window=0.3,
                               num_angles=31)


def test_build_likelihood_field_parity(clean_48):
    """The field agrees to 1e-6 (values in [0, 1]), also with a batch
    dimension and a mask. The noise-free walls sit on cell edges, where the
    index depends on dividing by the resolution as the reference's compiled
    program does (a multiplication by the f32 reciprocal)."""
    from hitl_slam_torch.ops import scan_match as TS
    from hitl_slam_tpu.ops import scan_match as JS

    m, map_pts = clean_48
    mask = np.ones(len(map_pts), bool)
    mask[::5] = False
    centers = np.stack([m.gt_poses[20, :2], m.gt_poses[3, :2] + 0.37]
                       ).astype(np.float32)
    refs = [np.asarray(JS.build_likelihood_field(
        jnp.asarray(map_pts), jnp.asarray(mask), jnp.asarray(c), _params(JS)))
        for c in centers]
    got = TS.build_likelihood_field(
        t(map_pts)[None].repeat(2, 1, 1), t(mask)[None].repeat(2, 1),
        t(centers), _params(TS))
    assert got.shape == (2, 280, 280)
    for b in range(2):
        np.testing.assert_allclose(n(got[b]), refs[b], atol=1e-6, rtol=0)
    one = TS.build_likelihood_field(t(map_pts), t(mask), t(centers[0]),
                                    _params(TS))
    assert torch.equal(one, got[0])


@pytest.mark.parametrize("offset", [(0.3, -0.2, 0.1), (-0.5, 0.4, -0.15),
                                    (0.0, 0.0, 0.0)])
def test_correlative_match_parity(clean_48, offset):
    """Same winning cell and angle (pose to 1e-6), score and ambiguity to
    1e-5, and the known offset is recovered (tests/test_scan_match.py)."""
    from hitl_slam_torch.ops import scan_match as TS
    from hitl_slam_tpu.ops import scan_match as JS

    m, map_pts = clean_48
    i = 20
    true_pose = m.gt_poses[i].astype(np.float32)
    center = true_pose[:2]
    ones = np.ones(len(map_pts), bool)
    scan = m.point_clouds[i]
    smask = np.ones(len(scan), bool)
    guess = true_pose + np.array(offset, np.float32)
    fj = JS.build_likelihood_field(jnp.asarray(map_pts), jnp.asarray(ones),
                                   jnp.asarray(center), _params(JS))
    ref = JS.correlative_match(fj, jnp.asarray(center), jnp.asarray(scan),
                               jnp.asarray(smask), jnp.asarray(guess),
                               _params(JS))
    ft = TS.build_likelihood_field(t(map_pts), t(ones), t(center), _params(TS))
    got = TS.correlative_match(ft, t(center), t(scan), t(smask), t(guess),
                               _params(TS))
    np.testing.assert_allclose(n(got[0]), np.asarray(ref[0]), atol=1e-6, rtol=0)
    assert abs(float(got[1]) - float(ref[1])) <= 1e-5
    assert abs(float(got[2]) - float(ref[2])) <= 1e-5
    pose = n(got[0])
    assert float(got[1]) > 0.3 and float(got[2]) <= 1.0
    assert abs(pose[0] - true_pose[0]) < 0.16 and abs(pose[1] - true_pose[1]) < 0.16
    dth = np.arctan2(np.sin(pose[2] - true_pose[2]),
                     np.cos(pose[2] - true_pose[2]))
    assert abs(dth) < 0.06


def test_correlation_routes_agree(clean_48):
    """The port's gathered sum and the reference's dense conv2d give the
    same scores to f32 round-off (1e-4 on sums of up to 180 terms in
    [0, 1]) and the same argmax, with duplicate cells counted once."""
    from hitl_slam_torch.ops import scan_match as TS

    m, map_pts = clean_48
    H, W, T = 280, 21, 5
    K = H - W + 1
    field = TS.build_likelihood_field(
        t(map_pts)[None].repeat(2, 1, 1),
        torch.ones((2, len(map_pts)), dtype=torch.bool),
        t(np.stack([m.gt_poses[20, :2], m.gt_poses[30, :2]])), _params(TS))
    rng = np.random.default_rng(1)
    ki = torch.as_tensor(rng.integers(0, K, (2, T, 180)), dtype=torch.int32)
    kj = torch.as_tensor(rng.integers(0, K, (2, T, 180)), dtype=torch.int32)
    ki[:, :, 100:] = ki[:, :, :80]          # duplicate cells
    kj[:, :, 100:] = kj[:, :, :80]
    ok = torch.as_tensor(rng.random((2, T, 180)) > 0.1)
    ki, kj = torch.where(ok, ki, 0), torch.where(ok, kj, 0)
    a = TS.correlate_gather(field, ki, kj, ok, W)
    b = dense_correlation(field, ki, kj, ok, W)
    assert a.shape == b.shape == (2, T, W, W)
    np.testing.assert_allclose(n(a), n(b), atol=1e-4, rtol=0)
    assert torch.equal(a.reshape(2, -1).argmax(1), b.reshape(2, -1).argmax(1))


# ---------------------------------------------------------------- proposals

def _fig8_states(**kw):
    from hitl_slam_torch.core.state import make_map_state as tmk
    from hitl_slam_tpu.core.state import make_map_state as jmk
    from hitl_slam_tpu.io.figure8 import generate_figure8

    m = generate_figure8(num_poses=256, num_rays=120, num_laps=2, **kw)
    args = (m.poses, m.covariances, m.point_clouds, m.normal_clouds)
    return m, jmk(*args), tmk(*args, device="cpu")


def _proposal_draws(seed, poses):
    """The reference's key tree for propose_corrections(seed=seed) on a map
    with these poses: split(PRNGKey(seed), 2B), anchor side first."""
    from hitl_slam_torch.models.hitl.propose import (PROPOSAL_RANSAC,
                                                     candidate_pairs)

    B = len(candidate_pairs(poses, max_proposals=4))
    keys = jax.random.split(jax.random.PRNGKey(seed), 2 * B)
    rp = PROPOSAL_RANSAC
    return (reference_draws(keys[:B], rp.num_segments, rp.num_hypotheses),
            reference_draws(keys[B:], rp.num_segments, rp.num_hypotheses))


@pytest.fixture(scope="module")
def drifted_256():
    return _fig8_states(seed=7, drift_theta_bias=6e-4)


def test_propose_corrections_parity_on_a_drifted_map(drifted_256):
    """One drifted 256-pose two-lap map, the reference's draws: the same
    number of proposals with the same pose pairs, selections within 1e-4 m,
    drift within 1e-4, score within 1e-5."""
    from hitl_slam_torch.models.hitl.propose import propose_corrections as tp
    from hitl_slam_tpu.models.hitl.propose import propose_corrections as jp

    m, js, ts = drifted_256
    ref = jp(js, max_proposals=4, seed=7)
    timings = {}
    got = tp(ts, max_proposals=4, seed=7, draws=_proposal_draws(7, m.poses),
             timings_ms=timings)
    assert len(ref) >= 1 and len(got) == len(ref)
    for a, b in zip(got, ref):
        assert (a.anchor_pose, a.corrected_pose) == (b.anchor_pose,
                                                     b.corrected_pose)
        assert int(a.input.correction_type) == int(b.input.correction_type)
        np.testing.assert_allclose(a.input.points, b.input.points,
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(a.drift, b.drift, atol=1e-4, rtol=0)
        assert abs(a.score - b.score) <= 1e-5
    assert timings["device_ms"] > 0 and timings["host_ms"] >= 0

    # the port's own draws: repeatable from the seed, and the strongest
    # proposal's drift points along the planted drift (the reference's
    # recall floor, tests/test_display_and_props.py)
    own = tp(ts, max_proposals=4, seed=7)
    again = tp(ts, max_proposals=4, seed=7)
    assert len(own) >= 1 and len(own) == len(again)
    cosines = []
    for a, b in zip(own, again):
        np.testing.assert_array_equal(a.input.points, b.input.points)
        gt = (m.gt_poses[a.corrected_pose] - m.poses[a.corrected_pose])[:2]
        cosines.append(float(a.drift[:2] @ gt / max(
            np.linalg.norm(a.drift[:2]) * np.linalg.norm(gt), 1e-12)))
    assert max(cosines) > 0.9, cosines


def test_propose_corrections_empty_on_a_clean_map():
    """A drift-free, noise-free map gives no proposal in either package."""
    from hitl_slam_torch.models.hitl.propose import propose_corrections as tp
    from hitl_slam_tpu.models.hitl.propose import propose_corrections as jp

    m, js, ts = _fig8_states(seed=5, drift_theta_bias=0.0, noise_trans=0.0,
                             noise_theta=0.0)
    assert jp(js, max_proposals=4, seed=5) == []
    assert tp(ts, max_proposals=4, seed=5) == []
    assert tp(ts, max_proposals=4, seed=5,
              draws=_proposal_draws(5, m.poses)) == []


def test_engine_propose_then_replay_matches_jax(drifted_256):
    """The engines' propose_corrections (the reference's draws), then the
    first proposal through replay_log: the same accept flag and LM
    iterations, poses within the loose golden tolerances (2 cm, 10 mrad),
    and the aligned error against ground truth falls."""
    from hitl_slam_torch.models.hitl.engine import HitLSLAM as THitLSLAM
    from hitl_slam_tpu.models.hitl.engine import HitLSLAM as JHitLSLAM

    m, _, _ = drifted_256
    te, je = THitLSLAM(device="cpu"), JHitLSLAM()
    for eng in (te, je):
        eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
                 odometry=m.odometry, constraint_capacity=8192)
    before = procrustes_error(te.get_poses(), m.gt_poses)
    tprops = te.propose_corrections(max_proposals=4, seed=0,
                                    draws=_proposal_draws(0, m.poses))
    jprops = je.propose_corrections(max_proposals=4, seed=0)
    assert len(tprops) == len(jprops) >= 1
    trep = te.replay_log(tprops[0].input, record=True)
    jrep = je.replay_log(jprops[0].input, record=True)
    assert trep.accepted and jrep.accepted
    assert trep.lm_iterations == jrep.lm_iterations
    assert trep.num_new_constraints == jrep.num_new_constraints
    tpose, jpose = te.get_poses(), np.asarray(je.get_poses())
    assert np.abs(tpose[:, :2] - jpose[:, :2]).max() <= 0.02
    dth = np.arctan2(np.sin(tpose[:, 2] - jpose[:, 2]),
                     np.cos(tpose[:, 2] - jpose[:, 2]))
    assert np.abs(dth).max() <= 0.01
    assert procrustes_error(tpose, m.gt_poses) < before
    assert len(te.get_input_history()) == 1


# ---------------------------------------------------------------- CLI

def test_cli_auto_repair_render_and_info_mat(drifted_256, tmp_path, capsys):
    """--auto-repair 3 on the CPU applies at least one correction and cuts
    the aligned error below 0.8 of its start (tests/test_scan_match.py);
    --render and --info-mat write PNGs of the repaired map; the help text
    lists the flags."""
    from hitl_slam_torch import cli
    from hitl_slam_torch.io import stfs

    m, _, _ = drifted_256
    path = str(tmp_path / "drift.stfs.covars")
    stfs.save_stfs_covars(path, "Fig8", 42.0, m.poses, m.covariances,
                          m.point_clouds, m.normal_clouds)
    out = tmp_path / "auto.txt"
    rc = cli.main(["-P", path, "--auto-repair", "3", "-V", str(out),
                   "--render", str(tmp_path / "map.png"),
                   "--info-mat", str(tmp_path / "info.png"),
                   "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0
    line = [ln for ln in text.splitlines() if ln.startswith("auto-repair:")]
    assert len(line) == 1 and int(line[0].split()[1]) >= 1, text
    poses = np.loadtxt(out)
    assert poses.shape == (256, 3) and np.isfinite(poses).all()
    # the file holds poses rounded to 4 decimals of a map written with 4
    loaded = stfs.load_stfs_covars(path)
    before = procrustes_error(loaded.poses, m.gt_poses)
    assert procrustes_error(poses, m.gt_poses) < 0.8 * before
    for name in ("map.png", "info.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    help_text = cli.build_parser().format_help()
    for flag in ("--render", "--info-mat", "--auto-repair"):
        assert flag in help_text


def test_cli_render_without_a_replay_mode(tmp_path, capsys):
    """No replay mode: the loaded map is rendered, and no adjacency image
    is written (as the reference's CLI)."""
    import os

    from hitl_slam_torch import cli

    data = os.path.join(os.path.dirname(__file__), "data",
                        "golden.stfs.covars")
    rc = cli.main(["-P", data, "-V", str(tmp_path / "p.txt"), "--render",
                   str(tmp_path / "m.png"), "--info-mat",
                   str(tmp_path / "i.png"), "--device", "cpu"])
    assert rc == 0
    assert (tmp_path / "m.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert not (tmp_path / "i.png").exists()
    assert "rendered map to" in capsys.readouterr().out
