"""Port parity of EnML batch localization: the sliding-window localizer
(models/enml/localizer.py), the LTF factors (ops/ltf.py), the driver
(models/enml/driver.py) and the command line (cli_enml.py), against the JAX
package on the same numpy inputs (both on the CPU, f32).

The JAX side runs with EnmlOptions(gn_unroll=2): its GN loop as a fori_loop
unrolled twice, the same math as the default full unroll
(tests/test_enml.py::test_gn_unroll_matches_full_unroll holds the two to
1e-5), compiled in two loop bodies instead of 24."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import n, t

torch.set_num_threads(2)

STREAM = dict(num_steps=160, num_rays=240, seed=11, noise_trans=4e-3,
              noise_theta=2e-3)
# whole-sweep tolerances: poses in m / rad, covariances relative to each
# pose's largest entry (f32 round-off carried through 64 window solves of
# 26 GN systems each; measured 7e-6 and 7e-5)
POSE_ATOL, COV_RTOL = 1e-4, 1e-3


def _jopts(**kw):
    from hitl_slam_tpu.models.enml.localizer import EnmlOptions

    return EnmlOptions(gn_unroll=2, **kw)


@pytest.fixture(scope="module")
def stream():
    from hitl_slam_tpu.io.figure8 import generate_raw_stream

    return generate_raw_stream(**STREAM)


@pytest.fixture(scope="module")
def small(stream):
    """tests/test_enml.py's small_episode_state: the first 80 scans (64
    episode nodes, 256 padded points a node), as JAX arrays and as CPU
    tensors."""
    from hitl_slam_tpu.core.state import make_map_state
    from hitl_slam_tpu.models.enml.driver import EpisodeOptions, build_episodes

    scans, angles, rel, gt, walls = stream
    poses, pcs, ncs, rels = build_episodes(
        scans[:80], angles, rel[:80], EpisodeOptions(clip_low=10, clip_high=10))
    st = make_map_state(poses, np.zeros((len(poses), 3, 3), np.float32),
                        pcs, ncs)
    arrays = (st.points, st.normals, st.point_mask, st.poses)
    return arrays, tuple(t(a) for a in arrays), poses, pcs, ncs


@pytest.fixture(scope="module")
def jax_sweep(small):
    from hitl_slam_tpu.models.enml.localizer import batch_localize

    p, c = batch_localize(*small[0], _jopts())
    return np.asarray(p), np.asarray(c)


@pytest.fixture(scope="module")
def port_sweep(small):
    from hitl_slam_torch.models.enml.localizer import batch_localize

    p, c = batch_localize(*small[1])
    return n(p), n(c)


def _pose_diff(a, b):
    dth = np.arctan2(np.sin(a[..., 2] - b[..., 2]), np.cos(a[..., 2] - b[..., 2]))
    return max(float(np.abs(a[..., :2] - b[..., :2]).max()),
               float(np.abs(dth).max()))


def _cov_rel(a, b):
    scale = np.maximum(np.abs(b).max(axis=(-2, -1), keepdims=True), 1e-30)
    return float((np.abs(a - b) / scale).max())


def _window(small, a, W=10):
    """(JAX, torch) flat inputs of the window at nodes a..a+W-1."""
    jp, jn, jm, jq = (x[a:a + W] for x in small[0])
    N = jp.shape[1]
    jflat = (jq, jp.reshape(-1, 2), jn.reshape(-1, 2), jm.reshape(-1),
             jnp.repeat(jnp.arange(W, dtype=jnp.int32), N))
    return jflat, tuple(t(x) for x in jflat)


def test_odometry_targets(small):
    from hitl_slam_torch.models.enml import localizer as TL
    from hitl_slam_tpu.models.enml import localizer as JL

    want = JL._odometry_targets(small[0][3], _jopts())
    got = TL._odometry_targets(small[1][3], TL.EnmlOptions())
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-6, atol=1e-7)
    # a degenerate (motionless) step takes the heading as its radial axis
    still = np.array([[0, 0, 0.3], [0, 0, 0.5], [1, 0, 0.5]], np.float32)
    for g, w in zip(TL._odometry_targets(t(still), TL.EnmlOptions()),
                    JL._odometry_targets(jnp.asarray(still), _jopts())):
        np.testing.assert_allclose(n(g), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("a", [0, 20, 54])
def test_brute_window_match(small, a):
    """tgt and valid equal; rows with no candidate (masked points, and at
    a = 0 the masked future rows) have tgt 0 in both packages."""
    from hitl_slam_torch.models.enml import localizer as TL
    from hitl_slam_tpu.models.enml import localizer as JL

    (jq, jp, jn, jm, jo), (tq, tp, tn, tm, to) = _window(small, a)
    if a == 0:
        # rows of the window past node 3 are future poses: masked out
        live = np.repeat(np.arange(10) <= 3, jp.shape[0] // 10)
        jm, tm = jm & jnp.asarray(live), tm & torch.as_tensor(live)
    jt, jv = JL._brute_window_match(jq, jp, jn, jm, jo, 0.15 ** 2,
                                    jnp.cos(_jopts().max_stf_angle_error))
    o = TL.EnmlOptions()
    tt, tv = TL._brute_window_match(tq, tp, tn, tm, to.long(),
                                    *TL._match_gates(o, "cpu"))
    jt, jv = np.asarray(jt), np.asarray(jv)
    np.testing.assert_array_equal(n(tv), jv)
    np.testing.assert_array_equal(n(tt), jt)
    assert jv.sum() > 500 and (~jv).sum() > 0
    assert (jt[~jv] == 0).all() and (n(tt)[~jv] == 0).all()
    # the normal gate sits on the same f32
    assert float(TL._match_gates(o, "cpu")[1]) == float(
        jnp.cos(jnp.float32(o.max_stf_angle_error)))


def _window_inputs(small, a, W=10):
    from hitl_slam_tpu.models.enml import localizer as JL

    axis, d, rot, isig = JL._odometry_targets(small[0][3], _jopts())
    jargs = tuple(x[a:a + W] for x in small[0][:3])
    jw = (small[0][3][a:a + W], *jargs, axis[a:a + W - 1], d[a:a + W - 1],
          rot[a:a + W - 1], isig[a:a + W - 1], jnp.ones(W - 1, jnp.float32))
    # the window poses perturbed so that the GN steps have work to do
    shift = np.zeros((W, 3), np.float32)
    shift[1:] = np.random.default_rng(2).normal(0, 0.02, (W - 1, 3))
    jw = (jw[0] + shift,) + jw[1:]
    return jw, tuple(t(np.asarray(x)) for x in jw)


@pytest.mark.parametrize("mode", ["solve", "eval_only_pinned"])
def test_window_gn(small, mode):
    """One window solve from fixed inputs: poses to 1e-5, the final Hessian
    to 1e-5 of its largest entry."""
    from hitl_slam_torch.models.enml import localizer as TL
    from hitl_slam_tpu.models.enml import localizer as JL

    jw, tw = _window_inputs(small, 30)
    pin = np.zeros(10, bool)
    pin[4] = mode != "solve"
    kw = dict(eval_only=mode != "solve")
    jfn = jax.jit(lambda *a: JL._window_gn(*a, _jopts(),
                                           w_pin=jnp.asarray(pin), **kw))
    jp, jH = (np.asarray(x) for x in jfn(*jw))
    tp, tH = TL._window_gn(*tw, TL.EnmlOptions(), w_pin=torch.as_tensor(pin),
                           **kw)
    assert _pose_diff(n(tp), jp) <= 1e-5
    assert np.abs(n(tH) - jH).max() <= 1e-5 * np.abs(jH).max()
    if mode == "solve":
        assert np.abs(jp - np.asarray(jw[0])).max() > 1e-3   # it moved
        # a caller's matcher in place of the brute one, and no final
        # Hessian: the same poses, an identity H
        W, N = tw[1].shape[:2]
        pose_of = torch.arange(W)[:, None].expand(W, N).reshape(-1)
        flat = (tw[1].reshape(-1, 2), tw[2].reshape(-1, 2),
                tw[3].reshape(-1))
        calls = []

        def match(poses):
            calls.append(1)
            return TL._brute_window_match(
                poses, *flat, pose_of, *TL._match_gates(TL.EnmlOptions(),
                                                        "cpu"))

        mp, mH = TL._window_gn(*tw, TL.EnmlOptions(), match_fn=match,
                               w_pin=torch.as_tensor(pin), need_hessian=False)
        assert len(calls) == TL.EnmlOptions().match_rounds
        assert torch.equal(mp, tp) and torch.equal(mH, torch.eye(3 * W))


def test_single_window_localize(small):
    from hitl_slam_torch.models.enml import localizer as TL
    from hitl_slam_tpu.models.enml import localizer as JL

    jw, tw = _window_inputs(small, 12)
    want = np.asarray(JL.single_window_localize(*jw[1:4], jw[0], _jopts()))
    got = n(TL.single_window_localize(*tw[1:4], tw[0]))
    assert _pose_diff(got, want) <= 1e-5
    assert np.abs(got[:, 2]).max() <= np.pi


def test_batch_localize_matches_reference(small, jax_sweep, port_sweep):
    """The whole sweep at default options: poses within 1e-4, covariances
    within 1e-3 relative; finite, symmetric PSD, and at least as consistent
    as odometry (tests/test_enml.py's gates)."""
    from hitl_slam_torch.models.enml.driver import consistency_metric

    (jp, jc), (tp, tc) = jax_sweep, port_sweep
    assert tp.shape == jp.shape and tc.shape == jc.shape == (len(jp), 3, 3)
    assert _pose_diff(tp, jp) <= POSE_ATOL
    assert _cov_rel(tc, jc) <= COV_RTOL
    assert np.isfinite(tp).all() and np.isfinite(tc).all()
    np.testing.assert_allclose(tc, np.swapaxes(tc, 1, 2), atol=1e-5)
    assert np.linalg.eigvalsh(tc[1:]).min() > -1e-7
    np.testing.assert_array_equal(tc[0], np.eye(3, dtype=np.float32) * 1e-6)
    poses, pcs = small[2], small[3]
    assert consistency_metric(tp, pcs) <= 1.05 * consistency_metric(poses, pcs)


def test_sweep_segment_tiled_matches_fused(small, port_sweep):
    """sweep_segment tiled by 8 over [0, P) gives the port's fused sweep
    (tests/test_enml_session.py's tolerances: angles are wrapped at every
    segment's end)."""
    from hitl_slam_torch.models.enml import localizer as TL

    pts, nrm, mask, poses = small[1]
    P = poses.shape[0]
    pre = TL.sweep_precompute(poses, TL.EnmlOptions())
    ps, cv = poses, torch.zeros((P, 3, 3))
    for t0 in range(0, P, 8):
        ps, cv = TL.sweep_segment(pts, nrm, mask, ps, cv, pre, t0,
                                  TL.EnmlOptions(), 8)
    tp, tc = port_sweep
    np.testing.assert_allclose(n(ps), tp, atol=1e-5)
    np.testing.assert_allclose(n(cv)[1:], tc[1:], atol=1e-4)
    # a tile past the end solves nothing: only its angle wrap touches poses
    ps2, cv2 = TL.sweep_segment(pts, nrm, mask, ps, cv, pre, P,
                                TL.EnmlOptions(), 8)
    assert torch.equal(cv2, cv)
    np.testing.assert_allclose(n(ps2), n(ps), atol=1e-6)


@pytest.mark.parametrize("node", [2, 20, 63])
def test_window_correspondences(small, jax_sweep, node):
    """Same endpoints and the same valid rows as the reference, on the same
    poses."""
    from hitl_slam_torch.models.enml import localizer as TL
    from hitl_slam_tpu.models.enml import localizer as JL

    jpts, jnrm, jmask, _ = small[0]
    poses = jax_sweep[0]
    js, jt, jv = (np.asarray(x) for x in JL.window_correspondences(
        jpts, jnrm, jmask, jnp.asarray(poses), jnp.asarray(node, jnp.int32),
        _jopts()))
    ts, tt, tv = (n(x) for x in TL.window_correspondences(
        *small[1][:3], t(poses), node))
    np.testing.assert_array_equal(tv, jv)
    assert jv.sum() > 100
    np.testing.assert_allclose(ts, js, atol=1e-5)
    np.testing.assert_allclose(tt[jv], jt[jv], atol=1e-5)


# ---------------------------------------------------------------- LTF

@pytest.fixture(scope="module")
def ltf_map():
    """tests/test_ltf.py's map: a noise-free 48-pose figure-8, its walls as
    the vector map."""
    from hitl_slam_tpu.io.figure8 import generate_figure8

    m = generate_figure8(num_poses=48, num_rays=200, seed=9,
                         drift_theta_bias=0.0, noise_trans=0.0,
                         noise_theta=0.0)
    return m, np.asarray(m.walls, np.float32)


def test_match_segments(ltf_map):
    """Indices and valid flags equal; distances to f32 round-off; a leading
    batch of scans gives each scan's result."""
    from hitl_slam_torch.ops import ltf as TF
    from hitl_slam_tpu.ops import ltf as JF

    m, segs = ltf_map
    worlds = []
    for i in (12, 30):
        gt = m.gt_poses[i]
        c, s = np.cos(gt[2]), np.sin(gt[2])
        worlds.append((m.point_clouds[i] @ np.array([[c, -s], [s, c]]).T
                       + gt[:2]).astype(np.float32))
    k = min(len(w) for w in worlds)
    worlds = np.stack([w[:k] for w in worlds])
    mask = np.ones(k, bool)
    mask[::17] = False
    tidx, tval = TF.match_segments(t(segs), t(worlds), torch.as_tensor(mask))
    for b, w in enumerate(worlds):
        jidx, jval = JF.match_segments(jnp.asarray(segs), jnp.asarray(w),
                                       jnp.asarray(mask))
        np.testing.assert_array_equal(n(tval)[b], np.asarray(jval))
        np.testing.assert_array_equal(n(tidx)[b], np.asarray(jidx))
        assert np.asarray(jval).mean() > 0.8
        jd, jnrm, jt = JF.point_segment_geometry(jnp.asarray(segs),
                                                 jnp.asarray(w))
        td, tnrm, tt = TF.point_segment_geometry(t(segs), t(w))
        np.testing.assert_allclose(n(td), np.asarray(jd), atol=2e-6)
        np.testing.assert_allclose(n(tnrm), np.asarray(jnrm), atol=1e-6)
        np.testing.assert_allclose(n(tt), np.asarray(jt), rtol=1e-5, atol=1e-6)


def test_localize_against_map(ltf_map):
    """tests/test_ltf.py's three starting offsets: poses within 1e-5 of the
    reference's, one by one and as one leading batch (the reference's
    vmap)."""
    from hitl_slam_torch.ops import ltf as TF
    from hitl_slam_tpu.ops import ltf as JF

    m, segs = ltf_map
    i = 12
    gt = m.gt_poses[i].astype(np.float32)
    guesses = np.stack([gt + np.array(o, np.float32) for o in (
        (0.15, -0.1, 0.04), (-0.2, 0.1, -0.05), (0.0, 0.0, 0.0))])
    pts = np.asarray(m.point_clouds[i], np.float32)
    mask = np.ones(len(pts), bool)
    jfn = jax.vmap(JF.localize_against_map, in_axes=(None, None, None, 0))
    jpose, jcost, jinl = (np.asarray(x) for x in jfn(
        jnp.asarray(segs), jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(guesses)))
    B = len(guesses)
    tpose, tcost, tinl = TF.localize_against_map(
        t(segs), t(np.broadcast_to(pts, (B,) + pts.shape)),
        torch.as_tensor(np.broadcast_to(mask, (B, len(mask))).copy()),
        t(guesses))
    assert _pose_diff(n(tpose), jpose) <= 1e-5
    np.testing.assert_array_equal(n(tinl), jinl)
    np.testing.assert_allclose(n(tcost), jcost, rtol=1e-4, atol=1e-9)
    assert (jinl > 50).all() and _pose_diff(jpose, gt[None]) < 0.03
    for b in range(B):
        p1, c1, k1 = TF.localize_against_map(t(segs), t(pts),
                                             torch.as_tensor(mask),
                                             t(guesses[b]))
        assert _pose_diff(n(p1), jpose[b]) <= 1e-5 and int(k1) == jinl[b]


def test_batch_localize_with_ltf_segs(stream, small):
    """The sweep with the stream's walls as the vector map (in the
    odometry frame of node 0) over the first 16 nodes: the reference's
    poses and covariances, and the map changes the result."""
    from hitl_slam_torch.models.enml import localizer as TL
    from hitl_slam_tpu.models.enml import localizer as JL

    gt0 = stream[3][0]
    c, s = np.cos(-gt0[2]), np.sin(-gt0[2])
    R = np.array([[c, -s], [s, c]])
    walls = np.asarray(stream[4], np.float64).reshape(-1, 2, 2)
    segs = ((walls - gt0[:2]) @ R.T).reshape(-1, 4).astype(np.float32)
    K = 16
    jin = tuple(x[:K] for x in small[0])
    tin = tuple(x[:K] for x in small[1])
    jp, jc = (np.asarray(x) for x in JL.batch_localize(
        *jin, _jopts(), ltf_segs=jnp.asarray(segs)))
    tp, tc = (n(x) for x in TL.batch_localize(*tin, ltf_segs=t(segs)))
    assert _pose_diff(tp, jp) <= POSE_ATOL
    assert _cov_rel(tc, jc) <= COV_RTOL
    plain, _ = TL.batch_localize(*tin)
    assert _pose_diff(tp, n(plain)) > 1e-4


# ---------------------------------------------------------------- driver

def test_driver_host_functions_match_reference(stream, tmp_path):
    """build_episodes (with keyframes and a range calibration table),
    generate_normals_np, consistency_metric, consistency_image and
    apply_noise_model (same default_rng seed) equal the reference's; the
    port's tensor generate_normals and rot2 equal the JAX ones."""
    from hitl_slam_torch.models.enml import driver as TD
    from hitl_slam_torch.ops import geometry as TG
    from hitl_slam_tpu.models.enml import driver as JD
    from hitl_slam_tpu.ops import geometry as JG

    scans, angles, rel = stream[:3]
    corr = np.linspace(0.99, 1.01, 36).astype(np.float32)
    for kw in ({}, dict(keyframes={3, 4, 5}, laser_corrections=corr)):
        te = TD.build_episodes(scans, angles, rel,
                               TD.EpisodeOptions(clip_low=10, clip_high=10), **kw)
        je = JD.build_episodes(scans, angles, rel,
                               JD.EpisodeOptions(clip_low=10, clip_high=10), **kw)
        np.testing.assert_array_equal(te[0], je[0])
        np.testing.assert_array_equal(te[3], je[3])
        for a, b in zip(te[1] + te[2], je[1] + je[2]):
            np.testing.assert_array_equal(a, b)
    poses, pcs = je[0], je[1]
    assert TD.consistency_metric(poses, pcs) == JD.consistency_metric(poses,
                                                                      pcs)
    np.testing.assert_array_equal(
        TD.consistency_image(poses[:12], pcs[:12], str(tmp_path / "c.png")),
        JD.consistency_image(poses[:12], pcs[:12]))
    assert (tmp_path / "c.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    for a, b in zip(TD.generate_normals_np(pcs[3], 0.5),
                    JD.generate_normals_np(pcs[3], 0.5)):
        np.testing.assert_array_equal(a, b)
    rt, rj = np.random.default_rng(7), np.random.default_rng(7)
    for m in ((0.3, 0.1, 0.05), (0.0, 0.0, 0.2), (-0.1, 0.2, 0.0)):
        assert TD.apply_noise_model(*m, 0.05, rt) == JD.apply_noise_model(
            *m, 0.05, rj)

    pts = np.asarray(pcs[5], np.float32)
    mask = np.ones(len(pts), bool)
    mask[[0, 7, 8]] = False
    tn, tm = TG.generate_normals(t(pts), torch.as_tensor(mask), 0.5)
    jn, jm = JG.generate_normals(jnp.asarray(pts), jnp.asarray(mask), 0.5)
    np.testing.assert_array_equal(n(tm), np.asarray(jm))
    np.testing.assert_allclose(n(tn), np.asarray(jn), atol=1e-6)
    th = np.linspace(-3, 3, 7).astype(np.float32)
    np.testing.assert_allclose(n(TG.rot2(t(th))), np.asarray(JG.rot2(th)),
                               atol=1e-7)


def test_localize_and_save_files_read_by_reference(small, tmp_path):
    """The port's .stfs.covars, .poses and .stfs of the first 12 nodes: the
    reference's load_stfs_covars reads the port's file to the port
    reader's arrays and to the returned poses and covariances at the file's
    precision; with parallel_windows (the checkerboard) too, and that mode
    refuses an LTF vector map, as the reference's does."""
    from hitl_slam_torch.io import stfs as ts
    from hitl_slam_torch.models.enml.driver import localize_and_save
    from hitl_slam_tpu.io import stfs as js

    K = 12
    poses, pcs, ncs = small[2][:K], small[3][:K], small[4][:K]
    prefix = str(tmp_path / "enml")
    new_poses, covs = localize_and_save(poses, pcs, ncs, prefix,
                                        map_name="TestEnML", device="cpu")
    jd = js.load_stfs_covars(prefix + ".stfs.covars")
    td = ts.load_stfs_covars(prefix + ".stfs.covars")
    assert jd.map_name == td.map_name == "TestEnML"
    np.testing.assert_array_equal(jd.poses, td.poses)
    np.testing.assert_array_equal(jd.covariances, td.covariances)
    for a, b in zip(jd.point_clouds + jd.normal_clouds,
                    td.point_clouds + td.normal_clouds):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(jd.poses, new_poses, atol=1e-4)
    np.testing.assert_allclose(jd.covariances, covs, atol=1e-6)
    np.testing.assert_allclose(np.loadtxt(prefix + ".poses"), new_poses,
                               atol=1e-6)
    lines = open(prefix + ".stfs").read().splitlines()
    assert len(lines) == 2 + sum(len(p) for p in pcs)
    cb_poses, cb_covs = localize_and_save(poses, pcs, ncs, prefix,
                                          parallel_windows=True, device="cpu")
    jd = js.load_stfs_covars(prefix + ".stfs.covars")
    np.testing.assert_allclose(jd.poses, cb_poses, atol=1e-4)
    np.testing.assert_allclose(jd.covariances, cb_covs, atol=1e-6)
    with pytest.raises(ValueError, match="parallel_windows"):
        localize_and_save(poses, pcs, ncs, prefix, parallel_windows=True,
                          ltf_segs=np.zeros((1, 4), np.float32), device="cpu")


def test_cli_enml_matches_reference(tmp_path, capsys):
    """`cli_enml --synthetic --steps 48` on the CPU writes the reference
    CLI's .stfs.covars to the sweep's tolerance (the file's %.4f poses);
    its line reads "N episode nodes localized ... consistency a -> b" with
    b <= 1.05 a; the HitL CLI loads the result."""
    import re

    from hitl_slam_torch import cli as tcli, cli_enml as tcli_enml
    from hitl_slam_tpu import cli_enml as jcli_enml
    from hitl_slam_tpu.io import stfs as js

    flags = ["--synthetic", "--steps", "48", "--max-history", "4",
             "--gn-unroll", "2"]
    tout, jout = str(tmp_path / "t"), str(tmp_path / "j")
    assert tcli_enml.main(flags + ["-o", tout, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert jcli_enml.main(flags + ["-o", jout]) == 0
    capsys.readouterr()
    got = re.search(r"run: (\d+) episode nodes localized in .*consistency "
                    r"([\d.]+) -> ([\d.]+); wrote", text)
    assert got, text
    nodes, before, after = int(got[1]), float(got[2]), float(got[3])
    assert nodes == 48 and after <= 1.05 * before
    td, jd = (js.load_stfs_covars(p + ".stfs.covars") for p in (tout, jout))
    assert td.poses.shape == jd.poses.shape == (48, 3)
    assert _pose_diff(td.poses, jd.poses) <= 2e-4
    np.testing.assert_allclose(td.covariances, jd.covariances, rtol=1e-3,
                               atol=2e-6)
    assert tcli.main(["-P", tout + ".stfs.covars", "-V",
                      str(tmp_path / "r.txt"), "--device", "cpu"]) == 0
    assert len(np.loadtxt(tmp_path / "r.txt")) == 48
