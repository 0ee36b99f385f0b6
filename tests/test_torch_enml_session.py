"""Port parity of the interactive EnML pieces: loop_inv_sigmas and
EnmlSession (models/enml/session.py), OnlineLocalizer
(models/enml/online.py), and cli_enml's --online, --replay and
--parallel-windows modes with their guards, against the JAX package on the
same numpy inputs (both on the CPU, f32).

The session workflow is tests/test_enml_session.py's: a 96-pose drifted
figure-8, max_history=8, 6 GN iterations, localized in segments of 32, one
loop correction after the sweep, its log replayed by a fresh session, and
the same correction queued before a one-segment sweep. The JAX side runs
with gn_unroll=2 (the same math as the full unroll) in one module-scoped
fixture. Waits are on events (OnlineLocalizer.flush), never on sleeps."""

import re

import numpy as np
import pytest
import torch

from torch_port_helpers import synth_wall_correction

torch.set_num_threads(2)

SESSION_KW = dict(max_history=8, gn_iterations=6)
# the golden loose tolerance (tests/test_golden.py): m, rad
LOOSE = (0.02, 0.01)


def _pose_diff(a, b):
    dth = np.arctan2(np.sin(a[..., 2] - b[..., 2]), np.cos(a[..., 2] - b[..., 2]))
    return float(np.abs(a[..., :2] - b[..., :2]).max()), float(np.abs(dth).max())


def _within(a, b, tol):
    dxy, dth = _pose_diff(a, b)
    return dxy <= tol[0] and dth <= tol[1]


@pytest.fixture(scope="module")
def drifted_map():
    from hitl_slam_tpu.io.figure8 import generate_figure8

    m = generate_figure8(num_poses=96, num_rays=120, seed=5,
                         drift_theta_bias=8e-4)
    return m, [np.asarray(p) for p in m.point_clouds], \
        [np.asarray(c) for c in m.normal_clouds]


@pytest.fixture(scope="module")
def jax_workflow(drifted_map, tmp_path_factory):
    """The reference test's workflow on the JAX package, recorded."""
    from hitl_slam_tpu.core.state import CorrectionType
    from hitl_slam_tpu.io.figure8 import synthesize_correction
    from hitl_slam_tpu.models.enml.localizer import EnmlOptions
    from hitl_slam_tpu.models.enml.session import EnmlSession

    m, pcs, ncs = drifted_map
    o = EnmlOptions(gn_unroll=2, **SESSION_KW)
    out = {}
    sess = EnmlSession(m.poses, pcs, ncs, options=o)
    b = []
    sess.localize(segment=32, progress_cb=lambda s, t: b.append(t))
    out["boundaries"] = b
    out["localized"] = (sess.poses.copy(), sess.covariances.copy())
    sel = synthesize_correction(m, range(60, 96), range(0, 30), (1, 0.0),
                                (1, 0.0), poses=sess.poses)
    out["sel"] = sel
    out["report"] = sess.add_loop_correction(CorrectionType.COLINEAR, sel)
    out["corrected"] = sess.poses.copy()
    log = str(tmp_path_factory.mktemp("jlog") / "session.log")
    sess.save_log(log)
    sess2 = EnmlSession(m.poses, pcs, ncs, options=o)
    sess2.load_log(log)
    sess2.localize(segment=32)
    out["replay"] = (sess2.replay_all(), sess2.poses.copy())
    sess3 = EnmlSession(m.poses, pcs, ncs, options=o)
    sess3.queue_correction(CorrectionType.COLINEAR, sel)
    sess3.localize(segment=128)
    out["queued"] = sess3.poses.copy()
    return out


def test_loop_inv_sigmas_bit_equal(drifted_map, jax_workflow):
    """Host numpy on both sides: bit-equal on a random PSD instance (with a
    motionless step and a non-finite covariance) and on the localized
    map's own poses and covariances."""
    from hitl_slam_torch.models.enml.localizer import EnmlOptions as TO
    from hitl_slam_torch.models.enml.session import loop_inv_sigmas as tl
    from hitl_slam_tpu.models.enml.localizer import EnmlOptions as JO
    from hitl_slam_tpu.models.enml.session import loop_inv_sigmas as jl

    rng = np.random.default_rng(3)
    P = 12
    poses = rng.normal(size=(P, 3)).astype(np.float32)
    poses[5, :2] = poses[4, :2]
    A = rng.normal(size=(P, 3, 3)) * 0.05
    covs = (A @ np.swapaxes(A, -1, -2)).astype(np.float32)
    covs[7, 2, 2] = np.nan
    for scale in (1.0, 2.0):
        np.testing.assert_array_equal(
            tl(poses, covs, TO(**SESSION_KW), scale=scale),
            jl(poses, covs, JO(**SESSION_KW), scale=scale))
    lp, lc = jax_workflow["localized"]
    got = tl(lp, lc, TO(**SESSION_KW))
    assert got.dtype == np.float32 and got.shape == (len(lp) - 1, 3)
    np.testing.assert_array_equal(got, jl(lp, lc, JO(**SESSION_KW)))


def test_session_correct_log_replay(drifted_map, jax_workflow, tmp_path):
    """The segment boundaries, the accept flags, new_constraints and the LM
    iteration counts equal the reference's; the poses stay within the loose
    golden tolerance of the reference's after each correction; a replayed
    log and a queued correction reproduce the session's poses."""
    from hitl_slam_torch.core.state import CorrectionType
    from hitl_slam_torch.models.enml.localizer import EnmlOptions
    from hitl_slam_torch.models.enml.session import EnmlSession

    m, pcs, ncs = drifted_map
    jw = jax_workflow
    o = EnmlOptions(**SESSION_KW)
    sess = EnmlSession(m.poses, pcs, ncs, options=o, device="cpu")
    b = []
    sess.localize(segment=32, progress_cb=lambda s, t: b.append(t))
    assert b == jw["boundaries"] == [32, 64, 96]
    jp, jc = jw["localized"]
    # the sweep's tolerances (tests/test_torch_enml.py)
    assert max(_pose_diff(sess.poses, jp)) <= 1e-4
    scale = np.maximum(np.abs(jc).max(axis=(1, 2), keepdims=True), 1e-30)
    assert (np.abs(sess.covariances - jc) / scale).max() <= 1e-3
    assert sess.covariances[60, 0, 0] > sess.covariances[5, 0, 0] > 0
    assert sess.localized_upto == 96

    rep = sess.add_loop_correction(CorrectionType.COLINEAR, jw["sel"])
    jr = jw["report"]
    assert (rep.accepted, rep.new_constraints, rep.lm_iterations) == (
        jr.accepted, jr.new_constraints, jr.lm_iterations)
    assert rep.accepted and rep.new_constraints > 0
    assert _within(sess.poses, jw["corrected"], LOOSE)
    corrected = sess.poses.copy()

    src, tgt = sess.correspondences()
    assert len(src) > 10 and src.shape == tgt.shape

    log = str(tmp_path / "session.log")
    sess.save_log(log)
    sess2 = EnmlSession(m.poses, pcs, ncs, options=o, device="cpu")
    assert sess2.load_log(log) == 1
    sess2.localize(segment=32)
    reps = sess2.replay_all()
    jreps, jpose2 = jw["replay"]
    assert [(r.accepted, r.new_constraints, r.lm_iterations) for r in reps] \
        == [(r.accepted, r.new_constraints, r.lm_iterations) for r in jreps] \
        == [(True, rep.new_constraints, rep.lm_iterations)]
    # the log holds the clicks as text: sub-mm replay agreement
    np.testing.assert_allclose(sess2.poses, corrected, atol=2e-3)
    assert _within(sess2.poses, jpose2, LOOSE)
    assert sess2.replay_next() is None

    sess3 = EnmlSession(m.poses, pcs, ncs, options=o, device="cpu")
    sess3.queue_correction(CorrectionType.COLINEAR, jw["sel"])
    sess3.localize(segment=128)      # one segment: applies after the sweep
    assert len(sess3.input_history) == 1
    np.testing.assert_allclose(sess3.poses, corrected, atol=2e-3)
    assert _within(sess3.poses, jw["queued"], LOOSE)


def test_online_localizer_matches_reference():
    """tests/test_enml.py's online case, both packages on the same 60 scans:
    the same node count, poses within 1e-3; each waits on flush()."""
    from hitl_slam_torch.models.enml.driver import EpisodeOptions as TE
    from hitl_slam_torch.models.enml.localizer import EnmlOptions as TO
    from hitl_slam_torch.models.enml.online import OnlineLocalizer as TOL
    from hitl_slam_tpu.io.figure8 import generate_raw_stream
    from hitl_slam_tpu.models.enml.driver import EpisodeOptions as JE
    from hitl_slam_tpu.models.enml.localizer import EnmlOptions as JO
    from hitl_slam_tpu.models.enml.online import OnlineLocalizer as JOL

    scans, angles, rel, gt, walls = generate_raw_stream(
        num_steps=160, num_rays=240, seed=11, noise_trans=4e-3,
        noise_theta=2e-3)
    kw = dict(max_history=6, gn_iterations=4, match_rounds=1)
    runs = []
    for loc in (JOL(JE(clip_low=10, clip_high=10), JO(**kw)),
                TOL(TE(clip_low=10, clip_high=10), TO(**kw), device="cpu")):
        loc.start()
        try:
            for i in range(60):
                loc.odometry_update(*[float(v) for v in rel[i]])
                loc.sensor_update(scans[i], angles)
            assert loc.flush(timeout=300.0)
            runs.append((loc.node_count(), loc.trajectory(), loc.pose()))
        finally:
            loc.stop()
    (jn, jt, jpose), (tn, tt, tpose) = runs
    assert tn == jn > 5
    assert max(_pose_diff(tt, jt)) <= 1e-3
    assert np.isfinite(tpose).all()
    np.testing.assert_allclose(tpose, jpose, atol=1e-3)
    # the reference's check: the estimate tracks ground truth within the
    # drift scale, in gt[0]'s frame
    c, s = np.cos(-gt[0][2]), np.sin(-gt[0][2])
    gt_rel = np.array([[c, -s], [s, c]]) @ (gt[59][:2] - gt[0][:2])
    assert np.linalg.norm(tpose[:2] - gt_rel) < 2.0


@pytest.mark.parametrize("cli_name", ["cli", "cli_enml"])
def test_cli_accepts_every_reference_flag(cli_name):
    """Each port CLI takes every flag of the reference's, with the same
    defaults, and adds only --device."""
    import importlib

    def options(parser):
        return {o: a.default for a in parser._actions
                for o in a.option_strings if o not in ("-h", "--help")}

    want = options(importlib.import_module(
        f"hitl_slam_tpu.{cli_name}").build_parser())
    got = options(importlib.import_module(
        f"hitl_slam_torch.{cli_name}").build_parser())
    assert set(got) - set(want) == {"--device"}
    assert {o: got[o] for o in want} == want


def test_cli_enml_online_and_guards(tmp_path, capsys):
    """--online streams through the worker and saves the live trajectory;
    the incompatible-mode guards exit with the reference's messages."""
    from hitl_slam_torch import cli_enml

    out = str(tmp_path / "live")
    rc = cli_enml.main(["--synthetic", "--steps", "48", "--online", "-o", out,
                        "--max-history", "6", "--device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    got = re.search(r"online: (\d+) episode nodes localized live .*lag at "
                    r"flush ([\d.]+)s", text)
    assert got, text
    poses = np.loadtxt(out + ".poses")
    assert poses.shape == (int(got[1]), 3) and len(poses) > 5
    assert np.isfinite(poses).all()
    lines = open(out + ".stfs").read().splitlines()
    assert lines[0] == "EnML" and len(lines) > 10 * len(poses)

    base = ["--synthetic", "--steps", "8", "-o", out, "--device", "cpu"]
    for flags, msg in (
            (["--online", "--parallel-windows"],
             "--online is incompatible with --statistical-test/"
             "--parallel-windows"),
            (["--online", "--statistical-test", "2"],
             "--online is incompatible"),
            (["--replay", "x.log", "--online"],
             "--replay is incompatible with --online"),
            (["--gui", "--parallel-windows"],
             "--gui/--replay are incompatible with --statistical-test/"
             "--parallel-windows"),
            (["--replay", "x.log", "--statistical-test", "2"],
             "--gui/--replay are incompatible")):
        with pytest.raises(SystemExit, match=re.escape(msg)):
            cli_enml.main(base + flags)


def test_cli_enml_replay_and_parallel_windows(tmp_path, capsys):
    """--replay localizes in segments and re-applies a logged correction
    (the same poses as the session API); --parallel-windows runs the
    checkerboard and writes files the HitL CLI loads."""
    from hitl_slam_torch import cli, cli_enml
    from hitl_slam_torch.core.state import CorrectionType, SingleInput
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.io.figure8 import generate_raw_stream
    from hitl_slam_torch.models.enml.driver import (EpisodeOptions,
                                                     build_episodes)
    from hitl_slam_torch.models.enml.localizer import EnmlOptions
    from hitl_slam_torch.models.enml.session import EnmlSession

    flags = ["--synthetic", "--steps", "48", "--seed", "5", "--max-history",
             "4", "--device", "cpu"]
    scans, angles, rel, gt, walls = generate_raw_stream(num_steps=48, seed=5)
    poses0, pcs, ncs, _ = build_episodes(
        list(scans), angles, rel, EpisodeOptions(clip_low=10, clip_high=10))
    mirror = EnmlSession(poses0, pcs, ncs, options=EnmlOptions(max_history=4),
                         device="cpu")
    mirror.localize(segment=32)
    P = len(mirror.poses)
    sel = synth_wall_correction(mirror.poses, pcs, walls,
                                 late=range(P - 12, P), early=range(0, 9))
    log = str(tmp_path / "loop.log")
    logs.save_log(log, [SingleInput(CorrectionType.COLINEAR, 0, sel)])
    want = mirror.add_loop_correction(CorrectionType.COLINEAR,
                                      logs.load_log(log)[0].points)
    assert want.accepted

    out = str(tmp_path / "rep")
    assert cli_enml.main(flags + ["--replay", log, "-o", out]) == 0
    text = capsys.readouterr().out
    assert re.search(rf"replay: {P} nodes localized \+ 1/1 corrections "
                     r"applied", text), text
    np.testing.assert_allclose(np.loadtxt(out + ".poses"), mirror.poses,
                               atol=1e-4)
    assert len(stfs.load_stfs_covars(out + ".stfs.covars").poses) == P

    out = str(tmp_path / "cb")
    assert cli_enml.main(flags + ["--parallel-windows", "-o", out]) == 0
    text = capsys.readouterr().out
    got = re.search(r"run: (\d+) episode nodes localized in .*consistency "
                    r"([\d.]+) -> ([\d.]+); wrote", text)
    assert got and int(got[1]) == P, text
    assert float(got[3]) <= 1.05 * float(got[2])
    assert cli.main(["-P", out + ".stfs.covars", "-V",
                     str(tmp_path / "r.txt"), "--device", "cpu"]) == 0
    assert len(np.loadtxt(tmp_path / "r.txt")) == P

