"""Port end to end on the CPU: the engine replays the golden sessions of
tests/test_golden.py at their tolerances, the port CLI's two replay modes
write identical results, and the engine API (run / undo / cost breakdown)
agrees with the JAX engine."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
LOOSE = (0.02, 0.01)     # tests/test_golden.py: 2 cm / 10 mrad
TIGHT = (0.002, 0.001)   # tests/test_golden.py: 2 mm / 1 mrad


def _assert_poses(got, expected, tol):
    atol_xy, atol_th = tol
    np.testing.assert_allclose(got[:, :2], expected[:, :2], atol=atol_xy)
    dth = np.arctan2(np.sin(got[:, 2] - expected[:, 2]),
                     np.cos(got[:, 2] - expected[:, 2]))
    np.testing.assert_allclose(dth, 0.0, atol=atol_th)


def _replay(stfs_name, log_name, capacity, fused=False):
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    data = stfs.load_stfs_covars(os.path.join(DATA, stfs_name))
    eng = HitLSLAM(device="cpu")
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=capacity)
    entries = logs.load_log(os.path.join(DATA, log_name))
    reports = (eng.run_queue(entries) if fused
               else [eng.replay_log(e) for e in entries])
    for r in reports:
        assert r.accepted, r.reason
    return eng, reports


@pytest.mark.parametrize("expected,tol", [
    ("golden_expected_poses.txt", LOOSE),
    ("golden_expected_poses_tight.txt", TIGHT),
])
def test_port_golden_session_replay(expected, tol):
    eng, _ = _replay("golden.stfs.covars", "golden.log", 256)
    _assert_poses(eng.get_poses(), np.loadtxt(os.path.join(DATA, expected)),
                  tol)


@pytest.mark.parametrize("fused", [False, True])
def test_port_golden_large_session_replay(fused):
    """The 1024-pose, 2-lap session (read from the .gz directly), by
    replay_log and by run_queue, at the loose golden tolerance."""
    eng, reports = _replay("golden_large.stfs.covars.gz", "golden_large.log",
                           16384, fused=fused)
    assert eng.get_poses().shape == (1024, 3)
    assert eng.num_constraints == sum(r.num_new_constraints for r in reports)
    _assert_poses(eng.get_poses(),
                  np.loadtxt(os.path.join(DATA,
                                          "golden_large_expected_poses.txt")),
                  LOOSE)


def test_port_cli_replay_modes_write_equal_results(tmp_path, capsys):
    from hitl_slam_torch.cli import main

    outs = {}
    for flag in ("--replay-all", "--replay-fused"):
        out = tmp_path / f"{flag[2:]}.txt"
        rc = main(["-P", os.path.join(DATA, "golden.stfs.covars"),
                   "-L", os.path.join(DATA, "golden.log"), flag,
                   "-V", str(out), "--device", "cpu"])
        assert rc == 0
        outs[flag] = out.read_bytes()
    assert outs["--replay-all"] == outs["--replay-fused"]
    text = capsys.readouterr().out
    assert "COLINEAR: ok" in text and "saved 64 poses" in text
    _assert_poses(np.loadtxt(tmp_path / "replay-all.txt"),
                  np.loadtxt(os.path.join(DATA, "golden_expected_poses_tight.txt")),
                  TIGHT)


def test_port_cli_errors(tmp_path):
    from hitl_slam_torch.cli import main

    assert main(["-P", str(tmp_path / "missing.stfs.covars"),
                 "--device", "cpu"]) == 1
    bad = tmp_path / "bad.log"
    bad.write_text("3\nnot, a, log\n")
    assert main(["-P", os.path.join(DATA, "golden.stfs.covars"), "-L",
                 str(bad), "--device", "cpu"]) == 1


def test_engine_run_undo_breakdown_match_jax():
    """The two-click input path, run(), get_cost_breakdown() and undo() of
    the port's engine against the JAX engine on the small golden session."""
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.models.hitl.engine import HitLSLAM
    from hitl_slam_tpu.models.hitl.engine import HitLSLAM as JHitLSLAM

    data = stfs.load_stfs_covars(os.path.join(DATA, "golden.stfs.covars"))
    entry = logs.load_log(os.path.join(DATA, "golden.log"))[0]
    ct = int(entry.correction_type)
    p = entry.points
    engines = [HitLSLAM(device="cpu"), JHitLSLAM()]
    engines[1].speculate = False
    reps, breakdowns = [], []
    for eng in engines:
        eng.init(data.poses, data.covariances, data.point_clouds,
                 data.normal_clouds, constraint_capacity=256)
        eng.add_correction_points(ct, p[0], p[1])
        eng.add_correction_points(ct, p[2], p[3])
        reps.append(eng.run())
        breakdowns.append(eng.get_cost_breakdown())
    tr, jr = reps
    assert tr.accepted and jr.accepted
    assert (tr.num_new_constraints, tr.lm_iterations) == (
        jr.num_new_constraints, jr.lm_iterations)
    tb, jb = breakdowns
    assert tb["num_active_constraints"] == jb["num_active_constraints"]
    # costs near the optimum are ~1e-9: absolute f32 noise floor
    for k in ("odometry_cost", "human_cost"):
        assert abs(tb[k] - jb[k]) <= 1e-4 * abs(jb[k]) + 1e-6, k
    np.testing.assert_allclose(engines[0].get_poses(), engines[1].get_poses(),
                               atol=1e-4)
    for eng in engines:
        assert eng.undo()
        assert not eng.undo()
        np.testing.assert_array_equal(eng.get_poses(), data.poses)
        assert eng.get_cost_breakdown()["num_active_constraints"] == 0
        assert eng.get_input_history()[-1].undone == 1
