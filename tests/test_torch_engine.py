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


@pytest.mark.parametrize("where", ["alone", "among_full_rows"])
def test_port_cli_truncated_row(tmp_path, capsys, where):
    """A .stfs.covars row of 15 fields, alone or among 16-field rows, gives
    the reference's clean "Unable to open" error and exit 1."""
    from hitl_slam_torch.cli import main

    lines = open(os.path.join(DATA, "golden.stfs.covars")).read().splitlines()
    short = ",".join(lines[2].split(",")[:15])
    rows = [short] if where == "alone" else lines[2:8] + [short] + lines[8:12]
    path = tmp_path / "short.stfs.covars"
    path.write_text("\n".join(lines[:2] + rows) + "\n")
    assert main(["-P", str(path), "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "ERROR: Unable to open specified pose-graph file" in err


def test_port_cli_config_sets_lm(tmp_path):
    """--config reads the [lm] table into the engine's LMConfig, as the
    reference's CLI does with config/hitl_slam.toml; the CLI entry points
    install the crash guard."""
    import faulthandler

    from hitl_slam_torch import cli
    from hitl_slam_torch.models.hitl import engine as E
    from hitl_slam_torch.solver.lm import LMConfig

    seen = []
    init = E.HitLSLAM.__init__

    def spy(self, lm_config=LMConfig(), *, device="cuda"):
        seen.append(lm_config)
        init(self, lm_config, device=device)

    faulthandler.disable()
    E.HitLSLAM.__init__ = spy
    try:
        out = tmp_path / "r.txt"
        cfg = os.path.join(os.path.dirname(DATA), os.pardir, "config",
                           "hitl_slam.toml")
        assert cli.main(["-P", os.path.join(DATA, "golden.stfs.covars"),
                         "-L", os.path.join(DATA, "golden.log"),
                         "--replay-all", "-V", str(out), "--config", cfg,
                         "--device", "cpu"]) == 0
        bad = tmp_path / "bad.toml"
        bad.write_text("[lm]\nno_such_field = 1\n")
        assert cli.main(["-P", os.path.join(DATA, "golden.stfs.covars"),
                         "--config", str(bad), "--device", "cpu"]) == 1
    finally:
        E.HitLSLAM.__init__ = init
    assert seen == [LMConfig(max_iterations=100, function_tolerance=1e-6)]
    assert faulthandler.is_enabled()
    _assert_poses(np.loadtxt(out),
                  np.loadtxt(os.path.join(DATA, "golden_expected_poses.txt")),
                  LOOSE)


def test_port_cli_profile_writes_trace(tmp_path):
    """--profile DIR writes a torch.profiler Chrome trace of the session;
    cli_ltvm installs the crash guard too."""
    import faulthandler
    import json

    from hitl_slam_torch.cli import main
    from hitl_slam_torch.cli_ltvm import main as ltvm_main

    trace_dir = tmp_path / "trace"
    assert main(["-P", os.path.join(DATA, "golden.stfs.covars"),
                 "-L", os.path.join(DATA, "golden.log"), "--replay-all",
                 "-V", str(tmp_path / "r.txt"), "--profile", str(trace_dir),
                 "--device", "cpu"]) == 0
    trace = json.loads((trace_dir / "hitl-session.pt.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "hitl-session" in names
    faulthandler.disable()
    assert ltvm_main(["-P", str(tmp_path / "missing.stfs.covars"),
                      "--device", "cpu"]) == 1
    assert faulthandler.is_enabled()


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


# --------------------------------------------------- the rest of the engine

def _engines(data, capacity=256, odometry=None):
    """The port's engine and the JAX engine on the same map (the JAX one
    without speculative dispatch: it is the plain reference)."""
    from hitl_slam_torch.models.hitl.engine import HitLSLAM
    from hitl_slam_tpu.models.hitl.engine import HitLSLAM as JHitLSLAM

    engines = [HitLSLAM(device="cpu"), JHitLSLAM()]
    engines[1].speculate = False
    for eng in engines:
        eng.init(data.poses, data.covariances, data.point_clouds,
                 data.normal_clouds, odometry=odometry,
                 constraint_capacity=capacity)
    return engines


def _golden():
    from hitl_slam_torch.io import logs, stfs

    return (stfs.load_stfs_covars(os.path.join(DATA, "golden.stfs.covars")),
            logs.load_log(os.path.join(DATA, "golden.log")))


def test_engine_public_names_cover_the_reference():
    """Every public method and attribute of the reference's HitLSLAM
    exists on the port's, on the class and on a fresh instance, and every
    public method takes the reference's parameters."""
    from hitl_slam_torch.models.hitl.engine import HitLSLAM
    from hitl_slam_tpu.models.hitl.engine import HitLSLAM as JHitLSLAM

    def public(obj):
        return {k for k in dir(obj) if not k.startswith("_")}

    missing = public(JHitLSLAM) - public(HitLSLAM)
    assert missing == set(), missing
    # last_pre_solve_poses appears on the reference only after a cycle
    want = public(JHitLSLAM()) | {"last_pre_solve_poses"}
    missing = want - public(HitLSLAM(device="cpu"))
    assert missing == set(), missing
    # every public method (and the constructor) takes the reference's
    # parameters in the reference's order; the port may add only these
    import inspect

    extra = {"device", "draws", "timings_ms"}
    methods = sorted(k for k in public(JHitLSLAM)
                     if callable(getattr(JHitLSLAM, k))) + ["__init__"]
    for name in methods:
        want_params = list(inspect.signature(
            getattr(JHitLSLAM, name)).parameters)
        got = [p for p in inspect.signature(getattr(HitLSLAM, name)).parameters
               if p not in extra]
        assert got == want_params, (name, got, want_params)


def test_signatures_follow_the_reference():
    """cycle_step, queue_chain, build_problem, lm.solve, load_stfs_covars,
    sharded_lm_solve and checkerboard_localize take the reference's
    parameters in the reference's order; lm.solve may add only the
    keyword-only `accepts` after them, checkerboard_localize only
    `stage_ms` and then the keyword-only `eager`."""
    import inspect

    from hitl_slam_torch.io import stfs
    from hitl_slam_torch.models.enml import parallel_localizer
    from hitl_slam_torch.models.hitl import cycle
    from hitl_slam_torch.parallel import sharded_solver
    from hitl_slam_torch.solver import joint, lm
    from hitl_slam_tpu.io import stfs as jstfs
    from hitl_slam_tpu.models.enml import parallel_localizer as jpl
    from hitl_slam_tpu.models.hitl import cycle as jcycle
    from hitl_slam_tpu.parallel import sharded_solver as jss
    from hitl_slam_tpu.solver import joint as jjoint, lm as jlm

    def params(f):
        f = getattr(f, "__wrapped__", f)
        return [p for p in inspect.signature(f).parameters
                if p not in ("accepts", "stage_ms", "eager")]

    for got, want in ((cycle.cycle_step, jcycle.cycle_step),
                      (cycle.queue_chain, jcycle.queue_chain),
                      (joint.build_problem, jjoint.build_problem),
                      (lm.solve, jlm.solve),
                      (stfs.load_stfs_covars, jstfs.load_stfs_covars),
                      (sharded_solver.sharded_lm_solve, jss.sharded_lm_solve),
                      (parallel_localizer.checkerboard_localize,
                       jpl.checkerboard_localize)):
        assert params(got) == params(want), got.__name__
    board = inspect.signature(parallel_localizer.checkerboard_localize)
    assert list(board.parameters)[-2:] == ["stage_ms", "eager"]
    assert board.parameters["eager"].kind is inspect.Parameter.KEYWORD_ONLY
    assert (inspect.signature(lm.solve).parameters["accepts"].kind
            is inspect.Parameter.KEYWORD_ONLY)


def test_device_follows_the_reference_parameters():
    """make_map_state and HitLSLAM take the reference's parameters in the
    reference's order, then `device` alone, keyword-only, defaulting to the
    card."""
    import inspect

    from hitl_slam_torch.core import state
    from hitl_slam_torch.models.hitl import engine
    from hitl_slam_tpu.core import state as jstate
    from hitl_slam_tpu.models.hitl import engine as jengine

    for got, want in ((state.make_map_state, jstate.make_map_state),
                      (engine.HitLSLAM, jengine.HitLSLAM)):
        params = inspect.signature(got).parameters
        assert list(params) == list(inspect.signature(want).parameters) + [
            "device"], got.__name__
        assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
        assert params["device"].default == "cuda"


def test_positional_calls_written_against_the_reference():
    """The reference's callers pass make_map_state's odometry and
    HitLSLAM's lm_config by position; the port takes the same calls with
    device= added, and a session built so replays the small golden log as
    one built by keywords does."""
    from hitl_slam_torch.core.state import make_map_state
    from hitl_slam_torch.models.hitl.engine import HitLSLAM
    from hitl_slam_torch.solver.lm import LMConfig

    data, entries = _golden()
    odom = data.poses + np.float32(0.25)
    st = make_map_state(data.poses, data.covariances, data.point_clouds,
                        data.normal_clouds, odom, device="cpu")
    assert st.poses.device.type == "cpu"
    np.testing.assert_array_equal(st.odometry.numpy(), odom)
    cfg = LMConfig(max_iterations=7)
    by_position = HitLSLAM(cfg, device="cpu")
    by_keyword = HitLSLAM(lm_config=cfg, device="cpu")
    assert by_position.lm_config == cfg
    assert by_position.device == torch.device("cpu")
    for eng in (by_position, by_keyword):
        eng.init(data.poses, data.covariances, data.point_clouds,
                 data.normal_clouds, constraint_capacity=256)
        for e in entries:
            assert eng.replay_log(e).accepted
    np.testing.assert_array_equal(by_position.get_poses(),
                                  by_keyword.get_poses())


def test_every_reference_class_has_its_public_members_in_the_port():
    """Each public class a module of hitl_slam_tpu/ defines has a namesake
    in the port's module with every public member of the reference's
    (methods, properties, class attributes); the name test above reads
    top-level definitions only and cannot see a missing method."""
    import glob
    import importlib
    import inspect

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    missing = {}
    checked = 0
    for path in sorted(glob.glob(os.path.join(repo, "hitl_slam_tpu", "**",
                                              "*.py"), recursive=True)):
        rel = os.path.relpath(path, os.path.join(repo, "hitl_slam_tpu"))[:-3]
        if os.path.basename(rel) == "__init__":
            rel = os.path.dirname(rel)
        ref = importlib.import_module(
            ".".join(["hitl_slam_tpu"] + [p for p in rel.split("/") if p]))
        port = importlib.import_module(".".join(
            ["hitl_slam_torch"]
            + [p for p in RENAMED.get(rel, rel).split("/") if p]))
        for name, cls in vars(ref).items():
            if (name.startswith("_") or not inspect.isclass(cls)
                    or cls.__module__ != ref.__name__):
                continue
            checked += 1
            theirs = getattr(port, name, None)
            if name in RETIRED.get(rel, set()):
                assert theirs is None, f"{rel}.{name} is retired"
                continue
            if not inspect.isclass(theirs):
                missing[f"{rel}.{name}"] = "no class"
                continue
            gap = ({k for k in dir(cls) if not k.startswith("_")}
                   - set(dir(theirs)))
            if gap:
                missing[f"{rel}.{name}"] = sorted(gap)
    assert checked >= 50, checked
    assert missing == {}, missing


# what the port has yet to port: a module (None) or names of a module;
# nothing is left
NAMES_LEFT = {}
# names of the reference that the port retired by design: the recorder's
# spans (utils/timing.py::TimerCollection.span) replace FunctionTimer's laps
RETIRED = {"utils/timing": {"FunctionTimer"}}
# the two TPU kernels' modules, ported under other names; in them the
# Pallas entry and the Pallas grid tile have CUDA counterparts of other names
RENAMED = {"ops/pallas_em": "ops/em_scan",
           "solver/pallas_bcr": "solver/bcr_kernel"}
RENAMED_NAMES = {"bcr_solve_pallas": "bcr_solve_cuda",
                 "POSE_TILE": "launch_plan"}


def _public_names(path):
    """Top-level public names a module defines (read from its source: the
    reference's modules import jax when imported)."""
    import ast

    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {tg.id for tg in node.targets
                      if isinstance(tg, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {k for k in names if not k.startswith("_")}


def test_every_reference_module_has_its_names_in_the_port():
    """Every module of hitl_slam_tpu/ has a counterpart in hitl_slam_torch/
    that defines each of its public top-level names (functions, classes,
    constants), but for what NAMES_LEFT lists (now nothing) and what
    RETIRED lists (gone from the port, by design)."""
    import glob

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref_root = os.path.join(repo, "hitl_slam_tpu")
    port_root = os.path.join(repo, "hitl_slam_torch")
    missing = {}
    for path in sorted(glob.glob(os.path.join(ref_root, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, ref_root)[:-3]
        if NAMES_LEFT.get(rel, set()) is None:
            continue
        left = NAMES_LEFT.get(rel, set()) | RETIRED.get(rel, set())
        port = os.path.join(port_root, RENAMED.get(rel, rel) + ".py")
        # the reference's type alias Array (jax.Array) is the port's Tensor
        want = {RENAMED_NAMES.get(k, k)
                for k in _public_names(path) - left - {"Array"}}
        if not os.path.exists(port):
            missing[rel] = "no module"
            continue
        gap = want - _public_names(port)
        if gap:
            missing[rel] = sorted(gap)
    assert missing == {}, missing
    # the allowlists name only what is still missing, or retired
    for rel, left in (*NAMES_LEFT.items(), *RETIRED.items()):
        port = os.path.join(port_root, rel + ".py")
        if left is None:
            assert not os.path.exists(port), rel
        else:
            assert not (left & _public_names(port)), rel


def test_run_queue_chain_capacity():
    """run_queue takes the reference's chain_capacity in second position
    and chunks the queue by it: chains of one give the poses of one chain
    of all, and no input is recorded without `record`."""
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    data, entries = _golden()

    def engine():
        eng = HitLSLAM(device="cpu")
        eng.init(data.poses, data.covariances, data.point_clouds,
                 data.normal_clouds, constraint_capacity=256)
        return eng

    one, whole = engine(), engine()
    reps_one = one.run_queue(entries, 1)
    reps_whole = whole.run_queue(entries)
    assert [r.accepted for r in reps_one] == [r.accepted for r in reps_whole]
    assert all(r.accepted for r in reps_one)
    np.testing.assert_allclose(one.get_poses(), whole.get_poses(), atol=1e-6)
    assert one.input_history == [] and whole.input_history == []
    assert one.num_constraints == whole.num_constraints
    rec = engine()
    rec.run_queue(entries, chain_capacity=1, record=True)
    assert len(rec.input_history) == len(entries)


def test_cycle_sets_last_pre_solve_poses():
    """_cycle records the poses it handed to the LM solve, as the
    reference's engine does (the port left the attribute unset)."""
    data, entries = _golden()
    te, je = _engines(data)
    assert te.last_pre_solve_poses is None
    for eng in (te, je):
        assert eng.replay_log(entries[0]).accepted
    got = te.last_pre_solve_poses.numpy()
    np.testing.assert_allclose(got, np.asarray(je.last_pre_solve_poses),
                               atol=1e-4)
    # backprop moved the poses before the solve polished them
    assert np.abs(got - data.poses).max() > 1e-3


def test_odom_inv_sigma_cycle_and_breakdown():
    """cycle_step (on the inputs of __graft_entry__.entry()), the engine's
    cycle and get_cost_breakdown with a random positive [P-1, 3] odometry
    weighting, against the reference. Costs near the optimum are ~1e-9, so
    they are held to an absolute 1e-6."""
    import jax.numpy as jnp

    import __graft_entry__ as G
    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.models.hitl.cycle import cycle_step
    from hitl_slam_torch.solver.lm import LMConfig as TCfg
    from hitl_slam_tpu.models.hitl.cycle import cycle_step as jcycle
    from hitl_slam_tpu.solver.lm import LMConfig as JCfg
    from torch_port_helpers import n, np_fields, t

    rng = np.random.default_rng(11)
    jin = G._tiny_cycle_inputs()
    points, mask, poses, covs, table, ctype, sel, off = jin
    w = rng.uniform(5.0, 120.0, (poses.shape[0] - 1, 3)).astype(np.float32)
    ref = jcycle(*jin, lm_config=JCfg(max_iterations=20),
                 odom_inv_sigma=jnp.asarray(w))
    args = (t(points), t(mask), t(poses), t(covs),
            table_from_numpy(np_fields(table), "cpu"), int(ctype), t(sel),
            int(off))
    got = cycle_step(*args, lm_config=TCfg(max_iterations=20),
                     odom_inv_sigma=t(w))
    plain = cycle_step(*args, lm_config=TCfg(max_iterations=20))
    assert bool(got.verified) and bool(got.order_valid)
    assert int(got.num_new_constraints) == int(ref.num_new_constraints)
    np.testing.assert_allclose(n(got.poses), np.asarray(ref.poses), atol=1e-4)
    for k in ("lm_initial_cost", "lm_final_cost"):
        np.testing.assert_allclose(float(getattr(got, k)),
                                   float(getattr(ref, k)), rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    # the solve has nothing left to do after backprop here, whatever the
    # weighting (test_lm_with_odom_inv_sigma_matches_jax shows its effect)
    np.testing.assert_allclose(n(got.poses), n(plain.poses), atol=1e-4)

    data, entries = _golden()
    w = rng.uniform(5.0, 120.0, (len(data.poses) - 1, 3)).astype(np.float32)
    te, je = _engines(data)
    te.odom_inv_sigma = torch.as_tensor(w)
    je.odom_inv_sigma = jnp.asarray(w)
    tr, jr = (eng.replay_log(entries[0]) for eng in (te, je))
    assert tr.accepted and jr.accepted
    assert tr.num_new_constraints == jr.num_new_constraints
    np.testing.assert_allclose(te.get_poses(), je.get_poses(), atol=1e-4)
    tb, jb = te.get_cost_breakdown(), je.get_cost_breakdown()
    assert tb["num_active_constraints"] == jb["num_active_constraints"] > 0
    for k in ("odometry_cost", "human_cost"):
        assert abs(tb[k] - jb[k]) <= 1e-3 * abs(jb[k]) + 1e-6, k


def test_lm_with_odom_inv_sigma_matches_jax(rng):
    """The LM solve of a 60-pose chain with three human constraints under a
    random odometry weighting: the reference's optimum, and another one than
    under the fixed noise model."""
    import jax.numpy as jnp

    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.solver import joint as TJ, lm as TL
    from hitl_slam_tpu.core.state import ConstraintTable as JTable
    from hitl_slam_tpu.solver import joint as JJ
    from hitl_slam_tpu.solver.lm import LMConfig as JCfg, solve_jit
    from torch_port_helpers import chain_poses

    num = 60
    poses = chain_poses(rng, num)
    w = rng.uniform(5.0, 120.0, (num - 1, 3)).astype(np.float32)
    tab = _three_constraints(8, [50, 52, 55])
    ref = solve_jit(
        JJ.build_problem(jnp.asarray(poses),
                         JTable(**{k: jnp.asarray(v) for k, v in tab.items()}),
                         odom_inv_sigma=jnp.asarray(w)),
        jnp.asarray(poses), JCfg(max_iterations=100))
    table = table_from_numpy(tab, "cpu")
    x0 = torch.as_tensor(poses)
    got = TL.solve(TJ.build_problem(x0, table,
                                    odom_inv_sigma=torch.as_tensor(w)),
                   x0, TL.LMConfig(max_iterations=100))
    plain = TL.solve(TJ.build_problem(x0, table), x0,
                     TL.LMConfig(max_iterations=100))
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses),
                               atol=2e-3)
    assert float((got.poses - plain.poses).abs().max()) > 1e-2


def _three_constraints(capacity, constrained):
    """The three human constraints of tests/test_cpu_baseline.py as the
    arrays of a constraint table of `capacity` rows."""
    tab = {
        "ctype": np.zeros(capacity, np.int32),
        "constrained": np.zeros(capacity, np.int32),
        "anchor": np.zeros(capacity, np.int32),
        "delta_parallel": np.zeros(capacity, np.float32),
        "delta_perpendicular": np.zeros(capacity, np.float32),
        "delta_angle": np.zeros(capacity, np.float32),
        "penalty_dir": np.zeros(capacity, np.float32),
        "active": np.zeros(capacity, bool),
    }
    tab["ctype"][:3] = [2, 4, 5]
    tab["constrained"][:3] = constrained
    tab["anchor"][:3] = [3, 4, 5]
    tab["delta_parallel"][:3] = [0.5, 0.2, 0.0]
    tab["delta_perpendicular"][:3] = [-0.2, 0.4, 0.0]
    tab["delta_angle"][:3] = [0.1, -0.1, 0.2]
    tab["penalty_dir"][:3] = [0.0, 0.7, 0.0]
    tab["active"][:3] = True
    return tab


def test_build_odometry_factors_inv_sigma_parity(rng):
    import jax.numpy as jnp

    from hitl_slam_torch.ops import residuals as TRes
    from hitl_slam_tpu.ops import residuals as JRes
    from torch_port_helpers import chain_poses

    poses = chain_poses(rng, 40)
    inv_sigma = rng.uniform(5.0, 120.0, (39, 3)).astype(np.float32)
    moved = poses + rng.normal(0, 0.02, poses.shape).astype(np.float32)
    for w in (None, inv_sigma):
        ft = TRes.build_odometry_factors(
            torch.as_tensor(poses), None if w is None else torch.as_tensor(w))
        fj = JRes.build_odometry_factors(
            jnp.asarray(poses), None if w is None else jnp.asarray(w))
        np.testing.assert_array_equal(ft.inv_sigma.numpy(),
                                      np.asarray(fj.inv_sigma))
        np.testing.assert_allclose(
            TRes.odometry_residuals(ft, torch.as_tensor(moved)).numpy(),
            np.asarray(JRes.odometry_residuals(fj, jnp.asarray(moved))),
            rtol=1e-4, atol=1e-4)


def test_lm_matches_f64_cpu_baseline_at_1024_poses():
    """The port's f32 LM against hitl_slam_tpu/baselines/cpu_lm.py (f64,
    banded Cholesky) on the problem of tests/test_cpu_baseline.py grown to
    1024 poses: the final cost at that test's tolerance. The poses lie in a
    flat valley at this length (three constraints on a 1024-pose chain): the
    JAX f32 solver ends 0.39 m from the f64 poses at a cost equal to 2e-5,
    so the poses are held to 0.5 m only."""
    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.solver import joint, lm
    from hitl_slam_tpu.baselines.cpu_lm import cpu_lm_solve

    rng = np.random.default_rng(1234)
    num = 1024
    poses = np.zeros((num, 3), np.float32)
    for i in range(1, num):
        poses[i, 2] = poses[i - 1, 2] + rng.normal(0, 0.1)
        poses[i, :2] = poses[i - 1, :2] + [0.4 * np.cos(poses[i - 1, 2]),
                                           0.4 * np.sin(poses[i - 1, 2])]
    tab = _three_constraints(8, [1000, 1010, 1020])
    np_table = dict(
        ctype=tab["ctype"][:3], constrained=tab["constrained"][:3],
        anchor=tab["anchor"][:3], dpar=tab["delta_parallel"][:3],
        dperp=tab["delta_perpendicular"][:3], dth=tab["delta_angle"][:3],
        pen=tab["penalty_dir"][:3], active=tab["active"][:3])
    cpu_poses, cpu_cost, cpu_iters = cpu_lm_solve(poses, np_table)
    prob = joint.build_problem(torch.as_tensor(poses),
                               table_from_numpy(tab, "cpu"))
    dev = lm.solve(prob, torch.as_tensor(poses),
                   lm.LMConfig(max_iterations=100))
    assert cpu_iters > 1 and int(dev.iterations) > 1
    dev_cost = float(dev.final_cost)
    assert float(dev.initial_cost) > 100 * dev_cost
    assert abs(dev_cost - cpu_cost) <= 0.02 * max(cpu_cost, 1e-6) + 1e-4, (
        dev_cost, cpu_cost)
    np.testing.assert_allclose(dev.poses.numpy(), cpu_poses, atol=0.5)


@pytest.fixture(scope="module")
def small_engines(small_map):
    """post_optimize(max_iterations=10) run once on small_map by both
    engines: (engines, reports)."""
    engines = _engines(small_map)
    return engines, [eng.post_optimize(max_iterations=10) for eng in engines]


def test_post_optimize_matches_jax(small_map, small_engines):
    """The report fields and the poses of post_optimize on small_map. The
    LM iteration count is not compared: on this nearly consistent map it is
    decided by f32 round-off (tests/test_torch_refine.py says why, and
    compares the counts where they are determined)."""
    (te, je), (tr, jr) = small_engines
    assert tr.accepted and jr.accepted
    assert tr.reason == jr.reason == "post-human STF refinement (global matcher)"
    assert tr.dropped_rows == jr.dropped_rows == 0
    assert 0 < tr.lm_iterations <= 10
    np.testing.assert_allclose(tr.initial_cost, jr.initial_cost, rtol=1e-4)
    np.testing.assert_allclose(tr.final_cost, jr.final_cost, rtol=1e-4)
    assert tr.final_cost <= tr.initial_cost
    np.testing.assert_allclose(te.get_poses(), je.get_poses(), atol=1e-4)
    np.testing.assert_array_equal(te.get_poses()[0], small_map.poses[0])
    assert te.get_input_history() == []


def test_undo_after_refine_then_last_correction():
    """undo() after post_optimize reverts the refine and leaves the input
    history alone; a second undo() reverts the last human correction; a
    third has nothing to revert. As in the reference, the refine's snapshot
    (poses and constraint count) has replaced the correction's, so the
    second undo() marks the correction undone but finds neither poses nor
    constraint rows of its own to take back."""
    data, entries = _golden()
    for eng in _engines(data):
        assert eng.replay_log(entries[0], record=True).accepted
        repaired = eng.get_poses().copy()
        n_rows = eng.num_constraints
        assert eng.post_optimize(max_iterations=5).accepted
        assert eng._undo_is_refine
        assert np.abs(eng.get_poses() - repaired).max() > 0
        assert eng.undo()
        np.testing.assert_array_equal(eng.get_poses(), repaired)
        assert not eng._undo_is_refine
        assert eng.get_input_history()[-1].undone == 0
        assert eng.num_constraints == n_rows
        assert eng.get_cost_breakdown()["num_active_constraints"] == n_rows
        assert eng.undo()
        np.testing.assert_array_equal(eng.get_poses(), repaired)
        assert eng.get_input_history()[-1].undone == 1
        assert eng.num_constraints == n_rows
        assert eng.get_cost_breakdown()["num_active_constraints"] == n_rows
        assert not eng.undo()
        # a queue after a refine takes the snapshot back
        assert eng.post_optimize(max_iterations=2).accepted
        eng.run_queue([entries[0]])
        assert not eng._undo_is_refine


def test_post_optimize_auto_falls_back_to_pair_matcher():
    """On a heavily re-traversed map the global matcher's bundles all die at
    the 10-per-pair gate; matcher="auto" then runs the pair matcher. Report
    fields as the reference's."""
    from hitl_slam_tpu.io.figure8 import generate_figure8

    m = generate_figure8(num_poses=512, num_rays=40, seed=13,
                         drift_theta_bias=2e-4, num_laps=8)
    te, je = _engines(m, capacity=64, odometry=m.odometry)
    tr, jr = (eng.post_optimize(max_iterations=3) for eng in (te, je))
    assert tr.accepted
    assert "pair matcher" in tr.reason and tr.reason == jr.reason
    assert tr.dropped_rows == jr.dropped_rows
    assert tr.lm_iterations == jr.lm_iterations == 3
    assert "vote_dropped=" in tr.reason      # the drop counter is equal
    np.testing.assert_allclose(tr.initial_cost, jr.initial_cost, rtol=1e-4)
    # three LM steps of a dense 1536 x 1536 f32 solve, not converged: an
    # f64 run of the same solve ends at cost 0.215370, the reference at
    # 0.215339 and the port at 0.215504, the port's poses 4e-4 from f64's
    np.testing.assert_allclose(tr.final_cost, jr.final_cost, rtol=2e-3)
    assert tr.final_cost < 0.5 * tr.initial_cost
    np.testing.assert_allclose(te.get_poses(), je.get_poses(), atol=1e-3)


def _click(eng, entry):
    ct = int(entry.correction_type)
    p = entry.points
    eng.add_correction_points(ct, p[0], p[1])
    eng.add_correction_points(ct, p[2], p[3])


def _plain_run(data, entries, capacity=256):
    """The engine without speculative dispatch, run() on each entry."""
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    eng = HitLSLAM(device="cpu")
    eng.speculate = False
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=capacity)
    reps = []
    for e in entries:
        _click(eng, e)
        assert eng._speculative is None
        reps.append(eng.run())
    return eng, reps


def _same_report(a, b):
    assert (a.accepted, a.reason, a.num_new_constraints, a.lm_iterations,
            a.initial_cost, a.final_cost) == (
        b.accepted, b.reason, b.num_new_constraints, b.lm_iterations,
        b.initial_cost, b.final_cost)


def test_speculative_hit_is_identical():
    """Two clicks dispatch the cycle; run() takes its result: one hit,
    poses, table and report bit-equal to the engine without speculation."""
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    data, entries = _golden()
    want, want_reps = _plain_run(data, entries[:1])
    eng = HitLSLAM(device="cpu")
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=256)
    _click(eng, entries[0])
    assert eng._speculative is not None
    rep = eng.run()
    assert eng.speculative_hits == 1 and eng._speculative is None
    assert rep.accepted
    _same_report(rep, want_reps[0])
    np.testing.assert_array_equal(eng.get_poses(), want.get_poses())
    np.testing.assert_array_equal(eng.get_covariances(),
                                  want.get_covariances())
    assert torch.equal(eng.state.constraints.active,
                       want.state.constraints.active)
    assert torch.equal(eng.last_pre_solve_poses, want.last_pre_solve_poses)
    assert eng.num_constraints == want.num_constraints
    assert len(eng.get_input_history()) == 1
    assert eng.undo()
    np.testing.assert_array_equal(eng.get_poses(), data.poses)


@pytest.mark.parametrize("how", ["selection_changed", "state_changed",
                                 "post_optimize", "run_queue", "reclick"])
def test_speculative_miss_and_discard(how):
    """A dispatch that no longer matches is waited for and dropped: no hit,
    and the results are those of the engine without speculation."""
    from hitl_slam_torch.core.state import SingleInput
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    data, entries = _golden()
    entry = entries[0]
    eng = HitLSLAM(device="cpu")
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=256)
    want, _ = _plain_run(data, [entry])
    _click(eng, entry)
    assert eng._speculative is not None
    if how == "selection_changed":
        # the selection is edited between the last click and run()
        moved = entry.points + np.float32(0.004)
        eng.selected_points = [p for p in moved]
        rep = eng.run()
        other, other_reps = _plain_run(
            data, [SingleInput(entry.correction_type, 0, moved)])
        assert eng.speculative_hits == 0
        _same_report(rep, other_reps[0])
        np.testing.assert_array_equal(eng.get_poses(), other.get_poses())
    elif how == "state_changed":
        # a replay_log in between retires the dispatch; the state.poses it
        # was made for is gone, so the run() after it is a fresh cycle
        thread = eng._speculative.thread
        stale = SingleInput(entry.correction_type, 0,
                            entry.points + np.float32(0.004))
        assert eng.replay_log(stale).accepted
        assert not thread.is_alive() and eng._speculative is None
        eng.speculate = False
        _click(eng, entry)
        eng.run()
        assert eng.speculative_hits == 0
        ref, _ = _plain_run(data, [])
        assert ref.replay_log(stale).accepted
        _click(ref, entry)
        ref.run()
        np.testing.assert_array_equal(eng.get_poses(), ref.get_poses())
    elif how == "post_optimize":
        thread = eng._speculative.thread
        assert eng.post_optimize(max_iterations=2).accepted
        assert not thread.is_alive() and eng._speculative is None
        # state.poses is the refine's now: the pending selection runs fresh
        assert eng.run().accepted
        assert eng.speculative_hits == 0
    elif how == "run_queue":
        thread = eng._speculative.thread
        reps = eng.run_queue([entry])
        assert not thread.is_alive() and eng._speculative is None
        assert reps[0].accepted and eng.speculative_hits == 0
        np.testing.assert_array_equal(eng.get_poses(), want.get_poses())
    else:
        # a second complete selection supersedes the first dispatch
        first = eng._speculative.thread
        eng.reset_correction_inputs()
        _click(eng, entry)
        assert not first.is_alive()
        assert eng._speculative.thread is not first
        assert eng.run().accepted and eng.speculative_hits == 1
        np.testing.assert_array_equal(eng.get_poses(), want.get_poses())


def test_speculative_worker_exception_is_raised_by_run(monkeypatch):
    """An exception on the worker is raised by the run() that would have
    used its result; a dispatch that is dropped takes its exception along."""
    from hitl_slam_torch.models.hitl import engine as E

    data, entries = _golden()
    eng = E.HitLSLAM(device="cpu")
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=256)

    def boom(*a, **k):
        raise RuntimeError("cycle failed on the worker")

    with monkeypatch.context() as mp:
        mp.setattr(E, "cycle_step", boom)
        _click(eng, entries[0])
        eng._speculative.thread.join(timeout=60)
        assert not eng._speculative.thread.is_alive()
    with pytest.raises(RuntimeError, match="on the worker"):
        eng.run()
    assert eng.speculative_hits == 0 and eng._speculative is None
    # dropped, not raised: the selection no longer matches
    with monkeypatch.context() as mp:
        mp.setattr(E, "cycle_step", boom)
        _click(eng, entries[0])
        eng._speculative.thread.join(timeout=60)
    eng.selected_points = [p + np.float32(0.004) for p in eng.selected_points]
    assert eng.run().accepted
    assert eng.speculative_hits == 0


def test_port_cli_post_optimize(tmp_path, capsys):
    """--post-optimize --refine-matcher pair after each replay mode and with
    no log at all, on the golden files: the report line is printed, and the
    saved poses are those of the engine driven directly."""
    from hitl_slam_torch.cli import main

    pg = os.path.join(DATA, "golden.stfs.covars")
    log = ["-L", os.path.join(DATA, "golden.log")]
    refine = ["--post-optimize", "--refine-matcher", "pair"]
    outs = {}
    for name, extra in (("replay", [*log, "--replay-all"]),
                        ("refined", [*log, "--replay-all", *refine]),
                        ("fused", [*log, "--replay-fused", *refine]),
                        ("nolog", ["--post-optimize"])):
        out = tmp_path / f"{name}.txt"
        assert main(["-P", pg, *extra, "-V", str(out), "--device",
                     "cpu"]) == 0
        outs[name] = np.loadtxt(out)
    text = capsys.readouterr().out
    assert text.count("post-optimize (STF refine): lm_iters=") == 3
    assert np.abs(outs["refined"] - outs["replay"]).max() > 1e-3
    np.testing.assert_array_equal(outs["fused"], outs["refined"])

    eng, _ = _replay("golden.stfs.covars", "golden.log", 8192)
    rep = eng.post_optimize(matcher="pair")
    assert rep.accepted and "pair matcher" in rep.reason
    np.testing.assert_allclose(outs["refined"], eng.get_poses(), atol=1e-5)
    fresh, _ = _plain_run(_golden()[0], [], capacity=8192)
    fresh.post_optimize()
    np.testing.assert_allclose(outs["nolog"], fresh.get_poses(), atol=1e-5)


def test_bench_prints_one_json_line(tmp_path, capsys):
    """python -m hitl_slam_torch.bench on the CPU, with the small golden
    session standing in for the 1024-pose one (same file names): one JSON
    line with the documented fields, the replay within the tight golden
    tolerance, the split refine bit-equal to the engine's."""
    import gzip
    import json
    import shutil

    from hitl_slam_torch import bench

    with open(os.path.join(DATA, "golden.stfs.covars"), "rb") as f, \
            gzip.open(tmp_path / "golden_large.stfs.covars.gz", "wb") as g:
        shutil.copyfileobj(f, g)
    shutil.copy(os.path.join(DATA, "golden.log"),
                tmp_path / "golden_large.log")
    shutil.copy(os.path.join(DATA, "golden_expected_poses_tight.txt"),
                tmp_path / "golden_large_expected_poses.txt")
    assert bench.main(["--device", "cpu", "--replays", "3", "--data",
                       str(tmp_path), "--refine-iterations", "5",
                       "--sharded", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["name"] == "cpu" and out["power_limit"] is None
    assert (out["poses"], out["replays"]) == (64, 3)
    assert len(out["cycle_wall_ms"]) == len(out["cycle_lm_iterations"]) == 1
    q = out["cycle_wall_ms"][0]
    assert 0 < q["q1"] <= q["median"] <= q["q3"]
    assert out["replay_pose_error"]["xy_m"] <= TIGHT[0]
    assert out["replay_pose_error"]["theta_rad"] <= TIGHT[1]
    po = out["post_optimize"]
    assert po["finite"] and po["split_equals_engine"]
    assert po["final_cost"] <= po["initial_cost"]
    assert po["num_matches"] > 0 and 0 < po["lm_iterations"] <= 5
    assert po["match_ms"] > 0 and po["solve_ms"] > 0 and po["wall_ms"] > 0
    for k in ("match_dropped", "pairs_dropped", "vote_dropped",
              "elect_dropped"):
        assert k in po
    assert po["match_dropped"] == po["dropped_rows"] == 0
    pr = out["propose_corrections"]
    assert pr["wall_ms"] > 0 and pr["device_ms"] > 0 and pr["host_ms"] >= 0
    assert pr["proposals"] == len(pr["pairs"])
    lt = out["ltvm_curate"]
    assert lt["vectors"] >= 1 and lt["wall_ms"] > 0
    for k in ("sdf_ms", "filter_ms", "ransac_ms", "merge_ms"):
        assert lt[k] >= 0
    assert lt["sdf_ms"] + lt["ransac_ms"] <= lt["wall_ms"]
    cb = out["enml_checkerboard"]
    assert cb["scans"] == 160 and cb["nodes"] == 128
    stages = ("setup_ms", "match_ms", "gn_ms", "carry_scatter_ms",
              "covariance_ms")
    assert all(cb[k] > 0 for k in stages)
    assert sum(cb[k] for k in stages) <= cb["wall_ms"] * 1.01
    sh = out["sharded"]
    assert sh["partitions"] == 4
    for name, poses in (("map", 64), ("chain", 1024)):
        r = sh[name]
        assert r["poses"] == poses and r["wall_ms"] > 0
        assert r["lone_wall_ms"] > 0 and 0 < r["iterations"] <= 20
        assert r["final_cost"] <= r["lone_final_cost"] * 1.05 + 1e-4
        # the CPU runs the multi route's plain version: no launch
        assert r["multi_launches"] == r["batched_launches"] == 0
    assert sh["checkerboard_mesh"]["nodes"] == 128
    assert sh["checkerboard_mesh"]["ms_per_node"] > 0
    assert bench.main(["--device", "cpu", "--replays", "0"]) == 2
