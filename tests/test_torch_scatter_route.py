"""The 8192-pose configuration's session on the CPU, on the route its card
runs take: `build_problem` reducing the human table to poses by the
scatter-add (solver/joint.py: past ONEHOT_BUDGET elements of the [C, P]
selector, as at 8192 poses and 32768 rows), held against the JAX
reference's `build_problem` and engine on the same route (ONEHOT_BUDGET 0
in both packages), and against the port's own one-hot route from the same
state.

Two maps of the configuration (cardbench/configs/hitl-figure8-8192.json,
its colinear session bench_sessions.specs_8192, the map's odometry handed
to the engine as the benchmark's mix does): its CPU cut
(cardbench/tiny/hitl-figure8-8192.json, 768 poses), where the session
decides as the full map does on the card (the second stroke accepted, the
first and third refused for overlapping selections), and 1024 poses, where
all three strokes are accepted and the LM runs 8-10 iterations."""

import json
import os

import numpy as np
import pytest
import torch

from hitl_slam_torch.bench_sessions import sketch, specs_8192
from hitl_slam_torch.core.state import SingleInput
from hitl_slam_torch.io.figure8 import generate_figure8
from hitl_slam_torch.models.hitl.engine import HitLSLAM
from hitl_slam_torch.ops import residuals
from hitl_slam_torch.solver import joint
from hitl_slam_torch.utils.device_loop import clone_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(
    ROOT, "cardbench", "configs", "hitl-figure8-8192.json")))
CUT = json.load(open(os.path.join(
    ROOT, "cardbench", "tiny", "hitl-figure8-8192.json")))
CUT_POSES = CUT["map"]["num_poses"]
MAPS = (CUT_POSES, 1024)
# the decisions of the session on the full 8192-pose map on the card
# (H100, the port's engine; PERF.md section 4)
FULL_MAP_DECISIONS = [False, True, False]


def _routes(module):
    """(a list that records, per `module.compact_human_factors` call,
    whether it had a one-hot selector; undo)."""
    routes = []
    inner = module.compact_human_factors

    def compact(human, poses, onehot=None):
        routes.append(onehot is not None)
        return inner(human, poses, onehot)

    module.compact_human_factors = compact
    return routes, lambda: setattr(module, "compact_human_factors", inner)


def _replay(eng, spec, sel, budget):
    """One correction on the port's engine with ONEHOT_BUDGET `budget`:
    what it left, copied, and the routes its build_problem took."""
    routes, undo = _routes(residuals)
    saved, joint.ONEHOT_BUDGET = joint.ONEHOT_BUDGET, budget
    try:
        rep = eng.replay_log(SingleInput(spec["ctype"], 0, sel))
    finally:
        joint.ONEHOT_BUDGET = saved
        undo()
    return dict(report=rep, routes=routes, poses=eng.get_poses(),
                pre=(eng.last_pre_solve_poses.clone() if rep.accepted
                     else None),
                table=clone_tree(eng.state.constraints))


class _Reference:
    """The JAX engine with its build_problem on the scatter-add
    (ONEHOT_BUDGET 0) while `replay` runs; `routes` records the routes its
    build_problem took while traced."""

    def __init__(self):
        from hitl_slam_tpu.core.state import SingleInput
        from hitl_slam_tpu.models.hitl.engine import HitLSLAM as JHitLSLAM
        from hitl_slam_tpu.ops import residuals as jres
        from hitl_slam_tpu.solver import joint as jjoint

        self.SingleInput, self.HitLSLAM = SingleInput, JHitLSLAM
        self.res, self.joint = jres, jjoint
        self.routes = []

    def engine(self, m=None, state=None, num_constraints=0, capacity=0):
        """A JAX engine on map `m`, or on the port's MapState `state`."""
        eng = self.HitLSLAM()
        eng.speculate = False
        if m is not None:
            eng.init(m.poses, m.covariances, m.point_clouds,
                     m.normal_clouds, odometry=m.odometry,
                     constraint_capacity=capacity)
        else:
            eng.init_from_state(_to_jax(state))
            eng.num_constraints = num_constraints
        return eng

    def replay(self, eng, spec, sel):
        """(report, poses, pre-solve poses) of one correction on `eng`."""
        routes, undo = _routes(self.res)
        saved, self.joint.ONEHOT_BUDGET = self.joint.ONEHOT_BUDGET, 0
        try:
            rep = eng.replay_log(self.SingleInput(spec["ctype"], 0, sel))
        finally:
            self.joint.ONEHOT_BUDGET = saved
            undo()
        self.routes += routes
        pre = (np.asarray(eng.last_pre_solve_poses) if rep.accepted
               else None)
        return rep, np.asarray(eng.get_poses()), pre


def _to_jax(obj):
    """The JAX package's namesake of a port dataclass of tensors."""
    import dataclasses

    import jax.numpy as jnp

    from hitl_slam_tpu.core import state as jstate

    cls = getattr(jstate, type(obj).__name__)
    return cls(**{f.name: (_to_jax(v) if dataclasses.is_dataclass(v)
                           else jnp.asarray(v.numpy()))
                  for f in dataclasses.fields(obj)
                  for v in [getattr(obj, f.name)]})


@pytest.fixture(scope="module", params=MAPS, ids=lambda p: f"P{p}")
def session(request):
    """The session at P poses on the scatter-add route, each stroke
    sketched against the poses of the moment; beside each correction, the
    same correction from the same state on the one-hot route (a twin
    engine); and the JAX engine's session on the scatter-add with the same
    clicks."""
    P = request.param
    m = generate_figure8(**dict(CONFIG["map"], num_poses=P))
    capacity = CONFIG["constraint_capacity"]
    specs = specs_8192(P)
    eng = HitLSLAM(device="cpu")
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             odometry=m.odometry, constraint_capacity=capacity)
    ref = _Reference()
    sels, scatter, onehot, twins = [], [], [], []
    for spec in specs:
        sel = sketch(m, spec, eng.get_poses())
        twin = HitLSLAM(device="cpu")
        twin.init_from_state(clone_tree(eng.state))
        twin.num_constraints = eng.num_constraints
        onehot.append(_replay(twin, spec, sel, joint.ONEHOT_BUDGET))
        twins.append(ref.replay(ref.engine(
            state=eng.state, num_constraints=eng.num_constraints), spec, sel))
        scatter.append(_replay(eng, spec, sel, 0))
        sels.append(sel)
    whole = ref.engine(m, capacity=capacity)
    chained = [ref.replay(whole, spec, sel) for spec, sel in zip(specs, sels)]
    return dict(P=P, scatter=scatter, onehot=onehot, ref=twins,
                ref_session=chained, ref_routes=ref.routes)


def _decisions(a, b):
    for f in ("accepted", "reason", "points_verified",
              "num_new_constraints", "dropped_rows"):
        assert getattr(a, f) == getattr(b, f), f


def test_session_decides_as_the_full_map(session):
    """At the CPU cut the strokes are accepted and refused as on the full
    map on the card; at 1024 poses all three are accepted. Every accepted
    stroke writes rows and loses none to the table."""
    reports = [r["report"] for r in session["scatter"]]
    want = (FULL_MAP_DECISIONS if session["P"] == CUT_POSES
            else [True] * 3)
    assert [r.accepted for r in reports] == want, [r.reason for r in reports]
    for r in reports:
        assert r.dropped_rows == 0
        assert r.accepted == (r.num_new_constraints > 0)
        if not r.accepted:
            assert "overlap" in r.reason


def _poses_gap(a, b) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    return float(np.abs(d).max())


@pytest.mark.parametrize("k", range(3))
def test_correction_matches_the_reference(session, k):
    """Correction k of the port's session against the JAX engine's from the
    same state (the port's before it) and clicks, both on the scatter-add:
    the same decisions and rows; the pre-solve poses within 0.02 m / rad,
    the 1024-pose cell's `pre_solve_gap` limit (the EM refit's f32 sums in
    another order turn a long stroke's fit a little: 3.0e-3 at 1024 poses,
    the third stroke). Both then solve in f32 with sums in another order,
    so their LMs may stop iterations apart in the flat valley of the cost,
    where poses move unseen by it (PERF.md section 2: up to 0.031 m at 1024
    poses between two f32 solvers): the final costs agree within 1e-3 of
    1 + the initial cost (the benchmark's `cost_gap` limit is 2e-3 of it)
    and the poses within 5e-3 m / rad."""
    got = session["scatter"][k]
    rep, poses, pre = session["ref"][k]
    a = got["report"]
    _decisions(a, rep)
    if not rep.accepted:
        return
    assert _poses_gap(got["pre"].numpy(), pre) <= 0.02
    assert abs(a.final_cost - rep.final_cost) <= 1e-3 * (1 + rep.initial_cost)
    assert _poses_gap(got["poses"], poses) <= 5e-3


def test_session_matches_the_reference_session(session):
    """The port's whole session against the JAX engine's, each from the
    initial map with the same clicks: the same decisions and rows, stroke
    by stroke, and after each stroke poses within 1e-2 m / rad (each
    stroke starts where the last one's f32 LM stopped, so the gaps of the
    test above add up along the session)."""
    for got, (rep, poses, _) in zip(session["scatter"],
                                 session["ref_session"]):
        _decisions(got["report"], rep)
        assert _poses_gap(got["poses"], poses) <= 1e-2


def test_reference_session_took_the_scatter_add(session):
    """The JAX engine's build_problem was traced without a one-hot
    selector (and was traced: a cached trace would not show here)."""
    routes = session["ref_routes"]
    assert routes and not any(routes)


@pytest.mark.parametrize("k", range(3))
def test_build_problem_scatter_add_matches_the_reference(session, k):
    """build_problem on correction k's pre-solve poses and table by the
    scatter-add, the port's against the JAX reference's (ONEHOT_BUDGET 0
    in both): the same human rows and active mask, the odometry factors
    and row targets within 1e-6 of their scale (the same f32 formulas,
    a few ulp apart where XLA fuses), and the per-pose sums A and c within
    1e-5 of each one's largest entry and k within 1e-5 relative (two f32
    sums of the same rows in another order: a few ulp of the largest
    terms)."""
    import jax.numpy as jnp

    from hitl_slam_tpu.core.state import ConstraintTable as JTable
    from hitl_slam_tpu.solver import joint as jjoint

    one = session["scatter"][k]
    if one["pre"] is None:
        # a refused stroke: no pre-solve poses, no rows
        rep = one["report"]
        assert not rep.accepted and rep.num_new_constraints == 0
        return
    pre, table = one["pre"], one["table"]
    saved, joint.ONEHOT_BUDGET = joint.ONEHOT_BUDGET, 0
    try:
        got = joint.build_problem(pre, table)
    finally:
        joint.ONEHOT_BUDGET = saved
    jt = JTable(**{f: jnp.asarray(v.numpy())
                   for f, v in vars(table).items()})
    ref = jjoint.build_problem(jnp.asarray(pre.numpy()), jt,
                               use_onehot=False)

    def close(a, b, rel, name):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), 1.0)
        assert np.abs(a - b).max() <= rel * scale, name

    for f in ("pose_idx", "active"):
        np.testing.assert_array_equal(getattr(got.human, f).numpy(),
                                      np.asarray(getattr(ref.human, f)), f)
    for f in ("M", "target"):
        close(getattr(got.human, f), getattr(ref.human, f), 1e-6, f)
    for f in ("axis", "radial", "rotation", "inv_sigma"):
        close(getattr(got.odom, f), getattr(ref.odom, f), 1e-6, f)
    for f in ("A", "c"):
        close(getattr(got.compact, f), getattr(ref.compact, f), 1e-5, f)
    # k, the cost offset at the build-time poses: on the cost's scale
    k_ref = float(ref.compact.k)
    assert abs(float(got.compact.k) - k_ref) <= 1e-6 * (1 + k_ref)


@pytest.mark.parametrize("k", range(3))
def test_scatter_add_route_matches_the_onehot_route(session, k):
    """Correction k on both of the port's routes from the same state: the
    same decisions, and the same table rows and pre-solve poses bit for bit
    (both are made before the problem is built). The LM then solves
    problems whose per-pose sums differ in order (next test; on the CPU
    the accumulating index_put_ also sums in a run-dependent order), so it
    may stop a few iterations apart in the flat valley of the f32 cost:
    the final costs agree within 1e-5 of 1 + the initial cost (the scale
    of the benchmark's `cost_gap`, limit 2e-3) and the poses within
    5e-3 m / rad."""
    one, sc = session["onehot"][k], session["scatter"][k]
    assert not any(sc["routes"])
    assert all(one["routes"])
    a, b = one["report"], sc["report"]
    _decisions(a, b)
    assert one["routes"] and sc["routes"]
    if not a.accepted:
        return
    for name, v in vars(one["table"]).items():
        assert torch.equal(getattr(sc["table"], name), v), name
    assert torch.equal(sc["pre"], one["pre"])
    assert b.initial_cost == a.initial_cost
    assert abs(b.final_cost - a.final_cost) <= 1e-5 * (1 + a.initial_cost)
    np.testing.assert_allclose(sc["poses"], one["poses"], rtol=0, atol=5e-3)


@pytest.mark.parametrize("k", range(3))
def test_build_problem_routes_reduce_the_table_alike(session, k):
    """The port's build_problem on correction k's pre-solve poses and
    table, with the one-hot selector and by the scatter-add: the same
    odometry factors and human table, and per-pose sums A and c within
    1e-5 of each one's largest entry (two f32 sums of the same rows in
    another order: a few ulp of the largest terms)."""
    one = session["scatter"][k]
    if one["pre"] is None:
        # a refused stroke: no pre-solve poses, no rows
        rep = one["report"]
        assert not rep.accepted and rep.num_new_constraints == 0
        return
    pre, table = one["pre"], one["table"]
    ref = joint.build_problem(pre, table)
    saved, joint.ONEHOT_BUDGET = joint.ONEHOT_BUDGET, 0
    try:
        got = joint.build_problem(pre, table)
    finally:
        joint.ONEHOT_BUDGET = saved
    for name in ("pose_idx", "M", "target", "active"):
        assert torch.equal(getattr(got.human, name),
                           getattr(ref.human, name)), name
    for name, v in vars(ref.odom).items():
        assert torch.equal(getattr(got.odom, name), v), name
    assert torch.equal(got.compact.k, ref.compact.k)
    for name in ("A", "c"):
        want = getattr(ref.compact, name)
        gap = (getattr(got.compact, name) - want).abs().max()
        assert gap <= 1e-5 * want.abs().max(), name
