"""The reference's whole bench record on the port (hitl_slam_torch/
bench_reference.py): its keys against the reference's own record
(BENCH_DETAIL.json, read as data: no number of it is used), and its
sections against the JAX package on the CPU at the reference's smoke sizes
(the 128-pose, 40-ray headline map, capacity 2048; EnML on 24 scans of 60
rays): speculation and the forced misses, the refine of the headline's
final state with its f64 baseline, EnML, and the bag's two read routes.

The port's record runs once for the module, through the command line's
parser, at its smoke size on the CPU."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from hitl_slam_torch import bench, bench_reference as B
from hitl_slam_torch import bench_sessions as S

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_enml.py's whole-sweep pose tolerance (m / rad)
ENML_POSE_ATOL = 1e-4
# the refine's final cost against the JAX package's, and the two f64
# baselines against each other on the same factors
REFINE_COST_RTOL = 1e-4
F64_ATOL = 1e-9


def _reference_detail() -> dict:
    with open(os.path.join(REPO, "BENCH_DETAIL.json")) as f:
        return json.load(f)["detail"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """`bench --reference --smoke --device cpu --out PATH`: (the printed
    lines, the record written to PATH, the sections with their arrays)."""
    out = tmp_path_factory.mktemp("reference") / "record.json"
    args = bench.parser().parse_args(
        ["--reference", "--smoke", "--device", "cpu", "--out", str(out)])
    keep = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert B.main(args, torch.device("cpu"), keep=keep) == 0
    with open(out) as f:
        written = json.load(f)
    return buf.getvalue().strip().splitlines(), written, keep


@pytest.fixture(scope="module")
def jax_engine_cls():
    from hitl_slam_tpu.models.hitl.engine import HitLSLAM

    return HitLSLAM


def _jax_engine(cls, m, capacity):
    eng = cls()
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             odometry=m.odometry, constraint_capacity=capacity)
    return eng


@pytest.fixture(scope="module")
def jax_speculative(port_run, jax_engine_cls):
    """bench.py:310-393 on the JAX engine, on the port's headline map: the
    natural script (hits, attempts, accepted flags, the engine after it)
    and the two forced misses (hits before and after each, accepted)."""
    import dataclasses

    import jax.numpy as jnp

    head = port_run[2]["headline"]
    m, capacity = head["_map"], head["capacity"]
    specs = S.correction_specs(m.poses.shape[0])
    eng = _jax_engine(jax_engine_cls, m, capacity)
    accepted = []
    for s in specs:
        try:
            sel = S.sketch(m, s, eng.get_poses())
        except ValueError:
            continue
        B._click(eng, int(s["ctype"]), sel)
        accepted.append(bool(eng.run().accepted))
    natural = dict(hits=eng.speculative_hits, attempts=len(accepted),
                   accepted=accepted, engine=eng)
    eng = _jax_engine(jax_engine_cls, m, capacity)
    misses = {}
    for kind, s in zip(B.MISS_KINDS, specs):
        sel = S.sketch(m, s, eng.get_poses())
        ct = int(s["ctype"])
        B._click(eng, ct, sel)
        if kind == "reselect":
            eng.speculate = False
            B._click(eng, ct, np.stack([sel[0] + B.RESELECT_NUDGE,
                                        sel[1] + B.RESELECT_NUDGE, sel[2],
                                        sel[3]]).astype(np.float32))
            eng.speculate = True
        else:
            eng.state = dataclasses.replace(
                eng.state, poses=jnp.asarray(np.asarray(eng.state.poses)))
        before = eng.speculative_hits
        rep = eng.run()
        misses[kind] = dict(before=before, after=eng.speculative_hits,
                            accepted=bool(rep.accepted))
    return natural, misses


def test_every_reference_key_is_mapped_or_not_ported():
    """Each key of the reference's record is given by a named section of
    the port or listed, with its reason, in NOT_PORTED, which holds
    xla_analysis alone; the map names no key the reference lacks."""
    ref = _reference_detail()
    assert set(B.KEY_MAP) | set(B.NOT_PORTED) == set(ref)
    assert not set(B.KEY_MAP) & set(B.NOT_PORTED)
    assert list(B.NOT_PORTED) == ["xla_analysis"]
    assert all(len(r) > 20 for r in B.NOT_PORTED.values())
    sections = {"device", "headline", "chain", "solve_only", "joint_solve",
                "overhead", "speculative", "replicas", "refine",
                "scale_8192", "scale_16384", "enml", "enml_scale", "memory",
                "bag_ingest"}
    assert set(B.KEY_MAP.values()) == sections
    assert set(B.SMOKE_LEFT_OUT) <= sections
    assert not set(B.PORT_KEYS) & set(ref)


def test_reference_smoke_record(port_run):
    """The last printed line is one JSON object, the same as the file
    --out wrote; its detail holds exactly the keys the reference's smoke
    mode gives (every key but the scale sessions' and the scale map's), in
    the reference's order, less NOT_PORTED, with device_analysis in
    xla_analysis' place; every value is set but W = 80's, which the
    reference leaves out at its smoke size, and the device's peak memory
    (and the native bag route's rate where the scanner does not build)."""
    lines, written, _ = port_run
    rec = json.loads(lines[-1])
    assert rec == written
    assert rec["unit"] == "ms" and rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["device"]["name"] == "cpu"
    ref = _reference_detail()
    left = {k for k, v in B.KEY_MAP.items() if v in B.SMOKE_LEFT_OUT}
    want = [k if k != "xla_analysis" else "device_analysis"
            for k in ref if k not in left]
    d = rec["detail"]
    assert list(d) == want
    from hitl_slam_torch import native

    # no device memory on the CPU; the bag's native route where it builds
    nulls = {"hbm_peak_mb", "enml_w80_checkerboard_ms"}
    if not native.bag_available():
        nulls.add("bag_ingest_mb_s")
    assert {k for k, v in d.items() if v is None} == nulls
    assert rec["notes"]["left_out"] == [*B.SMOKE_LEFT_OUT,
                                        "enml_w80_checkerboard_ms"]
    assert d["backend"] == "cpu" and d["tunnel_rtt_ms"] > 0
    assert d["device_cycle_ms"] == d["pipelined_cycle_ms"] == rec["value"]
    assert d["interactive_dispatch_overhead_ms"] == max(
        d["interactive_cycle_ms"] - d["pipelined_cycle_ms"], 0.0)
    assert d["vs_optimized_cpu_refine"] == (d["cpu_refine_solve_ms"]
                                            / d["post_optimize_lm_ms"])
    assert d["accepted"] == rec["notes"]["speculative"]["accepted"]
    assert set(d["device_analysis"]) == {
        "cycle_chain", "solve_8192", "refine_1024", "enml_batch"}
    for entry in d["device_analysis"].values():
        assert entry["wall_ms"] > 0 and entry["input_bytes"] > 0
        assert entry["device_ms"] is None     # no device on the CPU
    assert all(s["seconds"] > 0 for s in rec["notes"]["sections"].values())


def test_speculation_matches_jax(port_run, jax_speculative):
    """The natural script: hits, attempts and accepted flags equal to the
    JAX engine's, every cycle a hit, each hit bit-equal to the port's own
    non-speculative replay; the forced misses leave the hits where they
    were in both packages, and each miss's state equals the non-speculative
    cycle's."""
    spec = port_run[2]["speculative"]
    natural, misses = jax_speculative
    assert spec["attempts"] == natural["attempts"] == 5
    assert spec["hits"] == natural["hits"] == spec["attempts"]
    assert spec["accepted"] == natural["accepted"]
    assert all(spec["hit"]) and all(spec["bit_equal_to_replay"])
    assert len(spec["ms_accepted"]) == sum(spec["accepted"])
    for kind in B.MISS_KINDS:
        assert misses[kind]["after"] == misses[kind]["before"], kind
        assert spec["miss_accepted"][kind] == misses[kind]["accepted"]
        assert spec["miss_equal_to_replay"][kind], kind
    assert set(spec["miss_ms_per_kind"]) == {
        k for k in B.MISS_KINDS if spec["miss_accepted"][k]}


def test_refine_matches_jax_from_jax_state(port_run, jax_speculative):
    """The refine section on the JAX session's own final poses and rows
    (the port's map points): matches and drops equal to the JAX package's
    same halves, LM iterations equal or apart only by rejected trials at
    the f32 floor, the final cost within 1e-4 of JAX's, and the port's f64
    cpu_refine_solve equal to the JAX package's to 1e-9 on the same
    factors."""
    import jax
    import jax.numpy as jnp

    from hitl_slam_torch.core.state import table_from_numpy
    from hitl_slam_torch.models.hitl.refine import (
        match_factors_global as port_match)
    from hitl_slam_torch.solver.lm import LMConfig as PLMConfig
    from hitl_slam_torch.solver.stf_solve import stf_lm_solve as port_lm
    from hitl_slam_tpu.baselines.cpu_refine import (
        cpu_refine_solve as jax_cpu_refine)
    from hitl_slam_tpu.models.hitl.refine import match_factors_global
    from hitl_slam_tpu.solver.lm import LMConfig
    from hitl_slam_tpu.solver.stf_solve import stf_lm_solve

    from torch_port_helpers import np_fields

    jeng = jax_speculative[0]["engine"]
    jst = jeng.state
    port_state = port_run[2]["headline"]["_session"]["engine"].state
    state = port_state.replace(
        poses=torch.as_tensor(np.array(jst.poses)),
        constraints=table_from_numpy(np_fields(jst.constraints), "cpu"))
    out = B.headline_refine_section("cpu", state)

    cfg = LMConfig(max_iterations=B.REFINE_CONFIG.max_iterations)
    pts = jnp.asarray(port_state.points.numpy())
    nrm = jnp.asarray(port_state.normals.numpy())
    msk = jnp.asarray(port_state.point_mask.numpy())
    stf, matches = jax.jit(lambda p, q: match_factors_global(
        p, nrm, msk, q, capacity=B.REFINE_CAPACITY))(pts + 1e-6, jst.poses)
    warm = stf_lm_solve(jst.poses, jst.constraints, stf, config=cfg,
                        fused_eval=True)
    timed = stf_lm_solve(jst.poses + 1e-6, jst.constraints, stf, config=cfg,
                         fused_eval=True)
    assert out["matches"] == int(warm.num_matches)
    assert out["match_dropped"] == int(matches.dropped)
    assert out["iterations"] == out["lm_warm_iterations"]
    assert out["lm_final_cost"] == out["final_cost"]
    # the LM counts: equal, or apart by trials at the cost's f32 floor (the
    # ROADMAP's trap of LM counts at the f32 floor): the package that ran
    # further gained less than the LM's function tolerance over its extra
    # iterations (its own run capped at the other's count)
    pstf = port_match(state.points + 1e-6, state.normals, state.point_mask,
                      state.poses, capacity=B.REFINE_CAPACITY)[0]
    for shift, got, want, jres in ((0.0, out["iterations"], warm.iterations,
                                    warm),
                                   (1e-6, out["lm_iterations"],
                                    timed.iterations, timed)):
        want = int(want)
        if got > want:
            full, capped = (float(port_lm(
                state.poses + shift, state.constraints, pstf,
                config=PLMConfig(max_iterations=k),
                fused_eval=True).final_cost) for k in (got, want))
        elif got < want:
            full = float(jres.final_cost)
            capped = float(stf_lm_solve(
                jst.poses + shift, jst.constraints, stf,
                config=LMConfig(max_iterations=got),
                fused_eval=True).final_cost)
        else:
            continue
        assert 0.0 <= capped - full <= cfg.function_tolerance * capped, (
            got, want, capped, full)
    f64_poses, f64_cost, f64_iters = jax_cpu_refine(
        np.asarray(jst.poses), S._np_table(state.constraints,
                                           state.constraints.capacity),
        out["_stf"], max_iterations=cfg.max_iterations)
    assert out["cpu_iterations"] == f64_iters
    assert abs(out["cpu_final_cost"] - f64_cost) <= F64_ATOL
    np.testing.assert_allclose(out["_f64_poses"], f64_poses, rtol=0,
                               atol=F64_ATOL)
    assert out["f64_relative"] < 1e-3


def test_enml_matches_jax(port_run):
    """EnML on the 24-scan, 60-ray stream: nodes, padded points a node,
    the mask's occupancy and the state's MB equal to the JAX package's;
    the timed sweep's poses within tests/test_torch_enml.py's tolerance of
    the JAX sweep's from the same input."""
    from hitl_slam_tpu.core.state import make_map_state
    from hitl_slam_tpu.io.figure8 import generate_raw_stream
    from hitl_slam_tpu.models.enml.driver import EpisodeOptions, build_episodes
    from hitl_slam_tpu.models.enml.localizer import EnmlOptions, batch_localize

    e = port_run[2]["enml"]
    scans, angles, rel, _, _ = generate_raw_stream(**B.ENML_STREAM_SMOKE)
    poses, pcs, ncs, _ = build_episodes(
        scans, angles, rel, EpisodeOptions(clip_low=10, clip_high=10))
    st = make_map_state(poses, np.zeros((len(poses), 3, 3), np.float32),
                        pcs, ncs)
    assert e["scans"] == len(scans)
    assert e["nodes"] == st.num_poses
    assert e["padded_n"] == st.points.shape[1]
    assert e["points"] == int(np.asarray(st.point_mask).sum())
    assert e["mask_occupancy"] == pytest.approx(
        float(np.asarray(st.point_mask).mean()), abs=1e-7)
    assert e["state_mb"] == (st.points.nbytes + st.normals.nbytes
                             + st.point_mask.nbytes) / 1e6
    jp, _ = batch_localize(st.points + 1e-6, st.normals, st.point_mask,
                           st.poses, EnmlOptions(gn_unroll=2))
    jp = np.asarray(jp)
    dth = np.arctan2(np.sin(e["_poses"][:, 2] - jp[:, 2]),
                     np.cos(e["_poses"][:, 2] - jp[:, 2]))
    assert np.abs(e["_poses"][:, :2] - jp[:, :2]).max() <= ENML_POSE_ATOL
    assert np.abs(dth).max() <= ENML_POSE_ATOL
    assert e["w80_checkerboard_ms"] is None
    assert e["sequential_ms"] > 0 and e["checkerboard_ms"] > 0


def test_bag_ingest_routes(port_run):
    """The ingest bag read by the native scanner and by Python: the same
    messages, as many as were written (1280)."""
    from hitl_slam_torch import native

    bag = port_run[2]["bag_ingest"]
    assert bag["written"] == len(B.bag_messages()) == 64 * B.BAG_REPEAT
    assert bag["routes"]["python"]["messages"] == bag["written"]
    if not native.bag_available():
        pytest.skip("the native bag scanner does not build here (no g++)")
    assert bag["routes"]["native"]["messages"] == bag["written"]
    assert bag["routes_equal"] is True
