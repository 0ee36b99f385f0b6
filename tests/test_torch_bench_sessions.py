"""The reference's HitL bench sessions on the port (hitl_slam_torch/
bench_sessions.py) against the JAX package on the CPU, on the same maps:
the headline session at its 1024 poses (40 rays a scan, so 128 padded
points), its pipelined chain, and the 8192- and 16384-pose sessions with
their corrections scaled to 1152 poses; the JAX record that chip_smoke.py
reads on the card; and `python -m hitl_slam_torch.bench --headline` at its
smoke size."""

import json

import numpy as np
import pytest
import torch

from hitl_slam_torch import bench_sessions as S
from hitl_slam_torch.io.figure8 import generate_figure8
from hitl_slam_tpu.core.state import CorrectionType as JCorrectionType
from hitl_slam_tpu.core.state import SingleInput as JSingleInput
from hitl_slam_tpu.models.hitl.engine import HitLSLAM as JHitLSLAM

torch.set_num_threads(2)

LOOSE = (0.02, 0.01)     # tests/test_golden.py: 2 cm / 10 mrad
# the scaled sessions' pose count: the smallest multiple of 128 from 1024
# to 2048 at which the JAX package accepts all three corrections of the
# 8192-pose session; no such count accepts the first correction of the
# 16384-pose session (lap 4 against lap 1; "selection overlap / no
# backprop window" at every one), so that session runs at the same count,
# where the JAX package accepts the other two
SCALED_POSES = 1152


def _pose_errors(got, want):
    dth = np.arctan2(np.sin(got[:, 2] - want[:, 2]),
                     np.cos(got[:, 2] - want[:, 2]))
    return (float(np.abs(got[:, :2] - want[:, :2]).max()),
            float(np.abs(dth).max()))


def _jax_session(m, specs, capacity, odometry):
    """The same session on the JAX engine: flags and iterations per spec
    (None where it was not sketched), rows, and the poses after each
    accepted cycle."""
    eng = JHitLSLAM()
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             odometry=m.odometry if odometry else None,
             constraint_capacity=capacity)
    accepted, iters, after = [], [], []
    for s in specs:
        try:
            sel = S.sketch(m, s, eng.get_poses())
        except ValueError:
            accepted.append(None)
            iters.append(None)
            continue
        rep = eng.replay_log(JSingleInput(JCorrectionType(int(s["ctype"])),
                                          0, sel))
        accepted.append(bool(rep.accepted))
        iters.append(int(rep.lm_iterations))
        if rep.accepted:
            after.append(eng.get_poses())
    return dict(accepted=accepted, lm_iterations=iters,
                rows=int(eng.num_constraints), accepted_poses=after,
                poses=eng.get_poses())


@pytest.fixture(scope="module")
def headline_map():
    return generate_figure8(**dict(S.HEADLINE_MAP, num_rays=40))


@pytest.fixture(scope="module")
def headline(headline_map):
    return S.headline_section("cpu", m=headline_map, sessions=1, warmup=0)


@pytest.fixture(scope="module")
def jax_headline(headline_map):
    return _jax_session(headline_map, S.correction_specs(1024),
                        S.HEADLINE_CAPACITY, odometry=True)


def _plain(spec):
    """A spec in the fixture's JSON layout."""
    def pair(v):
        return None if v is None else list(v)

    return dict(ctype=int(spec["ctype"]),
                corrected=[spec["corrected"].start, spec["corrected"].stop],
                anchor=[spec["anchor"].start, spec["anchor"].stop],
                cw=list(spec["cw"]), aw=list(spec["aw"]),
                cspan=pair(spec["cspan"]), aspan=pair(spec["aspan"]),
                min_points=spec["min_points"])


def test_fixture_loads_with_what_chip_smoke_reads():
    """tests/data/scale_sessions_jax.{json,npz} (scripts/
    make_scale_fixture.py) hold every key and array phase 17 reads, at the
    reference's sizes, and the port's specs at the reference's pose counts
    are the ones the JAX package ran."""
    import chip_smoke

    fx, arrays = chip_smoke.load_scale_fixture()
    assert arrays["headline_poses"].shape == (1024, 3)
    assert arrays["s8192_poses"].shape == (8192, 3)
    assert arrays["s16384_poses"].shape == (16384, 3)
    n = fx["s8192"]["rows"]
    for k in chip_smoke.SCALE_FIXTURE_ARRAYS:
        if k.startswith("s8192_table_"):
            assert arrays[k].shape == (n,), k
    assert fx["headline"]["accepted"] == [True, True, True, False, True]
    assert all(fx["headline"]["chain"]["accepted"])
    assert len(fx["headline"]["chain"]["lm_iterations"]) == 4
    for key in ("s8192", "s16384"):
        assert fx[key]["accepted"] == [True] * 3
        g = fx[key]["gt_mean"]
        assert g["after"] < g["before"]
    for k in ("matches", "match_dropped", "vote_dropped", "elect_dropped",
              "final_cost", "initial_cost"):
        assert k in fx["s8192"]["refine"], k
    assert fx["s16384"]["f64"]["relative"] < chip_smoke.SCALE_F64_RTOL
    assert fx["headline"]["map"] == S.HEADLINE_MAP
    assert fx["s8192"]["map"] == S.SCALE_MAPS[8192]
    assert fx["s16384"]["map"] == S.SCALE_MAPS[16384]
    for key, specs in (("headline", S.correction_specs(1024)),
                       ("s8192", S.specs_8192()),
                       ("s16384", S.specs_16384())):
        assert fx[key]["specs"] == [_plain(s) for s in specs], key


def test_headline_session_matches_jax(headline, jax_headline):
    """The five mixed corrections on the 1024-pose map: the accept/reject
    sequence and the constraint rows exact, the final poses at the loose
    golden tolerance of the JAX engine's."""
    assert headline["accepted"] == jax_headline["accepted"]
    assert headline["rows"] == jax_headline["rows"]
    assert headline["dropped_rows"] == [0] * 5
    dxy, dth = _pose_errors(headline["_poses"], jax_headline["poses"])
    assert dxy <= LOOSE[0] and dth <= LOOSE[1], (dxy, dth)
    g = headline["gt_aligned"]
    assert g["after"] < g["before"]
    w = headline["cycle_wall_ms"]
    assert 0 < w["min"] <= w["q1"] <= w["median"] <= w["q3"]
    assert w["n"] == sum(bool(a) for a in headline["accepted"])


def test_chain_matches_the_sequential_session(headline, jax_headline):
    """queue_chain over the first four accepted corrections, twice from
    the initial state: every cycle accepted, the first repetition equal to
    the port's sequential session after the same corrections and at the
    loose golden tolerance of the JAX engine's; host reads counted."""
    chain = S.chain_section("cpu", headline, j_rep=2, samples=1)
    k = chain["cycles"]
    assert k == min(4, len(headline["_session"]["accepted_inputs"]))
    assert chain["accepted"] == [True] * k and chain["finite"]
    np.testing.assert_allclose(
        chain["_first_poses"], headline["_session"]["accepted_poses"][k - 1],
        atol=1e-5)
    dxy, dth = _pose_errors(chain["_first_poses"],
                            jax_headline["accepted_poses"][k - 1])
    assert dxy <= LOOSE[0] and dth <= LOOSE[1], (dxy, dth)
    assert chain["first_lm_iterations"] == [
        i for i, a in zip(headline["lm_iterations"], headline["accepted"])
        if a][:k]
    assert chain["ms_per_cycle"] > 0
    # the LM reads its exit flag back every iteration; the CPU has no
    # device operation to count
    assert chain["host_reads_per_cycle"] >= 1
    assert chain["device_ops_per_cycle"] is None


@pytest.mark.parametrize("size", [8192, 16384])
def test_scaled_session_matches_jax(size):
    """The 8192- and 16384-pose sessions' recipes at 1152 poses: flags and
    rows exact, poses at the loose golden tolerance of the JAX engine's,
    the ground-truth error down; the 16384-pose one also within 5e-3 of
    the f64 solve of its last cycle's problem."""
    m = generate_figure8(**dict(S.SCALE_MAPS[size], num_poses=SCALED_POSES))
    out = S.scale_session_section("cpu", size, m=m, warmup=False,
                                  refine=False)
    want = _jax_session(m, S.SCALE_SPECS[size](SCALED_POSES),
                        S.SCALE_CAPACITY, odometry=False)
    assert out["accepted"] == want["accepted"]
    assert out["rows"] == want["rows"]
    assert out["accepted_cycles"] == (3 if size == 8192 else 2)
    dxy, dth = _pose_errors(out["_poses"], want["poses"])
    assert dxy <= LOOSE[0] and dth <= LOOSE[1], (dxy, dth)
    g = out["gt_mean"]
    assert g["after"] < g["before"]
    assert out["peak_memory_mib"] is None
    if size == 16384:
        assert out["f64"]["relative"] <= 5e-3
        assert out["f64"]["last_cycle_cost"] == [
            c for c in out["final_cost"] if c is not None][-1]
    else:
        assert "f64" not in out


def test_bench_headline_smoke(capsys):
    """python -m hitl_slam_torch.bench --device cpu --headline --smoke:
    one JSON line with the headline, chain, solve-only and joint-solve
    sections; --scale takes only the reference's sizes."""
    from hitl_slam_torch import bench

    assert bench.main(["--device", "cpu", "--headline", "--smoke"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["name"] == "cpu" and "scale" not in out
    h = out["headline"]
    assert h["poses"] == 128 and h["rows"] > 0
    assert not any(k.startswith("_") for k in h)
    assert h["chain"]["j_rep"] == 2 and all(h["chain"]["accepted"])
    so = h["solve_only"]
    assert so["snapshots"] == sum(bool(a) for a in h["accepted"])
    assert so["ms_per_solve"] > 0 and so["cpu_lm_ms"] > 0
    assert so["scipy_ms"] > 0
    js = h["joint_solve"]
    assert js["poses"] == 512 and js["finite"]
    assert js["final_cost"] < js["initial_cost"]
    assert bench.main(["--device", "cpu", "--scale", "4096"]) == 2
