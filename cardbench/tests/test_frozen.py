"""The frozen copies' own outputs, pinned by hash (never the port's: the
yardstick keeps its value when the program moves), the traffic's specs
against the frozen session's, and the control's rounding."""

import hashlib

import numpy as np

from cardbench import harness
from cardbench.frozen import figure8, sessions, work
from cardbench.mixes.corrections import decode_specs
from cardbench.reference.precision import TF32

MAP_SHA = "d8e1ab07a32cbb1b"   # 1024 poses, 180 rays, map seed 7
SKETCH_SHA = "e311d487e81a58fe"  # the first spec sketched on the 128-pose map


def _sha(m):
    d = hashlib.sha256()
    for a in [m.poses, m.gt_poses, m.covariances, m.odometry,
              *m.point_clouds, *m.normal_clouds]:
        d.update(np.ascontiguousarray(a).tobytes())
    return d.hexdigest()[:16]


def test_generator_pinned():
    cfg = harness.find_cell("hitl-figure8-1024.corrections").config
    m = figure8.generate_figure8(**cfg["map"])
    assert _sha(m) == MAP_SHA
    assert sum(len(p) for p in m.point_clouds) == 157684


def test_traffic_specs_are_the_frozen_session():
    cell = harness.find_cell("hitl-figure8-1024.corrections")
    for P in (128, 1024):
        got = decode_specs(cell.traffic["specs"], P)
        want = sessions.correction_specs(P)
        for g, w in zip(got, want, strict=True):
            assert g == w


def test_sketch_pinned():
    m = figure8.generate_figure8(num_poses=128, num_rays=40, seed=7,
                                 drift_theta_bias=6e-4, num_laps=2)
    sel = sessions.sketch(m, sessions.correction_specs(128)[0], m.poses)
    assert sel.shape == (4, 2) and sel.dtype == np.float32
    assert hashlib.sha256(sel.tobytes()).hexdigest()[:16] == SKETCH_SHA


def test_work_pinned():
    mask = np.zeros((1024, 256), bool)
    mask[:, :180] = True
    assert work.em_scan_work(mask) == (2367536, 12926976)
    assert work.bcr_work(1024) == (98268, 460407)
    assert work.bound_s(98268, 460407) == 98268 / 3.35e12


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 20.06, -3.14159])
    r = TF32.q(x)
    assert r[0] == 1.0 and r[1] == 1.0          # a tie rounds to even
    assert r[2] == 1.0 + 2.0 ** -9
    assert np.all(np.abs(r - x) <= np.abs(x) * 2.0 ** -11)
    assert np.all(np.abs(r - x)[3:] > 0)
