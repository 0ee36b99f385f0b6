"""Port parity: headless rasterization (ops/raster.py) and the GUI draw
lists (gui/drawlist.py, gui/display.py) against the JAX package. Images are
integer outputs and must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import n, np_fields, t

torch.set_num_threads(2)


def _states(small_map):
    from hitl_slam_torch.core.state import make_map_state as tmk

    m = small_map
    return tmk(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
               odometry=m.odometry, constraint_capacity=512, device="cpu")


def test_rasterize_points_keeps_the_channel_maximum():
    """Points of different colours on one pixel: every channel keeps its
    own maximum, as the reference's scatter-max; masked and out-of-frame
    points draw nothing; coordinates in (-1, 0) land in pixel 0 (a cast,
    not a floor)."""
    from hitl_slam_torch.ops import raster as TR
    from hitl_slam_tpu.ops import raster as JR

    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.5, 8.5, (4000, 2)).astype(np.float32)
    pts[:50] = pts[50:100]                    # exact duplicates
    pts[100:110, 0] = -0.03                   # in (-1, 0) pixels
    mask = rng.random(4000) > 0.2
    colors = rng.integers(0, 256, (4000, 3)).astype(np.uint8)
    origin = np.array([0.0, 0.0], np.float32)
    scale = np.float32(4.0)
    ref = np.asarray(JR.rasterize_points(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(colors),
        jnp.asarray(origin), jnp.asarray(scale), 32, 32))
    got = TR.rasterize_points(t(pts), t(mask), torch.as_tensor(colors),
                              t(origin), torch.tensor(4.0), 32, 32)
    assert got.dtype == torch.uint8 and got.shape == (32, 32, 3)
    np.testing.assert_array_equal(n(got), ref)
    assert (ref > 0).any()


def test_rasterize_lines_and_compose_exact():
    from hitl_slam_torch.ops import raster as TR
    from hitl_slam_tpu.ops import raster as JR

    rng = np.random.default_rng(1)
    p1 = rng.uniform(0, 10, (40, 2)).astype(np.float32)
    p2 = rng.uniform(0, 10, (40, 2)).astype(np.float32)
    mask = rng.random(40) > 0.3
    colors = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    origin = np.array([-1.0, -1.0], np.float32)
    ref = JR.rasterize_lines(jnp.asarray(p1), jnp.asarray(p2),
                             jnp.asarray(mask), jnp.asarray(colors),
                             jnp.asarray(origin), jnp.asarray(5.0), 64, 80,
                             samples=33)
    got = TR.rasterize_lines(t(p1), t(p2), t(mask), torch.as_tensor(colors),
                             t(origin), torch.tensor(5.0), 64, 80, samples=33)
    np.testing.assert_array_equal(n(got), np.asarray(ref))
    other = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        n(TR.compose(got, torch.as_tensor(other))),
        np.asarray(JR.compose(ref, jnp.asarray(other))))


@pytest.mark.parametrize("size", [(256, 256), (300, 200)])
def test_render_map_exact(small_map, small_state, size):
    """The rendered map (scans and trajectory, fitted to the data bounds on
    the device) is equal pixel for pixel."""
    from hitl_slam_torch.ops import raster as TR
    from hitl_slam_tpu.ops import raster as JR

    h, w = size
    ts = _states(small_map)
    world = np.asarray(small_state.world_points())
    ref = np.asarray(JR.render_map(jnp.asarray(world), small_state.point_mask,
                                   small_state.poses, height=h, width=w))
    got = TR.render_map(t(world), ts.point_mask, ts.poses, height=h, width=w)
    assert got.shape == (h, w, 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(n(got), ref)
    assert int((ref > 0).sum()) > 1000
    # from the port's own world points (an ulp from the reference's): at
    # most a handful of pixels move
    own = TR.render_map(ts.world_points(), ts.point_mask, ts.poses,
                        height=h, width=w)
    assert int((n(own) != ref).any(-1).sum()) <= 8


def test_info_matrix_image_exact(small_map):
    """The adjacency image after one accepted correction: the odometry band
    and the active constraint pairs, equal to the reference's."""
    from hitl_slam_torch.models.hitl.engine import HitLSLAM
    from hitl_slam_torch.ops import raster as TR
    from hitl_slam_tpu.io.figure8 import synthesize_correction
    from hitl_slam_tpu.ops import raster as JR
    from hitl_slam_torch.core.state import CorrectionType, SingleInput

    m = small_map
    eng = HitLSLAM(device="cpu")
    eng.init(m.poses, m.covariances, m.point_clouds, m.normal_clouds,
             odometry=m.odometry, constraint_capacity=512)
    sel = synthesize_correction(m, range(60, 96), range(0, 30),
                                (1, 0.0), (1, 0.0))
    rep = eng.replay_log(SingleInput(CorrectionType.COLINEAR, 0, sel))
    assert rep.accepted and rep.num_new_constraints > 0
    tab = eng.state.constraints
    got = TR.info_matrix_image(eng.state.poses[:, 0], tab.anchor,
                               tab.constrained, tab.active)
    f = {k: jnp.asarray(n(getattr(tab, k)))
         for k in ("anchor", "constrained", "active")}
    ref = np.asarray(JR.info_matrix_image(
        jnp.asarray(n(eng.state.poses[:, 0])), f["anchor"], f["constrained"],
        f["active"]))
    assert got.dtype == torch.uint8 and got.shape == (96, 96)
    np.testing.assert_array_equal(n(got), ref)
    off_band = n(got).copy()
    i = np.arange(95)
    off_band[i, i + 1] = off_band[i + 1, i] = 0
    assert off_band.sum() > 0          # the constraint pairs are drawn


def test_drawlists_match_the_reference(small_map, small_state):
    """display_poses / display_selection / display_proposals /
    display_covariances build the same draw lists (same JSON) in both
    packages; events parse alike."""
    from hitl_slam_torch.core.state import CorrectionType, SingleInput
    from hitl_slam_torch.gui import display as TD, drawlist as TL
    from hitl_slam_torch.models.hitl.propose import Proposal
    from hitl_slam_tpu.gui import display as JD, drawlist as JL

    ts = _states(small_map)
    P = ts.num_poses
    tdl = TD.display_poses(ts, max_points=500)
    jdl = JD.display_poses(small_state, max_points=500)
    assert len(tdl.lines_p1) == P - 1 and len(tdl.points) <= 500 + P
    assert tdl.lines_p1 == jdl.lines_p1 and tdl.points_col == jdl.points_col
    np.testing.assert_allclose(np.asarray(tdl.points), np.asarray(jdl.points),
                               atol=1e-5, rtol=0)
    assert tdl.robot_pose == jdl.robot_pose

    sel = np.array([[0, 0], [1, 0], [5, 5], [6, 5]], np.float32)
    prop = Proposal(input=SingleInput(CorrectionType.COLINEAR, 0, sel),
                    anchor_pose=3, corrected_pose=9, score=0.7,
                    drift=np.array([0.1, 0.0, 0.0]))
    poses = np.zeros((4, 3), np.float32)
    covs = np.tile(np.diag([0.04, 0.01, 0.001]).astype(np.float32), (4, 1, 1))
    lists = []
    for D, L in ((TD, TL), (JD, JL)):
        dl = L.DrawList()
        D.display_selection(dl, [np.array([0, 0]), np.array([1, 1])])
        D.display_proposals(dl, [prop])
        D.display_covariances(dl, poses, covs, segments=12)
        lists.append(dl)
    assert lists[0].to_json() == lists[1].to_json()
    assert len(lists[0].lines_p1) == 1 + 2 + 4 * 12
    back = TL.DrawList.from_json(lists[0].to_json())
    assert back.lines_p1 == lists[0].lines_p1 and back.text == lists[0].text
    for msg in ('{"type":"keyboard","keycode":80}',
                '{"type":"mouse_click","mouse_down":[0,1],"mouse_up":[2,3],'
                '"modifiers":4}', '{"type":"other","x":1}'):
        assert TL.parse_event(msg) == JL.parse_event(msg) or (
            vars(TL.parse_event(msg)) == vars(JL.parse_event(msg)))
