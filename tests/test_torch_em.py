"""Port parity: the em_scan sweep (plain version of the CUDA kernel), the EM
endpoint refit and the device ordering, against the JAX package on the CPU
(JAX's em_scan in Pallas interpret mode, as its own tests run it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t

torch.set_num_threads(2)


def _edge_cases(small_state):
    """(name, world [P,N,2], mask [P,N], sel [4,2], threshold) numpy cases:
    two segment selections, a degenerate POINT selection, points exactly on
    the threshold, a P that is not a multiple of the 8-pose tile, and fully
    masked rows."""
    world = np.asarray(small_state.world_points())
    mask = np.asarray(small_state.point_mask)
    P = world.shape[0]
    sel_a = np.array([[0.0, 0.2], [3.0, 0.1], [-4.0, 0.0], [-1.0, 0.1]],
                     np.float32)
    sel_b = np.array([[-2.0, -1.0], [2.0, -1.2], [1.0, 2.0], [1.5, -2.0]],
                     np.float32)
    p, q = world[5, 0], world[60, 0]
    point = np.stack([p, p, q, q]).astype(np.float32)

    # (0, y) against segment (-1,0)-(1,0) has d2 = fl(y*y); y sweeps the f32
    # neighbours of 0.03 so some point sits exactly at fl(0.03**2)
    ys = [np.float32(0.03)]
    for _ in range(20):
        ys.append(np.nextafter(ys[-1], np.float32(1)))
        ys.insert(0, np.nextafter(ys[0], np.float32(0)))
    ys = np.asarray(ys, np.float32)
    assert np.any(ys * ys == np.float32(0.03 ** 2))
    w_edge = world.copy()
    m_edge = mask.copy()
    w_edge[:len(ys), 0] = np.stack([np.zeros_like(ys), ys], -1)
    m_edge[:len(ys), 0] = True
    edge_sel = np.array([[-1, 0], [1, 0], [-1, 0], [1, 0]], np.float32)

    holes = mask.copy()
    holes[::5] = False
    return [
        ("segments_a", world, mask, sel_a, 0.03),
        ("segments_b", world, mask, sel_b, 0.03),
        ("point", world, mask, point, 0.05),
        ("at_threshold", w_edge, m_edge, edge_sel, 0.03),
        ("P_not_tile", world[:P - 3], mask[:P - 3], sel_a, 0.03),
        ("masked_rows", world, holes, sel_b, 0.03),
    ]


@pytest.mark.parametrize("case", range(6))
def test_em_scan_plain_matches_jax(case, small_state):
    from hitl_slam_torch.ops.em_scan import em_scan_reference
    from hitl_slam_tpu.ops.pallas_em import em_scan

    name, world, mask, sel, thr = _edge_cases(small_state)[case]
    counts, mins = em_scan_reference(t(world), t(mask), t(sel), thr)
    jc, jm = em_scan(jnp.asarray(world), jnp.asarray(mask), jnp.asarray(sel),
                     inlier_threshold=thr)
    assert counts.dtype == torch.int32
    # counts are integers: exact, including points exactly at the threshold
    np.testing.assert_array_equal(n(counts), np.asarray(jc), err_msg=name)
    # minima: the same f32 expression; XLA may contract into FMAs, which
    # moves the last bit at most -> rtol 1e-6
    np.testing.assert_allclose(n(mins), np.asarray(jm), rtol=1e-6, atol=0,
                               err_msg=name)


def test_em_scan_wrapper_cpu_runs_plain_version(small_state):
    from hitl_slam_torch.ops import em_scan as E

    name, world, mask, sel, thr = _edge_cases(small_state)[0]
    before = E.launches.count
    a = E.em_scan(t(world), t(mask), t(sel), thr)
    b = E.em_scan_reference(t(world), t(mask), t(sel), thr)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert E.launches.count == before    # no kernel on the CPU
    with pytest.raises(ValueError):
        E.em_scan_cuda(t(world), t(mask), t(sel), thr)


def _selection(small_map, jitter):
    from hitl_slam_tpu.io.figure8 import synthesize_correction

    P = len(small_map.poses)
    sel = synthesize_correction(small_map, range(P - P // 3, P),
                                range(0, P // 3), (1, 0.0), (1, 0.0),
                                min_points=5)
    rng = np.random.default_rng(17)
    return (np.asarray(sel) + rng.normal(0, jitter, (4, 2))).astype(np.float32)


@pytest.mark.parametrize("jitter", [0.0, 0.02])
def test_endpoint_adjust_batch_matches_jax(jitter, small_map, small_state):
    from hitl_slam_torch.models.hitl import em_input as TE
    from hitl_slam_tpu.models.hitl import em_input as JE

    world = np.asarray(small_state.world_points())
    mask = np.asarray(small_state.point_mask)
    sel = _selection(small_map, jitter)
    segs = np.stack([sel[0:2], sel[2:4]])
    got = n(TE.endpoint_adjust_batch(t(world), t(mask), t(segs)))
    ref = np.asarray(JE.endpoint_adjust_batch(jnp.asarray(world),
                                              jnp.asarray(mask),
                                              jnp.asarray(segs)))
    # 25 Newton steps per round over ~10^4 points: f32 sum order and ~1 ulp
    # trig differences stay below 1e-5 m on metre-scale endpoints
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.abs(got - segs).max() > 0 or jitter == 0.0


def test_segfit_theta_matches_jax_and_bruteforce(rng):
    """_segfit_theta agrees with the JAX package's and converges to the
    brute-force argmin of the exact objective, end-zone inliers included
    (the cases of tests/test_pallas_em.py)."""
    from hitl_slam_torch.models.hitl.em_input import _segfit_theta
    from hitl_slam_tpu.models.hitl import em_input as JE

    def objective(theta, pts, w, cm, L):
        a = np.array([np.cos(theta), np.sin(theta)])
        rel = pts - cm
        tt = np.clip(rel @ a, -L, L)
        d2 = np.sum((rel - tt[:, None] * a[None, :]) ** 2, -1)
        return float(np.sum(w * d2))

    cm = np.zeros(2, np.float32)
    L = 1.0
    th_true = 0.03
    a = np.array([np.cos(th_true), np.sin(th_true)])
    s = np.concatenate([np.linspace(1.05, 1.6, 60), np.linspace(-1.6, -1.05, 60)])
    s2 = np.linspace(-1.5, 1.5, 120)
    cases = [(s[:, None] * a[None, :]).astype(np.float32),
             (s2[:, None] * a[None, :]
              + rng.normal(0, 0.005, (120, 2))).astype(np.float32)]
    for pts in cases:
        w = np.ones(len(pts), np.float32)
        got = float(_segfit_theta(t(pts), t(w), t(cm),
                                  torch.tensor(L, dtype=torch.float32),
                                  torch.tensor(0.0)))
        ref = float(JE._segfit_theta(jnp.asarray(pts), jnp.asarray(w),
                                     jnp.asarray(cm), jnp.asarray(L, jnp.float32),
                                     jnp.asarray(0.0, jnp.float32)))
        assert abs(got - ref) < 1e-6, (got, ref)
        grid = np.linspace(-0.3, 0.3, 2001)
        best = grid[np.argmin([objective(g, pts, w, cm, L) for g in grid])]
        assert abs(got - best) < 2e-3, (got, best)


def _random_counts(rng, P, kind):
    c1 = np.zeros(P, np.int32)
    c2 = np.zeros(P, np.int32)
    if kind == "good":
        c1[rng.integers(P // 2, P, 5)] = 10
        c2[rng.integers(0, P // 4, 5)] = 10
    elif kind == "swapped":
        c1[rng.integers(0, P // 4, 5)] = 10
        c2[rng.integers(P // 2, P, 5)] = 10
    elif kind == "overlap_partial":
        a = rng.integers(P // 2, P, 6)
        c1[a] = 10
        c2[a[:2]] = 10
        c2[rng.integers(0, P // 4, 4)] = 10
    elif kind == "overlap_complete":
        a = rng.integers(0, P, 6)
        c1[a] = 10
        c2[a] = 10
    elif kind == "interleaved":
        c1[rng.integers(0, P, 8)] = 10
        c2[rng.integers(0, P, 8)] = 10
    elif kind == "point_gate":
        c1[rng.integers(P // 2, P, 3)] = 1
        c2[rng.integers(0, P // 4, 3)] = 1
    return c1, c2


@pytest.mark.parametrize("kind", ["good", "swapped", "overlap_partial",
                                  "overlap_complete", "interleaved", "empty",
                                  "point_gate"])
def test_order_on_device_matches_jax(kind, rng):
    from hitl_slam_torch.models.hitl.ordering import order_on_device
    from hitl_slam_tpu.models.hitl.ordering import order_on_device as jorder

    P = 128
    sel = np.array([[0, 0], [1, 0], [5, 5], [6, 5]], np.float32)
    for trial in range(4):
        c1, c2 = _random_counts(rng, P, kind)
        for gate in (5, 0):
            got = order_on_device(t(c1), t(c2), t(sel), min_inliers=gate)
            ref = jorder(jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(sel),
                         min_inliers=gate)
            for field in ("valid", "sel", "corrected_mask", "anchor_mask",
                          "corrected_idx", "anchor_idx", "group_mask",
                          "last_pose", "bp_min", "bp_max"):
                a = n(getattr(got, field))
                b = np.asarray(getattr(ref, field))
                np.testing.assert_array_equal(a, b, err_msg=f"{kind} {field}")
                if field.endswith("idx") or field in ("last_pose", "bp_min",
                                                      "bp_max"):
                    assert a.dtype == np.int32, field


# ------------------------------------------------------------ host twins

@pytest.fixture(scope="module")
def fig8_64():
    """A 64-pose figure-8 map (world points and mask) and a selection
    synthesized on it, the last third against the first."""
    from hitl_slam_tpu.core.state import make_map_state
    from hitl_slam_tpu.io.figure8 import generate_figure8, synthesize_correction

    m = generate_figure8(num_poses=64, num_rays=64, seed=5,
                         drift_theta_bias=8e-4)
    st = make_map_state(m.poses, m.covariances, m.point_clouds,
                        m.normal_clouds, constraint_capacity=16)
    sel = synthesize_correction(m, range(64 - 64 // 3, 64), range(0, 64 // 3),
                                (1, 0.0), (1, 0.0), min_points=5)
    return (np.asarray(st.world_points()), np.asarray(st.point_mask),
            np.asarray(sel, np.float32))


def test_verify_input_matches_jax(fig8_64):
    """The 0.05 m proximity check: the synthesized clicks (on the map),
    clicks moved off it, and one exactly at a map point."""
    from hitl_slam_torch.models.hitl.em_input import verify_input
    from hitl_slam_tpu.models.hitl.em_input import verify_input as jverify

    world, mask, sel = fig8_64
    off = sel + np.array([[0.0, 0.0], [0.3, 0.0], [0.0, 0.049], [5.0, 5.0]],
                         np.float32)
    exact = np.stack([world[3, 0], sel[1], world[40, 2], sel[3]])
    for s in (sel, off, exact.astype(np.float32)):
        got = n(verify_input(t(world), t(mask), t(s)))
        ref = np.asarray(jverify(jnp.asarray(world), jnp.asarray(mask),
                                 jnp.asarray(s)))
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert n(verify_input(t(world), t(mask), t(sel))).all()


def test_endpoint_adjust_and_observation_counts_match_jax(fig8_64):
    """endpoint_adjust (one segment) and the per-pose inlier counts of the
    refit selection: counts exactly the JAX function's (its sqrt against
    0.03 m, not em_scan's squared compare)."""
    from hitl_slam_torch.models.hitl import em_input as TE
    from hitl_slam_tpu.models.hitl import em_input as JE

    world, mask, sel = fig8_64
    jw, jm = jnp.asarray(world), jnp.asarray(mask)
    refit = []
    for seg in (sel[0:2], sel[2:4]):
        got = n(TE.endpoint_adjust(t(world), t(mask), t(seg)))
        ref = np.asarray(JE.endpoint_adjust(jw, jm, jnp.asarray(seg)))
        # as test_endpoint_adjust_batch_matches_jax
        np.testing.assert_allclose(got, ref, atol=1e-4)
        refit.append(ref)
    refit = np.concatenate(refit).astype(np.float32)
    got = TE.observation_counts(t(world), t(mask), t(refit))
    ref = JE.observation_counts(jw, jm, jnp.asarray(refit))
    for g, r in zip(got, ref):
        assert n(g).dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(n(g), np.asarray(r))
    assert n(got[0]).max() > TE.MIN_POSE_INLIERS


@pytest.mark.parametrize("kind", ["map", "good", "swapped", "overlap_partial",
                                  "overlap_complete", "interleaved", "empty",
                                  "point_gate"])
def test_order_and_filter_matches_jax(kind, fig8_64, rng):
    """The host ordering on the figure-8's counts and on the random count
    patterns of test_order_on_device_matches_jax: every field exact."""
    from hitl_slam_torch.models.hitl.em_input import order_and_filter
    from hitl_slam_tpu.models.hitl import em_input as JE

    world, mask, sel = fig8_64
    if kind == "map":
        counts = [JE.observation_counts(jnp.asarray(world), jnp.asarray(mask),
                                        jnp.asarray(sel))]
        counts = [tuple(np.asarray(c) for c in counts[0])]
    else:
        counts = [_random_counts(rng, 128, kind) for _ in range(4)]
    for c1, c2 in counts:
        got = order_and_filter(c1, c2, sel)
        ref = JE.order_and_filter(c1, c2, sel)
        assert got.valid == ref.valid
        assert (got.backprop_start, got.backprop_end) == (
            ref.backprop_start, ref.backprop_end)
        for field in ("corrected_poses", "anchor_poses", "selected_points"):
            a, b = getattr(got, field), getattr(ref, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    if kind in ("map", "good", "swapped"):
        assert got.valid
