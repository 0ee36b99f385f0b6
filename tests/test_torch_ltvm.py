"""Port parity: the truncated SDF (ops/sdf.py), the LTVM curator
(models/ltvm/curator.py) and its command line, against the JAX package on
the same numpy inputs (both on the CPU, f32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import n, reference_draws, t

torch.set_num_threads(2)

ORIGIN = np.array([-21.3, -1.2], np.float32)
H, W = 125, 425

# SDF tolerance. Values and weights are running means of ~50 updates in
# f32, compared to 1e-5 and 1e-4. A pixel whose bearing falls within an ulp
# of a bin edge reads a neighbouring beam in one of the two packages
# (arctan2, sin and cos differ in the last bit between the two compilers),
# which moves that pixel's weight by up to one update: at most 0.05 % of the
# pixels may exceed the tolerance (2 of 53,125 observed).
SDF_VALUE_ATOL = 1e-5
SDF_WEIGHT_ATOL = 1e-4
SDF_OUTLIER_SHARE = 5e-4


def _maps(**kw):
    from hitl_slam_torch.core.state import make_map_state as tmk
    from hitl_slam_tpu.core.state import make_map_state as jmk
    from hitl_slam_tpu.io.figure8 import generate_figure8

    m = generate_figure8(**kw)
    return m, jmk, tmk


@pytest.fixture(scope="module")
def noisy_48():
    m, jmk, tmk = _maps(num_poses=48, num_rays=120, seed=4)
    args = (m.poses, m.covariances, m.point_clouds, m.normal_clouds)
    return m, jmk(*args), tmk(*args, device="cpu")


@pytest.fixture(scope="module")
def clean_72():
    """The map of tests/test_ltvm.py: ground-truth poses, no noise."""
    m, jmk, tmk = _maps(num_poses=72, num_rays=160, seed=2,
                        drift_theta_bias=0.0, noise_trans=0.0,
                        noise_theta=0.0)
    args = (m.gt_poses, m.covariances, m.point_clouds, m.normal_clouds)
    return m, jmk(*args), tmk(*args, device="cpu")


@pytest.fixture(scope="module")
def sdf_pair(noisy_48):
    from hitl_slam_torch.ops import sdf as TS
    from hitl_slam_tpu.ops import sdf as JS

    _, js, ts = noisy_48
    ref = JS.build_sdf(js.poses, js.points, js.point_mask, jnp.asarray(ORIGIN),
                       height=H, width=W,
                       params=JS.SdfParams(image_resolution=0.1))
    got = TS.build_sdf(ts.poses, ts.points, ts.point_mask, t(ORIGIN), H, W,
                       TS.SdfParams(image_resolution=0.1))
    return ref, got


def test_bin_scans_parity(noisy_48):
    """Every scan's bearing bins: the same bins are hit, and the minimum
    ranges agree to 2e-6 m (one ulp at 12 m)."""
    from hitl_slam_torch.ops import sdf as TS
    from hitl_slam_tpu.ops import sdf as JS

    _, js, ts = noisy_48
    ref = np.asarray(jax.vmap(
        lambda a, b, c: JS._bin_scan(a, b, c, 1024, 12.0))(
            js.poses, js.points, js.point_mask))
    got = n(TS._bin_scans(ts.points, ts.point_mask, 1024, 12.0))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    hit = np.isfinite(ref)
    assert hit.sum() > 1000
    np.testing.assert_allclose(got[hit], ref[hit], atol=2e-6, rtol=0)


def test_build_sdf_parity(sdf_pair):
    ref, got = sdf_pair
    assert got.values.shape == (H, W) and got.weights.shape == (H, W)
    dv = np.abs(n(got.values) - np.asarray(ref.values))
    dw = np.abs(n(got.weights) - np.asarray(ref.weights))
    allowed = SDF_OUTLIER_SHARE * dv.size
    assert (dv > SDF_VALUE_ATOL).sum() <= allowed, (dv > SDF_VALUE_ATOL).sum()
    assert (dw > SDF_WEIGHT_ATOL).sum() <= allowed, (dw > SDF_WEIGHT_ATOL).sum()
    np.testing.assert_array_equal(n(got.weights) > 0,
                                  np.asarray(ref.weights) > 0)
    np.testing.assert_array_equal(n(got.origin), ORIGIN)
    assert float(got.resolution) == float(ref.resolution)
    # never-observed pixels read min_sdf_value
    unobs = n(got.values)[n(got.weights) == 0]
    assert len(unobs) > 0
    np.testing.assert_allclose(unobs, -0.2, atol=1e-6)


def test_sdf_is_zero_on_walls(clean_72):
    """The port's SDF on the clean map, by the checks of
    tests/test_ltvm.py::test_sdf_zero_on_walls."""
    from hitl_slam_torch.ops import sdf as TS

    _, _, ts = clean_72
    params = TS.SdfParams(image_resolution=0.1)
    sdf = TS.build_sdf(ts.poses, ts.points, ts.point_mask,
                       torch.tensor([-21.0, -1.0]), 120, 420, params)
    v, w = n(sdf.values), n(sdf.weights)
    assert np.isfinite(v).all() and (w >= 0).all()
    wall = v[10, 30:390][w[10, 30:390] > 0.5]
    assert len(wall) > 50 and np.median(np.abs(wall)) < 0.08
    free = v[30, 100:300][w[30, 100:300] > 0.5]
    assert np.median(free) > 0.05
    dm = n(TS.dynamic_mask(sdf, params))
    assert 0 < dm.sum() < dm.size


def test_filter_points_and_dynamic_mask_exact(noisy_48, sdf_pair):
    """On the same SDF image and the same world points both packages keep
    exactly the same points (boolean output)."""
    from hitl_slam_torch.ops import sdf as TS
    from hitl_slam_tpu.ops import sdf as JS

    _, js, ts = noisy_48
    ref_sdf, _ = sdf_pair
    jp = JS.SdfParams(image_resolution=0.1)
    tp = TS.SdfParams(image_resolution=0.1)
    world = np.asarray(js.world_points())
    same = TS.SdfImage(values=t(ref_sdf.values), weights=t(ref_sdf.weights),
                       origin=t(ORIGIN), resolution=torch.tensor(0.1))
    ref = np.asarray(JS.filter_points(ref_sdf, jnp.asarray(world),
                                      js.point_mask, jp))
    got = n(TS.filter_points(same, t(world), ts.point_mask, tp))
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < np.asarray(js.point_mask).sum()
    np.testing.assert_array_equal(n(TS.dynamic_mask(same, tp)),
                                  np.asarray(JS.dynamic_mask(ref_sdf, jp)))


def test_sdf_bounds_parity(noisy_48):
    from hitl_slam_torch.ops import sdf as TS
    from hitl_slam_tpu.ops import sdf as JS

    _, js, ts = noisy_48
    world = np.asarray(js.world_points())
    lo_r, hi_r = JS.sdf_bounds(world, np.asarray(js.point_mask), 0.3)
    lo, hi = TS.sdf_bounds(t(world), ts.point_mask, 0.3)
    assert lo.dtype == np.float32 and hi.dtype == np.float32
    np.testing.assert_array_equal(lo, lo_r)
    np.testing.assert_array_equal(hi, hi_r)


def _curator_params(mod_curator, mod_sdf, mod_ransac):
    p = mod_curator.CuratorParams()
    p.sdf = mod_sdf.SdfParams(image_resolution=0.1)
    p.ransac = mod_ransac.RansacParams(num_segments=24, inlier_threshold=0.08,
                                       min_inliers=30, min_length=1.0)
    return p


def test_curate_parity_on_the_72_pose_map(clean_72, tmp_path):
    """One curation pass with the reference's draws (its key: the second
    half of split(PRNGKey(0))): the same number of vectors, endpoints
    within 1 cm, masses within 1 % (a point on a pixel edge may be filtered
    in one package only); every vector passes the prune floors."""
    from hitl_slam_torch.models.ltvm import curator as TC
    from hitl_slam_torch.ops import ransac as TR, sdf as TS
    from hitl_slam_tpu.models.ltvm import curator as JC
    from hitl_slam_tpu.ops import ransac as JR, sdf as JS

    _, js, ts = clean_72
    jcur = JC.LongTermVectorMap(_curator_params(JC, JS, JR))
    ref = jcur.curate(js.poses, js.points, js.point_mask)
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    tparams = _curator_params(TC, TS, TR)
    tcur = TC.LongTermVectorMap(tparams)
    timings = {}
    got = tcur.curate(ts.poses, ts.points, ts.point_mask,
                      draws=reference_draws(key, 24, 256), timings_ms=timings)
    assert len(got) == len(ref) >= 4
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.p1, b.p1, atol=0.01, rtol=0)
        np.testing.assert_allclose(a.p2, b.p2, atol=0.01, rtol=0)
        assert abs(a.mass - b.mass) <= 0.01 * b.mass
        assert a.mass >= tparams.prune_min_mass
        assert np.linalg.norm(a.p2 - a.p1) >= tparams.prune_min_length
        assert np.isfinite(a.endpoint_cov).all()
    assert sum(np.linalg.norm(v.p2 - v.p1) for v in got) > 50.0
    assert set(timings) == {"sdf_ms", "filter_ms", "ransac_ms", "merge_ms"}

    # a second pass over the same data does not balloon the map
    again = tcur.curate(ts.poses, ts.points, ts.point_mask)
    assert len(again) <= len(got) + 3
    tcur.save_sdf(str(tmp_path / "w.png"), str(tmp_path / "v.png"))
    tcur.save_vectors(str(tmp_path / "vectors.txt"))
    assert (tmp_path / "vectors.txt").read_text().count("\n") == len(again)
    assert (tmp_path / "w.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_curate_own_draws_repeat_from_the_seed(clean_72):
    """Two curators with the same seed give the same vectors bit for bit,
    pass after pass; the figure-8's walls come out (4 to 6 vectors)."""
    from hitl_slam_torch.models.ltvm import curator as TC
    from hitl_slam_torch.ops import ransac as TR, sdf as TS

    _, _, ts = clean_72
    curs = [TC.LongTermVectorMap(_curator_params(TC, TS, TR), seed=3)
            for _ in range(2)]
    for _ in range(2):
        a, b = (c.curate(ts.poses, ts.points, ts.point_mask) for c in curs)
        assert 4 <= len(a) <= 6 and len(a) == len(b)
        for va, vb in zip(a, b):
            for name in ("p1", "p2", "p_bar", "scatter", "endpoint_cov"):
                np.testing.assert_array_equal(getattr(va, name),
                                              getattr(vb, name))
            assert va.mass == vb.mass
    with pytest.raises(RuntimeError):
        TC.LongTermVectorMap().save_sdf("w.png", "v.png")


def test_cli_ltvm_on_the_cpu(clean_72, tmp_path, capsys):
    """python -m hitl_slam_torch.cli_ltvm: two sessions curated in order,
    the vectors file and both SDF rasters written; --device cuda without a
    card exits 2."""
    from hitl_slam_torch import cli_ltvm
    from hitl_slam_torch.io import stfs

    m, _, _ = clean_72
    path = str(tmp_path / "clean.stfs.covars")
    stfs.save_stfs_covars(path, "Fig8", 42.0, m.gt_poses, m.covariances,
                          m.point_clouds, m.normal_clouds)
    out = str(tmp_path / "ltvm")
    rc = cli_ltvm.main(["-P", path, path, "-o", out, "--resolution", "0.1",
                        "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0 and text.count("curated ") == 2
    rows = (tmp_path / "ltvm.vectors.txt").read_text().strip().splitlines()
    assert 4 <= len(rows) <= 9
    assert all(len(r.split(",")) == 5 for r in rows)
    for name in ("ltvm.weights.png", "ltvm.values.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    if not torch.cuda.is_available():
        assert cli_ltvm.main(["-P", path, "-o", out]) == 2
    assert cli_ltvm.main(["-P", str(tmp_path / "missing"), "-o", out,
                          "--device", "cpu"]) == 1
