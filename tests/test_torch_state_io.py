"""Port parity: data model, state converter, host I/O, and the import rule
(hitl_slam_torch never imports jax or hitl_slam_tpu)."""

import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import np_fields

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the three golden sessions of tests/test_golden.py (loose, tight, large):
# (stfs file, log file)
GOLDENS = {
    "golden": ("golden.stfs.covars", "golden.log"),
    "golden_tight": ("golden.stfs.covars", "golden.log"),
    "golden_large": ("golden_large.stfs.covars.gz", "golden_large.log"),
}


def test_correction_type_values_equal():
    from hitl_slam_torch.core.state import CorrectionType as TC
    from hitl_slam_tpu.core.state import CorrectionType as JC

    assert [(m.name, int(m)) for m in TC] == [(m.name, int(m)) for m in JC]


def test_make_map_state_matches(small_map):
    from hitl_slam_torch.core import state as TS
    from hitl_slam_tpu.core.state import make_map_state

    m = small_map
    ref = np_fields(make_map_state(m.poses, m.covariances, m.point_clouds,
                                   m.normal_clouds, odometry=m.odometry,
                                   constraint_capacity=512))
    got = TS.to_numpy(TS.make_map_state(
        m.poses, m.covariances, m.point_clouds, m.normal_clouds,
        odometry=m.odometry, constraint_capacity=512, device="cpu"))
    for k in ("poses", "covariances", "points", "normals", "point_mask",
              "odometry"):
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k, v in ref["constraints"].items():
        assert got["constraints"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got["constraints"][k], v, err_msg=k)


def test_state_converter_roundtrip(small_state):
    from hitl_slam_torch.core import state as TS

    arrays = np_fields(small_state)
    st = TS.from_numpy(arrays, "cpu")
    assert st.num_poses == small_state.num_poses
    assert st.constraints.capacity == small_state.constraints.capacity
    back = TS.to_numpy(st)
    for k, v in arrays.items():
        if k == "constraints":
            for kk, vv in v.items():
                np.testing.assert_array_equal(back[k][kk], vv, err_msg=kk)
        else:
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    np.testing.assert_allclose(st.world_points().numpy(),
                               np.asarray(small_state.world_points()),
                               rtol=0, atol=1e-5)


def _plain_path(name, tmp_path):
    path = os.path.join(DATA, name)
    if not name.endswith(".gz"):
        return path
    out = str(tmp_path / name[:-3])
    with gzip.open(path) as f, open(out, "wb") as g:
        shutil.copyfileobj(f, g)
    return out


@pytest.mark.parametrize("golden", list(GOLDENS))
def test_loaders_match(golden, tmp_path):
    """The port's stfs and log readers give the JAX package's arrays, on
    every golden session (the .gz one read directly by the port)."""
    from hitl_slam_torch.io import logs as tlogs, stfs as tstfs
    from hitl_slam_tpu.io import logs as jlogs, stfs as jstfs

    stfs_name, log_name = GOLDENS[golden]
    ref = jstfs.load_stfs_covars(_plain_path(stfs_name, tmp_path))
    got = tstfs.load_stfs_covars(os.path.join(DATA, stfs_name))
    assert (got.map_name, got.timestamp) == (ref.map_name, ref.timestamp)
    np.testing.assert_array_equal(got.poses, ref.poses)
    np.testing.assert_array_equal(got.covariances, ref.covariances)
    assert len(got.point_clouds) == len(ref.point_clouds)
    for a, b in zip(got.point_clouds, ref.point_clouds):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.normal_clouds, ref.normal_clouds):
        np.testing.assert_array_equal(a, b)

    ref_log = jlogs.load_log(os.path.join(DATA, log_name))
    got_log = tlogs.load_log(os.path.join(DATA, log_name))
    assert len(got_log) == len(ref_log)
    for a, b in zip(got_log, ref_log):
        assert int(a.correction_type) == int(b.correction_type)
        assert a.undone == b.undone
        np.testing.assert_array_equal(a.points, b.points)


def test_log_and_results_writers_match(tmp_path):
    from hitl_slam_torch.io import logs as tlogs, stfs as tstfs
    from hitl_slam_tpu.io import logs as jlogs, stfs as jstfs

    entries = tlogs.load_log(os.path.join(DATA, "golden_large.log"))
    tlogs.save_log(str(tmp_path / "t.log"), entries)
    jlogs.save_log(str(tmp_path / "j.log"),
                   jlogs.load_log(os.path.join(DATA, "golden_large.log")))
    assert (tmp_path / "t.log").read_bytes() == (tmp_path / "j.log").read_bytes()
    again = tlogs.load_log(str(tmp_path / "t.log"))
    for a, b in zip(again, entries):
        np.testing.assert_array_equal(a.points, b.points)

    poses = np.random.default_rng(0).normal(size=(17, 3)).astype(np.float32)
    tstfs.save_results_poses(str(tmp_path / "t.txt"), poses)
    jstfs.save_results_poses(str(tmp_path / "j.txt"), poses)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


FIGURE8_CASES = {
    "default_small": dict(num_poses=40, num_rays=60, seed=3),
    "two_laps_drifted": dict(num_poses=64, num_rays=45, seed=7,
                             drift_theta_bias=6e-4, num_laps=2),
    "clean": dict(num_poses=24, num_rays=30, seed=5, drift_theta_bias=0.0,
                  noise_trans=0.0, noise_theta=0.0, max_range=8.0),
}


@pytest.mark.parametrize("case", list(FIGURE8_CASES))
def test_figure8_generator_is_bit_equal(case):
    """The port's copy of the figure-8 generator gives the JAX package's
    arrays bit for bit (the same np.random.default_rng(seed) stream), and
    so do the synthetic human sketches made from them."""
    from hitl_slam_torch.io import figure8 as TF
    from hitl_slam_tpu.io import figure8 as JF

    kw = FIGURE8_CASES[case]
    got, ref = TF.generate_figure8(**kw), JF.generate_figure8(**kw)
    for name in ("poses", "gt_poses", "covariances", "odometry", "walls"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("point_clouds", "normal_clouds"):
        assert len(getattr(got, name)) == len(getattr(ref, name))
        for a, b in zip(getattr(got, name), getattr(ref, name)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    P = kw["num_poses"]
    late, early = range(P - P // 3, P), range(0, P // 3)
    np.testing.assert_array_equal(
        TF.wall_points_drifted(got, late, 1, 0.0),
        JF.wall_points_drifted(ref, late, 1, 0.0))
    try:
        want = JF.synthesize_correction(ref, late, early, min_points=10)
    except ValueError:
        with pytest.raises(ValueError):
            TF.synthesize_correction(got, late, early, min_points=10)
    else:
        np.testing.assert_array_equal(
            TF.synthesize_correction(got, late, early, min_points=10), want)
    blob = np.random.default_rng(0).normal(size=(50, 2)) * [3.0, 0.1]
    np.testing.assert_array_equal(TF.fit_clicked_segment(blob),
                                  JF.fit_clicked_segment(blob))


def test_raw_stream_generator_is_bit_equal():
    from hitl_slam_torch.io import figure8 as TF
    from hitl_slam_tpu.io import figure8 as JF

    kw = dict(num_steps=20, num_rays=48, seed=2, num_laps=1)
    got, ref = TF.generate_raw_stream(**kw), JF.generate_raw_stream(**kw)
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["png_gray", "png_rgb", "ppm_gray",
                                  "ppm_rgb"])
def test_image_writers_write_equal_bytes(kind, tmp_path):
    from hitl_slam_torch.utils import image as TI
    from hitl_slam_tpu.utils import image as JI

    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (37, 53) if kind.endswith("gray")
                       else (37, 53, 3)).astype(np.uint8)
    name = "write_png" if kind.startswith("png") else "write_ppm"
    getattr(TI, name)(str(tmp_path / "t"), img)
    getattr(JI, name)(str(tmp_path / "j"), img)
    data = (tmp_path / "t").read_bytes()
    assert data == (tmp_path / "j").read_bytes() and len(data) > 100
    if name == "write_png":
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        with pytest.raises(ValueError):
            TI.write_png(str(tmp_path / "bad"), np.zeros((3, 3, 2), np.uint8))


def test_stfs_covars_writer_matches(small_map, tmp_path):
    """save_stfs_covars writes the JAX package's bytes, and the port reads
    its own file back."""
    from hitl_slam_torch.io import stfs as tstfs
    from hitl_slam_tpu.io import stfs as jstfs

    m = small_map
    args = ("Fig8", 42.0, m.poses[:12], m.covariances[:12],
            m.point_clouds[:12], m.normal_clouds[:12])
    tstfs.save_stfs_covars(str(tmp_path / "t.stfs.covars"), *args)
    jstfs.save_stfs_covars(str(tmp_path / "j.stfs.covars"), *args)
    assert ((tmp_path / "t.stfs.covars").read_bytes()
            == (tmp_path / "j.stfs.covars").read_bytes())
    back = tstfs.load_stfs_covars(str(tmp_path / "t.stfs.covars"))
    assert back.map_name == "Fig8" and len(back.poses) == 12
    np.testing.assert_allclose(back.poses, m.poses[:12], atol=1e-4)


def test_port_imports_no_jax():
    """Every hitl_slam_torch module imports in a fresh interpreter without
    pulling in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hitl_slam_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "hitl_slam_torch.__path__, 'hitl_slam_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('hitl_slam_tpu'))\n"
        "assert not bad, bad\n"
        "for name in ('solver.cg', 'ops.correspond', 'solver.stf_solve', "
        "'models.hitl.refine', 'bench', 'io.figure8', 'utils.image', "
        "'ops.ransac', 'ops.scan_match', 'models.hitl.propose', "
        "'ops.raster', 'gui.drawlist', 'gui.display', 'ops.sdf', "
        "'models.ltvm.curator', 'cli_ltvm', 'utils.config', "
        "'utils.luaconfig', 'io.lz4frame', 'io.rosbag', 'ops.ltf', "
        "'models.enml.localizer', 'models.enml.driver', 'gui.map_edit', "
        "'cli_enml', 'models.enml.parallel_localizer', "
        "'models.enml.session', 'models.enml.online', 'gui.server', "
        "'gui.graph_edit', 'gui.live', 'parallel', 'parallel.replicas', "
        "'native', 'models.hitl.repair', 'solver.tridiag', "
        "'parallel.mesh', 'parallel.sharded_solver', 'baselines', "
        "'baselines.cpu_lm', 'baselines.cpu_refine', 'bench_sessions', "
        "'bench_reference', 'utils.device_loop'):\n"
        "    assert 'hitl_slam_torch.' + name in names, name\n"
        "print(len(names))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 70, out.stdout


def test_state_constants_match():
    """CORRECTION_TYPE_NAMES and RESIDUALS_PER_TYPE: the reference's
    tables, keyed by the port's CorrectionType."""
    from hitl_slam_torch.core import state as T
    from hitl_slam_tpu.core import state as J

    assert {int(k): v for k, v in T.CORRECTION_TYPE_NAMES.items()} == {
        int(k): v for k, v in J.CORRECTION_TYPE_NAMES.items()}
    assert {int(k): v for k, v in T.RESIDUALS_PER_TYPE.items()} == {
        int(k): v for k, v in J.RESIDUALS_PER_TYPE.items()}
    assert all(isinstance(k, T.CorrectionType)
               for k in T.RESIDUALS_PER_TYPE)
