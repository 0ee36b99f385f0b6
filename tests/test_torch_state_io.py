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
        m.poses, m.covariances, m.point_clouds, m.normal_clouds, "cpu",
        odometry=m.odometry, constraint_capacity=512))
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
        "'models.hitl.refine', 'bench'):\n"
        "    assert 'hitl_slam_torch.' + name in names, name\n"
        "print(len(names))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 24, out.stdout
