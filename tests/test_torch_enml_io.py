"""Port parity of EnML's host I/O and configuration: the ROS bag reader and
writer (io/rosbag.py, io/lz4frame.py), the Lua and TOML configs
(utils/luaconfig.py, utils/config.py), options_from_table, and the .stfs,
odometry and test-set writers (io/stfs.py), against the JAX package on the
same inputs. Host code only: no tensor work."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# the reference's own .cfg files, where tests/test_luaconfig.py finds them
from test_luaconfig import REF_CFG_DIR, REF_CFGS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def stream():
    from hitl_slam_tpu.io.figure8 import generate_raw_stream

    return generate_raw_stream(num_steps=48, num_rays=120, seed=4)


def _cobot_bag_messages(scans, angles, rel, with_set_location=False):
    """tests/test_rosbag.py's CoBot bag: two odometry deltas between laser
    scans; optionally one set_location event mid-run."""
    from hitl_slam_tpu.io import rosbag as rb

    msgs = []
    t = 100.0
    inc = float(angles[1] - angles[0])
    for i in range(len(scans)):
        if i > 0:
            dr, dx, dy = float(rel[i][2]), float(rel[i][0]), float(rel[i][1])
            msgs.append(("/Cobot/Odometry",
                         "vector_slam_msgs/CobotOdometryMsg", t,
                         rb.serialize_cobot_odometry(dr / 2, dx / 2, dy / 2,
                                                     t)))
            t += 0.01
            c, s = np.cos(dr / 2), np.sin(dr / 2)
            hx, hy = dx / 2, dy / 2
            msgs.append(("/Cobot/Odometry",
                         "vector_slam_msgs/CobotOdometryMsg", t,
                         rb.serialize_cobot_odometry(
                             dr / 2, c * hx + s * hy, -s * hx + c * hy, t)))
            t += 0.01
        if with_set_location and i == len(scans) // 2:
            msgs.append(("set_location", "vector_slam_msgs/LocalizationMsg",
                         t, rb.serialize_localization(3.0, -2.0, 0.5)))
            t += 0.01
        msgs.append(("laser", "sensor_msgs/LaserScan", t,
                     rb.serialize_laser_scan(scans[i], float(angles[0]), inc,
                                             range_min=0.02, range_max=13.0,
                                             stamp=t)))
        t += 0.03
    return msgs


def _unindex(path):
    """Zero the bag header's index_pos (rosbag's crash marker): readers
    must take the linear path."""
    blob = bytearray(open(path, "rb").read())
    pos = blob.find(b"index_pos=") + len(b"index_pos=")
    blob[pos:pos + 8] = bytes(8)
    open(path, "wb").write(bytes(blob))


def _lz4_or_skip(compression):
    from hitl_slam_tpu.io import lz4frame

    if compression in ("lz4", "mixed") and not lz4frame.available():
        pytest.skip("liblz4.so.1 unavailable")


@pytest.mark.parametrize("indexed", [True, False])
@pytest.mark.parametrize("compression", ["none", "bz2", "lz4", "mixed"])
def test_bag_reader_matches_reference(stream, tmp_path, compression, indexed):
    """The port's read_messages, bag_to_stream (with a set_location event),
    apply_set_locations and bag_info give the reference's messages and
    arrays on a bag written by the reference's write_bag."""
    from hitl_slam_torch.io import rosbag as trb
    from hitl_slam_tpu.io import rosbag as jrb

    _lz4_or_skip(compression)
    scans, angles, rel, _, _ = stream
    path = str(tmp_path / "s.bag")
    jrb.write_bag(path, _cobot_bag_messages(scans, angles, rel, True),
                  compression=compression,
                  chunk_size=None if compression == "none" else 8192)
    if not indexed:
        _unindex(path)
    want = [(m.topic, m.msgtype, m.time, m.raw)
            for m in jrb.read_messages(path, use_native=False)]
    got = [(m.topic, m.msgtype, m.time, m.raw)
           for m in trb.read_messages(path)]
    assert got == want and len(got) > 3 * len(scans) // 2
    # a topic-filtered read: through the index where there is one
    topics = ("laser",)
    assert [(m.topic, m.raw) for m in trb.read_messages(path, topics=topics)] \
        == [(m.topic, m.raw) for m in jrb.read_messages(path, topics=topics)]

    for kw in (dict(max_laser_msgs=20), dict(time_skip=0.7)):
        for a, b in zip(trb.bag_to_stream(path, **kw),
                        jrb.bag_to_stream(path, **kw)):
            np.testing.assert_array_equal(np.asarray(a, object),
                                          np.asarray(b, object))
    j_scans, j_angles, j_rel, j_loc = jrb.bag_to_stream(path)
    t_scans, t_angles, t_rel, t_loc = trb.bag_to_stream(path)
    np.testing.assert_array_equal(t_scans, j_scans)
    np.testing.assert_array_equal(t_angles, j_angles)
    np.testing.assert_array_equal(t_rel, j_rel)
    assert t_loc == j_loc and len(t_loc) == 1
    np.testing.assert_array_equal(trb.apply_set_locations(t_rel, t_loc),
                                  jrb.apply_set_locations(j_rel, j_loc))
    assert trb.bag_info(path) == jrb.bag_info(path)


def test_bag_cli_and_reindex_match_reference(stream, tmp_path, capsys):
    """`python -m hitl_slam_torch.io.rosbag {info, reindex}` prints and
    writes what the reference's does; the port's writer writes the
    reference's bytes."""
    from hitl_slam_torch.io import rosbag as trb
    from hitl_slam_tpu.io import rosbag as jrb

    _lz4_or_skip("mixed")
    scans, angles, rel, _, _ = stream
    msgs = _cobot_bag_messages(scans, angles, rel)
    paths = {}
    for name, mod in (("t", trb), ("j", jrb)):
        paths[name] = str(tmp_path / f"{name}.bag")
        mod.write_bag(paths[name], msgs, compression="bz2", chunk_size=8192)
    assert open(paths["t"], "rb").read() == open(paths["j"], "rb").read()
    _unindex(paths["t"])
    outs = {}
    for name, mod in (("t", trb), ("j", jrb)):
        fixed = str(tmp_path / f"{name}.fixed.bag")
        assert mod._main(["reindex", paths["t"], "-o", fixed]) == 0
        assert mod._main(["info", fixed]) == 0
        outs[name] = (capsys.readouterr().out.replace(fixed, "FIXED"),
                      open(fixed, "rb").read())
    assert outs["t"] == outs["j"]
    assert "indexed:  True" in outs["t"][0]


def test_lz4_frame_matches_reference():
    """The port's lz4frame: xxh32 on the spec vectors, and frames that each
    package writes decode in the other (without liblz4 only xxh32 runs)."""
    from hitl_slam_torch.io import lz4frame as t4
    from hitl_slam_tpu.io import lz4frame as j4

    for data, want in ((b"", 0x02CC5D05), (b"abc", 0x32D153FF)):
        assert t4.xxh32(data) == want
    rng = np.random.default_rng(11)
    for n in (1, 15, 16, 17, 257, 4099):
        data = rng.integers(0, 256, n, np.uint8).tobytes()
        assert t4.xxh32(data, 7) == j4.xxh32(data, 7)
    assert t4.available() == j4.available()
    if not t4.available():
        return
    data = b"hello world " * 9000 + rng.integers(0, 256, 5000,
                                                 np.uint8).tobytes()
    assert t4.compress(data) == j4.compress(data)
    assert t4.decompress(j4.compress(data)) == data
    assert j4.decompress(t4.compress(data)) == data


LUA_INLINE = [
    """
-- comment
domain = "a";
T = {
  x = 1.0 / 40.0;
  ang = deg2rad(90.0);
  off = vec2(0.14, 0.0);
  nested = { deep = 3; };
  flag = true;
};
T.extra = 2 * (3 + 4);
""",
    """
domain = "a";
T = { v = 1; };
if domain == "a" then
  T.v = 10;
elseif domain == "b" then
  T.v = 20;
else
  T.v = 30;
end
""",
    """
function helper(x)
  return x * 2
end
T = { a = nil; b = 3; };
""",
    """
R = { name = "Cobot1"; wheels = 4; };
""",
]


@pytest.mark.parametrize("case", range(len(LUA_INLINE)))
def test_lua_config_matches_reference(tmp_path, case):
    """load_lua_config on tests/test_luaconfig.py's kinds of inline
    fixtures (tables, arithmetic, helpers, if/elseif blocks with locked
    overrides, skipped functions, dotted overrides) gives the reference's
    environment."""
    from hitl_slam_torch.utils.luaconfig import load_lua_config as tload
    from hitl_slam_tpu.utils.luaconfig import load_lua_config as jload

    p = tmp_path / "t.cfg"
    p.write_text(LUA_INLINE[case])
    for locked in (None, {"domain": "b"}, {"R.name": "Cobot3"}):
        assert tload(str(p), locked) == jload(str(p), locked)


def test_options_from_table_matches_reference():
    """options_from_table on a table with every translated name."""
    from hitl_slam_torch.models.enml.driver import options_from_table as topt
    from hitl_slam_tpu.models.enml.driver import options_from_table as jopt

    table = {"max_history": 6, "max_solver_iterations": 7,
             "num_repeat_iterations": 0, "point_match_threshold": 0.2,
             "odometry_rotation_min_stddev": 0.01,
             "odometry_rotation_max_stddev": 0.3, "min_translation": -1,
             "min_rotation": 0.05, "robot_laser_offset": {"x": 0.15},
             "max_point_cloud_range": 30.0, "unknown_key": 1}
    for off in ({"x": 0.15}, [0.1, 0.2]):
        table["robot_laser_offset"] = off
        (te, tp), (je, jp) = topt(table), jopt(table)
        assert vars(te) == vars(je) and vars(tp) == vars(jp)
        assert te.gn_iterations == 7 and te.match_rounds == 1


@pytest.mark.skipif(not os.path.isdir(REF_CFG_DIR),
                    reason="reference tree not present")
@pytest.mark.parametrize("locked", [None, {"enml_domain": "freiburg"},
                                    {"enml_domain": "orebro"},
                                    {"RobotConfig.name": "Cobot3"}])
def test_reference_cfg_files_match(locked):
    from hitl_slam_torch.models.enml.driver import options_from_table as topt
    from hitl_slam_torch.utils.luaconfig import load_lua_config as tload
    from hitl_slam_tpu.models.enml.driver import options_from_table as jopt
    from hitl_slam_tpu.utils.luaconfig import load_lua_config as jload

    t, j = tload(REF_CFGS, locked), jload(REF_CFGS, locked)
    assert t == j
    (te, tp), (je, jp) = (topt(t["NonMarkovLocalization"]),
                          jopt(j["NonMarkovLocalization"]))
    assert vars(te) == vars(je) and vars(tp) == vars(jp)


def test_load_config_toml_matches_reference(tmp_path):
    """load_config on config/hitl_slam.toml, a JSON mirror and a Lua .cfg;
    is_lua_config classifies alike; SubTree reads alike; WatchedConfig's
    thread reloads an edited file and calls back."""
    import json
    import threading
    import time

    from hitl_slam_torch.utils import config as tc
    from hitl_slam_tpu.utils import config as jc

    path = os.path.join(REPO, "config", "hitl_slam.toml")
    cfg = tc.load_config(path)
    assert cfg == jc.load_config(path) and cfg["lm"]["max_iterations"] == 100
    js = tmp_path / "c.json"
    js.write_text(json.dumps(cfg))
    lua = tmp_path / "c.cfg"
    lua.write_text('T = { v = 2; };\n')
    for p in (str(js), str(lua), path):
        assert tc.load_config(p) == jc.load_config(p)
        assert tc.is_lua_config(p) == jc.is_lua_config(p)
    for mod in (tc, jc):
        tree = mod.SubTree(cfg)
        assert (tree.get_int("lm.max_iterations"), tree.sub("em").get_float(
            "inlier_threshold"), tree.get_str("nope", "d")) == (100, 0.03, "d")
    w = tc.WatchedConfig([str(js)], poll_interval=0.05)
    seen = threading.Event()
    w.on_change(lambda data: seen.set())
    w.start()
    try:
        assert w.tree().get_int("lm.max_iterations") == 100
        cfg["lm"]["max_iterations"] = 7
        js.write_text(json.dumps(cfg))
        os.utime(js, (time.time() + 5, time.time() + 5))
        assert seen.wait(10.0)
        assert w.tree().get_int("lm.max_iterations") == 7
    finally:
        w.stop()


def test_stfs_writers_byte_equal(tmp_path):
    """save_stfs, save_odometry and append_test_set_poses write the
    reference's bytes."""
    from hitl_slam_torch.io import stfs as ts
    from hitl_slam_tpu.io import stfs as js

    rng = np.random.default_rng(5)
    poses = rng.normal(size=(5, 3)).astype(np.float32)
    clouds = [rng.normal(size=(k, 2)).astype(np.float32) for k in (3, 1, 4, 2, 5)]
    for name, mod in (("t", ts), ("j", js)):
        d = tmp_path / name
        d.mkdir()
        mod.save_stfs(str(d / "m.stfs"), "Map", 12.5, poses, clouds)
        mod.save_odometry(str(d / "odom.txt"), poses)
        for _ in range(2):
            p = mod.append_test_set_poses(3, poses, str(d))
        assert p == str(d / "non_markov_test_3.txt")
    for f in ("m.stfs", "odom.txt", "non_markov_test_3.txt"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f


def test_map_edit_matches_reference(tmp_path):
    """VectorMapFile and handle_map_edit (what --ltvm-map reads): the same
    segments, saved bytes and draw list as the reference's."""
    from hitl_slam_torch.gui import map_edit as tm
    from hitl_slam_tpu.gui import map_edit as jm

    msgs = [{"op": "add_line", "p1": [0, 0], "p2": [4, 0]},
            {"op": "add_line", "p1": [0, 1], "p2": [0, 5]},
            {"op": "delete_line", "p": [0.1, 3.0]},
            {"op": "delete_line", "p": [20.0, 20.0]},
            {"op": "add_line", "p1": [1, 1], "p2": [2, 3]},
            {"op": "save"}, {"op": "noop"}]
    out = {}
    for name, mod in (("t", tm), ("j", jm)):
        path = tmp_path / f"{name}.vectors.txt"
        path.write_text("1.0,2.0,3.0,4.0,17.0\n1,2\n5,6,7,8\n")
        vm = mod.VectorMapFile(str(path))
        changed = [mod.handle_map_edit(vm, m) for m in msgs]
        out[name] = (changed, vm.segments, path.read_bytes(),
                     vm.to_drawlist().to_json())
    assert out["t"] == out["j"]
    assert mod.VectorMapFile(str(tmp_path / "none.txt")).segments == []


def _run_cli(argv, capsys):
    from hitl_slam_torch import cli_enml

    rc = cli_enml.main(argv + ["--device", "cpu"])
    return rc, capsys.readouterr()


def test_cli_enml_inputs_and_flags(stream, tmp_path, capsys):
    """The port CLI's batch flags on tiny streams (W = 3): bag input with
    --max-laser-poses, --time-skip and --use-kinect; .npz input; --noise
    with --statistical-test and -t; --map-name, --scan-period; --ltvm-map;
    --profile; the errors for a bad input, --domain without --config and
    --device cuda without a card."""
    import json

    from hitl_slam_torch import cli_enml
    from hitl_slam_torch.io import rosbag as trb
    from hitl_slam_torch.io import stfs as ts

    scans, angles, rel, _, _ = stream
    small = ["--max-history", "3"]
    bag = str(tmp_path / "s.bag")
    msgs = _cobot_bag_messages(scans[:10], angles, rel[:10])
    kinect = [(trb.KINECT_TOPIC if m[0] == "laser" else m[0],) + m[1:]
              for m in msgs]
    trb.write_bag(bag, msgs)
    kbag = str(tmp_path / "k.bag")
    trb.write_bag(kbag, kinect)

    out = str(tmp_path / "bag")
    rc, cap = _run_cli(["-b", bag, "-o", out, "--max-laser-poses", "6",
                        "--map-name", "BagMap", "--scan-period", "0.1"]
                       + small, capsys)
    assert rc == 0 and "stream: 6 scans x 120 beams" in cap.out
    assert "at 10 Hz scans" in cap.out
    assert ts.load_stfs_covars(out + ".stfs.covars").map_name == "BagMap"
    rc, cap = _run_cli(["-b", bag, "-o", out, "--time-skip", "0.3"] + small,
                       capsys)
    kept = len(trb.bag_to_stream(bag, time_skip=0.3)[0])
    assert rc == 0 and 0 < kept < 10 and f"stream: {kept} scans" in cap.out
    rc, cap = _run_cli(["-b", kbag, "-o", out, "--use-kinect"] + small,
                       capsys)
    assert rc == 0 and "stream: 10 scans" in cap.out
    with pytest.raises(SystemExit, match="needs --use-kinect"):
        _run_cli(["-b", kbag, "-o", out] + small, capsys)

    npz = str(tmp_path / "s.npz")
    np.savez(npz, scans=np.asarray(scans[:5]), angles=angles,
             rel_odometry=rel[:5])
    rc, cap = _run_cli(["-b", npz, "-o", out, "--noise", "0.05",
                        "--statistical-test", "2", "-t", "3", "--seed", "1"]
                       + small, capsys)
    assert rc == 0 and ".trial1: 5 episode nodes localized" in cap.out
    lines = (tmp_path / "non_markov_test_3.txt").read_text().splitlines()
    assert len(lines) == 2 and lines[0] != lines[1]
    assert os.path.exists(out + ".trial0.stfs.covars")

    vectors = tmp_path / "map.vectors.txt"
    vectors.write_text("0,-5,0,5\n")
    rc, cap = _run_cli(["-b", npz, "-o", out, "--ltvm-map", str(vectors)]
                       + small, capsys)
    assert rc == 0 and "ltvm map: 1 segments" in cap.out
    trace = tmp_path / "trace"
    rc, cap = _run_cli(["-b", npz, "-o", out, "--profile", str(trace)]
                       + small, capsys)
    assert rc == 0
    events = json.loads((trace / "enml-run.pt.trace.json").read_text())
    assert any(e.get("name") == "enml-run" for e in events["traceEvents"])

    garbage = tmp_path / "x.bag"
    garbage.write_bytes(b"not a bag")
    with pytest.raises(SystemExit, match="not a ROS bag"):
        _run_cli(["-b", str(garbage), "-o", out] + small, capsys)
    with pytest.raises(SystemExit, match="require --config"):
        _run_cli(["-b", npz, "-o", out, "--domain", "orebro"] + small, capsys)
    if not torch.cuda.is_available():
        assert cli_enml.main(["--synthetic", "--steps", "4"]) == 2


def test_cli_enml_config(stream, tmp_path, capsys):
    """--config: a TOML NonMarkovLocalization table and a Lua .cfg with a
    domain block chosen by --domain set the localizer's options; a file
    without the table is an error."""
    scans, angles, rel, _, _ = stream
    npz = str(tmp_path / "s.npz")
    np.savez(npz, scans=np.asarray(scans[:5]), angles=angles,
             rel_odometry=rel[:5])
    out = str(tmp_path / "c")
    toml = tmp_path / "enml.toml"
    toml.write_text("[NonMarkovLocalization]\nmax_history = 3\n"
                    "max_solver_iterations = 4\npoint_match_threshold = 0.2\n"
                    "robot_laser_offset = [0.1, 0.0]\n")
    rc, cap = _run_cli(["-b", npz, "-o", out, "--config", str(toml)], capsys)
    assert rc == 0
    assert ("match_threshold=0.2 max_history=3 gn_iterations=4 "
            "sensor_offset=(0.1, 0.0)") in cap.out
    lua = tmp_path / "enml.cfg"
    lua.write_text('enml_domain = "cobot";\n'
                   'NonMarkovLocalization = { max_history = 3; '
                   'max_solver_iterations = 2; };\n'
                   'if enml_domain == "orebro" then\n'
                   '  NonMarkovLocalization.max_solver_iterations = 5;\n'
                   'end\n')
    rc, cap = _run_cli(["-b", npz, "-o", out, "--config", str(lua),
                        "--domain", "orebro"], capsys)
    assert rc == 0 and "domain='orebro'" in cap.out
    assert "gn_iterations=5" in cap.out
    empty = tmp_path / "empty.toml"
    empty.write_text("")
    with pytest.raises(SystemExit, match="NonMarkovLocalization"):
        _run_cli(["-b", npz, "-o", out, "--config", str(empty)], capsys)


def test_timer_collection_matches_reference():
    """TimerCollection accumulates and reports as the reference's;
    GLOBAL_TIMERS is one per process; device_trace off runs the block."""
    from hitl_slam_torch.utils import timing as tt
    from hitl_slam_tpu.utils import timing as jt

    reports = []
    for mod in (tt, jt):
        tc = mod.TimerCollection()
        for label in ("b", "a", "b"):
            with tc.time(label):
                pass
        tc.acc = {k: 0.001 * len(k) for k in tc.acc}   # fixed times
        reports.append(tc.report())
        assert dict(tc.count) == {"a": 1, "b": 2}
    assert reports[0] == reports[1]
    assert isinstance(tt.GLOBAL_TIMERS, tt.TimerCollection)
    ran = []
    with tt.device_trace("x", enabled=False):
        ran.append(1)
    assert ran == [1]

