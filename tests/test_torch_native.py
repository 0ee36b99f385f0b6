"""Port parity of the native host libraries (hitl_slam_torch/native/): the
.stfs.covars parser, the ROS-bag record scanner and its xxHash32, built by
g++ at first use, against the port's own Python paths and the JAX package's
native libraries on the same inputs (clean, mixed-compression indexed,
truncated and malformed bags). Host code only: no tensor work."""

import gzip
import os
import struct
import warnings

import numpy as np
import pytest

from test_torch_enml_io import _cobot_bag_messages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


@pytest.fixture(scope="module")
def stream():
    from hitl_slam_tpu.io.figure8 import generate_raw_stream

    return generate_raw_stream(num_steps=48, num_rays=120, seed=4)


def test_both_libraries_build():
    """Both libraries build with this machine's g++ into the gitignored
    build directory, and the reference's build too (the parity below
    compares with it)."""
    from hitl_slam_torch import native
    from hitl_slam_tpu import native as jnative

    assert native.available() and native.bag_available()
    assert jnative.available() and jnative.bag_available()
    lib = native._load_lib("stfs_parser")
    assert os.path.dirname(os.path.dirname(lib._name)) == native.BUILD


def _plain_copy(tmp_path, name):
    """tests/data/<name> as an uncompressed file (gunzipped if it is .gz)."""
    src = os.path.join(DATA, name)
    if not name.endswith(".gz"):
        return src
    dst = str(tmp_path / name[:-3])
    with gzip.open(src, "rb") as f, open(dst, "wb") as g:
        g.write(f.read())
    return dst


@pytest.mark.parametrize("name", ["golden.stfs.covars",
                                  "golden_large.stfs.covars.gz"])
def test_stfs_parser_matches_python_and_reference(tmp_path, name):
    """parse_stfs_file's rows equal the reference's native parse bit for
    bit, and load_stfs_covars through it equals the numpy path."""
    from hitl_slam_torch import native
    from hitl_slam_torch.io import stfs
    from hitl_slam_tpu import native as jnative

    path = _plain_copy(tmp_path, name)
    got = native.parse_stfs_file(path)
    want = jnative.parse_stfs_file(path)
    assert got[:2] == want[:2]
    assert got[2].dtype == np.float64 and np.array_equal(got[2], want[2])
    a = stfs.load_stfs_covars(path, use_native=True)
    b = stfs.load_stfs_covars(path, use_native=False)
    assert (a.map_name, a.timestamp) == (b.map_name, b.timestamp)
    for x, y in [(a.poses, b.poses), (a.covariances, b.covariances)]:
        assert np.array_equal(x, y)
    for x, y in zip(a.point_clouds + a.normal_clouds,
                    b.point_clouds + b.normal_clouds):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("case", ["missing", "short_row", "long_row",
                                  "trailing_comma", "bad_timestamp"])
def test_stfs_parser_refuses_what_python_refuses(tmp_path, case):
    """A missing file or a row that is not 16 comma-separated numbers: the
    native parser refuses the file (None), and load_stfs_covars raises the
    Python path's error, as with use_native=False."""
    from hitl_slam_torch import native
    from hitl_slam_torch.io import stfs

    path = str(tmp_path / "bad.stfs.covars")
    if case != "missing":
        lines = open(os.path.join(DATA, "golden.stfs.covars")
                     ).read().splitlines()
        fields = lines[3].split(",")
        bad = {"short_row": ",".join(fields[:15]),
               "long_row": ",".join(fields + ["1.0"]),
               "trailing_comma": lines[3] + ",",
               "bad_timestamp": lines[3]}[case]
        head = lines[:2] if case != "bad_timestamp" else [lines[0], "t0"]
        open(path, "w").write("\n".join(head + lines[2:6] + [bad]
                                         + lines[6:9]) + "\n")
    assert native.parse_stfs_file(path) is None
    for use_native in (True, False):
        with pytest.raises((OSError, ValueError)):
            stfs.load_stfs_covars(path, use_native=use_native)


def test_stfs_parser_skips_blank_lines(tmp_path):
    """Blank lines among the rows are skipped by both parsers."""
    from hitl_slam_torch import native
    from hitl_slam_torch.io import stfs

    lines = open(os.path.join(DATA, "golden.stfs.covars")).read().splitlines()
    path = str(tmp_path / "blank.stfs.covars")
    open(path, "w").write("\n".join(lines[:5] + ["", "  "] + lines[5:40])
                          + "\n\n")
    assert len(native.parse_stfs_file(path)[2]) == 38
    a = stfs.load_stfs_covars(path, use_native=True)
    b = stfs.load_stfs_covars(path, use_native=False)
    assert np.array_equal(a.poses, b.poses)


def _messages_and_warnings(path, use_native):
    from hitl_slam_torch.io import rosbag as rb

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        msgs = list(rb.read_messages(path, use_native=use_native))
    return msgs, sorted(str(r.message) for r in rec)


def _dirty_tail():
    """tests/test_rosbag.py's malformed records: a corrupt bz2 chunk, a
    conn-less message, an id-less connection, an unknown op, duplicate
    header keys, a field without '=', a field overrunning its header, short
    conn and time fields."""
    from hitl_slam_tpu.io import rosbag as rb

    def rec(hdr, data):
        return (struct.pack("<I", len(hdr)) + hdr
                + struct.pack("<I", len(data)) + data)

    dup = (rb._field("op", bytes([0x02])) + rb._field("conn", bytes(4))
           + rb._field("time", rb._time(1.0)) + rb._field("op", bytes([0x7F])))
    noeq = b"\x04\x00\x00\x00neq!" + rb._field("op", bytes([0x7F]))
    overrun = rb._field("op", bytes([0x7F])) + b"\xff\x00\x00\x00ov=1"
    short = (rb._field("op", bytes([0x02])) + rb._field("conn", b"\x01\x00")
             + rb._field("time", b"\x01\x00\x00\x00"))
    return (rb._record({"op": bytes([0x05]), "compression": b"bz2",
                        "size": b"\x10\x00\x00\x00"}, b"NOT-BZ2-DATA")
            + rb._record({"op": bytes([0x02])}, b"orphan")
            + rb._record({"op": bytes([0x07]), "topic": b"ghost"}, b"")
            + rb._record({"op": bytes([0x7F]), "future": b"record"}, b"xyz")
            + rec(dup, b"xyz") + rec(noeq, b"z") + rec(overrun, b"q")
            + rec(short, b"ab"))


def _bags(stream, tmp_path):
    """{case: path}: clean, mixed-compression indexed, cut in a record's
    data, cut in a record's header, 2 trailing bytes, malformed records."""
    from hitl_slam_tpu.io import rosbag as jrb

    scans, angles, rel, _, _ = stream
    msgs = _cobot_bag_messages(scans, angles, rel, True)
    paths = {"clean": str(tmp_path / "clean.bag"),
             "mixed": str(tmp_path / "mixed.bag")}
    jrb.write_bag(paths["clean"], msgs, chunk_size=8192)
    jrb.write_bag(paths["mixed"], msgs, compression="mixed", chunk_size=8192)
    blob = open(paths["clean"], "rb").read()
    for name, data in (("cut_data", blob[:int(len(blob) * 0.6)]),
                       ("cut_header", blob[:int(len(blob) * 0.997)]),
                       ("tail", blob + b"\x01\x02"),
                       ("malformed", blob + _dirty_tail())):
        paths[name] = str(tmp_path / f"{name}.bag")
        open(paths[name], "wb").write(data)
    return paths


CASES = ["clean", "mixed", "cut_data", "cut_header", "tail", "malformed"]


@pytest.mark.parametrize("case", CASES)
def test_bag_scanner_matches_python_and_reference(stream, tmp_path, case):
    """read_messages through the native scanner gives the Python path's
    messages and warnings, and scan_bag_records the reference scanner's
    columns on the whole record stream."""
    from hitl_slam_torch import native
    from hitl_slam_tpu import native as jnative
    from hitl_slam_tpu.io import rosbag as jrb

    if case == "mixed":
        from hitl_slam_tpu.io import lz4frame

        if not lz4frame.available():
            pytest.skip("liblz4.so.1 unavailable")
    path = _bags(stream, tmp_path)[case]
    nat, nat_warn = _messages_and_warnings(path, True)
    py, py_warn = _messages_and_warnings(path, False)
    assert len(nat) == len(py) > 0
    for a, b in zip(nat, py):
        assert (a.topic, a.msgtype, a.time, a.raw) == (b.topic, b.msgtype,
                                                       b.time, b.raw)
    assert nat_warn == py_warn
    # the reference reader sees the same messages
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = list(jrb.read_messages(path, use_native=True))
    assert [(m.topic, m.time, m.raw) for m in ref] == [
        (m.topic, m.time, m.raw) for m in nat]
    blob = open(path, "rb").read()
    off = len(jrb.VERSION_LINE)
    got, want = native.scan_bag_records(blob, off), jnative.scan_bag_records(
        blob, off)
    assert got["stop"] == want["stop"]
    for k in ("op", "conn", "time", "header_off", "header_len", "data_off",
              "data_len"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_xxh32_matches_python_and_reference():
    """Known-answer vectors of the xxHash spec, then random lengths across
    every tail path and random seeds: native, Python and the reference's
    native agree."""
    from hitl_slam_torch import native
    from hitl_slam_torch.io import lz4frame
    from hitl_slam_tpu import native as jnative

    vectors = [(b"", 0, 0x02CC5D05), (b"abc", 0, 0x32D153FF),
               (b"Nobody inspects the spammish repetition", 0, 0xE2293B2F)]
    for data, seed, want in vectors:
        assert native.xxh32(data, seed) == want
        assert lz4frame.xxh32(data, seed) == want
    rng = np.random.default_rng(11)
    for n in (1, 3, 4, 15, 16, 17, 31, 257, 65536, 100001):
        data = rng.integers(0, 256, n, np.uint8).tobytes()
        seed = int(rng.integers(0, 2**32))
        want = lz4frame._xxh32_py(data, seed)
        assert native.xxh32(data, seed) == want
        assert jnative.xxh32(data, seed) == want


def test_fallback_when_the_library_cannot_build(monkeypatch, tmp_path):
    """No compiler: every native function says so (None / False) and the
    readers take their Python paths with the same results."""
    from hitl_slam_torch import native
    from hitl_slam_torch.io import lz4frame, stfs

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not native.available() and not native.bag_available()
    assert native.xxh32(b"abc") is None
    assert native.scan_bag_records(b"") is None
    path = os.path.join(DATA, "golden.stfs.covars")
    assert native.parse_stfs_file(path) is None
    assert lz4frame.xxh32(b"abc") == 0x32D153FF
    a = stfs.load_stfs_covars(path)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.delenv("CXX")
    b = stfs.load_stfs_covars(path)
    assert np.array_equal(a.poses, b.poses)
