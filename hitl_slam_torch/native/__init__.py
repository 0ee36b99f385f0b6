"""Native (C++) host pieces, built at first use, with Python fallbacks.

Port of hitl_slam_tpu/native/: the .stfs.covars parser (stfs_parser.cpp)
and the ROS-bag record scanner (bag_scanner.cpp, which also holds the
xxHash32 of the lz4 frames). These are host code, not device kernels. Each
library is built by `g++` on its first use into
`hitl_slam_torch/build/native/<key>/`, where the key hashes the source and
the flags (no `-march=native`: a build directory copied to another machine
must still load there). The Python paths are the contract: when the
compiler or the build is missing, every function here returns None (or
`available()` False) and the callers (io/stfs.py, io/rosbag.py,
io/lz4frame.py) take their Python path, which gives the same results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(os.path.dirname(_DIR), "build", "native")
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-Wall"]
_lock = threading.Lock()
_libs: dict[str, object] = {}       # name -> CDLL | None (None = failed)


def _build(name: str) -> str:
    """Compile lib<name>.so if needed; return its path (raises on failure)."""
    src = os.path.join(_DIR, f"{name}.cpp")
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    out_dir = os.path.join(BUILD, h.hexdigest()[:16])
    so = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(so):
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".so",
                               dir=out_dir)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", tmp, src], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _load_lib(name: str):
    """Build and dlopen lib<name>.so; the CDLL, or None (cached) when it
    cannot be built or loaded."""
    with _lock:
        if name in _libs:
            return _libs[name]
        try:
            lib = ctypes.CDLL(_build(name))
        except (subprocess.SubprocessError, OSError):
            lib = None
        _libs[name] = lib
        return lib


def _load():
    lib = _load_lib("stfs_parser")
    if lib is not None and not getattr(lib, "_configured", False):
        lib.parse_stfs_covars.restype = ctypes.c_int64
        lib.parse_stfs_covars.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.count_lines.restype = ctypes.c_int64
        lib.count_lines.argtypes = [ctypes.c_char_p]
        lib._configured = True
    return lib


def available() -> bool:
    """Whether the .stfs.covars parser built and loaded."""
    return _load() is not None


def _load_bag():
    lib = _load_lib("bag_scanner")
    if lib is not None and not getattr(lib, "_configured", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.bag_count_records.restype = ctypes.c_int64
        lib.bag_count_records.argtypes = [u8p, ctypes.c_int64,
                                          ctypes.c_int64]
        lib.bag_scan_records.restype = ctypes.c_int64
        lib.bag_scan_records.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), i64p,
            ctypes.POINTER(ctypes.c_double), i64p, i64p, i64p, i64p, i64p,
        ]
        lib.bag_xxh32.restype = ctypes.c_uint32
        lib.bag_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_uint32]
        lib._configured = True
    return lib


def xxh32(data: bytes, seed: int = 0):
    """xxHash32 by the native scanner library; None if it is unavailable
    (io/lz4frame.py then uses its Python one)."""
    lib = _load_bag()
    if lib is None:
        return None
    return int(lib.bag_xxh32(data, len(data), seed & 0xFFFFFFFF))


def bag_available() -> bool:
    """Whether the bag record scanner built and loaded."""
    return _load_bag() is not None


def scan_bag_records(buf, off: int = 0):
    """Scan a v2.0 record stream (a whole bag after the version line, or one
    decompressed chunk payload) in C. Returns None if the native library is
    unavailable, else a dict of per-record numpy columns:

      op [N] i32        first byte of the record's (last) "op" field; -1
      conn [N] i64      (last) "conn" field as u32; -1 if missing/short
      time [N] f64      (last) "time" field secs+1e-9*nsecs; NaN if missing
      header_off/header_len, data_off/data_len [N] i64 into `buf`
      stop (status, record_start, consumed):
          status 0 = clean end, 1 = 1-3 trailing bytes,
          2 = truncated record header, 3 = truncated record data

    Field semantics are those of io/rosbag.py::_parse_header and
    _iter_records."""
    lib = _load_bag()
    if lib is None:
        return None
    arr = np.frombuffer(buf, np.uint8)     # zero-copy view of the bytes
    n = arr.size
    if n == 0:
        arr = np.zeros(1, np.uint8)
    bufp = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    count = int(lib.bag_count_records(bufp, n, off))
    cols = dict(
        op=np.empty(count, np.int32), conn=np.empty(count, np.int64),
        time=np.empty(count, np.float64),
        header_off=np.empty(count, np.int64),
        header_len=np.empty(count, np.int64),
        data_off=np.empty(count, np.int64),
        data_len=np.empty(count, np.int64),
    )
    stop = np.zeros(3, np.int64)

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    got = int(lib.bag_scan_records(
        bufp, n, off, count, ptr(cols["op"], ctypes.c_int32),
        ptr(cols["conn"], ctypes.c_int64), ptr(cols["time"], ctypes.c_double),
        ptr(cols["header_off"], ctypes.c_int64),
        ptr(cols["header_len"], ctypes.c_int64),
        ptr(cols["data_off"], ctypes.c_int64),
        ptr(cols["data_len"], ctypes.c_int64), ptr(stop, ctypes.c_int64)))
    if got != count:   # only on a mid-scan inconsistency
        cols = {k: v[:got] for k, v in cols.items()}
    cols["stop"] = (int(stop[0]), int(stop[1]), int(stop[2]))
    return cols


def parse_stfs_file(path: str):
    """Parse a .stfs.covars file with the native library. Returns
    (map_name, timestamp, rows [N, 16] float64), or None if the native path
    is unavailable or the file does not parse."""
    lib = _load()
    if lib is None:
        return None
    pathb = path.encode()
    max_rows = int(lib.count_lines(pathb))
    if max_rows <= 0:
        return None
    out = np.empty((max_rows, 16), np.float64)
    name = ctypes.create_string_buffer(256)
    ts = ctypes.c_double()
    n = lib.parse_stfs_covars(
        pathb, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_rows, name, 256, ctypes.byref(ts),
    )
    if n < 0:
        return None
    return name.value.decode(), float(ts.value), out[:n]
