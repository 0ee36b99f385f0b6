"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled by its own `nvcc` process, all started together,
for `sm_90a` into an object file; the objects are linked into one shared
library with a plain C interface, loaded with ctypes. The build happens at
first use, from the package's own sources, into `hitl_slam_torch/build/<key>/`
where the key hashes the sources and flags, so an edited source rebuilds
and an unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source extra flags: em_scan must not contract a*b+c into an FMA, so
# that its per-point squared distances are bit-identical to the separate
# torch ops of its plain version (exact counts at the threshold); nor must
# lm_step, so that its assembly rounds as the plain version's separate ops;
# nor em_refit, so that its inlier test and its terms round as its plain
# version's (the same inliers, bit for bit)
EXTRA = {"em_scan.cu": ["--fmad=false"], "lm_step.cu": ["--fmad=false"],
         "em_refit.cu": ["--fmad=false"]}
SOURCES = ("em_scan.cu", "bcr.cu", "graph_loop.cu", "lm_step.cu",
           "em_refit.cu")
LIB_NAME = "libhitl_kernels.so"


class LaunchCounter:
    """A count of kernel launches, bumped (`bump`) by a wrapper right where
    it launches its kernel and nowhere else.

    An eager launch adds one on the host. A launch captured into a CUDA
    graph launches nothing at capture time: it captures, beside the kernel,
    one one-thread kernel that adds one to a device counter and, inside a
    LoopGraph, marks the graph's stage clock with the counter's name
    (csrc/graph_loop.cu::count_and_mark), so that every replay counts the
    launches it makes, and inside a device loop (utils/device_loop.py) only
    those of the trips that run. The device counter is made before the
    capture (`prepare`), outside the graph's memory. `count` is the host's
    count plus the device counters' (reading those waits for the device);
    setting it sets the host's and zeroes the device counters.

    A counter made with `mark=False` counts without marking the stage
    clock: a kernel inside a loop whose edges a reader fixes (the LM's
    `lm` and `bcr_solve`, cardbench/stages.py) then adds its time to the
    edge it runs in rather than a new one."""

    def __init__(self, name: str, mark: bool = True):
        self.name = name
        self.mark = mark
        self._host = 0
        self._device: dict = {}
        counters.append(self)

    def prepare(self, device) -> None:
        """Make the device counter for captures on `device` (a CUDA
        device), if there is none yet."""
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.index not in self._device:
            self._device[device.index] = torch.zeros(
                (), dtype=torch.int64, device=device)

    def bump(self, device) -> None:
        """One launch of the kernel on CUDA `device`, eager or captured."""
        if not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            self._host += 1
            return
        counter = self._device.get(device.index)
        if counter is None:
            raise RuntimeError(
                f"{self.name}: a launch captured into a CUDA graph needs "
                f"its device counter made before the capture "
                f"(LaunchCounter.prepare)")
        from .device_loop import mark_node

        mark_node(self.name, device, counter.data_ptr(), self.mark)

    @property
    def count(self) -> int:
        return self._host + sum(int(c) for c in self._device.values())

    @count.setter
    def count(self, value: int) -> None:
        self._host = int(value)
        for c in self._device.values():
            c.zero_()


counters: list[LaunchCounter] = []     # every counter made, in order


def all_counters() -> list[LaunchCounter]:
    """Every kernel's launch counter, and any other made so far. The
    kernel wrappers' modules are imported here, so that their counters
    exist before a capture whatever the caller imported: a wrapper first
    imported inside a capture could not count its launches there."""
    from ..ops import em_refit, em_scan  # noqa: F401
    from ..solver import bcr_kernel, lm_step  # noqa: F401

    return list(counters)


def prepare_counters(device) -> None:
    """Make every kernel's device counter for captures on `device`."""
    for counter in all_counters():
        counter.prepare(device)


def require(kernel: str, name: str, t, shape: tuple, dtype, device,
            per_system: bool = False) -> None:
    """Validate a tensor handed to a kernel wrapper: device, dtype, shape
    and contiguity (with `per_system`, only within each slice of the first
    dimension, for a kernel that takes the stride between them), raising
    ValueError on anything the kernel does not take."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} shape {tuple(t.shape)} != {shape}")
    if not (t[0] if per_system else t).is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous"
                         + (" within a system" if per_system else ""))


class BuildInfo:
    """What the last build() did: the library's path, whether it was
    reused, and nvcc's output (ptxas register and spill lines)."""

    def __init__(self):
        self.path = ""
        self.cached = False
        self.log = ""


_lib = None
build_info = BuildInfo()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _key() -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH + COMMON).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update(" ".join(EXTRA.get(name, [])).encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if needed; return the shared library's path."""
    out_dir = os.path.join(BUILD, _key())
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        build_info.path, build_info.cached = lib, True
        return lib
    nvcc = nvcc_path()
    os.makedirs(BUILD, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp-", dir=BUILD)
    try:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = ([nvcc] + ARCH + COMMON + EXTRA.get(name, [])
                   + ["-c", os.path.join(CSRC, name), "-o", obj])
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"--- {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(logs))
        link = subprocess.run(
            [nvcc] + ARCH + ["-shared", "-o", os.path.join(tmp, LIB_NAME)]
            + [obj for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"--- link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + "\n".join(logs))
        os.makedirs(out_dir, exist_ok=True)
        os.replace(os.path.join(tmp, LIB_NAME), lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.path, build_info.cached = lib, False
    build_info.log = "\n".join(logs)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.hitl_em_scan.argtypes = [vp, vp, vp, f, i, i, i, i, vp, vp, vp,
                                     vp, vp]
        lib.hitl_em_scan.restype = i
        lib.hitl_bcr_solve.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                       vp]
        lib.hitl_bcr_solve.restype = i
        lib.hitl_bcr_solve_batched.argtypes = [vp, vp, vp, vp, vp, i, i, i,
                                               i, i, i, i, vp]
        lib.hitl_bcr_solve_batched.restype = i
        ll = ctypes.c_longlong
        lib.hitl_bcr_solve_multi.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll,
                                             i, i, i, i, i, i, i, i, vp]
        lib.hitl_bcr_solve_multi.restype = i
        lib.hitl_lm_step.argtypes = [ctypes.POINTER(vp),
                                     ctypes.POINTER(f),
                                     ctypes.POINTER(i), vp]
        lib.hitl_lm_step.restype = i
        lib.hitl_em_refit.argtypes = [ctypes.POINTER(vp),
                                      ctypes.POINTER(f),
                                      ctypes.POINTER(i), vp]
        lib.hitl_em_refit.restype = i
        pp, ull = ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_ulonglong)
        for name, args in (("hitl_loop_graph_new", [pp]),
                           ("hitl_loop_append", [vp, pp, vp]),
                           ("hitl_loop_add_while",
                            [vp, pp, vp, pp, ull, vp, i]),
                           ("hitl_loop_close_body",
                            [vp, vp, ctypes.c_ulonglong, vp, vp, i]),
                           ("hitl_loop_add_clock", [vp, pp, vp, i]),
                           ("hitl_clock_mark", [vp, vp, i, vp]),
                           ("hitl_clock_stamp", [vp, vp]),
                           ("hitl_loop_graph_nodes", [vp, ull]),
                           ("hitl_loop_node_types", [vp, ull, i]),
                           ("hitl_loop_instantiate", [vp, pp]),
                           ("hitl_loop_launch", [vp, vp]),
                           ("hitl_loop_destroy", [vp, vp])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        lib.hitl_cuda_error_string.argtypes = [i]
        lib.hitl_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().hitl_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
