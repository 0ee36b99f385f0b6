"""Probe how the EnML window solve's factorizations enter a CUDA graph on
the card.

The sweep's window solve calls `torch.linalg.cholesky_ex` and
`torch.cholesky_solve` on one [1, 3W, 3W] system a GN step and
`torch.linalg.inv_ex` on the [3W, 3W] Hessian a node
(models/enml/localizer.py). PyTorch may send such calls to MAGMA, which
synchronizes with the host and cannot be captured, or to cuSOLVER and
cuBLAS, which can; and a library may allocate scratch memory inside a
capture (stream-ordered allocation), which puts memory-allocation nodes
into the graph, nodes a conditional (WHILE) body or a child graph may not
hold. For W in (10, 80) this prints, for each capture: whether it held,
its nodes by type (0 kernel, 1 memcpy, 2 memset, 10 allocation, 11 free),
and whether its replay is bit-equal to the eager calls:

  1. each call alone, batched ([1, n, n]) and unbatched ([n, n]), the
     three together, and cholesky_solve as the sweep runs it (two
     triangular solves, localizer.py::cholesky_solve), on a side stream A, a side stream B, A again, and
     the stream that ran the process's first cuSOLVER call (after one
     eager run on the default stream);
  2. the three calls under each preferred library ("default", "cusolver",
     "magma") on a fresh side stream;
  3. the dense STF refine's step (solver/stf_solve.py::stf_lm_solve:
     `cholesky_ex` of one [n, n] system and two `solve_triangular`s) at
     n = 3072 and 6144 (the refine at 1024 poses and at
     refine.DENSE_POSE_LIMIT = 2048), inside a WHILE body of two trips of
     a `DeviceProgram` whose warm() factors and solves an [n, n] identity
     on the program's stream first: whether it captured, the node types
     of each captured piece, the kernels of one eager `cholesky_ex`
     (cuSOLVER's potrf or MAGMA), and the replay against eager.

With `--batched` it probes instead the checkerboard localizer's batched
calls (models/enml/parallel_localizer.py), each in a WHILE body of two
trips of a `DeviceProgram` whose warm() makes the same call at the same
shape on the program's stream: `inv_ex` of the SE(2) boundary transforms
[B, 3, 3] (B = 2, 8, 9, 13, 14 and 108 windows), `inv_ex` of the window
Hessians [ck, 3W, 3W] (16 x 30, 8 x 30 and 8 x 240), and the batched GN
step (`cholesky_ex` and two `solve_triangular`s) at [16, 30, 30] and
[8, 240, 240]: whether each captured, the kernels of one eager call
(cuSOLVER, cuBLAS or MAGMA), and the replay against eager.

Run on the card: `python scripts/linalg_capture_probe.py [--batched]`
(~30 s with the build of the graph helper). Prints one JSON line last;
exits 1 without CUDA.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hitl_slam_torch.utils import cuda_build  # noqa: E402
from hitl_slam_torch.utils.device_loop import (DeviceProgram,  # noqa: E402
                                               device_while)

NODE_TYPES = 16


def _system(n: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """An SPD [1, n, n] system and a [1, n, 1] right-hand side, seeded."""
    g = torch.Generator().manual_seed(n)
    a = torch.randn((n, n), generator=g)
    H = (a @ a.T + n * torch.eye(n))[None].to(dev)
    b = torch.randn((1, n, 1), generator=g).to(dev)
    return H, b


def _all(H, b):
    L = torch.linalg.cholesky_ex(H)[0]
    x = torch.cholesky_solve(b, L)
    inv = torch.linalg.inv_ex(H[0])[0]
    return x, inv


CALLS = {
    "cholesky_ex [1,n,n]": lambda H, b: torch.linalg.cholesky_ex(H)[0],
    "cholesky_ex [n,n]": lambda H, b: torch.linalg.cholesky_ex(H[0])[0],
    "cholesky_solve [1,n,n]": lambda H, b: torch.cholesky_solve(
        b, torch.linalg.cholesky_ex(H)[0]),
    "cholesky_solve [n,n]": lambda H, b: torch.cholesky_solve(
        b[0], torch.linalg.cholesky_ex(H[0])[0]),
    "inv_ex [n,n]": lambda H, b: torch.linalg.inv_ex(H[0])[0],
    "all three": _all,
    "two solve_triangular [1,n,n]": lambda H, b: _triangular(H, b),
    "the sweep's three": lambda H, b: (
        _triangular(H, b), torch.linalg.inv_ex(H[0])[0]),
}


def _triangular(H, b):
    """cholesky_solve as the window solve runs it: two triangular solves
    with the Cholesky factor (localizer.py::cholesky_solve)."""
    L = torch.linalg.cholesky_ex(H)[0]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _types(lib, g) -> dict[int, int]:
    counts = (ctypes.c_ulonglong * NODE_TYPES)()
    code = lib.hitl_loop_node_types(ctypes.c_void_p(g.raw_cuda_graph()),
                                    counts, NODE_TYPES)
    if code:
        return {"error": code}
    return {t: int(c) for t, c in enumerate(counts) if c}


def _capture(lib, fn, H, b, stream) -> dict:
    """fn(H, b) warmed on `stream`, then captured there."""
    dev = H.device
    want = fn(H, b)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn(H, b)
    torch.cuda.synchronize(dev)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(g, stream=stream):
            out = fn(H, b)
    except RuntimeError as e:
        torch.cuda.synchronize(dev)
        return {"captured": False, "error": str(e).splitlines()[0][:160]}
    types = _types(lib, g)
    g.replay()
    torch.cuda.synchronize(dev)
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    return {"captured": True, "node_types": types,
            "replay_bit_equal": all(torch.equal(a, w)
                                    for a, w in zip(outs, wants))}


def _refine_step(H, b):
    """The dense refine's step on an [n, n] system and [n, 1] column."""
    L = torch.linalg.cholesky_ex(H)[0]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _potrf_kernels(H) -> list[str]:
    """The CUDA kernels of one eager cholesky_ex of H."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(H.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.linalg.cholesky_ex(H)
        torch.cuda.synchronize(H.device)
    return sorted({e.key[:60] for e in prof.key_averages()
                   if e.device_type.name == "CUDA"})[:8]


def refine_in_while(n: int, dev) -> dict:
    """_refine_step in a WHILE body of two trips of a DeviceProgram."""
    H1, b1 = _system(n, dev)
    H, b = H1[0].contiguous(), b1[0].contiguous()

    def fn(H, b):
        out = torch.zeros_like(b)
        k = torch.zeros((), dtype=torch.int32, device=H.device)
        cond = torch.ones((), dtype=torch.bool, device=H.device)

        def body():
            out.copy_(_refine_step(H, b + k.to(b.dtype)))
            k.add_(1)
            torch.lt(k, 2, out=cond)

        device_while(cond, body, 4)
        return out, k

    def warm():
        eye = torch.eye(n, device=dev)
        _refine_step(eye, torch.ones((n, 1), device=dev))

    row = {"n": n, "eager_kernels": _potrf_kernels(H)}
    want, _ = fn(H, b)
    prog = DeviceProgram(fn, (H, b), dev, warm=warm)
    try:
        got, k = prog.run(H, b)
    except RuntimeError as e:
        torch.cuda.synchronize(dev)
        row.update(captured=False, error=str(e).splitlines()[0][:300])
        return row
    g = prog.graph()
    row.update(captured=True, trips=int(k),
               replay_bit_equal=bool(torch.equal(got, want)),
               max_abs_diff=float((got - want).abs().max()),
               capture_ms=g.capture_ms, pool_mib=g.pool_mib,
               piece_node_types=[
                   g.node_types(ctypes.c_void_p(p.raw_cuda_graph()))
                   for p in g._pieces])
    return row


def _kernels(fn) -> list[str]:
    """The CUDA kernels of one eager fn()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:60] for e in prof.key_averages()
                   if e.device_type.name == "CUDA"})[:10]


def _spd_batch(B: int, n: int, dev) -> torch.Tensor:
    g = torch.Generator().manual_seed(B * 1000 + n)
    a = torch.randn((B, n, n), generator=g)
    return (a @ a.mT + n * torch.eye(n)).to(dev)


def _gn_step(H):
    L = torch.linalg.cholesky_ex(H)[0]
    b = torch.ones(H.shape[:-1] + (1,), dtype=H.dtype, device=H.device)
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


BATCHED = {
    **{f"inv_ex [{B}, 3, 3]": (B, 3, lambda H: torch.linalg.inv_ex(H)[0])
       for B in (2, 8, 9, 13, 14, 108)},
    **{f"inv_ex [{B}, {n}, {n}]": (B, n, lambda H: torch.linalg.inv_ex(H)[0])
       for B, n in ((16, 30), (8, 30), (8, 240))},
    **{f"GN step [{B}, {n}, {n}]": (B, n, _gn_step)
       for B, n in ((16, 30), (8, 240))},
}


def batched_in_while(name: str, B: int, n: int, call, dev) -> dict:
    """call(H + k) for k = 0, 1 in a WHILE body of a DeviceProgram."""
    H = _spd_batch(B, n, dev)
    shape = tuple(call(H).shape)

    def fn(H):
        out = torch.zeros(shape, dtype=H.dtype, device=H.device)
        k = torch.zeros((), dtype=torch.int32, device=H.device)
        cond = torch.ones((), dtype=torch.bool, device=H.device)

        def body():
            out.copy_(call(H + k.to(H.dtype)))
            k.add_(1)
            torch.lt(k, 2, out=cond)

        device_while(cond, body, 4)
        return out, k

    row = {"case": name, "eager_kernels": _kernels(lambda: call(H))}
    want, _ = fn(H)
    prog = DeviceProgram(fn, (H,), dev, warm=lambda: call(H.clone()))
    try:
        got, k = prog.run(H)
    except RuntimeError as e:
        torch.cuda.synchronize(dev)
        row.update(captured=False, error=str(e).splitlines()[0][:300])
        return row
    g = prog.graph()
    row.update(captured=True, trips=int(k),
               replay_bit_equal=bool(torch.equal(got, want)),
               capture_ms=g.capture_ms, pool_mib=g.pool_mib,
               piece_node_types=[
                   g.node_types(ctypes.c_void_p(p.raw_cuda_graph()))
                   for p in g._pieces])
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("linalg_capture_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = cuda_build.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    rows = {}
    if "--batched" in sys.argv[1:]:
        for name, (B, n, call) in BATCHED.items():
            res = batched_in_while(name, B, n, call, dev)
            print(f"[linalg] {res}", flush=True)
            rows[name] = res
        print(json.dumps({"linalg_capture_batched": rows}))
        return 0
    first = torch.cuda.Stream(dev)
    for W in (10, 80):
        H, b = _system(3 * W, dev)
        if W == 10:
            # the process's first cuSOLVER call, on `first`
            with torch.cuda.stream(first):
                _all(H, b)
            torch.cuda.synchronize(dev)
        _all(H, b)                     # an eager run on the default stream
        res = {}
        a, c = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        for name, fn in CALLS.items():
            for where, s in (("side A", a), ("side B", c), ("side A again", a),
                             ("first stream", first)):
                res[f"{name}, {where}"] = _capture(lib, fn, H, b, s)
        prev = torch.backends.cuda.preferred_linalg_library()
        for lib_name in ("default", "cusolver", "magma"):
            torch.backends.cuda.preferred_linalg_library(lib_name)
            try:
                res[f"all three, {lib_name}, side"] = _capture(
                    lib, _all, H, b, torch.cuda.Stream(dev))
            finally:
                torch.backends.cuda.preferred_linalg_library(prev)
        for k, v in res.items():
            print(f"[linalg] W = {W}: {k}: {v}")
        rows[str(W)] = res
    for n in (3072, 6144):
        res = refine_in_while(n, dev)
        print(f"[linalg] refine step in a WHILE body: {res}", flush=True)
        rows[f"refine_{n}"] = res
    print(json.dumps({"linalg_capture": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
