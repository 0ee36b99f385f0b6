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

With `--reduced` it probes the pose-sharded LM's reduced solve
(parallel/sharded_solver.py::_reduced_solve: the [6d, 6d] boundary system
assembled by index_put from [d, 42] coefficients, its LU, and a solve with
one step of refinement) at d = 4 and 8, by five routes (the port's; two
`lu_solve`s, which go to cuSOLVER's getrs; the factor alone; cuBLAS's
batched getrf on two copies; an LU in plain tensor operations), as the
SPIKE runs it on one card: one eager call under
torch.cuda.set_sync_debug_mode("error"), the kernels of one eager call
(cuSOLVER, cuBLAS or MAGMA), the call in a WHILE body of two trips of a
`DeviceProgram` whose warm() makes it once on the program's stream
(whether it captured, its pieces' node types, the replay against eager),
and the microseconds a trip over 50 trips of one replay.

Run on the card: `python scripts/linalg_capture_probe.py [--batched |
--reduced]`
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
                                               device_while, load_into)

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


def _coefficients(d: int, dev):
    """Seeded [d, 42] coefficients of the SPIKE's reduced system."""
    g = torch.Generator().manual_seed(d)
    return (0.1 * torch.randn((d, 42), generator=g)).to(dev)


def _plain_lu_solve(Mr, rhs):
    """Mr u = rhs by an LU with partial pivoting written as plain tensor
    operations (about 12 launches a column) and one step of refinement."""
    n = Mr.shape[0]
    LU = Mr.clone()
    ar = torch.arange(n, device=Mr.device)
    perm = ar.clone()
    for k in range(n - 1):
        p = torch.argmax(LU[k:, k].abs()) + k
        pair = torch.stack([ar[k], p])
        back = pair.flip(0)
        LU.index_copy_(0, back, LU.index_select(0, pair))
        perm.index_copy_(0, back, perm.index_select(0, pair))
        LU[k + 1:, k].div_(LU[k, k])
        LU[k + 1:, k + 1:].addr_(LU[k + 1:, k], LU[k, k + 1:], alpha=-1)

    def apply(b):
        y = torch.linalg.solve_triangular(LU, b.index_select(0, perm),
                                          upper=False, unitriangular=True)
        return torch.linalg.solve_triangular(LU, y, upper=True)

    u = apply(rhs)
    return u + apply(rhs - Mr @ u)


def _reduced_variants(d):
    """The port's reduced solve and the routes it was chosen from."""
    from hitl_slam_torch.parallel import sharded_solver as S

    def with_lu_solve(coef):
        Mr, rhs = S._reduced_system(coef, d)
        LU, piv, _ = torch.linalg.lu_factor_ex(Mr)
        u = torch.linalg.lu_solve(LU, piv, rhs)
        return u + torch.linalg.lu_solve(LU, piv, rhs - Mr @ u)

    def batched_getrf(coef):
        Mr, rhs = S._reduced_system(coef, d)
        LU, piv, _ = torch.linalg.lu_factor_ex(Mr.expand(2, *Mr.shape))
        P = torch.lu_unpack(LU[0], piv[0], unpack_data=False)[0]

        def apply(b):
            y = torch.linalg.solve_triangular(LU[0], P.mT @ b, upper=False,
                                              unitriangular=True)
            return torch.linalg.solve_triangular(LU[0], y, upper=True)

        u = apply(rhs)
        return u + apply(rhs - Mr @ u)

    return {
        "_reduced_solve (lu_factor_ex, lu_unpack, 2 solve_triangular)":
            lambda c: S._reduced_solve(c, d),
        "lu_factor_ex + 2 lu_solve": with_lu_solve,
        "lu_factor_ex alone": lambda c: torch.linalg.lu_factor_ex(
            S._reduced_system(c, d)[0])[0],
        "batched getrf (2 copies) + lu_unpack + 2 solve_triangular":
            batched_getrf,
        "plain-ops LU": lambda c: _plain_lu_solve(*S._reduced_system(c, d)),
    }


def reduced_in_while(d: int, name: str, call, dev) -> dict:
    """call(coef + k) for k = 0, 1 in a WHILE body; then 20 trips timed."""
    coef = _coefficients(d, dev)
    row = {"d": d, "case": name, "eager_kernels": _kernels(lambda: call(coef))}
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        call(coef)
        row["sync_debug_error"] = None
    except RuntimeError as e:
        row["sync_debug_error"] = str(e).splitlines()[0][:200]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    shape = tuple(call(coef).shape)

    def fn(coef, trips):
        out = torch.zeros(shape, dtype=coef.dtype, device=coef.device)
        k = torch.zeros((), dtype=torch.int32, device=coef.device)
        cond = torch.ones((), dtype=torch.bool, device=coef.device)

        def body():
            out.copy_(call(coef + 1e-3 * k.to(coef.dtype)))
            k.add_(1)
            torch.lt(k, trips, out=cond)

        device_while(cond, body, 64)
        return out, k

    two = torch.full((), 2, dtype=torch.int32, device=dev)
    want, _ = fn(coef, two)
    prog = DeviceProgram(fn, (coef, two), dev,
                         warm=lambda: call(coef.clone()))
    try:
        got, k = prog.run(coef, two)
    except RuntimeError as e:
        torch.cuda.synchronize(dev)
        row.update(captured=False, error=str(e).splitlines()[0][:300])
        return row
    gr = prog.graph()
    row.update(captured=True, trips=int(k),
               replay_bit_equal=bool(torch.equal(got, want)),
               max_abs_diff=float((got - want).abs().max()),
               capture_ms=gr.capture_ms, pool_mib=gr.pool_mib,
               body_nodes=gr.body_nodes,
               piece_node_types=[
                   gr.node_types(ctypes.c_void_p(p.raw_cuda_graph()))
                   for p in gr._pieces])
    many = torch.full((), 50, dtype=torch.int32, device=dev)
    prog.run(coef, many)
    torch.cuda.synchronize(dev)
    t0, t1 = torch.cuda.Event(True), torch.cuda.Event(True)
    with prog.turn():
        load_into(prog.inputs, (coef, many))
        t0.record()
        prog.replay()
        t1.record()
    torch.cuda.synchronize(dev)
    row["us_per_trip"] = t0.elapsed_time(t1) * 1e3 / 50
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
    if "--reduced" in sys.argv[1:]:
        for d in (4, 8):
            for name, call in _reduced_variants(d).items():
                res = reduced_in_while(d, name, call, dev)
                print(f"[linalg] reduced solve d = {d}, {name}: {res}",
                      flush=True)
                rows[f"d{d} {name}"] = res
        print(json.dumps({"linalg_capture_reduced": rows}))
        return 0
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
