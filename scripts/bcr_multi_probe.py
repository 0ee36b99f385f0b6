#!/usr/bin/env python3
"""Where the time of the BCR kernels goes, on one GPU.

    python scripts/bcr_multi_probe.py [--phases] [--plans]

--phases builds a copy of hitl_slam_torch/csrc/bcr.cu into
hitl_slam_torch/build/probe/ with a %globaltimer stamp in block (0, 0) after
each phase of the lone kernel and of the multi-right-hand-side kernel
(filling shared memory, each downward level, the root, each upward level,
writing x), launches both five times at the SPIKE's shapes (S systems of n
poses, 7 right-hand sides for the multi kernel, the first system's first
column for the lone one) and prints the microseconds of each phase of the
last launch.

--plans times the multi route (torch.profiler device ms a launch, 200
launches) under other launch plans than solver/bcr_kernel.py::launch_plan
gives (lanes a block, threads a block), through the package's own library,
and checks each against the plan's result bit for bit.

Without a flag, both. Prints the card's name and power limit first. Needs
one CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402

RHS = 7
PHASE_SHAPES = ((8, 128), (4, 256), (8, 1024))
# (S, n, [(lanes a block, threads a block), ...]); the first is the plan's
PLAN_SHAPES = ((8, 128, [(128, 256), (128, 64), (128, 512), (64, 256)]),
               (4, 256, [(256, 256), (256, 128), (256, 512), (128, 256)]),
               (8, 2048, [(256, 256), (1024, 512), (512, 512), (128, 256)]),
               (8, 1024, [(1024, 512), (512, 512), (256, 256)]))

STAMP = ('__device__ long long g_probe[2][64];\n'
         '__device__ __forceinline__ void stamp(int which, int i) {\n'
         '  long long t;\n'
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
         '  g_probe[which][i] = t;\n'
         '}\n'
         '#define STAMP(w, i) do { if (threadIdx.x == 0 && blockIdx.x == 0 '
         '&& blockIdx.y == 0) stamp(w, i); } while (0)\n')


def _after(text: str, stamp: str) -> tuple[str, str]:
    """(text, text with `stamp` on a line after it)."""
    return text, text + "  " + stamp + "\n"


# per kernel: its first line, then (text, replacement) pairs
LONE = ("bcr_kernel(const float* __restrict__ Din", [
    _after("  extern __shared__ float sm[];\n", "STAMP(0, 0);"),
    ("  sync_cluster<kCluster>();\n\n  int levels = 0;",
     "  sync_cluster<kCluster>();\n  STAMP(0, 1);\n\n  int levels = 0;"),
    _after("      absorb_even(ln, even.first + j * s, h);\n"
           "    // the next level's odd step reads only its own block's lanes\n"
           "    __syncthreads();\n", "STAMP(0, 1 + k);"),
    _after("    st<3>(ln, sm, kB, 0, x);\n  }\n  sync_cluster<kCluster>();\n",
           "STAMP(0, 40);"),
    _after("      back_substitute(ln, odd.first + j * (1 << k), h, m);\n"
           "    sync_cluster<kCluster>();\n", "STAMP(0, 40 + k);"),
    _after("    if (g < n) xout[g * 3 + c] = v;\n  }\n",
           "__syncthreads();\n  STAMP(0, 63);")])
MULTI = ("bcr_multi_kernel(const float* __restrict__ Din", [
    _after("  extern __shared__ float sm[];\n", "STAMP(1, 0);"),
    ("  sync_cluster<kCluster>();\n\n  int levels = 0;",
     "  sync_cluster<kCluster>();\n  STAMP(1, 1);\n\n  int levels = 0;"),
    _after("    // the next level's odd step reads only its own block's lanes\n"
           "    __syncthreads();\n", "STAMP(1, 1 + k);"),
    _after("    for (int c = tid; c < rhs; c += nt) multi_root(ln, c);\n"
           "  sync_cluster<kCluster>();\n", "STAMP(1, 40);"),
    ("    }\n    sync_cluster<kCluster>();\n  }\n\n  if (top == 0) {",
     "    }\n    sync_cluster<kCluster>();\n    STAMP(1, 40 + k);\n  }\n\n"
     "  if (top == 0) {"),
    _after("    multi_drain(ln, sm, xout, base, lanes, n, tid, nt);\n",
           "__syncthreads();\n    STAMP(1, 63);")])


def _stamped_source() -> str:
    """csrc/bcr.cu with the stamps, and probe_read() to fetch them."""
    with open(os.path.join(ROOT, "hitl_slam_torch", "csrc", "bcr.cu")) as f:
        s = f.read()
    s = s.replace("namespace {\n", "namespace {\n" + STAMP, 1)
    for start, pairs in (LONE, MULTI):
        at = s.index(start)
        body = s[at:]
        for old, new in pairs:
            if old not in body:
                raise SystemExit(f"bcr_multi_probe: {old!r} not found in "
                                 f"csrc/bcr.cu; update the probe's anchors")
            body = body.replace(old, new, 1)
        s = s[:at] + body
    return s + ('\nextern "C" int probe_read(long long* out) {\n'
                '  return static_cast<int>(cudaMemcpyFromSymbol(\n'
                '      out, g_probe, sizeof(long long) * 128));\n}\n')


def phases(torch) -> None:
    import numpy as np

    from hitl_slam_torch.solver import bcr_kernel as B
    from hitl_slam_torch.utils import cuda_build

    out_dir = os.path.join(cuda_build.BUILD, "probe")
    os.makedirs(out_dir, exist_ok=True)
    src, so = (os.path.join(out_dir, f) for f in ("bcr_probe.cu",
                                                  "libprobe.so"))
    with open(src, "w") as f:
        f.write(_stamped_source())
    built = subprocess.run([cuda_build.nvcc_path(), *cuda_build.ARCH,
                            *cuda_build.COMMON, "-shared", "-o", so, src],
                           capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(built.stdout + built.stderr)
    lib = ctypes.CDLL(so)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hitl_bcr_solve_multi.argtypes = [vp] * 5 + [ll] * 3 + [i] * 8 + [vp]
    lib.hitl_bcr_solve.argtypes = [vp] * 5 + [i] * 6 + [vp]
    lib.probe_read.argtypes = [vp]
    stream = torch.cuda.current_stream().cuda_stream
    buf = np.zeros(128, np.int64)
    for S, n in PHASE_SHAPES:
        D, U, b = _systems(torch, S, n)
        U = U.contiguous()
        x = torch.empty_like(b)
        b0 = b[0, :, :, 0].contiguous()
        x0 = torch.empty_like(b0)
        pm, pl = B.launch_plan(n, RHS), B.launch_plan(n)
        for _ in range(5):
            code = lib.hitl_bcr_solve_multi(
                D.data_ptr(), U.data_ptr(), b.data_ptr(), x.data_ptr(), None,
                D.stride(0), U.stride(0), b.stride(0), S, n, RHS, pm.m,
                pm.lanes_per_block.bit_length() - 1, pm.top, pm.threads,
                pm.smem_bytes, stream)
            code = code or lib.hitl_bcr_solve(
                D[0].data_ptr(), U[0].data_ptr(), b0.data_ptr(),
                x0.data_ptr(), None, n, pl.m,
                pl.lanes_per_block.bit_length() - 1, pl.top, pl.threads,
                pl.smem_bytes, stream)
            if code:
                raise SystemExit(f"launch failed: CUDA error {code}")
            torch.cuda.synchronize()
        lib.probe_read(buf.ctypes.data)
        levels = pm.m.bit_length() - 1
        order = ([("fill", 1)]
                 + [(f"down{k}", 1 + k) for k in range(1, levels + 1)]
                 + [("root", 40)]
                 + [(f"up{k}", 40 + k) for k in range(levels, 0, -1)]
                 + [("write", 63)])
        for which, name in ((0, "lone"), (1, "multi")):
            t = buf[64 * which:64 * which + 64]
            prev, parts = t[0], []
            for label, idx in order:
                parts.append(f"{label} {(t[idx] - prev) / 1e3:.2f}")
                prev = t[idx]
            print(f"[phases] S={S} n={n} {name}: {(t[63] - t[0]) / 1e3:.2f} "
                  f"us in block (0, 0): " + ", ".join(parts), flush=True)


def plans(torch) -> None:
    from hitl_slam_torch.solver import bcr_kernel as B
    from hitl_slam_torch.utils import cuda_build

    lib = cuda_build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for S, n, variants in PLAN_SHAPES:
        D, U, b = _systems(torch, S, n)
        want = B.bcr_solve_cuda_multi(D, U, b)
        plan = B.launch_plan(n, RHS)
        parts = []
        for lanes, threads in variants:
            x = torch.empty_like(want)

            def run():
                code = lib.hitl_bcr_solve_multi(
                    D.data_ptr(), U.data_ptr(), b.data_ptr(), x.data_ptr(),
                    None, D.stride(0), U.stride(0), b.stride(0), S, n, RHS,
                    plan.m, lanes.bit_length() - 1, 0, threads,
                    plan.smem_bytes, stream)
                cuda_build.check(code, "bcr_solve_multi")

            run()
            torch.cuda.synchronize()
            same = "" if torch.equal(x, want) else " (x DIFFERS)"
            ms = C.device_ms(run, "bcr_multi", iters=200)[0]
            parts.append(f"{plan.m // lanes} x {lanes} lanes, {threads} "
                         f"threads {ms:.5f}{same}")
        print(f"[plans] S={S} n={n} R={RHS} (plan: {plan.blocks} x "
              f"{plan.lanes_per_block} lanes, {plan.threads} threads), "
              f"device ms a launch: " + "; ".join(parts), flush=True)


def _systems(torch, S, n):
    """S of chip_smoke's SPD systems of n poses, U as the view [:, :-1] of
    [S, n, 3, 3] (the SPIKE's layout), b [S, n, 3, 7] from a seed."""
    import numpy as np

    sys_ = [C._spd_system(n + 1, seed=s) for s in range(S)]
    D = torch.as_tensor(np.stack([q[0][:n] for q in sys_]),
                        dtype=torch.float32, device="cuda")
    U = torch.as_tensor(np.stack([q[1] for q in sys_]), dtype=torch.float32,
                        device="cuda")[:, :-1]
    b = torch.as_tensor(np.random.default_rng(n).normal(size=(S, n, 3, RHS)),
                        dtype=torch.float32, device="cuda")
    return D, U, b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bcr_multi_probe: no CUDA device available", file=sys.stderr)
        return 2
    print(C.nvidia_smi_line(), flush=True)
    if args.phases or not args.plans:
        phases(torch)
    if args.plans or not args.phases:
        plans(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
