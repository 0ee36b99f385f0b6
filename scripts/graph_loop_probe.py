"""Probe the card's CUDA-graph device loops (utils/device_loop.py) before
the cycle uses them.

Prints the versions (torch, its CUDA, the card's name, power limit and
driver) and whether the installed PyTorch has conditional nodes of its own
(`CUDAGraph.begin_capture_to_if_node`), then, through `LoopGraph`:

  1. a loop of at most 100 trips whose body clears its flag after `stop`
     trips (an elementwise update, a fresh tensor, a cuBLAS product, a
     device-to-device copy, a launch-counter bump): the trips at replay
     must equal min(stop, 100) and the carry must equal eager; the replay
     times against `stop` give the cost of a trip and of a loop that exits
     at once;
  2. two loops with straight-line work between them, around em_scan and
     BCR launches, against the same code run eagerly (bit-equal), with the
     kernels' replay launch counts;
  3. what a capture refuses: a Python-scalar store into a CUDA tensor and
     a tensor copied from the host;
  4. a loop inside a loop: an outer loop of 5 trips, each with
     straight-line work before and after an inner loop whose trips the
     device decides (0 to 69 asked, at most 64 run), for three seeds: the
     inner trip counts and the carry at replay must equal eager;
  5. a loop of at most one trip used as an IF (the reference's lax.cond),
     taken and not taken, with work after it.

Run on the card: `python scripts/graph_loop_probe.py` (~30 s with the
kernels' build). Exits 1 without CUDA or on any mismatch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hitl_slam_torch.ops import em_scan as E  # noqa: E402
from hitl_slam_torch.solver import bcr_kernel as B  # noqa: E402
from hitl_slam_torch.utils import cuda_build  # noqa: E402
from hitl_slam_torch.utils.device_loop import LoopGraph, device_while  # noqa: E402


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _best_ms(fn, reset, reps=30) -> float:
    best = float("inf")
    for _ in range(reps):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def toy_loop(dev) -> bool:
    counter = cuda_build.LaunchCounter("probe")
    counter.prepare(dev)
    acc = torch.zeros(1024, device=dev)
    w = torch.randn(64, 64, device=dev)
    m = torch.randn(64, 64, device=dev)
    cnt = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.int32, device=dev)
    cond = torch.ones((), dtype=torch.bool, device=dev)

    def body():
        tmp = torch.zeros(1024, device=dev)
        tmp += acc * 0.5 + 1.0
        acc.copy_(tmp)
        m.copy_(torch.tanh(m @ w))
        cnt.add_(1)
        cond.copy_(cnt < stop)
        counter.bump(dev)

    def run():
        device_while(cond, body, 100)
        return acc.sum()

    def reset(s):
        acc.zero_(); cnt.zero_(); stop.fill_(s); cond.fill_(s > 0)
        torch.manual_seed(0)
        m.copy_(torch.randn(64, 64, device=dev))

    reset(1)
    run()      # warm-up, eager
    g = LoopGraph(run, dev)
    ok = True
    rows = {}
    for s in (0, 1, 10, 100, 200):
        reset(s)
        counter.count = 0
        g.replay()
        torch.cuda.synchronize()
        got, launched = int(cnt), counter.count
        acc_g, m_g = acc.clone(), m.clone()
        reset(s)
        eager_trips = device_while(cond, body, 100)
        same = bool(torch.equal(acc_g, acc)) and bool(torch.equal(m_g, m))
        ms = _best_ms(g.replay, lambda: reset(s))
        rows[s] = dict(trips=got, eager_trips=eager_trips, counted=launched,
                       bit_equal=same, replay_ms=ms)
        ok &= got == min(s, 100) == eager_trips == launched and same
    print(f"[toy] capture {g.capture_ms:.1f} ms, {g.nodes} nodes; "
          + "; ".join(f"stop {s}: {r}" for s, r in rows.items()), flush=True)
    return ok


def kernels_in_loops(dev) -> bool:
    torch.manual_seed(1)
    P, N, n = 1024, 256, 1024
    world = (torch.rand(P, N, 2, device=dev) * 20).contiguous()
    mask = torch.rand(P, N, device=dev) > 0.2
    sel0 = world[10, :4].clone()
    A = torch.randn(n, 3, 3, device=dev) * 0.1
    D0 = (A @ A.transpose(-1, -2) + 4 * torch.eye(3, device=dev)).contiguous()
    U0 = (torch.randn(n - 1, 3, 3, device=dev) * 0.2).contiguous()
    b0 = torch.randn(n, 3, device=dev)
    sel = sel0.clone()
    x = torch.zeros(n, 3, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    cond = torch.ones((), dtype=torch.bool, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)

    def run():
        sel.copy_(sel0)
        x.zero_(); k.zero_(); cond.fill_(True)

        def em_body():
            counts, mins = E.em_scan_cuda(world, mask, sel)
            sel.add_(torch.sqrt(mins)[:, None] * 0.01)
            k.add_(1)
            cond.copy_((k < 3) & (counts.sum() > 0))

        device_while(cond, em_body, 8)
        total.copy_(k.to(torch.int64))
        k.zero_(); cond.fill_(True)

        def lm_body():
            step = B.bcr_solve_cuda(D0, U0, (b0 - 0.1 * x).contiguous())
            x.copy_(x + 0.5 * step)
            k.add_(1)
            cond.copy_(k < 5)

        device_while(cond, lm_body, 100)
        return x.sum() + sel.sum() + total

    for c in (E.launches, B.launches):
        c.prepare(dev)
    eager = run().clone()
    x_e, sel_e = x.clone(), sel.clone()
    ticket = E.new_ticket(dev)
    with E.capture_ticket(ticket):
        g = LoopGraph(run, dev)
    E.launches.count = 0
    B.launches.count = 0
    g.replay()
    torch.cuda.synchronize()
    em_n, bcr_n = E.launches.count, B.launches.count
    same = (bool(torch.equal(g.outputs, eager)) and bool(torch.equal(x, x_e))
            and bool(torch.equal(sel, sel_e)))
    print(f"[kernels] capture {g.capture_ms:.1f} ms, {g.nodes} nodes; "
          f"bit-equal to eager {same}; replay launches em_scan {em_n} "
          f"(expected 3), bcr {bcr_n} (expected 5)", flush=True)
    return same and em_n == 3 and bcr_n == 5


def refusals(dev) -> dict:
    out = {}
    x = torch.zeros(4, device=dev)
    for name, fn in (("setitem_scalar", lambda: x.__setitem__(0, 5.0)),
                     ("tensor_from_host",
                      lambda: torch.tensor([1.0, 2.0], device=dev)),
                     ("where_scalar",
                      lambda: torch.where(x > 0, 1.0, x)),
                     ("fill_slice", lambda: x[3:].fill_(3.0))):
        try:
            LoopGraph(lambda: fn(), dev)
            out[name] = "captured"
        except Exception as e:
            out[name] = f"refused: {type(e).__name__}: {str(e)[:100]}"
        torch.cuda.synchronize()
        print(f"[capture] {name}: {out[name]}", flush=True)
    return out


def nested_loops(dev) -> bool:
    outer_k = torch.zeros((), dtype=torch.int32, device=dev)
    inner_k = torch.zeros((), dtype=torch.int32, device=dev)
    seed = torch.zeros((), dtype=torch.int32, device=dev)
    trips = torch.zeros(5, dtype=torch.int32, device=dev)
    acc = torch.zeros(256, device=dev)
    w = torch.randn(32, 32, device=dev) * 0.3
    m0 = torch.randn(32, 32, device=dev)
    m = m0.clone()
    cond_o = torch.ones((), dtype=torch.bool, device=dev)
    cond_i = torch.ones((), dtype=torch.bool, device=dev)

    def run():
        outer_k.zero_()
        trips.zero_()
        m.copy_(m0)
        acc.zero_()
        cond_o.fill_(True)

        def outer():
            # before the inner loop: its trip count, made on the device
            stop = (outer_k * 29 + seed) % 70
            acc.mul_(0.5)
            inner_k.zero_()
            torch.lt(inner_k, stop, out=cond_i)

            def inner():
                m.copy_(torch.tanh(m @ w))
                acc.add_(m[0, :1].repeat(256))
                inner_k.add_(1)
                torch.lt(inner_k, stop, out=cond_i)

            device_while(cond_i, inner, 64)
            # after it
            trips.index_copy_(0, outer_k.long()[None], inner_k[None])
            acc.add_(inner_k.to(acc.dtype))
            outer_k.add_(1)
            torch.lt(outer_k, 5, out=cond_o)

        device_while(cond_o, outer, 100)
        return acc.sum()

    g = LoopGraph(run, dev)
    ok = True
    rows = {}
    for sd in (0, 7, 40):
        seed.fill_(sd)
        g.replay()
        torch.cuda.synchronize()
        got = (trips.clone(), acc.clone(), m.clone(), int(outer_k))
        run()
        torch.cuda.synchronize()
        want = (trips.clone(), acc.clone(), m.clone(), int(outer_k))
        expect = [min((k * 29 + sd) % 70, 64) for k in range(5)]
        same = (all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
                and got[3] == want[3] == 5)
        rows[sd] = dict(inner_trips=got[0].tolist(), expected=expect,
                        bit_equal=same)
        ok &= same and got[0].tolist() == expect
    print(f"[nested] capture {g.capture_ms:.1f} ms, {g.nodes} nodes, loop "
          f"levels {g.levels}, body nodes {g.body_nodes}, nodes by level "
          f"{g.level_nodes}; " + "; ".join(f"seed {k}: {r}"
                                          for k, r in rows.items()),
          flush=True)
    return ok


def if_loop(dev) -> bool:
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    x = torch.zeros(16, device=dev)
    y = torch.zeros(16, device=dev)

    def run():
        def body():
            x.add_(torch.arange(16, device=dev, dtype=x.dtype))

        device_while(flag, body, 1)
        y.copy_(x * 2.0 + 1.0)
        return y.sum()

    g = LoopGraph(run, dev)
    ok = True
    rows = {}
    for taken in (True, False, True):
        x.fill_(1.0)
        flag.fill_(taken)
        g.replay()
        torch.cuda.synchronize()
        want = 1.0 + torch.arange(16, device=dev, dtype=x.dtype) * taken
        good = bool(torch.equal(x, want)) and bool(torch.equal(y, want * 2.0
                                                                + 1.0))
        rows[f"taken={taken}"] = good
        ok &= good
    print(f"[if] {g.nodes} nodes, loop levels {g.levels}; {rows}",
          flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "smi": _smi(),
            "torch_if_nodes": hasattr(torch.cuda.CUDAGraph,
                                      "begin_capture_to_if_node")}
    print(json.dumps(info), flush=True)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cuda_build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s, cached "
          f"{cuda_build.build_info.cached}", flush=True)
    ok = toy_loop(dev)
    ok &= kernels_in_loops(dev)
    refusals(dev)
    ok &= nested_loops(dev)
    ok &= if_loop(dev)
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
