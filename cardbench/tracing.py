"""Readings from torch.profiler's trace, for the trace runs.

The profiler's Chrome trace is written to the run's temporary directory and
read back: device operations are its `kernel`, `gpu_memcpy` and
`gpu_memset` events, a graph launch's counted whole (graph_spans), host
spans the `user_annotation` events that the drivers open with
`torch.profiler.record_function`.
"""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "cardbench.window"


@contextmanager
def profiled(device: str, out: dict):
    """Profile the block; afterwards `out["events"]` holds the trace's
    events (a list of dicts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if device.startswith("cuda"):
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def device_events(events: list) -> list:
    return [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]


def spans(events: list, name: str) -> list:
    """(start, end) in µs of the host spans called `name`."""
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == name
            and "dur" in e]


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


GRAPH_LAUNCH = "cudaGraphLaunch"
GRAPH_OP = "graph replay"


def graph_spans(events: list) -> tuple[list, set]:
    """(start, end) in µs of each graph launch's device work, from its
    first kernel's start to its last one's end, and the correlation ids of
    the launches. The profiler sees a WHILE node's kernels on its first
    trip only, but a graph's first and last kernels bound every trip."""
    ids = {e["args"]["correlation"] for e in events
           if e.get("cat") in ("cuda_runtime", "cuda_driver")
           and e.get("name") == GRAPH_LAUNCH
           and "correlation" in e.get("args", {})}
    by: dict = {}
    for e in device_events(events):
        c = e.get("args", {}).get("correlation")
        if c in ids:
            a, b = by.get(c, (e["ts"], e["ts"] + e["dur"]))
            by[c] = (min(a, e["ts"]), max(b, e["ts"] + e["dur"]))
    return sorted(by.values()), ids


def window_readings(events: list, labels: tuple) -> dict | None:
    """busy_s (the union, inside the traced window, of the device
    operations' intervals, a graph launch's being its span), window_s,
    graphs (the launches seen), and the breakdown: the 10 device operations
    that took most time (a graph launch counted whole, as GRAPH_OP), and
    the 10 longest idle gaps named by the host span (one of `labels`) in
    which each began. None where the trace holds no window or no device
    operation."""
    win = spans(events, WINDOW)
    gspans, ids = graph_spans(events)
    dev = [e for e in device_events(events)
           if e.get("args", {}).get("correlation") not in ids]
    if not win or not (dev or gspans):
        return None
    w0, w1 = win[0]
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in dev] + gspans
    busy = _union([(max(a, w0), min(b, w1)) for a, b in ops
                   if a < w1 and b > w0])
    busy_us = sum(b - a for a, b in busy)
    if busy_us <= 0:
        return None
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    if gspans:
        by_name[GRAPH_OP] = sum(b - a for a, b in gspans) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted((s, t, lab) for lab in labels for s, t in spans(events, lab))
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            lab = next((l for s, t, l in host if s <= a < t), "other")
            gaps.append((lab, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "graphs": len(gspans),
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in gaps[:10]]}}


def kernel_seconds(events: list, needle: str) -> tuple[float, int]:
    """Total device seconds and launches of the kernels whose name holds
    `needle`."""
    ks = [e for e in device_events(events)
          if e.get("cat") == "kernel" and needle in e.get("name", "")]
    return sum(e["dur"] for e in ks) * 1e-6, len(ks)
