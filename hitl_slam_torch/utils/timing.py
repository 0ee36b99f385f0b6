"""Scoped host timing utilities (port of hitl_slam_tpu/utils/timing.py):
wall-clock laps, a process-wide accumulator registry, a torch.profiler trace
around device work, and the native-crash guard of the entry points."""

from __future__ import annotations

import collections
import contextlib
import time


class FunctionTimer:
    """ft = FunctionTimer('x'); ...; ft.lap('stage')."""

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.laps: list[tuple[str, float]] = []

    def lap(self, label: str) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        self.laps.append((label, dt))
        return dt

    def total(self) -> float:
        return time.perf_counter() - self.t0

    def laps_ms(self) -> dict:
        return {k: v * 1e3 for k, v in self.laps}


class TimerCollection:
    """Process-wide (label -> accumulated seconds, count) registry, like the
    reference's AlgorithmTimer/TimerCollection."""

    def __init__(self):
        self.acc = collections.defaultdict(float)
        self.count = collections.defaultdict(int)

    @contextlib.contextmanager
    def time(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[label] += time.perf_counter() - t0
            self.count[label] += 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.acc):
            n = self.count[k]
            lines.append(
                f"{k}: total {self.acc[k]*1e3:.2f} ms over {n} "
                f"({self.acc[k]/max(n,1)*1e3:.3f} ms avg)"
            )
        return "\n".join(lines)


GLOBAL_TIMERS = TimerCollection()


@contextlib.contextmanager
def device_trace(label: str, enabled: bool = False,
                 logdir: str = "/tmp/torch-trace"):
    """Optionally wrap a block in a torch.profiler trace (host ops, and the
    card's kernels when CUDA is available), written to `logdir` as a Chrome
    trace (`<label>.pt.trace.json`, open with chrome://tracing or Perfetto)."""
    if not enabled:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(label):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"{label}.pt.trace.json"))


def install_crash_guard():
    """Native-crash backtrace guard for the entry points: both CUDA kernels
    are reached through ctypes (utils/cuda_build.py), and a crash inside a
    ctypes call would otherwise die without a Python traceback."""
    import faulthandler

    try:
        faulthandler.enable()
    except Exception:
        pass    # no real stderr fd (e.g. captured streams): skip the guard
