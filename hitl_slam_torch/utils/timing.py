"""Named wall-clock lap timer for the engine's per-cycle reports (port of
the FunctionTimer in hitl_slam_tpu/utils/timing.py)."""

from __future__ import annotations

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

    def laps_ms(self) -> dict:
        return {k: v * 1e3 for k, v in self.laps}
