"""The benchmark's general machinery: it finds a cell's files by the names in
BENCHMARK.json, runs the cell's mix, reads its metrics and decides
`correct`. Nothing here names a configuration, a mix or a metric.

Files, each found by name:

  configs/<config>.json      a deployment (BENCHMARK.json's `file`)
  workloads/<cell>.json      a cell: its traffic, the limits of its check
  traffic/<traffic>.json     a traffic mix: the driver that runs it, and
                             every parameter of the mix
  mixes/<driver>.py          a driver: `run(ctx) -> RunRecord`
  metrics/<metric>.py        a metric's reader: LAYER, UNIT, MOVES,
                             SOURCE and `read(run) -> float | None`
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "hitl_slam_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The module at `path`, imported under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell of BENCHMARK.json with every file it names, loaded."""

    name: str
    chips: int
    config: dict
    workload: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    base: str = HERE

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def find_cell(name: str, bench: dict | None = None, base: str = HERE,
              root: str = ROOT) -> Cell:
    """The cell `name` of `bench` (default: the checkout's BENCHMARK.json)
    with its configuration, workload and traffic files from `base`."""
    if bench is None:
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(os.path.join(root, configs[w["config"]]["file"]))
    work = load_json(os.path.join(base, "workloads", f"{name}.json"))
    traffic = load_json(os.path.join(base, "traffic", f"{w['traffic']}.json"))
    return Cell(name, int(w["chips"]), cfg, work, traffic,
                _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name), base)


@dataclass
class Check:
    """One number compared with its limit: the run is correct where every
    value is at most its limit (a missing value is not correct)."""

    name: str
    value: float | None
    limit: float

    @property
    def ok(self) -> bool:
        return self.value is not None and math.isfinite(self.value) \
            and self.value <= self.limit


@dataclass
class RunRecord:
    """What a driver hands back: set-up and window seconds, the window's
    samples, the trace's readings (trace runs only), the checks, the
    device's memory peak and notes for standard error."""

    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    samples: dict = field(default_factory=dict)
    trace: dict = field(default_factory=dict)
    checks: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    notes: dict = field(default_factory=dict)


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments and the device."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                      # the process's start, on perf_counter
    control: str | None = None     # calibration only: a control to read
    fault: str | None = None       # tests only: a fault planted in the path

    def sync(self):
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()


def read_metrics(cell: Cell, run: RunRecord, trace: bool) -> dict:
    """{name: {value, unit}} of the cell's end-to-end metrics (trace off)
    or per-layer metrics (trace on), each from its reader; a reader that
    finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        reader = load_module(os.path.join(cell.base, "metrics",
                                          f"{m['name']}.py"),
                             "cardbench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_info(device: str, chips: int, run: RunRecord, trace: bool) -> dict:
    import torch

    if device.startswith("cuda"):
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(run.memory_peak_bytes)}
    if trace and "busy_s" in run.trace:
        info["busy_s"] = run.trace["busy_s"]
        info["window_s"] = run.trace["window_s"]
    return info


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole."""
    return sorted({k.split(".")[0] for k in list(sys.modules)
                   if k.split(".")[0] in FORBIDDEN})


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t0: float | None = None, control: str | None = None,
             fault: str | None = None) -> tuple[dict, list[str]]:
    """Run `cell` once: its driver's set-up, window, trace (`trace`) and
    check. Returns the result's line (as a dict, `checks` last) and the
    lines for standard error: the driver's notes, then the checks."""
    ctx = Context(cell, int(seed), float(seconds), bool(trace), device,
                  time.perf_counter() if t0 is None else t0, control, fault)
    driver = load_module(os.path.join(cell.base, "mixes", f"{cell.driver}.py"),
                         "cardbench_mix_" + cell.driver)
    run = driver.run(ctx)
    checks = run.checks
    correct = bool(checks) and all(c.ok for c in checks)
    line = {
        "correct": correct,
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": read_metrics(cell, run, trace),
        "device": device_info(device, cell.chips, run, trace),
    }
    if trace and run.trace.get("breakdown"):
        line["breakdown"] = run.trace["breakdown"]
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    err = [f"note {k} {v!r}" for k, v in run.notes.items()]
    err += [f"check {c.name} {c.value!r} limit {c.limit!r}"
           f"{'' if c.ok else ' FAILED'}" for c in checks]
    return line, err
