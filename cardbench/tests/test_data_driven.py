"""A new configuration, traffic, mix, metric and cell take new files only:
dropped into a copy of the benchmark, they are found by name, the CPU cut
of the configuration too (tiny/<config>.json), and no file that was there
changes."""

import hashlib
import json
import os
import shutil

import pytest

from cardbench import harness
from cardbench.tests.tiny import tiny_cell

MIX = '''
import time
from cardbench.harness import Check, RunRecord

def run(ctx):
    t = time.perf_counter()
    n = int(ctx.cell.traffic["items"]) * int(ctx.cell.config["scale"])
    total = sum(range(n))
    run = RunRecord(setup_s=time.perf_counter() - ctx.t0, window_s=0.01,
                    attempted=n)
    run.samples = {"item_ms": [1.0] * n, "total": [total]}
    run.checks = [Check("sum_gap", abs(total - n * (n - 1) // 2),
                        ctx.cell.workload["limits"]["sum_gap"])]
    return run
'''
METRIC = '''
LAYER = "toy layer"
UNIT = "count"
MOVES = "toy_items_s"
SOURCE = "program_counter"

def read(run):
    return run.samples["total"][0]
'''
E2E = '''
UNIT = "items/s"
BETTER = "higher"
SOURCE = "host_clock"

def read(run):
    return run.attempted / run.window_s
'''


def _digest(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def _toy(tmp_path, cut=True):
    """A copy of the benchmark with the toy configuration, mix, metrics and
    cell dropped in (and the toy configuration's CPU cut, where `cut`), the
    manifest that names them, and the digest of the copy before."""
    base = tmp_path / "cardbench"
    shutil.copytree(harness.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    before = _digest(base)
    (base / "mixes" / "toy.py").write_text(MIX)
    (base / "metrics" / "toy_total.py").write_text(METRIC)
    (base / "metrics" / "toy_items_s.py").write_text(E2E)
    (base / "traffic" / "toy-mix.json").write_text(
        json.dumps({"driver": "toy", "items": 50}))
    (base / "configs" / "toy-config.json").write_text(
        json.dumps({"scale": 2, "shape": {"rows": 4, "cols": 8},
                    "assumed": [], "reduced": []}))
    if cut:
        (base / "tiny" / "toy-config.json").write_text(
            json.dumps({"scale": 1, "shape": {"rows": 2}}))
    (base / "workloads" / "toy-config.toy-mix.json").write_text(
        json.dumps({"config": "toy-config", "traffic": "toy-mix",
                    "limits": {"sum_gap": 0}}))
    bench["configs"].append({"name": "toy-config", "source": "x",
                             "file": "cardbench/configs/toy-config.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "toy-config.toy-mix",
                               "config": "toy-config", "traffic": "toy-mix",
                               "chips": 1, "why": "toy"})
    bench["end_to_end"].append({"name": "toy_items_s", "unit": "items/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy-config.toy-mix"]})
    bench["per_layer"].append({"name": "toy_total", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "toy layer", "moves": "toy_items_s",
                               "workloads": ["toy-config.toy-mix"]})
    return base, bench, before


def test_new_cell_needs_only_new_files(tmp_path):
    base, bench, before = _toy(tmp_path)
    cell = harness.find_cell("toy-config.toy-mix", bench, str(base),
                             str(tmp_path))
    line, _ = harness.run_cell(cell, 1, 0.1, False, "cpu")
    assert line["correct"] is True
    assert set(line["metrics"]) == {"toy_items_s", "setup_s"}
    line, _ = harness.run_cell(cell, 1, 0.1, True, "cpu")
    assert line["metrics"]["toy_total"]["value"] == sum(range(100))
    # the CPU cut is the configuration's overlay, found by its name
    cell = tiny_cell("toy-config.toy-mix", bench, str(base), str(tmp_path))
    assert cell.config["scale"] == 1
    assert cell.config["shape"] == {"rows": 2, "cols": 8}
    line, _ = harness.run_cell(cell, 1, 0.1, True, "cpu")
    assert line["correct"] is True
    assert line["metrics"]["toy_total"]["value"] == sum(range(50))
    after = _digest(base)
    assert {k: after[k] for k in before} == before


def test_a_configuration_without_a_cut_is_refused(tmp_path):
    """No overlay, no CPU run: the error names the file that is missing."""
    base, bench, _ = _toy(tmp_path, cut=False)
    with pytest.raises(FileNotFoundError, match="tiny/toy-config.json"):
        tiny_cell("toy-config.toy-mix", bench, str(base), str(tmp_path))
