"""BENCHMARK.json against the contract's shape: names, units, files, and
every per-layer metric's `moves` reported in each of its cells."""

import os
import re

import pytest

from cardbench import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert 1 <= BENCH["run_seconds"] <= 51
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_metrics_shape():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_reported_in_each_cell(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in _cells_of(metric):
        assert cell in _cells_of(e2e[metric["moves"]])


def test_each_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if w["name"] in _cells_of(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in _cells_of(m) for m in BENCH["per_layer"])


def test_files_exist_and_readers_agree():
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        assert c["file"].startswith("cardbench/")
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
    for w in BENCH["workloads"]:
        assert w["config"] in cfgs
        cell = harness.find_cell(w["name"], BENCH)
        assert os.path.isfile(os.path.join(harness.HERE, "mixes",
                                           f"{cell.driver}.py"))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        path = os.path.join(harness.HERE, "metrics", f"{m['name']}.py")
        mod = harness.load_module(path, "t_" + m["name"].replace(".", "_"))
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
        if m in BENCH["per_layer"]:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]


def test_command_and_paths():
    assert BENCH["command"][0].startswith("python")
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word.split("/")
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.endswith("_torch")
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
