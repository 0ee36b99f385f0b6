"""The readers of the cycle program's pre-solve stage marks (backprop_ms,
build_problem_ms) on a synthetic snapshot: each reads its edge over the
window's replays, the edges split `pre_solve_ms` without changing it, and
each falls silent on a program that sets no such marks (as before the
marks were added) or has no recorder."""

import os

import pytest

from cardbench import harness
from cardbench.tests.test_stage_readers import _clock

# reader: the edge it reads
EDGES = {"backprop_ms": "backprop->build_problem",
         "build_problem_ms": "build_problem->lm"}
# a replay's pre-solve stages after the count scan: (mark, µs since the
# last mark)
PRE_SOLVE = (("backprop", 2), ("build_problem", 3), ("lm", 4))
WANT_MS = {"backprop_ms": 3e-3, "build_problem_ms": 4e-3}


def _reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics",
                                            f"{name}.py"), "t_" + name)


def _replay(t0, trips, marks):
    """begin, verify scan, one EM round, count scan (1 µs each), the
    pre-solve (9 µs: with `marks` its three stages, else one edge to the
    LM's first test), `trips` trips of 10 + 30 µs, gating (1 µs)."""
    seq, t = [("begin", t0)], t0
    pre = PRE_SOLVE if marks else (("lm", 9),)
    for k, us in (("em_scan", 1), ("em_refit", 1), ("em_refit", 1),
                  ("em_scan", 1)) + pre:
        t += us * 1000
        seq.append((k, t))
    for _ in range(trips):
        t += 10_000
        seq.append(("bcr_solve", t))
        t += 30_000
        seq.append(("lm", t))
    return seq + [("end", t + 1000)]


def _run(monkeypatch, marks):
    """A process of three unprofiled corrections, one replay each, whose
    last two are the window."""
    from hitl_slam_torch.utils import timing

    replays = [_replay(1_000_000 * (k + 1), n, marks)
               for k, n in enumerate((8, 3, 5))]
    spans = []
    for k, seq in enumerate(replays):
        b, e = seq[0][1], seq[-1][1]
        spans += [(2 * k, "hitl.correction", b - 100_000, e + 50_000, -1, 1,
                   k + 1, None, False),
                  (2 * k + 1, "hitl.launch", b - 1_000, b - 500, 2 * k, 1,
                   k + 1, (0, k), False)]
    snap = timing.Snapshot([_clock(replays)], {}, spans, {})
    monkeypatch.setattr(timing, "snapshot", lambda: snap)
    walls = [(seq[-1][1] - seq[0][1] + 150_000) * 1e-6 + 0.01
             for seq in replays[1:]]
    return harness.RunRecord(samples={"correction_ms": walls})


@pytest.mark.parametrize("name", sorted(EDGES))
def test_reader_reads_its_edge_inside_the_pre_solve(name, monkeypatch):
    run = _run(monkeypatch, marks=True)
    pre = _reader("pre_solve_ms").read(run)
    assert _reader(name).read(run) == pytest.approx(WANT_MS[name])
    assert pre == pytest.approx(13e-3)
    assert sum(_reader(n).read(run) for n in EDGES) <= pre
    # the marks split the pre-solve; they do not move it or the replay
    cycle = _reader("cycle_device_ms").read(run)
    run = _run(monkeypatch, marks=False)
    assert _reader("pre_solve_ms").read(run) == pytest.approx(pre)
    assert _reader("cycle_device_ms").read(run) == pytest.approx(cycle)


@pytest.mark.parametrize("name", sorted(EDGES))
def test_reader_is_silent_without_the_marks(name, monkeypatch):
    assert _reader(name).read(_run(monkeypatch, marks=False)) is None


@pytest.mark.parametrize("name", sorted(EDGES))
def test_reader_is_silent_without_the_recorder(name, monkeypatch):
    from hitl_slam_torch.utils import timing

    run = _run(monkeypatch, marks=True)
    monkeypatch.delattr(timing, "snapshot")
    assert _reader(name).read(run) is None


@pytest.mark.parametrize("name", sorted(EDGES))
def test_reader_declares_its_manifest_entry(name):
    """The entry matches the reader and lists corrections cells alone, the
    mix whose window `stages.window` counts back."""
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    row = {m["name"]: m for m in bench["per_layer"]}[name]
    drivers = {w["name"]: harness.load_json(os.path.join(
        harness.HERE, "traffic", f"{w['traffic']}.json"))["driver"]
        for w in bench["workloads"]}
    mod = _reader(name)
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        row["layer"], row["unit"], row["moves"], row["source"])
    assert row["workloads"]
    assert all(drivers.get(c) == "corrections" for c in row["workloads"])
