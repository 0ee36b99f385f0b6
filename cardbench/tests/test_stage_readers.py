"""The readers of the program's stage clock and spans (cycle_device_ms,
pre_solve_ms, lm_trip_ms, lm_trips_per_correction, engine_host_ms,
host_reads_per_correction) on a synthetic snapshot, and their silence on a
program without the recorder."""

import os

import numpy as np
import pytest

from cardbench import harness

NAMES = ("cycle_device_ms", "pre_solve_ms", "lm_trip_ms",
         "lm_trips_per_correction", "engine_host_ms",
         "host_reads_per_correction")


def _reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics",
                                            f"{name}.py"), "t_" + name)


def _clock(replays, label="hitl", index=0):
    """A stage clock's reading (StageClock.read's keys) folded from
    replays of (mark, ns) lists, its log holding every mark."""
    marks = ["begin", "end"]
    for seq in replays:
        marks += [k for k in dict.fromkeys(k for k, _ in seq)
                  if k not in marks]
    m = len(marks)
    ns, hits_e, hits = (np.zeros((m, m), np.int64), np.zeros((m, m), np.int64),
                        np.zeros(m, np.int64))
    hits[0] = len(replays)
    for seq in replays:
        for (a, ta), (b, tb) in zip(seq[:-1], seq[1:]):
            i, j = marks.index(a), marks.index(b)
            ns[i, j] += tb - ta
            hits_e[i, j] += 1
            hits[j] += 1
    ring = np.array([(n, s[0][1], s[-1][1]) for n, s in enumerate(replays)],
                    np.float64)
    log = np.array([(t, marks.index(k)) for seq in replays for k, t in seq],
                   np.int64)
    return dict(label=label, index=index, marks=marks, edge_ns=ns,
                edge_hits=hits_e, hits=hits, replays=len(replays), ring=ring,
                log=log)


def _replay(t0, trips):
    """begin, verify scan (1 µs), EM (2 rounds of 1 µs), count scan, the LM
    entry (2 µs), `trips` trips of 10 + 30 µs, gating (1 µs)."""
    seq, t = [("begin", t0)], t0
    for k, dt in (("em_scan", 1000), ("em_refit", 1000), ("em_refit", 1000),
                  ("em_refit", 1000), ("em_scan", 1000), ("lm", 2000)):
        t += dt
        seq.append((k, t))
    for _ in range(trips):
        t += 10_000
        seq.append(("bcr_solve", t))
        t += 30_000
        seq.append(("lm", t))
    return seq + [("end", t + 1000)]


# the process: a warm-up correction, the window's two, a traced one
TRIPS = (10, 4, 6, 12)
READS = (6, 1, 3, 1)


def _process():
    """(snapshot, run): one replay a correction; each correction's span
    opens 100 µs before its replay begins and closes 50 µs after it ends;
    its host reads as counter events under it."""
    from hitl_slam_torch.utils import timing

    replays = [_replay(1_000_000 * (k + 1), n) for k, n in enumerate(TRIPS)]
    spans, i = [], 0
    for k, seq in enumerate(replays):
        traced = k == len(replays) - 1
        b, e = seq[0][1], seq[-1][1]
        spans += [(i, "hitl.correction", b - 100_000, e + 50_000, -1, 1,
                   k + 1, None, traced),
                  (i + 1, "hitl.launch", b - 1_000, b - 500, i, 1, k + 1,
                   (0, k), traced)]
        spans += [(i + 2 + r, "host_reads", e + 1_000, e + 1_000, i, 1,
                   k + 1, 1, traced) for r in range(READS[k])]
        i += 2 + READS[k]
    other = _clock(replays[:1], "refine", index=1)
    snap = timing.Snapshot([_clock(replays), other], {}, spans,
                           {"host_reads": sum(READS)})
    walls = [(seq[-1][1] - seq[0][1] + 150_000) * 1e-6 + 0.01
             for seq in replays[1:3]]
    return snap, harness.RunRecord(samples={"correction_ms": walls})


@pytest.fixture
def process(monkeypatch):
    from hitl_slam_torch.utils import timing

    snap, run = _process()
    monkeypatch.setattr(timing, "snapshot", lambda: snap)
    return run


def test_readers_read_the_window_alone(process):
    got = {n: _reader(n).read(process) for n in NAMES}
    # a replay: 7 µs of EM and entry, 40 µs a trip, 1 µs of gating; the
    # window's replays make 4 and 6 trips
    assert got["cycle_device_ms"] == pytest.approx((8 + 40 * 5) * 1e-3)
    assert got["pre_solve_ms"] == pytest.approx(7e-3)
    assert got["lm_trip_ms"] == pytest.approx(40e-3)
    assert got["lm_trips_per_correction"] == pytest.approx(5.0)
    assert got["engine_host_ms"] == pytest.approx(0.150)
    assert got["host_reads_per_correction"] == pytest.approx(2.0)


def test_readers_fall_silent_where_the_window_is_not_held(process):
    walls = process.samples["correction_ms"]
    # more samples than the recorder's unprofiled corrections
    process.samples["correction_ms"] = walls * 2
    assert all(_reader(n).read(process) is None for n in NAMES)
    # a sample shorter than its correction's span: not the window
    process.samples["correction_ms"] = [walls[0], 0.001]
    assert all(_reader(n).read(process) is None for n in NAMES)


def test_readers_on_a_program_without_clocks(monkeypatch):
    from hitl_slam_torch.utils import timing

    monkeypatch.setattr(timing, "snapshot", lambda: timing.Snapshot())
    _, run = _process()
    assert all(_reader(n).read(run) is None for n in NAMES)


def test_readers_on_a_program_without_the_recorder(monkeypatch):
    """The parent commit's program has no snapshot(): every reader finds
    nothing and raises nothing."""
    from hitl_slam_torch.utils import timing

    monkeypatch.delattr(timing, "snapshot")
    _, run = _process()
    assert all(_reader(n).read(run) is None for n in NAMES)


def test_readers_declare_the_manifest_entries():
    """Each reader's entry matches it, and lists only cells of the
    corrections mix, the mix whose window `stages.window` counts back."""
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    rows = {m["name"]: m for m in bench["per_layer"]}
    drivers = {w["name"]: harness.load_json(os.path.join(
        harness.HERE, "traffic", f"{w['traffic']}.json"))["driver"]
        for w in bench["workloads"]}
    for n in NAMES:
        mod = _reader(n)
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
            rows[n]["layer"], rows[n]["unit"], rows[n]["moves"],
            rows[n]["source"])
        cells = rows[n]["workloads"]
        assert all(drivers.get(c) == "corrections" for c in cells), (n, cells)
        assert "hitl-figure8-1024.corrections" in cells
