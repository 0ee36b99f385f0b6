"""The recorder (utils/timing.py) and the stage clock (utils/device_loop.py,
csrc/graph_loop.cu): the readings' arithmetic on synthetic marks and
spans, span nesting, parents and correction ids (the speculative worker's
too), the profiler only under a profiler, the engine's host reads and
report timings on the CPU; and, on a card only (marker `cuda`), a
replay's marks against its LM iterations, the graphs' node budget, and
the mapped replays against the profiler's graph spans.

On the card: python -m pytest -p no:cacheprovider --noconftest -m cuda
tests/test_torch_stage_clock.py"""

import json
import os
import re
import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hitl_slam_torch.utils import device_loop, timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
LM = ("lm", "bcr_solve")


def _clock(replays, marks=None):
    """A clock's reading (StageClock.read's keys, and snapshot's
    `log_host`, the host's clock taken as the device's) folded from
    `replays`, each a list of (mark name, ns) from begin to end, as the
    device's marks fold them: each mark adds the time since the last to
    the edge (last, mark)."""
    marks = list(marks or ["begin", "end"])
    for seq in replays:
        marks += [k for k in dict.fromkeys(k for k, _ in seq)
                  if k not in marks]
    m = len(marks)
    edge_ns = np.zeros((m, m), np.int64)
    edge_hits = np.zeros((m, m), np.int64)
    hits = np.zeros(m, np.int64)
    ring, log = [], []
    for n, seq in enumerate(replays):
        assert seq[0][0] == "begin" and seq[-1][0] == "end"
        hits[0] += 1
        for (a, ta), (b, tb) in zip(seq[:-1], seq[1:]):
            i, j = marks.index(a), marks.index(b)
            edge_ns[i, j] += tb - ta
            edge_hits[i, j] += 1
            hits[j] += 1
        ring.append((n, seq[0][1], seq[-1][1]))
        log += [(t, marks.index(k)) for k, t in seq]
    return dict(label="hitl", index=0, marks=marks, edge_ns=edge_ns,
                edge_hits=edge_hits, hits=hits, replays=len(replays),
                ring=np.array(ring, np.float64), log=np.array(log, np.int64),
                log_host=np.array(log, np.float64))


def _cycle_marks(t0, em_rounds, lm_trips):
    """One cycle replay's marks: verify scan, EM rounds, count scan, the LM
    loop with a BCR launch a trip, gating; 10 ns an edge but 100 ns each
    LM trip edge."""
    seq, t = [("begin", t0)], t0
    names = (["em_scan"] + ["em_refit"] * (em_rounds + 1) + ["em_scan", "lm"])
    for k in names:
        t += 10
        seq.append((k, t))
    for _ in range(lm_trips):
        for k in ("bcr_solve", "lm"):
            t += 100
            seq.append((k, t))
    seq.append(("end", t + 10))
    return seq


def test_edges_sum_to_the_replay_and_loops_count_their_trips():
    replays = [_cycle_marks(1000, 2, 5), _cycle_marks(5000, 0, 1),
               _cycle_marks(9000, 3, 14)]
    st = timing.Stages.merge([_clock(replays)])
    walls = [s[-1][1] - s[0][1] for s in replays]
    assert st.replays == 3
    assert st.mean_ms() == pytest.approx(np.mean(walls) * 1e-6)
    edges = st.edges_ms()
    assert sum(ms for ms, _ in edges.values()) == pytest.approx(st.mean_ms())
    assert edges["em_scan->lm"] == (pytest.approx(10e-6), 1.0)
    # before the LM: begin to its first test
    pre = [[t for k, t in s if k == "lm"][0] - s[0][1] for s in replays]
    assert st.before_ms(LM) == pytest.approx(np.mean(pre) * 1e-6)
    trips, ns = st.loop("lm", LM)
    assert trips == 5 + 1 + 14 and ns == 200 * trips
    rounds, _ = st.loop("em_refit", ("em_refit",))
    assert rounds == 2 + 0 + 3
    # two clocks of one program, their marks named in other orders, merge
    a = _clock(replays[:1])
    b = _clock(replays[1:], marks=["begin", "end", "lm", "bcr_solve"])
    both = timing.Stages.merge([a, b])
    assert both.loop("lm", LM) == (trips, ns)
    assert both.mean_ms() == pytest.approx(st.mean_ms())
    assert timing.Stages.merge([_clock([])]) is None


def test_chosen_replays_fold_from_the_log_as_the_device_folds_them():
    replays = [_cycle_marks(1000, 2, 5), _cycle_marks(5000, 0, 1),
               _cycle_marks(9000, 3, 14), _cycle_marks(20_000, 1, 2)]
    clock = _clock(replays)
    whole = timing.Stages.merge([_clock(replays[1:3])])
    some = timing.Stages.of_replays([clock], [(0, 2), (0, 1)])
    assert some.replays == 2
    assert some.loop("lm", LM) == whole.loop("lm", LM)
    assert some.mean_ms() == pytest.approx(whole.mean_ms())
    assert some.before_ms(LM) == pytest.approx(whole.before_ms(LM))
    assert timing.Stages.of_replays([clock], [(0, k) for k in range(4)]
                                    ).edge_ns.sum() == clock["edge_ns"].sum()
    # a log that lost its oldest marks, mid-replay: the replays it still
    # holds whole are numbered from its last one, the others are missing
    cut = dict(clock, log=clock["log"][30:])
    assert timing.Stages.of_replays([cut], [(0, 3)]).loop("lm", LM) == (
        2, 400.0)
    assert timing.Stages.of_replays([cut], [(0, 0)]) is None
    assert timing.Stages.of_replays([cut], [(5, 0)]) is None
    assert timing.Stages.of_replays([cut], []) is None


@pytest.mark.parametrize("intervals,want", [
    ([], 100), ([(20, 50)], 70), ([(-10, 30)], 70), ([(80, 150)], 80),
    ([(-5, 200)], 0), ([(200, 300)], 100), ([(10, 40), (30, 60)], 50),
    ([(60, 70), (10, 20)], 80), ([(10, 20), (12, 15)], 90)])
def test_host_exposed_is_interval_subtraction(intervals, want):
    assert timing.exposed_ns(0, 100, intervals) == want


def test_to_host_maps_the_epoch_timer_exactly():
    epoch = 1_790_000_000_000_000_123    # ~2**60.6 ns
    one = [(epoch, 5_000, 12)]
    assert timing.to_host(one, [epoch + 7]).tolist() == [5_007.0]
    # a drift of 1 ns in 1000 between two points; beyond them their line
    two = [(epoch, 5_000, 12), (epoch + 1_000_000, 1_005_001, 9)]
    got = timing.to_host(two, [epoch, epoch + 500_000, epoch + 2_000_000])
    assert got.tolist() == [5_000.0, 505_000.5, 2_005_002.0]


def _snapshot_with_corrections():
    """Two corrections, one replay each: the first fully inside its span,
    the second's replay (speculative) begun before its span opened; a
    third whose replay fell out of the ring; host reads under the first
    two."""
    clock = _clock([[("begin", 1_000), ("end", 4_000)],
                    [("begin", 9_000), ("end", 12_000)]])
    spans = [
        (0, "hitl.launch", 900, 950, 1, 1, 1, (0, 0), False),
        (1, "hitl.correction", 500, 5_000, -1, 1, 1, None, False),
        (2, "hitl.launch", 8_900, 8_950, 4, 2, 2, (0, 1), False),
        (3, "hitl.correction", 10_000, 13_000, -1, 1, 2, None, False),
        (4, "hitl.launch", 20_000, 20_050, 5, 1, 3, (0, 7), True),
        (5, "hitl.correction", 19_000, 25_000, -1, 1, 3, None, True),
        # counter events: two under correction 1, one under 2, one outside
        (6, "host_reads", 4_100, 4_100, 1, 1, 1, 1, False),
        (7, "host_reads", 4_200, 4_200, 1, 1, 1, 1, False),
        (8, "host_reads", 12_100, 12_100, 3, 2, 2, 1, False),
        (9, "host_reads", 30_000, 30_000, -1, 1, 0, 1, False),
    ]
    return timing.Snapshot([clock], {}, spans, {"host_reads": 4})


def test_corrections_read_wall_device_and_exposed():
    snap = _snapshot_with_corrections()
    rows = snap.corrections()
    assert [(c.id, c.start_ns, c.wall_ns, c.device_ns, c.exposed_ns)
            for c in rows] == [(1, 500, 4_500, 3_000, 1_500),
                               (2, 10_000, 3_000, 3_000, 1_000),
                               (3, 19_000, 6_000, None, None)]
    assert [c.replays for c in rows] == [[(0, 0)], [(0, 1)], [(0, 7)]]
    assert [c.profiled for c in rows] == [False, False, True]
    assert snap.counted("host_reads", [1, 2]) == 3
    assert snap.counted("host_reads", [2]) == 1
    assert snap.counted("hitl.launch", [1]) == 0     # spans are not counts
    assert snap.stages("hitl").replays == 2 and snap.stages("x") is None
    assert snap.stages("hitl", [(0, 1)]).replays == 1


def test_span_nesting_parents_threads_and_correction_ids():
    rec = timing.TimerCollection(capacity=8)
    with rec.span("root", correction=7) as root:
        with rec.span("a") as a:
            with rec.span("b"):
                pass
        with rec.span("a"):
            pass
        seen = {}

        def worker():
            with rec.span("w") as w:
                seen["w"] = (w.parent, w.correction)

        th = threading.Thread(target=worker)
        th.start()
        th.join()
    with rec.span("free") as free:
        pass
    spans = {r[0]: r for r in rec.spans()}
    assert [spans[i][1] for i in sorted(spans)] == ["root", "a", "b", "a",
                                                    "w", "free"]
    assert spans[a.index][4] == root.index and spans[2][4] == a.index
    assert spans[root.index][4] == -1 and spans[root.index][6] == 7
    assert spans[2][6] == 7                   # inherited through "a"
    assert seen["w"] == (None, 0)             # another thread's root
    assert spans[4][5] != spans[0][5] and free.correction == 0
    assert set(root.children_ms()) == {"a"}
    assert root.children_ms()["a"] == pytest.approx(
        sum((r[3] - r[2]) * 1e-6 for r in spans.values() if r[1] == "a"))
    assert dict(rec.count) == {"root": 1, "a": 2, "b": 1, "w": 1, "free": 1}
    assert "a: total" in rec.report()
    # the ring keeps the last `capacity` spans
    for _ in range(10):
        with rec.span("x"):
            pass
    assert len(rec.spans()) == 8 and rec.spans()[-1][0] == 15


def test_counts_are_events_under_the_open_span():
    rec = timing.TimerCollection()
    rec.tally("reads")
    with rec.span("root", correction=4) as root:
        with rec.span("a") as a:
            rec.tally("reads", 2)
    events = [r for r in rec.spans() if r[1] == "reads"]
    assert [(r[2] == r[3], r[4], r[6], r[7]) for r in events] == [
        (True, -1, 0, 1), (True, a.index, 4, 2)]
    assert rec.counters["reads"] == 3 and "reads" not in rec.count
    assert root.children_ms().keys() == {"a"}


def test_span_enters_record_function_only_under_a_profiler(monkeypatch,
                                                           tmp_path):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    rec = timing.TimerCollection()
    with rec.span("hitl.off"):
        pass
    assert calls == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with rec.span("hitl.on"):
                with rec.span("hitl.inner"):
                    pass
    assert calls == ["hitl.on", "hitl.inner"] * 3
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    events = json.load(open(path))["traceEvents"]
    assert sum(e.get("name") == "hitl.on" for e in events) == 3
    assert [r[8] for r in rec.spans()] == [False] + [True] * 6
    # the recorder's clock against the trace's: one offset pairs them (a
    # profiler's first record_function may pause for its own set-up)
    off = timing.trace_offset_us(events, rec.spans())
    theirs = sorted(e["ts"] for e in events if e.get("name") == "hitl.on")
    ours = [r[2] * 1e-3 for r in rec.spans() if r[1] == "hitl.on"]
    assert np.median([abs(a + off - b) for a, b in zip(ours, theirs)]) < 100


def test_stage_events_put_edges_on_the_trace_clock():
    snap = timing.Snapshot([_clock([_cycle_marks(10_000, 0, 1),
                                    _cycle_marks(90_000, 0, 1)])])
    ev = timing.stage_events(snap, offset_us=5.0, t0_us=0.0, t1_us=50.0)
    edges = [e for e in ev if e["ph"] == "X"]
    names = [e["name"] for e in edges]
    assert names == ["begin->em_scan", "em_scan->em_refit",
                     "em_refit->em_scan", "em_scan->lm", "lm->bcr_solve",
                     "bcr_solve->lm", "lm->end"]
    assert edges[0]["ts"] == pytest.approx(15.0)       # 10 µs + 5 µs
    assert sum(e["dur"] for e in edges) == pytest.approx(0.25)
    assert {e["pid"] for e in ev} == {timing.STAGE_PID}


def test_device_trace_writes_the_spans(tmp_path):
    """`--profile`'s trace on the CPU: the recorder's spans are in it (no
    stage clock runs without a card)."""
    with timing.device_trace("t", enabled=True, logdir=str(tmp_path)):
        with timing.span("hitl.probe"):
            pass
    events = json.load(open(tmp_path / "t.pt.trace.json"))["traceEvents"]
    assert any(e.get("name") == "hitl.probe" for e in events)


def test_clock_layout_matches_the_kernels():
    src = open(os.path.join(ROOT, "hitl_slam_torch", "csrc",
                            "graph_loop.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMarks") == device_loop.CLOCK_MARKS
    assert const("kRing") == device_loop.CLOCK_RING
    assert const("kLog") == device_loop.CLOCK_LOG


def test_marks_past_the_limit_share_one_id():
    clock = device_loop.StageClock("cpu", "probe")
    ids = [clock.mark(f"m{k}") for k in range(40)]
    assert ids[:29] == list(range(2, 31))
    assert set(ids[29:]) == {31} and clock.marks[31] == "other"
    assert clock.mark("m3") == 5 and clock.mark("begin") == 0
    # a clock on no card takes no part in a snapshot
    assert all(c["index"] != clock.index
               for c in device_loop.read_clocks()["clocks"])


def test_a_clock_goes_with_its_last_reference():
    """The registry holds no clock alive: a dropped graph's clock, and its
    buffer, go with it."""
    import gc

    clock = device_loop.StageClock("cpu", "probe")
    index = clock.index
    assert device_loop.clocks[index] is clock
    assert device_loop.StageClock("cpu", "probe").index > index
    del clock
    gc.collect()
    assert index not in device_loop.clocks


# ------------------------------------------------------------ the engine

def _engine(device, name="golden"):
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    path = os.path.join(DATA, f"{name}.stfs.covars")
    data = stfs.load_stfs_covars(path if os.path.exists(path)
                                 else path + ".gz")
    eng = HitLSLAM(device=device)
    eng.init(data.poses, data.covariances, data.point_clouds,
             data.normal_clouds, constraint_capacity=16384)
    return eng, logs.load_log(os.path.join(DATA, f"{name}.log"))


class _ScalarReads(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


# with no speculative dispatch pending, no hitl.speculation
CHILDREN = ["hitl.load", "hitl.launch", "hitl.report_read", "hitl.commit"]


def test_eager_cycle_reads_its_report_once_and_its_loop_tests():
    """On the CPU a correction's host reads are its report (one) and its
    loops' exit tests; its report's timings_ms are its child spans."""
    eng, entries = _engine("cpu")
    before = timing.snapshot().counters.get("host_reads", 0)
    with _ScalarReads() as mode:
        rep = eng.replay_log(entries[0])
    snap = timing.snapshot()
    assert mode.n > 2          # the EM refit's and the LM's exit tests
    assert snap.counters["host_reads"] - before == 1 + mode.n
    assert rep.accepted and list(rep.timings_ms) == CHILDREN
    root = [r for r in snap.spans if r[1] == "hitl.correction"][-1]
    kids = [r for r in snap.spans if r[4] == root[0]]
    assert [r[1] for r in kids] == CHILDREN
    assert {r[6] for r in kids} == {root[6]} and root[6] > 0
    assert sum(rep.timings_ms.values()) <= (root[3] - root[2]) * 1e-6


def test_speculative_worker_spans_share_the_correction_id():
    """The cycle dispatched when the selection completes runs on a worker
    thread under the id of the correction that adopts it."""
    eng, entries = _engine("cpu")
    e = entries[0]
    pts = np.asarray(e.points, np.float32)
    eng.add_correction_points(int(e.correction_type), pts[0], pts[1])
    eng.add_correction_points(int(e.correction_type), pts[2], pts[3])
    rep = eng.run()
    assert rep.accepted and eng.speculative_hits == 1
    assert list(rep.timings_ms) == ["hitl.speculation", "hitl.commit"]
    spans = timing.snapshot().spans
    root = [r for r in spans if r[1] == "hitl.correction"][-1]
    dispatch = [r for r in spans if r[1] == "hitl.dispatch"][-1]
    assert dispatch[6] == root[6] and dispatch[5] != root[5]
    assert dispatch[4] == -1
    kids = [r for r in spans if r[4] == dispatch[0]]
    assert [r[1] for r in kids] == ["hitl.load", "hitl.launch",
                                    "hitl.report_read"]
    assert {r[6] for r in kids} == {root[6]}


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage clock lives in CUDA "
                    "graphs")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replay_marks_count_the_lm_trips(cuda_device):
    """Replay by replay, the `lm` marks of a cycle replay's log are one
    more than the iterations its LM ran (CycleProgram.solve_iterations),
    and its edges sum to its begin-to-end."""
    eng, entries = _engine(cuda_device, "golden_large")
    for e in entries:
        ct = int(e.correction_type)
        eng.replay_log(e)
        prog = eng._program(eng.state)
        want = int(prog.solve_iterations(ct))
        clock = prog.graphs[ct].clock.read()
        log = clock["log"]
        begin = np.nonzero(log[:, 1] == 0)[0][-1]
        seq = [clock["marks"][int(k)] for k in log[begin:, 1]]
        assert seq[-1] == "end" and seq.count("lm") == want + 1
        assert seq.count("bcr_solve") == want
        n, b, t_end = clock["ring"][-1]
        assert (b, t_end) == (log[begin, 0], log[-1, 0])


@pytest.mark.cuda
def test_clock_adds_two_top_nodes_and_none_to_a_body(cuda_device):
    eng, entries = _engine(cuda_device, "golden_large")
    e = entries[0]
    eng.replay_log(e)
    prog = eng._program(eng.state)
    ct = int(e.correction_type)
    with_clock = prog.graph(ct)
    args = (*prog.inputs, ct)
    bare = device_loop.LoopGraph(lambda: prog.fn(*args), prog.device,
                                 stream=prog.stream)
    assert with_clock.levels == bare.levels and bare.levels
    assert with_clock.body_nodes == bare.body_nodes
    assert with_clock.nodes == bare.nodes + 2
    assert with_clock.level_nodes[0] == bare.level_nodes[0] + 2


@pytest.mark.cuda
def test_mapped_replays_fall_inside_the_profiler_graph_spans(cuda_device):
    """One clock: each traced replay's begin and end, mapped onto the
    host's clock and then the trace's, lie within the profiler's span of
    the same launch (cardbench/tracing.py::graph_spans) to twice the
    calibration's bracket (the mapping's error, and CUPTI's own, not the
    replay); the median distance is under 20 µs."""
    import sys

    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from cardbench import tracing

    eng, entries = _engine(cuda_device, "golden_large")
    for e in entries:          # captures outside the profiler
        eng.replay_log(e)
    eng, entries = _engine(cuda_device, "golden_large")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for e in entries:
            eng.replay_log(e)
        torch.cuda.synchronize()
    path = os.path.join(ROOT, "chiprun_out", "stage_clock_test.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    events = json.load(open(path))["traceEvents"]
    snap = timing.snapshot()
    off = timing.trace_offset_us(events, snap.spans)
    assert off is not None
    spans, _ = tracing.graph_spans(events)
    t0 = min(a for a, _ in spans)
    mapped = sorted((b * 1e-3 + off, t * 1e-3 + off)
                    for c in snap.clocks if c["label"] == "hitl"
                    for _, b, t in c["ring"] if b * 1e-3 + off > t0 - 1e3)
    assert len(mapped) == len(spans) == len(entries)
    tol = 2e-3 * max(t["bracket_ns"] for t in snap.timer().values())
    dist = []
    for (b, t), (s0, s1) in zip(mapped, spans):
        assert s0 - tol <= b < t <= s1 + tol, (b, t, s0, s1, tol)
        dist += [abs(b - s0), abs(s1 - t)]
    assert float(np.median(dist)) <= 20.0
