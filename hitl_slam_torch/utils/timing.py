"""The port's recorder, on one clock with the device (port of
hitl_slam_tpu/utils/timing.py, extended), a torch.profiler trace around
device work, and the native-crash guard of the entry points.

Host half: `TimerCollection` accumulates seconds by label (`time`, as the
reference's does) and records spans (`span`): start, end, parent, thread,
correction id and the span's own arguments, into a preallocated ring;
counters (`count`) tally events such as host reads, each also an event of
no length in the ring, under the span open around it (its correction's).
`GLOBAL_TIMERS` is the process's recorder; `span`, `count` and
`new_correction` are its methods.

Device half: every clocked LoopGraph's stage clock (utils/device_loop.py:
the cycle program's graphs), marked by the graph's own one-thread kernels
with %globaltimer. `snapshot()` synchronises, reads every clock, maps the
device's timer onto the host's `time.perf_counter_ns` (calibration points
taken when the first clock is made and at every snapshot), and returns both
halves as a `Snapshot`, whose methods give the readings: a program's stage
edges, its loops' trips and trip times, over every replay or over chosen
ones (from the clocks' logs of their marks), each correction's replays and
host-exposed time, and the counters' events of chosen corrections. Nothing
is read back while the program runs.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

SPAN_RING = 1 << 17     # spans the ring keeps (the last ones)
_profiling = torch.autograd._profiler_enabled


class _Span:
    """One open span (TimerCollection.span); `args` may be set while it is
    open; `children_ms` sums its direct children's milliseconds by name."""

    __slots__ = ("rec", "name", "index", "parent", "correction", "args",
                 "start", "end", "children", "_profile")

    def __init__(self, rec, name, correction):
        self.rec = rec
        self.name = name
        self.correction = correction
        self.args = None
        self.children = None
        self._profile = None

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        parent = stack[-1] if stack else None
        self.parent = parent
        if self.correction is None:
            self.correction = parent.correction if parent is not None else 0
        self.index = next(rec._next)
        stack.append(self)
        if _profiling():
            self._profile = torch.profiler.record_function(self.name)
            self._profile.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = end = time.perf_counter_ns()
        if self._profile is not None:
            self._profile.__exit__(*exc)
        rec, name, parent = self.rec, self.name, self.parent
        rec._local.stack.pop()
        dt = end - self.start
        if parent is not None:
            if parent.children is None:
                parent.children = {}
            parent.children[name] = parent.children.get(name, 0.0) + dt * 1e-6
        # under the GIL; a span closing on the speculative worker at the
        # same bytecode as one on the caller could lose one accumulation
        rec.acc[name] += dt * 1e-9
        rec.count[name] += 1
        rec._ring[self.index % rec._capacity] = (
            self.index, name, self.start, end,
            -1 if parent is None else parent.index, threading.get_ident(),
            self.correction, self.args, self._profile is not None)
        return False

    @property
    def ms(self) -> float:
        return (self.end - self.start) * 1e-6

    def children_ms(self) -> dict:
        return dict(self.children or {})


class TimerCollection:
    """Process-wide (label -> accumulated seconds, count) registry, like the
    reference's AlgorithmTimer/TimerCollection, and the recorder's host
    half: spans and counters."""

    def __init__(self, capacity: int = SPAN_RING):
        self.acc = collections.defaultdict(float)
        self.count = collections.defaultdict(int)
        self.counters = collections.defaultdict(int)
        self._capacity = capacity
        self._ring: list = [None] * capacity
        self._next = itertools.count()
        self._corrections = itertools.count(1)
        self._local = threading.local()

    @contextlib.contextmanager
    def time(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[label] += time.perf_counter() - t0
            self.count[label] += 1

    def span(self, name: str, correction: int | None = None) -> _Span:
        """A context manager that records the span `name`: its parent is
        the span open around it on this thread, its correction id
        `correction`, else its parent's, else 0. While a torch.profiler
        runs, it is also a `record_function(name)`; otherwise it enters
        nothing of the profiler's."""
        return _Span(self, name, correction)

    def new_correction(self) -> int:
        """A fresh correction id (1, 2, ...)."""
        return next(self._corrections)

    def tally(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name` (under the GIL, as spans), and
        record it in the ring as an event of no length: (index, name, ns,
        ns, the open span's index or -1, thread, its correction or 0, n,
        profiled)."""
        self.counters[name] += n
        stack = self._stack()
        parent = stack[-1] if stack else None
        i = next(self._next)
        t = time.perf_counter_ns()
        self._ring[i % self._capacity] = (
            i, name, t, t, -1 if parent is None else parent.index,
            threading.get_ident(), 0 if parent is None else parent.correction,
            n, _profiling())

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def spans(self) -> list:
        """The spans and counter events the ring holds, oldest first:
        (index, name, start ns, end ns, parent index or -1, thread,
        correction, args, profiled)."""
        return sorted((r for r in list(self._ring) if r is not None),
                      key=lambda r: r[0])

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
span = functools.partial(_Span, GLOBAL_TIMERS, correction=None)
count = GLOBAL_TIMERS.tally
new_correction = GLOBAL_TIMERS.new_correction


# -- readings -----------------------------------------------------------------

def to_host(points: list, device_ns) -> np.ndarray:
    """Device ns mapped to host ns through calibration points (device ns,
    host ns, bracket ns): linear between the two around each time, the
    nearest segment's line beyond them, an offset alone from one point.
    The device's timer counts from the epoch (~2**60 ns), past float64's
    exact integers, so times are taken relative to the first point in int64
    before any float arithmetic."""
    pts = sorted(points)
    d0, h0 = pts[0][0], pts[0][1]
    x = (np.asarray(device_ns, np.int64) - d0).astype(np.float64)
    d = np.array([p[0] - d0 for p in pts], np.float64)
    off = np.array([(p[1] - h0) - (p[0] - d0) for p in pts], np.float64)
    if len(pts) == 1:
        return h0 + x + off[0]
    i = np.clip(np.searchsorted(d, x) - 1, 0, len(pts) - 2)
    w = (x - d[i]) / np.maximum(d[i + 1] - d[i], 1.0)
    return h0 + x + off[i] + w * (off[i + 1] - off[i])


def exposed_ns(start: int, end: int, intervals) -> int:
    """The part of [start, end] that no interval of `intervals` covers."""
    covered, last = 0, start
    for a, b in sorted(intervals):
        a, b = max(a, last), min(b, end)
        if b > a:
            covered += b - a
            last = b
    return (end - start) - covered


@dataclass
class Stages:
    """The stage clocks of one program, merged by mark name: nanoseconds
    and hits of each edge (previous mark, mark), hits of each mark, and the
    replays."""

    marks: list
    edge_ns: np.ndarray
    edge_hits: np.ndarray
    hits: np.ndarray
    replays: int

    @classmethod
    def merge(cls, clocks: list) -> Stages | None:
        names: list = []
        for c in clocks:
            names += [k for k in c["marks"] if k not in names]
        m = len(names)
        out = cls(names, np.zeros((m, m), np.int64),
                  np.zeros((m, m), np.int64), np.zeros(m, np.int64), 0)
        for c in clocks:
            ix = [names.index(k) for k in c["marks"]]
            out.edge_ns[np.ix_(ix, ix)] += c["edge_ns"]
            out.edge_hits[np.ix_(ix, ix)] += c["edge_hits"]
            out.hits[ix] += c["hits"]
            out.replays += c["replays"]
        return out if out.replays else None

    @classmethod
    def of_replays(cls, clocks: list, replays) -> Stages | None:
        """The replays `replays` ((clock index, replay number)) of
        `clocks`, each folded from its clock's log of marks as the device
        folds them; None where a log no longer holds one of them, or none
        is asked."""
        want: dict = collections.defaultdict(set)
        for k, n in replays:
            want[int(k)].add(int(n))
        folded = []
        for c in clocks:
            numbers = want.pop(c["index"], None)
            if not numbers:
                continue
            ids = c["log"][:, 1].astype(np.int64)
            ns = c["log"][:, 0].astype(np.int64)
            starts = np.nonzero(ids == 0)[0]
            # the log's last begin is the clock's last replay
            first = c["replays"] - len(starts)
            keep = [i for i in range(len(starts)) if first + i in numbers]
            if len(keep) != len(numbers):
                return None
            m = len(c["marks"])
            edge_ns = np.zeros((m, m), np.int64)
            edge_hits = np.zeros((m, m), np.int64)
            hits = np.zeros(m, np.int64)
            bounds = np.append(starts, len(ids))
            for i in keep:
                a, b = bounds[i], bounds[i + 1]
                seg, t = ids[a:b], ns[a:b]
                np.add.at(edge_ns, (seg[:-1], seg[1:]), np.diff(t))
                np.add.at(edge_hits, (seg[:-1], seg[1:]), 1)
                np.add.at(hits, seg, 1)
            folded.append(dict(marks=c["marks"], edge_ns=edge_ns,
                               edge_hits=edge_hits, hits=hits,
                               replays=len(keep)))
        if want or not folded:
            return None
        return cls.merge(folded)

    def _ix(self, marks) -> list:
        return [self.marks.index(k) for k in marks if k in self.marks]

    def mean_ms(self) -> float:
        """Mean ms of a replay, begin to end (the edges sum to it)."""
        return float(self.edge_ns.sum()) / self.replays * 1e-6

    def edges_ms(self) -> dict:
        """{"a->b": (ms a replay, hits a replay)} of every edge that ran."""
        out = {}
        for i, j in zip(*np.nonzero(self.edge_hits)):
            out[f"{self.marks[i]}->{self.marks[j]}"] = (
                float(self.edge_ns[i, j]) / self.replays * 1e-6,
                float(self.edge_hits[i, j]) / self.replays)
        return out

    def before_ms(self, inside) -> float:
        """Mean ms a replay of the edges that leave a mark outside `inside`
        (a loop's test and the marks of its trips): for a loop that every
        replay enters and leaves to its end, the time before the loop."""
        out = [i for i, k in enumerate(self.marks) if k not in inside]
        return float(self.edge_ns[out].sum()) / self.replays * 1e-6

    def loop(self, test: str, inside) -> tuple[int, float]:
        """(trips, ns of all trips) of the loop whose tests mark `test` and
        whose trips mark `inside` (the test among them): a trip runs from
        one test to the next; the first test of each entry comes from a mark
        outside."""
        ins = self._ix(inside)
        if test not in self.marks:
            return 0, 0.0
        t = self.marks.index(test)
        out = [i for i in range(len(self.marks)) if i not in ins]
        entries = int(self.edge_hits[out, t].sum())
        trips = int(self.hits[t]) - entries
        return trips, float(self.edge_ns[np.ix_(ins, ins)].sum())


@dataclass
class Correction:
    """One correction the span ring holds (Snapshot.corrections): its id,
    its root span's start and wall (host ns), whether a profiler ran, its
    replays ((clock index, replay number) of its launch spans), and, where
    the clocks' rings hold every one of them, their begin-to-end summed
    and the part of its wall during which none of them ran on the device
    (host-exposed), else None."""

    id: int
    start_ns: int
    wall_ns: int
    profiled: bool
    replays: list
    device_ns: float | None
    exposed_ns: float | None


@dataclass
class Snapshot:
    """Both halves of the recorder at one moment (snapshot()): every stage
    clock read (`ring`: replay, begin, end, mapped to host ns; `log`: the
    device's ns and mark id of its last marks; `log_host`: the log's times
    mapped to host ns), the calibration points by device, the spans and
    counter events the ring holds, and the counters."""

    clocks: list = field(default_factory=list)
    calibration: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    def stages(self, label: str, replays=None) -> Stages | None:
        """The stage clocks of the graphs of program `label` merged, over
        every replay, or over `replays` ((clock index, replay number)) from
        the clocks' logs; None where none replayed, or where a log no
        longer holds one of `replays`."""
        clocks = [c for c in self.clocks if c["label"] == label]
        if replays is None:
            return Stages.merge(clocks)
        return Stages.of_replays(clocks, replays)

    def corrections(self, root: str = "hitl.correction",
                    launch: str = "hitl.launch") -> list:
        """Every `root` span the ring holds, oldest first, as a Correction;
        its replays are the `launch` spans of its correction id, on any
        thread."""
        rings = {c["index"]: {int(n): (b, e) for n, b, e in c["ring"]}
                 for c in self.clocks}
        replays = collections.defaultdict(list)
        for r in self.spans:
            if r[1] == launch and r[7] is not None:
                replays[r[6]].append((int(r[7][0]), int(r[7][1])))
        out = []
        for r in self.spans:
            if r[1] != root:
                continue
            ids = replays.get(r[6], [])
            ivs = [rings.get(k, {}).get(n) for k, n in ids]
            known = bool(ivs) and all(iv is not None for iv in ivs)
            out.append(Correction(
                r[6], r[2], r[3] - r[2], bool(r[8]), ids,
                sum(b - a for a, b in ivs) if known else None,
                exposed_ns(r[2], r[3], ivs) if known else None))
        return out

    def counted(self, counter: str, corrections) -> int:
        """The events of counter `counter` under the correction ids
        `corrections` that the ring holds, summed."""
        ids = set(corrections)
        return sum(r[7] for r in self.spans
                   if r[1] == counter and r[2] == r[3] and r[6] in ids)

    def timer(self) -> dict:
        """By device: the calibration's tightest and latest bracket (ns),
        and the drift of device against host between the first and the
        last point (ns and ppm over the seconds between them)."""
        out = {}
        for d, pts in self.calibration.items():
            (d0, h0, _), (d1, h1, b1) = pts[0], pts[-1]
            span_s = (d1 - d0) * 1e-9
            drift = (h1 - d1) - (h0 - d0)
            out[d] = dict(bracket_ns=b1, tightest_ns=min(p[2] for p in pts),
                          points=len(pts), over_s=span_s, drift_ns=drift,
                          drift_ppm=drift / (span_s * 1e3) if span_s else None)
        return out


def snapshot(recorder: TimerCollection | None = None) -> Snapshot:
    """The recorder now (synchronises and reads every stage clock; takes a
    fresh calibration point on every device with one)."""
    from . import device_loop

    rec = GLOBAL_TIMERS if recorder is None else recorder
    dev = device_loop.read_clocks()
    clocks = []
    for c in dev["clocks"]:
        pts = dev["calibration"][c["device"]]
        ring = c["ring"].astype(np.float64)
        ring[:, 1:] = to_host(pts, c["ring"][:, 1:])
        log_host = c["log"].astype(np.float64)
        log_host[:, 0] = to_host(pts, c["log"][:, 0])
        clocks.append(dict(c, ring=ring, log_host=log_host))
    return Snapshot(clocks, dev["calibration"], rec.spans(),
                    dict(rec.counters))


# -- the trace ----------------------------------------------------------------

STAGE_PID = 1 << 30     # the stage clock's process in the Chrome trace


def trace_offset_us(events: list, spans: list) -> float | None:
    """Host perf_counter µs -> the trace's µs: the median difference of the
    midpoints of the spans recorded under the profiler and of the trace's
    `user_annotation` events of the same name (a span times itself inside
    its record_function, so midpoints cancel the profiler's own time at
    either end), paired in order for each name whose counts agree; None
    where none pair."""
    ours = collections.defaultdict(list)
    for r in spans:
        if r[8]:
            ours[r[1]].append((r[2] + r[3]) * 0.5e-3)
    theirs = collections.defaultdict(list)
    for e in events:
        if (e.get("cat") == "user_annotation" and e.get("name") in ours
                and "dur" in e):
            theirs[e["name"]].append(float(e["ts"]) + 0.5 * float(e["dur"]))
    diffs = []
    for name, mids in ours.items():
        ts = sorted(theirs.get(name, []))
        if ts and len(ts) == len(mids):
            diffs += [b - a for a, b in zip(mids, ts)]
    return float(np.median(diffs)) if diffs else None


def stage_events(snap: Snapshot, offset_us: float, t0_us: float,
                 t1_us: float) -> list:
    """Chrome-trace events of every stage edge inside [t0, t1] (trace µs):
    one track (of the process "stage clock") a graph, an edge "a->b" from
    mark a to mark b of one replay."""
    out = [{"ph": "M", "name": "process_name", "pid": STAGE_PID,
            "args": {"name": "stage clock"}}]
    for c in snap.clocks:
        log = c["log_host"]
        tid = c["index"]
        out.append({"ph": "M", "name": "thread_name", "pid": STAGE_PID,
                    "tid": tid, "args": {"name": f"{c['label']} #{tid}"}})
        for (ta, a), (tb, b) in zip(log[:-1], log[1:]):
            a_us, b_us = ta * 1e-3 + offset_us, tb * 1e-3 + offset_us
            if int(b) == 0 or a_us < t0_us or b_us > t1_us:
                continue
            out.append({"ph": "X", "cat": "stage", "pid": STAGE_PID,
                        "tid": tid, "ts": a_us, "dur": b_us - a_us,
                        "name": f"{c['marks'][int(a)]}->{c['marks'][int(b)]}"})
    return out


def add_stage_track(path: str) -> int:
    """Append the stage edges that fall inside the Chrome trace at `path`
    (torch.profiler's) as events on a track of their own, on the trace's
    clock (trace_offset_us); the number of edges added (0 where no span of
    the trace pairs with the recorder's)."""
    import json

    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    snap = snapshot()
    off = trace_offset_us(events, snap.spans)
    timed = [e for e in events if "ts" in e and e.get("ph") == "X"]
    if off is None or not timed:
        return 0
    t0 = min(float(e["ts"]) for e in timed)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0)) for e in timed)
    added = stage_events(snap, off, t0, t1)
    trace["traceEvents"] = events + added
    with open(path, "w") as f:
        json.dump(trace, f)
    return sum(e["ph"] == "X" for e in added)


@contextlib.contextmanager
def device_trace(label: str, enabled: bool = False,
                 logdir: str = "/tmp/torch-trace"):
    """Optionally wrap a block in a torch.profiler trace (host ops, the
    recorder's spans, and the card's kernels when CUDA is available),
    written to `logdir` as a Chrome trace (`<label>.pt.trace.json`, open
    with chrome://tracing or Perfetto), with the stage clocks' edges on a
    track of their own (add_stage_track)."""
    if not enabled:
        yield
        return
    import os

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
    path = os.path.join(logdir, f"{label}.pt.trace.json")
    prof.export_chrome_trace(path)
    add_stage_track(path)


def install_crash_guard():
    """Native-crash backtrace guard for the entry points: both CUDA kernels
    are reached through ctypes (utils/cuda_build.py), and a crash inside a
    ctypes call would otherwise die without a Python traceback."""
    import faulthandler

    try:
        faulthandler.enable()
    except Exception:
        pass    # no real stderr fd (e.g. captured streams): skip the guard
