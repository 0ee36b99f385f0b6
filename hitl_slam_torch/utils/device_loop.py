"""Loops whose trips the device decides: `device_while` and `LoopGraph`.

The reference runs its EM refit and its LM solve as `lax.while_loop`s
inside one compiled program: the device evaluates the condition, and the
host never sees it. The port's counterpart has two forms.

- Eagerly (CPU tensors, or CUDA tensors outside a capture), `device_while`
  reads `cond` before each trip and stops at the first false one, or after
  `max_trips` trips: one host read a trip, the loop's only ones. A loop
  inside a trip is a Python loop inside a Python loop.
- Inside `LoopGraph` (a CUDA graph capture on the card), it reads nothing.
  The work before the loop is closed as one captured piece, the graph gets
  a conditional node of type WHILE (csrc/graph_loop.cu) that runs its body
  while `cond & (trips < max_trips)` holds on the device, and one trip is
  captured into that body; the work after the loop starts the next piece.
  A `device_while` inside the trip does the same one level down: it closes
  the trip's current piece and adds its WHILE node to the body, so a CG
  loop inside an LM loop is a WHILE node inside a WHILE node, and a WHILE
  of `max_trips=1` is the reference's `lax.cond`. A replay of the whole
  graph runs every loop to its exit on the device, as `lax.while_loop`
  does.

`body` must update the loop's carry in place, with `copy_` into buffers
made before the loop, and recompute `cond` in place; it must not drop the
last reference to a tensor made before the loop. A trip that does not run
then leaves the carry exactly as it was.

The pieces are ordinary PyTorch captures (`torch.cuda.CUDAGraph` with
`keep_graph=True`), one after another on one stream and into one memory
pool, so a later piece may reuse what an earlier one freed; the graph runs
them in the order they were captured. PyTorch 2.11, the card's, has no
conditional nodes of its own (`CUDAGraph.begin_capture_to_if_node` came
later), so the WHILE node is added through the CUDA runtime in
csrc/graph_loop.cu (conditional nodes need CUDA 12.4 or later;
scripts/graph_loop_probe.py checks them on the card, nested ones too).

`device_for` is the loop of a static trip count (a chunk, a pose or a
round index): eagerly a Python loop that reads nothing, captured a WHILE
node over an index held on the device.

A LoopGraph made with `clock=True` carries a `StageClock`: a buffer on the
device, made before the capture, that the graph's one-thread kernels stamp
with %globaltimer (csrc/graph_loop.cu). The cycle's graphs carry one, the
only program a metric reads; the others go without, since a mark costs each
trip of a loop about half a microsecond or more (on an H100 the SDF build's
replay, 1,027 marks, ran 3.1 % slower with a clock). A loop's test marks
the clock with the loop's `name`, a kernel wrapper's launch counter with
the counter's name (utils/cuda_build.py::LaunchCounter), and two nodes of
the top graph mark its `begin` and `end`; the clock sums the nanoseconds
between consecutive marks by (previous mark, mark), and keeps each replay's
begin and end and a log of the last marks. A WHILE body gains no node, the
top graph two. Nothing is read back during a replay; `read_clocks`
(utils/timing.py::snapshot) synchronises and reads every live clock (a
clock goes with its graph), and `calibrate` maps the device's timer onto
the host's `time.perf_counter_ns`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable

import numpy as np
import torch

from . import cuda_build
from .timing import count, span

Tensor = torch.Tensor

_local = threading.local()
# one capture at a time in the process: a capture first returns the memory
# of dropped graphs' pools to the device (torch.cuda.empty_cache), which
# must not run while another thread captures
_capture_lock = threading.Lock()


def device_while(cond: Tensor, body: Callable[[], None],
                 max_trips: int, name: str = "loop") -> int | None:
    """While `cond` (a scalar bool tensor) holds, at most `max_trips`
    times, run `body()`, which updates the carry and `cond` in place.
    `name` is the loop's mark on its graph's stage clock.

    Returns the number of trips when run eagerly (each test a host read,
    counted as `host_reads`); None inside a `LoopGraph` capture, where the
    trips happen at replay."""
    if cond.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        capture = getattr(_local, "capture", None)
        if capture is None:
            raise RuntimeError("device_while: a loop can be captured only "
                               "inside a LoopGraph")
        capture.loop(cond, body, max_trips, name)
        return None
    trips = 0
    while trips < max_trips:
        count("host_reads")
        if not bool(cond):
            break
        body()
        trips += 1
    return trips


def device_for(trips: int, body: Callable[[Tensor], None],
               device, name: str = "for") -> None:
    """`body(i)` for i = 0 .. trips - 1, `i` a 0-dim int64 tensor on
    `device`: the reference's `lax.map` or `lax.scan` over a static range.
    `body` updates its carry in place, as device_while's does. Eagerly a
    Python loop that reads nothing back; inside a `LoopGraph` capture one
    WHILE node (device_while on i < trips), one trip captured."""
    i = torch.zeros((), dtype=torch.int64, device=device)
    if trips <= 0:
        return
    if i.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        go = i < trips

        def trip():
            body(i)
            i.add_(1)
            torch.lt(i, trips, out=go)

        device_while(go, trip, trips, name)
        return
    for _ in range(trips):
        body(i)
        i.add_(1)


# the stage clock's layout in int64 words (csrc/graph_loop.cu): marks a
# graph may name (0 and 1 are begin and end), replays the ring holds, marks
# the log holds
CLOCK_MARKS = 32
CLOCK_RING = 4096
CLOCK_LOG = 65536
_EDGE_NS = 4
_EDGE_HITS = _EDGE_NS + CLOCK_MARKS * CLOCK_MARKS
_HITS = _EDGE_HITS + CLOCK_MARKS * CLOCK_MARKS
_RING = _HITS + CLOCK_MARKS
_LOG = _RING + 2 * CLOCK_RING
CLOCK_WORDS = _LOG + 2 * CLOCK_LOG

# the live StageClocks by index (a clock goes with its graph)
clocks: weakref.WeakValueDictionary = weakref.WeakValueDictionary()
_clock_index = itertools.count()
# per device index: calibration points (device ns, host ns, bracket ns)
_calibration: dict = {}


class StageClock:
    """The stage clock of one LoopGraph (module docstring): its buffer on
    `device`, made outside any graph's memory, the names of its marks by id
    (`begin`, `end`, then in order of first use; past CLOCK_MARKS - 1 names
    every further one is `other`), and `launches`, the replays started,
    counted on the host. `label` names the graph's program."""

    def __init__(self, device, label: str):
        self.label = label
        self.device = torch.device(device)
        self.buf = torch.zeros((CLOCK_WORDS,), dtype=torch.int64,
                               device=self.device)
        self.marks = ["begin", "end"]
        self.launches = 0
        self.index = next(_clock_index)
        clocks[self.index] = self

    def mark(self, name: str) -> int:
        """The id of mark `name`, given one at its first use."""
        if name not in self.marks:
            if len(self.marks) >= CLOCK_MARKS - 1:
                name = "other"
            if name not in self.marks:
                self.marks.append(name)
        return self.marks.index(name)

    def read(self) -> dict:
        """The buffer read back (waits for the device): the edges' ns and
        hits [m, m] and the marks' hits [m] for the m named marks, the
        replays, the ring's (replay, begin ns, end ns) of the last
        CLOCK_RING replays and the log's (ns, mark id) of the last
        CLOCK_LOG marks, oldest first, in the device's ns."""
        b = self.buf.cpu().numpy()
        m = len(self.marks)
        M = CLOCK_MARKS
        replays, logged = int(b[2]), int(b[3])
        ring = b[_RING:_LOG].reshape(CLOCK_RING, 2)
        first = max(0, replays - CLOCK_RING)
        n = np.arange(first, replays)
        log = b[_LOG:].reshape(CLOCK_LOG, 2)
        k = np.arange(max(0, logged - CLOCK_LOG), logged) % CLOCK_LOG
        return dict(
            label=self.label, index=self.index, marks=list(self.marks),
            edge_ns=b[_EDGE_NS:_EDGE_HITS].reshape(M, M)[:m, :m].copy(),
            edge_hits=b[_EDGE_HITS:_HITS].reshape(M, M)[:m, :m].copy(),
            hits=b[_HITS:_HITS + m].copy(), replays=replays,
            ring=np.column_stack([n, ring[n % CLOCK_RING]]),
            log=log[k].copy())


def calibrate(device, trials: int = 64) -> tuple[int, int, int]:
    """One point of the map from the device's %globaltimer to the host's
    `time.perf_counter_ns` on CUDA `device`: `trials` one-thread stamps,
    each launched between two host reads, the second after a synchronise;
    of the tightest bracket, (device ns, the bracket's middle, its width).
    Kept as a calibration point of the device."""
    lib = cuda_build.library()
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize(dev)
    stream = torch.cuda.current_stream(dev)
    out = torch.zeros((trials,), dtype=torch.int64, device=dev)
    brackets = []
    for k in range(trials):
        t0 = time.perf_counter_ns()
        cuda_build.check(lib.hitl_clock_stamp(out[k].data_ptr(),
                                              stream.cuda_stream),
                         "clock stamp")
        stream.synchronize()
        brackets.append((t0, time.perf_counter_ns()))
    stamps = out.cpu().tolist()
    k = min(range(trials), key=lambda i: brackets[i][1] - brackets[i][0])
    t0, t1 = brackets[k]
    point = (int(stamps[k]), (t0 + t1) // 2, t1 - t0)
    _calibration.setdefault(dev.index, []).append(point)
    return point


def read_clocks() -> dict:
    """Every live stage clock on a card read, and its device's
    calibration, after a fresh calibration point on each device that has a
    clock: {"clocks": [StageClock.read()], "calibration": {device index:
    [points]}}. Nothing on a machine without clocks."""
    cards = sorted((c for c in list(clocks.values())
                    if c.device.type == "cuda"), key=lambda c: c.index)
    devices = sorted({c.device.index for c in cards})
    for d in devices:
        calibrate(torch.device("cuda", d))
    read = [dict(c.read(), device=c.device.index) for c in cards]
    return {"clocks": read,
            "calibration": {d: list(_calibration[d]) for d in devices}}


def capture_mark(name: str) -> tuple[int, int]:
    """(the clock's address, the id of mark `name`) of the LoopGraph this
    thread captures; (0, 0) outside one, or for a graph without a clock."""
    capture = getattr(_local, "capture", None)
    if capture is None or capture.clock is None:
        return 0, 0
    return capture.clock.buf.data_ptr(), capture.clock.mark(name)


class LoopGraph:
    """`fn()` captured once on CUDA `device` into one graph in which every
    `device_while` is a WHILE node, loops inside loops included;
    `replay()` runs it on the current stream. `outputs` is what `fn`
    returned: tensors in the graph's memory, overwritten by every replay.

    With `clock`, the graph carries a StageClock (`clock`, else None),
    labelled `label` (its program's name), made before the capture and
    dropped with the graph.

    `pool` (a `torch.cuda.graph_pool_handle()`) may be shared by several
    LoopGraphs that are never replayed at the same time and are captured on
    one `stream` (the pool's free memory is kept by stream). Any failure of the
    capture raises; nothing falls back to eager execution. `capture_ms`
    is the host time of the capture and instantiation, `nodes` the graph's
    nodes (those of every captured piece, each loop body once, the three a
    loop adds: its first test, the WHILE node, the test after a trip, and
    the clock's begin and end), `body_nodes` each loop's body nodes (one
    trip's captured pieces, not those of a loop inside it), `levels` each
    loop's depth (1: a loop of the top graph, 2: a loop inside a loop's
    trip), `level_nodes` the nodes at each depth (0: the top graph's; k: those in the bodies of the
    loops of depth k, their inner loops' first tests and WHILE nodes
    included), `pool_mib` the device memory the capture reserved. A
    LoopGraph is not captured inside another, and captures of several
    threads take turns.

    A capture starts with `torch.cuda.empty_cache()`: the pool of a graph
    that was dropped stays reserved until then (the allocator frees
    nothing while a capture runs, so a capture could run out of memory
    beside the pools of dropped programs)."""

    def __init__(self, fn: Callable[[], object], device, pool=None,
                 stream: torch.cuda.Stream | None = None,
                 label: str = "graph", clock: bool = False):
        self.device = torch.device(device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._lib = cuda_build.library()
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.stream = (torch.cuda.Stream(self.device) if stream is None
                       else stream)
        self.nodes = 0
        self.body_nodes: list[int] = []
        self.levels: list[int] = []
        self.level_nodes: dict[int, int] = {}
        self._pieces: list = []     # captured graphs: their memory stays
        self._keep: list = []       # loop flags the graph reads
        self._graph = ctypes.c_void_p()
        self._exec = ctypes.c_void_p()
        self._open = None
        # the graphs being filled: the top graph, then each open loop's
        # body, each with its last node and its node count
        self._stack: list = []
        # (the clock's index, the replay's number) of the last replay
        self.last_replay: tuple[int, int] | None = None
        self._check(self._lib.hitl_loop_graph_new(ctypes.byref(self._graph)),
                    "graph create")
        if getattr(_local, "capture", None) is not None:
            raise RuntimeError("LoopGraph: captures do not nest")
        with _capture_lock, span(label + ".capture"):
            if clock and self.device.index not in _calibration:
                calibrate(self.device)
            self.clock = StageClock(self.device, label) if clock else None
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                _local.capture = self
                try:
                    self._push(self._graph)
                    self._clock_node(0)
                    self._begin()
                    self.outputs = fn()
                    self._end()
                    self._clock_node(1)
                    self._pop()
                except BaseException:
                    self._abort()
                    raise
                finally:
                    _local.capture = None
            self._check(self._lib.hitl_loop_instantiate(
                self._graph, ctypes.byref(self._exec)), "graph instantiate")
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
            self.capture_ms = (time.perf_counter() - t0) * 1e3
            self.pool_mib = (torch.cuda.memory_reserved(self.device)
                             - reserved) / 2 ** 20
        self.level_nodes = dict(sorted(self.level_nodes.items()))

    # -- capture -----------------------------------------------------------

    def _check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self._lib.hitl_cuda_error_string(code).decode()
            raise RuntimeError(f"LoopGraph {what}: CUDA error {code} ({msg})")

    def _clock_ptr(self) -> int:
        return self.clock.buf.data_ptr() if self.clock is not None else 0

    def _clock_node(self, end: int) -> None:
        """The clock's begin (end = 0) or end node, appended to the top
        graph."""
        if self.clock is None:
            return
        level = self._stack[-1]
        self._check(self._lib.hitl_loop_add_clock(
            level[0], ctypes.byref(level[1]), self._clock_ptr(), end),
            "add clock node")
        level[2] += 1
        self.nodes += 1

    def _push(self, graph: ctypes.c_void_p) -> None:
        self._stack.append([graph, ctypes.c_void_p(), 0])

    def _pop(self) -> list:
        level = self._stack.pop()
        depth = len(self._stack)
        self.level_nodes[depth] = self.level_nodes.get(depth, 0) + level[2]
        return level

    def _begin(self) -> None:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._open = g

    def _close(self) -> tuple[ctypes.c_void_p, int]:
        """End the open capture; its graph and node count."""
        g, self._open = self._open, None
        with warnings.catch_warnings():
            # a piece may be empty (nothing between two loops)
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            g.capture_end()
        self._pieces.append(g)
        raw = ctypes.c_void_p(g.raw_cuda_graph())
        n = ctypes.c_ulonglong()
        self._check(self._lib.hitl_loop_graph_nodes(raw, ctypes.byref(n)),
                    "node count")
        self.nodes += n.value
        return raw, n.value

    def _end(self) -> int:
        """Close the open piece and append it to the innermost open graph;
        its node count."""
        raw, n = self._close()
        if n:
            level = self._stack[-1]
            code = self._lib.hitl_loop_append(level[0], ctypes.byref(level[1]),
                                              raw)
            if code != 0:
                where = ("the top graph" if len(self._stack) == 1
                         else f"a loop body at depth {len(self._stack) - 1}")
                self._check(code, f"append to {where} (the piece's nodes by "
                                  f"type: {self.node_types(raw)})")
            level[2] += n
        return n

    def _abort(self) -> None:
        if self._open is not None:
            try:
                self._open.capture_end()
            except RuntimeError:
                pass
            self._open = None

    def loop(self, cond: Tensor, body: Callable[[], None],
             max_trips: int, name: str = "loop") -> None:
        """Close the open piece, add the WHILE node to the innermost open
        graph, capture one trip into its body (a loop inside the trip
        nests there), close the body with its test and open the piece
        after the loop (device_while's capture). Both tests mark the clock
        with `name`."""
        dev = cond.device
        mark = self.clock.mark(name) if self.clock is not None else 0
        trips = torch.zeros((), dtype=torch.int32, device=dev)
        go = torch.logical_and(cond, trips < max_trips)
        self._keep += [trips, go]
        self._end()
        outer = self._stack[-1]
        inner = ctypes.c_void_p()
        handle = ctypes.c_ulonglong()
        self._check(self._lib.hitl_loop_add_while(
            outer[0], ctypes.byref(outer[1]), go.data_ptr(),
            ctypes.byref(inner), ctypes.byref(handle), self._clock_ptr(),
            mark), "add while")
        outer[2] += 2
        self.nodes += 2
        k = len(self.body_nodes)
        self.body_nodes.append(0)
        self.levels.append(len(self._stack))
        self._push(inner)
        self._begin()
        body()
        trips.add_(1)
        torch.logical_and(cond, trips < max_trips, out=go)
        self._end()
        level = self._stack[-1]
        self._check(self._lib.hitl_loop_close_body(
            level[0], level[1], handle, go.data_ptr(), self._clock_ptr(),
            mark), "close body")
        level[2] += 1
        self.nodes += 1
        self._pop()
        # this loop's own pieces: the body's nodes less its closing test
        # and the nodes its inner loops added there
        inner_frames = 2 * sum(1 for d in self.levels[k + 1:]
                               if d == self.levels[k] + 1)
        self.body_nodes[k] = level[2] - 1 - inner_frames
        self._begin()

    def node_types(self, graph) -> dict[int, int] | str:
        """The nodes of a captured piece (a raw cudaGraph_t) by
        cudaGraphNodeType, for an error message (the error's text if they
        cannot be read)."""
        counts = (ctypes.c_ulonglong * 16)()
        code = self._lib.hitl_loop_node_types(graph, counts, 16)
        if code != 0:
            return self._lib.hitl_cuda_error_string(code).decode()
        return {t: int(c) for t, c in enumerate(counts) if c}

    # -- replay ------------------------------------------------------------

    def replay(self) -> None:
        """Run the graph on the current stream; `last_replay` names the
        replay in its clock's ring."""
        self._check(self._lib.hitl_loop_launch(
            self._exec, torch.cuda.current_stream(self.device).cuda_stream),
            "launch")
        if self.clock is not None:
            self.last_replay = (self.clock.index, self.clock.launches)
            self.clock.launches += 1

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and (self._exec.value or self._graph.value):
            lib.hitl_loop_destroy(self._graph, self._exec)
            self._graph = self._exec = ctypes.c_void_p()


# -- programs: a function of static inputs, captured once ---------------------

def _map(fn, tree, *rest):
    """fn applied to each tensor of `tree` (a tensor, a tuple or list, a
    dataclass of them, nested) and the leaves in the same places of
    `rest`, rebuilt in tree's shape; other leaves are kept."""
    if isinstance(tree, Tensor):
        return fn(tree, *rest)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, *xs) for xs in zip(tree, *rest,
                                                      strict=True))
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _map(fn, getattr(tree, f.name),
                                          *(getattr(r, f.name) for r in rest))
                             for f in dataclasses.fields(tree)})
    return tree


def static_like(tree, device):
    """Contiguous buffers on `device` shaped as the tensors of `tree`."""
    return _map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
                tree)


def load_into(dst, src) -> None:
    """Copy the tensors of `src` into the like-placed buffers of `dst`
    (static_like's tree): device to device, or host to device; a Python
    number fills its buffer."""
    _map(lambda d, s: d.copy_(s) if isinstance(s, Tensor) else d.fill_(s),
         dst, src)


def clone_tree(tree):
    """A copy of the tensors of `tree` that no later replay overwrites."""
    return _map(torch.clone, tree)


def signature(tree) -> tuple:
    """The shapes and dtypes of `tree`'s tensors and its other leaves: what
    a program captured for it needs of the next inputs."""
    if isinstance(tree, Tensor):
        return (tuple(tree.shape), tree.dtype)
    if isinstance(tree, (tuple, list)):
        return tuple(signature(x) for x in tree)
    if dataclasses.is_dataclass(tree):
        return tuple(signature(getattr(tree, f.name))
                     for f in dataclasses.fields(tree))
    return (tree,)


def replays(t: Tensor, eager: bool = False) -> bool:
    """Whether an entry point given `t` replays its program: on a CUDA
    device, unless the caller asks for eager execution or a capture is
    open (the entry point is then part of that capture)."""
    return (t.device.type == "cuda" and not eager
            and not torch.cuda.is_current_stream_capturing())


class DeviceProgram:
    """`fn` as a device program on a CUDA device: static input buffers
    shaped as `example` (static_like), and `LoopGraph`s of `fn` on them,
    each captured at its first use, all in the program's own memory pool
    and on its own stream. A program holds one graph by `key`: the graph
    of key None captures `fn(*inputs)`, that of any other key `fn(*inputs,
    key)` (the cycle keeps one a correction type). `run` copies its inputs
    into the buffers, replays a graph on the current stream, and returns a
    copy of its outputs that later replays leave alone. Uses go one at a
    time (`turn`), each after the last on whatever stream it ran. A failed
    capture or replay raises; nothing runs eagerly instead.

    `warm()`, if given, runs on the program's stream before a capture:
    what a library makes at its first call on a stream (a handle, a
    workspace) is made there, outside the graph. Each graph records its
    capture (LoopGraph's `capture_ms`, `nodes`, `body_nodes`, `levels`,
    `level_nodes`, `pool_mib`). With `clock` each graph carries a stage
    clock labelled `name`; `name` also labels the spans of `run`:
    `<name>.load`, `<name>.launch` (which carries the replay's place in its
    clock's ring, None without a clock) and `<name>.copy_out`."""

    def __init__(self, fn: Callable, example, device,
                 warm: Callable[[], None] | None = None,
                 name: str = "program", clock: bool = False):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"a device program runs on a CUDA device, not "
                             f"{dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.name = name
        self.clock = clock
        self.fn = fn
        self.inputs = static_like(example, dev)
        self._warm = warm
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)
        self.graphs: dict = {}
        self.lock = threading.Lock()
        self._done = None     # event after the last use and its copies

    def graph(self, key=None) -> LoopGraph:
        """The graph of `key`, captured now if it is the first use."""
        g = self.graphs.get(key)
        if g is not None:
            return g
        dev = self.device
        cuda_build.prepare_counters(dev)
        with torch.cuda.stream(self.stream):
            a = torch.ones((2, 2, 2), device=dev)
            torch.bmm(a, a)
            a[0] @ a[0]
            if self._warm is not None:
                self._warm()
        args = self.inputs if key is None else (*self.inputs, key)
        g = LoopGraph(lambda: self.fn(*args), dev, pool=self.pool,
                      stream=self.stream, label=self.name, clock=self.clock)
        self.graphs[key] = g
        return g

    def replay(self, key=None):
        """Replay the graph of `key` on the loaded inputs (capturing it
        first at its first use): its outputs, in the graph's memory, which
        the next replay overwrites."""
        g = self.graph(key)
        g.replay()
        return g.outputs

    @contextmanager
    def turn(self):
        """Hold the program for one use on the current stream: after the
        last use, whatever stream it ran on, and alone."""
        with self.lock:
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            yield
            self._done = torch.cuda.Event()
            self._done.record(stream)

    def run(self, *inputs, key=None):
        """Load `inputs`, replay the graph of `key`, and return a copy of
        its outputs."""
        with self.turn():
            with span(self.name + ".load"):
                load_into(self.inputs, inputs)
            with span(self.name + ".launch") as launch:
                outputs = self.replay(key)
                launch.args = self.graphs[key].last_replay
            with span(self.name + ".copy_out"):
                return clone_tree(outputs)


class ProgramCache:
    """Programs by key, the least recently used beyond `size` dropped (each
    holds its graphs' memory). Thread-safe."""

    def __init__(self, size: int = 4):
        self.size = size
        self._programs: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key, make: Callable[[], DeviceProgram]) -> DeviceProgram:
        with self._lock:
            prog = self._programs.pop(key, None)
            if prog is None:
                prog = make()
            self._programs[key] = prog
            while len(self._programs) > self.size:
                self._programs.popitem(last=False)
        return prog
