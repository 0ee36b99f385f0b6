"""The correction cycle: verify -> world transform -> EM endpoint refit ->
inlier counts -> ordering -> explicit correction -> constraint rows ->
backprop -> joint LM solve.

Port of hitl_slam_tpu/models/hitl/cycle.py (`cycle_step`, `queue_chain`).
The correction type is host-known, so the reference's `lax.cond` on it
becomes a Python branch; everything data-dependent (validity, ordering,
backprop bounds, the table write cursor) stays on the device and gates the
state update there. Invalid or unverified inputs leave the state as it
was; the solve still runs for them, as in the reference.

Run eagerly (`cycle_step`; the CPU path, and on the card where a caller
asks for it by name), a cycle reads the host only at the exit tests of its
EM refit and LM loops (utils/device_loop.py::device_while: one flag a round
and an iteration). On the card the engine runs `CycleProgram`: the
reference's one compiled program per cycle becomes one CUDA graph per
correction type, captured with `LoopGraph`, in which both loops are WHILE
nodes; a replay reads nothing back. `queue_chain` on the card runs K
replays with the carry selected on the device between them, so a chain
reads the host only where its caller reads the result, as the reference's
`lax.scan` chain does.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, fields

import torch

from ...core.state import ConstraintTable, CorrectionType
from ...ops import em_scan as em_scan_kernel
from ...ops.em_scan import em_scan
from ...ops.geometry import pose_to_world
from ...solver import bcr_kernel
from ...solver.joint import build_problem
from ...solver.lm import LMConfig, LMResult, solve as lm_solve
from ...utils.device_loop import LoopGraph
from . import em_input
from .backprop import backprop
from .explicit import apply_explicit, constraint_deltas
from .ordering import MIN_POSE_INLIERS, order_on_device
from .repair import _scatter_constraints, _wrap_theta

Tensor = torch.Tensor


@dataclass(frozen=True)
class CycleOutput:
    poses: Tensor
    covariances: Tensor
    constraints: ConstraintTable
    verified: Tensor             # scalar bool: all clicked points near map
    order_valid: Tensor          # scalar bool: ordering/backprop bounds OK
    num_new_constraints: Tensor  # scalar int32
    refit_sel: Tensor            # [4,2] EM-refit (and possibly swapped) points
    lm_iterations: Tensor
    lm_initial_cost: Tensor
    lm_final_cost: Tensor
    lm_final_mu: Tensor          # damping at exit (chain warm-start source)
    pre_solve_poses: Tensor


def cycle_step(
    points: Tensor,        # [P,N,2] robot frame
    point_mask: Tensor,    # [P,N]
    poses: Tensor,         # [P,3]
    covariances: Tensor,   # [P,3,3]
    constraints: ConstraintTable,
    ctype: int,            # CorrectionType value
    sel_raw: Tensor,       # [4,2] clicked points, world frame
    write_offset,          # int or scalar int tensor
    lm_config: LMConfig = LMConfig(),
    odom_inv_sigma: Tensor | None = None,  # [P-1,3] loop-closure weighting
    mu0: Tensor | None = None,             # warm-start damping
) -> CycleOutput:
    """One correction cycle, run eagerly."""
    return cycle_solve(points, point_mask, poses, covariances, constraints,
                       ctype, sel_raw, write_offset, lm_config,
                       odom_inv_sigma, mu0)[0]


def cycle_solve(
    points: Tensor,        # [P,N,2] robot frame
    point_mask: Tensor,    # [P,N]
    poses: Tensor,         # [P,3]
    covariances: Tensor,   # [P,3,3]
    constraints: ConstraintTable,
    ctype: int,            # CorrectionType value
    sel_raw: Tensor,       # [4,2] clicked points, world frame
    write_offset,          # int or scalar int tensor
    lm_config: LMConfig = LMConfig(),
    odom_inv_sigma: Tensor | None = None,  # [P-1,3] loop-closure weighting
    mu0: Tensor | None = None,             # warm-start damping
) -> tuple[CycleOutput, LMResult, Tensor]:
    """cycle_step's cycle, its LM solve's own result (whose iteration
    count is that of every solve, valid or not: BCR launches once an
    iteration) and em_scan's per-pose inlier counts of the refit
    selections ([P, 2] int32)."""
    ctype = int(ctype)
    world = pose_to_world(poses[:, None, :], points)

    # POINT selections are degenerate segments [p,p,q,q]; CORNER drags are
    # anchored at a feature vertex: neither gets the segment refit
    is_point = ctype == int(CorrectionType.POINT)
    is_corner = ctype == int(CorrectionType.CORNER)

    # --- verification: em_scan's minima ---
    _, min_d2 = em_scan(world, point_mask, sel_raw)
    degenerate = (torch.all(sel_raw[0] == sel_raw[1])
                  | torch.all(sel_raw[2] == sel_raw[3]))
    verified = torch.all(min_d2 < em_input.VERIFY_THRESHOLD ** 2)
    if not is_point:
        verified = verified & ~degenerate

    # --- EM: refit both sketched segments, then count inliers ---
    if is_point or is_corner:
        refit = sel_raw
    else:
        segs = em_input.endpoint_adjust_batch(
            world, point_mask, torch.stack([sel_raw[0:2], sel_raw[2:4]]))
        refit = segs.reshape(4, 2)
    # POINT selections count inliers in the wider verify-radius disc
    threshold = (em_input.VERIFY_THRESHOLD if is_point
                 else em_input.INLIER_THRESHOLD)
    counts, _ = em_scan(world, point_mask, refit.contiguous(),
                        inlier_threshold=threshold)

    # --- ordering / filtering ---
    o = order_on_device(counts[:, 0], counts[:, 1], refit,
                        min_inliers=0 if is_point else MIN_POSE_INLIERS)
    valid = verified & o.valid

    # --- explicit correction + constraint targets ---
    poses1, C = apply_explicit(poses, ctype, o.sel, o.group_mask, o.last_pose)
    dpar, dperp, dth, pen, pair_valid = constraint_deltas(
        poses1, o.sel, o.anchor_idx, o.corrected_idx)
    table, n_new = _scatter_constraints(
        constraints, ctype, o.anchor_idx, o.corrected_idx,
        dpar, dperp, dth, pen, pair_valid & valid, write_offset)

    # --- backprop + angle wrap ---
    poses2, cov2 = backprop(poses1, covariances, C, o.bp_min, o.bp_max)
    poses2 = _wrap_theta(poses2)

    # --- joint LM solve over odometry + all human factors ---
    problem = build_problem(poses2, table, odom_inv_sigma=odom_inv_sigma)
    lm = lm_solve(problem, poses2, lm_config, mu0=mu0)
    poses3 = _wrap_theta(lm.poses)

    # --- gate the state update on validity ---
    zero = torch.zeros((), dtype=torch.int32, device=poses.device)
    out = CycleOutput(
        poses=torch.where(valid, poses3, poses),
        covariances=torch.where(valid, cov2, covariances),
        constraints=table,
        verified=verified,
        order_valid=o.valid,
        num_new_constraints=torch.where(valid, n_new, zero),
        refit_sel=o.sel,
        lm_iterations=torch.where(valid, lm.iterations, zero),
        lm_initial_cost=lm.initial_cost,
        lm_final_cost=lm.final_cost,
        lm_final_mu=lm.final_mu,
        pre_solve_poses=poses2,
    )
    return out, lm, counts


def _select_table(ok: Tensor, a: ConstraintTable,
                  b: ConstraintTable) -> ConstraintTable:
    return ConstraintTable(**{
        name: torch.where(ok, getattr(a, name), getattr(b, name))
        for name in ConstraintTable.__dataclass_fields__
    })


def clone_output(out: CycleOutput) -> CycleOutput:
    """A copy of `out` that no later replay overwrites."""
    return CycleOutput(**{
        f.name: (ConstraintTable(**{k: v.clone()
                                    for k, v in vars(out.constraints).items()})
                 if f.name == "constraints" else getattr(out, f.name).clone())
        for f in fields(CycleOutput)})


class CycleProgram:
    """The correction cycle as a device program on a CUDA device, for one
    map's shapes ([P, N] points), constraint capacity, LMConfig, odometry
    weighting (`odom_sigma`: whether a [P-1, 3] odom_inv_sigma is given)
    and warm start (`warm_start`: the solve starts from the damping in
    `mu`).

    It holds static inputs (the map's points and mask, poses, covariances,
    the constraint table, the selection, the write cursor `n` and `mu`)
    and one `LoopGraph` of `cycle_solve` on them for each correction type,
    captured at its first use, all in one memory pool and on one stream;
    the EM refit and the LM solve are WHILE nodes, so a replay reads
    nothing back. A replay's outputs live in the graph's memory and the
    next replay overwrites them: callers clone what they keep. Replays run
    one at a time (`lock`), each after the last on whatever stream it
    ran. A failed capture or replay raises; nothing runs eagerly instead.

    `capture_ms`, `nodes` and `pool_mib` record each capture: its host
    time, the graph's nodes, and the device memory the capture reserved."""

    def __init__(self, P: int, N: int, capacity: int, lm_config: LMConfig,
                 odom_sigma: bool, warm_start: bool, device):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"CycleProgram runs on a CUDA device, not {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.lm_config = lm_config
        self.warm_start = warm_start
        f32 = torch.float32
        self.points = torch.zeros((P, N, 2), dtype=f32, device=dev)
        self.point_mask = torch.zeros((P, N), dtype=torch.bool, device=dev)
        self.poses = torch.zeros((P, 3), dtype=f32, device=dev)
        self.covariances = torch.zeros((P, 3, 3), dtype=f32, device=dev)
        self.table = ConstraintTable.empty(capacity, dev)
        self.sel = torch.zeros((4, 2), dtype=f32, device=dev)
        self.n = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = torch.full((), lm_config.initial_mu, dtype=f32, device=dev)
        self.odom_inv_sigma = (torch.ones((P - 1, 3), dtype=f32, device=dev)
                               if odom_sigma else None)
        self.ticket = em_scan_kernel.new_ticket(dev)
        for counter in (em_scan_kernel.launches, bcr_kernel.launches):
            counter.prepare(dev)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(dev)
        self.graphs: dict[int, LoopGraph] = {}
        self.capture_ms: dict[int, float] = {}
        self.nodes: dict[int, int] = {}
        self.pool_mib: dict[int, float] = {}
        self.lock = threading.Lock()
        self._done = None     # event after the last replay and its reads

    # -- inputs --------------------------------------------------------------

    def load(self, points: Tensor, point_mask: Tensor, poses: Tensor,
             covariances: Tensor, constraints: ConstraintTable, n,
             odom_inv_sigma: Tensor | None = None) -> None:
        """Copy a cycle's inputs into the static buffers (device to device;
        `n` a Python int or a scalar tensor) and set `mu` to the config's
        initial damping."""
        self.points.copy_(points)
        self.point_mask.copy_(point_mask)
        self.poses.copy_(poses)
        self.covariances.copy_(covariances)
        for name, buf in vars(self.table).items():
            buf.copy_(getattr(constraints, name))
        if isinstance(n, Tensor):
            self.n.copy_(n)
        else:
            self.n.fill_(int(n))
        self.mu.fill_(self.lm_config.initial_mu)
        if (odom_inv_sigma is None) != (self.odom_inv_sigma is None):
            raise ValueError("CycleProgram: odom_inv_sigma given to a program "
                             "made without it, or the reverse")
        if odom_inv_sigma is not None:
            self.odom_inv_sigma.copy_(odom_inv_sigma)

    # -- capture and replay ----------------------------------------------------

    def _capture(self, ctype: int) -> LoopGraph:
        dev = self.device

        def run():
            return cycle_solve(
                self.points, self.point_mask, self.poses, self.covariances,
                self.table, ctype, self.sel, self.n,
                lm_config=self.lm_config, odom_inv_sigma=self.odom_inv_sigma,
                mu0=self.mu if self.warm_start else None)

        # what PyTorch makes at a library's first call on a stream (the
        # cuBLAS handle and its workspace) is made here, outside the graph
        with torch.cuda.stream(self.stream):
            a = torch.ones((2, 2, 2), device=dev)
            torch.bmm(a, a)
            a[0] @ a[0]
        reserved = torch.cuda.memory_reserved(dev)
        with em_scan_kernel.capture_ticket(self.ticket):
            g = LoopGraph(run, dev, pool=self.pool, stream=self.stream)
        self.capture_ms[ctype] = g.capture_ms
        self.nodes[ctype] = g.nodes
        self.pool_mib[ctype] = (torch.cuda.memory_reserved(dev)
                                - reserved) / 2 ** 20
        self.graphs[ctype] = g
        return g

    def graph(self, ctype: int) -> LoopGraph:
        """The graph of `ctype`, captured now if it is the first use."""
        g = self.graphs.get(int(ctype))
        return g if g is not None else self._capture(int(ctype))

    def replay(self, ctype: int) -> CycleOutput:
        """Replay the cycle of `ctype` on the loaded inputs (capturing it
        first at its first use); the graph's outputs."""
        g = self.graph(ctype)
        g.replay()
        return g.outputs[0]

    def solve_iterations(self, ctype: int) -> Tensor:
        """The LM iterations of the last replay of `ctype` (every solve's,
        valid or not), in the graph's memory."""
        return self.graphs[int(ctype)].outputs[1].iterations

    def _enter(self) -> torch.cuda.Stream:
        stream = torch.cuda.current_stream(self.device)
        if self._done is not None:
            stream.wait_event(self._done)
        return stream

    def _leave(self, stream) -> None:
        self._done = torch.cuda.Event()
        self._done.record(stream)

    def run(self, ctype: int, points: Tensor, point_mask: Tensor,
            poses: Tensor, covariances: Tensor, constraints: ConstraintTable,
            sel: Tensor, n,
            odom_inv_sigma: Tensor | None = None) -> CycleOutput:
        """One cycle as a replay, on the current stream: load, replay, and
        a copy of the outputs that later replays leave alone."""
        with self.lock:
            stream = self._enter()
            self.load(points, point_mask, poses, covariances, constraints, n,
                      odom_inv_sigma)
            self.sel.copy_(sel)
            out = clone_output(self.replay(ctype))
            self._leave(stream)
        return out

    def chain(self, ctypes, sels: Tensor, points: Tensor, point_mask: Tensor,
              poses: Tensor, covariances: Tensor, constraints: ConstraintTable,
              n0, odom_inv_sigma: Tensor | None = None):
        """queue_chain on the device: K replays, the carry selected on the
        device between them, nothing read back. Returns queue_chain's
        tuple, copies that later replays leave alone."""
        with self.lock:
            stream = self._enter()
            self.load(points, point_mask, poses, covariances, constraints, n0,
                      odom_inv_sigma)
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            ys = []
            for k, ctype in enumerate(ctypes):
                self.sel.copy_(sels[k])
                out = self.replay(int(ctype))
                ok = (out.verified & out.order_valid
                      & torch.isfinite(out.lm_final_cost))
                n_new = torch.where(ok, out.num_new_constraints, zero)
                ys.append((ok, out.verified.clone(), out.order_valid.clone(),
                           n_new, out.lm_iterations.clone(),
                           out.lm_initial_cost.clone(),
                           out.lm_final_cost.clone()))
                self.poses.copy_(torch.where(ok, out.poses, self.poses))
                self.covariances.copy_(
                    torch.where(ok, out.covariances, self.covariances))
                for name, buf in vars(self.table).items():
                    buf.copy_(torch.where(ok, getattr(out.constraints, name),
                                          buf))
                self.mu.copy_(torch.where(ok, out.lm_final_mu, self.mu))
                self.n.add_(n_new)
            per_cycle = (tuple(torch.stack(col) for col in zip(*ys))
                         if ys else ())
            result = (self.poses.clone(), self.covariances.clone(),
                      ConstraintTable(**{k: v.clone() for k, v
                                         in vars(self.table).items()}),
                      self.n.clone(), per_cycle)
            self._leave(stream)
        return result


_programs: OrderedDict = OrderedDict()
_programs_lock = threading.Lock()
MAX_PROGRAMS = 4     # programs kept (each holds its graphs' memory)


def cycle_program(points: Tensor, capacity: int, lm_config: LMConfig,
                  odom_sigma: bool, warm_start: bool) -> CycleProgram:
    """The CycleProgram of a map with `points` ([P, N, 2] on a CUDA device)
    and these settings: the one made before, or a new one; the least
    recently used beyond MAX_PROGRAMS are dropped."""
    P, N = points.shape[0], points.shape[1]
    dev = points.device
    key = (P, N, int(capacity), lm_config, bool(odom_sigma),
           bool(warm_start), dev.type, dev.index)
    with _programs_lock:
        prog = _programs.pop(key, None)
        if prog is None:
            prog = CycleProgram(P, N, capacity, lm_config, odom_sigma,
                                warm_start, dev)
        _programs[key] = prog
        while len(_programs) > MAX_PROGRAMS:
            _programs.popitem(last=False)
    return prog


def queue_chain(
    points: Tensor,
    point_mask: Tensor,
    poses: Tensor,
    covariances: Tensor,
    constraints: ConstraintTable,
    ctypes,                # [K] host ints, per-cycle correction types
    sels: Tensor,          # [K,4,2] per-cycle clicked points (world frame)
    n0,                    # int or scalar int tensor: table write cursor
    lm_config: LMConfig = LMConfig(),
    odom_inv_sigma: Tensor | None = None,
    warm_start_mu: bool = False,
):
    """K correction cycles in sequence, carried on the device.

    A cycle's outputs are adopted only when it verified, ordered, and solved
    finite; otherwise the carried poses, covariances and table stay as they
    were (the table drops the rows the rejected cycle wrote). With
    `warm_start_mu`, an accepted cycle's exit damping seeds the next solve.

    On a CUDA device the chain is K replays of the map's CycleProgram, with
    the carry selected on the device between them: it reads nothing back
    (tests/test_torch_device_program.py, chip_smoke.py phase 19 count its
    host reads). On the CPU each cycle runs eagerly, with its loops' exit
    tests as its host reads.

    Returns (poses, covariances, constraints, n_end, per_cycle) where
    per_cycle stacks [K] tensors: (accepted, verified, order_valid, n_new,
    lm_iterations, lm_initial_cost, lm_final_cost).
    """
    if poses.device.type == "cuda":
        prog = cycle_program(points, constraints.capacity, lm_config,
                             odom_inv_sigma is not None, warm_start_mu)
        return prog.chain(ctypes, sels, points, point_mask, poses,
                          covariances, constraints, n0, odom_inv_sigma)
    return queue_chain_eager(points, point_mask, poses, covariances,
                             constraints, ctypes, sels, n0, lm_config,
                             odom_inv_sigma, warm_start_mu)


def queue_chain_eager(points, point_mask, poses, covariances, constraints,
                      ctypes, sels, n0, lm_config: LMConfig = LMConfig(),
                      odom_inv_sigma: Tensor | None = None,
                      warm_start_mu: bool = False):
    """queue_chain with every cycle run eagerly by cycle_step: the CPU's
    chain, and on a card only where a caller asks for it by name."""
    dev = poses.device
    n = (n0.to(device=dev, dtype=torch.int32) if isinstance(n0, Tensor)
         else torch.full((), int(n0), dtype=torch.int32, device=dev))
    mu = torch.full((), lm_config.initial_mu, dtype=poses.dtype, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    ys = []
    for k, ctype in enumerate(ctypes):
        out = cycle_step(points, point_mask, poses, covariances, constraints,
                         int(ctype), sels[k], n, lm_config=lm_config,
                         mu0=mu if warm_start_mu else None,
                         odom_inv_sigma=odom_inv_sigma)
        ok = (out.verified & out.order_valid
              & torch.isfinite(out.lm_final_cost))
        poses = torch.where(ok, out.poses, poses)
        covariances = torch.where(ok, out.covariances, covariances)
        constraints = _select_table(ok, out.constraints, constraints)
        n_new = torch.where(ok, out.num_new_constraints, zero)
        mu = torch.where(ok, out.lm_final_mu, mu)
        n = n + n_new
        ys.append((ok, out.verified, out.order_valid, n_new,
                   out.lm_iterations, out.lm_initial_cost, out.lm_final_cost))
    per_cycle = tuple(torch.stack(col) for col in zip(*ys)) if ys else ()
    return poses, covariances, constraints, n, per_cycle
