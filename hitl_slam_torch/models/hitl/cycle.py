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

from dataclasses import dataclass

import torch

from ...core.state import ConstraintTable, CorrectionType
from ...ops import em_scan as em_scan_kernel
from ...ops.em_scan import em_scan
from ...ops.geometry import pose_to_world
from ...solver.joint import build_problem
from ...solver.lm import LMConfig, LMResult, solve as lm_solve
from ...utils.device_loop import (DeviceProgram, ProgramCache, clone_tree,
                                  load_into, stage_mark)
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
    stage_mark("backprop")
    poses2, cov2 = backprop(poses1, covariances, C, o.bp_min, o.bp_max)
    poses2 = _wrap_theta(poses2)

    # --- joint LM solve over odometry + all human factors ---
    stage_mark("build_problem")
    problem = build_problem(poses2, table, odom_inv_sigma=odom_inv_sigma)
    # part of the cycle's program when captured, and eager with an eager
    # cycle (never a program of its own)
    lm = lm_solve(problem, poses2, lm_config, mu0=mu0, eager=True)
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
    return clone_tree(out)


class CycleProgram(DeviceProgram):
    """The correction cycle as a device program on a CUDA device, for one
    map's shapes ([P, N] points), constraint capacity, LMConfig, odometry
    weighting (`odom_sigma`: whether a [P-1, 3] odom_inv_sigma is given)
    and warm start (`warm_start`: the solve starts from the damping in
    `mu`).

    Its static inputs are the map's points and mask, poses, covariances,
    the constraint table, the selection, the write cursor `n`, `mu` and
    odom_inv_sigma; it keeps one graph of `cycle_solve` on them for each
    correction type (DeviceProgram's key), each captured at its first use,
    all in one memory pool and on one stream. The EM refit and the LM
    solve are WHILE nodes, so a replay reads nothing back. `replay(ctype)`
    gives the CycleOutput in the graph's memory, which the next replay
    overwrites; `run` and `chain` return copies."""

    def __init__(self, P: int, N: int, capacity: int, lm_config: LMConfig,
                 odom_sigma: bool, warm_start: bool, device):
        f32 = torch.float32
        example = (torch.empty((P, N, 2), dtype=f32),
                   torch.empty((P, N), dtype=torch.bool),
                   torch.empty((P, 3), dtype=f32),
                   torch.empty((P, 3, 3), dtype=f32),
                   ConstraintTable.empty(capacity, "cpu"),
                   torch.empty((4, 2), dtype=f32),
                   torch.empty((), dtype=torch.int32),
                   torch.empty((), dtype=f32),
                   torch.empty((P - 1, 3), dtype=f32) if odom_sigma else None)

        def solve(points, point_mask, poses, covariances, table, sel, n, mu,
                  odom_inv_sigma, ctype):
            with em_scan_kernel.capture_ticket(self.ticket):
                return cycle_solve(
                    points, point_mask, poses, covariances, table, ctype,
                    sel, n, lm_config=lm_config,
                    odom_inv_sigma=odom_inv_sigma,
                    mu0=mu if warm_start else None)

        super().__init__(solve, example, device, name="hitl", clock=True)
        self.lm_config = lm_config
        self.odom_sigma = odom_sigma
        self.ticket = em_scan_kernel.new_ticket(self.device)

    def replay(self, ctype: int) -> CycleOutput:
        """Replay the cycle of `ctype` on the loaded inputs (capturing it
        first at its first use); the graph's CycleOutput."""
        return super().replay(int(ctype))[0]

    def solve_iterations(self, ctype: int) -> Tensor:
        """The LM iterations of the last replay of `ctype` (every solve's,
        valid or not), in the graph's memory."""
        return self.graphs[int(ctype)].outputs[1].iterations

    def _inputs(self, points, point_mask, poses, covariances, constraints,
                sel, n, odom_inv_sigma) -> tuple:
        """run's inputs for DeviceProgram, `mu` the config's initial
        damping; a host selection (an array) is copied into its buffer
        directly."""
        if (odom_inv_sigma is None) == self.odom_sigma:
            raise ValueError("CycleProgram: odom_inv_sigma given to a program "
                             "made without it, or the reverse")
        return (points, point_mask, poses, covariances, constraints,
                torch.as_tensor(sel, dtype=torch.float32), n,
                self.lm_config.initial_mu, odom_inv_sigma)

    def run(self, ctype: int, points: Tensor, point_mask: Tensor,
            poses: Tensor, covariances: Tensor, constraints: ConstraintTable,
            sel: Tensor, n,
            odom_inv_sigma: Tensor | None = None) -> CycleOutput:
        """One cycle as a replay, on the current stream (`n` a Python int
        or a scalar tensor, `sel` a tensor or a host array): load, replay,
        and a copy of the outputs that later replays leave alone."""
        return super().run(
            *self._inputs(points, point_mask, poses, covariances,
                          constraints, sel, n, odom_inv_sigma),
            key=int(ctype))

    def chain(self, ctypes, sels: Tensor, points: Tensor, point_mask: Tensor,
              poses: Tensor, covariances: Tensor, constraints: ConstraintTable,
              n0, odom_inv_sigma: Tensor | None = None):
        """queue_chain on the device: K replays, the carry selected on the
        device between them, nothing read back. Returns queue_chain's
        tuple, copies that later replays leave alone."""
        _, _, poses_c, covs_c, table_c, sel_c, n_c, mu_c, _ = self.inputs
        with self.turn():
            load_into(self.inputs, self._inputs(
                points, point_mask, poses, covariances, constraints,
                sel_c, n0, odom_inv_sigma))
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            ys = []
            for k, ctype in enumerate(ctypes):
                sel_c.copy_(sels[k])
                out = self.replay(int(ctype))
                ok = (out.verified & out.order_valid
                      & torch.isfinite(out.lm_final_cost))
                n_new = torch.where(ok, out.num_new_constraints, zero)
                ys.append((ok, out.verified.clone(), out.order_valid.clone(),
                           n_new, out.lm_iterations.clone(),
                           out.lm_initial_cost.clone(),
                           out.lm_final_cost.clone()))
                poses_c.copy_(torch.where(ok, out.poses, poses_c))
                covs_c.copy_(torch.where(ok, out.covariances, covs_c))
                for name, buf in vars(table_c).items():
                    buf.copy_(torch.where(ok, getattr(out.constraints, name),
                                          buf))
                mu_c.copy_(torch.where(ok, out.lm_final_mu, mu_c))
                n_c.add_(n_new)
            per_cycle = (tuple(torch.stack(col) for col in zip(*ys))
                         if ys else ())
            return (poses_c.clone(), covs_c.clone(), clone_tree(table_c),
                    n_c.clone(), per_cycle)


_programs = ProgramCache()     # each program holds its graphs' memory


def cycle_program(points: Tensor, capacity: int, lm_config: LMConfig,
                  odom_sigma: bool, warm_start: bool) -> CycleProgram:
    """The CycleProgram of a map with `points` ([P, N, 2] on a CUDA device)
    and these settings: the one made before, or a new one; the least
    recently used beyond the cache's size are dropped."""
    P, N = points.shape[0], points.shape[1]
    dev = points.device
    key = (P, N, int(capacity), lm_config, bool(odom_sigma),
           bool(warm_start), dev.type, dev.index)
    return _programs.get(key, lambda: CycleProgram(
        P, N, capacity, lm_config, odom_sigma, warm_start, dev))


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
