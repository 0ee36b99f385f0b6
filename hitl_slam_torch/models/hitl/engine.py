"""HitLSLAM session orchestrator (host side).

Port of hitl_slam_tpu/models/hitl/engine.py::HitLSLAM: init / run /
replay_log / run_queue / add_correction_points / undo / getters /
get_cost_breakdown / propose_corrections / post_optimize and speculative
dispatch, with the same
single-depth undo snapshot and the two-click pending-correction state
machine. The numeric cycle runs on the engine's device
(models/hitl/cycle.py); this class holds the state, records history and
undo snapshots, and keeps the constraint-table write cursor. It reads back
six scalars per correction.

Speculative dispatch: when the second drag completes a selection, the whole
cycle for it starts on a worker thread (on a CUDA stream of its own when the
device is a card), so that it computes during the pause before run() is
called. run() takes the result only if the correction type, the selection
bytes, the identity of `state.poses` and the constraint count are those of
the dispatch; anything else waits for the worker, drops its result and runs
the cycle afresh.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from ...core.state import (
    ConstraintTable,
    CorrectionType,
    MapState,
    SingleInput,
    make_map_state,
)
from ...solver.lm import LMConfig
from ...utils.timing import FunctionTimer
from .cycle import CycleOutput, cycle_step, queue_chain


@dataclass
class CycleReport:
    """What happened in one run()/replay cycle."""

    accepted: bool
    reason: str = ""
    points_verified: int = 0
    num_new_constraints: int = 0
    lm_iterations: int = 0
    initial_cost: float = 0.0
    final_cost: float = 0.0
    dropped_rows: int = 0   # constraint rows lost to a full table this cycle
    timings_ms: dict = field(default_factory=dict)


def _read_scalars(*ts) -> list[float]:
    """One device -> host transfer for a handful of scalar tensors."""
    return torch.stack([t.to(torch.float64) for t in ts]).cpu().tolist()


def _report_scalars(out: CycleOutput) -> list[float]:
    return _read_scalars(
        out.verified, out.order_valid, out.num_new_constraints,
        out.lm_iterations, out.lm_initial_cost, out.lm_final_cost)


@dataclass
class _Speculation:
    """One cycle dispatched ahead of run(): what it was dispatched for, the
    worker, and the box the worker leaves its result or its exception in."""

    ctype: int
    sel_bytes: bytes
    poses: torch.Tensor      # the state's pose tensor at dispatch (identity)
    num_constraints: int
    thread: threading.Thread
    box: dict


class HitLSLAM:
    """One interactive map-repair session on `device` (the card unless the
    caller names another)."""

    def __init__(self, lm_config: LMConfig = LMConfig(), *, device="cuda"):
        self.lm_config = lm_config
        self.device = torch.device(device)
        self.state: MapState | None = None
        self.prev_poses = None
        self.prev_covariances = None
        self.prev_num_constraints = 0
        # True iff the snapshot in prev_* belongs to a post_optimize solve
        # (undo then reverts the refine without touching input_history)
        self._undo_is_refine = False
        self.num_constraints = 0
        self.input_history: list[SingleInput] = []
        self.num_completed_cycles = 0
        self.selected_points: list[np.ndarray] = []
        self.pending_type = CorrectionType.UNKNOWN
        self.correction_type = CorrectionType.UNKNOWN
        # speculative dispatch: the cycle starts when the selection is
        # complete, so the device computes during the pause before run()
        self.speculate = True
        self.speculative_hits = 0
        self._speculative: _Speculation | None = None
        self._spec_stream = None     # the worker's CUDA stream, made once
        # the poses the last accepted cycle handed to its LM solve
        self.last_pre_solve_poses = None
        # optional [P-1, 3] per-factor odometry inverse standard deviations
        # (the EnML loop-closure mode weights chain factors by the pose
        # covariance ellipses, not by the fixed noise model)
        self.odom_inv_sigma = None

    # -- lifecycle ---------------------------------------------------------

    def init(self, poses, covariances, point_clouds, normal_clouds,
             odometry=None, constraint_capacity: int = 8192):
        self.state = make_map_state(
            np.asarray(poses), np.asarray(covariances), point_clouds,
            normal_clouds, odometry=odometry,
            constraint_capacity=constraint_capacity, device=self.device,
        )
        self.prev_poses = self.state.poses
        self.prev_covariances = self.state.covariances

    def init_from_state(self, state: MapState):
        self.state = state
        self.prev_poses = state.poses
        self.prev_covariances = state.covariances

    # -- getters -----------------------------------------------------------

    def get_poses(self) -> np.ndarray:
        return self.state.poses.cpu().numpy()

    def get_covariances(self) -> np.ndarray:
        return self.state.covariances.cpu().numpy()

    def get_world_frame_scans(self) -> np.ndarray:
        return self.state.world_points().cpu().numpy()

    def get_input_history(self) -> list[SingleInput]:
        return self.input_history

    # -- correction input state machine ------------------------------------

    def is_valid_correction_type(self, t: CorrectionType) -> bool:
        return t in (
            CorrectionType.POINT, CorrectionType.LINE_SEGMENT,
            CorrectionType.CORNER, CorrectionType.COLINEAR,
            CorrectionType.PERPENDICULAR, CorrectionType.PARALLEL,
        )

    def add_correction_points(self, modifiers: int, mouse_down, mouse_up):
        """Two drags select the two segments; the modifier bitmask IS the
        correction type."""
        ctype = (
            CorrectionType(modifiers)
            if modifiers in set(int(t) for t in CorrectionType)
            else CorrectionType.UNKNOWN
        )
        if ctype == CorrectionType.UNKNOWN:
            return
        mouse_down = np.asarray(mouse_down, np.float32)
        mouse_up = np.asarray(mouse_up, np.float32)
        if ctype != self.pending_type and self.is_valid_correction_type(ctype):
            # first drag of a new correction
            self.selected_points = [mouse_down]
            if ctype != CorrectionType.POINT:
                self.selected_points.append(mouse_up)
            self.pending_type = ctype
        else:
            # second drag completes the pair
            self.selected_points.append(mouse_down)
            if ctype != CorrectionType.POINT:
                self.selected_points.append(mouse_up)
            self.correction_type = ctype
            self.pending_type = CorrectionType.UNKNOWN
            self._dispatch_speculative()

    def _prepare_sel(self, ctype: CorrectionType,
                     sel: np.ndarray) -> np.ndarray | None:
        if ctype == CorrectionType.POINT and sel.shape[0] == 2:
            # a point pair enters the cycle as two degenerate segments
            sel = np.stack([sel[0], sel[0], sel[1], sel[1]])
        return sel if sel.shape[0] == 4 else None

    def _run_cycle(self, st: MapState, ctype: int, sel: np.ndarray,
                   num_constraints: int) -> CycleOutput:
        return cycle_step(
            st.points, st.point_mask, st.poses, st.covariances,
            st.constraints, ctype,
            torch.as_tensor(sel, dtype=torch.float32, device=self.device),
            num_constraints,
            lm_config=self.lm_config,
            odom_inv_sigma=self.odom_inv_sigma,
        )

    def _dispatch_speculative(self):
        """Start the cycle for the just-completed selection on a worker
        thread, without waiting for it. On a CUDA device the worker runs on
        a stream of its own, which first waits for the work already queued
        on the caller's stream (the state's tensors may still be in the
        making there)."""
        if not self.speculate or self.state is None:
            return
        sel = self._prepare_sel(self.correction_type,
                                np.stack(self.selected_points).astype(
                                    np.float32))
        if sel is None:
            return
        # retire a superseded dispatch before starting the new one
        self._discard_speculative()
        st = self.state
        ctype = int(self.correction_type)
        n = self.num_constraints
        stream = None
        if self.device.type == "cuda":
            if self._spec_stream is None:
                self._spec_stream = torch.cuda.Stream(self.device)
            stream = self._spec_stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
        box: dict = {}

        def work():
            try:
                if stream is None:
                    out = self._run_cycle(st, ctype, sel, n)
                    vals = _report_scalars(out)
                else:
                    with torch.cuda.stream(stream):
                        out = self._run_cycle(st, ctype, sel, n)
                        vals = _report_scalars(out)
                box["out"], box["vals"] = out, vals
            except Exception as e:   # handed to the run() that uses it
                box["error"] = e

        th = threading.Thread(target=work, daemon=True,
                              name="hitl-speculative-cycle")
        th.start()
        self._speculative = _Speculation(ctype, sel.tobytes(), st.poses, n,
                                         th, box)

    def _discard_speculative(self) -> _Speculation | None:
        """Take the pending speculative dispatch, if any, after its worker
        has finished and its stream has drained: from here on nothing of it
        is in flight, so the tensors it read may be released."""
        spec, self._speculative = self._speculative, None
        if spec is not None:
            spec.thread.join()
            if self._spec_stream is not None:
                self._spec_stream.synchronize()
        return spec

    def _adopt_speculative(self, spec: _Speculation):
        """(out, vals) of a dispatch that matched; its exception, if it
        raised, is raised here. The result's tensors were allocated on the
        worker's stream and are used on the caller's from now on: the
        allocator is told, so that it does not hand their memory to a later
        dispatch while the caller's stream still reads it."""
        if "error" in spec.box:
            raise spec.box["error"]
        out, vals = spec.box["out"], spec.box["vals"]
        if self._spec_stream is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_stream(self._spec_stream)
            for t in (out.poses, out.covariances, out.pre_solve_poses,
                      out.refit_sel, *vars(out.constraints).values()):
                t.record_stream(cur)
        return out, vals

    def reset_correction_inputs(self):
        self.selected_points = []
        self.pending_type = CorrectionType.UNKNOWN
        self.correction_type = CorrectionType.UNKNOWN

    # -- undo --------------------------------------------------------------

    def undo(self) -> bool:
        """Single-depth undo: restore the pose/covariance snapshot and
        deactivate the last correction's constraint rows.

        When the most recent solve was post_optimize (which has no entry in
        the input history), undo reverts that and leaves the history alone:
        the last human correction stays undoable afterwards."""
        if self._undo_is_refine:
            self.state = self.state.replace(
                poses=self.prev_poses, covariances=self.prev_covariances)
            self._undo_is_refine = False
            return True
        if not self.input_history:
            return False
        if self.input_history[-1].undone:
            return False
        st = self.state
        active = st.constraints.active.clone()
        active[self.prev_num_constraints:self.num_constraints] = False
        table = ConstraintTable(
            ctype=st.constraints.ctype,
            constrained=st.constraints.constrained,
            anchor=st.constraints.anchor,
            delta_parallel=st.constraints.delta_parallel,
            delta_perpendicular=st.constraints.delta_perpendicular,
            delta_angle=st.constraints.delta_angle,
            penalty_dir=st.constraints.penalty_dir,
            active=active,
        )
        self.state = st.replace(poses=self.prev_poses,
                                covariances=self.prev_covariances,
                                constraints=table)
        self.num_constraints = self.prev_num_constraints
        self.input_history[-1].undone = 1
        return True

    # -- observability -----------------------------------------------------

    def get_cost_breakdown(self) -> dict:
        """Current odometry/human factor cost split at the present poses."""
        from ...ops import residuals as R
        from ...solver.joint import build_problem

        st = self.state
        prob = build_problem(st.poses, st.constraints,
                             odom_inv_sigma=self.odom_inv_sigma)
        r_o = R.odometry_residuals(prob.odom, st.poses)
        r_h = R.human_residuals(prob.human, st.poses)
        odo, hum, n_act = _read_scalars(
            0.5 * torch.sum(r_o * r_o), 0.5 * torch.sum(r_h * r_h),
            torch.sum(st.constraints.active))
        return {
            "odometry_cost": odo,
            "human_cost": hum,
            "num_active_constraints": int(n_act),
        }

    # -- auto-proposed corrections -----------------------------------------

    def propose_corrections(self, max_proposals: int = 3, **kw):
        """Loop-closure suggestions from the correlative scan matcher
        (models/hitl/propose.py); each proposal's .input runs through the
        ordinary replay_log path when accepted."""
        from .propose import propose_corrections

        return propose_corrections(self.state, max_proposals=max_proposals,
                                   **kw)

    # -- post-human STF refinement -----------------------------------------

    def post_optimize(self, max_iterations: int = 30,
                      matcher: str = "auto") -> CycleReport:
        """Run the STF correspondence search and refinement solve on the
        current map.

        matcher="auto": try the global 1-NN grid first; if every bundle dies
        at the >= 10-per-pair gate (the fragmentation mode of heavily
        re-traversed maps), run again with the per-pair matcher.
        "global"/"pair" force one path."""
        from .refine import post_human_refine

        self._discard_speculative()
        st = self.state
        self.prev_poses = st.poses
        self.prev_covariances = st.covariances
        self.prev_num_constraints = self.num_constraints
        cfg = LMConfig(max_iterations=max_iterations)
        used = "pair" if matcher == "pair" else "global"
        out = post_human_refine(
            st.points, st.normals, st.point_mask, st.poses, st.constraints,
            config=cfg, matcher=used,
        )
        if matcher == "auto" and int(out.num_matches) == 0:
            used = "pair"
            out = post_human_refine(
                st.points, st.normals, st.point_mask, st.poses,
                st.constraints, config=cfg, matcher=used,
            )
        self.state = st.replace(poses=out.poses)
        # the prev_* snapshot now belongs to this refine: undo reverts it
        # without marking the last human input undone
        self._undo_is_refine = True
        labels = [("pairs_dropped", out.pairs_dropped),
                  ("vote_dropped", out.vote_dropped),
                  ("elect_dropped", out.elect_dropped)]
        labels = [(k, v) for k, v in labels if v is not None]
        lm_it, c0, c1, match_dropped, *drops = _read_scalars(
            out.iterations, out.initial_cost, out.final_cost,
            out.match_dropped, *[v for _, v in labels])
        # capacity violations beyond lost rows surface in the reason text
        extra = "".join(f", {k}={int(v)}"
                        for (k, _), v in zip(labels, drops) if int(v) > 0)
        return CycleReport(
            True, reason=f"post-human STF refinement ({used} matcher{extra})",
            lm_iterations=int(lm_it), initial_cost=c0, final_cost=c1,
            # factor rows lost to matcher-table capacity
            dropped_rows=int(match_dropped),
        )

    # -- the correction cycle ----------------------------------------------

    def run(self) -> CycleReport:
        """Execute one full correction cycle from the pending user input."""
        if (
            not self.selected_points
            or self.pending_type != CorrectionType.UNKNOWN
        ):
            self.reset_correction_inputs()
            return CycleReport(False, "incomplete correction specification")
        sel = np.stack(self.selected_points).astype(np.float32)
        ctype = self.correction_type
        report = self._cycle(ctype, sel, record_history=True)
        self.reset_correction_inputs()
        return report

    def _clip_cursor(self) -> int:
        cap = self.state.constraints.capacity - 1
        if self.num_constraints <= cap:
            return 0
        # rows beyond capacity landed in the dump slot and were dropped
        dropped = self.num_constraints - cap
        print(f"WARNING: constraint table full ({cap}); {dropped} rows "
              f"dropped. Increase constraint_capacity.", file=sys.stderr)
        self.num_constraints = cap
        return dropped

    def run_queue(self, inputs: list[SingleInput],
                  chain_capacity: int = 8,
                  record: bool = False) -> list[CycleReport]:
        """Execute queued corrections as device-carried chains
        (cycle.queue_chain), up to `chain_capacity` corrections a chain, with
        one host read at the end of each. Per-cycle accept/reject semantics
        match sequential replay_log; undo() restores the state before the
        whole queue. Nothing is compiled, so a short chain needs no padding
        cycles."""
        if not inputs:
            return []
        self._discard_speculative()
        st = self.state
        self.prev_poses = st.poses
        self.prev_covariances = st.covariances
        self.prev_num_constraints = self.num_constraints
        self._undo_is_refine = False
        reports: list[CycleReport] = []
        for lo in range(0, len(inputs), chain_capacity):
            reports += self._run_chain(inputs[lo:lo + chain_capacity], record)
        return reports

    def _run_chain(self, inputs: list[SingleInput],
                   record: bool) -> list[CycleReport]:
        """One chunk of run_queue: one queue_chain call and its reports."""
        st = self.state
        live = [self._prepare_sel(s.correction_type,
                                  np.asarray(s.points, np.float32))
                for s in inputs]
        runs = [(s, sel) for s, sel in zip(inputs, live) if sel is not None]
        timer = FunctionTimer("queue")
        flags = []
        if runs:
            sels = torch.as_tensor(np.stack([sel for _, sel in runs]),
                                   dtype=torch.float32, device=self.device)
            poses, covs, table, _, per = queue_chain(
                st.points, st.point_mask, st.poses, st.covariances,
                st.constraints, [int(s.correction_type) for s, _ in runs],
                sels, self.num_constraints, lm_config=self.lm_config,
                odom_inv_sigma=self.odom_inv_sigma)
            flags = torch.stack([c.to(torch.float64) for c in per],
                                dim=1).cpu().tolist()
            timer.lap("queue_chain")
            self.state = st.replace(poses=poses, covariances=covs,
                                    constraints=table)
        reports: list[CycleReport] = []
        it = iter(flags)
        n_total = 0
        for s, sel in zip(inputs, live):
            self.num_completed_cycles += 1
            if sel is None:
                reports.append(CycleReport(False, "unsupported selection shape"))
                continue
            ok, ver, ordv, n_new, lm_it, c0, c1 = next(it)
            diverged = bool(ver) and bool(ordv) and not bool(ok)
            if record and bool(ver) and not diverged:
                self.input_history.append(
                    SingleInput(s.correction_type, 0, sel.copy()))
            if not bool(ver):
                reports.append(CycleReport(
                    False, "input not verified near observations"))
            elif not bool(ordv):
                reports.append(CycleReport(
                    False, "selection overlap / no backprop window",
                    points_verified=4))
            elif not bool(ok):
                reports.append(CycleReport(
                    False, "solver diverged (non-finite cost); "
                    "state preserved"))
            else:
                reports.append(CycleReport(
                    True, points_verified=4,
                    num_new_constraints=int(n_new),
                    lm_iterations=int(lm_it),
                    initial_cost=c0, final_cost=c1,
                    timings_ms=timer.laps_ms()))
            n_total += int(n_new)
        self.num_constraints += n_total
        self._clip_cursor()
        return reports

    def replay_log(self, logged: SingleInput,
                   record: bool = False) -> CycleReport:
        """Re-execute one logged correction; `record=True` appends it to the
        session history."""
        report = self._cycle(
            logged.correction_type,
            np.asarray(logged.points, np.float32),
            record_history=record,
        )
        self.reset_correction_inputs()
        return report

    def _cycle(self, ctype: CorrectionType, sel: np.ndarray,
               record_history: bool) -> CycleReport:
        st = self.state
        timer = FunctionTimer("cycle")
        sel_p = self._prepare_sel(ctype, sel)
        if sel_p is None:
            return CycleReport(False, f"unsupported selection shape {sel.shape}")
        sel = sel_p

        prev_poses = st.poses
        prev_covariances = st.covariances
        prev_n = self.num_constraints

        # take the speculative dispatch when it was made for this exact
        # cycle (type, selection bytes, pose tensor identity, constraint
        # count); anything else has been waited for and is dropped here
        out = vals = None
        spec = self._discard_speculative()
        if (spec is not None and spec.ctype == int(ctype)
                and spec.sel_bytes == sel.astype(np.float32).tobytes()
                and spec.poses is st.poses
                and spec.num_constraints == self.num_constraints):
            out, vals = self._adopt_speculative(spec)
            self.speculative_hits += 1
        if out is None:
            out = self._run_cycle(st, int(ctype), sel, self.num_constraints)
            vals = _report_scalars(out)
        verified, order_valid, n_new, lm_it, c0, c1 = vals
        timer.lap("cycle_step")
        self.num_completed_cycles += 1

        # a non-finite solve leaves the session state untouched
        if bool(order_valid) and bool(verified) and not np.isfinite(c1):
            return CycleReport(False, "solver diverged (non-finite cost); "
                               "state preserved",
                               timings_ms=timer.laps_ms())

        if not bool(verified):
            return CycleReport(False, "input not verified near observations",
                               timings_ms=timer.laps_ms())

        # history is recorded once the input verifies, even if ordering then
        # rejects it, with the snapshot taken before the ordering check
        if record_history:
            self.input_history.append(SingleInput(ctype, 0, sel.copy()))
            self.prev_poses = prev_poses
            self.prev_covariances = prev_covariances
            self.prev_num_constraints = prev_n
            self._undo_is_refine = False

        if not bool(order_valid):
            return CycleReport(False, "selection overlap / no backprop window",
                               points_verified=4, timings_ms=timer.laps_ms())

        self.prev_poses = prev_poses
        self.prev_covariances = prev_covariances
        self.prev_num_constraints = prev_n
        self._undo_is_refine = False
        self.num_constraints += int(n_new)
        dropped = self._clip_cursor()
        self.last_pre_solve_poses = out.pre_solve_poses
        self.state = st.replace(poses=out.poses, covariances=out.covariances,
                                constraints=out.constraints)
        return CycleReport(
            True,
            points_verified=4,
            num_new_constraints=int(n_new),
            lm_iterations=int(lm_it),
            initial_cost=c0,
            final_cost=c1,
            dropped_rows=dropped,
            timings_ms=timer.laps_ms(),
        )
