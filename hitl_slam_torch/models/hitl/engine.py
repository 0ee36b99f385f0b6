"""HitLSLAM session orchestrator (host side).

Port of hitl_slam_tpu/models/hitl/engine.py::HitLSLAM: init / run /
replay_log / run_queue / add_correction_points / undo / getters /
get_cost_breakdown, with the same single-depth undo snapshot and the
two-click pending-correction state machine. The numeric cycle runs on the
engine's device (models/hitl/cycle.py); this class holds the state,
records history and undo snapshots, and keeps the constraint-table write
cursor. It reads back six scalars per correction.

Not ported yet: speculative dispatch, post_optimize and
propose_corrections.
"""

from __future__ import annotations

import sys
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
from .cycle import cycle_step, queue_chain


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


class HitLSLAM:
    """One interactive map-repair session on `device`."""

    def __init__(self, device, lm_config: LMConfig = LMConfig()):
        self.lm_config = lm_config
        self.device = torch.device(device)
        self.state: MapState | None = None
        self.prev_poses = None
        self.prev_covariances = None
        self.prev_num_constraints = 0
        self.num_constraints = 0
        self.input_history: list[SingleInput] = []
        self.num_completed_cycles = 0
        self.selected_points: list[np.ndarray] = []
        self.pending_type = CorrectionType.UNKNOWN
        self.correction_type = CorrectionType.UNKNOWN

    # -- lifecycle ---------------------------------------------------------

    def init(self, poses, covariances, point_clouds, normal_clouds,
             odometry=None, constraint_capacity: int = 8192):
        self.state = make_map_state(
            np.asarray(poses), np.asarray(covariances), point_clouds,
            normal_clouds, self.device, odometry=odometry,
            constraint_capacity=constraint_capacity,
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

    def _prepare_sel(self, ctype: CorrectionType,
                     sel: np.ndarray) -> np.ndarray | None:
        if ctype == CorrectionType.POINT and sel.shape[0] == 2:
            # a point pair enters the cycle as two degenerate segments
            sel = np.stack([sel[0], sel[0], sel[1], sel[1]])
        return sel if sel.shape[0] == 4 else None

    def reset_correction_inputs(self):
        self.selected_points = []
        self.pending_type = CorrectionType.UNKNOWN
        self.correction_type = CorrectionType.UNKNOWN

    # -- undo --------------------------------------------------------------

    def undo(self) -> bool:
        """Single-depth undo: restore the pose/covariance snapshot and
        deactivate the last correction's constraint rows."""
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
        prob = build_problem(st.poses, st.constraints)
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
                  record: bool = False) -> list[CycleReport]:
        """Execute queued corrections as one device-carried chain
        (cycle.queue_chain) with one host read at its end. Per-cycle
        accept/reject semantics match sequential replay_log; undo()
        restores the state before the whole queue."""
        if not inputs:
            return []
        st = self.state
        self.prev_poses = st.poses
        self.prev_covariances = st.covariances
        self.prev_num_constraints = self.num_constraints
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
                sels, self.num_constraints, lm_config=self.lm_config)
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

        out = cycle_step(
            st.points, st.point_mask, st.poses, st.covariances,
            st.constraints, int(ctype),
            torch.as_tensor(sel, dtype=torch.float32, device=self.device),
            self.num_constraints,
            lm_config=self.lm_config,
        )
        verified, order_valid, n_new, lm_it, c0, c1 = _read_scalars(
            out.verified, out.order_valid, out.num_new_constraints,
            out.lm_iterations, out.lm_initial_cost, out.lm_final_cost)
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

        if not bool(order_valid):
            return CycleReport(False, "selection overlap / no backprop window",
                               points_verified=4, timings_ms=timer.laps_ms())

        self.prev_poses = prev_poses
        self.prev_covariances = prev_covariances
        self.prev_num_constraints = prev_n
        self.num_constraints += int(n_new)
        dropped = self._clip_cursor()
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
