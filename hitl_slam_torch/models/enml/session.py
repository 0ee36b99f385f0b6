"""Interactive EnML session: loop-closure corrections while (or after)
producing the map, with logging and replay.

Port of hitl_slam_tpu/models/enml/session.py. The interactive side of the
original `vector_mapping` tool:

  - `loop_inv_sigmas`   AddLoopConstraint's noise model: chain factors
                        weighted by each pose's covariance ellipse (95 %
                        eigen scaling, radial projection, rate bounds)
                        instead of the HitL tool's fixed noise model; host
                        numpy, a copy;
  - `EnmlSession`       corrections accepted mid-localization, routed
                        through the HitL constraint machinery
                        (models/hitl/engine.py) and applied to the live pose
                        graph;
  - logging + replay    every applied correction is recorded as a
                        SingleInput, and a logged session can be stepped or
                        replayed in full.

The trajectory sweep runs in `segment`-node pieces (localizer.sweep_segment)
on the session's device; between pieces the host reads the poses and
covariances back once, publishes progress and splices in queued
corrections. A correction runs the HitL cycle on the FULL pose array with
per-factor covariance-derived odometry weights; not-yet-localized suffix
poses are untouched by construction (human factors bind only the poses the
selection covers) and are re-seeded by the sweep as it advances.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ...core.state import CorrectionType, SingleInput
from .localizer import EnmlOptions


def loop_inv_sigmas(poses: np.ndarray, covariances: np.ndarray,
                    options: EnmlOptions = EnmlOptions(),
                    scale: float = 1.0) -> np.ndarray:
    """[P-1, 3] per-chain-factor inverse stddevs (radial, tangential,
    angular) from the pose covariance ellipses, vectorized:

      - 95% covariance ellipse axes: sqrt(5.991 * eigval_k) * eigvec_k of
        the position block of pose i-1;
      - radial/tangential stddev: the ellipse projected onto the radial
        direction (the original computes the SAME projection for both,
        reproduced here);
      - angular stddev: sqrt(cov[2,2]);
      - all bounded into [min, max] stddev options, non-finite values
        clamped to the minimum, then multiplied by `scale`.
    """
    o = options
    poses = np.asarray(poses, np.float64)
    covariances = np.asarray(covariances, np.float64)
    eps = 1e-6

    trans = poses[1:, :2] - poses[:-1, :2]             # [F, 2]
    norm = np.linalg.norm(trans, axis=-1)
    degenerate = (np.abs(trans[:, 0]) < eps) & (np.abs(trans[:, 1]) < eps)
    c, s = np.cos(-poses[:-1, 2]), np.sin(-poses[:-1, 2])
    local = np.stack([c * trans[:, 0] - s * trans[:, 1],
                      s * trans[:, 0] + c * trans[:, 1]], -1)
    radial = np.where(
        degenerate[:, None],
        np.stack([np.cos(poses[1:, 2]), np.sin(poses[1:, 2])], -1),
        local / np.maximum(norm, eps)[:, None])

    cov2 = covariances[:-1, :2, :2]
    cov2 = 0.5 * (cov2 + np.swapaxes(cov2, -1, -2))
    w, v = np.linalg.eigh(cov2)                        # [F, 2], [F, 2, 2]
    sig = np.sqrt(5.991 * np.maximum(w, 0.0))          # [F, 2]
    # ellipse axes dir_k = eigvec_k * sigma_k; projection onto radial
    proj = np.einsum("fi,fik->fk", radial, v) * sig    # [F, 2]
    r_std = np.sqrt(np.sum(proj**2, -1))
    t_std = r_std                                      # the original's quirk
    a_std = np.sqrt(np.maximum(covariances[:-1, 2, 2], 0.0))

    def bound(x, lo, hi):
        x = np.where(np.isfinite(x), x, lo)
        return np.clip(x, lo, hi)

    r_std = bound(r_std, o.odometry_translation_min_stddev,
                  o.odometry_translation_max_stddev)
    t_std = bound(t_std, o.odometry_translation_min_stddev,
                  o.odometry_translation_max_stddev)
    a_std = bound(a_std, o.odometry_angular_min_stddev,
                  o.odometry_angular_max_stddev)
    sigmas = scale * np.stack([r_std, t_std, a_std], -1)   # [P-1, 3]
    return (1.0 / np.maximum(sigmas, 1e-12)).astype(np.float32)


@dataclass
class SessionReport:
    """Result of one applied loop-closure correction."""

    accepted: bool
    reason: str
    lm_iterations: int
    new_constraints: int
    total_cost: float


class EnmlSession:
    """One interactive EnML mapping session on `device`: localize
    (optionally in live segments), accept loop-closure corrections, log,
    replay.

    Thread contract: `queue_correction` may be called from any thread (the
    GUI websocket thread); everything else runs on the session thread.
    `poses` and `covariances` are host numpy copies, refreshed after every
    segment and every accepted correction.
    """

    def __init__(self, poses, point_clouds, normal_clouds,
                 options: EnmlOptions = EnmlOptions(),
                 correction_scale: float = 1.0,
                 constraint_capacity: int = 2048,
                 ltf_segs=None, device="cuda"):
        from ...core.state import make_map_state

        self.device = torch.device(device)
        self.options = options
        self.correction_scale = correction_scale
        self.ltf_segs = None if ltf_segs is None else np.asarray(
            ltf_segs, np.float32)
        self.state = make_map_state(
            np.asarray(poses, np.float32),
            np.zeros((len(poses), 3, 3), np.float32),
            point_clouds, normal_clouds,
            constraint_capacity=constraint_capacity, device=self.device)
        self.initial_poses = np.asarray(poses, np.float32)
        self.poses = np.asarray(poses, np.float32)
        self.covariances = np.zeros((len(poses), 3, 3), np.float32)
        self.localized_upto = 0          # nodes [0, localized_upto) solved
        # correction machinery (lazy: the first correction builds the engine)
        self._engine = None
        self.input_history: list[SingleInput] = []
        self.replay_index = 0
        self._pending: list[tuple[CorrectionType, np.ndarray]] = []
        self._pending_lock = threading.Lock()
        # loop-corrections toggle (the 0x06 click of the GUI protocol)
        self.loop_corrections_on = False

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -- batch / segmented localization -------------------------------------

    def localize(self, segment: int = 32, progress_cb=None):
        """Run the trajectory sweep start to finish in `segment`-node
        pieces. Between pieces: apply any queued corrections, then call
        `progress_cb(session, t_done)` (publish GUI frames there).
        Returns (poses [P, 3], covariances [P, 3, 3]) as host arrays."""
        from .localizer import sweep_precompute, sweep_segment

        st = self.state
        P = st.num_poses
        pre = sweep_precompute(self._tensor(self.initial_poses), self.options)
        ps = self._tensor(self.poses)
        cv = self._tensor(self.covariances)
        t0 = self.localized_upto
        segs = None if self.ltf_segs is None else self._tensor(self.ltf_segs)
        while t0 < P:
            ps, cv = sweep_segment(
                st.points, st.normals, st.point_mask, ps, cv, pre, t0,
                self.options, segment, ltf_segs=segs)
            t0 = min(t0 + segment, P)
            self.poses = ps.cpu().numpy()
            self.covariances = cv.cpu().numpy()      # writable host copy
            self.covariances[0] = np.eye(3, dtype=np.float32) * 1e-6
            self.localized_upto = t0
            if self._apply_pending():
                ps = self._tensor(self.poses)   # corrections moved poses
            if progress_cb is not None:
                progress_cb(self, t0)
        return self.poses, self.covariances

    def correspondences(self, t: int | None = None, max_lines: int = 512):
        """World-frame STF correspondence segments at the window ending at
        `t` (default: the newest localized node), as host arrays."""
        from .localizer import window_correspondences

        st = self.state
        if t is None:
            t = max(self.localized_upto - 1, 0)
        src, tgt, valid = window_correspondences(
            st.points, st.normals, st.point_mask, self._tensor(self.poses),
            int(t), self.options)
        src, tgt, valid = src.cpu().numpy(), tgt.cpu().numpy(), \
            valid.cpu().numpy()
        src, tgt = src[valid], tgt[valid]
        if len(src) > max_lines:
            idx = np.linspace(0, len(src) - 1, max_lines).astype(int)
            src, tgt = src[idx], tgt[idx]
        return src, tgt

    # -- loop-closure corrections --------------------------------------------

    def _ensure_engine(self):
        if self._engine is None:
            from ..hitl.engine import HitLSLAM

            eng = HitLSLAM(device=self.device)
            eng.init_from_state(self.state)
            eng.speculate = False       # corrections apply synchronously here
            self._engine = eng
        return self._engine

    def _sync_engine_state(self):
        """Push the session's live poses and covariances into the engine
        state and refresh the covariance-weighted chain (it is rebuilt from
        the CURRENT covariances for every solve)."""
        eng = self._ensure_engine()
        eng.state = eng.state.replace(
            poses=self._tensor(self.poses),
            covariances=self._tensor(self.covariances))
        eng.odom_inv_sigma = self._tensor(loop_inv_sigmas(
            self.poses, self.covariances, self.options,
            scale=self.correction_scale))
        return eng

    def queue_correction(self, ctype: CorrectionType, sel) -> None:
        """Thread-safe: enqueue a correction to be applied at the next
        segment boundary (corrections arriving WHILE the map is being
        produced)."""
        with self._pending_lock:
            self._pending.append(
                (CorrectionType(ctype), np.asarray(sel, np.float32)))

    def _apply_pending(self) -> bool:
        with self._pending_lock:
            pending, self._pending = self._pending, []
        applied = False
        for ctype, sel in pending:
            rep = self.add_loop_correction(ctype, sel)
            applied = applied or rep.accepted
        return applied

    def add_loop_correction(self, ctype: CorrectionType,
                            sel) -> SessionReport:
        """Apply one human loop-closure correction to the current pose graph:
        the HitL cycle (affine pre-correction + COP-SLAM backprop + joint
        LM) with the chain weighted by the pose covariance ellipses. It
        launches em_scan twice and BCR once an LM iteration. Logged into
        `input_history` for replay."""
        sel = np.asarray(sel, np.float32)
        eng = self._sync_engine_state()
        eng.correction_type = CorrectionType(ctype)
        eng.selected_points = list(sel)
        rep = eng.run()
        if rep.accepted:
            self.poses = eng.get_poses()
            self.covariances = eng.get_covariances()
            self.state = eng.state
        self.input_history.append(
            SingleInput(CorrectionType(ctype), 0, sel))
        return SessionReport(
            accepted=rep.accepted, reason=rep.reason,
            lm_iterations=rep.lm_iterations,
            new_constraints=rep.num_new_constraints,
            total_cost=rep.final_cost)

    # -- logging + replay ----------------------------------------------------

    def save_log(self, path: str) -> None:
        from ...io import logs

        logs.save_log(path, self.input_history)

    def load_log(self, path: str) -> int:
        from ...io import logs

        self.logged_input = logs.load_log(path)
        self.replay_index = 0
        return len(self.logged_input)

    def replay_next(self) -> SessionReport | None:
        """Apply the next not-undone logged correction. Returns None when
        the log is exhausted."""
        log = getattr(self, "logged_input", None)
        if not log:
            return None
        while self.replay_index < len(log):
            entry = log[self.replay_index]
            self.replay_index += 1
            if entry.undone:
                continue
            return self.add_loop_correction(entry.correction_type,
                                            entry.points)
        return None

    def replay_all(self) -> list[SessionReport]:
        out = []
        while True:
            rep = self.replay_next()
            if rep is None:
                break
            out.append(rep)
        return out
