"""Auto-proposed loop-closure corrections.

Port of hitl_slam_tpu/models/hitl/propose.py. The correlative scan matcher
(ops/scan_match.py) detects drift between temporally distant, spatially
near pose pairs and converts the measured misalignment into ordinary
human-style COLINEAR corrections: a pair of drawn segments that feed the
unmodified correction machinery (verify -> EM refit -> ordering -> explicit
-> backprop -> joint solve). The human stays in the loop: a GUI renders the
proposals as suggestions (gui/display.py::display_proposals), and the CLI's
--auto-repair applies them headless.

Pipeline per proposal:
  1. candidate pair: pose j and the spatially nearest pose i with
     j - i > min_gap (loop closure, not odometry neighbours);
  2. correlative_match of pose j's scan against a likelihood field built
     from the anchor neighbourhood's points -> matched pose + score;
  3. RANSAC segments (ops/ransac.py) from the anchor neighbourhood and from
     pose j's scan placed at the matched pose; the longest angle/offset/
     overlap-consistent pair becomes the correction: the anchor-side segment
     stays put, the corrected-side segment is mapped back through the
     inverse drift onto the current (drifted) rendering, where a human
     would draw it;
  4. endpoints snap to the nearest observed points so that the engine's
     0.05 m verification gate passes.

All candidates' likelihood fields, correlative matches and RANSAC
extractions run as three batched device stages over fixed-size padded anchor
neighbourhoods, each read back to the host once; only the final segment
pairing, snapping and gating loop is host numpy over the handful of
survivors.

The RANSAC hypotheses come from `draws`, a pair (anchor side, corrected
side) of what ops/ransac.py::extract_segments takes; by default both are
uniforms from one CPU generator seeded with `seed`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ...core.state import CorrectionType, MapState, SingleInput
from ...ops.ransac import (RansacParams, Segments, extract_segments,
                           uniform_draws)
from ...ops.scan_match import (ScanMatchParams, build_likelihood_field,
                               correlative_match)


@dataclass
class Proposal:
    input: SingleInput        # ready-to-run COLINEAR correction
    anchor_pose: int
    corrected_pose: int
    score: float              # correlation score (0..1)
    drift: np.ndarray         # [3] estimated (dx, dy, dtheta) at the pose


# the segment extraction of both sides of a candidate
PROPOSAL_RANSAC = RansacParams(num_segments=8, min_inliers=10, min_length=0.8)


def _wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def _snap(endpoint: np.ndarray, pts: np.ndarray, max_d: float = 0.12):
    """Snap to the nearest observed point (the verify gate wants <0.05 m;
    the EM refit re-centers afterwards). None if nothing is close."""
    d = np.linalg.norm(pts - endpoint[None], axis=1)
    k = int(np.argmin(d))
    if d[k] > max_d:
        return None
    return pts[k]


def _segments_to_host(segs: Segments) -> dict:
    """The fields the pairing loop reads, one transfer each."""
    return {k: getattr(segs, k).cpu().numpy() for k in ("p1", "p2", "valid")}


def candidate_pairs(poses: np.ndarray, max_proposals: int = 3,
                    min_gap: int | None = None,
                    pair_radius: float = 4.0) -> list[tuple[int, int]]:
    """Candidate loop pairs (i, j): a late pose j and the nearest early pose
    i with j - i > min_gap, nearest pairs first, one per corrected-pose
    cluster, at most 2 * max_proposals of them. Host numpy."""
    P = len(poses)
    gap = min_gap if min_gap is not None else max(P // 4, 8)
    cands = []
    step = max(P // 48, 1)
    for j in range(P - 1, gap, -step):
        d = np.linalg.norm(poses[: j - gap, :2] - poses[j, :2], axis=1)
        i = int(np.argmin(d))
        if d[i] < pair_radius:
            cands.append((float(d[i]), i, j))
    cands.sort()
    # dedupe: one candidate per corrected-pose cluster
    chosen, used = [], np.zeros(P, bool)
    for d, i, j in cands:
        if used[max(0, j - gap // 2): j + gap // 2].any():
            continue
        used[j] = True
        chosen.append((i, j))
        if len(chosen) >= 2 * max_proposals:
            break
    return chosen


def candidate_inputs(state: MapState, world: torch.Tensor,
                     poses: np.ndarray, chosen: list[tuple[int, int]],
                     neighborhood: int = 5) -> tuple:
    """What the device stage works on, for B candidate pairs, on the state's
    device: the anchor neighbourhoods' world points [B, (2 nb + 1) N, 2] and
    mask (fixed size, padded where the window leaves the trajectory), their
    centres [B, 2], and the corrected poses' robot-frame scans [B, N, 2],
    masks and pose guesses [B, 3]. `world` is state.world_points(), `poses`
    the state's poses on the host."""
    device = state.poses.device
    P = len(poses)
    B = len(chosen)
    nb2 = 2 * neighborhood + 1
    N = world.shape[1]
    ii = np.array([i for i, _ in chosen])
    jj = np.array([j for _, j in chosen])
    win = ii[:, None] + np.arange(-neighborhood, neighborhood + 1)[None]
    pose_ok = (win >= 0) & (win < P)
    win_t = torch.as_tensor(np.clip(win, 0, P - 1), device=device)
    jj_t = torch.as_tensor(jj, device=device)
    a_pts = world[win_t].reshape(B, nb2 * N, 2)
    a_mask = (state.point_mask[win_t]
              & torch.as_tensor(pose_ok, device=device)[:, :, None]
              ).reshape(B, nb2 * N)
    centers = torch.as_tensor(poses[ii, :2], dtype=torch.float32,
                              device=device)
    guesses = torch.as_tensor(poses[jj], dtype=torch.float32, device=device)
    return (a_pts, a_mask, centers, state.points[jj_t],
            state.point_mask[jj_t], guesses)


def place_scans(scans: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """[B, N, 2] robot-frame scans placed at their matched poses [B, 3]."""
    cb = torch.cos(matched[:, 2])[:, None]
    sb = torch.sin(matched[:, 2])[:, None]
    return torch.stack([
        cb * scans[..., 0] - sb * scans[..., 1] + matched[:, 0:1],
        sb * scans[..., 0] + cb * scans[..., 1] + matched[:, 1:2],
    ], dim=-1)


def match_candidates(
    state: MapState,
    poses: np.ndarray,
    chosen: list[tuple[int, int]],
    neighborhood: int = 5,
    params: ScanMatchParams = ScanMatchParams(),
    seed: int = 0,
    draws: tuple | None = None,
) -> dict:
    """The batched device stage: all B candidates' likelihood fields,
    correlative matches and RANSAC segment extractions on the state's
    device, each result read back to the host once. Returns the numpy
    arrays `gate_and_pair` works on."""
    device = state.poses.device
    B = len(chosen)
    world_t = state.world_points()
    jj_t = torch.as_tensor([j for _, j in chosen], device=device)
    a_pts, a_mask, centers, scans, scan_masks, guesses = candidate_inputs(
        state, world_t, poses, chosen, neighborhood)

    fields = build_likelihood_field(a_pts, a_mask, centers, params)
    matched_t, score_t, ambiguity_t = correlative_match(
        fields, centers, scans, scan_masks, guesses, params)

    rp = PROPOSAL_RANSAC
    if draws is None:
        u = uniform_draws(seed, rp, device, batch=2 * B)
        draws = (u[:B], u[B:])
    draws_a, draws_c = draws
    seg_a = extract_segments(a_pts, a_mask, draws_a, rp)
    # each scan placed at its matched pose (where it should be)
    scans_w = place_scans(scans, matched_t)
    seg_c = extract_segments(scans_w, scan_masks, draws_c, rp)
    return dict(
        world=world_t.cpu().numpy(),
        mask=state.point_mask.cpu().numpy(),
        matched=matched_t.cpu().numpy(),
        score=score_t.cpu().numpy(),
        ambiguity=ambiguity_t.cpu().numpy(),
        seg_a=_segments_to_host(seg_a),
        seg_c=_segments_to_host(seg_c),
        a_pts=a_pts.cpu().numpy(),
        a_mask=a_mask.cpu().numpy(),
        scan_mask=scan_masks.cpu().numpy(),
        covs=state.covariances[jj_t].cpu().numpy(),
    )


def gate_and_pair(
    poses: np.ndarray,
    chosen: list[tuple[int, int]],
    found: dict,
    max_proposals: int = 3,
    min_drift: float = 0.08,
    min_score: float = 0.35,
    max_ambiguity: float = 0.85,
    drift_sigma_gate: float = 4.0,
) -> list[Proposal]:
    """The host loop over the candidates `match_candidates` scored: gates,
    segment pairing and snapping, numpy only."""
    world, mask = found["world"], found["mask"]
    proposals: list[Proposal] = []
    for b, (i, j) in enumerate(chosen):
        if int(found["a_mask"][b].sum()) < 50:
            continue
        matched = found["matched"][b]
        score = float(found["score"][b])
        drift = np.array([matched[0] - poses[j, 0], matched[1] - poses[j, 1],
                          _wrap(matched[2] - poses[j, 2])])
        if score < min_score:
            continue
        # reject aliased matches (a second, nearly as good alignment exists
        # elsewhere, typically a parallel wall)
        if float(found["ambiguity"][b]) > max_ambiguity:
            continue
        if np.linalg.norm(drift[:2]) < min_drift and abs(drift[2]) < 0.02:
            continue
        # implausibly large jumps: gate by the pose's own uncertainty
        # (covariances shrink as corrections land, tightening this gate)
        cov_xy = found["covs"][b][:2, :2]
        sigma = float(np.sqrt(max(np.trace(cov_xy), 0.0)))
        if np.linalg.norm(drift[:2]) > drift_sigma_gate * sigma + 0.3:
            continue
        if int(found["scan_mask"][b].sum()) < 30:
            continue
        anchor_pts = found["a_pts"][b][found["a_mask"][b]]
        seg_a = {k: v[b] for k, v in found["seg_a"].items()}
        seg_c = {k: v[b] for k, v in found["seg_c"].items()}

        pair = _best_segment_pair(seg_a, seg_c)
        if pair is None:
            continue
        (a0, a1), (m0, m1) = pair
        c, s = np.cos(matched[2]), np.sin(matched[2])
        R_new = np.array([[c, -s], [s, c]])

        # map the corrected-side segment back onto the current rendering:
        # current = T_old . T_new^-1 . matched_endpoint
        co, so = np.cos(poses[j, 2]), np.sin(poses[j, 2])
        R_old = np.array([[co, -so], [so, co]])
        back = lambda q: R_old @ (R_new.T @ (q - matched[:2])) + poses[j, :2]
        c0, c1 = back(m0), back(m1)

        # snap all four endpoints onto observed points
        corr_pts = world[j][mask[j]]
        c0s, c1s = _snap(c0, corr_pts), _snap(c1, corr_pts)
        a0s, a1s = _snap(a0, anchor_pts), _snap(a1, anchor_pts)
        if any(v is None for v in (c0s, c1s, a0s, a1s)):
            continue
        sel = np.stack([c0s, c1s, a0s, a1s]).astype(np.float32)
        proposals.append(Proposal(
            input=SingleInput(CorrectionType.COLINEAR, 0, sel),
            anchor_pose=i, corrected_pose=j, score=score, drift=drift,
        ))
        if len(proposals) >= max_proposals:
            break
    return proposals


def propose_corrections(
    state: MapState,
    max_proposals: int = 3,
    min_gap: int | None = None,
    pair_radius: float = 4.0,
    min_drift: float = 0.08,
    min_score: float = 0.35,
    max_ambiguity: float = 0.85,
    drift_sigma_gate: float = 4.0,
    neighborhood: int = 5,
    params: ScanMatchParams = ScanMatchParams(),
    seed: int = 0,
    draws: tuple | None = None,
    timings_ms: dict | None = None,
) -> list[Proposal]:
    """Loop-closure suggestions for `state`, on the state's device.
    `timings_ms`, when given, receives the wall ms of the device stage
    ("device_ms": the candidate search and `match_candidates`, which ends
    in host reads) and of the host loop ("host_ms")."""
    t_start = time.perf_counter()
    poses = state.poses.cpu().numpy()
    chosen = candidate_pairs(poses, max_proposals, min_gap, pair_radius)
    found = (match_candidates(state, poses, chosen, neighborhood, params,
                              seed, draws) if chosen else None)
    t_device = time.perf_counter()
    proposals = (gate_and_pair(poses, chosen, found, max_proposals, min_drift,
                               min_score, max_ambiguity, drift_sigma_gate)
                 if chosen else [])
    if timings_ms is not None:
        timings_ms["device_ms"] = (t_device - t_start) * 1e3
        timings_ms["host_ms"] = (time.perf_counter() - t_device) * 1e3
    return proposals


def _best_segment_pair(seg_a, seg_c, max_angle=0.18, max_offset=0.25,
                       min_overlap=0.6):
    """Longest (anchor, corrected) segment pair that is colinear-consistent
    after matching: similar direction, small line offset, overlapping spans.
    `seg_a`, `seg_c`: {"p1", "p2", "valid"} numpy arrays of one candidate.
    Returns ((a0, a1), (c0, c1)) trimmed to the common span, or None."""
    a_p1, a_p2, a_ok = seg_a["p1"], seg_a["p2"], seg_a["valid"]
    c_p1, c_p2, c_ok = seg_c["p1"], seg_c["p2"], seg_c["valid"]
    best, best_len = None, 0.0
    for ai in np.nonzero(a_ok)[0]:
        da = a_p2[ai] - a_p1[ai]
        la = np.linalg.norm(da)
        if la < 1e-6:
            continue
        ua = da / la
        na = np.array([-ua[1], ua[0]])
        for ci in np.nonzero(c_ok)[0]:
            dc = c_p2[ci] - c_p1[ci]
            lc = np.linalg.norm(dc)
            if lc < 1e-6:
                continue
            uc = dc / lc
            ang = np.arccos(np.clip(abs(ua @ uc), -1, 1))
            if ang > max_angle:
                continue
            off = abs((0.5 * (c_p1[ci] + c_p2[ci]) - a_p1[ai]) @ na)
            if off > max_offset:
                continue
            # overlap of projections on the anchor direction
            ta = sorted([0.0, la])
            tc = sorted([(c_p1[ci] - a_p1[ai]) @ ua,
                         (c_p2[ci] - a_p1[ai]) @ ua])
            o0, o1 = max(ta[0], tc[0]), min(ta[1], tc[1])
            if o1 - o0 < min_overlap:
                continue
            if o1 - o0 > best_len:
                best_len = o1 - o0
                anchor_seg = (a_p1[ai] + o0 * ua, a_p1[ai] + o1 * ua)
                # corrected segment trimmed to the same span, on its own line
                proj = lambda t: c_p1[ci] + np.clip(
                    (t - (c_p1[ci] - a_p1[ai]) @ ua)
                    / max(uc @ ua, 1e-6), 0.0, lc) * uc
                corr_seg = (proj(o0), proj(o1))
                best = (anchor_seg, corr_seg)
    return best
