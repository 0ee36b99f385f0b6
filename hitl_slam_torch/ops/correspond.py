"""Correspondence engine: grid-bucketed nearest-neighbour point matching.

Port of hitl_slam_tpu/ops/correspond.py. Every point of every pose looks for
its nearest neighbour in another pose within `threshold` whose normal agrees
within the STF angle gate. All points are binned once into a compact table
of occupied grid cells (cell size = match threshold) with a fixed per-cell
`bucket` capacity: one stable sort by cell key, then block gathers. The 3x3
neighbourhood search is dense batched arithmetic over
[max_cells, bucket, 5*bucket] tiles (the centre cell and 4 of its
neighbours; each neighbour tile also serves the opposite offset by reducing
over the query axis).

What the fixed capacities cost is counted, never silent:
  - points beyond `bucket` per cell or `max_cells` occupied cells, and points
    beyond the grid span (|coord| >= 16384 * threshold), take no part in the
    matching and are counted in `Matches.dropped`;
  - `pair_match_factors` counts voted pairs beyond `max_pairs` and factor
    rows beyond `capacity` in `PairMatchInfo`.

Every sort that decides which points survive a capacity clamp, or which row
stands for a run, is stable, and ties are broken by the lowest index, so the
results are the same on every device and from run to run. The two-term
products of the distance and normal gates are written out elementwise
(x*x' + y*y'), so the CPU and a CUDA device round them alike.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .geometry import perp, pose_to_world, rotate

Tensor = torch.Tensor

# reference config values
POINT_MATCH_THRESHOLD = 0.15
MAX_STF_ANGLE_ERROR = 25.0 * math.pi / 180.0
LASER_STD_DEV = 0.05
POINT_CORRELATION_FACTOR = 1.0 / 40.0
MIN_PAIR_MATCHES = 10        # smallest bundle of matches a pose pair keeps

_INT32_MAX = 2147483647
_MIN_COS = float(np.cos(MAX_STF_ANGLE_ERROR))


@dataclass(frozen=True)
class Matches:
    """Per-source-point best cross-pose match (flat indexing over P*N)."""

    target: Tensor   # [M] int32 flat index of matched point (0 if invalid)
    valid: Tensor    # [M] bool
    dist: Tensor     # [M] f32 distance to match
    dropped: Tensor  # scalar int32: in-mask points not binned (capacity clamp)


def nonzero_fixed(mask: Tensor, size: int, fill: int) -> Tensor:
    """Indices of the first `size` true entries of a 1-D mask, in ascending
    order, padded with `fill`: a fixed-length table built without a host
    read (true entries beyond `size` are left out; callers count them)."""
    n = mask.shape[0]
    pos = torch.arange(n, device=mask.device)
    slot = torch.cumsum(mask, 0) - 1
    keep = mask & (slot < size)
    # one dump row absorbs everything that is not kept; it is sliced off
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out[torch.where(keep, slot, size)] = pos
    return out[:size]


def _run_starts(sorted_key: Tensor) -> tuple[Tensor, Tensor]:
    """(is_new, run_start) over a sorted key vector: whether a row opens a
    run of equal keys, and the index of the row that opened its run."""
    n = sorted_key.shape[0]
    pos = torch.arange(n, device=sorted_key.device)
    is_new = torch.ones((n,), dtype=torch.bool, device=sorted_key.device)
    is_new[1:] = sorted_key[1:] != sorted_key[:-1]
    run_start = torch.cummax(torch.where(is_new, pos, 0), 0).values
    return is_new, run_start


def _run_ends(sorted_key: Tensor) -> tuple[Tensor, Tensor]:
    """(is_last, run_end) over a sorted key vector."""
    n = sorted_key.shape[0]
    pos = torch.arange(n, device=sorted_key.device)
    is_last = torch.ones((n,), dtype=torch.bool, device=sorted_key.device)
    is_last[:-1] = sorted_key[:-1] != sorted_key[1:]
    run_end = torch.cummin(torch.where(is_last, pos, n - 1).flip(0),
                           0).values.flip(0)
    return is_last, run_end


@functools.lru_cache(maxsize=8)
def _preshuffle(M: int) -> np.ndarray:
    """The fixed pseudo-random permutation of M points applied before the
    cell sort, so that a cell over its `bucket` capacity keeps an unbiased
    sample and not the lowest pose ids. It depends on M alone (treat the
    cached array as read-only)."""
    return np.argsort(
        (np.arange(M, dtype=np.int64) * -1640531527) & 0x7FFFFFFF,
        kind="stable")


def preshuffle_on(M: int, device) -> Tensor:
    """_preshuffle(M) on `device`, copied there once (a device program
    calls this before its capture, which cannot copy from the host)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _preshuffle_on(M, dev)


@functools.lru_cache(maxsize=8)
def _preshuffle_on(M: int, dev: torch.device) -> Tensor:
    return torch.as_tensor(_preshuffle(M), device=dev)


def grid_match(
    world_pts: Tensor,     # [P, N, 2]
    world_nrm: Tensor,     # [P, N, 2]
    mask: Tensor,          # [P, N]
    threshold: float = POINT_MATCH_THRESHOLD,
    min_cos: float = _MIN_COS,
    bucket: int = 64,      # per-cell point capacity (a density cap)
    max_cells: int | None = None,  # occupied-cell capacity (None: M // 32)
) -> Matches:
    """Exact best-in-3x3-neighbourhood nearest neighbour via dense bucket
    tables.

    Stage 1 (bin): stable-sort the flat points by integer cell key; cell c's
    bucket is then the contiguous sorted rows cell_start[c] .. +bucket-1, so
    the bucket table ([max_cells, bucket] slots of position, normal, pose id
    and flat index) is built by gathers alone.

    Stage 2 (match): each neighbour cell's compact id comes from one
    searchsorted over the sorted cell keys; the centre and 4 representative
    offsets' buckets form one [max_cells, bucket, 5*bucket] gated-distance
    tile (distance, normal gate, same-pose exclusion). Each +offset slice
    also serves the opposite offset by reducing over the query axis and
    writing to the neighbour's rows (the neighbour map is injective per
    offset). Exact whenever nothing is dropped (Matches.dropped == 0)."""
    P, N, _ = world_pts.shape
    M = P * N
    if max_cells is None:
        max_cells = max(1024, min(16384, M // 32))
    dtype, dev = world_pts.dtype, world_pts.device
    pts = world_pts.reshape(M, 2)
    nrm = world_nrm.reshape(M, 2)
    fmask = mask.reshape(M)

    # integer cell key: the offset keeps coordinates positive; a span of
    # 2^15 keeps the combined key within int32 for |coord| < 16384*threshold
    OFF, SPAN = 1 << 14, 1 << 15
    inv_h = 1.0 / threshold
    fx = torch.floor(pts[:, 0] * inv_h)
    fy = torch.floor(pts[:, 1] * inv_h)
    # coordinates beyond the grid span are masked out and counted in
    # `dropped`: clipping them into border cells would alias far-apart
    # points into spurious matches
    in_range = ((fx >= -OFF) & (fx < SPAN - OFF)
                & (fy >= -OFF) & (fy < SPAN - OFF))
    binnable = fmask & in_range
    ix = torch.where(in_range, fx, 0.0).to(torch.int64) + OFF
    iy = torch.where(in_range, fy, 0.0).to(torch.int64) + OFF
    key = torch.where(binnable, ix * SPAN + iy, _INT32_MAX)   # masked -> end

    pos = torch.arange(M, device=dev)
    perm = preshuffle_on(M, dev)
    order = perm[torch.argsort(key[perm], stable=True)]   # stable in cells
    skey = key[order]
    is_real = skey != _INT32_MAX
    is_new, run_start = _run_starts(skey)
    is_new = is_new & is_real
    # run_start of the real rows only matters: the masked tail is one run
    cid = torch.cumsum(is_new, 0) - 1                     # compact cell id
    rank = pos - run_start

    slot_ok = is_real & (rank < bucket) & (cid < max_cells)
    dropped = (torch.sum(is_real & ~slot_ok)
               + torch.sum(fmask & ~in_range)).to(torch.int32)

    # bucket table by gather: the sort grouped the points by cell, so cell
    # c's slots are the sorted rows cell_start[c] .. cell_start[c]+bucket-1
    n_real = torch.sum(is_real)
    cell_start = nonzero_fixed(is_new, max_cells, M)
    cell_end = torch.clamp(
        torch.cat([cell_start[1:], cell_start.new_full((1,), M)]),
        max=n_real)
    slot_idx = cell_start[:, None] + torch.arange(bucket, device=dev)
    occ = slot_idx < cell_end[:, None]                 # false for fills too
    fidx_tab = torch.where(occ, order[torch.clamp(slot_idx, 0, M - 1)], 0)
    pose_tab = fidx_tab // N                           # [K, B]
    p_tab = torch.where(occ[:, :, None], pts[fidx_tab], 0.0)
    n_tab = torch.where(occ[:, :, None], nrm[fidx_tab], 0.0)

    # sorted occupied-cell keys (ascending, fills -> INT32_MAX at the end)
    ucell = torch.where(cell_start < M,
                        skey[torch.clamp(cell_start, max=M - 1)], _INT32_MAX)

    # recentre all slot coordinates on the owning cell's centre: pairwise
    # terms then involve only O(threshold) magnitudes (no |world|^2
    # cancellation in the expanded distance)
    kx = ucell // SPAN
    ky = ucell - kx * SPAN
    center = (torch.stack([kx, ky], -1).to(dtype) - (OFF - 0.5)) * threshold
    # unoccupied slots also serve as candidates in the reverse-offset
    # reduction: push them out of range
    q_rel = torch.where(occ[:, :, None], p_tab - center[:, None, :], 1e3)

    t2 = torch.full((), threshold * threshold, dtype=dtype, device=dev)
    cmin = torch.full((), min_cos, dtype=dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    # one dump row at index max_cells absorbs the reverse-side updates of
    # queries with no such neighbour; nothing reads it back
    best_d2 = torch.full((max_cells + 1, bucket), float("inf"), dtype=dtype,
                         device=dev)
    best_tgt = torch.zeros((max_cells + 1, bucket), dtype=torch.int64,
                           device=dev)

    qq = q_rel[:, :, 0] * q_rel[:, :, 0] + q_rel[:, :, 1] * q_rel[:, :, 1]

    # one concatenated candidate table for the symmetric half-stencil
    offs = ((1, 0), (0, 1), (1, 1), (1, -1))
    G = 1 + len(offs)
    real_cell = ucell != _INT32_MAX
    nbs = [torch.arange(max_cells, device=dev)]        # centre: identity
    oks = [real_cell]
    for dx, dy in offs:
        qk = torch.where(real_cell, ucell + (dx * SPAN + dy), _INT32_MAX)
        nb = torch.clamp(torch.searchsorted(ucell, qk), max=max_cells - 1)
        nbs.append(nb)
        oks.append((ucell[nb] == qk) & (qk != _INT32_MAX))
    nb_all = torch.stack(nbs, 1)                       # [K, G]
    ok_all = torch.stack(oks, 1)                       # [K, G]
    GB = G * bucket
    cand_fidx = fidx_tab[nb_all].reshape(max_cells, GB)
    cand_pose = pose_tab[nb_all].reshape(max_cells, GB)
    cand_p = p_tab[nb_all].reshape(max_cells, GB, 2)
    cand_n = n_tab[nb_all].reshape(max_cells, GB, 2)
    cand_occ = occ[nb_all].reshape(max_cells, GB)
    ok_flat = ok_all[:, :, None].expand(max_cells, G, bucket).reshape(
        max_cells, GB)

    # gated pairwise distances [K, Bq, G*B]: d2 = (|q|^2 + |c|^2) - 2 q.c,
    # the two-term products written out elementwise
    bad = ~(ok_flat & cand_occ)
    c_rel = torch.where(bad[:, :, None], 1e3, cand_p - center[:, None, :])
    cc = c_rel[:, :, 0] * c_rel[:, :, 0] + c_rel[:, :, 1] * c_rel[:, :, 1]
    cross = q_rel[:, :, None, 0] * c_rel[:, None, :, 0]
    cross += q_rel[:, :, None, 1] * c_rel[:, None, :, 1]
    d2 = qq[:, :, None] + cc[:, None, :]
    d2 -= cross.mul_(2.0)
    cos = torch.mul(n_tab[:, :, None, 0], cand_n[:, None, :, 0], out=cross)
    cos += n_tab[:, :, None, 1] * cand_n[:, None, :, 1]
    good = ((d2 < t2) & (cos > cmin)
            & (pose_tab[:, :, None] != cand_pose[:, None, :]))
    d2e = torch.where(good, d2, inf)                   # [K, Bq, G*B]
    del cross, cos, d2, good

    # forward reduction: each query's best over all 5 candidate groups;
    # among equal distances the highest flat index wins
    dm = torch.amin(d2e, 2)
    hit = (d2e <= dm[:, :, None]) & torch.isfinite(dm)[:, :, None]
    tm = torch.amax(torch.where(hit, cand_fidx[:, None, :], -1), 2)
    best_d2[:max_cells] = dm
    best_tgt[:max_cells] = tm

    # reverse reductions: the +offset slice, reduced over the query axis,
    # gives the candidates' best among this cell's queries
    for g in range(1, G):
        sl = d2e[:, :, g * bucket:(g + 1) * bucket]
        dmr = torch.amin(sl, 1)                        # [K, Bc]
        hitr = (sl <= dmr[:, None, :]) & torch.isfinite(dmr)[:, None, :]
        tmr = torch.amax(torch.where(hitr, fidx_tab[:, :, None], -1), 1)
        rows = torch.where(oks[g], nbs[g], max_cells)
        old_d = best_d2[rows]
        old_t = best_tgt[rows]
        updr = dmr < old_d
        best_d2[rows] = torch.where(updr, dmr, old_d)
        best_tgt[rows] = torch.where(updr, tmr, old_t)

    best_d2 = best_d2[:max_cells].reshape(-1)
    best_tgt = best_tgt[:max_cells].reshape(-1)

    # read each sorted point's result back from its slot, then unsort
    # through the permutation; sorted row pos sits at table[cid, rank]
    safe_slot = torch.where(slot_ok, cid * bucket + rank, 0)
    d2_sorted = torch.where(slot_ok, best_d2[safe_slot], inf)
    tgt_sorted = torch.where(slot_ok, best_tgt[safe_slot], 0)
    d2_res = torch.empty((M,), dtype=dtype, device=dev)
    tgt_res = torch.empty((M,), dtype=torch.int64, device=dev)
    d2_res[order] = d2_sorted
    tgt_res[order] = tgt_sorted
    valid = torch.isfinite(d2_res)
    return Matches(
        target=torch.where(valid, tgt_res, 0).to(torch.int32),
        valid=valid,
        # the expanded (|q|^2 + |c|^2) - 2 q.c can round slightly negative
        # for near-coincident points: clamp before the square root
        dist=torch.sqrt(torch.clamp(torch.where(valid, d2_res, 0.0),
                                    min=0.0)),
        dropped=dropped)


@dataclass(frozen=True)
class STFFactors:
    """Compacted symmetric point-to-plane factors with static capacity C.

    With p0/p1 and n0/n1 the matched points and normals in their poses'
    robot frames,
        r0 = w * n0_world . (p1_world - p0_world)
        r1 = w * n1_world . (p1_world - p0_world)
    where w folds std_dev, the correlation factor and the per-bundle RMS
    normalization 1/sqrt(n_matches(pair)).
    """

    pose0: Tensor   # [C] int32
    pose1: Tensor   # [C] int32
    p0: Tensor      # [C, 2] robot frame of pose0
    p1: Tensor      # [C, 2] robot frame of pose1
    n0: Tensor      # [C, 2]
    n1: Tensor      # [C, 2]
    weight: Tensor  # [C]
    valid: Tensor   # [C] bool

    def take(self, idx: Tensor) -> "STFFactors":
        """The table with its rows gathered through `idx`."""
        return STFFactors(**{f.name: getattr(self, f.name)[idx]
                             for f in dataclasses.fields(self)})


def _compact_rows(valid: Tensor, capacity: int) -> tuple[Tensor, Tensor]:
    """(perm [capacity] int64, filled [capacity] bool): the indices of the
    first `capacity` valid rows in order, and which slots hold one."""
    perm = nonzero_fixed(valid, capacity, -1)
    filled = perm >= 0
    return torch.clamp(perm, min=0), filled


def build_stf_factors(
    points: Tensor,    # [P, N, 2] robot frame
    normals: Tensor,   # [P, N, 2] robot frame
    matches: Matches,
    capacity: int = 65536,
    std_dev: float = LASER_STD_DEV,
    correlation_factor: float = POINT_CORRELATION_FACTOR,
    min_pair_matches: int = MIN_PAIR_MATCHES,
) -> STFFactors:
    """Each matched source point contributes one symmetric factor (both
    normals in the residual). Bundles (matches of one (pose0, pose1) pair)
    smaller than `min_pair_matches` are dropped whole; the rest are weighted
    by 1/sqrt(bundle size) and compacted, in source order, into a table of
    `capacity` rows."""
    P, N, _ = points.shape
    M = P * N
    dtype, dev = points.dtype, points.device
    flat_pts = points.reshape(M, 2)
    flat_nrm = normals.reshape(M, 2)
    src = torch.arange(M, device=dev)
    tgt = matches.target.long()
    pose0 = src // N
    pose1 = tgt // N
    valid = matches.valid

    # per-(pose0, pose1) bundle sizes: run boundaries in pair-sorted order,
    # unsorted through the permutation
    pair_key = torch.where(valid, pose0 * P + pose1, _INT32_MAX)
    sorted_key, sort_idx = torch.sort(pair_key, stable=True)
    _, run_start = _run_starts(sorted_key)
    _, run_end = _run_ends(sorted_key)
    count_sorted = (run_end - run_start + 1).to(dtype)
    pair_count = torch.empty((M,), dtype=dtype, device=dev)
    pair_count[sort_idx] = count_sorted
    valid = valid & (pair_count >= min_pair_matches)

    w = (correlation_factor / std_dev) / torch.sqrt(
        torch.clamp(pair_count, min=1.0))

    perm, filled = _compact_rows(valid, capacity)
    perm_tgt = tgt[perm]
    f2 = filled[:, None]
    return STFFactors(
        pose0=torch.where(filled, perm // N, 0).to(torch.int32),
        pose1=torch.where(filled, perm_tgt // N, 0).to(torch.int32),
        p0=torch.where(f2, flat_pts[perm], 0.0),
        p1=torch.where(f2, flat_pts[perm_tgt], 0.0),
        n0=torch.where(f2, flat_nrm[perm], 0.0),
        n1=torch.where(f2, flat_nrm[perm_tgt], 0.0),
        weight=torch.where(filled, w[perm], 0.0),
        valid=filled,
    )


def _factor_geometry(f: STFFactors, poses: Tensor):
    q0 = poses[f.pose0.long()]
    q1 = poses[f.pose1.long()]
    p0w = rotate(q0[:, 2], f.p0) + q0[:, :2]
    p1w = rotate(q1[:, 2], f.p1) + q1[:, :2]
    n0w = rotate(q0[:, 2], f.n0)
    n1w = rotate(q1[:, 2], f.n1)
    return q0, q1, p0w, p1w, n0w, n1w


def stf_residuals(f: STFFactors, poses: Tensor) -> Tensor:
    """[C, 2] symmetric point-to-plane residuals at `poses`."""
    _, _, p0w, p1w, n0w, n1w = _factor_geometry(f, poses)
    dp = p1w - p0w
    r0 = torch.sum(n0w * dp, dim=-1) * f.weight
    r1 = torch.sum(n1w * dp, dim=-1) * f.weight
    r = torch.stack([r0, r1], dim=-1)
    return torch.where(f.valid[:, None], r, 0.0)


def stf_jacobians(f: STFFactors, poses: Tensor) -> tuple[Tensor, Tensor]:
    """Analytic Jacobians wrt (pose0, pose1): each [C, 2, 3].

    d r0 / d pose0: translation -w n0w; rotation w (n0w' . dp - n0w . p0w'),
    where v' = d(R(th) v)/dth = perp(R v).
    """
    q0, q1, p0w, p1w, n0w, n1w = _factor_geometry(f, poses)
    dp = p1w - p0w
    w = f.weight

    dp0_dth = perp(p0w - q0[:, :2])     # d p0w / d th0
    dp1_dth = perp(p1w - q1[:, :2])
    dn0_dth = perp(n0w)
    dn1_dth = perp(n1w)

    # r0 = w n0w . dp
    r0_t0 = -w[:, None] * n0w
    r0_th0 = w * (torch.sum(dn0_dth * dp, -1) - torch.sum(n0w * dp0_dth, -1))
    r0_t1 = w[:, None] * n0w
    r0_th1 = w * torch.sum(n0w * dp1_dth, -1)
    # r1 = w n1w . dp
    r1_t0 = -w[:, None] * n1w
    r1_th0 = -w * torch.sum(n1w * dp0_dth, -1)
    r1_t1 = w[:, None] * n1w
    r1_th1 = w * (torch.sum(dn1_dth * dp, -1) + torch.sum(n1w * dp1_dth, -1))

    J0 = torch.stack([
        torch.cat([r0_t0, r0_th0[:, None]], -1),
        torch.cat([r1_t0, r1_th0[:, None]], -1),
    ], dim=1)
    J1 = torch.stack([
        torch.cat([r0_t1, r0_th1[:, None]], -1),
        torch.cat([r1_t1, r1_th1[:, None]], -1),
    ], dim=1)
    v = f.valid[:, None, None]
    return torch.where(v, J0, 0.0), torch.where(v, J1, 0.0)


@dataclass(frozen=True)
class PairMatchInfo:
    """Diagnostics of the per-pair matcher (all device scalars)."""

    n_pairs: Tensor          # pose pairs that cleared min_pair_matches
    n_matches: Tensor        # factor rows emitted (pre-capacity)
    grid_dropped: Tensor     # stage-1 grid capacity/span drops
    pairs_overflow: Tensor   # voted pairs beyond max_pairs
    rows_overflow: Tensor    # emitted rows beyond `capacity`


def pair_match_factors(
    points: Tensor,       # [P, N, 2] robot frame
    normals: Tensor,      # [P, N, 2]
    point_mask: Tensor,   # [P, N]
    poses: Tensor,        # [P, 3]
    max_pairs: int = 8192,
    capacity: int = 65536,
    threshold: float = POINT_MATCH_THRESHOLD,
    min_cos: float = _MIN_COS,
    std_dev: float = LASER_STD_DEV,
    correlation_factor: float = POINT_CORRELATION_FACTOR,
    min_pair_matches: int = MIN_PAIR_MATCHES,
    pair_chunk: int | None = None,
    bucket: int = 64,
    max_cells: int | None = None,
    elect_impl: str = "top_k",
) -> tuple[STFFactors, PairMatchInfo]:
    """Per-pair STF correspondences.

    `grid_match` gives each point its single best cross-pose neighbour; on
    heavily re-traversed maps that neighbour is an arbitrary choice among
    near-duplicates, the matches fragment across thousands of pose pairs,
    and the `min_pair_matches` bundle gate kills them all. This matcher
    works per pose pair, in two stages:
      1. VOTE: grid_match's output is a proximity vote. Sort the (min, max)
         pose-pair keys, count runs, elect the `max_pairs` most-voted pairs
         (ties to the lowest sorted position).
      2. MATCH: for each elected pair, one dense [N, N] gated distance tile
         gives every source point of the lower pose its best neighbour in
         the other (ties to the lowest index), `pair_chunk` pairs at a time.

    Emits one symmetric factor per (pair, source point) weighted by
    1/sqrt(bundle size); bundles below `min_pair_matches` are dropped whole.
    `elect_impl` names the reference's two ways of electing ("top_k",
    "argsort"); both are a stable descending sort here and elect the same
    pairs.
    """
    if elect_impl not in ("top_k", "argsort"):
        raise ValueError(f"unknown elect_impl {elect_impl!r}")
    P, N, _ = points.shape
    M = P * N
    dtype, dev = points.dtype, points.device
    if pair_chunk is None:
        # larger chunks amortize per-chunk overhead while the [chunk, N, N]
        # tile is small
        pair_chunk = 2048 if N <= 64 else 512

    world = pose_to_world(poses[:, None, :], points)
    wnrm = rotate(poses[:, 2][:, None], normals)

    # ---- stage 1: pair election by global-NN vote -------------------------
    m = grid_match(world, wnrm, point_mask, threshold, min_cos, bucket,
                   max_cells)
    src_pose = torch.arange(M, device=dev) // N
    tgt_pose = m.target.long() // N
    pi_ = torch.minimum(src_pose, tgt_pose)
    pj_ = torch.maximum(src_pose, tgt_pose)
    key = torch.where(m.valid, pi_ * P + pj_, _INT32_MAX)
    skey = torch.sort(key).values
    pos = torch.arange(M, device=dev)
    _, run_start = _run_starts(skey)
    is_last, _ = _run_ends(skey)
    is_last = is_last & (skey != _INT32_MAX)
    votes = torch.where(is_last, pos - run_start + 1, -1)
    # tiny maps (P*N < max_pairs) elect every row
    k = min(max_pairs, M)
    if elect_impl == "argsort":
        topi = torch.argsort(-votes, stable=True)[:k]
        topv = votes[topi]
    else:
        topv, topi = torch.sort(votes, descending=True, stable=True)
        topv, topi = topv[:k], topi[:k]
    if k < max_pairs:
        topv = torch.nn.functional.pad(topv, (0, max_pairs - k), value=-1)
        topi = torch.nn.functional.pad(topi, (0, max_pairs - k))
    pair_ok = topv > 0
    pair_key = skey[topi]
    pi = torch.where(pair_ok, pair_key // P, 0)
    pj = torch.where(pair_ok, pair_key % P, 0)
    n_voted = torch.sum(is_last)
    pairs_overflow = torch.clamp(n_voted - k, min=0)

    # ---- stage 2: dense per-pair NN ---------------------------------------
    t2 = torch.full((), threshold * threshold, dtype=dtype, device=dev)
    cmin = torch.full((), min_cos, dtype=dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    col = torch.arange(N, device=dev)
    tgts, ok_rows = [], []
    for lo in range(0, max_pairs, pair_chunk):
        ci, cj = pi[lo:lo + pair_chunk], pj[lo:lo + pair_chunk]
        cok = pair_ok[lo:lo + pair_chunk]
        a_pts, b_pts = world[ci], world[cj]            # [c, N, 2]
        a_nrm, b_nrm = wnrm[ci], wnrm[cj]
        dx = a_pts[:, :, None, 0] - b_pts[:, None, :, 0]
        dy = a_pts[:, :, None, 1] - b_pts[:, None, :, 1]
        d2 = dx * dx + dy * dy                         # [c, N, N]
        cosn = (a_nrm[:, :, None, 0] * b_nrm[:, None, :, 0]
                + a_nrm[:, :, None, 1] * b_nrm[:, None, :, 1])
        ok = (point_mask[ci][:, :, None] & point_mask[cj][:, None, :]
              & (d2 < t2) & (cosn > cmin) & cok[:, None, None])
        d2m = torch.where(ok, d2, inf)
        dmin = torch.amin(d2m, 2)
        # the first index that attains the minimum
        tgts.append(torch.amin(torch.where(d2m == dmin[:, :, None], col, N),
                               2))
        ok_rows.append(torch.isfinite(dmin))
    tgt = torch.cat(tgts)                              # [K, N]
    ok_row = torch.cat(ok_rows)
    counts = torch.sum(ok_row, dim=1)                  # [K]
    good = counts >= min_pair_matches
    w_pair = (correlation_factor / std_dev) / torch.sqrt(
        torch.clamp(counts.to(dtype), min=1.0))
    valid_rows = ok_row & good[:, None]                # [K, N]

    # ---- emit + compact: row r = (pair r // N, source point r % N) ---------
    vflat = valid_rows.reshape(max_pairs * N)
    perm, filled = _compact_rows(vflat, capacity)
    pk, pn = perm // N, perm % N
    pose0, pose1 = pi[pk], pj[pk]
    ptgt = tgt[pk, pn]
    f2 = filled[:, None]
    n_matches = torch.sum(vflat)
    factors = STFFactors(
        pose0=torch.where(filled, pose0, 0).to(torch.int32),
        pose1=torch.where(filled, pose1, 0).to(torch.int32),
        p0=torch.where(f2, points[pose0, pn], 0.0),
        p1=torch.where(f2, points[pose1, ptgt], 0.0),
        n0=torch.where(f2, normals[pose0, pn], 0.0),
        n1=torch.where(f2, normals[pose1, ptgt], 0.0),
        weight=torch.where(filled, w_pair[pk], 0.0),
        valid=filled,
    )
    info = PairMatchInfo(
        n_pairs=torch.sum(good).to(torch.int32),
        n_matches=n_matches.to(torch.int32),
        grid_dropped=m.dropped,
        pairs_overflow=pairs_overflow.to(torch.int32),
        rows_overflow=torch.clamp(n_matches - capacity, min=0).to(torch.int32),
    )
    return factors, info
