"""Checkerboard-parallel EnML batch localizer.

Port of hitl_slam_tpu/models/enml/parallel_localizer.py, in plain PyTorch.
The sequential sweep (localizer.batch_localize) seeds each window from the
previous window's solution, so it is one long chain. This module replaces
the chain with a red/black (checkerboard) decomposition of the trajectory:

  1. The trajectory is tiled into DISJOINT windows of W poses, at offsets 0
     (even parity) and W//2 (odd parity). The windows of one parity are
     independent given the current estimates, so a chunk of them is solved
     as ONE batched Gauss-Newton problem (localizer.window_gn_batched:
     [B, 3W, 3W] systems, one batched Cholesky a step).
  2. The sequential sweep's forward seeding is recovered to rigid motion by
     an SE(2) prefix-composition carry: window k's boundary correction is
     dT_k = T_new(last) T_old(last)^-1, and window j's block is
     premultiplied by carry_j = dT_0 ... dT_{j-1} (a log-depth scan of
     batched 3x3 products). Rigid carries keep every within-window factor
     (odometry and STF are relative).
  3. Alternating parities covers the cross-boundary factors; `n_passes`
     even/odd rounds stand in for a convergence loop.

Window matching: the brute [M, M] matcher for windows of W*N <=
BRUTE_MATCH_LIMIT points, else the grid matcher (ops/correspond.grid_match),
one window after another, feeding precomputed matches to the batched GN
(the reference's split driver: a batched grid match thrashes memory, the GN
steps batch well). Both routes run each match round as match -> batched GN
steps, which is what the reference's vmapped window solve computes.

On a device mesh (`mesh=`), the solve passes take every window of a parity
as one batch, and each device group of the mesh's first axis solves its
share of the windows (the reference shards the vmapped window solve over
that axis).

Covariances: an evaluation pass over the even tiling takes every pose's
3x3 marginal from its window Hessian at the FINAL estimates, rotated into
the pose frame; a window's first pose is pinned, so a second pass over the
odd tiling fills the poses 0, W, 2W, ... .

No host read inside the passes: window starts, masks and scatter rows are
numpy, built once and copied to the device before the first solve.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ...ops.correspond import grid_match
from ...ops.geometry import angle_mod, rotate
from ...parallel.mesh import groups_of
from .localizer import (EnmlOptions, _brute_window_match, _match_gates,
                        _odometry_targets, _pair_mask, window_gn_batched)

Tensor = torch.Tensor

# windows with more points than this use the grid matcher instead of the
# dense [M, M] distance matrix
BRUTE_MATCH_LIMIT = 4096


def _se2_mat(poses: Tensor) -> Tensor:
    """[..., 3] (x, y, th) -> [..., 3, 3] homogeneous."""
    c, s = torch.cos(poses[..., 2]), torch.sin(poses[..., 2])
    x, y = poses[..., 0], poses[..., 1]
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    return torch.stack([
        torch.stack([c, -s, x], -1),
        torch.stack([s, c, y], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=-2)


def _se2_apply(T: Tensor, poses: Tensor) -> Tensor:
    """Apply carry transform T [3, 3] (or [B, 1, 3, 3] batched) to poses
    [..., 3]: p -> R p + t, th -> th + dth."""
    xy = (T[..., :2, :2] @ poses[..., :2, None])[..., 0] + T[..., :2, 2]
    dth = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    return torch.cat([xy, (poses[..., 2] + dth)[..., None]], dim=-1)


def _gather_windows(arr: Tensor, starts: Tensor, W: int, fill_clamp: int):
    """[B] window starts -> [B, W, ...] gathered slices (indices clamped)."""
    idx = starts[:, None] + torch.arange(W, device=starts.device)[None, :]
    return arr[torch.clamp(idx, 0, fill_clamp)], idx


def _grid_capacities(W: int, N: int) -> tuple[int, int]:
    """(bucket, max_cells) for the window grid matcher: bucket 64 caps the
    densest cells (a figure-8 window of W = 80 has at most 887 occupied
    cells, the fullest holding 107 points); violations on denser data show
    in probe_match_capacity."""
    return 64, max(1024, min(4096, W * N // 16))


def _make_match_fn(flat_pts, flat_nrm, flat_mask, W, N, o: EnmlOptions):
    """Grid-hash window matcher with the same (tgt, valid) contract as the
    brute matcher; used when W*N exceeds BRUTE_MATCH_LIMIT."""
    pose_of = torch.arange(W, device=flat_pts.device)[:, None].expand(
        W, N).reshape(W * N)
    bucket, max_cells = _grid_capacities(W, N)
    # the reference passes the Python float cosine; grid_match rounds it to
    # the points' dtype once, as the reference's comparison does
    min_cos = math.cos(o.max_stf_angle_error)

    def match(poses):
        q = poses[pose_of]
        pw = (rotate(q[:, 2], flat_pts) + q[:, :2]).reshape(W, N, 2)
        nw = rotate(q[:, 2], flat_nrm).reshape(W, N, 2)
        m = grid_match(pw, nw, flat_mask.reshape(W, N),
                       threshold=o.point_match_threshold, min_cos=min_cos,
                       bucket=bucket, max_cells=max_cells)
        return m.target, m.valid

    return match


def window_covariances(H: Tensor, active: Tensor, th: Tensor) -> Tensor:
    """Per-pose 3x3 marginals from a window Hessian: mask inactive rows,
    regularize, invert, take diagonal blocks, rotate into each pose frame.
    H [..., 3W, 3W], active [..., W], th [..., W] -> [..., W, 3, 3]; any
    leading dims are windows. The inverse skips its host-side info check
    (`inv_ex`): a singular window gives non-finite values, as jnp's does."""
    W = th.shape[-1]
    dtype = H.dtype
    m3 = active.repeat_interleave(3, dim=-1)
    H = torch.where(m3[..., :, None] & m3[..., None, :], H, 0.0)
    H = H + torch.diag_embed(torch.where(m3, 1e-9, 1.0).to(dtype))
    if H.device.type == "cpu" and H.dim() > 2:
        # one window at a time: MKL's batched LU solve stalls on some
        # batches of [240, 240] window systems (W = 80) with more than one
        # thread, after reporting an invalid pivot; each matrix alone is
        # fine, and the arithmetic is the same
        flat = H.reshape(-1, 3 * W, 3 * W)
        cov_full = torch.stack([torch.linalg.inv_ex(h)[0] for h in flat]
                               ).reshape(H.shape)
    else:
        cov_full = torch.linalg.inv_ex(H)[0]
    blocks = cov_full.unflatten(-1, (W, 3)).unflatten(-3, (W, 3)).diagonal(
        dim1=-4, dim2=-2).movedim(-1, -3)                # [..., W, 3, 3]
    c, s_ = torch.cos(-th), torch.sin(-th)
    zero = torch.zeros_like(c)
    one_ = torch.ones_like(c)
    T = torch.stack([
        torch.stack([c, -s_, zero], -1),
        torch.stack([s_, c, zero], -1),
        torch.stack([zero, zero, one_], -1),
    ], dim=-2)
    return T @ blocks @ T.transpose(-1, -2)


def probe_match_capacity(
    points: Tensor,         # [P, N, 2] robot frame
    normals: Tensor,        # [P, N, 2]
    point_mask: Tensor,     # [P, N]
    poses: Tensor,          # [P, 3]
    options: EnmlOptions = EnmlOptions(),
    W: int | None = None,
) -> Tensor:
    """Total grid_match-dropped points over the even window tiling at the
    EXACT capacities checkerboard_localize's matcher uses, so that capacity
    violations on a new dataset are detectable, not silent.

    Returns a scalar int32 tensor on the points' device; 0 means every
    in-mask point was binned and matched exactly within its 3x3
    neighbourhood on this dataset."""
    o = options
    P, N, _ = points.shape
    W = min(o.max_history, P) if W is None else W
    bucket, max_cells = _grid_capacities(W, N)
    n_win = -(-P // W)
    idx = W * np.arange(n_win)[:, None] + np.arange(W)[None, :]
    dev = points.device
    idx_d = torch.as_tensor(np.clip(idx, 0, P - 1), device=dev)
    act_d = torch.as_tensor(idx < P, device=dev)
    min_cos = math.cos(o.max_stf_angle_error)
    total = torch.zeros((), dtype=torch.int32, device=dev)
    for k in range(n_win):
        i, active = idx_d[k], act_d[k]
        q = poses[i]
        pw = rotate(q[:, 2, None], points[i]) + q[:, None, :2]
        nw = rotate(q[:, 2, None], normals[i])
        m = grid_match(pw, nw, point_mask[i] & active[:, None],
                       threshold=o.point_match_threshold, min_cos=min_cos,
                       bucket=bucket, max_cells=max_cells)
        total = total + m.dropped
    return total


def _prefix_matmul(x: Tensor) -> Tensor:
    """Inclusive prefix products x0, x0 x1, x0 x1 x2, ... of [B, 3, 3] in
    ceil(log2 B) batched products (Hillis-Steele). The association order
    differs from a left fold, so results agree to round-off, not bits."""
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], x[:-d] @ x[d:]], 0)
        d *= 2
    return x


@dataclasses.dataclass
class _Tiling:
    """One parity's disjoint window tiling on the device: B real windows,
    padded to a multiple of the chunk width ck with fully inactive windows.
    Row tensors are [Bpad, W(-1)]; the per-window point data is gathered
    once (it does not depend on the poses)."""

    B: int
    ck: int
    idx: Tensor          # [Bpad, W] pose rows, clamped to [0, P - 1]
    active: Tensor       # [Bpad, W] row < P
    pin: Tensor          # [Bpad, W] ~active
    pts: Tensor          # [Bpad, W, N, 2]
    nrm: Tensor
    mask: Tensor         # [Bpad, W, N], inactive rows masked
    chain: tuple         # (axis, d, rot, isig, valid) of each window chain
    rows: Tensor         # [B * W] scatter rows, inactive -> P (dump row)
    old_last: Tensor     # [B] pose row of each window's last active pose
    last_j: Tensor       # [B] its window offset
    any_active: np.ndarray  # [B] host flags
    fill_odd: Tensor     # [Bpad * W] covariance rows of the odd tiling

    @property
    def n_chunked(self) -> int:
        """Windows in the chunks of ck that hold the real ones."""
        return -(-self.B // self.ck) * self.ck


def _tiling(parity, half, W, P, chunk, points, normals, point_mask,
            odo, n_shares=1) -> _Tiling:
    first = parity * half
    n_win = -(-(P - first) // W) if P > first else 0
    B = max(n_win, 1)
    starts = first + W * np.arange(B)
    # the batch width is clamped to the real window count: a padding
    # window costs as much as a real one; on a mesh the windows also split
    # into n_shares equal shares
    ck = max(min(chunk, B), 1)
    step = math.lcm(ck, n_shares)
    Bpad = -(-B // step) * step
    starts = np.concatenate([starts, np.full(Bpad - B, P + W)])
    idx = starts[:, None] + np.arange(W)[None, :]
    active = idx < P
    dev = points.device
    starts_d = torch.as_tensor(starts, device=dev)
    pts, idx_d = _gather_windows(points, starts_d, W, P - 1)
    cl = torch.clamp(idx_d, 0, P - 1)
    act = torch.as_tensor(active, device=dev)
    cidx = torch.as_tensor(np.clip(idx[:, :-1], 0, max(P - 2, 0)), device=dev)
    axis, d, rot, isig = odo
    chain = (axis[cidx], d[cidx], rot[cidx], isig[cidx],
             torch.as_tensor(idx[:, :-1] < P - 1, device=dev).to(
                 points.dtype))
    last_j = np.maximum(active[:B].sum(1) - 1, 0)
    # rows of the odd tiling that the even tiling cannot give (its pinned
    # window-first poses, multiples of W); the window-first offset of the
    # odd tiling is pinned too, so it never gives a marginal
    fill = active & (idx % W == 0) & (np.arange(W)[None, :] != 0)
    return _Tiling(
        B=B, ck=ck, idx=cl, active=act, pin=~act, pts=pts,
        nrm=_gather_windows(normals, starts_d, W, P - 1)[0],
        mask=_gather_windows(point_mask, starts_d, W, P - 1)[0]
        & act[..., None], chain=chain,
        rows=torch.as_tensor(np.where(active[:B], idx[:B], P).reshape(-1),
                             device=dev),
        old_last=torch.as_tensor(np.clip(starts[:B] + last_j, 0, P - 1),
                                 device=dev),
        last_j=torch.as_tensor(last_j, device=dev),
        any_active=active[:B].any(1),
        fill_odd=torch.as_tensor(np.where(fill, idx, P).reshape(-1),
                                 device=dev))


def _stage_clock(stage_ms: dict | None, device):
    """lap(name) adds the wall ms since the previous lap to stage_ms[name],
    after synchronising the device; without stage_ms it does nothing (and
    never synchronises)."""
    if stage_ms is None:
        return lambda name: None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    last = [time.perf_counter()]

    def lap(name):
        sync()
        now = time.perf_counter()
        stage_ms[name] = stage_ms.get(name, 0.0) + (now - last[0]) * 1e3
        last[0] = now

    return lap


def checkerboard_localize(
    points: Tensor,         # [P, N, 2] robot frame
    normals: Tensor,        # [P, N, 2]
    point_mask: Tensor,     # [P, N]
    initial_poses: Tensor,  # [P, 3] odometry-integrated estimates
    options: EnmlOptions = EnmlOptions(),
    n_passes: int = 2,
    chunk: int = 8,         # windows solved as one batch (memory bound)
    force_grid: bool = False,  # use the grid matcher regardless of size
    mesh=None,              # parallel.mesh.Mesh: windows over its 1st axis
    stage_ms: dict | None = None,  # receives wall ms per stage (synchronised)
) -> tuple[Tensor, Tensor]:
    """Full-trajectory batched sweep. Returns (poses [P, 3], covariances
    [P, 3, 3]) on the inputs' device.

    With a `mesh`, the solve passes take every window of a parity as one
    batch, padded to a multiple of the mesh's first axis with inactive
    windows, and each device group of that axis solves its contiguous share
    with the matcher inside the window solve (the reference's mesh branch:
    the brute matcher batched, the grid matcher window by window), its
    results coming back to the inputs' device. The covariance pass is
    chunked as without a mesh.

    `stage_ms`, when given, receives the wall ms of the window set-up
    ("setup"), the matches of the solve passes ("match"), the batched GN
    steps ("gn"), the SE(2) carry and the scatter ("carry_scatter") and the
    covariance pass with its own matches ("covariance"), synchronising the
    device at every boundary."""
    o = options
    P, N, _ = points.shape
    W = min(o.max_history, P)
    M = W * N
    half = max(W // 2, 1)
    dev, dtype = initial_poses.device, initial_poses.dtype
    lap = _stage_clock(stage_ms, dev)
    o_one_round = dataclasses.replace(o, match_rounds=1)
    gates = _match_gates(o, dev)
    use_grid = force_grid or (W * N > BRUTE_MATCH_LIMIT)
    pose_of = torch.arange(W, device=dev)[:, None].expand(W, N).reshape(M)
    eye = torch.eye(3, dtype=dtype, device=dev)

    odo = _odometry_targets(initial_poses, o)
    entries = [] if mesh is None else mesh.axis(mesh.axis_names[0])
    n_shares = max(len(entries), 1)
    tilings = [_tiling(0, half, W, P, chunk, points, normals, point_mask,
                       odo, n_shares)]
    if P > half:
        tilings.append(_tiling(1, half, W, P, chunk, points, normals,
                               point_mask, odo, n_shares))
    lap("setup")

    def match_chunk(tl, sl, wposes):
        """(tgt [ck, M], valid [ck, M]) of the chunk's windows at wposes:
        one batched brute match, or the grid matcher window by window."""
        pts = tl.pts[sl].reshape(-1, M, 2)
        nrm = tl.nrm[sl].reshape(-1, M, 2)
        msk = tl.mask[sl].reshape(-1, M)
        if not use_grid:
            return _brute_window_match(wposes, pts, nrm, msk, pose_of,
                                       *gates, _pair_mask(msk, pose_of))
        tv = [_make_match_fn(pts[k], nrm[k], msk[k], W, N, o)(wposes[k])
              for k in range(wposes.shape[0])]
        return (torch.stack([t for t, _ in tv]),
                torch.stack([v for _, v in tv]))

    def gn_chunk(tl, sl, wposes, tgt, valid, eval_only=False):
        return window_gn_batched(
            wposes, tl.pts[sl], tl.nrm[sl], tl.mask[sl],
            *(c[sl] for c in tl.chain), o_one_round,
            match_fn=lambda _p: (tgt, valid), w_pin=tl.pin[sl],
            eval_only=eval_only, need_hessian=eval_only, gates=gates)

    def mesh_solve(poses, tl):
        """Every window of the tiling, each device group its contiguous
        share, the matcher inside the window solve."""
        share = tl.idx.shape[0] // n_shares
        new_w = []
        for grp in groups_of(entries):
            g_dev = grp.device
            sl = slice(grp.lo * share, grp.hi * share)
            pts, nrm, msk = (a[sl].to(g_dev) for a in (tl.pts, tl.nrm,
                                                        tl.mask))
            w0 = poses.to(g_dev)[tl.idx[sl].to(g_dev)]
            match_fn = None
            if use_grid:
                # padding windows (from tl.B on) match nothing
                real = min(max(tl.B - sl.start, 0), sl.stop - sl.start)

                def match_fn(wp, pts=pts, nrm=nrm, msk=msk, real=real):
                    tgt = torch.zeros(wp.shape[0], M, dtype=torch.long,
                                      device=wp.device)
                    valid = torch.zeros(wp.shape[0], M, dtype=torch.bool,
                                        device=wp.device)
                    for i in range(real):
                        t_, v_ = _make_match_fn(
                            pts[i].reshape(M, 2), nrm[i].reshape(M, 2),
                            msk[i].reshape(M), W, N, o)(wp[i])
                        tgt[i], valid[i] = t_, v_
                    return tgt, valid
            wp = window_gn_batched(
                w0, pts, nrm, msk, *(c[sl].to(g_dev) for c in tl.chain), o,
                match_fn=match_fn, w_pin=tl.pin[sl].to(g_dev),
                need_hessian=False, gates=_match_gates(o, g_dev))[0]
            new_w.append(torch.where(tl.active[sl, :, None].to(g_dev), wp,
                                     w0).to(dev))
        lap("gn")
        return new_w

    def chunked_solve(poses, tl):
        new_w = []
        for lo in range(0, tl.n_chunked, tl.ck):
            sl = slice(lo, lo + tl.ck)
            w0 = poses[tl.idx[sl]]
            wp = w0
            for _ in range(o.match_rounds):
                tgt, valid = match_chunk(tl, sl, wp)
                lap("match")
                wp = gn_chunk(tl, sl, wp, tgt, valid)[0]
                lap("gn")
            new_w.append(torch.where(tl.active[sl, :, None], wp, w0))
        return new_w

    def half_pass(poses, tl):
        new_w = (chunked_solve if mesh is None else mesh_solve)(poses, tl)
        new_w = torch.cat(new_w)[:tl.B]                          # [B, W, 3]

        # SE(2) carry: boundary correction at each window's last ACTIVE pose
        old_last = poses[tl.old_last]
        new_last = new_w[torch.arange(tl.B, device=dev), tl.last_j]
        dT = _se2_mat(new_last) @ torch.linalg.inv_ex(_se2_mat(old_last))[0]
        if not tl.any_active.all():
            # windows with no active pose contribute identity
            dT = torch.where(torch.as_tensor(tl.any_active, device=dev)[
                :, None, None], dT, eye)
        carry = torch.cat([eye[None], _prefix_matmul(dT)[:-1]], 0)
        carried = _se2_apply(carry[:, None], new_w)               # [B, W, 3]
        # scatter back: disjoint windows; inactive rows land in the dump
        # row P, which is cut off (duplicate writes there are harmless)
        out = torch.cat([poses, poses.new_zeros((1, 3))])
        out.index_put_((tl.rows,), carried.reshape(-1, 3))
        lap("carry_scatter")
        return out[:P]

    poses = initial_poses
    for _ in range(n_passes):
        for tl in tilings:
            poses = half_pass(poses, tl)

    # ---- covariances: each window's Hessian AT the final estimates (one
    # match, one assembly, no GN step); the window-first pose is pinned, so
    # its block is no marginal: the even tiling gives every other pose, the
    # odd tiling the even tiling's window-first poses (0, W, 2W, ...) ----
    def eval_tiling(tl):
        covs = []
        for lo in range(0, tl.n_chunked, tl.ck):
            sl = slice(lo, lo + tl.ck)
            w0 = poses[tl.idx[sl]]
            tgt, valid = match_chunk(tl, sl, w0)
            np_, H = gn_chunk(tl, sl, w0, tgt, valid, eval_only=True)
            covs.append(window_covariances(H, tl.active[sl], np_[..., 2]))
        return torch.cat(covs).reshape(-1, 3, 3)         # [n_chunked * W]

    even = tilings[0]
    pinned = torch.arange(W, device=dev) == 0
    rows = torch.where(even.active & ~pinned, even.idx, P)[:even.n_chunked]
    covariances = torch.zeros((P + 1, 3, 3), dtype=dtype, device=dev)
    covariances.index_put_((rows.reshape(-1),), eval_tiling(even))
    if len(tilings) > 1:
        odd = tilings[1]
        covariances.index_put_((odd.fill_odd[:odd.n_chunked * W],),
                               eval_tiling(odd))
    covariances = covariances[:P]
    covariances[0] = eye * 1e-6
    lap("covariance")

    poses = torch.cat([poses[:, :2], angle_mod(poses[:, 2:])], -1)
    return poses, covariances
