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

No host read inside the passes: window starts, masks and scatter rows
(each parity's `_Plan`) are numpy, built from (P, W, chunk) alone and
copied to the device before the first solve, or before a program's
capture. The chunk loops are `device_for`s over a chunk index held on the
device, so on a CUDA device the whole localizer is one captured program
(models/enml/program.py::CheckerboardProgram), replayed by a call.
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
from ...utils.device_loop import device_for, replays
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
    if H.dim() > 2:
        # one window at a time: on the CPU, MKL's batched LU solve stalls
        # on some batches of [240, 240] window systems (W = 80) with more
        # than one thread, after reporting an invalid pivot; on the card,
        # PyTorch hands a batch of [240, 240] systems to MAGMA, which
        # synchronises with the host and cannot be captured, where one
        # system alone goes to cuSOLVER (scripts/linalg_capture_probe.py
        # --batched). Each matrix alone is fine, and the arithmetic is the
        # same
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
class _Plan:
    """One parity's disjoint window tiling, from (P, W, chunk, n_shares)
    alone: B real windows, padded to Bpad (a multiple of the chunk width
    ck and of n_shares) with fully inactive windows. Its index rows and
    masks are device tensors made from numpy before any capture (a
    program's warm()); `any_active` is also kept on the host, where it
    makes a static choice."""

    B: int
    ck: int
    idx: Tensor          # [Bpad, W] pose rows, clamped to [0, P - 1]
    active: Tensor       # [Bpad, W] row < P
    cidx: Tensor         # [Bpad, W - 1] chain factor rows, clamped
    chain_ok: Tensor     # [Bpad, W - 1] the chain factor exists
    rows: Tensor         # [B * W] scatter rows, inactive -> P (dump row)
    old_last: Tensor     # [B] pose row of each window's last active pose
    last_j: Tensor       # [B] its window offset
    any_active: np.ndarray  # [B] host flags
    any_active_d: Tensor    # [B] the same on the device
    fill_odd: Tensor     # [Bpad * W] covariance rows of the odd tiling

    @property
    def n_chunked(self) -> int:
        """Windows in the chunks of ck that hold the real ones."""
        return -(-self.B // self.ck) * self.ck

    @property
    def n_chunks(self) -> int:
        return self.n_chunked // self.ck


def _plan(parity, half, W, P, chunk, n_shares, device) -> _Plan:
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
    last_j = np.maximum(active[:B].sum(1) - 1, 0)
    # rows of the odd tiling that the even tiling cannot give (its pinned
    # window-first poses, multiples of W); the window-first offset of the
    # odd tiling is pinned too, so it never gives a marginal
    fill = active & (idx % W == 0) & (np.arange(W)[None, :] != 0)
    any_active = active[:B].any(1)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return _Plan(
        B=B, ck=ck, idx=dev(np.clip(idx, 0, P - 1)), active=dev(active),
        cidx=dev(np.clip(idx[:, :-1], 0, max(P - 2, 0))),
        chain_ok=dev(idx[:, :-1] < P - 1),
        rows=dev(np.where(active[:B], idx[:B], P).reshape(-1)),
        old_last=dev(np.clip(starts[:B] + last_j, 0, P - 1)),
        last_j=dev(last_j), any_active=any_active,
        any_active_d=dev(any_active),
        fill_odd=dev(np.where(fill, idx, P).reshape(-1)))


def _plans(P: int, W: int, chunk: int, n_shares: int,
           device) -> tuple[_Plan, ...]:
    """The even tiling's plan, and the odd one's where P > W // 2."""
    half = max(W // 2, 1)
    out = [_plan(0, half, W, P, chunk, n_shares, device)]
    if P > half:
        out.append(_plan(1, half, W, P, chunk, n_shares, device))
    return tuple(out)


@dataclasses.dataclass
class _Chunk:
    """The data of a chunk's windows: pin [ck, W], pts / nrm [ck, W, N, 2],
    mask [ck, W, N] (inactive rows masked) and the chain factors (axis, d,
    rot, isig, valid) [ck, W - 1, ...]."""

    pin: Tensor
    pts: Tensor
    nrm: Tensor
    mask: Tensor
    chain: tuple


@dataclasses.dataclass
class _Tiling(_Plan):
    """A plan with its windows' data gathered from the inputs (it does not
    depend on the poses), every window's as a _Chunk's [Bpad, ...]."""

    data: _Chunk

    def take(self, sel: Tensor) -> _Chunk:
        """The data of the windows `sel` ([ck] rows of Bpad), gathered on
        the device."""
        d = self.data

        def pick(a):
            return a.index_select(0, sel)

        return _Chunk(pin=pick(d.pin), pts=pick(d.pts), nrm=pick(d.nrm),
                      mask=pick(d.mask), chain=tuple(pick(c) for c in d.chain))


def _tiling(pl: _Plan, points, normals, point_mask, odo) -> _Tiling:
    Bpad, W = pl.idx.shape
    flat = pl.idx.reshape(-1)

    def gather(a):
        return a.index_select(0, flat).reshape(Bpad, W, *a.shape[1:])

    cflat = pl.cidx.reshape(-1)
    axis, d, rot, isig = odo
    chain = tuple(c.index_select(0, cflat).reshape(Bpad, W - 1, *c.shape[1:])
                  for c in (axis, d, rot, isig))
    return _Tiling(
        **{f.name: getattr(pl, f.name) for f in dataclasses.fields(pl)},
        data=_Chunk(pin=~pl.active, pts=gather(points), nrm=gather(normals),
                    mask=gather(point_mask) & pl.active[..., None],
                    chain=chain + (pl.chain_ok.to(points.dtype),)))


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
    *,
    eager: bool = False,
) -> tuple[Tensor, Tensor]:
    """Full-trajectory batched sweep. Returns (poses [P, 3], covariances
    [P, 3, 3]) on the inputs' device.

    Each chunk loop (a solve pass's chunks with their match rounds, the
    covariance pass's chunks) is a `device_for` over a chunk index held on
    the device, and with the grid matcher a chunk's window matches are one
    inside it, as the reference's `lax.map`s. On a CUDA device the call
    replays the shape's CheckerboardProgram (models/enml/program.py: one
    CUDA graph, 2 n_passes + 2 WHILE nodes, the SE(2) carries and scatters
    between them), unless `eager`, which runs the same code eagerly there,
    for comparisons only. Two calls stay eager: one with a `mesh` (one
    graph on one device cannot hold the device groups' copies) and one
    with `stage_ms` (its clock synchronises at every stage boundary).

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
    if mesh is None and stage_ms is None and replays(initial_poses, eager):
        from .program import checkerboard_program

        return checkerboard_program(points, options, n_passes, chunk,
                                    force_grid).run(
            points, normals, point_mask, initial_poses)
    o = options
    P = points.shape[0]
    dev = initial_poses.device
    lap = _stage_clock(stage_ms, dev)
    entries = [] if mesh is None else mesh.axis(mesh.axis_names[0])
    plans = _plans(P, min(o.max_history, P), chunk, max(len(entries), 1),
                   dev)
    return _checkerboard(points, normals, point_mask, initial_poses, o,
                         n_passes, force_grid, plans, _match_gates(o, dev),
                         entries, lap)


def _checkerboard(points, normals, point_mask, initial_poses,
                  o: EnmlOptions, n_passes: int, force_grid: bool,
                  plans: tuple, gates, entries=(), lap=None):
    """checkerboard_localize's passes over the tilings `plans` (from
    _plans), eager or captured; `entries` the mesh's first axis (none: the
    chunked solve), `lap` the stage clock."""
    P, N, _ = points.shape
    W = min(o.max_history, P)
    M = W * N
    dev, dtype = initial_poses.device, initial_poses.dtype
    if lap is None:
        lap = _stage_clock(None, dev)
    o_one_round = dataclasses.replace(o, match_rounds=1)
    use_grid = force_grid or (W * N > BRUTE_MATCH_LIMIT)
    pose_of = torch.arange(W, device=dev)[:, None].expand(W, N).reshape(M)
    eye = torch.eye(3, dtype=dtype, device=dev)

    odo = _odometry_targets(initial_poses, o)
    n_shares = max(len(entries), 1)
    tilings = [_tiling(pl, points, normals, point_mask, odo) for pl in plans]
    lap("setup")

    def match_chunk(ch, wposes):
        """(tgt [ck, M], valid [ck, M]) of the chunk's windows at wposes:
        one batched brute match, or the grid matcher window by window (a
        loop over the chunk's windows)."""
        pts = ch.pts.reshape(-1, M, 2)
        nrm = ch.nrm.reshape(-1, M, 2)
        msk = ch.mask.reshape(-1, M)
        if not use_grid:
            return _brute_window_match(wposes, pts, nrm, msk, pose_of,
                                       *gates, _pair_mask(msk, pose_of))
        ck = wposes.shape[0]
        tgt = torch.empty((ck, M), dtype=torch.int32, device=dev)
        valid = torch.empty((ck, M), dtype=torch.bool, device=dev)

        def window(j):
            j1 = j.reshape(1)
            t_, v_ = _make_match_fn(
                pts.index_select(0, j1)[0], nrm.index_select(0, j1)[0],
                msk.index_select(0, j1)[0], W, N, o)(
                    wposes.index_select(0, j1)[0])
            tgt.index_copy_(0, j1, t_[None])
            valid.index_copy_(0, j1, v_[None])

        device_for(ck, window, dev, name="window")
        return tgt, valid

    def gn_chunk(ch, wposes, tgt, valid, eval_only=False):
        return window_gn_batched(
            wposes, ch.pts, ch.nrm, ch.mask, *ch.chain, o_one_round,
            match_fn=lambda _p: (tgt, valid), w_pin=ch.pin,
            eval_only=eval_only, need_hessian=eval_only, gates=gates)

    def window_poses(poses, ch_idx):
        """[ck, W, 3] poses of the windows with pose rows ch_idx [ck, W]."""
        return poses.index_select(0, ch_idx.reshape(-1)).reshape(
            *ch_idx.shape, 3)

    def mesh_solve(poses, tl):
        """Every window of the tiling, each device group its contiguous
        share, the matcher inside the window solve."""
        share = tl.idx.shape[0] // n_shares
        new_w = []
        for grp in groups_of(entries):
            g_dev = grp.device
            sl = slice(grp.lo * share, grp.hi * share)
            d = tl.data
            pts, nrm, msk = (a[sl].to(g_dev) for a in (d.pts, d.nrm, d.mask))
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
                w0, pts, nrm, msk, *(c[sl].to(g_dev) for c in d.chain), o,
                match_fn=match_fn, w_pin=d.pin[sl].to(g_dev),
                need_hessian=False, gates=_match_gates(o, g_dev))[0]
            new_w.append(torch.where(tl.active[sl, :, None].to(g_dev), wp,
                                     w0).to(dev))
        lap("gn")
        return torch.cat(new_w)

    def chunked_solve(poses, tl):
        """[n_chunked, W, 3]: each chunk's windows after its match rounds,
        a loop over the chunks."""
        ck = tl.ck
        ar = torch.arange(ck, device=dev)
        out = torch.empty((tl.n_chunked, W, 3), dtype=dtype, device=dev)

        def trip(c):
            sel = c * ck + ar
            ch = tl.take(sel)
            w0 = window_poses(poses, tl.idx.index_select(0, sel))
            wp = w0
            for _ in range(o.match_rounds):
                tgt, valid = match_chunk(ch, wp)
                lap("match")
                wp = gn_chunk(ch, wp, tgt, valid)[0]
                lap("gn")
            out.index_copy_(0, sel, torch.where(
                tl.active.index_select(0, sel)[..., None], wp, w0))

        device_for(tl.n_chunks, trip, dev, name="chunk")
        return out

    def half_pass(poses, tl):
        new_w = (chunked_solve if not entries else mesh_solve)(poses, tl)
        new_w = new_w[:tl.B]                                     # [B, W, 3]

        # SE(2) carry: boundary correction at each window's last ACTIVE pose
        old_last = poses.index_select(0, tl.old_last)
        new_last = new_w[torch.arange(tl.B, device=dev), tl.last_j]
        dT = _se2_mat(new_last) @ torch.linalg.inv_ex(_se2_mat(old_last))[0]
        if not tl.any_active.all():
            # windows with no active pose contribute identity
            dT = torch.where(tl.any_active_d[:, None, None], dT, eye)
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
        """[n_chunked * W, 3, 3] marginals, a loop over the chunks."""
        ck = tl.ck
        ar = torch.arange(ck, device=dev)
        arw = torch.arange(ck * W, device=dev)
        out = torch.empty((tl.n_chunked * W, 3, 3), dtype=dtype, device=dev)

        def trip(c):
            sel = c * ck + ar
            ch = tl.take(sel)
            w0 = window_poses(poses, tl.idx.index_select(0, sel))
            tgt, valid = match_chunk(ch, w0)
            np_, H = gn_chunk(ch, w0, tgt, valid, eval_only=True)
            cov = window_covariances(H, tl.active.index_select(0, sel),
                                     np_[..., 2])
            out.index_copy_(0, c * (ck * W) + arw, cov.reshape(-1, 3, 3))

        device_for(tl.n_chunks, trip, dev, name="chunk")
        return out

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
