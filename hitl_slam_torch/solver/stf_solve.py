"""Post-human STF refinement solve: Gauss-Newton/LM over odometry, human and
STF factors.

Port of hitl_slam_tpu/solver/stf_solve.py. STF factors couple arbitrary pose
pairs, so the Hessian is not block-tridiagonal. Two solvers:

  - `stf_lm_solve`: a dense normal-equation solve. The 3x3 factor blocks go
    into H [3P, 3P], which is Cholesky-factored every LM iteration.
  - `stf_pcg_lm_solve`: matrix-free. The chain's tridiagonal part plus the
    STF diagonal blocks are kept as blocks, the STF off-diagonal coupling is
    applied pair-block-wise, and the linear solves are PCG (solver/cg.py);
    no [3P, 3P] matrix is formed.

By default the solve includes odometry + human + STF factors;
`include_chain=False` solves over the STF factors alone (pose 0 pinned).

Every reduction has a fixed summation order: per-pose sums are matmuls with
one-hot selectors or segmented sums over sorted runs, and every scatter has
unique targets, so two runs on the same inputs give bit-equal results.

Each LM loop is the reference's `lax.while_loop` in carry form: a
`device_while` (utils/device_loop.py) whose body updates buffers made
before it with `copy_`, and the reassembly after an accepted step, the
reference's `lax.cond`, is a `device_while` of at most one trip. Eagerly
that is one host read a test; inside a LoopGraph capture each loop is a
WHILE node (the PCG solve's CG loop one inside the LM loop's body), and
nothing is read back.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.state import ConstraintTable
from ..ops import correspond as C
from ..utils.device_loop import device_while
from .assembly_soa import SoaConstants, normal_equations_soa, soa_constants
from .cg import pcg_solve
from .joint import JointProblem, build_problem, cost as chain_cost
from .lm import LMConfig

Tensor = torch.Tensor

_INT32_MAX = 2147483647


def _dense_from_tridiag(D: Tensor, U: Tensor) -> Tensor:
    P = D.shape[0]
    H = torch.zeros((P, 3, P, 3), dtype=D.dtype, device=D.device)
    i = torch.arange(P, device=D.device)
    H[i, :, i, :] = D
    j = i[:-1]
    H[j, :, j + 1, :] = U
    H[j + 1, :, j, :] = U.transpose(-1, -2)
    return H.reshape(3 * P, 3 * P)


def _block_index(bi: Tensor, bj: Tensor) -> tuple[Tensor, Tensor]:
    r3 = torch.arange(3, device=bi.device)
    rows = (3 * bi.long())[:, None, None] + r3[None, :, None]
    cols = (3 * bj.long())[:, None, None] + r3[None, None, :]
    return rows, cols


def _scatter_block(H: Tensor, bi: Tensor, bj: Tensor, block: Tensor) -> Tensor:
    """H with the [K,3,3] blocks added at block positions (bi, bj);
    colliding blocks sum (index_put_ with accumulate sorts by target, so
    the order of the sum is fixed)."""
    return H.index_put(_block_index(bi, bj), block, accumulate=True)


# one-hot selector budget for the dense-refine assembly (elements per
# [C, P] matrix; 2 are built, f32)
STF_ONEHOT_BUDGET = 160 * 1024 * 1024


def sort_factors_by_pair(stf: C.STFFactors, P: int):
    """Permute the factor table into (pose0, pose1)-pair order, once per
    solve. Returns (sorted_stf, run_last [C] bool, run_start [C] int64).

    In pair order the per-pair block sums come from a segmented cumsum, and
    only one row per pair writes its block: all targets unique."""
    key = torch.where(stf.valid, stf.pose0.long() * P + stf.pose1.long(),
                      _INT32_MAX)
    skey, idx = torch.sort(key, stable=True)
    f = stf.take(idx)
    _, run_start = C._run_starts(skey)
    is_last, _ = C._run_ends(skey)
    return f, is_last & f.valid, run_start


def compact_pair_rows(stf: C.STFFactors, run_last: Tensor, P: int,
                      max_pairs: int = 16384):
    """Indices of the pair-representative (run-last) rows, compacted to a
    static `max_pairs` capacity, built once per solve.

    Returns (idx [max_pairs] row indices with fill = C, bi, bj [max_pairs]
    destination pose indices with fill = P + slot (out of bounds, so every
    consumer drops them, and distinct, so targets stay unique),
    dropped = number of pairs beyond the capacity)."""
    Cn = run_last.shape[0]
    idx = C.nonzero_fixed(run_last, max_pairs, Cn)
    npairs = torch.sum(run_last)
    dropped = torch.clamp(npairs - max_pairs, min=0).to(torch.int32)
    oob = torch.full((1,), P, dtype=torch.int64, device=run_last.device)
    pi0 = torch.cat([stf.pose0.long(), oob])
    pi1 = torch.cat([stf.pose1.long(), oob])
    fill_oob = P + torch.arange(max_pairs, device=run_last.device)
    filled_row = idx < Cn
    bi = torch.where(filled_row, pi0[idx], fill_oob)
    bj = torch.where(filled_row, pi1[idx], fill_oob)
    return idx, bi, bj, dropped


def stf_onehots(stf: C.STFFactors, P: int, dtype) -> tuple | None:
    """[C, P] selectors for the factor -> pose reductions, or None when over
    budget. Invalid rows point at pose 0 but carry zero Jacobians."""
    Cn = stf.pose0.shape[0]
    if Cn * P > STF_ONEHOT_BUDGET:
        return None
    r = torch.arange(P, device=stf.pose0.device)[None, :]
    return ((stf.pose0[:, None] == r).to(dtype),
            (stf.pose1[:, None] == r).to(dtype))


def _stf_scalar_products(stf: C.STFFactors, poses: Tensor):
    """STF residual/Jacobian products in flat [C]-lane form.

    Returns (X0cat [C,12], X1cat [C,12], X2 [C,9], sqcost [C]):
      X0cat = [vec(J0^T J0) | J0^T r],  X1cat = [vec(J1^T J1) | J1^T r],
      X2 = vec(J0^T J1),  sqcost = |r|^2 per factor."""
    q0 = poses[stf.pose0.long()]
    q1 = poses[stf.pose1.long()]
    c0_, s0_ = torch.cos(q0[:, 2]), torch.sin(q0[:, 2])
    c1_, s1_ = torch.cos(q1[:, 2]), torch.sin(q1[:, 2])
    # rotated robot-frame points/normals (world minus own translation)
    r0x = c0_ * stf.p0[:, 0] - s0_ * stf.p0[:, 1]
    r0y = s0_ * stf.p0[:, 0] + c0_ * stf.p0[:, 1]
    r1x = c1_ * stf.p1[:, 0] - s1_ * stf.p1[:, 1]
    r1y = s1_ * stf.p1[:, 0] + c1_ * stf.p1[:, 1]
    n0x = c0_ * stf.n0[:, 0] - s0_ * stf.n0[:, 1]
    n0y = s0_ * stf.n0[:, 0] + c0_ * stf.n0[:, 1]
    n1x = c1_ * stf.n1[:, 0] - s1_ * stf.n1[:, 1]
    n1y = s1_ * stf.n1[:, 0] + c1_ * stf.n1[:, 1]
    dpx = (r1x + q1[:, 0]) - (r0x + q0[:, 0])
    dpy = (r1y + q1[:, 1]) - (r0y + q0[:, 1])
    vm = stf.weight * stf.valid.to(poses.dtype)
    rr0 = vm * (n0x * dpx + n0y * dpy)
    rr1 = vm * (n1x * dpx + n1y * dpy)
    # dp0_dth = perp(R p0) = (-r0y, r0x); dn0_dth = (-n0y, n0x); etc.
    n0_dp0 = -n0x * r0y + n0y * r0x
    n1_dp0 = -n1x * r0y + n1y * r0x
    n0_dp1 = -n0x * r1y + n0y * r1x
    n1_dp1 = -n1x * r1y + n1y * r1x
    dn0_dp = -n0y * dpx + n0x * dpy
    dn1_dp = -n1y * dpx + n1x * dpy
    # J0 rows (d r0/d pose0, d r1/d pose0), J1 rows (wrt pose1)
    a0 = (-vm * n0x, -vm * n0y, vm * (dn0_dp - n0_dp0))
    a1 = (-vm * n1x, -vm * n1y, -vm * n1_dp0)
    b0 = (vm * n0x, vm * n0y, vm * n0_dp1)
    b1 = (vm * n1x, vm * n1y, vm * (dn1_dp + n1_dp1))
    X0cat = torch.stack(
        [a0[p] * a0[q] + a1[p] * a1[q] for p in range(3) for q in range(3)]
        + [a0[p] * rr0 + a1[p] * rr1 for p in range(3)], dim=-1)
    X1cat = torch.stack(
        [b0[p] * b0[q] + b1[p] * b1[q] for p in range(3) for q in range(3)]
        + [b0[p] * rr0 + b1[p] * rr1 for p in range(3)], dim=-1)
    X2 = torch.stack(
        [a0[p] * b0[q] + a1[p] * b1[q] for p in range(3) for q in range(3)],
        dim=-1)
    return X0cat, X1cat, X2, rr0 * rr0 + rr1 * rr1


def _segmented_pair_sums(X: Tensor, run_start: Tensor,
                         block: int = 512) -> Tensor:
    """Per-run inclusive sums sum(X[run_start[i] .. i]) for every row i, by
    a two-level blocked cumsum.

    A single global cumsum difference cs[i] - cs[run_start-1] carries the
    error of the global prefix magnitude (the sum over all factors), so
    small late runs can lose several f32 digits. Blocking resets the
    accumulator every `block` rows: runs inside a block difference only
    local prefixes; runs straddling one boundary add two local partials and
    an exactly zero middle; only runs spanning three or more blocks touch
    the block-level prefix, and their own sums are comparable to the blocks
    they span."""
    Cn, K = X.shape
    nb = -(-Cn // block)
    pad = nb * block - Cn
    Xp = torch.nn.functional.pad(X, (0, 0, 0, pad))
    lcs = torch.cumsum(Xp.reshape(nb, block, K), dim=1)     # [nb, block, K]
    btot = lcs[:, -1, :]                                    # [nb, K]
    off = torch.cumsum(btot, dim=0) - btot                  # exclusive prefix
    lcs_f = lcs.reshape(nb * block, K)[:Cn]
    pos = torch.arange(Cn, device=X.device)
    a = run_start.long() - 1                                # exclusive lower
    bi = pos // block
    ba = torch.where(a >= 0, a // block, -1)
    Ea = torch.where((a >= 0)[:, None], lcs_f[torch.clamp(a, min=0)], 0.0)
    tail = torch.where((ba >= 0)[:, None],
                       btot[torch.clamp(ba, min=0)] - Ea, 0.0)
    mid = off[bi] - off[torch.clamp(ba + 1, 0, nb - 1)]     # 0 when adjacent
    return torch.where((ba == bi)[:, None], lcs_f - Ea, tail + mid + lcs_f)


def assemble_dense(
    problem: JointProblem,
    stf: C.STFFactors,
    poses: Tensor,
    include_chain: bool = True,
    onehots: tuple | None = None,
    pair_runs: tuple | None = None,
    pair_compact: tuple | None = None,
    chain_soa: SoaConstants | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Dense H [3P,3P], gradient g [3P] and cost of the odometry + human
    (optional) and STF factors at `poses`.

    With `onehots` (built once per solve by stf_onehots), the per-pose
    diagonal blocks and the gradient are [P, C] @ [C, 12] products and the
    off-diagonal coupling is one block scatter plus a transpose.

    With `pair_runs` (= (run_last, run_start) from sort_factors_by_pair;
    needs `stf` pair-sorted) the per-pair block sums come from
    _segmented_pair_sums and only the last row of each pair run writes its
    block; with `pair_compact` (from compact_pair_rows) those rows are
    gathered into a [max_pairs] table first.

    `chain_soa` = soa_constants(problem), to be passed where many assemblies
    share one problem."""
    P = poses.shape[0]
    n = 3 * P
    dtype, dev = poses.dtype, poses.device

    if include_chain:
        if chain_soa is None:
            chain_soa = soa_constants(problem)
        D, U, g_blocks, cost = normal_equations_soa(problem, chain_soa, poses)
        H = _dense_from_tridiag(D, U)
        g = g_blocks.reshape(n)
    else:
        H = torch.zeros((n, n), dtype=dtype, device=dev)
        g = torch.zeros((n,), dtype=dtype, device=dev)
        cost = torch.zeros((), dtype=dtype, device=dev)

    if onehots is not None:
        oh0, oh1 = onehots
        Cn = stf.pose0.shape[0]
        X0, X1, X2, sq = _stf_scalar_products(stf, poses)
        Y = oh0.T @ X0 + oh1.T @ X1            # [P, 12]
        i = torch.arange(P, device=dev)
        H4 = H.view(P, 3, P, 3)
        H4[i, :, i, :] += Y[:, :9].reshape(P, 3, 3)
        H_off = torch.zeros((n, n), dtype=dtype, device=dev)
        if pair_compact is not None:
            _, run_start = pair_runs
            idx, bi, bj = pair_compact
            seg = _segmented_pair_sums(X2, run_start)
            segp = torch.cat([seg, seg.new_zeros((1, 9))], 0)
            blocks = segp[idx].reshape(idx.shape[0], 3, 3)
            # one row per pose pair, so the targets are unique and the
            # blocks are written, not summed. Fill rows carry zero blocks;
            # they all go to block (0, 0), which the gauge fix overwrites
            live = bi < P
            H_off.index_put_(
                _block_index(torch.where(live, bi, 0),
                             torch.where(live, bj, 0)), blocks)
        elif pair_runs is not None:
            run_last, run_start = pair_runs
            seg = _segmented_pair_sums(X2, run_start)
            # only a run's last row holds the run's sum
            blocks = torch.where(run_last[:, None], seg, 0.0)
            H_off = _scatter_block(H_off, stf.pose0, stf.pose1,
                                   blocks.reshape(Cn, 3, 3))
        else:
            H_off = _scatter_block(H_off, stf.pose0, stf.pose1,
                                   X2.reshape(Cn, 3, 3))
        H = H + H_off + H_off.T
        g = (g.reshape(P, 3) + Y[:, 9:]).reshape(n)
        cost = cost + 0.5 * torch.sum(sq)
    else:
        r = C.stf_residuals(stf, poses)            # [Cf, 2]
        J0, J1 = C.stf_jacobians(stf, poses)       # [Cf, 2, 3]
        J0T, J1T = J0.transpose(-1, -2), J1.transpose(-1, -2)
        H = _scatter_block(H, stf.pose0, stf.pose0, J0T @ J0)
        H = _scatter_block(H, stf.pose1, stf.pose1, J1T @ J1)
        H = _scatter_block(H, stf.pose0, stf.pose1, J0T @ J1)
        H = _scatter_block(H, stf.pose1, stf.pose0, J1T @ J0)
        g = g.reshape(P, 3).index_put(
            (stf.pose0.long(),), (J0T @ r[..., None])[..., 0], accumulate=True
        ).index_put(
            (stf.pose1.long(),), (J1T @ r[..., None])[..., 0], accumulate=True
        ).reshape(n)
        cost = cost + 0.5 * torch.sum(r * r)

    # gauge fix pose 0
    H[:3, :] = 0.0
    H[:, :3] = 0.0
    H[:3, :3] = torch.eye(3, dtype=dtype, device=dev)
    g[:3] = 0.0
    return H, g, cost


@dataclass(frozen=True)
class STFSolveResult:
    poses: Tensor
    final_cost: Tensor
    initial_cost: Tensor
    iterations: Tensor
    num_matches: Tensor
    # pose pairs beyond the solvers' compacted off-diagonal capacity
    # (0 = exact)
    pairs_dropped: Tensor | None = None
    # factor rows lost before the solve: the global matcher's density-cap /
    # out-of-range drops, or the pair matcher's factor-table overflow
    match_dropped: Tensor | None = None
    # pair matcher only: stage-1 grid drops that may have silenced a pair's
    # vote (the pair itself is then never elected)
    vote_dropped: Tensor | None = None
    # pair matcher only: voted pose pairs beyond the election capacity
    # (units: pairs, each worth up to N rows)
    elect_dropped: Tensor | None = None
    # linear-solver iterations summed over the LM iterations (PCG solver;
    # a 0-dim int32 tensor)
    cg_iterations: Tensor | None = None


# ---------------------------------------------------------------------------
# matrix-free path: PCG on (chain tridiagonal + STF diagonal) with the STF
# off-diagonal coupling applied pair-block-wise. O(P + C) per LM iteration
# and O(P + n_pairs) per CG iteration. Per-pose and per-pair reductions are
# sorted-run segmented sums followed by unique-target scatters, and the CG
# matvec works on the <= max_pairs compacted 3x3 pair blocks, not on the
# [C]-row factor table.
# ---------------------------------------------------------------------------


def _sorted_runs(keys: Tensor, size: int):
    """Run boundaries over an ascending-sorted key vector (invalid rows =
    INT32_MAX, sorted to the tail). Returns (run_start [N], the index of
    each row's run head; rep_idx [size], the row index of each run's last
    row, fill = N for unused slots: gather through a zero-padded array)."""
    N = keys.shape[0]
    _, run_start = C._run_starts(keys)
    is_last, _ = C._run_ends(keys)
    run_last = is_last & (keys != _INT32_MAX)
    return run_start, C.nonzero_fixed(run_last, size, N)


def _pcg_reductions(stf_s: C.STFFactors, run_start_pair: Tensor,
                    pair_compact: tuple, P: int):
    """Once-per-solve orderings for the PCG assembly and matvec.

    `stf_s` must be pair-sorted (sort_factors_by_pair), so pose0 is already
    ascending; pose1 needs its own permutation. The compacted pair table
    (cbi ascending by construction) gets bi-runs directly and bj-runs through
    a second <= max_pairs permutation."""
    cidx, cbi, cbj = pair_compact
    dev = cbi.device

    def _dst(keys_padded, rep):
        # fills go to P, the dump row of the consumers' [P+1]-row buffers
        d = keys_padded[torch.clamp(rep, max=keys_padded.shape[0] - 1)]
        fill = (rep >= keys_padded.shape[0] - 1) | (d >= P)
        return torch.where(fill, P, d)

    oobP = torch.full((1,), P, dtype=torch.int64, device=dev)
    pose0, pose1 = stf_s.pose0.long(), stf_s.pose1.long()
    key0 = torch.where(stf_s.valid, pose0, _INT32_MAX)
    run_start_p0, rep_p0 = _sorted_runs(key0, P)
    dst_p0 = _dst(torch.cat([pose0, oobP]), rep_p0)
    key1 = torch.where(stf_s.valid, pose1, _INT32_MAX)
    skey1, ord1 = torch.sort(key1, stable=True)
    run_start_p1, rep_p1 = _sorted_runs(skey1, P)
    dst_p1 = _dst(torch.cat([pose1[ord1], oobP]), rep_p1)
    # pair-table runs: grouped by destination pose0 (bi) and pose1 (bj)
    run_start_bi, rep_bi = _sorted_runs(
        torch.where(cbi < P, cbi, _INT32_MAX), P)
    dst_bi = _dst(torch.cat([cbi, oobP]), rep_bi)
    ordp1 = torch.argsort(torch.where(cbj < P, cbj, _INT32_MAX), stable=True)
    cbj_o = cbj[ordp1]
    cbi_o = cbi[ordp1]
    run_start_bj, rep_bj = _sorted_runs(
        torch.where(cbj_o < P, cbj_o, _INT32_MAX), P)
    dst_bj = _dst(torch.cat([cbj_o, oobP]), rep_bj)
    return dict(run_start_pair=run_start_pair, cidx=cidx, cbi=cbi, cbj=cbj,
                run_start_p0=run_start_p0, rep_p0=rep_p0, dst_p0=dst_p0,
                ord1=ord1, run_start_p1=run_start_p1, rep_p1=rep_p1,
                dst_p1=dst_p1, run_start_bi=run_start_bi, rep_bi=rep_bi,
                dst_bi=dst_bi, ordp1=ordp1, cbi_o=cbi_o,
                run_start_bj=run_start_bj, rep_bj=rep_bj, dst_bj=dst_bj)


def _run_totals(X: Tensor, run_start: Tensor, rep: Tensor) -> Tensor:
    """[size, K] per-run totals of X's sorted runs (zero rows for fills)."""
    seg = _segmented_pair_sums(X, run_start)
    return torch.cat([seg, seg.new_zeros((1, X.shape[1]))], 0)[rep]


def _scatter_rows(P: int, dst: Tensor, rows: Tensor) -> Tensor:
    """[P, ...] zeros with rows[k] written at dst[k]; dst == P is dropped.
    Real targets are unique; only the dump row collects duplicates."""
    out = rows.new_zeros((P + 1,) + rows.shape[1:])
    out[dst] = rows
    return out[:P]


def _stf_system_compact(stf_s: C.STFFactors, x: Tensor, red: dict):
    """Per-pose STF diagonal blocks [P,3,3], gradient [P,3] and cost, and
    the compacted per-pair off-diagonal blocks B [max_pairs,3,3]: one
    [C]-row factor pass, every reduction a segmented sum and a unique
    scatter. Pose-0 contributions are zeroed (gauge)."""
    P = x.shape[0]
    X0, X1, X2, sq = _stf_scalar_products(stf_s, x)
    Y0 = _run_totals(X0, red["run_start_p0"], red["rep_p0"])      # [P, 12]
    Y1 = _run_totals(X1[red["ord1"]], red["run_start_p1"], red["rep_p1"])
    Y = _scatter_rows(P, red["dst_p0"], Y0) + _scatter_rows(
        P, red["dst_p1"], Y1)
    Dh = Y[:, :9].reshape(P, 3, 3).clone()
    g = Y[:, 9:].clone()
    B = _run_totals(X2, red["run_start_pair"], red["cidx"])
    Dh[0] = 0.0
    g[0] = 0.0
    return Dh, g, 0.5 * torch.sum(sq), B.reshape(-1, 3, 3)


def _pair_block_matvec(B: Tensor, red: dict, P: int):
    """v [P,3] -> the off-diagonal STF Hessian product from the compacted
    pair blocks: out[bi] += B v[bj], out[bj] += B^T v[bi]; gauge row 0
    projected out. O(max_pairs) per call."""
    cbj = torch.clamp(red["cbj"], max=P - 1)
    cbi_o = torch.clamp(red["cbi_o"], max=P - 1)
    Bt = B[red["ordp1"]]

    def mv(v):
        vz = v.clone()
        vz[0] = 0.0
        # fill rows carry zero blocks, so the clamped gather is harmless
        y = torch.einsum("kab,kb->ka", B, vz[cbj])
        out = _scatter_rows(
            P, red["dst_bi"], _run_totals(y, red["run_start_bi"],
                                          red["rep_bi"]))
        yt = torch.einsum("kab,ka->kb", Bt, vz[cbi_o])
        out = out + _scatter_rows(
            P, red["dst_bj"], _run_totals(yt, red["run_start_bj"],
                                          red["rep_bj"]))
        out[0] = 0.0
        return out

    return mv


def _mnt_updates(config: LMConfig, c, c_new, step, diag, g, mu, nu, x):
    """The Madsen-Nielsen-Tingleff acceptance, damping and termination block
    shared by the STF LM drivers (dense two-pass, dense fused, PCG).
    Returns (accept, mu_out, nu_out, done)."""
    pred = 0.5 * torch.sum(step * (mu * diag * step - g))
    rho = (c - c_new) / torch.clamp(pred, min=1e-30)
    accept = (rho > 0) & torch.isfinite(c_new)
    t = 2.0 * rho - 1.0
    factor = torch.clamp(1.0 - t * (t * t), min=1.0 / 3.0)
    mu_out = torch.clamp(torch.where(accept, mu * factor, mu * nu),
                         1e-32, 1e32)
    nu_out = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
    fdone = accept & (torch.abs(c - c_new) <= config.function_tolerance * c)
    sdone = accept & (torch.linalg.vector_norm(step)
                      <= config.parameter_tolerance
                      * (torch.linalg.vector_norm(x)
                         + config.parameter_tolerance))
    mdone = mu_out >= config.mu_collapse
    return accept, mu_out, nu_out, fdone | sdone | mdone


def stf_pcg_lm_solve(
    poses0: Tensor,
    table: ConstraintTable,
    stf: C.STFFactors,
    config: LMConfig = LMConfig(max_iterations=30),
    include_chain: bool = True,
    max_pairs: int = 16384,
    precondition: str = "tridiag",
    cg_tolerance: float = 1e-2,
    cg_max_iterations: int | None = None,
) -> STFSolveResult:
    """Matrix-free LM: the same problem as stf_lm_solve, its linear solves
    by PCG (solver/cg.py) and not by a dense factorization.

    The Hessian's action goes through the compacted pair blocks (<= max_pairs
    3x3 blocks, _pair_block_matvec), so a CG iteration costs O(P + n_pairs);
    the [C]-row factor table is touched once per LM iteration
    (_stf_system_compact), not once per CG iteration. "tridiag"
    preconditioning solves the damped chain + diagonal part exactly per CG
    apply, so the iteration count follows the pair coupling alone; the loose
    default `cg_tolerance` is enough because the linear solve only feeds a
    trust-region step."""
    dtype, dev = poses0.dtype, poses0.device
    P = poses0.shape[0]
    problem = build_problem(poses0, table)
    sc = soa_constants(problem)

    stf_s, run_last, run_start_pair = sort_factors_by_pair(stf, P)
    cidx, cbi, cbj, pairs_dropped = compact_pair_rows(stf_s, run_last, P,
                                                      max_pairs=max_pairs)
    red = _pcg_reductions(stf_s, run_start_pair, (cidx, cbi, cbj), P)

    def cost_only(x):
        c = (chain_cost(problem, x) if include_chain
             else torch.zeros((), dtype=dtype, device=dev))
        r = C.stf_residuals(stf_s, x)
        return c + 0.5 * torch.sum(r * r)

    def assemble_all(x):
        """Chain + STF system at x: (D_aug [P,3,3], U [P-1,3,3],
        g_tot [P,3], B pair blocks)."""
        if include_chain:
            D, U, g, _ = normal_equations_soa(problem, sc, x)
        else:
            # gauge: pin pose 0 like the dense path
            D = torch.zeros((P, 3, 3), dtype=dtype, device=dev)
            D[0] = torch.eye(3, dtype=dtype, device=dev)
            U = torch.zeros((P - 1, 3, 3), dtype=dtype, device=dev)
            g = torch.zeros((P, 3), dtype=dtype, device=dev)
        Dh, gh, _, B = _stf_system_compact(stf_s, x, red)
        return D + Dh, U, g + gh, B

    if cg_max_iterations is None:
        cg_max_iterations = 64 if precondition == "tridiag" else 200
    c0 = cost_only(poses0)
    c = c0.clone()
    x = poses0.clone()
    system = assemble_all(poses0)
    D_aug, U, g_tot, B = system
    mu = torch.full((), config.initial_mu, dtype=dtype, device=dev)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    cg_total = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    go = ~done

    def reassemble():
        for buf, new in zip(system, assemble_all(x)):
            buf.copy_(new)

    def iteration():
        # the system is always valid at the current x: a rejected step
        # leaves x unchanged, so only mu changes and the [C]-row factor
        # pass is skipped
        diag = torch.clamp(torch.diagonal(D_aug, dim1=-2, dim2=-1),
                           config.min_diagonal, config.max_diagonal)
        D_damped = D_aug + mu * torch.diag_embed(diag)
        step, _res, cg_it = pcg_solve(
            D_damped, U, -g_tot,
            extra_matvec=_pair_block_matvec(B, red, P),
            max_iterations=cg_max_iterations,
            tolerance=cg_tolerance, preconditioner=precondition,
        )
        cg_total.add_(cg_it)
        x_new = x + step
        c_new = cost_only(x_new)
        accept, mu_new, nu_new, done_new = _mnt_updates(
            config, c, c_new, step, diag, g_tot, mu, nu, x)
        x.copy_(torch.where(accept, x_new, x))
        c.copy_(torch.where(accept, c_new, c))
        mu.copy_(mu_new)
        nu.copy_(nu_new)
        it.add_(1)
        done.copy_(done | done_new)
        device_while(accept & ~done, reassemble, 1, name="reassemble")
        torch.logical_not(done, out=go)

    device_while(go, iteration, config.max_iterations, name="lm")
    return STFSolveResult(
        poses=x, final_cost=c, initial_cost=c0, iterations=it,
        num_matches=torch.sum(stf_s.valid).to(torch.int32),
        pairs_dropped=pairs_dropped, cg_iterations=cg_total,
    )


def stf_lm_solve(
    poses0: Tensor,
    table: ConstraintTable,
    stf: C.STFFactors,
    config: LMConfig = LMConfig(max_iterations=30),
    include_chain: bool = True,
    fused_eval: bool = False,
    max_pairs: int = 16384,
) -> STFSolveResult:
    """Dense STF LM.

    `fused_eval=True` takes the trial cost from the assembly (assemble_dense
    returns the cost as a by-product of the same factor pass): one [C]-row
    pass per iteration, where the two-pass form runs cost_only and, on
    accepted steps, a second assembly pass. The trade: rejected steps pay
    the full assembly where the two-pass form pays only the residual
    reduction, so it is the better choice when most steps are accepted."""
    dtype, dev = poses0.dtype, poses0.device
    P = poses0.shape[0]
    problem = build_problem(poses0, table)
    sc = soa_constants(problem)

    def cost_only(x):
        c = (chain_cost(problem, x) if include_chain
             else torch.zeros((), dtype=dtype, device=dev))
        r = C.stf_residuals(stf, x)
        return c + 0.5 * torch.sum(r * r)

    # once per solve: pair-sort the factor table, build the [C,P] one-hot
    # selectors from the sorted table, compact the pair-representative rows
    stf, run_last, run_start = sort_factors_by_pair(stf, P)
    onehots = stf_onehots(stf, P, dtype)
    cidx, cbi, cbj, pairs_dropped = compact_pair_rows(stf, run_last, P,
                                                      max_pairs=max_pairs)

    def assemble_cost(x):
        return assemble_dense(problem, stf, x, include_chain, onehots,
                              (run_last, run_start), (cidx, cbi, cbj),
                              chain_soa=sc)

    def solve_step(H, g, mu):
        diag = torch.clamp(torch.diagonal(H), config.min_diagonal,
                           config.max_diagonal)
        Hd = H + mu * torch.diag(diag)
        # SPD by construction (PSD normal equations + gauge identity block
        # + positive damping): Cholesky and two triangular solves. A
        # factorization that fails gives a non-finite step, which the
        # acceptance test rejects (no host read of the status here).
        L, info = torch.linalg.cholesky_ex(Hd)
        y = torch.linalg.solve_triangular(L, -g[:, None], upper=False)
        step = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
        step = torch.where(info > 0, torch.full_like(step, float("nan")),
                           step)
        return step, diag

    if fused_eval:
        H, g, c0 = assemble_cost(poses0)
    else:
        c0 = cost_only(poses0)
        H, g, _ = assemble_cost(poses0)
    c = c0.clone()
    x = poses0.clone()
    mu = torch.full((), config.initial_mu, dtype=dtype, device=dev)
    nu = torch.full((), 2.0, dtype=dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    go = ~done

    def reassemble():
        H_new, g_new, _ = assemble_cost(x)
        H.copy_(H_new)
        g.copy_(g_new)

    def iteration():
        # H, g are always valid at the current x: a rejected step leaves x
        # unchanged, so only mu changes
        step, diag = solve_step(H, g, mu)
        x_new = x + step.reshape(-1, 3)
        if fused_eval:
            # one factor pass: trial H, g and cost together, kept on accept
            H_new, g_new, c_new = assemble_cost(x_new)
        else:
            c_new = cost_only(x_new)
        accept, mu_new, nu_new, done_new = _mnt_updates(
            config, c, c_new, step, diag, g, mu, nu, x)
        x.copy_(torch.where(accept, x_new, x))
        c.copy_(torch.where(accept, c_new, c))
        mu.copy_(mu_new)
        nu.copy_(nu_new)
        it.add_(1)
        done.copy_(done | done_new)
        if fused_eval:
            H.copy_(torch.where(accept, H_new, H))
            g.copy_(torch.where(accept, g_new, g))
        else:
            device_while(accept & ~done, reassemble, 1, name="reassemble")
        torch.logical_not(done, out=go)

    device_while(go, iteration, config.max_iterations, name="lm")
    return STFSolveResult(
        poses=x, final_cost=c, initial_cost=c0, iterations=it,
        num_matches=torch.sum(stf.valid).to(torch.int32),
        pairs_dropped=pairs_dropped,
    )
