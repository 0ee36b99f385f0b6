"""Batched sequential RANSAC line-segment extraction.

Port of hitl_slam_tpu/ops/ransac.py. Each round scores K pair hypotheses
against all M points at once (a [K, M] distance tile), takes the best line,
refines it by total least squares over its inliers, claims them, and goes on
to the next round, for a fixed number of rounds in the reference's order.
Shapes are static; segments below the inlier floor come back invalid. A
leading batch dimension runs B independent extractions side by side (what
the reference does with `vmap`).

The hypotheses' endpoints are drawn from the points still available. The
reference draws them with its own random stream, which cannot be reproduced
here, so the draws are an input (`draws`):

  - a tensor of uniforms in [0, 1), [S, 2, K] (or [B, S, 2, K]): round s
    takes as endpoint the available point of rank floor(u * n_available),
    found on the device by an int32 cumsum of the availability mask and a
    searchsorted, with no host read. `uniform_draws` makes such a tensor
    from a seeded CPU generator, so that a run on a card and a run on the
    CPU score the same hypotheses;
  - or a callable (round_index, avail) -> (ia, ib) giving the endpoint
    indices ([K], or [B, K]) for the availability mask it is handed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import torch

Tensor = torch.Tensor
Draws = Union[Tensor, Callable[[int, Tensor], tuple]]


@dataclass(frozen=True)
class RansacParams:
    num_segments: int = 32        # max segments extracted
    num_hypotheses: int = 256     # pair hypotheses scored per round
    inlier_threshold: float = 0.06
    min_inliers: int = 12
    min_length: float = 0.3


@dataclass(frozen=True)
class Segments:
    p1: Tensor        # [S, 2]
    p2: Tensor        # [S, 2]
    count: Tensor     # [S] int32 inlier counts
    valid: Tensor     # [S] bool
    mass: Tensor      # [S] f32 (== count; the curator's 'mass')
    centroid: Tensor  # [S, 2]
    scatter: Tensor   # [S, 2, 2] inlier scatter matrix about the centroid


def uniform_draws(seed: int | None, params: RansacParams, device,
                  batch: int | None = None,
                  generator: torch.Generator | None = None) -> Tensor:
    """[S, 2, K] (or [batch, S, 2, K]) uniforms in [0, 1) from a CPU
    generator seeded with `seed`, moved to `device`. A caller that draws
    more than once hands in its own CPU `generator`, which advances, and
    `seed` is then not read."""
    if generator is None:
        generator = torch.Generator(device="cpu")
        generator.manual_seed(int(seed))
    shape = (params.num_segments, 2, params.num_hypotheses)
    if batch is not None:
        shape = (batch,) + shape
    return torch.rand(shape, generator=generator,
                      dtype=torch.float32).to(device)


def principal_direction(a: Tensor, b: Tensor, d: Tensor) -> Tensor:
    """[..., 2] unit eigenvector of the largest eigenvalue of the symmetric
    2x2 matrix [[a, b], [b, d]] with a + d >= 0, in closed form, with the
    sign LAPACK's symmetric eigensolver gives it (the reference takes
    `eigh(S)[1][:, 1]`, and the sign decides which endpoint is p1): an
    off-diagonal that is negligible against the diagonal leaves the unit
    vector of the larger diagonal entry; otherwise the rotation of
    LAPACK's 2x2 routine (slaev2)."""
    df = a - d
    tb = b + b
    ab = tb.abs()
    adf = df.abs()
    big = torch.maximum(adf, ab)
    small = torch.minimum(adf, ab)
    ratio = small / torch.where(big > 0, big, torch.ones_like(big))
    rt = big * torch.sqrt(1.0 + ratio * ratio)
    pos = df >= 0
    cs = torch.where(pos, df + rt, df - rt)
    safe_cs = torch.where(cs != 0, cs, torch.ones_like(cs))
    ct = -tb / safe_cs
    sn1 = torch.rsqrt(1.0 + ct * ct)
    cs1 = ct * sn1
    # df >= 0: the pair is turned a quarter (slaev2's sgn1 == sgn2 branch)
    vx = torch.where(pos, -sn1, cs1)
    vy = torch.where(pos, cs1, sn1)
    # the tridiagonal solver drops an off-diagonal e with
    # e^2 <= eps^2 |a| |d| and then only sorts the diagonal
    eps = 2.0 ** -24
    split = (b * b) <= (eps * eps) * a.abs() * d.abs() + 1.17549435e-38
    vx = torch.where(split, (a > d).to(a.dtype), vx)
    vy = torch.where(split, (a <= d).to(a.dtype), vy)
    return torch.stack([vx, vy], dim=-1)


def _pick_available(avail: Tensor, csum: Tensor, u: Tensor) -> Tensor:
    """Index of the available point of rank floor(u * n_available) for each
    uniform in u [B, K]; avail [B, M] bool, csum its int32 cumsum."""
    n_av = csum[:, -1:]                                     # [B, 1]
    rank = torch.floor(u * n_av.to(u.dtype)).to(torch.int32)
    rank = torch.minimum(rank, n_av - 1).clamp_(min=0)
    idx = torch.searchsorted(csum, rank + 1)
    return idx.clamp_(max=avail.shape[1] - 1)


def extract_segments(
    pts: Tensor,     # [M, 2] world points, or [B, M, 2]
    mask: Tensor,    # [M] bool, or [B, M]
    draws: Draws,
    params: RansacParams = RansacParams(),
) -> Segments:
    p = params
    batched = pts.dim() == 3
    if not batched:
        pts, mask = pts[None], mask[None]
    B, M, _ = pts.shape
    dtype = pts.dtype
    thr = p.inlier_threshold
    ptsT = pts.transpose(1, 2)                              # [B, 2, M]
    from_uniforms = isinstance(draws, Tensor)
    if from_uniforms:
        u_all = draws if batched else draws[None]
        want = (B, p.num_segments, 2, p.num_hypotheses)
        if tuple(u_all.shape) != want:
            raise ValueError(f"draws {tuple(draws.shape)} do not fit "
                             f"{want[0 if batched else 1:]}")

    def take(x: Tensor, idx: Tensor) -> Tensor:
        """x[b, idx[b, k]] for x [B, M, 2] -> [B, K, 2]."""
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, 2).long())

    def line_fit(inliers: Tensor):
        wsum = inliers.sum(1).clamp(min=1).to(dtype)        # [B]
        sel = inliers[..., None]
        cm = torch.where(sel, pts, 0.0).sum(1) / wsum[:, None]
        rel = torch.where(sel, pts - cm[:, None, :], 0.0)   # [B, M, 2]
        return cm, rel, rel.transpose(1, 2) @ rel           # [B, 2, 2]

    avail = mask
    out = []
    for r in range(p.num_segments):
        if from_uniforms:
            csum = torch.cumsum(avail, 1, dtype=torch.int32)
            ia = _pick_available(avail, csum, u_all[:, r, 0])
            ib = _pick_available(avail, csum, u_all[:, r, 1])
        else:
            ia, ib = draws(r, avail if batched else avail[0])
            ia = torch.as_tensor(ia, device=pts.device).reshape(B, -1)
            ib = torch.as_tensor(ib, device=pts.device).reshape(B, -1)
        a = take(pts, ia)                                    # [B, K, 2]
        b = take(pts, ib)
        d = b - a
        nrm = torch.stack([-d[..., 1], d[..., 0]], -1)
        nlen = torch.sqrt(torch.sum(nrm * nrm, -1, keepdim=True))
        n = nrm / nlen.clamp(min=1e-9)
        c = torch.sum(n * a, -1)                             # [B, K]
        ok_h = (torch.gather(avail, 1, ia.long())
                & torch.gather(avail, 1, ib.long()) & (nlen[..., 0] > 1e-6))
        # [B, K, M] point-line distances
        dist = (n @ ptsT - c[..., None]).abs_()
        inl = (dist < thr) & avail[:, None, :]
        counts = inl.sum(2) * ok_h
        best = torch.argmax(counts, dim=1, keepdim=True)     # first on ties
        # all-zero scores mean argmax picked an arbitrary (possibly
        # degenerate) hypothesis: a duplicate-point pair has n_b = 0 and
        # would claim every available point as an inlier, so gate the round
        best_ok = torch.gather(counts, 1, best) > 0          # [B, 1]
        n_b = take(n, best)                                  # [B, 1, 2]
        c_b = torch.gather(c, 1, best)                       # [B, 1]
        inliers = (((n_b @ ptsT)[:, 0] - c_b).abs() < thr) & avail & best_ok

        # total-least-squares refine over the claimed inliers
        cm, rel, S = line_fit(inliers)
        direction = principal_direction(S[:, 0, 0], S[:, 0, 1], S[:, 1, 1])
        # re-gate inliers against the refined line
        n_ref = torch.stack([-direction[:, 1], direction[:, 0]], -1)
        d_ref = ((pts - cm[:, None, :]) @ n_ref[..., None])[..., 0].abs()
        inliers = (d_ref < thr) & avail & best_ok
        cm, rel, S = line_fit(inliers)
        t = (rel @ direction[..., None])[..., 0]             # [B, M]
        count = inliers.sum(1)
        some = count > 0
        inf = torch.full_like(t, float("inf"))
        t_lo = torch.where(some, torch.where(inliers, t, inf).amin(1), 0.0)
        t_hi = torch.where(some, torch.where(inliers, t, -inf).amax(1), 0.0)
        p1 = cm + t_lo[:, None] * direction
        p2 = cm + t_hi[:, None] * direction
        valid = ((count >= p.min_inliers) & ((t_hi - t_lo) >= p.min_length)
                 & best_ok[:, 0])
        avail = avail & ~(inliers & valid[:, None])
        out.append((p1, p2, count.to(torch.int32), valid, count.to(dtype),
                    cm, S))

    fields = [torch.stack(f, dim=1) for f in zip(*out)]      # [B, S, ...]
    if not batched:
        fields = [f[0] for f in fields]
    p1, p2, count, valid, mass, cm, S = fields
    return Segments(p1=p1, p2=p2, count=count, valid=valid, mass=mass,
                    centroid=cm, scatter=S)
