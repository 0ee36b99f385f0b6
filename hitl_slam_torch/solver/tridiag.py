"""Block-tridiagonal solve of the Gauss-Newton normal equations, in torch.

Port of hitl_slam_tpu/solver/tridiag.py (`inv3`, `thomas_solve`,
`bcr_solve`, `bcr_factor`, `bcr_apply`, `schur_solve`). The joint problem's
Hessian is block-tridiagonal with 3x3 blocks; `bcr_solve` is block cyclic
reduction: pad to a power of two with decoupled identity rows, then log2(n)
levels of batched 3x3 algebra over halved arrays, then back-substitution. It
is the plain version of the CUDA kernel in csrc/bcr.cu (same padding,
elimination order and adjugate inverses), and the solver LM uses on CPU
tensors. `bcr_factor` keeps the matrix-dependent half of that elimination so
that `bcr_apply` solves many right-hand sides with matrix-vector products
only (the PCG preconditioner of solver/cg.py).

`bcr_solve`, `bcr_factor` and `bcr_apply` take optional leading batch
dimensions (D [..., n, 3, 3], U [..., n-1, 3, 3], b [..., n, 3]): every
system of the batch goes through the same operations as it would alone, so
a batched solve equals the lone solves of its systems (the batched LM of
solver/lm.py). `thomas_solve` (sequential block elimination) and
`schur_solve` (chunk interiors eliminated by batched dense solves) are
reference solvers for one system.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def inv3(m: Tensor) -> Tensor:
    """Closed-form inverse of batched 3x3 matrices via the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = torch.stack(
        [
            torch.stack([A, D, G], -1),
            torch.stack([B, E, H], -1),
            torch.stack([C, F, I], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _mv(A: Tensor, v: Tensor) -> Tensor:
    return (A @ v[..., None])[..., 0]


def _mv_each(A: Tensor, v: Tensor) -> Tensor:
    """`_mv` of A [..., 3, 3] and v [..., 3], one system at a time: a lone
    [3, 3] x [3] product is a matrix product of its own (not a batched
    one, whose rounding may differ), so a batch's root solves round as its
    systems' lone solves do."""
    if v.dim() == 1:
        return _mv(A, v)
    out = [_mv(a, w) for a, w in zip(A.reshape(-1, 3, 3), v.reshape(-1, 3))]
    return torch.stack(out).reshape(v.shape)


def _zeros(like: Tensor, *shape: int) -> Tensor:
    """Zeros of shape like.shape[:-3] + shape (the batch dims of a D-like
    [..., n, 3, 3] tensor, then `shape`)."""
    return torch.zeros((*like.shape[:-3], *shape), dtype=like.dtype,
                       device=like.device)


def _interleave(x_even: Tensor, x_odd: Tensor) -> Tensor:
    """[..., h, 3] evens and odds -> [..., 2h, 3] in lane order."""
    h = x_even.shape[-2]
    return torch.stack([x_even, x_odd], dim=-2).reshape(
        *x_even.shape[:-2], 2 * h, 3)


def thomas_solve(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Sequential block-Thomas solve of H x = b, H[i,i] = D[i],
    H[i,i+1] = U[i], H[i+1,i] = U[i]^T (the reference's `lax.scan` as a
    loop over the n poses). D: [n,3,3], U: [n-1,3,3], b: [n,3] -> x [n,3]."""
    n = D.shape[0]
    S = [D[0]]                 # Schur complements
    y = [b[0]]                 # modified right-hand sides
    for i in range(1, n):
        W = U[i - 1].transpose(-1, -2) @ inv3(S[-1])
        S.append(D[i] - W @ U[i - 1])
        y.append(b[i] - _mv(W, y[-1]))
    x = [_mv(inv3(S[-1]), y[-1])]
    for i in range(n - 2, -1, -1):
        x.append(_mv(inv3(S[i]), y[i] - _mv(U[i], x[-1])))
    return torch.stack(x[::-1], 0)


def bcr_solve(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """Solve H x = b with H[i,i] = D[i], H[i,i+1] = U[i], H[i+1,i] = U[i]^T.

    D: [..., n,3,3], U: [..., n-1,3,3], b: [..., n,3]. Returns x: [..., n,3].
    """
    n = D.shape[-3]
    m = next_pow2(n)
    # general (L, U) representation; start symmetric: L[i] = U[i-1]^T
    Df, Lf, Uf = _pad_system(D, U)
    bf = torch.cat([b, _zeros(D, m - n, 3)], -2)
    z3 = _zeros(D, 1, 3, 3)
    z1 = _zeros(D, 1, 3)

    levels = []
    while Df.shape[-3] > 1:
        De, Do = Df[..., 0::2, :, :], Df[..., 1::2, :, :]
        Le, Lo = Lf[..., 0::2, :, :], Lf[..., 1::2, :, :]
        Ue, Uo = Uf[..., 0::2, :, :], Uf[..., 1::2, :, :]
        be, bo = bf[..., 0::2, :], bf[..., 1::2, :]

        Do_inv = inv3(Do)
        DinvL = Do_inv @ Lo
        DinvU = Do_inv @ Uo
        Dinvb = _mv(Do_inv, bo)

        # left odd neighbour of even k is odd k-1 (zero-padded at k=0)
        DinvL_l = torch.cat([z3, DinvL[..., :-1, :, :]], -3)
        DinvU_l = torch.cat([z3, DinvU[..., :-1, :, :]], -3)
        Dinvb_l = torch.cat([z1, Dinvb[..., :-1, :]], -2)

        D_new = De - Le @ DinvU_l - Ue @ DinvL
        L_new = -(Le @ DinvL_l)
        U_new = -(Ue @ DinvU)
        b_new = be - _mv(Le, Dinvb_l) - _mv(Ue, Dinvb)

        levels.append((Lo, Uo, bo, Do_inv))
        Df, Lf, Uf, bf = D_new, L_new, U_new, b_new

    x = _mv_each(inv3(Df[..., 0, :, :]), bf[..., 0, :])[..., None, :]

    for Lo, Uo, bo, Do_inv in reversed(levels):
        x_even = x
        x_even_r = torch.cat([x[..., 1:, :], z1], -2)
        rhs = bo - _mv(Lo, x_even) - _mv(Uo, x_even_r)
        x_odd = _mv(Do_inv, rhs)
        x = _interleave(x_even, x_odd)

    return x[..., :n, :]


def _pad_system(D: Tensor, U: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(Df, Lf, Uf), each [..., next_pow2(n), 3, 3]: D padded with identity
    blocks, U with zeros, and L[i] = U[i-1]^T."""
    n = D.shape[-3]
    m = next_pow2(n)
    eye = torch.eye(3, dtype=D.dtype, device=D.device).expand(
        *D.shape[:-3], m - n, 3, 3)
    Df = torch.cat([D, eye], -3)
    Uf = torch.cat([U, _zeros(D, m - n + 1, 3, 3)], -3)
    Lf = torch.cat([_zeros(D, 1, 3, 3),
                    Uf[..., :-1, :, :].transpose(-1, -2)], -3)
    return Df, Lf, Uf


def bcr_factor(D: Tensor, U: Tensor):
    """The matrix-dependent half of `bcr_solve`, reusable across right-hand
    sides: per level the elimination operators (Le, Ue, Lo, Uo, Do_inv), and
    the root inverse. Returns (levels, root_inv, n)."""
    n = D.shape[-3]
    Df, Lf, Uf = _pad_system(D, U)
    z3 = _zeros(D, 1, 3, 3)

    levels = []
    while Df.shape[-3] > 1:
        De, Do = Df[..., 0::2, :, :], Df[..., 1::2, :, :]
        Le, Lo = Lf[..., 0::2, :, :], Lf[..., 1::2, :, :]
        Ue, Uo = Uf[..., 0::2, :, :], Uf[..., 1::2, :, :]

        Do_inv = inv3(Do)
        DinvL = Do_inv @ Lo
        DinvU = Do_inv @ Uo
        DinvL_l = torch.cat([z3, DinvL[..., :-1, :, :]], -3)
        DinvU_l = torch.cat([z3, DinvU[..., :-1, :, :]], -3)

        D_new = De - Le @ DinvU_l - Ue @ DinvL
        L_new = -(Le @ DinvL_l)
        U_new = -(Ue @ DinvU)

        levels.append((Le, Ue, Lo, Uo, Do_inv))
        Df, Lf, Uf = D_new, L_new, U_new

    return tuple(levels), inv3(Df[..., 0, :, :]), n


def bcr_apply(factor, b: Tensor) -> Tensor:
    """Solve with a `bcr_factor` factorization: the right-hand side's
    reduction and the back-substitution only. Same result as
    `bcr_solve(D, U, b)` for the factored (D, U)."""
    levels, root_inv, n = factor
    m = next_pow2(n)
    lead = b.shape[:-2]
    bf = torch.cat([b, b.new_zeros((*lead, m - n, 3))], -2)
    z1 = b.new_zeros((*lead, 1, 3))

    rhs_stack = []
    for Le, Ue, _, _, Do_inv in levels:
        be, bo = bf[..., 0::2, :], bf[..., 1::2, :]
        Dinvb = _mv(Do_inv, bo)
        Dinvb_l = torch.cat([z1, Dinvb[..., :-1, :]], -2)
        bf = be - _mv(Le, Dinvb_l) - _mv(Ue, Dinvb)
        rhs_stack.append(bo)

    x = _mv_each(root_inv, bf[..., 0, :])[..., None, :]  # [..., 1, 3]

    for (_, _, Lo, Uo, Do_inv), bo in zip(reversed(levels),
                                          reversed(rhs_stack)):
        x_even = x
        x_even_r = torch.cat([x[..., 1:, :], z1], -2)
        rhs = bo - _mv(Lo, x_even) - _mv(Uo, x_even_r)
        x_odd = _mv(Do_inv, rhs)
        x = _interleave(x_even, x_odd)

    return x[..., :n, :]


def _block_tridiag_dense(D: Tensor, U: Tensor, Ut: Tensor) -> Tensor:
    """Dense [..., 3m, 3m] matrices of block-tridiagonal systems with
    diagonal blocks D [..., m, 3, 3], upper blocks U [..., m-1, 3, 3] and
    lower blocks Ut [..., m-1, 3, 3] (H[i+1, i] = Ut[i])."""
    m = D.shape[-3]
    A = D.new_zeros((*D.shape[:-3], m, 3, m, 3))
    i = torch.arange(m, device=D.device)
    j = i[:-1]
    # advanced indices split by a slice: the indexed dim comes first
    A[..., i, :, i, :] = D.movedim(-3, 0)
    A[..., j, :, j + 1, :] = U.movedim(-3, 0)
    A[..., j + 1, :, j, :] = Ut.movedim(-3, 0)
    return A.reshape(*D.shape[:-3], 3 * m, 3 * m)


def schur_solve(D: Tensor, U: Tensor, b: Tensor, chunk: int = 16) -> Tensor:
    """Schur-partitioned solve of the same system as `bcr_solve`: every
    `chunk`-th pose is a separator; the chunk interiors are eliminated by
    one batched dense solve ([K, 3(chunk-1), 3(chunk-1)]), the separators'
    Schur complement (block-tridiagonal again) is solved densely, and the
    interiors back-substitute. Below 2 * chunk poses it is `bcr_solve`."""
    n = D.shape[0]
    if n < 2 * chunk:
        return bcr_solve(D, U, b)
    dt, dev = D.dtype, D.device
    C = chunk
    n_s = -(-(n - 1) // C)             # number of chunks
    n_pad = n_s * C + 1
    pad = n_pad - n
    eye = torch.eye(3, dtype=dt, device=dev).expand(pad, 3, 3)
    Df = torch.cat([D, eye], 0)
    Uf = torch.cat([U, D.new_zeros((n_pad - n, 3, 3))], 0)
    bf = torch.cat([b, b.new_zeros((pad, 3))], 0)

    m = C - 1                          # interior poses per chunk
    D_int = Df[1:].reshape(n_s, C, 3, 3)[:, :m]
    U_all = Uf.reshape(n_s, C, 3, 3)
    U_int = U_all[:, 1:m]              # within-interior couplings
    U_left = U_all[:, 0]               # separator_k -> first interior
    U_right = U_all[:, m]              # last interior -> separator_{k+1}
    b_int = bf[1:].reshape(n_s, C, 3)[:, :m].reshape(n_s, 3 * m)
    D_sep = Df[::C]                    # [n_s+1, 3, 3]
    b_sep = bf[::C]                    # [n_s+1, 3]

    A = _block_tridiag_dense(D_int, U_int, U_int.transpose(-1, -2))
    # right-hand sides [B_k | C_k | b_k], B and C the separator couplings
    Bk = D.new_zeros((n_s, 3 * m, 3))
    Bk[:, 0:3, :] = U_left.transpose(-1, -2)
    Ck = D.new_zeros((n_s, 3 * m, 3))
    Ck[:, 3 * m - 3:, :] = U_right
    X = torch.linalg.solve(A, torch.cat([Bk, Ck, b_int[..., None]], -1))
    XB, XC, xb = X[..., 0:3], X[..., 3:6], X[..., 6]

    BT, CT = Bk.transpose(-1, -2), Ck.transpose(-1, -2)
    S_kk = BT @ XB                     # [K, 3, 3]
    S_kk1 = BT @ XC
    S_k1k = CT @ XB
    S_k1k1 = CT @ XC
    g_k = _mv(BT, xb)
    g_k1 = _mv(CT, xb)

    # the separators' system: block-tridiagonal over n_s + 1 separators
    Ds = D_sep.clone()
    Ds[:-1] -= S_kk
    Ds[1:] -= S_k1k1
    bs = b_sep.clone()
    bs[:-1] -= g_k
    bs[1:] -= g_k1
    Hs = _block_tridiag_dense(Ds, -S_kk1, -S_k1k.transpose(-1, -2))
    x_sep = torch.linalg.solve(Hs, bs.reshape(-1)).reshape(n_s + 1, 3)

    # back-substitution of the interiors
    x_int = xb - _mv(XB, x_sep[:-1]) - _mv(XC, x_sep[1:])   # [K, 3m]
    x = D.new_zeros((n_pad, 3))
    x[::C] = x_sep
    x[1:].view(n_s, C, 3)[:, :m] = x_int.reshape(n_s, m, 3)
    return x[:n]
