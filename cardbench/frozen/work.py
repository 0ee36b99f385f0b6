"""Bytes and float32 operations of one launch of the port's two kernels,
from their shapes, and the peaks they are held against.

Frozen copy of `em_scan_work` and `bcr_work` from chip_smoke.py at commit
455be22, unchanged. Each input byte is counted once and each output byte
once; the bound of a launch is max(bytes / HBM rate, ops / f32 rate).
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at 700 W: HBM3 bytes/s, f32 FLOP/s outside
# the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def em_scan_work(mask) -> tuple[int, int]:
    """(bytes, flops) of one em_scan call: world, mask and sel read once,
    counts and minima written once; per point 6 operations for each of the
    4 clicked points, and 18 for each of the 2 segments where the point is
    masked in (the kernel skips the segment test elsewhere)."""
    P, N = mask.shape
    bytes_moved = P * N * 8 + P * N + 4 * 2 * 4 + P * 2 * 4 + 4 * 4
    flops = P * N * 4 * 6 + int(mask.sum()) * 2 * 18
    return bytes_moved, flops


def bcr_work(n: int, systems: int = 1, rhs: int = 1) -> tuple[int, int]:
    """(bytes, flops) of `systems` n-pose systems, each solved against `rhs`
    right-hand sides: D, U read once a system, b read and x written once a
    right-hand side. Cyclic reduction of an n-pose system eliminates n - 1
    lanes. The factorization, once a system, does a lane's 3x3 adjugate
    inverse (42 operations), its products Dinv L, Dinv U (90) and its even
    neighbour's matrix update (four 3x3 products, 18 subtractions, 18
    negations: 216), and at the root one more inverse (42); each
    right-hand side does a lane's Dinv b (15), its neighbour's vector update
    (two matrix-vector products, 6 subtractions: 36) and its
    back-substitution (51), and at the root one product (15)."""
    bytes_moved = 4 * (systems * (9 * n + 9 * (n - 1))
                       + systems * rhs * (3 * n + 3 * n))
    flops = (systems * ((n - 1) * (42 + 90 + 216) + 42)
             + systems * rhs * ((n - 1) * (15 + 36 + 51) + 15))
    return bytes_moved, flops


def bound_s(bytes_moved: int, flops: int) -> float:
    """The least time the card could take for this work."""
    return max(bytes_moved / PEAK_BYTES_S, flops / PEAK_F32_FLOPS)
