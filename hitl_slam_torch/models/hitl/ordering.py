"""Selection ordering/filtering as branch-free masked tensor ops.

Port of hitl_slam_tpu/models/hitl/ordering.py::order_on_device (the
OrderAndFilterUserInput decision procedure): participation masks from
inlier counts, overlap resolution, role assignment with the selected-pair
swap, open-interval backprop bounds, the first contiguous corrected group
and its last pose, and fixed-capacity index lists padded with -1. Nothing
here reads back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

Tensor = torch.Tensor

MIN_POSE_INLIERS = 5
MAX_ANCHORS = 64
MAX_CORRECTED = 64


@dataclass(frozen=True)
class DeviceOrdering:
    valid: Tensor           # scalar bool
    sel: Tensor             # [4,2] possibly swapped
    corrected_mask: Tensor  # [P]
    anchor_mask: Tensor     # [P]
    corrected_idx: Tensor   # [MAX_CORRECTED] pad -1
    anchor_idx: Tensor      # [MAX_ANCHORS] pad -1
    group_mask: Tensor      # [P] first contiguous corrected run
    last_pose: Tensor       # scalar int32
    bp_min: Tensor          # scalar int32
    bp_max: Tensor          # scalar int32


def _mask_min(mask: Tensor, idx: Tensor, P: int) -> Tensor:
    return torch.min(torch.where(mask, idx, P))


def _mask_max(mask: Tensor, idx: Tensor) -> Tensor:
    return torch.max(torch.where(mask, idx, -1))


def _top_indices(mask: Tensor, idx: Tensor, k: int, P: int) -> Tensor:
    """First k set indices ascending, padded with -1."""
    vals = torch.where(mask, idx, P)
    picked = torch.sort(vals).values[:k]
    return torch.where(picked < P, picked, -1).to(torch.int32)


def order_on_device(c1: Tensor, c2: Tensor, sel: Tensor,
                    min_inliers: int = MIN_POSE_INLIERS) -> DeviceOrdering:
    """POINT corrections pass min_inliers=0 (a single observed point cannot
    produce >5 inliers)."""
    P = c1.shape[0]
    idx = torch.arange(P, device=c1.device)
    first = c1 > min_inliers
    second = c2 > min_inliers
    overlap = first & second
    n_f = torch.sum(first)
    n_s = torch.sum(second)
    n_o = torch.sum(overlap)

    complete = (n_o == n_f) & (n_o == n_s) & (n_o > 0)
    drop_from_second = (n_o == n_f) & ~complete
    drop_from_first = (n_o == n_s) & ~complete & ~drop_from_second
    drop_both = (n_o > 0) & ~complete & ~drop_from_second & ~drop_from_first

    first2 = torch.where(drop_from_first | drop_both, first & ~overlap, first)
    second2 = torch.where(drop_from_second | drop_both, second & ~overlap, second)
    n_f2 = torch.sum(first2)
    n_s2 = torch.sum(second2)

    f_min = _mask_min(first2, idx, P)
    f_max = _mask_max(first2, idx)
    s_min = _mask_min(second2, idx, P)
    s_max = _mask_max(second2, idx)

    first_is_corrected = f_min > s_max
    swapped = (f_max < s_min) & ~first_is_corrected
    ordered_ok = first_is_corrected | swapped

    corrected = torch.where(first_is_corrected, first2, second2)
    anchors = torch.where(first_is_corrected, second2, first2)
    bp_min = torch.where(first_is_corrected, s_max + 1, f_max + 1)
    bp_max = torch.where(first_is_corrected, f_min - 1, s_min - 1)

    # the pairs swapped by slices: a list index would be copied from the
    # host
    sel_out = torch.where(swapped, torch.cat([sel[2:4], sel[0:2]]), sel)

    valid = (
        ~complete
        & (n_f2 > 0)
        & (n_s2 > 0)
        & ordered_ok
        & (bp_min >= 0)
        & (bp_max >= 1)
    )

    # first contiguous corrected run + last pose (argmax of a bool picks the
    # first True, or 0 when there is none)
    start = torch.argmax(corrected.to(torch.int32))
    broken = (~corrected) & (idx >= start)
    group = corrected & (torch.cumsum(broken.to(torch.int32), 0) == 0)
    last_pose = _mask_max(group, idx).to(torch.int32)

    return DeviceOrdering(
        valid=valid,
        sel=sel_out,
        corrected_mask=corrected,
        anchor_mask=anchors,
        corrected_idx=_top_indices(corrected, idx, MAX_CORRECTED, P),
        anchor_idx=_top_indices(anchors, idx, MAX_ANCHORS, P),
        group_mask=group,
        last_pose=last_pose,
        bp_min=bp_min.to(torch.int32),
        bp_max=bp_max.to(torch.int32),
    )
