"""Writing a correction's new constraint rows into the fixed-capacity table.

Port of hitl_slam_tpu/models/hitl/repair.py::_scatter_constraints: valid
(anchor, corrected) pairs land in consecutive slots from `write_offset`
(slot = offset + cumsum(valid) - 1); invalid pairs, and valid ones past the
capacity, all go to the dump slot cap-1, which is then deactivated. Several
rows writing the dump slot leave its payload order-dependent; only its
`active` bit is defined.
"""

from __future__ import annotations

import torch

from ...core.state import ConstraintTable

Tensor = torch.Tensor


def _scatter_constraints(
    table: ConstraintTable,
    ctype: int,
    anchor_idx: Tensor,
    corr_idx: Tensor,
    dpar: Tensor,
    dperp: Tensor,
    dth: Tensor,
    pen: Tensor,
    valid: Tensor,
    write_offset,
) -> tuple[ConstraintTable, Tensor]:
    """write_offset: int or scalar int tensor. Returns (new table, number of
    valid pairs as a scalar int32 tensor)."""
    cap = table.capacity
    v = valid.reshape(-1)
    slots = write_offset + torch.cumsum(v.to(torch.int64), 0) - 1
    slots = torch.where(v, torch.clamp(slots, 0, cap - 1), cap - 1).long()

    MA, MC = valid.shape
    a_grid = anchor_idx[:, None].expand(MA, MC).reshape(-1)
    c_grid = corr_idx[None, :].expand(MA, MC).reshape(-1)

    def put(col: Tensor, vals) -> Tensor:
        vals = torch.as_tensor(vals, dtype=col.dtype, device=col.device)
        new = torch.where(v, vals.expand(v.shape), col[slots])
        return col.clone().index_put_((slots,), new)

    active = put(table.active, True)
    active[cap - 1] = False   # the dump slot stays dead
    new = ConstraintTable(
        ctype=put(table.ctype, int(ctype)),
        constrained=put(table.constrained, c_grid),
        anchor=put(table.anchor, a_grid),
        delta_parallel=put(table.delta_parallel, dpar.reshape(-1)),
        delta_perpendicular=put(table.delta_perpendicular, dperp.reshape(-1)),
        delta_angle=put(table.delta_angle, dth.reshape(-1)),
        penalty_dir=put(table.penalty_dir, pen.reshape(-1)),
        active=active,
    )
    return new, torch.sum(v).to(torch.int32)
