"""The repair step after EM: explicit correction -> new constraint rows ->
covariance backprop -> angle wrap -> joint LM solve.

Port of hitl_slam_tpu/models/hitl/repair.py (`RepairOutput`, `repair_step`,
`_scatter_constraints`). New constraint rows: valid (anchor, corrected)
pairs land in consecutive slots from `write_offset` (slot = offset +
cumsum(valid) - 1); invalid pairs, and valid ones past the capacity, all go
to the dump slot cap-1, which is then deactivated. Several rows writing the
dump slot leave its payload order-dependent; only its `active` bit is
defined.

On a CUDA device `repair_step` replays one device program (one CUDA graph
of the whole step, its LM loop a WHILE node), as the reference runs its
jitted `repair_step`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core.state import ConstraintTable
from ...ops.geometry import angle_mod
from ...solver.joint import build_problem
from ...solver.lm import LMConfig, LMResult, solve as lm_solve
from ...utils.device_loop import (DeviceProgram, ProgramCache, replays,
                                  signature)
from .backprop import backprop
from .explicit import apply_explicit, constraint_deltas

Tensor = torch.Tensor


@dataclass(frozen=True)
class RepairOutput:
    poses: Tensor
    covariances: Tensor
    constraints: ConstraintTable
    num_new_constraints: Tensor  # scalar int32
    lm: LMResult
    correction: Tensor           # [3] explicit-stage correction fed to backprop
    pre_solve_poses: Tensor      # [P,3] post-backprop, pre-LM poses


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
        # a Python scalar stays one (no tensor copied from the host)
        if isinstance(vals, Tensor):
            vals = vals.to(col.dtype).expand(v.shape)
        new = torch.where(v, vals, col[slots])
        return col.clone().index_put_((slots,), new)

    active = put(table.active, True)
    active[cap - 1:].fill_(False)   # the dump slot stays dead
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


def _wrap_theta(poses: Tensor) -> Tensor:
    return torch.cat([poses[:, :2], angle_mod(poses[:, 2:3])], dim=1)


def repair_step(
    poses: Tensor,
    covariances: Tensor,
    constraints: ConstraintTable,
    ctype: int,            # CorrectionType value
    sel: Tensor,           # [4,2] refit + reordered selected points
    group_mask: Tensor,    # [P] bool, first contiguous corrected group
    last_pose,             # int or scalar int tensor
    anchor_idx: Tensor,    # [MA] int (pad -1)
    corr_idx: Tensor,      # [MC] int (pad -1)
    bp_min,                # int or scalar int tensor
    bp_max,                # int or scalar int tensor
    write_offset,          # int or scalar int tensor: next free table slot
    lm_config: LMConfig = LMConfig(),
    *,
    eager: bool = False,
) -> RepairOutput:
    """One correction after EM and ordering, on the device: the explicit
    rigid correction (with the tail carry), the constraint targets from the
    corrected poses and their rows in the table, the covariance-weighted
    backprop over the open window, the angle wrap, and the joint LM solve
    (whose poses are wrapped again on the way out).

    The scalars (`last_pose`, `bp_min`, `bp_max`, `write_offset`) become
    int32 tensors on the poses' device. On a CUDA device the step replays
    its program for the inputs' shapes, `ctype` and `lm_config` (the
    reference's static arguments; `repair_program`) unless `eager`, which
    runs the same code eagerly there, for comparisons only."""
    ctype = int(ctype)
    dev = poses.device
    last_pose, bp_min, bp_max, write_offset = (
        torch.as_tensor(v, dtype=torch.int32, device=dev)
        for v in (last_pose, bp_min, bp_max, write_offset))
    sel, group_mask, anchor_idx, corr_idx = (
        torch.as_tensor(v, device=dev)
        for v in (sel, group_mask, anchor_idx, corr_idx))
    args = (poses, covariances, constraints, sel, group_mask, last_pose,
            anchor_idx, corr_idx, bp_min, bp_max, write_offset)
    if replays(poses, eager):
        return repair_program(args, ctype, lm_config).run(*args)
    return _repair(*args, ctype, lm_config)


_programs = ProgramCache(size=2)


def repair_program(example: tuple, ctype: int,
                   lm_config: LMConfig = LMConfig()) -> DeviceProgram:
    """repair_step's program on a CUDA device for inputs shaped as
    `example` (repair_step's tensors in its order, the scalars as int32
    tensors), `ctype` and `lm_config`: the one made before, or a new one
    (captured at its first run)."""
    dev = example[0].device
    key = (signature(example), int(ctype), lm_config, dev.index)
    return _programs.get(key, lambda: DeviceProgram(
        lambda *a: _repair(*a, int(ctype), lm_config), example, dev,
        name="repair"))


def _repair(poses, covariances, constraints, sel, group_mask, last_pose,
            anchor_idx, corr_idx, bp_min, bp_max, write_offset, ctype: int,
            lm_config: LMConfig) -> RepairOutput:
    """repair_step's step, eager or captured."""
    poses1, C = apply_explicit(poses, ctype, sel, group_mask, last_pose)
    dpar, dperp, dth, pen, valid = constraint_deltas(
        poses1, sel, anchor_idx, corr_idx)
    table, n_new = _scatter_constraints(
        constraints, ctype, anchor_idx, corr_idx,
        dpar, dperp, dth, pen, valid, write_offset)
    poses2, cov2 = backprop(poses1, covariances, C, bp_min, bp_max)
    poses2 = _wrap_theta(poses2)
    # part of this step's program when captured
    lm = lm_solve(build_problem(poses2, table), poses2, lm_config,
                  eager=True)
    return RepairOutput(
        poses=_wrap_theta(lm.poses),
        covariances=cov2,
        constraints=table,
        num_new_constraints=n_new,
        lm=lm,
        correction=C,
        pre_solve_poses=poses2,
    )
