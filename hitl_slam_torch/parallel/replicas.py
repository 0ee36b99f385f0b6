"""Replica batching: optimize many perturbed copies of one map at once.

Port of hitl_slam_tpu/parallel/replicas.py (`make_perturbed_replicas`,
`batched_solve`): the statistical-robustness run, 32 perturbed Figure8
replicas optimized together. The reference vmaps problem build and LM solve
over a leading replica axis; here each replica's problem is built on its
own, the problems are stacked on a leading dimension, and
solver/lm.py::solve_batched runs one LM over the batch, one batched linear
solve a step (on the card, one launch of csrc/bcr.cu's batched route).

Deviation: the reference gates the one-hot selector of the table -> pose
reduction on the whole batch's footprint (B * P * C <= 384M), because its
vmap stacks B selectors at once, and takes the scatter route above it. The
port never holds more than one selector, so each replica takes the lone
solve's gate (P * C <= ONEHOT_BUDGET), and each replica's reduction order is
exactly the lone solve's.

`shard_replicas` places contiguous chunks of the replicas on the mesh's
'replica' axis (parallel/mesh.py); `batched_solve` of placed replicas runs
one batched LM a device group and returns the results in replica order. On
a mesh that repeats one device that is one group, the unsharded call.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass

import numpy as np
import torch

from ..core.state import ConstraintTable
from ..solver.joint import JointProblem, build_problem
from ..solver.lm import LMConfig, LMResult, solve_batched
from . import mesh as M

Tensor = torch.Tensor


def _stack(items: list):
    """Stack a list of like dataclasses of tensors field by field on a new
    leading dimension (nested dataclasses recursively; other fields, such as
    JointProblem.num_poses, are taken from the first)."""
    first = items[0]
    if isinstance(first, Tensor):
        return torch.stack(items)
    if is_dataclass(first):
        return type(first)(**{
            f.name: _stack([getattr(it, f.name) for it in items])
            for f in fields(first)})
    return first


def replica_table(table_b: ConstraintTable, r: int) -> ConstraintTable:
    """Replica r's table of a table with a leading replica dimension."""
    return ConstraintTable(**{f.name: getattr(table_b, f.name)[r]
                              for f in fields(table_b)})


def make_perturbed_replicas(
    poses: np.ndarray,
    table: ConstraintTable,
    num_replicas: int,
    trans_noise: float = 0.02,
    angle_noise: float = 0.005,
    seed: int = 0,
) -> tuple[Tensor, ConstraintTable]:
    """[B, P, 3] perturbed poses (pose 0 kept as the gauge) and the table
    broadcast to a leading [B] (a view, not a copy), on the table's device.
    The draws are the reference's: the same numpy generator, the same
    calls in the same order, so the replicas are bit-equal to its."""
    rng = np.random.default_rng(seed)
    base = np.asarray(poses, np.float32)
    reps = np.tile(base[None], (num_replicas, 1, 1))
    reps[:, :, :2] += rng.normal(0, trans_noise,
                                 reps[:, :, :2].shape).astype(np.float32)
    reps[:, :, 2] += rng.normal(0, angle_noise,
                                reps[:, :, 2].shape).astype(np.float32)
    reps[:, 0] = base[0]  # keep the gauge pose identical
    batched_table = ConstraintTable(**{
        f.name: getattr(table, f.name).expand(
            num_replicas, *getattr(table, f.name).shape)
        for f in fields(table)})
    return (torch.as_tensor(reps, device=table.ctype.device),
            batched_table)


def build_problems(poses_b: Tensor, table_b: ConstraintTable
                   ) -> JointProblem:
    """Each replica's problem at its own poses, built one at a time (one
    one-hot selector alive at once), stacked on a leading [B]."""
    return _stack([build_problem(poses_b[r], replica_table(table_b, r))
                   for r in range(poses_b.shape[0])])


def batched_solve(
    poses: Tensor,            # [B, P, 3]
    table: ConstraintTable,   # leaves with a leading [B]
    config: LMConfig = LMConfig(),
    device="cuda",
) -> LMResult:
    """Build every replica's problem and run one batched LM over them on
    `device`: an LMResult of [B, P, 3] poses and [B] costs, iteration
    counts, convergence flags and exit damping. Replicas placed by
    `shard_replicas` run where they were placed, one batched LM a device
    group, and come back in replica order on the first group's device."""
    if isinstance(poses, M.Placed):
        out = [batched_solve(p, tb, config, grp.device) for p, tb, grp in
               zip(poses.shares, table.shares, poses.groups)]
        if len(out) == 1:
            return out[0]
        dev = poses.groups[0].device
        return LMResult(**{f.name: torch.cat([getattr(o, f.name).to(dev)
                                              for o in out])
                           for f in fields(LMResult)})
    poses = torch.as_tensor(poses, dtype=torch.float32, device=device)
    table = ConstraintTable(**{f.name: getattr(table, f.name).to(device)
                               for f in fields(table)})
    return solve_batched(build_problems(poses, table), poses, config)


def shard_replicas(mesh: M.Mesh, poses_b: Tensor, table_b: ConstraintTable):
    """Place the replica axis across the mesh's 'replica' axis: B / n_replica
    contiguous replicas an entry, each device group's on its device."""
    sh = M.replica_sharding(mesh)
    return M.device_put(poses_b, sh), M.device_put(table_b, sh)
