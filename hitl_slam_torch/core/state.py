"""MapState and the human-constraint data model, as torch dataclasses.

Port of hitl_slam_tpu/core/state.py. The session state is a set of dense,
statically shaped tensors with validity masks:

  - poses[P, 3]            (x, y, theta) per pose
  - covariances[P, 3, 3]   per-pose covariance blocks
  - points[P, N, 2]        robot-frame lidar points, padded to N_max
  - normals[P, N, 2]       per-point normals
  - point_mask[P, N]       validity of padded entries
  - ConstraintTable        struct-of-arrays HumanConstraint store with a fixed
                           capacity and an active mask

`from_numpy` / `to_numpy` convert the state to and from a dict of numpy
arrays keyed by field name (the constraint table nested under
"constraints"), so the same state can be fed to both packages.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

Tensor = torch.Tensor


class CorrectionType(enum.IntEnum):
    UNKNOWN = 0
    POINT = 1          # ALT
    LINE_SEGMENT = 2   # CTRL         ("colocation")
    CORNER = 3         # ALT + CTRL
    COLINEAR = 4       # SHIFT
    PERPENDICULAR = 5  # SHIFT + ALT
    PARALLEL = 6       # CTRL + SHIFT


@dataclass(frozen=True)
class ConstraintTable:
    """Struct-of-arrays HumanConstraint store with static capacity; `active`
    marks live rows."""

    ctype: Tensor        # [C] int32, CorrectionType value
    constrained: Tensor  # [C] int32 pose id
    anchor: Tensor       # [C] int32 pose id
    delta_parallel: Tensor       # [C] f32
    delta_perpendicular: Tensor  # [C] f32
    delta_angle: Tensor          # [C] f32
    penalty_dir: Tensor          # [C] f32 (relative penalty direction)
    active: Tensor       # [C] bool

    @staticmethod
    def empty(capacity: int, device, dtype=torch.float32) -> "ConstraintTable":
        zf = torch.zeros((capacity,), dtype=dtype, device=device)
        zi = torch.zeros((capacity,), dtype=torch.int32, device=device)
        return ConstraintTable(
            ctype=zi, constrained=zi.clone(), anchor=zi.clone(),
            delta_parallel=zf, delta_perpendicular=zf.clone(),
            delta_angle=zf.clone(), penalty_dir=zf.clone(),
            active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.ctype.shape[0]


@dataclass(frozen=True)
class MapState:
    """The full repairable-map state as dense tensors on one device."""

    poses: Tensor          # [P, 3]
    covariances: Tensor    # [P, 3, 3]
    points: Tensor         # [P, N, 2] robot frame
    normals: Tensor        # [P, N, 2] robot frame
    point_mask: Tensor     # [P, N] bool
    odometry: Tensor       # [P, 3] raw odometry poses
    constraints: ConstraintTable

    @property
    def num_poses(self) -> int:
        return self.poses.shape[0]

    @property
    def max_points(self) -> int:
        return self.points.shape[1]

    def world_points(self) -> Tensor:
        """[P, N, 2] points in the world frame, computed on demand."""
        from ..ops import geometry

        return geometry.pose_to_world(self.poses[:, None, :], self.points)

    def replace(self, **changes) -> "MapState":
        return replace(self, **changes)


@dataclass
class SingleInput:
    """One logged human correction."""

    correction_type: CorrectionType
    undone: int
    points: np.ndarray  # [K, 2] clicked points (world frame)


def make_map_state(
    poses: np.ndarray,
    covariances: np.ndarray,
    point_clouds: list[np.ndarray],
    normal_clouds: list[np.ndarray],
    device,
    odometry: np.ndarray | None = None,
    constraint_capacity: int = 8192,
    max_points: int | None = None,
    pad_multiple: int = 128,
    dtype=torch.float32,
) -> MapState:
    """Pack ragged per-pose clouds into a padded, masked MapState on
    `device`. N_max is rounded up to `pad_multiple`, as in the JAX package,
    so both hold identical arrays."""
    num_poses = len(point_clouds)
    if poses.shape != (num_poses, 3):
        raise ValueError(f"poses {poses.shape} != ({num_poses}, 3)")
    if max_points is None:
        max_points = max((len(pc) for pc in point_clouds), default=1)
    max_points = max(1, -(-max_points // pad_multiple) * pad_multiple)

    pts = np.zeros((num_poses, max_points, 2), np.float32)
    nrm = np.zeros((num_poses, max_points, 2), np.float32)
    msk = np.zeros((num_poses, max_points), bool)
    for i, (pc, nc) in enumerate(zip(point_clouds, normal_clouds)):
        k = min(len(pc), max_points)
        pts[i, :k] = pc[:k]
        nrm[i, :k] = nc[:k]
        msk[i, :k] = True

    if odometry is None:
        odometry = poses.copy()

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return MapState(
        poses=t(poses),
        covariances=t(covariances),
        points=t(pts),
        normals=t(nrm),
        point_mask=t(msk, torch.bool),
        odometry=t(odometry),
        constraints=ConstraintTable.empty(constraint_capacity, device, dtype),
    )


_TABLE_DTYPES = {
    "ctype": torch.int32, "constrained": torch.int32, "anchor": torch.int32,
    "delta_parallel": torch.float32, "delta_perpendicular": torch.float32,
    "delta_angle": torch.float32, "penalty_dir": torch.float32,
    "active": torch.bool,
}


def table_from_numpy(arrays: dict, device) -> ConstraintTable:
    return ConstraintTable(**{
        k: torch.as_tensor(np.array(arrays[k]), dtype=dt, device=device)
        for k, dt in _TABLE_DTYPES.items()
    })


def table_to_numpy(table: ConstraintTable) -> dict:
    return {f.name: getattr(table, f.name).detach().cpu().numpy()
            for f in fields(table)}


def from_numpy(arrays: dict, device) -> MapState:
    """MapState from a dict of numpy arrays keyed by MapState field name,
    with the constraint table as a nested dict under "constraints" (the
    layout of the JAX package's MapState read back with np.asarray)."""
    def t(k, dt):
        return torch.as_tensor(np.array(arrays[k]), dtype=dt, device=device)

    return MapState(
        poses=t("poses", torch.float32),
        covariances=t("covariances", torch.float32),
        points=t("points", torch.float32),
        normals=t("normals", torch.float32),
        point_mask=t("point_mask", torch.bool),
        odometry=t("odometry", torch.float32),
        constraints=table_from_numpy(arrays["constraints"], device),
    )


def to_numpy(state: MapState) -> dict:
    out = {f.name: getattr(state, f.name).detach().cpu().numpy()
           for f in fields(state) if f.name != "constraints"}
    out["constraints"] = table_to_numpy(state.constraints)
    return out
