"""Device mesh: a grid of torch devices, placements on it, and the
collectives of a partitioned computation.

Port of hitl_slam_tpu/parallel/mesh.py. The framework's two parallel axes:

  "replica" - data parallelism over independent map replicas (the batched
              throughput configuration, BASELINE.json config #5);
  "pose"    - sequence parallelism over the trajectory: the pose-sharded
              LM solve (parallel/sharded_solver.py) cuts the pose axis
              into d partitions and couples them by a few small
              collectives a step.

A mesh entry is a `torch.device`, and one device may fill several entries:
`[torch.device("cuda", 0)] * 8` is an 8-entry mesh on one card, the port's
counterpart of the reference's 8 virtual CPU devices. Adjacent entries on the
same device form one *group*. A group holds its partitions stacked on a
leading dimension and runs each step as one batch; data moves between groups
by `.to()`. Entries `cpu:0 ... cpu:7` are distinct devices (while their
tensors all live in host memory), so they give eight groups of one.

The collectives take and return one tensor per group, each `[n_g, ...]` for
the group's n_g partitions, and are the port's counterparts of
`lax.ppermute` (a cyclic shift by one along the axis), `lax.all_gather`
and `lax.psum`. `collectives` counts the floats each moves per partition.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

Tensor = torch.Tensor

AXIS_NAMES = ("replica", "pose")


@dataclass(frozen=True, eq=False)
class Mesh:
    """An [n_replica, n_pose] grid of torch devices."""

    devices: np.ndarray   # object array of torch.device, [n_replica, n_pose]
    axis_names: tuple[str, ...] = AXIS_NAMES

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis(self, name: str) -> list[torch.device]:
        """The entries along axis `name` (at index 0 of the other axis)."""
        if name == "replica":
            return list(self.devices[:, 0])
        if name == "pose":
            return list(self.devices[0, :])
        raise ValueError(f"mesh has no axis {name!r}")


@dataclass(frozen=True)
class NamedSharding:
    """A placement: the mesh, and the mesh axis each leading dimension of a
    value is cut along (the reference's NamedSharding(mesh, P(*spec)))."""

    mesh: Mesh
    spec: tuple[str, ...]


def make_mesh(n_replica: int = 1, n_pose: int = 1, devices=None) -> Mesh:
    """An [n_replica, n_pose] mesh of the first n_replica * n_pose of
    `devices` (default: every visible CUDA device)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(dv) for dv in devices]
    n = n_replica * n_pose
    if len(devices) < n:
        raise RuntimeError(
            f"need {n} devices for a (replica={n_replica}, pose={n_pose}) "
            f"mesh, but got {devices}. For a virtual mesh, repeat one "
            f"device: devices=[torch.device('cuda', 0)] * {n}, or on the "
            f"CPU devices=[torch.device('cpu', i) for i in range({n})]")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(n_replica, n_pose))


def replica_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-of-maps values: leading axis over 'replica'."""
    return NamedSharding(mesh, ("replica",))


def pose_sharding(mesh: Mesh) -> NamedSharding:
    """Single-map values: leading (pose) axis over 'pose'."""
    return NamedSharding(mesh, ("pose",))


def batched_pose_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-of-maps values sharded on both axes: [B, P, ...]."""
    return NamedSharding(mesh, ("replica", "pose"))


def storage(device: torch.device) -> torch.device:
    """Where a mesh entry's tensors live: the entry itself, or the host for
    every CPU entry."""
    return torch.device("cpu") if device.type == "cpu" else device


@dataclass(frozen=True)
class Group:
    """A run of adjacent mesh entries on one device: partitions lo..hi-1."""

    device: torch.device
    lo: int
    hi: int

    def index(self) -> Tensor:
        """The group's partition numbers, on its device."""
        return torch.arange(self.lo, self.hi, device=self.device)


def groups_of(entries: list[torch.device]) -> list[Group]:
    """The groups of a mesh axis's entries: maximal runs of adjacent
    entries on the same device."""
    out = []
    for i, dv in enumerate(entries):
        if out and entries[i - 1] == dv:
            out[-1] = Group(out[-1].device, out[-1].lo, i + 1)
        else:
            out.append(Group(storage(dv), i, i + 1))
    return out


class CollectiveCounter:
    """Per kind of collective ("shift", "gather", "sum"): the calls, the
    floats one partition sent over all of them, and the most it sent in
    one call. The port's counterpart of counting the collectives of the
    reference's program; bumped by the collectives below and nowhere else."""

    KINDS = ("shift", "gather", "sum")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = dict.fromkeys(self.KINDS, 0)
        self.floats = dict.fromkeys(self.KINDS, 0)
        self.largest = dict.fromkeys(self.KINDS, 0)

    def add(self, kind: str, floats: int) -> None:
        self.calls[kind] += 1
        self.floats[kind] += floats
        self.largest[kind] = max(self.largest[kind], floats)


collectives = CollectiveCounter()


def split(x: Tensor, groups: list[Group]) -> list[Tensor]:
    """A stack of partitions [d, ...] as one [n_g, ...] tensor a group, on
    the group's device."""
    return [x[g.lo:g.hi].to(g.device) for g in groups]


def shift(xs: list[Tensor], groups: list[Group], offset: int
          ) -> list[Tensor]:
    """Cyclic shift by one along the axis: partition j receives partition
    (j - offset) mod d's value (offset +1: from the previous partition,
    -1: from the next), as `lax.ppermute` with the permutation
    [(i, (i + offset) % d)] delivers it."""
    collectives.add("shift", xs[0][0].numel())
    k = len(groups)
    out = []
    for i, g in enumerate(groups):
        if offset == 1:
            edge = xs[(i - 1) % k][-1:].to(g.device)
            out.append(torch.cat([edge, xs[i][:-1]]))
        elif offset == -1:
            edge = xs[(i + 1) % k][:1].to(g.device)
            out.append(torch.cat([xs[i][1:], edge]))
        else:
            raise ValueError(f"shift by {offset}: only by +1 or -1")
    return out


def all_gather(xs: list[Tensor], groups: list[Group]) -> list[Tensor]:
    """Every partition's value, [d, ...] in partition order, on each
    group's device."""
    collectives.add("gather", xs[0][0].numel())
    return [xs[0] if len(xs) == 1 else
            torch.cat([x.to(g.device) for x in xs]) for g in groups]


def psum(xs: list[Tensor], groups: list[Group]) -> list[Tensor]:
    """The sum over the partitions of a [n_g] value a partition, on each
    group's device. Summed in partition order from the gathered [d]
    vector, so every group, and every grouping, adds the same floats in
    the same order."""
    collectives.add("sum", xs[0][0].numel())
    return [(xs[0] if len(xs) == 1 else
             torch.cat([x.to(g.device) for x in xs])).sum(0)
            for g in groups]


@dataclass(frozen=True)
class Placed:
    """A value cut along its leading dimension into contiguous shares, one
    a group of a mesh axis: the port's counterpart of an array that
    `jax.device_put` placed with a NamedSharding. Each share is a tensor,
    or a dataclass of tensors cut alike, on its group's device."""

    shares: tuple
    groups: tuple[Group, ...]


def _cut(value, lo: int, hi: int, device: torch.device):
    if isinstance(value, Tensor):
        return value[lo:hi].to(device)
    return type(value)(**{f.name: _cut(getattr(value, f.name), lo, hi, device)
                          for f in fields(value)})


def device_put(value, sharding: NamedSharding) -> Placed:
    """Cut `value` (a tensor, or a dataclass of tensors with one leading
    dimension) along its leading dimension over the sharding's one axis:
    equal contiguous parts a mesh entry, each group's parts on its
    device."""
    if len(sharding.spec) != 1:
        raise ValueError(f"device_put: one mesh axis, got {sharding.spec}")
    entries = sharding.mesh.axis(sharding.spec[0])
    lead = (value if isinstance(value, Tensor)
            else getattr(value, fields(value)[0].name)).shape[0]
    d = len(entries)
    if lead % d:
        raise ValueError(f"device_put: leading dimension {lead} does not "
                         f"divide over the {d} entries of {sharding.spec[0]}")
    part = lead // d
    groups = tuple(groups_of(entries))
    return Placed(tuple(_cut(value, g.lo * part, g.hi * part, g.device)
                        for g in groups), groups)
