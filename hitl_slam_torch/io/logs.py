"""Correction-log reader/writer. Host only.

Port of hitl_slam_tpu/io/logs.py. Format: first line = number of entries;
each entry is a `type, undone` line followed by K `x, y` lines of clicked
points, where K is 2 for point, 8 for corner, and 4 for the line-pair
correction types. Type 7 is read as parallel, as logs written by the
original tool use it.
"""

from __future__ import annotations

import numpy as np

from ..core.state import CorrectionType, SingleInput

_NUM_POINTS = {
    CorrectionType.POINT: 2,
    CorrectionType.CORNER: 8,
    CorrectionType.LINE_SEGMENT: 4,
    CorrectionType.COLINEAR: 4,
    CorrectionType.PERPENDICULAR: 4,
    CorrectionType.PARALLEL: 4,
}


def load_log(path: str) -> list[SingleInput]:
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    num_entries = int(lines[0])
    entries: list[SingleInput] = []
    i = 1
    known = set(int(t) for t in CorrectionType)
    for _ in range(num_entries):
        if i >= len(lines):
            break
        type_str, undone_str = lines[i].split(",")
        raw_type = int(type_str)
        if raw_type == 7:
            raw_type = int(CorrectionType.PARALLEL)
        ctype = (CorrectionType(raw_type) if raw_type in known
                 else CorrectionType.UNKNOWN)
        k = _NUM_POINTS.get(ctype, 0)
        pts = np.array(
            [[float(v) for v in lines[i + 1 + j].split(",")] for j in range(k)],
            np.float32,
        ).reshape(k, 2)
        entries.append(SingleInput(ctype, int(undone_str), pts))
        i += 1 + k
    return entries


def save_log(path: str, inputs: list[SingleInput]) -> None:
    with open(path, "w") as f:
        f.write(f"{len(inputs)} \n")
        for inp in inputs:
            f.write(f"{int(inp.correction_type)}, {inp.undone}\n")
            for p in np.asarray(inp.points).reshape(-1, 2):
                f.write(f"{p[0]:.4f}, {p[1]:.4f}\n")
