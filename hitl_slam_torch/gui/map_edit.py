"""Vector-map editing over the GUI bridge.

Port of hitl_slam_tpu/gui/map_edit.py (host numpy only, a copy).

The reference GUI carries map/graph editing modes for hand-curating vector
maps (VectorDisplayThread, vector_display_thread.h:209-218: add/delete line
segments in the loaded .vectormap, save on command). Equivalent here: a
`VectorMapFile` host model plus bridge message handlers — viewers send
  {"type": "map_edit", "op": "add_line", "p1": [...], "p2": [...]}
  {"type": "map_edit", "op": "delete_line", "p": [x, y]}   (nearest segment)
  {"type": "map_edit", "op": "save"}
and the engine broadcasts the updated map as draw-list lines.

File format: one `x1,y1,x2,y2` CSV row per segment — compatible with the
LTVM curator's vectors.txt output (an optional trailing mass column is
preserved on round-trip).
"""

from __future__ import annotations

import numpy as np

from .drawlist import DrawList


class VectorMapFile:
    def __init__(self, path: str):
        self.path = path
        self.segments: list[list[float]] = []   # [x1, y1, x2, y2, (mass)]
        self.load()

    def load(self):
        self.segments = []
        try:
            with open(self.path) as f:
                for line in f:
                    parts = [float(v) for v in line.strip().split(",") if v]
                    if len(parts) >= 4:
                        self.segments.append(parts[:5])
        except OSError:
            pass  # new map

    def save(self):
        with open(self.path, "w") as f:
            for s in self.segments:
                f.write(",".join(f"{v:.4f}" for v in s) + "\n")

    def add_line(self, p1, p2):
        self.segments.append(
            [float(p1[0]), float(p1[1]), float(p2[0]), float(p2[1])])

    def delete_nearest(self, p, max_dist: float = 1.0) -> bool:
        """Delete the segment nearest to p (within max_dist). Returns True if
        something was deleted."""
        if not self.segments:
            return False
        p = np.asarray(p, np.float64)
        best, best_d = -1, max_dist
        for i, s in enumerate(self.segments):
            a = np.array(s[0:2])
            b = np.array(s[2:4])
            d = b - a
            denom = max(float(d @ d), 1e-12)
            t = float(np.clip((p - a) @ d / denom, 0.0, 1.0))
            dist = float(np.linalg.norm(p - (a + t * d)))
            if dist < best_d:
                best, best_d = i, dist
        if best < 0:
            return False
        del self.segments[best]
        return True

    def to_drawlist(self, dl: DrawList | None = None,
                    color: int = 0x00A000) -> DrawList:
        dl = dl or DrawList()
        for s in self.segments:
            dl.draw_line(s[0:2], s[2:4], color)
        return dl


def handle_map_edit(vmap: VectorMapFile, msg: dict) -> bool:
    """Apply one map_edit message; returns True if the map changed."""
    op = msg.get("op")
    if op == "add_line":
        vmap.add_line(msg["p1"], msg["p2"])
        return True
    if op == "delete_line":
        return vmap.delete_nearest(msg["p"])
    if op == "save":
        vmap.save()
        return False
    return False
