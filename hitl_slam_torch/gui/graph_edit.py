"""Navigation / semantic graph editing over the GUI bridge.

Port of hitl_slam_tpu/gui/graph_edit.py (host json only, a copy).

The reference GUI edits two *graph* maps in addition to the vector line map:
the navigation graph (navMapMode) and the semantic graph (semanticMapMode),
both driven by modifier-keyed mouse drags in VectorDisplayThread::editGraph
(vector_display_thread.cpp:305-440, declared vector_display_thread.h:209-218):

  Shift  (0x04): empty space -> add vertex (semantic: with type/label/angle);
                 drag vertex A -> vertex B -> add edge (nav: width/max_speed/
                 has_door params; semantic: edge type)
  Ctrl   (0x02): click vertex -> delete vertex; click edge -> delete edge
  Alt    (0x01): drag vertex -> move it; drag edge -> shift both endpoints
  Ctrl+Alt(0x03): edit parameters of the vertex/edge under the cursor
  kMaxError = 0.1 m hit radius; a "click" is a drag shorter than kMaxError.

The reference's NavigationMap class itself is NOT in the repo (the
`map/navigation_map.h` include and member are commented out,
vector_display_thread.h:51,92), so its file format is unrecoverable; this
module defines the graph model + a JSON file format and reuses the exact
editGraph interaction semantics above. The GUI parameter dialogs
(GetNavEdgeParams / GetSemanticTypeAndLabel) become message fields supplied
by the viewer.

Bridge messages ({"type": "graph_edit", ...}):
  {"op": "interact", "down": [x,y], "up": [x,y], "modifiers": M,
   "params": {...}}                      -- the editGraph drag protocol
  {"op": "save"} / {"op": "load"}
"""

from __future__ import annotations

import json
import math

from .drawlist import DrawList

# editGraph's vertex/edge hit radius and click threshold
#   (vector_display_thread.cpp:313 kMaxError)
MAX_ERROR = 0.1

# the reference's semantic vocabularies (vector_display_thread.cpp:322-335)
SEMANTIC_VERTEX_TYPES = ("Office", "Other", "Stair", "Bathroom", "Elevator",
                         "Kitchen", "Printer", "MapExit")
SEMANTIC_EDGE_TYPES = ("Hallway", "Vertical", "MapExit")


class GraphMap:
    """Vertex/edge graph with nav params or semantic annotations.

    vertices: {handle: {"x", "y", "angle", "type", "name"}}
    edges: list of {"v1", "v2", "width", "max_speed", "has_door", "type"}
    (nav graphs leave type/name empty; semantic graphs carry them —
    matching NavigationMap's dual use in editGraph).
    """

    def __init__(self, path: str, semantic: bool = False):
        self.path = path
        self.semantic = semantic
        self.vertices: dict[int, dict] = {}
        self.edges: list[dict] = []
        self._next_handle = 0
        self.load()

    # -- persistence --
    def load(self):
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return  # new graph
        self.vertices = {int(k): dict(v)
                         for k, v in data.get("vertices", {}).items()}
        self.edges = [dict(e) for e in data.get("edges", [])]
        self._next_handle = 1 + max(self.vertices.keys(), default=-1)

    def save(self):
        with open(self.path, "w") as f:
            json.dump({"semantic": self.semantic,
                       "vertices": {str(k): v
                                    for k, v in self.vertices.items()},
                       "edges": self.edges}, f, indent=1)

    # -- NavigationMap-API analogs --
    def next_vertex_index(self) -> int:           # GetNextVertexIndex
        h = self._next_handle
        self._next_handle += 1
        return h

    def add_vertex(self, x, y, angle=0.0, vtype="", name="") -> int:
        h = self.next_vertex_index()
        self.vertices[h] = {"x": float(x), "y": float(y),
                            "angle": float(angle), "type": vtype,
                            "name": name}
        return h

    def add_edge(self, v1: int, v2: int, width=1.0, max_speed=1.0,
                 has_door=False, etype="") -> bool:
        if v1 not in self.vertices or v2 not in self.vertices or v1 == v2:
            return False
        for e in self.edges:
            if {e["v1"], e["v2"]} == {v1, v2}:
                return False
        self.edges.append({"v1": v1, "v2": v2, "width": float(width),
                           "max_speed": float(max_speed),
                           "has_door": bool(has_door), "type": etype})
        return True

    def delete_vertex(self, h: int):
        self.vertices.pop(h, None)
        self.edges = [e for e in self.edges
                      if e["v1"] != h and e["v2"] != h]

    def delete_edge(self, v1: int, v2: int):
        self.edges = [e for e in self.edges
                      if {e["v1"], e["v2"]} != {v1, v2}]

    def closest_vertex(self, p, max_dist: float = MAX_ERROR) -> int:
        """Handle of the nearest vertex within max_dist, else -1
        (GetClosestVertex)."""
        best, best_d = -1, max_dist
        for h, v in self.vertices.items():
            d = math.hypot(v["x"] - p[0], v["y"] - p[1])
            if d < best_d:
                best, best_d = h, d
        return best

    def closest_edge(self, p, max_dist: float = MAX_ERROR) -> int:
        """Index of the nearest edge within max_dist of the segment, else -1
        (GetClosestEdge)."""
        best, best_d = -1, max_dist
        for i, e in enumerate(self.edges):
            a = self.vertices[e["v1"]]
            b = self.vertices[e["v2"]]
            ax, ay, bx, by = a["x"], a["y"], b["x"], b["y"]
            dx, dy = bx - ax, by - ay
            denom = max(dx * dx + dy * dy, 1e-12)
            t = min(max(((p[0] - ax) * dx + (p[1] - ay) * dy) / denom, 0.0),
                    1.0)
            d = math.hypot(p[0] - (ax + t * dx), p[1] - (ay + t * dy))
            if d < best_d:
                best, best_d = i, d
        return best

    # -- the editGraph drag protocol --
    def interact(self, down, up, modifiers: int,
                 params: dict | None = None) -> bool:
        """One modifier-keyed mouse drag, exactly editGraph's dispatch
        (vector_display_thread.cpp:340-440). Returns True if the graph
        changed."""
        params = params or {}
        v_down = self.closest_vertex(down)
        v_up = self.closest_vertex(up)
        e_near = self.closest_edge(down)
        click = math.hypot(up[0] - down[0], up[1] - down[1]) < MAX_ERROR
        dragged_between = (v_down >= 0 and v_up >= 0 and v_down != v_up)

        if modifiers == 0x04:            # Shift: add vertex or edge
            if not dragged_between and v_down < 0:
                angle = math.atan2(up[1] - down[1], up[0] - down[0])
                if self.semantic:
                    vtype = params.get("type", "Other")
                    if vtype not in SEMANTIC_VERTEX_TYPES:
                        return False
                    self.add_vertex(down[0], down[1], angle, vtype,
                                    params.get("name", ""))
                else:
                    self.add_vertex(down[0], down[1])
                return True
            if dragged_between:
                if self.semantic:
                    etype = params.get("type", "Hallway")
                    if etype not in SEMANTIC_EDGE_TYPES:
                        return False
                    return self.add_edge(v_down, v_up, 1, 1, False, etype)
                return self.add_edge(
                    v_down, v_up, params.get("width", 1.0),
                    params.get("max_speed", 1.0),
                    params.get("has_door", False))
            return False
        if modifiers == 0x02:            # Ctrl: delete vertex or edge
            if click and v_down >= 0:
                self.delete_vertex(v_down)
                return True
            if click and e_near >= 0:
                e = self.edges[e_near]
                self.delete_edge(e["v1"], e["v2"])
                return True
            return False
        if modifiers == 0x01:            # Alt: move vertex or edge
            if v_down >= 0:
                self.vertices[v_down]["x"] = float(up[0])
                self.vertices[v_down]["y"] = float(up[1])
                return True
            if e_near >= 0:
                sx, sy = up[0] - down[0], up[1] - down[1]
                e = self.edges[e_near]
                for h in (e["v1"], e["v2"]):
                    self.vertices[h]["x"] += sx
                    self.vertices[h]["y"] += sy
                return True
            return False
        if modifiers == 0x03:            # Ctrl+Alt: edit parameters
            if v_down >= 0:
                v = self.vertices[v_down]
                for k in ("type", "name", "angle"):
                    if k in params:
                        v[k] = params[k]
                return True
            if e_near >= 0:
                e = self.edges[e_near]
                for k in ("width", "max_speed", "has_door", "type"):
                    if k in params:
                        e[k] = params[k]
                return True
            return False
        return False

    def to_drawlist(self, dl: DrawList | None = None,
                    color: int = 0x0000C0) -> DrawList:
        dl = dl or DrawList()
        for e in self.edges:
            a = self.vertices[e["v1"]]
            b = self.vertices[e["v2"]]
            dl.draw_line((a["x"], a["y"]), (b["x"], b["y"]), color)
        for h, v in self.vertices.items():
            dl.draw_circle((v["x"], v["y"]), color)
            if self.semantic and (v["type"] or v["name"]):
                dl.draw_text((v["x"], v["y"]),
                             f"{v['type']}:{v['name']}" if v["name"]
                             else v["type"], 0.5, color)
        return dl


def handle_graph_edit(graph: GraphMap, msg: dict) -> bool:
    """Apply one graph_edit message; returns True if the graph changed."""
    op = msg.get("op")
    if op == "interact":
        return graph.interact(msg["down"], msg["up"],
                              int(msg.get("modifiers", 0)),
                              msg.get("params"))
    if op == "save":
        graph.save()
        return False
    if op == "load":
        graph.vertices.clear()
        graph.edges.clear()
        graph.load()
        return True
    return False
