"""Draw-list message schema — the GUI wire format.

Reimplements the reference's `LidarDisplayMsg` (vector_slam_msgs/msg/
LidarDisplayMsg.msg: parallel arrays lines_p1x/p1y/p2x/p2y/col, points_x/y/
col, circles_*, text_*, plus robot pose and window hints) and the
`gui_publisher_helper.h` append API (DrawPoint/DrawLine/DrawCircle/DrawText/
ClearDrawingMessage) as a plain dataclass with numpy-backed channels and
JSON serialization for a websocket bridge. Host numpy and json only: a copy
of hitl_slam_tpu/gui/drawlist.py, with the same wire format.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

# palette constants used by the reference's DisplayPoses
# (HitLSLAM_main.cpp:160-183)
TRAJECTORY_COLOR = 0x6B6B6B
POSE_COLOR = 0xF0761F
STF_POINT_COLOR = 0xFFFF5500
CORRESPONDENCE_COLOR = 0x7F994CD9
POINT_COLOR = 0xDE2352


@dataclass
class DrawList:
    """Accumulating draw-list; numeric channels become numpy on serialize."""

    lines_p1: list = field(default_factory=list)    # [N][2]
    lines_p2: list = field(default_factory=list)
    lines_col: list = field(default_factory=list)
    points: list = field(default_factory=list)      # [N][2]
    points_col: list = field(default_factory=list)
    circles: list = field(default_factory=list)     # [N][2]
    circles_col: list = field(default_factory=list)
    text: list = field(default_factory=list)        # [N] (x, y, size, str)
    text_col: list = field(default_factory=list)
    robot_pose: tuple = (0.0, 0.0, 0.0)
    window_size: float = 1.0
    # batch-localization progress in [0, 1] — the EnML live view renders a
    # progress indicator while the sweep runs (CorrespondenceCallback cadence)
    progress: float = 1.0

    def clear(self):
        self.__init__()

    def draw_line(self, p1, p2, color: int = 0x000000):
        self.lines_p1.append((float(p1[0]), float(p1[1])))
        self.lines_p2.append((float(p2[0]), float(p2[1])))
        self.lines_col.append(int(color))

    def draw_point(self, p, color: int = 0x000000):
        self.points.append((float(p[0]), float(p[1])))
        self.points_col.append(int(color))

    def draw_points(self, pts: np.ndarray, color: int = 0x000000):
        pts = np.asarray(pts, np.float32).reshape(-1, 2)
        self.points.extend(map(tuple, pts.tolist()))
        self.points_col.extend([int(color)] * len(pts))

    def draw_lines(self, p1s: np.ndarray, p2s: np.ndarray, color: int = 0):
        p1s = np.asarray(p1s, np.float32).reshape(-1, 2)
        p2s = np.asarray(p2s, np.float32).reshape(-1, 2)
        self.lines_p1.extend(map(tuple, p1s.tolist()))
        self.lines_p2.extend(map(tuple, p2s.tolist()))
        self.lines_col.extend([int(color)] * len(p1s))

    def draw_circle(self, center, color: int = 0x000000):
        self.circles.append((float(center[0]), float(center[1])))
        self.circles_col.append(int(color))

    def draw_text(self, p, text: str, size: float = 1.0, color: int = 0):
        self.text.append((float(p[0]), float(p[1]), float(size), str(text)))
        self.text_col.append(int(color))

    def to_json(self) -> str:
        return json.dumps({
            "type": "drawlist",
            "lines_p1": self.lines_p1,
            "lines_p2": self.lines_p2,
            "lines_col": self.lines_col,
            "points": self.points,
            "points_col": self.points_col,
            "circles": self.circles,
            "circles_col": self.circles_col,
            "text": self.text,
            "text_col": self.text_col,
            "robot_pose": list(self.robot_pose),
            "window_size": self.window_size,
            "progress": self.progress,
        })

    @staticmethod
    def from_json(s: str) -> "DrawList":
        d = json.loads(s)
        dl = DrawList()
        dl.lines_p1 = [tuple(x) for x in d.get("lines_p1", [])]
        dl.lines_p2 = [tuple(x) for x in d.get("lines_p2", [])]
        dl.lines_col = d.get("lines_col", [])
        dl.points = [tuple(x) for x in d.get("points", [])]
        dl.points_col = d.get("points_col", [])
        dl.circles = [tuple(x) for x in d.get("circles", [])]
        dl.circles_col = d.get("circles_col", [])
        dl.text = [tuple(x) for x in d.get("text", [])]
        dl.text_col = d.get("text_col", [])
        dl.robot_pose = tuple(d.get("robot_pose", (0, 0, 0)))
        dl.window_size = d.get("window_size", 1.0)
        dl.progress = d.get("progress", 1.0)
        return dl


@dataclass
class MouseClickEvent:
    """GuiMouseClickEvent: mouse_down/up world coords + modifier bitmask
    Alt=0x01 Ctrl=0x02 Shift=0x04 (vector_slam_msgs/msg/GuiMouseClickEvent)."""

    mouse_down: tuple
    mouse_up: tuple
    modifiers: int

    def to_json(self) -> str:
        return json.dumps({"type": "mouse_click",
                           "mouse_down": list(self.mouse_down),
                           "mouse_up": list(self.mouse_up),
                           "modifiers": self.modifiers})

    @staticmethod
    def from_dict(d) -> "MouseClickEvent":
        return MouseClickEvent(tuple(d["mouse_down"]), tuple(d["mouse_up"]),
                               int(d["modifiers"]))


@dataclass
class KeyboardEvent:
    """GuiKeyboardEvent: keycode + modifiers."""

    keycode: int
    modifiers: int = 0

    def to_json(self) -> str:
        return json.dumps({"type": "keyboard", "keycode": self.keycode,
                           "modifiers": self.modifiers})

    @staticmethod
    def from_dict(d) -> "KeyboardEvent":
        return KeyboardEvent(int(d["keycode"]), int(d.get("modifiers", 0)))


def parse_event(s: str):
    d = json.loads(s)
    t = d.get("type")
    if t == "mouse_click":
        return MouseClickEvent.from_dict(d)
    if t == "keyboard":
        return KeyboardEvent.from_dict(d)
    if t == "drawlist":
        return DrawList.from_json(s)
    return d
