"""Live scan view + background vector maps for the viewer bus.

Port of hitl_slam_tpu/gui/live.py (host numpy only, a copy).

Reference surfaces (gui/vector_display_thread.cpp):
  - ``laserCallback`` / ``kinectScanCallback`` (:650-668): latch the latest
    scan message and recompile the display.
  - liveView rendering (:926-958 kinect, :960-974 laser): scan points drawn
    in WORLD frame at the *current* robot pose (laser mounted 0.145 m
    forward, :963-964), LidarPointColor 0xF0761F / KinectScanColor 0xFF0505
    (:718-719), shown while fresher than MessageTimeout = 1 s (:717) unless
    persistentDisplay.
  - ``drawMap`` (:560-570): background vector-map lines in
    Color(0.32, 0.49, 0.91) = 0x527DE8.
  - ``ChangeMap`` (:141-176): choose a named map from mapsFolder/atlas.txt
    ("<index> <name>" rows).
  - ``autoUpdateMap`` toggle (Key_U, :246-249): when on, the background map
    follows the map name announced by localization messages.

Deviations: scans arrive as in-process callbacks or websocket messages
instead of ROS topics; a named map resolves to ``<folder>/<name>.vectors.txt``
in the VectorMapFile CSV format (LTVM curator output) instead of the CoBot
map tree.
"""

from __future__ import annotations

import os

import numpy as np

from .drawlist import DrawList
from .map_edit import VectorMapFile

LIDAR_POINT_COLOR = 0xF0761F    # LidarPointColor (alpha stripped)
KINECT_SCAN_COLOR = 0xFF0505    # KinectScanColor
MAP_LINE_COLOR = 0x527DE8       # drawMap Color(0.32, 0.49, 0.91)
LASER_OFFSET = 0.145            # laser mount, vector_display_thread.cpp:963
MESSAGE_TIMEOUT = 1.0           # seconds, vector_display_thread.cpp:717


def load_atlas(maps_folder: str) -> list[str]:
    """Map names from ``<maps_folder>/atlas.txt`` ("<index> <name>" rows,
    ChangeMap's format, vector_display_thread.cpp:144-155)."""
    names = []
    try:
        with open(os.path.join(maps_folder, "atlas.txt")) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    names.append(parts[1])
    except OSError:
        pass
    return names


class _Scan:
    __slots__ = ("ranges", "angle_min", "angle_inc", "range_min",
                 "range_max", "stamp")

    def __init__(self, ranges, angle_min, angle_inc, range_min, range_max,
                 stamp):
        self.ranges = np.asarray(ranges, np.float32)
        self.angle_min = float(angle_min)
        self.angle_inc = float(angle_inc)
        self.range_min = float(range_min)
        self.range_max = float(range_max)
        self.stamp = float(stamp)

    def world_points(self, pose, offset: float) -> np.ndarray:
        """Valid returns in world frame at `pose` — the liveView transform
        (vector_display_thread.cpp:960-974): beam angle = robotAngle +
        angle_min + i*inc, origin = robot + R(angle) * (offset, 0)."""
        r = self.ranges
        ok = (r > self.range_min) & (r < self.range_max)
        idx = np.nonzero(ok)[0]
        a = pose[2] + self.angle_min + idx * self.angle_inc
        c, s = np.cos(pose[2]), np.sin(pose[2])
        ox = pose[0] + c * offset
        oy = pose[1] + s * offset
        return np.stack([ox + r[idx] * np.cos(a),
                         oy + r[idx] * np.sin(a)], axis=1)


class LiveView:
    """Latched live scans + switchable background map, compiled into
    DrawList channels. Pure host-side state — safe to drive from the GUI
    server's callback thread."""

    def __init__(self, maps_folder: str | None = None,
                 map_name: str | None = None,
                 persistent_display: bool = False):
        self.maps_folder = maps_folder
        self.map_name: str | None = None
        self.map_segments: np.ndarray | None = None   # [S, 4]
        self.auto_update_map = True
        self.persistent_display = persistent_display
        self.live_view = True
        self._laser: _Scan | None = None
        self._kinect: _Scan | None = None
        if map_name:
            self.change_map(map_name)

    # -- scan callbacks (laserCallback/kinectScanCallback analogs) ----------

    def on_laser(self, ranges, angle_min, angle_inc, range_min, range_max,
                 now: float):
        self._laser = _Scan(ranges, angle_min, angle_inc, range_min,
                            range_max, now)

    def on_kinect(self, ranges, angle_min, angle_inc, range_min, range_max,
                  now: float):
        self._kinect = _Scan(ranges, angle_min, angle_inc, range_min,
                             range_max, now)

    def clear(self):
        """clearDisplayMessages analog (:704-713)."""
        self._laser = None
        self._kinect = None

    # -- background map (ChangeMap/drawMap analogs) --------------------------

    def atlas(self) -> list[str]:
        return load_atlas(self.maps_folder) if self.maps_folder else []

    def change_map(self, name: str) -> bool:
        """Load `name` as the background map: a direct VectorMapFile path,
        or ``<maps_folder>/<name>.vectors.txt``."""
        path = name
        if not os.path.exists(path) and self.maps_folder:
            path = os.path.join(self.maps_folder, f"{name}.vectors.txt")
        vm = VectorMapFile(path)
        if not vm.segments:
            return False
        self.map_segments = np.asarray([s[:4] for s in vm.segments],
                                       np.float32)
        self.map_name = os.path.basename(path).replace(".vectors.txt", "")
        return True

    def maybe_auto_switch(self, announced: str | None) -> bool:
        """autoUpdateMap semantics: follow the map name announced by a
        localization message when it differs from the displayed one."""
        if (self.auto_update_map and announced
                and announced != self.map_name):
            return self.change_map(announced)
        return False

    # -- frame compilation ----------------------------------------------------

    def compile(self, dl: DrawList, robot_pose, now: float) -> None:
        """Append background-map lines + fresh live scans to `dl` at the
        current robot pose (compileDisplay's liveView block)."""
        if self.map_segments is not None:
            dl.draw_lines(self.map_segments[:, 0:2], self.map_segments[:, 2:4],
                          MAP_LINE_COLOR)
        if not self.live_view:
            return
        pose = np.asarray(robot_pose, np.float64)
        for scan, color, offset in ((self._laser, LIDAR_POINT_COLOR,
                                     LASER_OFFSET),
                                    (self._kinect, KINECT_SCAN_COLOR, 0.0)):
            if scan is None:
                continue
            if now - scan.stamp >= MESSAGE_TIMEOUT and \
                    not self.persistent_display:
                continue
            pts = scan.world_points(pose, offset)
            if len(pts):
                dl.draw_points(pts, color)
