"""Online EnML: producer/consumer localization front end.

Port of hitl_slam_tpu/models/enml/online.py. The original's online mode
(SensorUpdate/OdometryUpdate with a mutex-and-semaphore update thread):
sensor callbacks enqueue observations; a background worker folds them into
the episode and re-localizes the active window.

Here the protocol is a thread-safe queue and a daemon worker; each new node
runs ONE window GN (localizer.single_window_localize) over the trailing W
nodes on the localizer's device. The worker puts its tensors on that device
explicitly, never on the thread's current CUDA device. Host threading only
feeds the device: the compute path never runs concurrently with itself.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .driver import EpisodeOptions, generate_normals_np
from .localizer import EnmlOptions


@dataclass
class _SensorMsg:
    ranges: np.ndarray
    angles: np.ndarray


@dataclass
class _OdometryMsg:
    rel: np.ndarray   # (dx, dy, dtheta) since last message


@dataclass
class _SetLocationMsg:
    pose: np.ndarray  # absolute (x, y, theta) map-frame reset


class OnlineLocalizer:
    """Feed odometry_update()/sensor_update() from callbacks; read pose().
    `flush()` is the completion barrier: it returns once every message
    enqueued before it has been processed, window solve included."""

    def __init__(self, episode_options: EpisodeOptions = EpisodeOptions(),
                 enml_options: EnmlOptions = EnmlOptions(),
                 max_nodes: int = 4096, device="cuda"):
        self.eo = episode_options
        self.opts = enml_options
        self.max_nodes = max_nodes
        self.device = torch.device(device)
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._acc = np.zeros(3)
        self._pose = np.zeros(3)
        # episode barrier: a set_location teleport starts a NEW episode;
        # window solves never span the barrier, else the GN would drag the
        # seeded pose back onto the pre-teleport scan-consistent chain
        self._episode_start = 0
        self.poses: list[np.ndarray] = []
        self.clouds: list[np.ndarray] = []
        self.normals: list[np.ndarray] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # optional observer, called from the WORKER thread after a node is
        # added or a set_location is applied: the live-view publish hook
        # (repaint on localization updates, not on the sensor cadence)
        self.on_update = None

    # -- producer side (sensor callbacks) ------------------------------------

    def odometry_update(self, dx: float, dy: float, dtheta: float):
        self._queue.put(_OdometryMsg(np.array([dx, dy, dtheta])))

    def sensor_update(self, ranges: np.ndarray, angles: np.ndarray):
        self._queue.put(_SensorMsg(np.asarray(ranges), np.asarray(angles)))

    def set_location(self, x: float, y: float, theta: float):
        """Re-localization event: resets the integrated pose to the given
        map-frame pose and clears the accumulated odometry, in stream
        order."""
        self._queue.put(_SetLocationMsg(np.array([x, y, theta])))

    def pose(self) -> np.ndarray:
        """Latest pose estimate (thread safe)."""
        with self._lock:
            return self._pose.copy()

    def node_count(self) -> int:
        with self._lock:
            return len(self.poses)

    def trajectory(self) -> np.ndarray:
        """Copy of the episode-node poses [N, 3] under the lock: cheap (no
        clouds), for live-view publishing."""
        with self._lock:
            if not self.poses:
                return np.zeros((0, 3))
            return np.stack(self.poses)

    def snapshot(self):
        """Consistent copy of (poses, clouds, normals) under the lock: the
        only safe way to read the trajectory while the worker runs."""
        with self._lock:
            return ([p.copy() for p in self.poses], list(self.clouds),
                    list(self.normals))

    # -- consumer side --------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._queue.put(None)
        if self._thread:
            self._thread.join(timeout=10)

    def drain(self, timeout: float = 5.0):
        """Block until the queue is empty. The worker pops a message BEFORE
        processing it, so an empty queue does not mean the last window
        solve finished: use flush() for a real completion barrier."""
        import time

        t0 = time.time()
        while not self._queue.empty() and time.time() - t0 < timeout:
            time.sleep(0.01)

    def flush(self, timeout: float | None = None) -> bool:
        """Completion barrier: returns True once the worker has PROCESSED
        every message enqueued before this call (including the device solve
        of the final window), False on timeout."""
        ev = threading.Event()
        self._queue.put(ev)
        return ev.wait(timeout)

    def _run(self):
        while not self._stop.is_set():
            msg = self._queue.get()
            if msg is None:
                break
            if isinstance(msg, _OdometryMsg):
                self._integrate_odometry(msg.rel)
            elif isinstance(msg, _SensorMsg):
                if self._maybe_add_node(msg):
                    self._notify()
            elif isinstance(msg, _SetLocationMsg):
                with self._lock:
                    self._pose = msg.pose.astype(np.float64).copy()
                    self._episode_start = len(self.poses)
                self._acc[:] = 0.0
                self._notify()
            elif isinstance(msg, threading.Event):
                msg.set()   # flush barrier

    def _notify(self):
        """Fire the on_update observer; a failing observer must never kill
        the localization worker."""
        cb = self.on_update
        if cb is None:
            return
        try:
            cb()
        except Exception:   # pragma: no cover - observer bug isolation
            pass

    def _integrate_odometry(self, rel):
        c, s = np.cos(self._acc[2]), np.sin(self._acc[2])
        self._acc[:2] += np.array([[c, -s], [s, c]]) @ rel[:2]
        self._acc[2] += rel[2]

    def _maybe_add_node(self, msg: _SensorMsg) -> bool:
        """Returns True when a node was added (and the window re-solved)."""
        eo = self.eo
        if self.poses and (
            np.linalg.norm(self._acc[:2]) < eo.minimum_node_translation
            and abs(self._acc[2]) < eo.minimum_node_rotation
        ):
            return False
        r, a = msg.ranges, msg.angles
        ok = np.isfinite(r) & (r > eo.min_point_cloud_range) & (
            r < eo.max_point_cloud_range)
        pts = np.stack([r[ok] * np.cos(a[ok]), r[ok] * np.sin(a[ok])], -1)
        pts, nrm = generate_normals_np(
            pts.astype(np.float32), eo.max_normal_point_distance)
        if len(pts) == 0:
            return False
        with self._lock:
            c, s = np.cos(self._pose[2]), np.sin(self._pose[2])
            self._pose = np.array([
                *(self._pose[:2] + np.array([[c, -s], [s, c]]) @ self._acc[:2]),
                self._pose[2] + self._acc[2],
            ])
            self.poses.append(self._pose.copy())
            self.clouds.append(pts)
            self.normals.append(nrm)
            # bounded history: a long-running session keeps only the newest
            # max_nodes (the trailing-window localize never looks further)
            if len(self.poses) > self.max_nodes:
                drop = len(self.poses) - self.max_nodes
                del self.poses[:drop]
                del self.clouds[:drop]
                del self.normals[:drop]
                self._episode_start = max(0, self._episode_start - drop)
        self._acc[:] = 0.0
        self._relocalize_window()
        return True

    def _relocalize_window(self):
        """Re-solve the trailing episode window on the device."""
        W = self.opts.max_history
        with self._lock:
            n = len(self.poses)
            lo = n - W
            if lo < self._episode_start:
                return   # a fixed window size; after an episode barrier,
                         # dead-reckon from the seed until a full window of
                         # post-teleport nodes accumulates
            poses = np.stack(self.poses[lo:])
            clouds = self.clouds[lo:]
            normals = self.normals[lo:]

        from ...core.state import make_map_state
        from .localizer import single_window_localize

        st = make_map_state(poses, np.zeros((len(poses), 3, 3), np.float32),
                            clouds, normals, max_points=384,
                            device=self.device)
        # ONE window GN over the trailing W nodes (on a card a replay of
        # the [W, 384] window's program)
        new_poses = single_window_localize(
            st.points, st.normals, st.point_mask, st.poses,
            self.opts).cpu().numpy()
        with self._lock:
            for k in range(len(new_poses)):
                self.poses[lo + k] = new_poses[k]
            self._pose = new_poses[-1].copy()
