"""The port's GUI bridge (hitl_slam_torch/gui/{server,graph_edit,live}.py and
the viewer assets) and the interactive modes of both CLIs over it: the GUI
cases of tests/test_cli_and_aux.py, tests/test_live_view.py and
tests/test_enml_session.py::test_enml_gui_protocol, on the port and on the
CPU. Every wait is on an event or a received frame, never on a sleep: a
CLI's bridge is awaited through a GuiServer.start that signals once it
listens, and a client's event through the callback that handles it. Skips
without `websockets` (the bridge's one extra dependency); the host-only
cases run regardless."""

import asyncio
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from torch_port_helpers import synth_wall_correction

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def listening(monkeypatch):
    """An event set once the port's next GuiServer listens."""
    from hitl_slam_torch.gui import server

    ev = threading.Event()
    start = server.GuiServer.start

    def start_and_signal(self):
        start(self)
        ev.set()

    monkeypatch.setattr(server.GuiServer, "start", start_and_signal)
    return ev


def _run_cli(main, argv):
    """main(argv) on a daemon thread; returns (thread, {"code": rc})."""
    rc = {}
    th = threading.Thread(target=lambda: rc.update(code=main(argv)),
                          daemon=True)
    th.start()
    return th, rc


async def _recv(ws, frames=None):
    f = json.loads(await asyncio.wait_for(ws.recv(), timeout=TIMEOUT))
    if frames is not None:
        frames.append(f)
    return f


@pytest.mark.parametrize("name", ["viewer.html", "viewer_core.js"])
def test_viewer_assets_byte_equal(name):
    """The port serves the reference's viewer unchanged."""
    with open(os.path.join(REPO, "hitl_slam_tpu", "gui", name), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "hitl_slam_torch", "gui", name), "rb") as f:
        assert f.read() == want


def test_gui_server_roundtrip():
    """Draw-list broadcast (latched for a late joiner) and mouse, keyboard
    and capture dispatch."""
    websockets = pytest.importorskip("websockets")
    from hitl_slam_torch.gui.drawlist import (DrawList, KeyboardEvent,
                                              MouseClickEvent)
    from hitl_slam_torch.gui.server import GuiServer

    port = _free_port()
    server = GuiServer(port=port)
    clicks, keys, captures = [], [], []
    done = threading.Event()
    server.on_mouse_click = clicks.append
    server.on_keyboard = keys.append

    def capture(name):
        captures.append(name)
        done.set()

    server.on_capture = capture
    server.start()
    got = {}
    try:
        async def client():
            async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                await ws.send(MouseClickEvent((1, 2), (3, 4), 4).to_json())
                await ws.send(KeyboardEvent(0x50).to_json())
                await ws.send(json.dumps({"type": "capture",
                                          "filename": "shot.png"}))
                dl = DrawList()
                dl.draw_point((9.0, 9.0), 0xFF0000)
                server.publish(dl)
                got["frame"] = await _recv(ws)
                assert await asyncio.to_thread(done.wait, TIMEOUT)

        asyncio.run(client())
    finally:
        server.stop()
    assert clicks and clicks[0].modifiers == 4
    assert list(clicks[0].mouse_down) == [1, 2]
    assert keys and keys[0].keycode == 0x50
    assert captures == ["shot.png"]
    assert got["frame"]["type"] == "drawlist"
    assert got["frame"]["points"] == [[9.0, 9.0]]


class _Viewer:
    """A websocket stand-in for GuiServer._handler: records what it is sent
    and stays connected until `leave` is set."""

    def __init__(self):
        self.sent = []
        self.leave = asyncio.Event()

    async def send(self, msg):
        self.sent.append(msg)

    def __aiter__(self):
        return self

    async def __anext__(self):
        await self.leave.wait()
        raise StopAsyncIteration


@pytest.mark.parametrize("package", ["hitl_slam_torch", "hitl_slam_tpu"])
def test_gui_server_latched_frame_sent_once(package):
    """A viewer that joins while a publish is in flight gets the frame
    once. The viewer's handler is scheduled first and the publish second;
    the JAX package's server, which sets the latched frame from the calling
    thread, sends it twice (latched, then broadcast): the fault the port
    repairs."""
    import importlib

    from hitl_slam_torch.gui.drawlist import DrawList

    GuiServer = importlib.import_module(f"{package}.gui.server").GuiServer
    server = GuiServer()
    server.loop = asyncio.new_event_loop()
    dl = DrawList()
    dl.draw_point((1.0, 2.0), 0xFF0000)

    async def join_during_publish():
        viewer = _Viewer()
        handler = asyncio.ensure_future(server._handler(viewer))
        server.publish(dl)
        for _ in range(10):
            await asyncio.sleep(0)
        viewer.leave.set()
        await handler
        return viewer.sent

    try:
        sent = server.loop.run_until_complete(join_during_publish())
    finally:
        server.loop.close()
    assert len(sent) == (1 if package == "hitl_slam_torch" else 2)
    assert json.loads(sent[0])["points"] == [[1.0, 2.0]]


def test_gui_server_survives_malformed_events():
    """A malformed message is dropped and the connection keeps dispatching."""
    websockets = pytest.importorskip("websockets")
    from hitl_slam_torch.gui.drawlist import KeyboardEvent
    from hitl_slam_torch.gui.server import GuiServer

    port = _free_port()
    server = GuiServer(port=port)
    keys = []
    seen = threading.Event()

    def on_key(ev):
        keys.append(ev)
        seen.set()

    server.on_keyboard = on_key
    server.start()
    try:
        async def client():
            async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                await ws.send(json.dumps({"type": "mouse_click", "x": 1.0,
                                          "y": 2.0, "modifiers": 4}))
                await ws.send("{not json")
                await ws.send(json.dumps({"type": "keyboard"}))
                await ws.send(KeyboardEvent(0x50).to_json())
                assert await asyncio.to_thread(seen.wait, TIMEOUT)

        asyncio.run(client())
    finally:
        server.stop()
    assert [k.keycode for k in keys] == [0x50]


def test_cli_test_mode_streams_frames(listening):
    """cli --test-mode streams synthetic draw-lists and ends on shutdown."""
    websockets = pytest.importorskip("websockets")
    from hitl_slam_torch import cli

    port = _free_port()
    th, rc = _run_cli(cli.main, ["--test-mode", "--gui-port", str(port)])
    assert listening.wait(TIMEOUT)
    frames = []

    async def client():
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            for _ in range(3):
                await _recv(ws, frames)
            await ws.send(json.dumps({"type": "shutdown"}))

    asyncio.run(client())
    th.join(timeout=TIMEOUT)
    assert not th.is_alive() and rc == {"code": 0}
    assert len(frames) == 3
    assert all(f["type"] == "drawlist" and len(f["lines_p1"]) == 64
               for f in frames)


@pytest.fixture(scope="module")
def session_files(tmp_path_factory):
    """A 96-pose drifted figure-8 .stfs.covars and a one-correction log
    (tests/test_cli_and_aux.py's fixture, by the port's own writers)."""
    from hitl_slam_torch.core.state import CorrectionType, SingleInput
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.io.figure8 import (generate_figure8,
                                            synthesize_correction)

    d = tmp_path_factory.mktemp("session")
    m = generate_figure8(num_poses=96, num_rays=120, seed=5,
                         drift_theta_bias=8e-4)
    graph = str(d / "fig8.stfs.covars")
    stfs.save_stfs_covars(graph, "Figure8Synthetic", 42.0, m.poses,
                          m.covariances, m.point_clouds, m.normal_clouds)
    sel = synthesize_correction(m, range(60, 96), range(0, 30), (1, 0.0),
                                (1, 0.0))
    log = str(d / "session.log")
    logs.save_log(log, [SingleInput(CorrectionType.COLINEAR, 0, sel)])
    return graph, log


def test_gui_headless_session_protocol(session_files, tmp_path, listening):
    """cli --gui driven over the websocket: 'p', two drags, 'p' runs the
    correction (the poses move, and equal replay_log's), 'u' undoes it,
    capture, graph edits, 'o' refines, 'v' saves, shutdown ends the loop."""
    websockets = pytest.importorskip("websockets")
    from hitl_slam_torch import cli
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.models.hitl.engine import HitLSLAM

    graph, log = session_files
    entry = logs.load_log(log)[0]
    sel = entry.points
    data = stfs.load_stfs_covars(graph)
    want = HitLSLAM(device="cpu")
    want.init(data.poses, data.covariances, data.point_clouds,
              data.normal_clouds)
    assert want.replay_log(entry).accepted
    corrected = want.get_poses()

    out = str(tmp_path / "gui_saved.txt")
    cap = str(tmp_path / "cap.png")
    navmap = str(tmp_path / "nav.graph.json")
    port = _free_port()
    th, rc = _run_cli(cli.main, ["-P", graph, "--gui", "--gui-port",
                                 str(port), "-V", out, "--nav-map", navmap,
                                 "--device", "cpu"])
    assert listening.wait(TIMEOUT)

    async def drive():
        async with websockets.connect(f"ws://127.0.0.1:{port}",
                                      max_size=2 ** 24) as ws:
            async def send(obj):
                await ws.send(json.dumps(obj))

            base = await _recv(ws)                     # the latched frame
            assert base["type"] == "drawlist"
            n_lines0 = len(base["lines_p1"])
            assert n_lines0 > 0 and len(base["points"]) > 0
            await send({"type": "keyboard", "keycode": 0x50})
            await send({"type": "mouse_click", "modifiers": 4,
                        "mouse_down": list(map(float, sel[0])),
                        "mouse_up": list(map(float, sel[1]))})
            assert len((await _recv(ws))["circles"]) >= 2
            await send({"type": "mouse_click", "modifiers": 4,
                        "mouse_down": list(map(float, sel[2])),
                        "mouse_up": list(map(float, sel[3]))})
            assert len((await _recv(ws))["circles"]) >= 4
            await send({"type": "keyboard", "keycode": 0x50})
            f3 = await _recv(ws)
            assert len(f3["circles"]) == 0             # selection cleared
            moved = (np.asarray(f3["points"][:96])
                     - np.asarray(base["points"][:96]))
            assert np.abs(moved).max() > 1e-3          # the poses moved
            # 'v' now saves the corrected poses
            await send({"type": "keyboard", "keycode": 0x56})
            await send({"type": "keyboard", "keycode": 0x55})      # 'u'
            f4 = await _recv(ws)
            np.testing.assert_allclose(np.asarray(f4["points"][:96]),
                                       np.asarray(base["points"][:96]),
                                       atol=1e-5)
            await send({"type": "capture", "filename": cap})
            await send({"type": "graph_edit", "op": "interact",
                        "down": [0, 0], "up": [0, 0], "modifiers": 4})
            assert len((await _recv(ws))["circles"]) == 1
            await send({"type": "graph_edit", "op": "interact",
                        "down": [3, 0], "up": [3, 0], "modifiers": 4})
            await _recv(ws)
            await send({"type": "graph_edit", "op": "interact",
                        "down": [0, 0], "up": [3, 0], "modifiers": 4})
            f6 = await _recv(ws)
            assert len(f6["circles"]) == 2
            assert len(f6["lines_p1"]) == n_lines0 + 1      # the new edge
            await send({"type": "graph_edit", "op": "save"})
            await send({"type": "keyboard", "keycode": 0x4F})      # 'o'
            f7 = await _recv(ws)
            assert np.isfinite(np.asarray(f7["points"][:96])).all()
            await send({"type": "shutdown"})

    asyncio.run(drive())
    th.join(timeout=TIMEOUT)
    assert not th.is_alive() and rc == {"code": 0}
    # the 'v' save came before the undo: replay_log's poses, to the file's
    # 6 decimals
    np.testing.assert_allclose(np.loadtxt(out), corrected, rtol=0,
                               atol=1e-6)
    with open(cap, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    saved = json.load(open(navmap))
    assert len(saved["vertices"]) == 2 and len(saved["edges"]) == 1


def _graph_ops():
    """tests/test_cli_and_aux.py::test_graph_edit_roundtrip's edits."""
    return [
        {"op": "interact", "down": [0, 0], "up": [0, 0], "modifiers": 0x04},
        {"op": "interact", "down": [5, 0], "up": [5, 0], "modifiers": 0x04},
        {"op": "interact", "down": [5, 5], "up": [5, 5], "modifiers": 0x04},
        {"op": "interact", "down": [0.05, 0], "up": [0.05, 0],
         "modifiers": 0x04},
        {"op": "interact", "down": [0, 0], "up": [5, 0], "modifiers": 0x04,
         "params": {"width": 2.0, "max_speed": 0.5, "has_door": True}},
        {"op": "interact", "down": [5, 0], "up": [5, 5], "modifiers": 0x04},
        {"op": "interact", "down": [0, 0], "up": [5, 0], "modifiers": 0x04},
        {"op": "interact", "down": [5, 5], "up": [6, 6], "modifiers": 0x01},
        {"op": "interact", "down": [2.5, 0], "up": [2.5, 1],
         "modifiers": 0x01},
        {"op": "interact", "down": [2.5, 1], "up": [2.5, 1],
         "modifiers": 0x03, "params": {"max_speed": 3.0}},
        {"op": "save"},
    ]


def test_graph_edit_roundtrip(tmp_path):
    """The nav-graph protocol (Shift adds, Alt moves, Ctrl+Alt edits
    parameters, Ctrl deletes), save and reload; the same edits through the
    JAX package's module give the same answers and the same file."""
    from hitl_slam_torch.gui.graph_edit import GraphMap, handle_graph_edit
    from hitl_slam_tpu.gui import graph_edit as ref

    path, ref_path = str(tmp_path / "nav.json"), str(tmp_path / "ref.json")
    g, rg = GraphMap(path), ref.GraphMap(ref_path)
    got = [handle_graph_edit(g, op) for op in _graph_ops()]
    want = [ref.handle_graph_edit(rg, op) for op in _graph_ops()]
    assert got == want == [True] * 3 + [False] + [True] * 2 + [False] \
        + [True] * 3 + [False]
    assert g.edges[0]["width"] == 2.0 and g.edges[0]["has_door"] is True
    assert g.edges[0]["max_speed"] == 3.0
    assert {(v["x"], v["y"]) for v in g.vertices.values()} == {
        (0.0, 1.0), (5.0, 1.0), (6.0, 6.0)}
    with open(path) as f, open(ref_path) as rf:
        assert f.read() == rf.read()
    g2 = GraphMap(path)
    assert g2.vertices == g.vertices and g2.edges == g.edges
    assert handle_graph_edit(g2, {"op": "interact", "down": [5, 1],
                                  "up": [5, 1], "modifiers": 0x02})
    assert len(g2.vertices) == 2 and len(g2.edges) == 0
    h = g2.add_vertex(9, 9)
    assert h not in (set(g.vertices) - set(g2.vertices))
    dl = g.to_drawlist()
    assert len(dl.lines_p1) == 2 and len(dl.circles) == 3


def test_semantic_graph_edit(tmp_path):
    """Semantic mode: typed and labelled vertices and edges, the
    vocabulary enforced, labels drawn as text."""
    from hitl_slam_torch.gui.graph_edit import GraphMap, handle_graph_edit

    g = GraphMap(str(tmp_path / "sem.graph.json"), semantic=True)
    assert handle_graph_edit(
        g, {"op": "interact", "down": [0, 0], "up": [1, 0],
            "modifiers": 0x04, "params": {"type": "Office",
                                          "name": "Rm 101"}})
    assert handle_graph_edit(
        g, {"op": "interact", "down": [5, 0], "up": [5, 0],
            "modifiers": 0x04, "params": {"type": "Kitchen"}})
    assert not handle_graph_edit(
        g, {"op": "interact", "down": [9, 9], "up": [9, 9],
            "modifiers": 0x04, "params": {"type": "Spaceport"}})
    assert len(g.vertices) == 2
    v0 = next(iter(g.vertices.values()))
    assert v0["type"] == "Office" and v0["name"] == "Rm 101"
    assert abs(v0["angle"]) < 1e-9
    assert handle_graph_edit(
        g, {"op": "interact", "down": [0, 0], "up": [5, 0],
            "modifiers": 0x04, "params": {"type": "Hallway"}})
    assert g.edges[0]["type"] == "Hallway"
    assert len(g.to_drawlist().text) == 2


def _write_maps(folder):
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "a.vectors.txt"), "w") as f:
        f.write("0.0,0.0,4.0,0.0\n")
    with open(os.path.join(folder, "b.vectors.txt"), "w") as f:
        f.write("0.0,1.0,0.0,5.0\n0.0,5.0,4.0,5.0\n")
    with open(os.path.join(folder, "atlas.txt"), "w") as f:
        f.write("0 a\n1 b\n")


def test_live_view_unit(tmp_path):
    """LiveView: the atlas, map changes, the auto-update toggle, scan
    latching and time-out, the world transform with the laser offset, the
    kinect channel."""
    from hitl_slam_torch.gui.drawlist import DrawList
    from hitl_slam_torch.gui.live import (KINECT_SCAN_COLOR,
                                          LIDAR_POINT_COLOR, MAP_LINE_COLOR,
                                          LiveView, load_atlas)

    folder = str(tmp_path / "maps")
    _write_maps(folder)
    assert load_atlas(folder) == ["a", "b"]
    lv = LiveView(maps_folder=folder, map_name="a")
    assert lv.map_name == "a" and len(lv.map_segments) == 1
    assert not lv.change_map("nope")
    assert lv.maybe_auto_switch("b") and lv.map_name == "b"
    lv.auto_update_map = False
    assert not lv.maybe_auto_switch("a") and lv.map_name == "b"

    lv.on_laser([2.0], 0.0, 0.1, 0.02, 10.0, now=100.0)
    dl = DrawList()
    lv.compile(dl, (1.0, 0.0, 0.0), now=100.1)
    scan = [p for p, c in zip(dl.points, dl.points_col)
            if c == LIDAR_POINT_COLOR]
    assert len(scan) == 1
    np.testing.assert_allclose(scan[0], (3.145, 0.0), atol=1e-6)
    assert sum(c == MAP_LINE_COLOR for c in dl.lines_col) == 2
    dl2 = DrawList()
    lv.compile(dl2, (1.0, 0.0, 0.0), now=101.5)
    assert not any(c == LIDAR_POINT_COLOR for c in dl2.points_col)
    lv.persistent_display = True
    dl3 = DrawList()
    lv.compile(dl3, (1.0, 0.0, 0.0), now=101.5)
    assert any(c == LIDAR_POINT_COLOR for c in dl3.points_col)
    lv.on_kinect([1.0], 0.0, 0.1, 0.02, 10.0, now=102.0)
    dl4 = DrawList()
    lv.compile(dl4, (0.0, 0.0, 0.0), now=102.0)
    kin = [p for p, c in zip(dl4.points, dl4.points_col)
           if c == KINECT_SCAN_COLOR]
    np.testing.assert_allclose(kin[0], (1.0, 0.0), atol=1e-6)


def test_online_live_view_protocol(tmp_path, listening):
    """cli_enml --online --gui over the wire: live scan frames, a
    set_location seed (the pose jumps, the background map follows the
    announcement), a Set Position drag (a node lands near it), the
    auto-update toggle, change_map, and shutdown of the held bridge."""
    websockets = pytest.importorskip("websockets")
    from hitl_slam_torch import cli_enml
    from hitl_slam_torch.gui.drawlist import TRAJECTORY_COLOR
    from hitl_slam_torch.gui.live import LIDAR_POINT_COLOR, MAP_LINE_COLOR

    folder = str(tmp_path / "maps")
    _write_maps(folder)
    out = str(tmp_path / "live")
    port = _free_port()
    # 0.5 s a scan: the stream outlasts the scripted interactions, so the
    # seeds land mid-stream and nodes follow them
    th, rc = _run_cli(cli_enml.main, [
        "--synthetic", "--steps", "32", "--online", "--gui", "--gui-port",
        str(port), "--rate", "0.1", "-o", out, "--maps-folder", folder,
        "--background-map", "a", "--hold", "--device", "cpu"])
    assert listening.wait(TIMEOUT)

    def scan_pts(f):
        return [p for p, c in zip(f["points"], f["points_col"])
                if c == LIDAR_POINT_COLOR]

    def map_lines(f):
        return [(tuple(p1), tuple(p2)) for p1, p2, c in
                zip(f["lines_p1"], f["lines_p2"], f["lines_col"])
                if c == MAP_LINE_COLOR]

    def node_near(f, x, y, r):
        return any((p[0] - x) ** 2 + (p[1] - y) ** 2 < r ** 2
                   for p, c in zip(f["points"], f["points_col"])
                   if c == TRAJECTORY_COLOR)

    async def drive():
        async with websockets.connect(f"ws://127.0.0.1:{port}",
                                      max_size=2 ** 24) as ws:
            async def recv_until(pred, tries=400):
                for _ in range(tries):
                    f = await _recv(ws)
                    if f.get("type") == "drawlist" and pred(f):
                        return f
                raise AssertionError("condition never met in the stream")

            f = await recv_until(lambda f: len(scan_pts(f)) > 10)
            assert map_lines(f) == [((0.0, 0.0), (4.0, 0.0))]
            await ws.send(json.dumps({"type": "set_location",
                                      "pose": [5.0, 5.0, 0.5], "map": "b"}))
            await recv_until(lambda f: len(map_lines(f)) == 2
                             and abs(f["robot_pose"][0] - 5.0) < 2.0
                             and abs(f["robot_pose"][1] - 5.0) < 2.0)
            await ws.send(json.dumps({"type": "mouse_click", "modifiers": 4,
                                      "mouse_down": [-3.0, 2.0],
                                      "mouse_up": [-3.0, 3.0]}))
            await recv_until(lambda f: abs(f["robot_pose"][0] + 3.0) < 2.0
                             and abs(f["robot_pose"][1] - 2.0) < 2.0
                             and node_near(f, -3.0, 2.0, 2.5))
            await ws.send(json.dumps({"type": "keyboard", "keycode": 0x55}))
            await ws.send(json.dumps({"type": "set_location",
                                      "pose": [0.0, 0.0, 0.0], "map": "a"}))
            f = await recv_until(lambda f: True)
            assert len(map_lines(f)) == 2          # still map 'b'
            await ws.send(json.dumps({"type": "change_map", "name": "a"}))
            await recv_until(
                lambda f: map_lines(f) == [((0.0, 0.0), (4.0, 0.0))])
            # latched: the CLI ends once the stream is done
            await ws.send(json.dumps({"type": "shutdown"}))

    asyncio.run(drive())
    th.join(timeout=TIMEOUT)
    assert not th.is_alive() and rc == {"code": 0}
    poses = np.loadtxt(out + ".poses")
    assert poses.ndim == 2 and poses.shape[1] == 3
    d = np.linalg.norm(poses[:, :2] - np.array([-3.0, 2.0]), axis=1)
    assert d.min() < 2.5


def test_enml_gui_protocol(tmp_path, listening):
    """cli_enml --gui: progress frames during the sweep, the 0x06 click
    turns loop corrections on, two COLINEAR drags apply a correction to the
    live map (the poses the session API gives), 'v' saves, and shutdown
    writes the correction log."""
    websockets = pytest.importorskip("websockets")
    from hitl_slam_torch import cli_enml
    from hitl_slam_torch.core.state import CorrectionType
    from hitl_slam_torch.io import logs, stfs
    from hitl_slam_torch.io.figure8 import generate_raw_stream
    from hitl_slam_torch.models.enml.driver import (EpisodeOptions,
                                                     build_episodes)
    from hitl_slam_torch.models.enml.localizer import EnmlOptions
    from hitl_slam_torch.models.enml.session import EnmlSession

    # the CLI's run mirrored in process, to sketch a correction on the map
    # the CLI will produce
    scans, angles, rel, gt, walls = generate_raw_stream(num_steps=48, seed=5)
    poses0, pcs, ncs, _ = build_episodes(
        list(scans), angles, rel, EpisodeOptions(clip_low=10, clip_high=10))
    mirror = EnmlSession(poses0, pcs, ncs, options=EnmlOptions(max_history=4),
                         device="cpu")
    mirror.localize(segment=16)
    P = len(mirror.poses)
    sel = synth_wall_correction(mirror.poses, pcs, walls,
                                late=range(P - 12, P), early=range(0, 9))
    assert mirror.add_loop_correction(CorrectionType.COLINEAR, sel).accepted

    out = str(tmp_path / "gui_out")
    port = _free_port()
    th, rc = _run_cli(cli_enml.main, [
        "--synthetic", "--steps", "48", "--seed", "5", "--max-history", "4",
        "--gui", "--gui-port", str(port), "--segment", "16", "-o", out,
        "--device", "cpu"])
    assert listening.wait(TIMEOUT)
    progress = []

    async def drive():
        async with websockets.connect(f"ws://127.0.0.1:{port}",
                                      max_size=2 ** 25) as ws:
            async def send(obj):
                await ws.send(json.dumps(obj))

            f = await _recv(ws)
            while f.get("progress", 1.0) < 1.0:
                progress.append(f["progress"])
                f = await _recv(ws)
            base = f
            assert base["type"] == "drawlist" and len(base["points"]) > 0
            await send({"type": "mouse_click", "modifiers": 6,
                        "mouse_down": [0.0, 0.0], "mouse_up": [0.0, 0.0]})
            await send({"type": "mouse_click", "modifiers": 4,
                        "mouse_down": list(map(float, sel[0])),
                        "mouse_up": list(map(float, sel[1]))})
            await send({"type": "mouse_click", "modifiers": 4,
                        "mouse_down": list(map(float, sel[2])),
                        "mouse_up": list(map(float, sel[3]))})
            # the sweep's last frame may come twice (its progress callback
            # and the completion publish): read on until the map moves
            moved = 0.0
            for _ in range(5):
                f2 = await _recv(ws)
                moved = np.abs(
                    np.asarray(f2["points"][:len(base["points"])])
                    - np.asarray(base["points"])).max()
                if moved > 1e-3:
                    break
            assert moved > 1e-3
            await send({"type": "keyboard", "keycode": 0x56})
            await send({"type": "shutdown"})

    asyncio.run(drive())
    th.join(timeout=TIMEOUT)
    assert not th.is_alive() and rc == {"code": 0}
    assert progress and progress == sorted(progress)
    np.testing.assert_allclose(np.loadtxt(out + ".poses"), mirror.poses,
                               rtol=0, atol=1e-5)
    entries = logs.load_log(out + ".correction.log")
    assert len(entries) == 1
    assert entries[0].correction_type == CorrectionType.COLINEAR
    assert len(stfs.load_stfs_covars(out + ".stfs.covars").poses) == P


def test_default_log_name_matches_reference():
    """The session log the CLI writes on Ctrl-C is named as the
    reference's: <pose graph>_logged_<y-m-d-h-m-s>.log."""
    import re

    from hitl_slam_torch.io.logs import default_log_name
    from hitl_slam_tpu.io.logs import default_log_name as ref

    pattern = r"map\.stfs\.covars_logged_(\d+-){5}\d+\.log"
    got, want = default_log_name("map.stfs.covars"), ref("map.stfs.covars")
    assert re.fullmatch(pattern, got) and re.fullmatch(pattern, want)
