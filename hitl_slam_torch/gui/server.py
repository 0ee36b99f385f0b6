"""GUI bridge: a websocket message bus between the repair engine and viewers.

Port of hitl_slam_tpu/gui/server.py: host asyncio and json only, a
copy but for one repair (the latched frame is set on the server's loop, so
a viewer that joins during a publish does not get the frame twice).
`websockets` is imported inside `start()`, so the module imports without
it.

Replaces the reference's ROS1 pub/sub plumbing (roscore + TCPROS topics
VectorSLAM/VectorLocalization/{Gui,GuiMouseClickEvents,GuiKeyboardEvents},
HitLSLAM_main.cpp:986-1005, vector_display_main.cpp:206-216): the engine
process runs this server; any number of viewer clients connect, receive
draw-list JSON frames, and send mouse/keyboard events that drive the same
keycode protocol as the reference GUI ('p' provide correction, 'u' undo,
'v' save, 'l' replay — README.md:178-184).

The engine work runs on the server's thread via a callback queue so the
device pipeline never runs concurrently with itself.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Callable

from .drawlist import DrawList, KeyboardEvent, MouseClickEvent, parse_event


class GuiServer:
    """Broadcast draw-lists; dispatch input events to engine callbacks."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8765):
        self.host = host
        self.port = port
        self.clients: set = set()
        self.on_mouse_click: Callable[[MouseClickEvent], None] | None = None
        self.on_keyboard: Callable[[KeyboardEvent], None] | None = None
        # capture service (LocalizationGuiCaptureSrv analog): client sends
        # {"type": "capture", "filename": ...}
        self.on_capture: Callable[[str], None] | None = None
        # vector-map editing (VectorDisplayThread edit modes analog)
        self.on_map_edit: Callable[[dict], None] | None = None
        # nav/semantic graph editing (editGraph modes analog)
        self.on_graph_edit: Callable[[dict], None] | None = None
        # {"type": "set_location", "pose": [x, y, theta], "map": name?}:
        # GUI-initiated localization seed (the reference's Set Position
        # initialpose publish + AutoLocalize service call,
        # vector_display_thread.cpp:218-226,527-551)
        self.on_set_location: Callable[[dict], None] | None = None
        # {"type": "change_map", "name": ...}: background-map switch
        # (ChangeMap, vector_display_thread.cpp:141-176)
        self.on_change_map: Callable[[dict], None] | None = None
        # {"type": "shutdown"}: ask the engine process to exit its serve
        # loop (used by headless tests; the interactive path uses Ctrl-C)
        self.on_shutdown: Callable[[], None] | None = None
        self.loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._started = threading.Event()
        self._stop = None
        # serializes ENGINE callbacks across clients: `async for` only
        # orders events per connection, and two viewers pressing keys
        # concurrently must not run the device pipeline against itself
        self._cb_lock = threading.Lock()
        # latched last frame, replayed to late-joining clients — the analog
        # of the reference's latched queue-size-1 publisher
        # (HitLSLAM_main.cpp:986-988)
        self._last_frame: str | None = None

    async def _handler(self, ws):
        self.clients.add(ws)
        try:
            if self._last_frame is not None:
                await ws.send(self._last_frame)
            async for msg in ws:
                try:
                    ev = parse_event(msg)
                except Exception as e:  # malformed client message: drop it,
                    # keep the connection — a ROS subscriber would skip a
                    # bad message, not tear down the topic (1011 close
                    # observed driving the bridge with a partial event)
                    print(f"gui: dropped malformed event: {e!r}", flush=True)
                    continue

                def locked(fn, *a):
                    with self._cb_lock:
                        fn(*a)

                if isinstance(ev, MouseClickEvent) and self.on_mouse_click:
                    await asyncio.to_thread(locked, self.on_mouse_click, ev)
                elif isinstance(ev, KeyboardEvent) and self.on_keyboard:
                    await asyncio.to_thread(locked, self.on_keyboard, ev)
                elif (isinstance(ev, dict) and ev.get("type") == "capture"
                      and self.on_capture):
                    await asyncio.to_thread(
                        locked, self.on_capture,
                        str(ev.get("filename", "capture.png")))
                elif (isinstance(ev, dict) and ev.get("type") == "map_edit"
                      and self.on_map_edit):
                    await asyncio.to_thread(locked, self.on_map_edit, ev)
                elif (isinstance(ev, dict) and ev.get("type") == "graph_edit"
                      and self.on_graph_edit):
                    await asyncio.to_thread(locked, self.on_graph_edit, ev)
                elif (isinstance(ev, dict)
                      and ev.get("type") == "set_location"
                      and self.on_set_location):
                    await asyncio.to_thread(locked, self.on_set_location, ev)
                elif (isinstance(ev, dict)
                      and ev.get("type") == "change_map"
                      and self.on_change_map):
                    await asyncio.to_thread(locked, self.on_change_map, ev)
                elif (isinstance(ev, dict) and ev.get("type") == "shutdown"
                      and self.on_shutdown):
                    self.on_shutdown()
        finally:
            self.clients.discard(ws)

    async def _main(self):
        import websockets

        self._stop = asyncio.Event()
        async with websockets.serve(self._handler, self.host, self.port):
            self._started.set()
            await self._stop.wait()

    def start(self):
        """Run the server on a daemon thread; returns once listening."""
        self.loop = asyncio.new_event_loop()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self._main())

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("GUI server failed to start")

    def stop(self):
        if self.loop and self._stop:
            self.loop.call_soon_threadsafe(self._stop.set)
        if self._thread:
            self._thread.join(timeout=5)

    def publish(self, drawlist: DrawList):
        """Broadcast a draw-list frame to all connected viewers.

        The latched frame is set on the server's loop, where `_handler`
        reads it: a viewer joining while a publish is in flight then gets
        the frame once, either latched or broadcast (set from the calling
        thread, a joiner could get both)."""
        frame = drawlist.to_json()
        if not self.loop:
            self._last_frame = frame
            return

        async def send():
            self._last_frame = frame
            dead = []
            for ws in list(self.clients):
                try:
                    await ws.send(frame)
                except Exception:
                    dead.append(ws)
            for ws in dead:
                self.clients.discard(ws)

        asyncio.run_coroutine_threadsafe(send(), self.loop)

    def publish_json(self, payload: dict):
        if not self.loop:
            return
        frame = json.dumps(payload)

        async def send():
            for ws in list(self.clients):
                try:
                    await ws.send(frame)
                except Exception:
                    pass

        asyncio.run_coroutine_threadsafe(send(), self.loop)
