"""Config system with hot reload.

Port of hitl_slam_tpu/utils/config.py (host only, a copy).

The reference embeds Lua 5.1 (`ConfigReader`, shared/util/configreader.h) with
inotify-based hot reload (`WatchFiles`, shared/util/watch_files.h) and config
files config/{common,robot,non_markov_localization}.cfg. Here: Python-dict
configs loaded from TOML (stdlib tomllib) or JSON, a `WatchedConfig` that
re-reads on mtime change (poll- or inotify-based where available), and the
same parameter names as the reference's Lua tables so configs translate
1:1 (e.g. NonMarkovLocalization.max_history -> enml.max_history).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable


def is_lua_config(path: str) -> bool:
    """True when `path` would be dispatched to the Lua interpreter by
    load_config: a .cfg/.lua file that does not parse as TOML (the
    reference's .cfg files are Lua; a .cfg that parses as TOML — the
    pre-round-3 convention here — stays TOML). The single source of the
    format classification; cli_enml groups Lua files through one shared
    interpreter environment with it."""
    if not (path.endswith(".cfg") or path.endswith(".lua")):
        return False
    import tomllib

    try:
        with open(path, "rb") as f:
            tomllib.load(f)
        return False
    except (tomllib.TOMLDecodeError, UnicodeDecodeError):
        return True


def load_config(path: str, overrides: dict | None = None) -> dict:
    """Load a single config file: JSON, TOML, or a reference-style Lua .cfg
    (executable configs with domain/robot override blocks — see
    utils/luaconfig). `overrides` applies to Lua configs only (locked
    top-level names / dotted field re-assertions, e.g.
    {"enml_domain": "freiburg"})."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as f:
            return tomllib.load(f)
    if path.endswith(".cfg") or path.endswith(".lua"):
        if is_lua_config(path):
            from .luaconfig import load_lua_config

            return load_lua_config(path, overrides)
        import tomllib

        with open(path, "rb") as f:
            return tomllib.load(f)
    raise ValueError(f"unsupported config format: {path}")


class SubTree:
    """Scoped view of a nested config dict (ConfigReader::getSubTree analog)."""

    def __init__(self, data: dict, prefix: str = ""):
        self.data = data
        self.prefix = prefix

    def _get(self, key: str, default=None):
        node: Any = self.data
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self._get(key, default))

    def get_float(self, key: str, default: float = 0.0) -> float:
        return float(self._get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        return bool(self._get(key, default))

    def get_str(self, key: str, default: str = "") -> str:
        return str(self._get(key, default))

    def sub(self, key: str) -> "SubTree":
        v = self._get(key, {})
        return SubTree(v if isinstance(v, dict) else {})


class WatchedConfig:
    """Hot-reloading config: polls file mtimes on a daemon thread and invokes
    callbacks with the merged dict on change (WatchFiles analog)."""

    def __init__(self, paths: list[str], poll_interval: float = 0.5):
        self.paths = list(paths)
        self.poll_interval = poll_interval
        self.callbacks: list[Callable[[dict], None]] = []
        self._mtimes = {p: self._mtime(p) for p in self.paths}
        self.data = self._load_all()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @staticmethod
    def _mtime(p: str) -> float:
        try:
            return os.stat(p).st_mtime
        except OSError:
            return -1.0

    def _load_all(self) -> dict:
        merged: dict = {}
        for p in self.paths:
            try:
                cfg = load_config(p)
            except (OSError, ValueError):
                continue
            _deep_update(merged, cfg)
        return merged

    def on_change(self, cb: Callable[[dict], None]):
        self.callbacks.append(cb)

    def check(self) -> bool:
        """Poll once; reload + fire callbacks if anything changed."""
        changed = False
        for p in self.paths:
            m = self._mtime(p)
            if m != self._mtimes.get(p):
                self._mtimes[p] = m
                changed = True
        if changed:
            self.data = self._load_all()
            for cb in self.callbacks:
                cb(self.data)
        return changed

    def start(self):
        def run():
            while not self._stop.is_set():
                self.check()
                time.sleep(self.poll_interval)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def tree(self) -> SubTree:
        return SubTree(self.data)


def _deep_update(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = v
