"""Restricted-Lua config interpreter: ingest the reference's .cfg files.

Port of hitl_slam_tpu/utils/luaconfig.py (host only, a copy).

The reference's configs are executable Lua 5.1 evaluated by ConfigReader
(shared/util/configreader.h:14-120) over config/{common,robot,
non_markov_localization}.cfg: a base `NonMarkovLocalization` table plus
per-robot blocks (`if RobotConfig.name=="Cobot3" then ... end`,
non_markov_localization.cfg:76-152) and per-domain blocks
(`if enml_domain == "freiburg" then ... elseif ... end`, :184-310), with
helper functions/constants from common.cfg (deg2rad, vec2, pi, ...).

This module evaluates exactly the statement/expression subset those files
use — assignments, (nested) table constructors, dotted member assignment,
if/elseif/else chains, arithmetic, comparisons, calls of the common.cfg
helpers — so the reference's config files load UNMODIFIED, including the
override-precedence the Lua gives them (base table first, then robot
blocks, then domain blocks, in file order). `function ... end` definitions
are skipped: the common.cfg helpers are provided as Python builtins.

Domain/robot selection: the reference flips the `enml_domain = "..."` line
at the top of the cfg (or RobotConfig.name in robot.cfg). Here the loader
additionally accepts `locked` overrides (e.g. from a --domain CLI flag):
a locked name keeps its injected value, and in-file assignments to it are
ignored — same effect as editing the line, without editing the file.

Not supported (not used by the reference configs): loops, local variables,
string concatenation, table indexing with brackets, varargs, metatables.
"""

from __future__ import annotations

import math
import re
from typing import Any

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<number>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<op>==|~=|<=|>=|[-+*/%^#<>=(){}\[\];:,.])
    """,
    re.VERBOSE,
)

_KEYWORDS = {"if", "then", "elseif", "else", "end", "function", "return",
             "true", "false", "nil", "and", "or", "not", "local"}


def _tokenize(src: str) -> list[tuple[str, str]]:
    toks = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise ValueError(f"lua config: bad character {src[pos]!r} "
                             f"at offset {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group()
        if kind == "name" and text in _KEYWORDS:
            toks.append(("kw", text))
        elif kind == "string":
            toks.append(("string", text[1:-1]))
        else:
            toks.append((kind, text))
    toks.append(("eof", ""))
    return toks


def _builtins() -> dict[str, Any]:
    """common.cfg's helper functions/constants as Python callables."""
    def vec2(x, y):
        return {"x": x, "y": y}

    def vec3(x, y, z):
        return {"x": x, "y": y, "z": z}

    def quat4(w, x, y, z):
        return {"w": w, "x": x, "y": y, "z": z}

    def rng(lo, hi):
        return {"min": lo, "max": hi}

    def bbox2d(cx, cy, rx, ry):
        return {"cen": vec2(cx, cy), "rad": vec2(rx, ry)}

    return {
        "pi": math.pi,
        "math": {"pi": math.pi, "abs": abs, "sin": math.sin,
                 "cos": math.cos, "sqrt": math.sqrt},
        "on": True,
        "off": False,
        "abs": abs,
        "sin": math.sin,
        "cos": math.cos,
        "sq": lambda x: x * x,
        "circle_area": lambda r: math.pi * r * r,
        "deg2rad": lambda a: a * math.pi / 180.0,
        "rad2deg": lambda a: a * 180.0 / math.pi,
        "iff": lambda sel, a, b: a if sel else b,
        "vec2": vec2,
        "vec3": vec3,
        "quat4": quat4,
        "range": rng,
        "range_empty": lambda m: {"min": m, "max": m},
        "bbox2d": bbox2d,
        "bbox2d_xxyy": lambda x0, x1, y0, y1: {
            "cen": vec2((x1 + x0) / 2, (y1 + y0) / 2),
            "rad": vec2(abs((x1 - x0) / 2), abs((y1 - y0) / 2))},
        "bbox2d_xxcr": lambda x0, x1, cy, ry: {
            "cen": vec2((x1 + x0) / 2, cy),
            "rad": vec2(abs((x1 - x0) / 2), ry)},
    }


class _Interp:
    def __init__(self, env: dict, locked: frozenset[str]):
        self.env = env
        self.locked = locked
        self.toks: list[tuple[str, str]] = []
        self.i = 0

    # -- token helpers --
    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, text=None):
        t = self.next()
        if t[0] != kind or (text is not None and t[1] != text):
            raise ValueError(f"lua config: expected {text or kind}, "
                             f"got {t} at token {self.i - 1}")
        return t

    # -- statements --
    def run(self, src: str):
        self.toks = _tokenize(src)
        self.i = 0
        self.block(("eof",))

    def block(self, stop_kws: tuple):
        """Execute statements until one of stop_kws (kw text) or eof."""
        while True:
            kind, text = self.peek()
            if kind == "eof" or (kind == "kw" and text in stop_kws):
                return
            self.statement()

    def skip_block(self, stop_kws: tuple):
        """Skip (without evaluating) until a matching stop keyword, tracking
        nested if/function blocks."""
        depth = 0
        while True:
            kind, text = self.peek()
            if kind == "eof":
                return
            if kind == "kw":
                if text in ("if", "function"):
                    depth += 1
                elif text == "end":
                    if depth == 0:
                        return
                    depth -= 1
                elif depth == 0 and text in stop_kws:
                    return
            self.next()

    def statement(self):
        kind, text = self.peek()
        if kind == "op" and text == ";":
            self.next()
            return
        if kind == "kw" and text == "function":
            # helpers are predefined in Python; skip the Lua body
            self.next()
            self.skip_block(())
            self.expect("kw", "end")
            return
        if kind == "kw" and text == "if":
            self.if_statement()
            return
        if kind == "kw" and text == "local":
            self.next()  # treat `local x = ...` as a plain assignment
            kind, text = self.peek()
        if kind == "name":
            self.assignment()
            return
        raise ValueError(f"lua config: unexpected statement start {text!r}")

    def if_statement(self):
        self.expect("kw", "if")
        taken = False
        while True:
            cond = self.expression()
            self.expect("kw", "then")
            if cond and not taken:
                taken = True
                self.block(("elseif", "else", "end"))
            else:
                self.skip_block(("elseif", "else", "end"))
            kind, text = self.next()
            if text == "end":
                return
            if text == "else":
                if taken:
                    self.skip_block(("end",))
                else:
                    taken = True
                    self.block(("end",))
                self.expect("kw", "end")
                return
            # text == "elseif": loop

    def assignment(self):
        parts = [self.expect("name")[1]]
        while self.peek() == ("op", "."):
            self.next()
            parts.append(self.expect("name")[1])
        self.expect("op", "=")
        value = self.expression()
        if self.peek() == ("op", ";"):
            self.next()
        if parts[0] in self.locked:
            return  # CLI override wins over in-file assignment
        node: Any = self.env
        for p in parts[:-1]:
            nxt = node.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                node[p] = nxt
            node = nxt
        node[parts[-1]] = value

    # -- expressions (precedence climbing) --
    def expression(self):
        return self.or_expr()

    def or_expr(self):
        v = self.and_expr()
        while self.peek() == ("kw", "or"):
            self.next()
            rhs = self.and_expr()
            v = v or rhs
        return v

    def and_expr(self):
        v = self.cmp_expr()
        while self.peek() == ("kw", "and"):
            self.next()
            rhs = self.cmp_expr()
            v = v and rhs
        return v

    def cmp_expr(self):
        v = self.add_expr()
        while self.peek()[0] == "op" and self.peek()[1] in (
                "==", "~=", "<", ">", "<=", ">="):
            op = self.next()[1]
            rhs = self.add_expr()
            v = {"==": lambda a, b: a == b, "~=": lambda a, b: a != b,
                 "<": lambda a, b: a < b, ">": lambda a, b: a > b,
                 "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b}[op](
                     v, rhs)
        return v

    def add_expr(self):
        v = self.mul_expr()
        while self.peek()[0] == "op" and self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            rhs = self.mul_expr()
            v = v + rhs if op == "+" else v - rhs
        return v

    def mul_expr(self):
        v = self.unary_expr()
        while self.peek()[0] == "op" and self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            rhs = self.unary_expr()
            v = (v * rhs if op == "*"
                 else v / rhs if op == "/" else v % rhs)
        return v

    def unary_expr(self):
        if self.peek() == ("op", "-"):
            self.next()
            return -self.unary_expr()
        if self.peek() == ("kw", "not"):
            self.next()
            return not self.unary_expr()
        return self.primary()

    def primary(self):
        kind, text = self.next()
        if kind == "number":
            f = float(text)
            return int(f) if f.is_integer() and "." not in text \
                and "e" not in text.lower() else f
        if kind == "string":
            return text
        if kind == "kw":
            if text == "true":
                return True
            if text == "false":
                return False
            if text == "nil":
                return None
            raise ValueError(f"lua config: unexpected keyword {text!r} "
                             "in expression")
        if kind == "op" and text == "(":
            v = self.expression()
            self.expect("op", ")")
            return v
        if kind == "op" and text == "{":
            return self.table_constructor()
        if kind == "name":
            v = self.lookup(text)
            while True:
                if self.peek() == ("op", "."):
                    self.next()
                    fld = self.expect("name")[1]
                    if isinstance(v, dict):
                        v = v.get(fld)
                    elif v is None:
                        v = None  # nil.field -> nil (lenient: lets the
                        # domain cfg load without robot.cfg)
                    else:
                        raise ValueError(
                            f"lua config: {text}.{fld}: not a table")
                elif self.peek() == ("op", "("):
                    self.next()
                    args = []
                    if self.peek() != ("op", ")"):
                        args.append(self.expression())
                        while self.peek() == ("op", ","):
                            self.next()
                            args.append(self.expression())
                    self.expect("op", ")")
                    v = v(*args)
                else:
                    return v
        raise ValueError(f"lua config: unexpected token {text!r}")

    def lookup(self, name: str):
        return self.env.get(name)  # undefined global -> nil, as in Lua

    def table_constructor(self) -> dict:
        out: dict = {}
        while True:
            kind, text = self.peek()
            if kind == "op" and text == "}":
                self.next()
                return out
            key = self.expect("name")[1]
            self.expect("op", "=")
            out[key] = self.expression()
            while self.peek()[0] == "op" and self.peek()[1] in (";", ","):
                self.next()


def load_lua_config(
    paths: str | list[str],
    overrides: dict[str, Any] | None = None,
) -> dict:
    """Evaluate reference-style Lua config file(s) in order; return the
    resulting global table dict (tables as dicts, vec2/vec3 as {x:, y:}).

    overrides: name -> value pairs injected before evaluation and LOCKED —
    in-file assignments to those top-level names are ignored, so
    `load_lua_config(cfg, {"enml_domain": "freiburg"})` selects the
    freiburg domain block regardless of the file's own `enml_domain` line
    (the reference's workflow edits that line in place). Dotted keys
    ("RobotConfig.name") re-assert the single field after every file, so
    the rest of the table survives the file's own constructor."""
    overrides = overrides or {}
    flat = {k: v for k, v in overrides.items() if "." not in k}
    dotted = {k: v for k, v in overrides.items() if "." in k}
    env = _builtins()
    locked = frozenset(flat.keys())
    env.update(flat)

    def apply_dotted():
        for key, v in dotted.items():
            parts = key.split(".")
            node = env
            for p in parts[:-1]:
                nxt = node.get(p)
                if not isinstance(nxt, dict):
                    nxt = {}
                    node[p] = nxt
                node = nxt
            node[parts[-1]] = v

    apply_dotted()
    if isinstance(paths, str):
        paths = [paths]
    interp = _Interp(env, locked)
    for p in paths:
        with open(p, encoding="utf-8", errors="replace") as f:
            interp.run(f.read())
        apply_dotted()
    skip = set(_builtins().keys())
    return {k: v for k, v in env.items() if k not in skip}
