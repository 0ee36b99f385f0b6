"""The headline correction session's specs and the sketch of its clicks.

Frozen copy of `_spec`, `correction_specs` and `sketch` from
hitl_slam_torch/bench_sessions.py at commit 455be22. The only change: the
port's `CorrectionType` members are written as their integer values (the
benchmark imports nothing of the port outside the program under test), and
the sketch calls the benchmark's frozen figure-8 generator.
"""

from __future__ import annotations

import numpy as np

from .figure8 import synthesize_correction

# CorrectionType values (hitl_slam_torch/core/state.py)
POINT, LINE_SEGMENT, CORNER, COLINEAR, PERPENDICULAR, PARALLEL = 1, 2, 3, 4, 5, 6


def _spec(ctype, corrected, anchor, cw, aw, cspan=None, aspan=None,
          min_points=40) -> dict:
    return dict(ctype=ctype, corrected=corrected, anchor=anchor, cw=cw,
                aw=aw, cspan=cspan, aspan=aspan, min_points=min_points)


def correction_specs(P: int) -> list[dict]:
    """A mixed sequence of 'human' corrections between lap 1 and lap 2."""
    lap = P // 2
    h = 10.0
    lap1 = range(0, lap)
    lap2 = range(lap, P)
    return [
        # colinear: bottom wall, right-room span, lap2 vs lap1
        _spec(COLINEAR, lap2, lap1, (1, 0.0), (1, 0.0),
              (4.0, 16.0), (4.0, 16.0)),
        # perpendicular: late top-left section vs early left wall
        _spec(PERPENDICULAR, lap2, lap1, (1, h), (0, -20.0),
              (-16.0, -4.0), (2.0, 8.0)),
        # colocation: left wall, lap2 vs lap1
        _spec(LINE_SEGMENT, lap2, lap1, (0, -20.0),
              (0, -20.0), (2.0, 8.0), (2.0, 8.0)),
        # colinear: top wall left span, lap2 vs lap1
        _spec(COLINEAR, lap2, lap1, (1, h), (1, h),
              (-16.0, -4.0), (-16.0, -4.0)),
        # parallel: right wall, lap2 vs lap1
        _spec(PARALLEL, lap2, lap1, (0, 20.0), (0, 20.0),
              (2.0, 8.0), (2.0, 8.0)),
    ]


def sketch(m, spec: dict, poses: np.ndarray) -> np.ndarray:
    """The [4, 2] clicks of `spec` on map `m` as it stands at `poses`;
    ValueError where a wall shows too few points."""
    span = {}
    if spec["cspan"] is not None:
        span = dict(corrected_span=spec["cspan"], anchor_span=spec["aspan"])
    return synthesize_correction(m, spec["corrected"], spec["anchor"],
                                 spec["cw"], spec["aw"],
                                 min_points=spec["min_points"], poses=poses,
                                 **span)
