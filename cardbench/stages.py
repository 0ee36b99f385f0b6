"""The window's share of the program's recorder, for the readers of its
stage clock and spans (metrics/cycle_device_ms.py, pre_solve_ms.py,
lm_trip_ms.py, lm_trips_per_correction.py, engine_host_ms.py,
host_reads_per_correction.py).

The recorder (hitl_slam_torch/utils/timing.py::snapshot) holds the whole
process: set-up's warm sessions, the window, the traced window. Each
reader covers the window's corrections alone, and their replays, so that
its number speaks of the corrections `correction_p50_ms` is taken from:
the last n corrections the recorder holds that ran with no profiler, n the
window's samples (after the window the mix runs only its traced sessions,
whose spans the profiler marks). Each sample's wall holds its
correction's span, which is checked; the replays come from the launch
spans of each correction, their marks from the stage clocks' logs."""

# the marks of the cycle's LM loop: its test and the BCR launch
LM = ("lm", "bcr_solve")
PROGRAM = "hitl"


def window(run):
    """(the recorder's snapshot, the window's corrections), or None where
    the program has no recorder or the recorder no longer holds every one
    of the window's corrections with its replays."""
    try:
        from hitl_slam_torch.utils.timing import snapshot
    except ImportError:     # a program without the recorder
        return None
    walls = list(getattr(run, "samples", {}).get("correction_ms", []))
    snap = snapshot()
    rows = [c for c in snap.corrections() if not c.profiled]
    if not walls or len(rows) < len(walls):
        return None
    rows = rows[len(rows) - len(walls):]
    if any(c.device_ns is None or c.wall_ns * 1e-6 > w + 1e-3
           for c, w in zip(rows, walls)):
        return None
    return snap, rows


def stages(run):
    """The cycle program's stage clocks over the window's replays (a
    timing.Stages), or None."""
    w = window(run)
    if w is None:
        return None
    snap, rows = w
    return snap.stages(PROGRAM, [r for c in rows for r in c.replays])
