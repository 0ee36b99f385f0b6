"""bcr_roofline: the BCR kernel's share of its roofline at the cell's n,
over many eager launches after the window: the frozen bcr_work bound
divided by the profiler's device seconds a call (all of the call's BCR
kernels)."""

from cardbench.frozen.work import bcr_work, bound_s

LAYER = "BCR kernel"
UNIT = "%"
MOVES = "correction_p95_ms"
SOURCE = "device_trace"


def read(run):
    p = run.trace.get("bcr")
    if not p or p["device_s"] <= 0 or p["calls"] <= 0:
        return None
    return 100.0 * bound_s(*bcr_work(p["n"])) / (p["device_s"] / p["calls"])
