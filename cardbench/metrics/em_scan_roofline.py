"""em_scan_roofline: the em_scan kernel's share of its roofline at the
window's [P, N] and mask, over many eager launches after the window: the
frozen em_scan_work bound divided by the profiler's device seconds a
launch."""

from cardbench.frozen.work import bound_s, em_scan_work

LAYER = "em_scan kernel"
UNIT = "%"
MOVES = "correction_p50_ms"
SOURCE = "device_trace"


def read(run):
    p = run.trace.get("em_scan")
    if not p or p["device_s"] <= 0 or p["launches"] <= 0:
        return None
    return 100.0 * bound_s(*em_scan_work(p["mask"])) / (
        p["device_s"] / p["launches"])
