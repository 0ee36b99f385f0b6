"""correction_p50_ms: the median wall of every correction submitted in the
window, from the call of HitLSLAM.replay_log to a synchronise after it,
rejected corrections included."""

import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    xs = run.samples.get("correction_ms")
    return float(np.percentile(xs, 50)) if xs else None
