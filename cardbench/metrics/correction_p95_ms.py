"""correction_p95_ms: the 95th percentile (linear interpolation) of the
same walls as correction_p50_ms: every correction of the window."""

import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    xs = run.samples.get("correction_ms")
    return float(np.percentile(xs, 95)) if xs else None
