"""setup_s: seconds from the process's start to the window: imports, the
kernels' build or cache load, inputs, state upload, warm-up and captures."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
