"""engine_host_ms: the mean host-exposed ms of the window's corrections:
the part of each one's `hitl.correction` span during which no part of its
replay ran on the device (the replay's begin and end from the stage
clock's ring, mapped onto the host's clock; cardbench/stages.py)."""

from cardbench import stages

LAYER = "engine"
UNIT = "ms"
MOVES = "correction_p50_ms"
SOURCE = "program_span"


def read(run):
    w = stages.window(run)
    if w is None:
        return None
    _, rows = w
    return sum(c.exposed_ns for c in rows) / len(rows) * 1e-6
