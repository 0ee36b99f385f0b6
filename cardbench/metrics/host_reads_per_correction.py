"""host_reads_per_correction: the program's host reads (counter
`host_reads`: the report's read, and every eager loop test) under the
window's corrections (`hitl.correction` spans and their speculative
dispatches, by correction id; cardbench/stages.py), over those
corrections."""

from cardbench import stages

LAYER = "engine"
UNIT = "reads"
MOVES = "correction_p50_ms"
SOURCE = "program_counter"


def read(run):
    w = stages.window(run)
    if w is None:
        return None
    snap, rows = w
    return snap.counted("host_reads", [c.id for c in rows]) / len(rows)
