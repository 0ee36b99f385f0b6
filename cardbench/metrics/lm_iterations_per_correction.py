"""lm_iterations_per_correction: the mean of CycleReport.lm_iterations over
the window's corrections (0 for a rejected one). The slowest corrections
are those with the most iterations."""

LAYER = "LM loop"
UNIT = "iterations"
MOVES = "correction_p95_ms"
SOURCE = "program_counter"


def read(run):
    xs = run.samples.get("lm_iterations")
    return sum(xs) / len(xs) if xs else None
