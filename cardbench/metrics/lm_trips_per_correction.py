"""lm_trips_per_correction: the trips of the cycle's LM WHILE node a cycle
replay, over the replays of the window's corrections, counted by the stage
clock's `lm` marks (each replay's first test is its entry, every later one
ends a trip). Rejected corrections solve too, while their reports say 0
iterations."""

from cardbench import stages

LAYER = "LM loop"
UNIT = "iterations"
MOVES = "correction_p95_ms"
SOURCE = "program_counter"


def read(run):
    st = stages.stages(run)
    if st is None:
        return None
    trips, _ = st.loop("lm", stages.LM)
    return trips / st.replays
