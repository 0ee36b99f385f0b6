"""lm_trip_ms: the mean device ms of one trip of the cycle's LM WHILE node,
from one test of the loop (mark `lm`) to the next: damping, BCR, the trial
assembly and the accept (the stage clock's edges among `lm` and
`bcr_solve`, over the trips of the window's replays)."""

from cardbench import stages

LAYER = "LM loop"
UNIT = "ms"
MOVES = "correction_p95_ms"
SOURCE = "program_span"


def read(run):
    st = stages.stages(run)
    trips, ns = st.loop("lm", stages.LM) if st is not None else (0, 0.0)
    return ns / trips * 1e-6 if trips else None
