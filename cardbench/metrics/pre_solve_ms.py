"""pre_solve_ms: the mean device ms of a cycle replay before its LM loop's
entry, over the replays of the window's corrections: the stage clock's
edges from `begin` to the LM loop's first test (the world transform and
verify scan, the EM refit rounds, the count scan, ordering, explicit
correction, rows, back-propagation, build_problem and the first
assembly)."""

from cardbench import stages

LAYER = "cycle program"
UNIT = "ms"
MOVES = "correction_p50_ms"
SOURCE = "program_span"


def read(run):
    st = stages.stages(run)
    return st.before_ms(stages.LM) if st is not None else None
