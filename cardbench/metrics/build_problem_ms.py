"""build_problem_ms: the mean device ms a replay of the cycle program's
stage from its `build_problem` mark to the LM loop's first test, over the
window's replays: the joint problem's build with the human table's
reduction to poses (a one-hot matmul, or past `solver/joint.py`'s
ONEHOT_BUDGET the scatter-add) and the LM's first assembly. None where
the program sets no such mark."""

from cardbench import stages

LAYER = "cycle program"
UNIT = "ms"
MOVES = "correction_p50_ms"
SOURCE = "program_span"


def read(run):
    st = stages.stages(run)
    if st is None:
        return None
    edge = st.edges_ms().get("build_problem->lm")
    return edge[0] if edge is not None else None
