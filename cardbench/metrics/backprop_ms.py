"""backprop_ms: the mean device ms a replay of the cycle program's stage
from its `backprop` mark to its `build_problem` mark, over the window's
replays: back-propagation of the correction along the trajectory and the
angle wrap (hitl_slam_torch/models/hitl/cycle.py::cycle_solve). None where
the program sets no such marks."""

from cardbench import stages

LAYER = "cycle program"
UNIT = "ms"
MOVES = "correction_p50_ms"
SOURCE = "program_span"


def read(run):
    st = stages.stages(run)
    if st is None:
        return None
    edge = st.edges_ms().get("backprop->build_problem")
    return edge[0] if edge is not None else None
