"""cycle_device_ms: the mean device ms of a replay of the cycle program,
from its graph's `begin` node to its `end` node, over the replays of the
window's corrections: the stage clock's edges of each replay summed
(cardbench/stages.py; hitl_slam_torch/utils/timing.py::snapshot, program
"hitl")."""

from cardbench import stages

LAYER = "cycle program"
UNIT = "ms"
MOVES = "correction_p50_ms"
SOURCE = "program_span"


def read(run):
    st = stages.stages(run)
    return st.mean_ms() if st is not None else None
