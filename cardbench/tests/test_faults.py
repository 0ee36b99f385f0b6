"""The check fails what it must: the control (the reference in TF32, in the
program's place) and each fault a cell can have, planted under the
timed path, at a tiny size on the CPU with the cell's own limits."""

import pytest

from cardbench import harness
from cardbench.tests.tiny import tiny_cell

CORRECTIONS = "hitl-figure8-1024.corrections"


def test_control_fails():
    cell = tiny_cell(CORRECTIONS)
    line, err = harness.run_cell(cell, 5, 0.5, False, "cpu", control="tf32")
    assert line["correct"] is False, err


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_fault_fails(fault):
    cell = tiny_cell(CORRECTIONS)
    line, err = harness.run_cell(cell, 6, 0.5, False, "cpu", fault=fault)
    assert line["correct"] is False, err
