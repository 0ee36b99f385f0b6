"""The check fails what it must, in every cell: the control (the reference
in TF32, in the program's place) and each fault a cell can have, planted
under the timed path, at the cell's tiny size on the CPU with the cell's
own limits (the mix contract: tests/tiny.py)."""

import pytest

from cardbench import harness
from cardbench.tests.tiny import FAULTS, cell_names, tiny_cell


@pytest.mark.parametrize("name", cell_names())
def test_control_fails(name):
    cell = tiny_cell(name)
    line, err = harness.run_cell(cell, 5, 0.5, False, "cpu", control="tf32")
    assert line["correct"] is False, err


@pytest.mark.parametrize("name", cell_names())
@pytest.mark.parametrize("fault", FAULTS)
def test_fault_fails(fault, name):
    cell = tiny_cell(name)
    line, err = harness.run_cell(cell, 6, 0.5, False, "cpu", fault=fault)
    assert line["correct"] is False, err
