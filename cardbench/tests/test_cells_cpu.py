"""Every cell at a tiny size on the CPU, through its own mix code, ends in
one well-formed result line that the reference judges correct."""

import json

import pytest

from cardbench import harness
from cardbench.tests.tiny import cell_names, tiny_cell


@pytest.mark.parametrize("name", cell_names())
@pytest.mark.parametrize("trace", [False, True])
def test_cell_line(name, trace):
    cell = tiny_cell(name)
    line, err = harness.run_cell(cell, 2 ** 31 + 17, 0.5, trace, "cpu")
    json.loads(json.dumps(line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert line["device"]["platform"] == "cpu"
    n = len(line["checks"])
    assert [e.split()[1] for e in err[-n:]] == list(line["checks"])
    assert all(e.startswith("check ") for e in err[-n:])
