"""On the card: each cell's command, as the benchmark's check runs it, for a
short window. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from cardbench import harness
from cardbench.tests.tiny import cell_names


@pytest.mark.cuda
@pytest.mark.parametrize("name", cell_names())
def test_cell_on_card(card, name):
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         name, "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-4000:]
    assert line["device"]["platform"] == "gpu"
