"""What the benchmark loads: no JAX and no JAX package anywhere, compared
by whole top-level names; and a reference that loads nothing of the
program."""

import ast
import os
import subprocess
import sys

from cardbench import harness

REF_DIRS = ("reference", "frozen")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_compares_whole_names(monkeypatch):
    for name in ("jaxtyping_like", "hitl_slam_tpu_extra", "hitl_slam_torch"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "hitl_slam_tpu.ops", sys)
    assert harness.forbidden_modules() == ["hitl_slam_tpu", "jax"]


def test_no_jax_after_a_run():
    """A tiny run of every cell in a fresh process loads no JAX."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from cardbench import harness\n"
        "from cardbench.tests.tiny import cell_names, tiny_cell\n"
        "for n in cell_names():\n"
        "    harness.run_cell(tiny_cell(n), 3, 0.2, False, 'cpu')\n"
        "print(','.join(harness.forbidden_modules()) or 'none')\n"
    ) % harness.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_reference_imports_nothing_of_the_program():
    for d in REF_DIRS:
        for f in os.listdir(os.path.join(harness.HERE, d)):
            if f.endswith(".py"):
                for mod in _imports(os.path.join(harness.HERE, d, f)):
                    top = mod.split(".")[0]
                    assert top not in ("hitl_slam_torch", "torch", "jax",
                                       "hitl_slam_tpu"), (f, mod)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import cardbench.reference.hitl_cycle, cardbench.frozen.sessions\n"
            "import cardbench.frozen.work\n"
            "print(sorted({k.split('.')[0] for k in sys.modules} & "
            "{'hitl_slam_torch', 'torch', 'jax', 'hitl_slam_tpu'}))\n"
            ) % harness.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_run_refuses_without_a_card():
    """run.py exits non-zero and prints no result on a machine without the
    cards the cell asks for, and in a directory that holds only the
    benchmark."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload",
         "hitl-figure8-1024.corrections", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
