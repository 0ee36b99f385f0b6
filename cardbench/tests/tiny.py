"""Each configuration cut to a size that a CPU test run holds, the same
mix code otherwise. The limits stay the cell's own.

A configuration's cut is data: `tiny/<config>.json`, an overlay merged into
the configuration (a dict merges key by key, any other value replaces the
one it meets). A configuration with no overlay has no CPU cut, and its
cells are refused here rather than run at full size on the CPU.

The mix contract the CPU tests hold every cell to: its driver honours
`ctx.control` (the reference in a lower precision, put in the program's
place) and `ctx.fault` (one of FAULTS, planted under the timed path: a
correction that leaves its state unchanged, an answer altered where it is
produced), and the cell's own limits fail each of them
(tests/test_faults.py)."""

import os

from cardbench import harness

FAULTS = ("unchanged", "altered")


def overlay(base: dict, cut: dict) -> dict:
    """`base` with `cut` merged in: dicts key by key, any other value
    replaced."""
    out = dict(base)
    for k, v in cut.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = overlay(out[k], v)
        else:
            out[k] = v
    return out


def tiny_cell(name: str, bench=None, base=harness.HERE, root=harness.ROOT):
    """The cell at its configuration's tiny size."""
    if bench is None:
        bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    cell = harness.find_cell(name, bench, base, root)
    config = {w["name"]: w for w in bench["workloads"]}[name]["config"]
    rel = f"tiny/{config}.json"
    path = os.path.join(base, rel)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"configuration {config!r} has no CPU cut: "
                                f"{rel} is missing ({path})")
    cell.config = overlay(cell.config, harness.load_json(path))
    return cell


def cell_names() -> list[str]:
    return [w["name"] for w in harness.load_json(
        f"{harness.ROOT}/BENCHMARK.json")["workloads"]]
