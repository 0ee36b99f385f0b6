"""Each configuration cut to a size that a CPU test run holds, the same
mix code otherwise. The limits stay the cell's own."""

from cardbench import harness

TINY = {
    "hitl-figure8-1024": lambda c: (c["map"].update(num_poses=128, num_rays=180),
                                    c.update(constraint_capacity=2048)),
}


def tiny_cell(name: str, bench=None, base=harness.HERE, root=harness.ROOT):
    """The cell at its configuration's tiny size."""
    cell = harness.find_cell(name, bench, base, root)
    TINY[cell.workload["config"]](cell.config)
    return cell


def cell_names() -> list[str]:
    return [w["name"] for w in harness.load_json(
        f"{harness.ROOT}/BENCHMARK.json")["workloads"]]
