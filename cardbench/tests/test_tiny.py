"""The CPU cuts as data: the overlay's merge, and the first
configuration's cut pinned to the size its CPU cells have always run at."""

import copy

from cardbench import harness
from cardbench.tests.tiny import overlay, tiny_cell


def test_overlay_merges_dicts_key_by_key():
    base = {"a": 1, "g": {"x": 1, "y": {"p": 1, "q": 2}}, "l": [1, 2]}
    keep = copy.deepcopy(base)
    got = overlay(base, {"g": {"y": {"q": 3}, "z": 4}, "l": [5], "n": {"m": 1}})
    assert got == {"a": 1, "g": {"x": 1, "y": {"p": 1, "q": 3}, "z": 4},
                   "l": [5], "n": {"m": 1}}
    assert base == keep
    # a dict meets a value that is no dict: it replaces it whole
    assert overlay({"g": 1}, {"g": {"x": 2}}) == {"g": {"x": 2}}
    assert overlay({"g": {"x": 1}}, {"g": 0}) == {"g": 0}


def test_the_1024_cut_is_the_cpu_cells_size():
    name = "hitl-figure8-1024.corrections"
    full = harness.find_cell(name).config
    want = copy.deepcopy(full)
    want["map"]["num_poses"] = 128
    want["map"]["num_rays"] = 180
    want["constraint_capacity"] = 2048
    assert tiny_cell(name).config == want
