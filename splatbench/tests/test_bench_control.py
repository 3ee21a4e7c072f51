"""The control: the reference in bfloat16 put in the program's place fails
every cell's limits (at a tiny size here; at each cell's own size on the
card, `python3 -m splatbench.control`, PERF.md)."""

import json

import pytest
import torch

from splatbench import control, judge, spec
from splatbench.tests import tiny

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    torch.set_num_threads(2)
    root = tiny.write_root(tmp_path_factory.mktemp("bench"),
                           {"tiny-orbit": ("tiny-move", tiny.traffic(0.05))})
    cell = spec.load_cell("tiny-orbit", root)
    return [control.control_readings(cell, seed, [0, 5], device="cpu") for seed in (3, 2**31 + 5)]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_each_cells_limits(readings, name):
    limits = spec.load_cell(name).limits
    for r in readings:
        correct, checks = judge.judge([r], limits)
        assert correct is False, checks
