"""On a CUDA card: each cell's run comes out correct, and each cell's
control, at the cell's own size, does not (three seeds)."""

import json
import os
import subprocess
import sys

import pytest

from gpubench import control
from gpubench.harness import cells, judge

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_card(card, name):
    out = subprocess.run(
        [sys.executable, os.path.join("gpubench", "run.py"), "--workload",
         name, "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0, result["check"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_card(card, name):
    cell = cells.load_cell(name)
    for seed in (2147483661, 2147483662, 2147483663):
        nums = control.readings(cell, seed, card)
        assert not judge.verdict(nums, cell.config["limits"]), nums
