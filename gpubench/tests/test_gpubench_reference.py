"""The plain reference against the port at small sizes on the CPU, and
each cell's control (the reference with one guarantee broken) failing
the comparison that decides `correct`."""

import time

import numpy as np
import pytest

from gpubench import control
from gpubench.harness import cells, judge, window
from gpubench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_port(tmp_path, name):
    """Graph, warm-up state, every message's delays and the state when
    the window closes agree bit for bit."""
    cell = tiny_cell(tmp_path, name, messages=3)
    run = window.run_cell(cell, 11, 0.1, False, "cpu", time.perf_counter())
    ref = judge.reference_run(cell.config, cell.traffic, 11, "cpu",
                              final_cycle=run.outputs.final_cycle)
    nums, per_msg = judge.compare(run.outputs, ref,
                                  with_mix="mix_mismatch"
                                  in cell.config["limits"])
    assert all(v == 0 for v in nums.values()), nums
    for i, delays, received, _ in run.outputs.messages:
        assert np.array_equal(received, ref.messages[i].received)
        assert np.array_equal(delays[received],
                              ref.messages[i].delays_ms[received])


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(tmp_path, name):
    cell = tiny_cell(tmp_path, name, messages=3)
    for seed in (1, 2, 3):
        nums = control.readings(cell, seed, "cpu")
        assert not judge.verdict(nums, cell.config["limits"]), nums
