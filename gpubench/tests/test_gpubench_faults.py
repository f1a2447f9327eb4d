"""A run whose timed path is broken underneath comes out not correct:
the harness's look for a card is skipped, everything else runs."""

import time

import numpy as np
import pytest

from gpubench.harness import cells, judge, window
from gpubench.tests.tiny import tiny_cell
from dst_libp2p_test_node_tpu_torch.runtime import simulator

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


def _correct(cell):
    run = window.run_cell(cell, 5, 0.1, False, "cpu", time.perf_counter())
    ok, failed, rows = judge.check(cell, run.outputs, 5, "cpu")
    return ok, failed


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tmp_path, name):
    assert _correct(tiny_cell(tmp_path, name)) == (True, 0)


@pytest.mark.parametrize("name", CELLS)
def test_step_that_keeps_its_state(tmp_path, name, monkeypatch):
    """Heartbeats that return the state unchanged."""
    real = simulator.Simulator.advance
    calls = []

    def stuck(self, ms):
        calls.append(ms)
        if len(calls) > 1:          # the warm-up runs; later steps do not
            return None
        return real(self, ms)

    monkeypatch.setattr(simulator.Simulator, "advance", stuck)
    assert not _correct(tiny_cell(tmp_path, name))[0]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_peers_left_out(tmp_path, name, monkeypatch):
    """Publishes that write back the state of the even peers only: the
    odd peers keep the uplink and downlink drain times and the
    first-delivery counters they had before the message."""
    real = simulator.Simulator.publish
    leaves = ("uplink_free_ms", "rx_free_ms", "fmd")

    def halved(self, *args, **kw):
        before = {k: getattr(self.state, k).clone() for k in leaves}
        rec = real(self, *args, **kw)
        kept = {}
        for k, old in before.items():
            new = getattr(self.state, k).clone()
            new[1::2] = old[1::2]
            kept[k] = new
        self.state = self.state.replace(**kept)
        return rec

    monkeypatch.setattr(simulator.Simulator, "publish", halved)
    assert not _correct(tiny_cell(tmp_path, name))[0]


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_produced(tmp_path, name, monkeypatch):
    """One receiver's delay moved by 0.5 ms as the record is made."""
    real = simulator.record_from_result

    def altered(res, **kw):
        rec = real(res, **kw)
        q = int(np.flatnonzero(rec.received)[-1])
        rec.delays_ms[q] += 0.5
        return rec

    monkeypatch.setattr(simulator, "record_from_result", altered)
    ok, failed = _correct(tiny_cell(tmp_path, name))
    assert not ok and failed > 0
