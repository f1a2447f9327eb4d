"""The harness's arithmetic: cycles, episodes and rates, the kernels'
byte bounds, and the trace's busy time, gaps and per-layer readings."""

import statistics
import time

import pytest

from gpubench import run as bench_run
from gpubench.harness import cells, peaks, trace, window
from gpubench.tests.tiny import tiny_cell


@pytest.mark.parametrize("n,c,expect", [(1_000_000, 40, 0.0967),
                                        (100_000, 40, 0.0097)])
def test_gather_bound(n, c, expect):
    assert round(peaks.bound_ms(peaks.gather_bytes(n, c)), 4) == expect


@pytest.mark.parametrize("with_score,expect", [(True, 0.2388),
                                               (False, 0.1910)])
def test_score_update_bound(with_score, expect):
    nbytes = peaks.score_update_bytes(1_000_000, 40, with_score)
    assert round(peaks.bound_ms(nbytes), 4) == expect


@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_rate_is_all_the_work_over_all_the_time(name):
    cell = cells.load_cell(name)
    run = window.Run(setup_s=12.5, window_s=4.0, cycles=10, heartbeats=20,
                     n=100_000)
    out = bench_run.end_to_end(cell, run, 3 * 2**30)
    assert set(out) == {m["name"] for m in cell.end_to_end}
    rates = [v["value"] for k, v in out.items()
             if k.startswith("peer_rounds_per_s")]
    assert rates == [100_000 * 20 / 4.0]
    assert out["setup_s"]["value"] == 12.5
    assert out["peak_device_gib"]["value"] == 3.0


def test_window_replays_episodes(tmp_path):
    """Cycles run whole, episodes start over from s0 with message 0, and
    the window stops after the first cycle that ends past its length."""
    cell = tiny_cell(tmp_path, "c5-1m-mix.msg2s", n=1200, messages=2)
    run = window.run_cell(cell, 3, 1.5, False, "cpu", time.perf_counter())
    idx = [m[0] for m in run.outputs.messages]
    assert idx == [i % 2 for i in range(run.cycles)]
    assert run.heartbeats == 2 * run.cycles
    assert run.outputs.final_cycle == (run.cycles - 1) % 2
    assert run.window_s >= 1.5
    first = [m for m in run.outputs.messages if m[0] == 0]
    for m in first[1:]:
        assert (m[1] == first[0][1]).all()


def _slice():
    return {"wall_s": 0.010, "publishes": 2, "heartbeats": 4,
            "kernels": [("vmem_gather_kernel", 0.0, 100.0),
                        ("score_update_kernel", 50.0, 250.0),
                        ("aten_add", 1000.0, 1100.0),
                        ("vmem_gather_kernel", 3000.0, 3300.0)],
            "span_dev": {"disseminate.refinement": [(0.0, 2000.0),
                                                    (4000.0, 5000.0)],
                         "disseminate.fast_pipeline": [(0.0, 500.0)],
                         "gpubench.advance": [], "gpubench.publish": []},
            "span_cpu": {"gpubench.publish": [(0.0, 2000.0),
                                              (2000.0, 9000.0)],
                         "gpubench.advance": [],
                         "disseminate.fast_pipeline": [],
                         "disseminate.refinement": [(100.0, 1500.0)]},
            "syncs": [(400.0, 900.0), (2500.0, 2600.0), (9500.0, 9600.0)],
            "busy_s": trace._union([(0.0, 100.0), (50.0, 250.0),
                                    (1000.0, 1100.0), (3000.0, 3300.0)])
            * 1e-6,
            "by_name_s": {"vmem_gather_kernel": 400e-6,
                          "score_update_kernel": 200e-6,
                          "aten_add": 100e-6}}


def test_busy_is_the_union_of_kernels():
    assert trace._union([(0, 100), (50, 250), (1000, 1100)]) == 350


def test_breakdown_names_gaps_by_host():
    b = trace.breakdown(_slice())
    assert b["device_ops"][0] == ["vmem_gather_kernel", 400e-6]
    assert b["idle_gaps"][0] == ["disseminate.refinement: host sync",
                                 pytest.approx(1900e-6)]
    assert b["idle_gaps"][1] == ["disseminate.refinement: host sync",
                                 pytest.approx(750e-6)]


def test_readers_on_a_slice():
    ctx = {"slice": _slice(), "n": 100_000, "c": 40, "cell": "x",
           "run": window.Run(build_s=1.5, heartbeats=4,
                             advance_walls=[0.002, 0.006],
                             publish_walls=[0.1 * i for i in range(1, 11)])}

    def read(name):
        return cells.metric_reader(name)(ctx)

    assert read("refine_ms") == pytest.approx(1.5)
    assert read("fast_pipeline_ms") == pytest.approx(0.25)
    assert read("host_syncs_per_publish") == 1.0
    assert read("heartbeat_ms") == pytest.approx(2.0)
    assert read("setup.build_s") == 1.5
    assert read("publish_ms.p90") == pytest.approx(statistics.quantiles(
        [100.0 * i for i in range(1, 11)], n=10)[8])
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 0.00065
                                                           / 0.010))
    bound = peaks.bound_ms(peaks.gather_bytes(100_000, 40))
    assert read("vmem_gather_roofline") == pytest.approx(100 * bound / 0.2)
    bound = peaks.bound_ms(peaks.score_update_bytes(100_000, 40, False))
    assert read("score_update_roofline") == pytest.approx(100 * bound / 0.2)


def test_readers_return_nothing_without_readings():
    empty = {"wall_s": 0.01, "publishes": 1, "heartbeats": 2, "kernels": [],
             "span_dev": {s: [] for s in trace.SPANS},
             "span_cpu": {s: [] for s in trace.SPANS}, "syncs": [],
             "busy_s": 0.0, "by_name_s": {}}
    ctx = {"slice": empty, "n": 10, "c": 4, "cell": "x",
           "run": window.Run()}
    for m in cells.benchmark()["per_layer"]:
        if m["name"] != "setup.build_s":
            assert cells.metric_reader(m["name"])(ctx) is None, m["name"]
