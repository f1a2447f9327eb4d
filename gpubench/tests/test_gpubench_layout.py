"""BENCHMARK.json and the files it names: every piece is found by name,
every name and unit keeps to the contract's characters, and a cell made
of new files alone runs through the harness."""

import json
import os
import re
import time

import pytest

from gpubench import run as bench_run
from gpubench.harness import cells, judge, window
from gpubench.tests.tiny import tiny_cell

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"gpubench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = ([m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + CELLS + [c["name"] for c in BENCH["configs"]])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = cells.load_cell(name)
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    assert cell.config["name"] == w["config"]
    assert cell.traffic["name"] == w["traffic"]
    assert {"limits", "control", "experiment", "model"} <= set(cell.config)
    reported = [m["name"] for m in cell.end_to_end]
    assert reported[0] == "setup_s" and len(reported) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    """Each per-layer metric has its reader, and every cell it lists
    reports the end-to-end metric it moves."""
    assert callable(cells.metric_reader(metric))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for name in m["workloads"]:
        reported = [x["name"] for x in cells.load_cell(name).end_to_end]
        assert m["moves"] in reported, name


def test_configuration_is_the_programs():
    """The reference's numbers ("model") are the ones the port derives
    from the configuration's "experiment"."""
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import Simulator

    for c in BENCH["configs"]:
        with open(os.path.join(cells.ROOT, c["file"])) as fh:
            config = json.load(fh)
        m = config["model"]
        config["experiment"]["topo"]["network_size"] = 64
        sim = Simulator(window.experiment_config(config, 0), device="cpu")
        p = sim.params
        for key in ("d", "d_low", "d_high", "d_score", "d_out", "d_lazy",
                    "heartbeat_ms", "prune_backoff_ms", "gossip_factor",
                    "history_gossip", "fmd_weight", "fmd_cap", "fmd_decay",
                    "decay_to_zero", "proc_delay_ms", "mss_bytes",
                    "initcwnd_segments", "idontwant_threshold_bytes",
                    "churn_down_per_hb", "churn_up_per_hb",
                    "serialize_answers"):
            assert getattr(p, key) == m[key], key
        assert p.capacity == m["max_degree"] and p.flood_publish
        assert p.exclude_first_sender and p.send_queue_cap >= m["num_frags"]
        assert p.slow_weight == 0.0 and not (p.evict or p.px)
        topo = config["experiment"]["topo"]
        for key in ("anchor_stages", "min_bandwidth", "max_bandwidth",
                    "min_latency", "max_latency", "msg_size_bytes",
                    "num_frags"):
            assert topo[key] == m[key], key
        assert config["experiment"].get("num_mix", 0) == m.get("num_mix", 0)


def test_new_cell_from_new_files_runs(tmp_path):
    """A configuration and a traffic mix that no file of the benchmark
    holds, written as new files, run through set-up, the window and the
    check, and read their metrics."""
    cell = tiny_cell(tmp_path, "c5-1m-mix.msg2s", n=1200, messages=2,
                     heartbeats=1, config_name="c5-small",
                     traffic_name="hb1")
    assert cell.name == "c5-small.hb1"
    t0 = time.perf_counter()
    run = window.run_cell(cell, 2**31 + 7, 0.5, True, "cpu", t0)
    assert run.cycles >= 1 and run.heartbeats == run.cycles
    ok, failed, rows = judge.check(cell, run.outputs, 2**31 + 7, "cpu")
    assert ok and failed == 0, rows
    e2e = bench_run.end_to_end(cell, run, 2**30)
    assert e2e["peak_device_gib"]["value"] == 1.0
    layer = bench_run.per_layer(cell, run)
    assert {"setup.build_s", "heartbeat_ms", "publish_ms.p90"} <= set(layer)
