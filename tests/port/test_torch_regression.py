"""The port's regression workload (dst_libp2p_test_node_tpu_torch/runtime/
regression_runtime.py) against the reference's, bitwise on the CPU: the
DHT-sampled graph, and whole RegressionSimulator runs (kad state after
discovery, GossipSub state leaves, message records, ping records, log
lines, summary), sender-side and with the fixpoints receiver-side. The
reference swaps the discovered graph into a Simulator built on a shuffle
graph and keeps that graph's edge tables; the port keeps the same stale
tables."""

import dataclasses

import numpy as np
import pytest
import torch

import dst_libp2p_test_node_tpu.ops.pull as jpull
import dst_libp2p_test_node_tpu_torch.ops.pull as tpull
from dst_libp2p_test_node_tpu.ops.disseminate import disseminate as jdis
from dst_libp2p_test_node_tpu.runtime import regression_runtime as jrr
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops.disseminate import edge_tables
from dst_libp2p_test_node_tpu_torch.runtime import regression_runtime as trr

torch.set_num_threads(1)


def _state_leaves(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _record_fields(rec, names):
    """The reference record's fields (the port's record adds two)."""
    return [(k, v.tobytes() if isinstance(v, np.ndarray) else v)
            for k in names for v in (getattr(rec, k),)]


@pytest.mark.parametrize("budget,fragments", [("default", 1),
                                              ("lowered", 2)])
def test_regression_simulator_matches_reference(budget, fragments,
                                                monkeypatch):
    kw = dict(network_size=48, n_bootstrap=1, connect_to=6, messages=3,
              msg_size=1500, fragments=fragments, ping_rounds=2,
              discovery_rounds=2, start_sleep_s=40.0, delay_seconds=2.0,
              seed=1)
    if budget == "lowered":
        monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
        monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
        jdis.clear_cache()
    try:
        js = jrr.RegressionSimulator(jrr.RegressionConfig(**kw))
        ts = trr.RegressionSimulator(trr.RegressionConfig(**kw),
                                     device="cpu")
        jsum, tsum = js.run(), ts.run()
    finally:
        monkeypatch.undo()
        jdis.clear_cache()
    assert interop.leaf_mismatches(interop.leaves_to_numpy(js.kstate),
                                   interop.leaves_to_numpy(ts.kstate)) == []
    for f in ("conns", "rev", "out_mask", "degree"):
        a, b = getattr(js.sim.graph, f), getattr(ts.sim.graph, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert interop.leaf_mismatches(
        _state_leaves(js.sim.state),
        interop.state_to_numpy(ts.sim.state)) == []
    names = [f.name for f in dataclasses.fields(js.records()[0])]
    assert ([_record_fields(r, names) for r in js.records()]
            == [_record_fields(r, names) for r in ts.records()])
    assert ([dataclasses.astuple(p) for p in js.pings]
            == [dataclasses.astuple(p) for p in ts.pings])
    assert js.lines == ts.lines
    assert jsum.report() == tsum.report()
    # the edge tables are the shuffle graph's, not the discovered one's
    lat_edge = np.asarray(js.sim._lat_edge)
    assert lat_edge.tobytes() == ts.sim._lat_edge.numpy().tobytes()
    fresh, _ = edge_tables(ts.sim._stage, ts.sim._lat,
                           ts.sim.arrays["conns"], ts.sim.arrays["rev"])
    assert fresh.numpy().tobytes() != lat_edge.tobytes()


def test_discovery_graph_copy():
    cfg = dict(network_size=40, n_bootstrap=2, connect_to=5, seed=3,
               discovery_rounds=2)
    js = jrr.RegressionSimulator(jrr.RegressionConfig(**cfg))
    ts = trr.RegressionSimulator(trr.RegressionConfig(**cfg), device="cpu")
    js.discover()
    ts.discover()
    # a sparse table forces the anchor-and-ring padding branch
    rt = np.asarray(js.kstate.rtable).copy()
    rt[5:9] = -1
    js.kstate = js.kstate.replace(rtable=rt)
    ts.kstate = ts.kstate.replace(rtable=torch.from_numpy(rt))
    a = jrr.discovery_graph(js.kstate, 5, np.array([0, 1]), 3)
    b = trr.discovery_graph(ts.kstate, 5, np.array([0, 1]), 3)
    for f in ("conns", "rev", "out_mask", "degree"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f


def test_config_from_env(monkeypatch):
    for k, v in (("PEERS", "64"), ("CONNECTTO", "7"), ("STARTSLEEP", "60"),
                 ("FRAGMENTS", "2"), ("MUXER", "quic")):
        monkeypatch.setenv(k, v)
    assert (dataclasses.asdict(trr.config_from_env())
            == dataclasses.asdict(jrr.config_from_env()))
    assert (dataclasses.asdict(trr.regression_gossipsub_params())
            == dataclasses.asdict(jrr.regression_gossipsub_params()))
