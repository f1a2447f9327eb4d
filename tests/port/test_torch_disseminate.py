"""The port's disseminate (ops/disseminate.py, bounded delivery mode)
against the reference: every DisseminationResult leaf and every leaf of the
new state, bitwise, for one and two fragments, with and without gossip, at
the default pull budget (sender-side fixpoint) and with the budget lowered
in both packages (the receiver-side fixpoint of the 1M-peer class, whose
sweep runs the vmem_gather path). Two publishes in a row, so the second
sees the uplink/downlink occupancy the first wrote back."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dst_libp2p_test_node_tpu.ops.pull as jpull
import dst_libp2p_test_node_tpu_torch.ops.pull as tpull
from dst_libp2p_test_node_tpu.config.topology import Topology, TopoParams
from dst_libp2p_test_node_tpu.ops import disseminate as jd
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.ops.heartbeat import run_heartbeats
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import disseminate as td
from dst_libp2p_test_node_tpu_torch.ops import state as tst

torch.set_num_threads(1)

N = 100


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _torch_leaves(obj):
    return {f.name: getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)}


@pytest.fixture
def lowered_budget(monkeypatch):
    monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
    monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
    jd.disseminate.clear_cache()
    yield
    monkeypatch.undo()
    jd.disseminate.clear_cache()


def _world(seed=2, **overrides):
    topo = Topology.build(TopoParams(
        network_size=N, anchor_stages=5, min_bandwidth=50,
        max_bandwidth=150, min_latency=40, max_latency=130))
    g = build_connection_graph(N, 10, seed=seed, max_degree=40)
    kw = dict(serialize_answers=False, proc_delay_ms=0.8, **overrides)
    pj = jst.SimParams(n=N, capacity=g.capacity, **kw)
    pt = tst.SimParams(n=N, capacity=g.capacity, **kw)
    aj = jst.graph_arrays(g)
    sj = run_heartbeats(jst.init_state(pj, seed), aj["conns"], aj["rev"],
                        aj["out_mask"], pj, 12)
    return topo, g, pj, pt, aj, sj


def _publish_twice(fragments, with_gossip, **overrides):
    topo, g, pj, pt, aj, sj = _world(**overrides)
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    at = tst.graph_arrays(g, "cpu")
    consts_j = [jnp.asarray(x) for x in (topo.stage_of_peer, topo.latency_ms,
                                         topo.bw_up_mbit)]
    consts_t = [torch.from_numpy(x) for x in (topo.stage_of_peer,
                                              topo.latency_ms,
                                              topo.bw_up_mbit)]
    for publisher, t0 in ((7, float(sj.t_ms) + 250.5), (40, float(sj.t_ms)
                                                        + 900.25)):
        kw = dict(publisher=publisher, t0_ms=t0, payload_bytes=15000,
                  fragments=fragments, with_gossip=with_gossip)
        rj, sj = jd.disseminate(sj, aj["conns"], aj["rev"], *consts_j,
                                params=pj, **kw)
        rt, st = td.disseminate(st, at["conns"], at["rev"], *consts_t,
                                params=pt, **kw)
        assert interop.leaf_mismatches(_leaves(rj), _torch_leaves(rt)) == []
        assert interop.leaf_mismatches(
            _leaves(sj), interop.state_to_numpy(st)) == []
    assert bool(rt.converged) and bool(rt.received.all())
    return rt


@pytest.mark.parametrize("fragments", [1, 2])
def test_bounded_mode_bitwise_sender_side(fragments):
    res = _publish_twice(fragments, True)
    assert int(res.iwant_sent.sum()) >= 0 and int(res.sends.sum()) > N


@pytest.mark.parametrize("fragments", [1, 2])
def test_bounded_mode_bitwise_receiver_side(fragments, lowered_budget):
    _publish_twice(fragments, True)


def test_no_gossip_and_first_sender_kept_bitwise(lowered_budget):
    _publish_twice(1, False)
    _publish_twice(1, True, exclude_first_sender=False)


def test_outside_the_slice_raises():
    topo, g, _, pt, _, _ = _world()
    st = tst.init_state(pt, 0, "cpu")
    at = tst.graph_arrays(g, "cpu")
    args = (st, at["conns"], at["rev"], torch.from_numpy(topo.stage_of_peer),
            torch.from_numpy(topo.latency_ms),
            torch.from_numpy(topo.bw_up_mbit))
    kw = dict(publisher=1, t0_ms=0.0, params=pt, payload_bytes=15000)
    for extra, slice_name in ((dict(return_plan=True), "tooling"),
                              (dict(mesh=object()), "multi-GPU")):
        with pytest.raises(NotImplementedError, match=slice_name):
            td.disseminate(*args, **kw, **extra)
    # censor_edge is ported now (the campaign slice): every edge censored,
    # nothing leaves the publisher
    res, _ = td.disseminate(*args, **kw, censor_edge=at["conns"] >= 0)
    assert int(res.received.sum()) == 1 and bool(res.received[1])
    # a lossy topology is ported now (slice 4): the call runs
    res, _ = td.disseminate(*args, **kw, loss_stage=torch.full((6, 6), 0.5),
                            loss_mode="message")
    assert int(res.lost_tx.sum()) > 0
    # fanout publish and warm start are ported now (slice 5): they run
    res, new = td.disseminate(*args, **kw, with_fanout=True)
    assert bool(new.fanout_mask[1].any()) and bool(res.received[1])
    td.reset_engine_counts()
    warm = dataclasses.replace(pt, warm_start=True)
    td.disseminate(*args, publisher=1, t0_ms=0.0, params=warm,
                   payload_bytes=15000)
    assert td.engine_counts["warm_certified"] == 1
