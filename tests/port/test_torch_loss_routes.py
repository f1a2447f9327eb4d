"""Lossy publishes (loss_stage, both loss models) of the port's disseminate
against the reference, bitwise on every DisseminationResult leaf (lost_tx
included) and every leaf of the new state over two publishes in a row, in
each route the exact mode takes: the fast pipeline kept, the prefix engine,
the serial engine sender-side and, with the pull budget lowered in both
packages, receiver-side, and the capped prefix->serial fallback; then
bounded mode on both fixpoint formulations. Each case checks that the
route really ran (engine counts) and that loss was live."""

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

N = 150
LOSS = 0.1
# the gossip-heavy setting that makes queued answers first deliveries
GOSSIP_HEAVY = dict(flood_publish=False, d_lazy=12)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _torch_leaves(obj):
    return {f.name: getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)}


def _world(seed=2, **overrides):
    topo = Topology.build(TopoParams(
        network_size=N, anchor_stages=5, min_bandwidth=50,
        max_bandwidth=150, min_latency=40, max_latency=130,
        packet_loss=LOSS))
    g = build_connection_graph(N, 10, seed=seed, max_degree=40)
    kw = dict(proc_delay_ms=0.8, **overrides)
    pj = jst.SimParams(n=N, capacity=g.capacity, **kw)
    pt = tst.SimParams(n=N, capacity=g.capacity, **kw)
    aj = jst.graph_arrays(g)
    sj = run_heartbeats(jst.init_state(pj, seed), aj["conns"], aj["rev"],
                        aj["out_mask"], pj, 12)
    return topo, g, pj, pt, aj, sj


def publish_twice(world, fragments, loss_mode):
    """Both packages, two lossy publishes in a row, every leaf bitwise.
    Returns the port's results and the engine counts its dispatch took."""
    topo, g, pj, pt, aj, sj = world
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    at = tst.graph_arrays(g, "cpu")
    arrays = (topo.stage_of_peer, topo.latency_ms, topo.bw_up_mbit,
              topo.packet_loss)
    *consts_j, loss_j = [jnp.asarray(x) for x in arrays]
    *consts_t, loss_t = [torch.from_numpy(x) for x in arrays]
    td.reset_engine_counts()
    results = []
    t_base = float(sj.t_ms)
    for publisher, dt in ((7, 250.5), (40, 900.25)):
        kw = dict(publisher=publisher, t0_ms=t_base + dt,
                  payload_bytes=15000, fragments=fragments,
                  loss_mode=loss_mode)
        rj, sj = jd.disseminate(sj, aj["conns"], aj["rev"], *consts_j,
                                params=pj, loss_stage=loss_j, **kw)
        rt, st = td.disseminate(st, at["conns"], at["rev"], *consts_t,
                                params=pt, loss_stage=loss_t, **kw)
        assert interop.leaf_mismatches(_leaves(rj), _torch_leaves(rt)) == []
        assert interop.leaf_mismatches(
            _leaves(sj), interop.state_to_numpy(st)) == []
        results.append(rt)
    assert all(bool(r.converged) for r in results)
    return results, dict(td.engine_counts)


def _assert_loss_live(results, loss_mode):
    """Message mode loses copies outright; tcp mode at 10% loss abandons
    almost none (p^7) but its stalls still deliver every reachable peer."""
    lost = sum(int(r.lost_tx.sum()) for r in results)
    sent = sum(int(r.sends.sum()) for r in results)
    if loss_mode == "message":
        assert 0.03 * sent < lost < 0.2 * sent, (lost, sent)
    else:
        assert lost <= 0.001 * sent, (lost, sent)
    assert all(int(r.received.sum()) > N // 2 for r in results)


@pytest.fixture
def lowered_budget(monkeypatch):
    monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
    monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
    jd.disseminate.clear_cache()
    yield
    monkeypatch.undo()
    jd.disseminate.clear_cache()


@pytest.mark.parametrize("loss_mode,fragments,mode,engine", [
    ("tcp", 1, "parallel_prefix", "prefix"),
    ("message", 3, "parallel_prefix", "prefix"),
    ("message", 1, "serial", "serial"),
    ("tcp", 3, "serial", "serial"),
])
def test_exact_engines_sender_side(loss_mode, fragments, mode, engine):
    res, counts = publish_twice(
        _world(answer_queue_mode=mode, **GOSSIP_HEAVY), fragments, loss_mode)
    assert counts[engine] == 2, counts
    assert max(int(r.refine_passes) for r in res) > 0
    _assert_loss_live(res, loss_mode)


@pytest.mark.parametrize("loss_mode,fragments", [("tcp", 3), ("message", 1)])
def test_exact_serial_receiver_side(loss_mode, fragments, lowered_budget):
    res, counts = publish_twice(_world(**GOSSIP_HEAVY), fragments, loss_mode)
    assert counts["serial"] == 2 and counts["prefix"] == 0, counts
    _assert_loss_live(res, loss_mode)


def test_fast_pipeline_kept_lossy():
    # default GossipSub settings (flood publish): no queued answer is a
    # first delivery in either publish, so the fast pipeline's times stand
    res, counts = publish_twice(_world(seed=5), 1, "tcp")
    assert counts["fast"] == 2, counts
    assert all(int(r.refine_passes) == 0 for r in res)
    _assert_loss_live(res, "tcp")


def test_capped_prefix_falls_back_to_serial_lossy():
    res, counts = publish_twice(
        _world(max_relax_iters=3, **GOSSIP_HEAVY), 1, "message")
    assert counts["prefix_fallback"] > 0, counts
    assert max(int(r.refine_passes) for r in res) > 3


@pytest.mark.parametrize("budget", ["default", "lowered"])
def test_bounded_mode_lossy(budget, monkeypatch):
    if budget == "lowered":
        monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
        monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
        jd.disseminate.clear_cache()
    try:
        loss_mode, fragments = (("message", 3) if budget == "default"
                                else ("tcp", 1))
        res, counts = publish_twice(_world(serialize_answers=False),
                                    fragments, loss_mode)
    finally:
        monkeypatch.undo()
        jd.disseminate.clear_cache()
    assert sum(counts.values()) == 0
    _assert_loss_live(res, loss_mode)
