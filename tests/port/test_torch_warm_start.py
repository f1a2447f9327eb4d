"""Cross-publish warm start (SimParams.warm_start) of the port against the
reference: the Simulator text of a warm run equals the reference's warm
run and the port's own cold run byte for byte, in bounded and exact mode
and on the receiver-side fixpoint; churn and set_subscribed invalidate the
carry; a poisoned carry is rejected by the certificate and the message
reruns cold (engine_counts shows which way each message went), bitwise
against the reference's cold rerun."""

import dataclasses
import io

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
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import disseminate as td
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 150
INVALID = 1e30


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _torch_leaves(obj):
    return {f.name: getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)}


def _kw(warm, **overrides):
    topo = TopoParams(network_size=N, anchor_stages=5, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=15000, num_frags=1, messages=3,
                      delay_seconds=2.0)
    kw = dict(topo=topo, seed=3, warmup_s=20.0, warm_start=warm,
              publisher_rotation=True)
    kw.update(overrides)
    return kw


def _text(sim):
    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return buf.getvalue()


def _port_run(warm, **overrides):
    td.reset_engine_counts()
    sim = tsim.Simulator(tsim.ExperimentConfig(**_kw(warm, **overrides)),
                         device="cpu")
    sim.run()
    return sim, dict(td.engine_counts)


@pytest.mark.parametrize("mode,budget", [("bounded", "default"),
                                         ("exact", "default"),
                                         ("bounded", "lowered")])
def test_warm_equals_cold_and_the_reference(mode, budget, monkeypatch):
    ov = dict(serialize_answers=(mode == "exact"))
    if budget == "lowered":
        monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
        monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
        jd.disseminate.clear_cache()
    try:
        ref = jsim.Simulator(jsim.ExperimentConfig(**_kw(True, **ov)))
        ref.run()
        warm, counts = _port_run(True, **ov)
        cold, cold_counts = _port_run(False, **ov)
    finally:
        monkeypatch.undo()
        jd.disseminate.clear_cache()
    assert _text(warm) == _text(ref)
    assert _text(warm) == _text(cold)
    assert interop.leaf_mismatches(
        _leaves(ref.state), interop.state_to_numpy(warm.state)) == []
    # every message took one of the two warm outcomes; the first publish
    # has no carry (INF seeds) and certifies trivially
    assert counts["warm_certified"] + counts["warm_cold_rerun"] == 3
    assert counts["warm_certified"] >= 1
    assert cold_counts["warm_certified"] + cold_counts["warm_cold_rerun"] == 0
    assert float(warm.state.warm_offset_ms.max()) < INVALID


def test_churn_invalidates_the_carry():
    ov = dict(churn_down_per_hb=0.05, churn_up_per_hb=0.025,
              serialize_answers=False)
    ref = jsim.Simulator(jsim.ExperimentConfig(**_kw(True, **ov)))
    ref.run()
    warm, _ = _port_run(True, **ov)
    cold, _ = _port_run(False, **ov)
    assert _text(warm) == _text(ref) == _text(cold)
    assert float(warm.state.warm_offset_ms.min()) < INVALID
    warm.advance(1500.0)
    assert float(warm.state.warm_offset_ms.min()) > INVALID


def test_set_subscribed_invalidates_the_carry():
    ov = dict(serialize_answers=False)
    warm, _ = _port_run(True, **ov)
    cold, _ = _port_run(False, **ov)
    assert float(warm.state.warm_offset_ms.min()) < INVALID
    sub = warm._subscribed_np.copy()
    sub[7] = False
    for sim in (warm, cold):
        sim.set_subscribed(sub)
    assert float(warm.state.warm_offset_ms.min()) > INVALID
    td.reset_engine_counts()
    a, b = warm.publish(4), cold.publish(4)
    assert np.array_equal(a.delays_ms, b.delays_ms)
    assert td.engine_counts["warm_certified"] == 1


@pytest.mark.parametrize("mode", ["bounded", "exact"])
def test_poisoned_carry_reruns_cold_bitwise(mode):
    # a negative offset claims every peer heard the message before it was
    # sent: an undershot seed the min-only relaxation cannot raise, which
    # the certificate must reject
    g = build_connection_graph(N, 10, seed=2, max_degree=40)
    topo = Topology.build(TopoParams(network_size=N, anchor_stages=5,
                                     min_bandwidth=50, max_bandwidth=150,
                                     min_latency=40, max_latency=130))
    kw = dict(serialize_answers=(mode == "exact"), warm_start=True,
              proc_delay_ms=0.8)
    pj = jst.SimParams(n=N, capacity=g.capacity, **kw)
    pt = tst.SimParams(n=N, capacity=g.capacity, **kw)
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    sj = run_heartbeats(jst.init_state(pj, 2), aj["conns"], aj["rev"],
                        aj["out_mask"], pj, 10)
    sj = sj.replace(warm_offset_ms=jnp.full((N,), -5000.0, jnp.float32))
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    arrays = (topo.stage_of_peer, topo.latency_ms, topo.bw_up_mbit)
    args = dict(publisher=0, t0_ms=float(sj.t_ms) + 125.5,
                payload_bytes=15000)
    rj, nj = jd.disseminate(sj, aj["conns"], aj["rev"],
                            *[jnp.asarray(x) for x in arrays], params=pj,
                            **args)
    consts = [torch.from_numpy(x) for x in arrays]
    td.reset_engine_counts()
    rt, nt = td.disseminate(st, at["conns"], at["rev"], *consts, params=pt,
                            **args)
    assert td.engine_counts["warm_cold_rerun"] == 1
    assert td.engine_counts["warm_certified"] == 0
    assert interop.leaf_mismatches(_leaves(rj), _torch_leaves(rt)) == []
    assert interop.leaf_mismatches(_leaves(nj),
                                   interop.state_to_numpy(nt)) == []
    cold, _ = td.disseminate(st, at["conns"], at["rev"], *consts,
                             params=dataclasses.replace(pt, warm_start=False),
                             **args)
    assert torch.equal(rt.t_rx_ms, cold.t_rx_ms)
    assert bool(rt.converged) and bool(rt.received.all())
