"""Simulator(mesh=) and MultiTopicSimulator(mesh=) on a peer mesh of 2
gloo CPU ranks (runtime/sharded.py) against the reference's
single-device Simulator, at the cases of tests/test_sharded_sim.py
(lossless, 2 fragments, tcp loss, bounded mode, multi-topic, uneven rows
rejected), the sharded warm start of tests/test_warm_start.py and one
churned configuration:

  - `received` and `sends` bitwise;
  - delays bitwise against the reference run with answer_queue_mode
    "serial" (the refinement engine a mesh takes), and within rtol 1e-5
    of the reference's default engine (the reference's own pin for a
    sharded run, tests/test_sharded_sim.py:37);
  - every state leaf of the mesh run equal to the port's one-device run
    of the same configuration;
  - the handle's set_subscribed, rebind_graph and reset reach the ranks;
  - the row placers (place_simulation, shard_simulation, reshard_rows)
    split rows and replicate the rest, with the reference's uneven-rows
    ValueError.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.runtime import multitopic as jmt
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import disseminate as td
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.parallel import sharding as tsh
from dst_libp2p_test_node_tpu_torch.runtime import multitopic as tmt
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim
from dst_libp2p_test_node_tpu_torch.runtime.sharded import ShardedSimulator

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh(cpu_mesh):
    return cpu_mesh


_TOPO = dict(network_size=64, anchor_stages=2, min_bandwidth=50,
             max_bandwidth=100, min_latency=40, max_latency=80,
             msg_size_bytes=2000)

# name -> (topo overrides, ExperimentConfig overrides)
CASES = {
    "lossless": ({}, {}),
    "fragments": ({"num_frags": 2}, {}),
    "tcp_loss": ({"packet_loss": 0.3}, {"loss_mode": "tcp"}),
    "bounded": ({"packet_loss": 0.3}, {"loss_mode": "message",
                                       "serialize_answers": False}),
    "churn": ({"num_frags": 2}, {"churn_down_per_hb": 0.05,
                                 "churn_up_per_hb": 0.025}),
}


def _cfgs(topo_kw, kw, mode=None):
    base = dict(connect_to=6, warmup_s=3.0, seed=11, **kw)
    if mode is not None:
        base["answer_queue_mode"] = mode
    return (tsim.ExperimentConfig(topo=TTopo(**_TOPO, **topo_kw), **base),
            jsim.ExperimentConfig(topo=JTopo(**_TOPO, **topo_kw), **base))


def _publishes(sim):
    sim.warmup()
    recs = [sim.publish(4)]
    sim.advance(1500.0)
    recs.append(sim.publish(5))
    return recs


def _same(a, b, exact_delays=True):
    np.testing.assert_array_equal(a.received, b.received)
    np.testing.assert_array_equal(a.sends, b.sends)
    if exact_delays:
        assert a.delays_ms.tobytes() == b.delays_ms.tobytes()
    else:
        np.testing.assert_allclose(a.delays_ms, b.delays_ms, rtol=1e-5)


def _same_state(a, b):
    bad = interop.leaf_mismatches(interop.state_to_numpy(a),
                                  interop.state_to_numpy(b))
    assert bad == []


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_simulator_matches_single_device(mesh, case):
    topo_kw, kw = CASES[case]
    exact = kw.get("serialize_answers", True)
    tcfg, jcfg_serial = _cfgs(topo_kw, kw, mode="serial")
    sim = tsim.Simulator(tcfg, mesh=mesh)
    assert isinstance(sim, ShardedSimulator) and sim.backend == "gloo"
    got = _publishes(sim)
    for a, b in zip(_publishes(jsim.Simulator(jcfg_serial)), got):
        _same(a, b)
        assert a.ihave == b.ihave and a.iwant == b.iwant
        assert a.answer_wait_max_ms == b.answer_wait_max_ms
    if exact:
        # the reference's default engine (parallel_prefix): its own pin
        _, jcfg = _cfgs(topo_kw, kw)
        for a, b in zip(_publishes(jsim.Simulator(jcfg)), got):
            _same(a, b, exact_delays=False)
    one = tsim.Simulator(copy.deepcopy(tcfg), device="cpu")
    _publishes(one)
    _same_state(one.state, sim.state)
    sim.close()


def test_sharded_warm_equals_cold_and_single_device(mesh):
    topo = dict(network_size=200, anchor_stages=3, min_bandwidth=50,
                max_bandwidth=150, min_latency=40, max_latency=130,
                msg_size_bytes=2000, messages=2, delay_seconds=1.0)

    def run(warm, sim_cls, topo_cls, cfg_cls, **extra):
        sim = sim_cls(cfg_cls(topo=topo_cls(**topo), connect_to=6,
                              warmup_s=5.0, seed=3, warm_start=warm,
                              serialize_answers=False), **extra)
        sim.warmup()
        r1 = sim.publish(4, msg_size=2000)
        sim.advance(1500.0)
        r2 = sim.publish(5, msg_size=2000)
        return [r1, r2]

    td.reset_engine_counts()
    warm_sh = run(True, tsim.Simulator, TTopo, tsim.ExperimentConfig,
                  mesh=mesh)
    assert td.engine_counts["warm_certified"] >= 1
    cold_sh = run(False, tsim.Simulator, TTopo, tsim.ExperimentConfig,
                  mesh=mesh)
    cold_1d = run(False, jsim.Simulator, JTopo, jsim.ExperimentConfig)
    for a, b, c in zip(warm_sh, cold_sh, cold_1d):
        _same(a, b)
        np.testing.assert_array_equal(a.copies_rx, b.copies_rx)
        _same(c, a)


def _mt_cfg(mod, topo_cls, n=48, topics=("blocks", "attestations")):
    return mod.MultiTopicConfig(
        topo=topo_cls(network_size=n, anchor_stages=2, min_bandwidth=50,
                      max_bandwidth=100, min_latency=40, max_latency=80,
                      msg_size_bytes=15000),
        topics=topics, connect_to=6, subscribe_fraction=0.8, warmup_s=3.0,
        seed=11)


def test_sharded_multitopic_matches_single_device(mesh):
    # two topics published back to back: the cross-topic uplink fold runs
    # on the ranks' rows (all-gathered, folded, each rank keeps its rows)
    def run(sim):
        sim.warmup()
        return [sim.publish("blocks", 7), sim.publish("attestations", 7)]

    sim = tmt.MultiTopicSimulator(_mt_cfg(tmt, TTopo), mesh=mesh)
    got = run(sim)
    for a, b in zip(run(jmt.MultiTopicSimulator(_mt_cfg(jmt, JTopo))), got):
        _same(a, b, exact_delays=False)
    one = tmt.MultiTopicSimulator(_mt_cfg(tmt, TTopo), device="cpu")
    for a, b in zip(run(one), got):
        _same(a, b, exact_delays=False)
    assert sim.mesh_sizes() == one.mesh_sizes()
    assert sim.rank_rows == [(0, 48), (48, 96)]
    sim.close()


def test_uneven_shard_rejected(mesh):
    with pytest.raises(ValueError, match="divide evenly"):
        tsim.Simulator(tsim.ExperimentConfig(
            topo=TTopo(network_size=63), connect_to=6), mesh=mesh)
    with pytest.raises(ValueError, match="divide evenly"):
        tmt.MultiTopicSimulator(
            _mt_cfg(tmt, TTopo, n=31, topics=("a", "b", "c")), mesh=mesh)
    with pytest.raises(TypeError, match="PeerMesh"):
        tsim.Simulator(tsim.ExperimentConfig(
            topo=TTopo(network_size=64), connect_to=6), mesh=object())


def test_handle_calls_reach_the_ranks(mesh):
    # set_subscribed (an unsubscribed publisher: the fanout path),
    # rebind_graph and reset on the handle equal the one-device calls
    tcfg, _ = _cfgs({}, {}, mode="serial")
    sims = [tsim.Simulator(copy.deepcopy(tcfg), mesh=mesh),
            tsim.Simulator(copy.deepcopy(tcfg), device="cpu")]
    mask = np.random.default_rng(5).random(64) < 0.75
    mask[9] = False
    recs = []
    for sim in sims:
        sim.set_subscribed(mask)
        sim.warmup()
        recs.append(sim.publish(9))
        g = sim.graph
        conns = g.conns.copy()
        conns[conns == 3] = -1          # isolate peer 3, both directions
        conns[3] = -1
        rev = np.where(conns >= 0, g.rev, -1)
        sim.rebind_graph(conns, rev, g.out_mask & (conns >= 0))
        recs.append(sim.publish(4))
    _same(recs[0], recs[2])
    _same(recs[1], recs[3])
    assert not recs[1].received[3]
    np.testing.assert_array_equal(sims[0]._sub_events_np,
                                  sims[1]._sub_events_np)
    _same_state(sims[1].state, sims[0].state)
    for sim in sims:
        sim.reset()
    assert sims[0].records == [] and sims[0]._t_now() == 0.0
    _same_state(sims[1].state, sims[0].state)
    for f in dataclasses.fields(sims[1].state):
        assert getattr(sims[0].state, f.name).device.type == "cpu"
    sims[0].close()


def test_row_placers(mesh):
    params = tst.SimParams(n=64, capacity=8)
    st = tst.init_state(params, seed=2, device="cpu")
    arrays = {"conns": torch.arange(64 * 8).reshape(64, 8)}
    stage = torch.arange(64)
    lat = torch.ones(3, 3)
    per = tsh.place_simulation(st, arrays, stage, lat, torch.ones(3), None,
                               mesh)
    assert len(per) == 2
    for r, (s, a, sg, la, bw, loss) in enumerate(per):
        rows = slice(32 * r, 32 * (r + 1))
        assert torch.equal(s.hb_phase, st.hb_phase[rows])
        assert torch.equal(s.mesh_mask, st.mesh_mask[rows])
        assert torch.equal(s.key, st.key) and torch.equal(s.t_ms, st.t_ms)
        assert torch.equal(a["conns"], arrays["conns"][rows])
        assert torch.equal(sg, stage[rows]) and la is lat and loss is None
    assert [b.tolist() for b in tsh.reshard_rows(np.arange(4), mesh)] == \
        [[0, 1], [2, 3]]
    odd = tst.init_state(tst.SimParams(n=63, capacity=8), device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        tsh.place_simulation(odd, {}, stage[:63], lat, lat, None, mesh)
