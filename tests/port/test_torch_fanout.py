"""Fanout publish (gossipsub v1.1: an unsubscribed publisher sends to a
persistent fanout set) of the port against the reference, bitwise on every
DisseminationResult leaf and every state leaf: three publishes from an
unsubscribed peer (the set reused within the TTL, topped up after members
unsubscribe, rebuilt after heartbeats past the TTL), with and without
flood publish, with the score gates binding and under tcp loss; the
heartbeats with a partial subscription mask, with and without churn; and
the Simulator text with set_subscribed and an unsubscribed publisher."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import Topology, TopoParams
from dst_libp2p_test_node_tpu.ops import disseminate as jd
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.ops.heartbeat import run_heartbeats as jhb
from dst_libp2p_test_node_tpu.runtime import bandwidth as jbw
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import disseminate as td
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.ops.heartbeat import run_heartbeats as thb
from dst_libp2p_test_node_tpu_torch.runtime import bandwidth as tbw
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 120
PUB = 9          # unsubscribed in every world below
TTL_MS = 3000.0  # a short fanoutTTL, so a few heartbeats expire the set


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _torch_leaves(obj):
    return {f.name: getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)}


def _subscribed(seed=1):
    mask = np.random.default_rng(seed).random(N) < 0.75
    mask[PUB] = False
    return mask


class Pair:
    """Both packages' state side by side, stepped in lockstep and compared
    leaf by leaf after every step."""

    def __init__(self, loss=None, churn=0.0, **overrides):
        self.topo = Topology.build(TopoParams(
            network_size=N, anchor_stages=5, min_bandwidth=50,
            max_bandwidth=150, min_latency=40, max_latency=130,
            packet_loss=loss or 0.0))
        self.g = build_connection_graph(N, 10, seed=3, max_degree=40)
        kw = dict(proc_delay_ms=0.8, fanout_ttl_ms=TTL_MS,
                  churn_down_per_hb=churn, churn_up_per_hb=churn / 2,
                  **overrides)
        self.pj = jst.SimParams(n=N, capacity=self.g.capacity, **kw)
        self.pt = tst.SimParams(n=N, capacity=self.g.capacity, **kw)
        self.aj = jst.graph_arrays(self.g)
        self.at = tst.graph_arrays(self.g, "cpu")
        sj = jst.init_state(self.pj, 4).replace(
            subscribed=jnp.asarray(_subscribed()))
        self.sj = sj
        self.st = interop.state_from_numpy(_leaves(sj), "cpu")
        arrays = (self.topo.stage_of_peer, self.topo.latency_ms,
                  self.topo.bw_up_mbit)
        self.cj = [jnp.asarray(x) for x in arrays]
        self.ct = [torch.from_numpy(x) for x in arrays]
        self.loss_j = self.loss_t = None
        if loss:
            self.loss_j = jnp.asarray(self.topo.packet_loss)
            self.loss_t = torch.from_numpy(self.topo.packet_loss)
        self.heartbeats(10)

    def check_state(self):
        assert interop.leaf_mismatches(
            _leaves(self.sj), interop.state_to_numpy(self.st)) == []

    def heartbeats(self, steps):
        a, b = self.aj, self.at
        self.sj = jhb(self.sj, a["conns"], a["rev"], a["out_mask"], self.pj,
                      steps)
        self.st = thb(self.st, b["conns"], b["rev"], b["out_mask"], self.pt,
                      steps)
        self.check_state()

    def set_subscribed(self, mask):
        self.sj = self.sj.replace(subscribed=jnp.asarray(mask))
        self.st = self.st.replace(subscribed=torch.from_numpy(mask))

    def publish(self, dt, publisher=PUB, with_fanout=True):
        kw = dict(publisher=publisher, t0_ms=float(self.sj.t_ms) + dt,
                  payload_bytes=15000, with_fanout=with_fanout)
        rj, self.sj = jd.disseminate(
            self.sj, self.aj["conns"], self.aj["rev"], *self.cj,
            params=self.pj, loss_stage=self.loss_j, **kw)
        rt, self.st = td.disseminate(
            self.st, self.at["conns"], self.at["rev"], *self.ct,
            params=self.pt, loss_stage=self.loss_t, **kw)
        assert interop.leaf_mismatches(_leaves(rj), _torch_leaves(rt)) == []
        self.check_state()
        return rt

    def fanout_row(self):
        return self.st.fanout_mask[PUB].numpy().copy()


def _plant_scores(pair):
    """Give the publisher a -100 score of a third of its neighbours (the
    slow-peer counter at weight -1), so publishThreshold -50 binds."""
    conns = np.asarray(pair.aj["conns"])
    slow = np.zeros(pair.sj.slow_penalty.shape, np.float32)
    slots = np.nonzero(conns[PUB] >= 0)[0]
    slow[PUB, slots[::3]] = 100.0
    pair.sj = pair.sj.replace(slow_penalty=jnp.asarray(slow))
    pair.st = pair.st.replace(slow_penalty=torch.from_numpy(slow))
    return conns[PUB], slots[::3]


CASES = {
    "fanout": dict(flood_publish=False),
    "flood": dict(flood_publish=True),
    "gated": dict(flood_publish=False, slow_weight=-1.0,
                  publish_threshold=-50.0),
    "lossy_tcp": dict(flood_publish=False, loss=0.1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fanout_publishes_bitwise(case):
    kw = dict(CASES[case])
    pair = Pair(**kw)
    low = None
    if case == "gated":
        low = _plant_scores(pair)
    # t0 values float32 cannot hold: fanout_expire = f32(t0) + TTL, rounded
    r1 = pair.publish(250.3)
    row1 = pair.fanout_row()
    assert row1.sum() == pair.pt.d
    expire = float(pair.st.fanout_expire[PUB])
    assert expire == float(np.float32(np.float32(float(pair.sj.t_ms) + 250.3)
                                      + np.float32(TTL_MS)))
    assert bool(r1.received[~_subscribed()].sum() <= 1)
    if low is not None:
        # no member scored below publishThreshold
        assert not row1[low[1]].any()
    # within the TTL: the same set is reused
    pair.publish(900.7)
    assert (pair.fanout_row() == row1).all()
    # two members unsubscribe: the set is topped back up to D
    conns = pair.at["conns"].numpy()[PUB]
    gone = conns[np.nonzero(row1)[0][:2]]
    mask = _subscribed()
    mask[gone] = False
    pair.set_subscribed(mask)
    pair.publish(1500.2)
    row3 = pair.fanout_row()
    assert row3.sum() == pair.pt.d and (row3 != row1).any()
    assert (row3 & row1).sum() == pair.pt.d - 2
    # heartbeats past the TTL drop the set; the next publish draws afresh
    pair.heartbeats(int(TTL_MS // 1000) + 3)
    assert not pair.fanout_row().any()
    pair.publish(300.9)
    assert pair.fanout_row().sum() == pair.pt.d


@pytest.mark.parametrize("churn", [0.0, 0.02])
def test_heartbeats_with_partial_subscription_bitwise(churn):
    pair = Pair(churn=churn)
    mesh = pair.st.mesh_mask.numpy()
    conns = pair.at["conns"].numpy()
    unsub = ~_subscribed()
    # no mesh link to an unsubscribed peer
    assert not (mesh & unsub[np.clip(conns, 0, None)] & (conns >= 0)).any()
    assert not mesh[unsub].any()
    pair.heartbeats(25)


def _sim_outputs(sim, bw):
    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return (buf.getvalue(), "\n".join(bw.shadowlog_lines(sim.traffic())),
            sim.summary_report() + sim.bandwidth_report())


def test_simulator_with_unsubscribed_publisher_text():
    topo = TopoParams(network_size=N, anchor_stages=5, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=15000, messages=1, delay_seconds=2.0)
    kw = dict(topo=topo, seed=2, warmup_s=15.0, serialize_answers=False,
              self_trigger=True)
    sims = (jsim.Simulator(jsim.ExperimentConfig(**kw)),
            tsim.Simulator(tsim.ExperimentConfig(**kw), device="cpu"))
    mask = _subscribed(5)
    for sim in sims:
        sim.set_subscribed(mask)     # pre-warm-up: the startup membership
        sim.warmup()
        for i, pub in enumerate((PUB, PUB, 30, PUB)):
            if i:
                sim.advance(1700.0)
            rec = sim.publish(pub)
            # an unsubscribed origin never logs its own message
            assert not rec.received[PUB]
        mask2 = mask.copy()
        mask2[[3, 4]] = ~mask2[[3, 4]]
        sim.set_subscribed(mask2)    # mid-run: one event per flip
        sim.publish(PUB)
    (j, t) = sims
    assert _sim_outputs(t, tbw) == _sim_outputs(j, jbw)
    assert (t._sub_events_np == j._sub_events_np).all()
    assert (t._unsub_events_np == j._unsub_events_np).all()
    assert t._unsub_events_np.sum() + t._sub_events_np.sum() \
        == mask.sum() + 2
    assert interop.leaf_mismatches(
        _leaves(j.state), interop.state_to_numpy(t.state)) == []
    t.reset()
    assert t._subscribed_np.all() and t._unsub_events_np.sum() == 0
