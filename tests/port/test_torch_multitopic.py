"""The port's MultiTopicSimulator (runtime/multitopic.py) against the
reference, bitwise: every state leaf after the warm-up and after each
publish (the block-diagonal stacked graph, the seeded subscription draw,
the tiled per-node heartbeat phase, the cross-topic uplink/downlink fold),
every MessageRecord array of each topic's publish (exact mode, an
unsubscribed publisher included), mesh_sizes and topic_health; and
publish_batch across topics (test_torch_batch.py has the rest)."""

import dataclasses

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams
from dst_libp2p_test_node_tpu.runtime import multitopic as jmt
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.runtime import multitopic as tmt

torch.set_num_threads(1)

N = 100
TOPICS = ("blocks", "attestations", "sync")


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _kw(**overrides):
    kw = dict(topo=TopoParams(network_size=N, anchor_stages=5,
                              min_bandwidth=50, max_bandwidth=150,
                              min_latency=40, max_latency=130,
                              msg_size_bytes=2000),
              topics=TOPICS, subscribe_fraction=0.75, warmup_s=15.0, seed=3)
    kw.update(overrides)
    return kw


@pytest.fixture(scope="module")
def sims():
    j = jmt.MultiTopicSimulator(jmt.MultiTopicConfig(**_kw()))
    t = tmt.MultiTopicSimulator(tmt.MultiTopicConfig(**_kw()), device="cpu")
    return j, t


def _same_state(j, t):
    assert interop.leaf_mismatches(
        _leaves(j.state), interop.state_to_numpy(t.state)) == []


def _same_record(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


def test_subscription_draw_and_warmup_state(sims):
    j, t = sims
    assert (t.subscribed_np == j.subscribed_np).all()
    assert 0.6 < t.subscribed_np.mean() < 0.9
    for k in ("conns", "rev", "out_mask"):
        assert (t.arrays[k].numpy() == np.asarray(j.arrays[k])).all(), k
    _same_state(j, t)
    phase = t.states.hb_phase.numpy()
    assert (phase == phase[0]).all()          # one phase per node
    j.warmup()
    t.warmup()
    _same_state(j, t)
    assert t.states.mesh_mask.shape == (len(TOPICS), N, t.graph.capacity)


def test_per_topic_records_and_cross_topic_fold(sims):
    j, t = sims
    if float(t.state.t_ms) == 0.0:
        j.warmup()
        t.warmup()
    for ti, topic in enumerate(TOPICS):
        pub = int(np.nonzero(t.subscribed_np[ti])[0][4])
        a, b = j.publish(topic, pub), t.publish(topic, pub)
        _same_record(a, b)
        assert b.converged
        _same_state(j, t)
        # one uplink and downlink per physical node, tiled across blocks
        up = t.states.uplink_free_ms.numpy()
        rx = t.states.rx_free_ms.numpy()
        assert (up == up[0]).all() and (rx == rx[0]).all()
        # the topic's subscribers, and nobody outside them, receive it
        assert b.received[t.subscribed_np[ti]].all()
        assert not b.received[~t.subscribed_np[ti]].any()
        j.advance(2000.0)
        t.advance(2000.0)
    _same_state(j, t)
    # the fold coupled the topics: the last publish's senders are busy
    # in every topic block
    assert float(t.state.uplink_free_ms.max()) > float(t.state.t_ms) - 4000.0
    assert t.mesh_sizes() == j.mesh_sizes()
    assert t.topic_health() == j.topic_health()
    assert set(t.topic_health().values()) == {"healthy"}


def test_unsubscribed_publisher_and_reset(sims):
    j, t = sims
    if float(t.state.t_ms) == 0.0:
        j.warmup()
        t.warmup()
    ti = 1
    pub = int(np.nonzero(~t.subscribed_np[ti])[0][0])
    a, b = j.publish(TOPICS[ti], pub), t.publish(TOPICS[ti], pub)
    _same_record(a, b)
    _same_state(j, t)
    assert not b.received[pub] and b.received[t.subscribed_np[ti]].all()
    fan = t.states.fanout_mask.numpy()[ti, pub]
    assert fan.sum() == t.params.d
    # the mix of per-topic records in publish order
    assert [r[0] for r in t.records] == [r[0] for r in j.records]
    for (_, x), (_, y) in zip(j.records, t.records):
        _same_record(x, y)
    j.reset()
    t.reset()
    _same_state(j, t)
    assert t.records == [] and float(t.state.t_ms) == 0.0


def test_publish_batch_is_a_later_slice(sims):
    # one batch across two topics, as the reference's
    j, t = sims
    if float(t.state.t_ms) == 0.0:
        j.warmup()
        t.warmup()
    items = [(TOPICS[0], int(np.nonzero(t.subscribed_np[0])[0][0])),
             (TOPICS[1], int(np.nonzero(t.subscribed_np[1])[0][1]))]
    for a, b in zip(j.publish_batch(items, pad_to=4),
                    t.publish_batch(items, pad_to=4)):
        _same_record(a, b)
    _same_state(j, t)
    with pytest.raises(KeyError):
        t.publish("nope", 1)
