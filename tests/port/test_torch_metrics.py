"""The port's Prometheus layer (runtime/metrics.py) against the reference,
byte for byte: the exposition of the same series operations (counters,
gauges, histograms, label escaping, non-finite values, the flight-recorder
family), and NodeMetrics.fill_from_sim on a JAX simulator and a port
simulator of the same config (single-topic with a set_subscribed flip,
and multi-topic at subscribe_fraction 0.75), after a warm-up and after
publishes, from several viewed peers."""

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams
from dst_libp2p_test_node_tpu.runtime import metrics as jm
from dst_libp2p_test_node_tpu.runtime import multitopic as jmt
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch.runtime import metrics as tm
from dst_libp2p_test_node_tpu_torch.runtime import multitopic as tmt
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)


def _ops(mod):
    """One fixed sequence of series operations on a fresh registry and a
    fresh NodeMetrics."""
    r = mod.Registry()
    c = r.counter("x_total", "a counter", ("k",))
    g = r.gauge("y", "a gauge")
    h = r.histogram("z_ms", "a histogram", ("t",), buckets=(1.0, 2.5, 10.0))
    r.gauge("empty", "never set")
    r.histogram("h_empty", "never observed")
    c.inc(labels={"k": 'quote" back\\ new\nline'})
    c.inc(2.5, labels={"k": "b"})
    c.inc(labels={"k": "b"})
    g.set(float("inf"))
    g.set(-0.1)
    for v in (0.5, 1.0, 2.0, 7.25, 99.0, float("nan")):
        h.observe(v, labels={"t": "a"})
    h.observe(3.0, labels={"t": "b"})
    m = mod.NodeMetrics(muxer="quic", peer_id="7", topic="blocks,att_0")
    m.on_publish_request(ok=True)
    m.on_publish_request(ok=False)
    for d in (0.0, 3.0, 600.0, 12000.0, 1e16):
        m.on_delivery(d, chunks=4)
    m.update_topic_health(3, 4)
    m.service_latency.observe(12.5, labels={"tenant": "att"})
    m.service_dropped.inc(labels={"reason": "backpressure"})
    m.fill_from_telemetry({
        "tel_coverage": np.array([0.25, 0.5, 1.0], np.float32),
        "tel_deg_hist": np.arange(6, dtype=np.float32).reshape(3, 2),
        "other": np.zeros(3)})
    return r.render(), m.render(), c.get({"k": "b"}), g.get()


def test_series_operations_render_identically():
    assert _ops(tm) == _ops(jm)


def test_value_formatting_and_escaping():
    for v in (0, 1, -3.0, 0.1, 1e15, 1e16, float("inf"), -float("inf"),
              float("nan"), 2.5e-7, np.float32(0.1), np.int64(5)):
        assert tm._fmt_value(v) == jm._fmt_value(v)
    for s in ('a"b', "a\\b", "x\ny", "plain"):
        assert tm._escape_label_value(s) == jm._escape_label_value(s)


def _topo(n, size):
    return TopoParams(network_size=n, msg_size_bytes=size, messages=1)


@pytest.fixture(scope="module")
def single():
    kw = dict(topo=_topo(16, 500), connect_to=4, warmup_s=5.0, seed=3)
    j = jsim.Simulator(jsim.ExperimentConfig(**kw))
    t = tsim.Simulator(tsim.ExperimentConfig(**kw), device="cpu")
    return j, t


@pytest.fixture(scope="module")
def multi():
    kw = dict(topo=_topo(16, 400), topics=("blocks", "att_0", "att_1"),
              connect_to=4, warmup_s=5.0, seed=2, subscribe_fraction=0.75)
    j = jmt.MultiTopicSimulator(jmt.MultiTopicConfig(**kw))
    t = tmt.MultiTopicSimulator(tmt.MultiTopicConfig(**kw), device="cpu")
    return j, t


def _fill(mod, sim, view, topic):
    m = mod.NodeMetrics(muxer="yamux", peer_id=str(view), topic=topic)
    m.fill_from_sim(sim, view)
    return m.render()


def _views_equal(j, t, topic, views):
    for v in views:
        assert _fill(tm, t, v, topic) == _fill(jm, j, v, topic), v


def test_fill_from_sim_single_topic(single):
    j, t = single
    _views_equal(j, t, "test", (0, 2, 15))          # before the warm-up
    for s in (j, t):
        s.warmup()
    _views_equal(j, t, "test", (0, 2, 15))
    mask = np.ones(16, bool)
    mask[[2, 5, 9]] = False
    for s in (j, t):
        s.set_subscribed(mask)
        s.publish(2, msg_size=500)                  # fanout publish
        s.publish(4, msg_size=300)
        s.advance(2000.0)
    text = _fill(tm, t, 4, "test")
    assert "libp2p_pubsub_received_unsubscriptions_total" in text
    _views_equal(j, t, "test", (0, 2, 4, 9, 15))


def test_fill_from_sim_multi_topic(multi):
    j, t = multi
    topics = "blocks,att_0,att_1"
    for s in (j, t):
        s.warmup()
    _views_equal(j, t, topics, (0, 1, 7, 15))
    assert t.mesh_sizes() == j.mesh_sizes()
    sub = t.subscribed_np
    pub = next(p for p in range(16) if sub[0, p] == sub[2, p])
    for s in (j, t):
        s.publish("att_0", 3, msg_size=400)
        s.publish_batch([("blocks", pub), ("att_1", pub)], msg_size=400)
        s.advance(1500.0)
    # a node joined to no topic keeps its three health gauges at 0
    none = [p for p in range(16) if not t.subscribed_np[:, p].any()]
    _views_equal(j, t, topics, tuple({0, 1, 3, 15, *none}))
    text = _fill(tm, t, 3, topics)
    for name in ("blocks", "att_0", "att_1"):
        assert f'libp2p_gossipsub_peers_per_topic_mesh{{topic="{name}"}}' \
            in text
