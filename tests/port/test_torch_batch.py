"""The port's batched publish (Simulator.publish_batch through
runtime/publisher.publish_columns, MultiTopicSimulator.publish_batch one
publish() per message, both from one t0)
against the reference's, bitwise: the records and every state leaf after
the batch, at integer and at fractional latencies, in bounded and exact
mode, with nim and go message ids, padded wider than the batch, across a
warm-start carry and on the receiver-side path; against the reference's
`publish_batch_scan` itself, column by column; a mixed-topic multi-topic
batch; the mixed-fanout refusal.

At fractional latencies which multiply of the mesh base XLA's CPU
backend contracts into an FMA depends on the fused kernel (ROADMAP C3);
test_c3_one_fragment_fractional_exact holds the one-fragment exact
program, where it differs, bitwise."""

import dataclasses

import numpy as np
import pytest
import torch

import dst_libp2p_test_node_tpu.ops.pull as jpull
import dst_libp2p_test_node_tpu_torch.ops.pull as tpull
from dst_libp2p_test_node_tpu.config.topology import Topology as JTopology
from dst_libp2p_test_node_tpu.config.topology import TopoParams
from dst_libp2p_test_node_tpu.ops.disseminate import disseminate as jdis
from dst_libp2p_test_node_tpu.runtime import multitopic as jmt
from dst_libp2p_test_node_tpu.runtime import publisher as jpub
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import (
    Topology as TTopology)
from dst_libp2p_test_node_tpu_torch.runtime import multitopic as tmt
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 120


def _leaves(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def same_state(j, t):
    assert interop.leaf_mismatches(
        _leaves(j.state), interop.state_to_numpy(t.state)) == []


def same_records(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                    f.name
            else:
                assert x == y, f.name


def _topologies(frac, fragments=1):
    topo = TopoParams(network_size=N, anchor_stages=5, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=15000, num_frags=fragments, messages=3,
                      delay_seconds=2.0)
    j = JTopology.build(topo)
    if frac:
        rng = np.random.default_rng(3)
        lat = j.latency_ms + rng.uniform(0.0, 1.0, j.latency_ms.shape)
        j = dataclasses.replace(j, latency_ms=(
            np.triu(lat) + np.triu(lat, 1).T).astype(np.float32))
    t = TTopology(topo, j.latency_ms, j.bw_up_mbit, j.packet_loss,
                  j.stage_of_peer)
    return topo, j, t


def pair(frac=False, fragments=1, **kw):
    """The reference's and the port's Simulator on one topology, both
    after the warm-up."""
    topo, jt, tt = _topologies(frac, fragments)
    kw = dict(dict(topo=topo, seed=3, warmup_s=10.0), **kw)
    j = jsim.Simulator(jsim.ExperimentConfig(**kw), topology=jt)
    t = tsim.Simulator(tsim.ExperimentConfig(**kw), topology=tt,
                       device="cpu")
    j.warmup()
    t.warmup()
    return j, t


@pytest.mark.parametrize("frac,mode,fragments", [
    (False, "bounded", 1), (False, "exact", 1), (True, "bounded", 1),
    (True, "exact", 2)], ids=["int-bounded", "int-exact", "frac-bounded",
                              "frac-exact-2frag"])
def test_batch_matches_reference_bitwise(frac, mode, fragments):
    kw = dict(fragments=fragments, serialize_answers=(mode == "exact"))
    j, t = pair(frac, **kw)
    pubs = [4, 9, 4]
    want = j.publish_batch(pubs, pad_to=4)
    got = t.publish_batch(pubs, pad_to=4)
    same_records(want, got)
    same_state(j, t)
    assert all(r.converged for r in got)
    # the same messages one publish() at a time, in the port
    _, s = pair(frac, **kw)
    same_records(got, [s.publish(p) for p in pubs])
    assert interop.leaf_mismatches(interop.state_to_numpy(t.state),
                                   interop.state_to_numpy(s.state)) == []
    # the key chain continues after the batch
    same_records([j.publish(7)], [t.publish(7)])
    same_state(j, t)


def test_go_ids_padding_and_the_receiver_side_path(monkeypatch):
    # two fragments with the pull budget lowered: receiver-side fixpoints
    # (the gather's plain version) in exact mode, padded to twice the
    # batch, timestamp message ids
    monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
    monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
    jdis.clear_cache()
    try:
        j, t = pair(True, fragments=2, msgid_mode="go")
        pubs = [3, 3, 50]
        want = j.publish_batch(pubs, pad_to=6)
        got = t.publish_batch(pubs, pad_to=6)
    finally:
        monkeypatch.undo()
        jdis.clear_cache()
    same_records(want, got)
    same_state(j, t)
    ids = [r.msg_id for r in got]
    assert ids == sorted(set(ids)) and len(ids) == 3


def test_publish_batch_scan_column_by_column():
    # the reference's engine itself at fractional latencies in exact mode,
    # padded: each active column's record and the carried state
    j, t = pair(True)
    rows = np.array([5, 0, 11, 0], np.int32)
    active = np.array([True, False, True, False])
    t0 = float(j.state.t_ms) + j._hb_carry_ms
    jys, jstate = jpub.publish_batch_scan(
        j.state, j.arrays["conns"], j.arrays["rev"], j._stage, j._lat,
        j._bw, rows, active, t0, j.params, 15000, 1, True, j._loss, "tcp",
        j._lat_edge, j._loss_edge, j._ans_tables, j._valid_edge, False)
    ys = {k: np.asarray(v) for k, v in jys.items()}
    assert not ys["received"][1].any() and not ys["received"][3].any()
    want = [jsim.record_from_result(
        jsim._BatchColumn(ys, i), publisher=int(rows[i]), t0_ms=t0,
        msg_id=int(j._msg_rng.integers(0, 2**63, dtype=np.int64)))
        for i in (0, 2)]
    got = t.publish_batch([5, 11], pad_to=4)
    same_records(want, got)
    assert got[0].t0_ms == got[1].t0_ms == t0
    assert interop.leaf_mismatches(_leaves(jstate),
                                   interop.state_to_numpy(t.state)) == []


@pytest.mark.parametrize("how", ["batch", "sequential"])
def test_c3_one_fragment_fractional_exact(how):
    """One fragment, fractional latencies, exact mode: the program where
    XLA's CPU backend contracts the queue multiply of phase 2's mesh base
    (not the latency one), which from the second same-t0 message on moved
    a few delays and the occupancy and warm-offset leaves by one float32
    ulp of the clock. Records and every state leaf are bitwise, batched
    and one publish() at a time."""
    j, t = pair(True, serialize_answers=True)
    pubs = [4, 9, 4]
    want = j.publish_batch(pubs, pad_to=4)
    got = (t.publish_batch(pubs) if how == "batch"
           else [t.publish(p) for p in pubs])
    same_records(want, got)
    same_state(j, t)
    assert all(r.converged for r in got)


@pytest.mark.parametrize("mode,fragments,budget", [
    ("bounded", 3, "lowered"), ("exact", 1, "lowered"),
    ("exact", 1, "default"), ("exact", 2, "default")])
def test_fractional_mesh_base_contraction_per_fixpoint(mode, fragments,
                                                       budget, monkeypatch):
    # nine publishes at fractional latencies reach every fixpoint whose
    # mesh base XLA contracts on one multiply or the other: sender- and
    # receiver-side (the budget lowered), phase 1 and 2, bounded and exact
    # (the prefix and serial engines included)
    if budget == "lowered":
        monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
        monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
        jdis.clear_cache()
    try:
        j, t = pair(True, fragments=fragments,
                    serialize_answers=(mode == "exact"))
        pubs = [4, 9, 4, 20, 20, 33, 4, 50, 9]
        want = [j.publish(p) for p in pubs]
        got = [t.publish(p) for p in pubs]
    finally:
        monkeypatch.undo()
        jdis.clear_cache()
    same_records(want, got)
    same_state(j, t)


def test_batch_across_a_warm_start_carry():
    j, t = pair(False, warm_start=True)
    same_records([j.publish(4)], [t.publish(4)])
    j.advance(2000.0)
    t.advance(2000.0)
    same_records(j.publish_batch([4, 4, 8], pad_to=4),
                 t.publish_batch([4, 4, 8], pad_to=4))
    same_state(j, t)


def test_mixed_fanout_refused_and_uniform_buckets_batch():
    j, t = pair(False)
    assert t.publish_batch([]) == [] and t.records == []
    mask = np.ones(N, dtype=bool)
    mask[7] = False
    j.set_subscribed(mask)
    t.set_subscribed(mask)
    with pytest.raises(ValueError, match="uniform fanout"):
        t.publish_batch([2, 7])
    same_records(j.publish_batch([7], pad_to=2),
                 t.publish_batch([7], pad_to=2))
    same_records(j.publish_batch([2, 3]), t.publish_batch([2, 3]))
    same_state(j, t)
    assert not t.records[0].received[7]


def test_mix_relay_batch_is_per_message():
    j, t = pair(False, uses_mix=True, num_mix=16, mix_d=4)
    same_records(j.publish_batch([20, 30], pad_to=4),
                 t.publish_batch([20, 30], pad_to=4))
    same_state(j, t)


def _mt_pair():
    kw = dict(topo=TopoParams(network_size=100, anchor_stages=5,
                              min_bandwidth=50, max_bandwidth=150,
                              min_latency=40, max_latency=130,
                              msg_size_bytes=2000),
              topics=("blocks", "att_0", "att_1"), subscribe_fraction=0.75,
              warmup_s=10.0, seed=11)
    j = jmt.MultiTopicSimulator(jmt.MultiTopicConfig(**kw))
    t = tmt.MultiTopicSimulator(tmt.MultiTopicConfig(**kw), device="cpu")
    j.warmup()
    t.warmup()
    return j, t


def test_multitopic_mixed_topic_batch():
    j, t = _mt_pair()
    sub = t.subscribed_np
    items = [("blocks", int(np.nonzero(sub[0])[0][3])),
             ("att_0", int(np.nonzero(sub[1])[0][3])),
             ("att_1", int(np.nonzero(sub[2])[0][8])),
             ("att_0", int(np.nonzero(sub[1])[0][5]))]
    want = j.publish_batch(items, msg_size=600, pad_to=8)
    got = t.publish_batch(items, msg_size=600, pad_to=8)
    same_records(want, got)
    assert [x for x, _ in t.records] == [x for x, _ in j.records]
    same_state(j, t)
    # the fold ran between columns: one uplink per physical node
    up = t.states.uplink_free_ms.numpy()
    assert (up == up[0]).all()
    # an unsubscribed (fanout) bucket, and the mixed-bucket refusal
    uns = [("att_1", int(np.nonzero(~sub[2])[0][0])),
           ("blocks", int(np.nonzero(~sub[0])[0][1]))]
    same_records(j.publish_batch(uns), t.publish_batch(uns))
    same_state(j, t)
    with pytest.raises(ValueError, match="uniform fanout"):
        t.publish_batch([items[0], uns[0]])
