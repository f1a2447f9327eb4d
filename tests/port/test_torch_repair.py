"""The port's mesh repair against the reference, on the CPU, bitwise (no
tolerance):

  - the heartbeat's repair branches (score eviction counted in both PRUNE
    ledgers, PX capture into px_pool, the carried degree re-reduced when
    only eviction fired), deferred-decay and churned paths;
  - repair_round on a graph where dials collide (many dialers on one
    acceptor: lowest dialer id wins, one inbound dial per round);
  - run_recovery_heartbeats with the graph in its carry (evict + px +
    redial, flight recorder armed): state, conns / rev / out_mask, obs;
  - Simulator.rebind_graph then publish: the rebuilt per-edge tables and
    the publish over the dialed graph."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import heartbeat as jhb
from dst_libp2p_test_node_tpu.ops import repair as jrep
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops import telemetry as jtel
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import heartbeat as thb
from dst_libp2p_test_node_tpu_torch.ops import repair as trep
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.ops import telemetry as ttel
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 128
ARMED = dict(slow_weight=-10.0, slow_decay=0.9, graylist_threshold=-50.0,
             gossip_threshold=-10.0, publish_threshold=-20.0)
REPAIR = dict(evict=True, px=True, redial=True)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _same_state(want, got):
    assert interop.leaf_mismatches(_leaves(want),
                                   interop.state_to_numpy(got)) == []


def _same_graph(want, got):
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype and np.array_equal(w, g.numpy())


@pytest.fixture(scope="module")
def attacked():
    """A warm network after 15 graft-flood rounds: penalties live, so
    eviction and PX fire."""
    g = build_connection_graph(N, 10, seed=1, max_degree=40)
    pj = jst.SimParams(n=N, capacity=g.capacity, **ARMED)
    pt = tst.SimParams(n=N, capacity=g.capacity, **ARMED)
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    sj = jhb.run_heartbeats(jst.init_state(pj, 3), aj["conns"], aj["rev"],
                            aj["out_mask"], pj, 10)
    att = jadv.attacker_cohort(N, 0.2, seed=0)
    sj, _ = jadv.run_attacked_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att), pj,
        jadv.AdversaryParams(), 15)
    return g, pj, pt, aj, at, sj, att


@pytest.mark.parametrize("churn", [0.0, 0.02])
def test_heartbeat_repair_branches_bitwise(attacked, churn):
    g, pj, pt, aj, at, sj, att = attacked
    kw = dict(churn_down_per_hb=churn, churn_up_per_hb=churn / 2,
              evict=True, px=True)
    pj = dataclasses.replace(pj, **kw)
    pt = dataclasses.replace(pt, **kw)
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    want = jhb.run_heartbeats(sj, aj["conns"], aj["rev"], aj["out_mask"],
                              pj, 6)
    got = thb.run_heartbeats(st, at["conns"], at["rev"], at["out_mask"],
                             pt, 6)
    _same_state(want, got)
    assert int(got.evictions.sum()) > 0
    assert int((got.px_pool >= 0).sum()) > 0
    # an eviction is a PRUNE in both ledgers
    assert int((got.prunes - st.prunes).sum()) >= int(got.evictions.sum())
    # one step without the deferred protocol (the gated per-step decay)
    want1 = jhb.heartbeat_step(sj, aj["conns"], aj["rev"], aj["out_mask"],
                               pj)
    got1 = thb.heartbeat_step(st, at["conns"], at["rev"], at["out_mask"],
                              pt)
    _same_state(want1, got1)


def test_repair_round_colliding_dials(attacked):
    g, pj, pt, aj, at, sj, att = attacked
    pj = jrep.RepairParams(**REPAIR).apply(pj)
    pt = trep.RepairParams(**REPAIR).apply(pt)
    conns = np.asarray(g.conns)
    target = 9
    # peers not connected to the target, each with a free slot
    dialers = [p for p in range(N) if p != target
               and target not in conns[p] and (conns[p] < 0).any()][:12]
    pool = np.asarray(sj.px_pool).copy()
    pool[dialers, 0] = target
    mesh = np.asarray(sj.mesh_mask).copy()
    mesh[dialers] = False          # starved: degree below D
    starve = np.asarray(sj.starve_hb).copy()
    starve[dialers[6:]] = 5        # some of them re-dial too
    sj = sj.replace(px_pool=jnp.asarray(pool), mesh_mask=jnp.asarray(mesh),
                    starve_hb=jnp.asarray(starve))
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    want = jrep.repair_round(sj, aj["conns"], aj["rev"], aj["out_mask"], pj,
                             actor=jnp.asarray(~att))
    got = trep.repair_round(st, at["conns"], at["rev"], at["out_mask"], pt,
                            actor=torch.from_numpy(~att))
    _same_state(want[0], got[0])
    _same_graph(want[1:], got[1:])
    new_conns = got[1].numpy()
    # the target took one inbound dial: the lowest acting dialer
    acting = [p for p in dialers if not att[p]]
    assert (new_conns[target] >= 0).sum() == (conns[target] >= 0).sum() + 1
    assert min(acting) in new_conns[target]
    # the involution holds on the extended graph
    rev = got[2].numpy()
    for p, i in zip(*np.nonzero(new_conns >= 0)):
        q, j = new_conns[p, i], rev[p, i]
        assert new_conns[q, j] == p and rev[q, j] == i
    assert int(got[0].redials.sum()) > int(st.redials.sum())


def test_recovery_window_with_graph_carry(attacked):
    g, pj, pt, aj, at, sj, att = attacked
    pj = jrep.RepairParams(**REPAIR).apply(pj)
    pt = trep.RepairParams(**REPAIR).apply(pt)
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    (wj, *graph_j), obs_j = jrep.run_recovery_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att), pj, 20,
        publisher=4, telemetry=jtel.TelemetryParams(record=True))
    (wt, *graph_t), obs_t = trep.run_recovery_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], torch.from_numpy(att),
        pt, 20, publisher=4, telemetry=ttel.TelemetryParams(record=True))
    _same_state(wj, wt)
    _same_graph(graph_j, graph_t)
    assert interop.leaf_mismatches(
        {k: np.asarray(v) for k, v in obs_j.items()},
        interop.obs_to_numpy(obs_t)) == []
    assert sorted(obs_t) == sorted(obs_j)
    assert int(wt.redials.sum()) > 0 and int(wt.evictions.sum()) > 0
    assert int(wt.px_grafts.sum()) > 0
    assert not torch.equal(graph_t[0], at["conns"])
    # a committed dial invalidated the warm-start carry
    assert bool((wt.warm_offset_ms >= 3.4e38).all())


def _sim_cfg(mod, topo_mod):
    return mod.ExperimentConfig(
        topo=topo_mod(network_size=N, anchor_stages=3, msg_size_bytes=2000,
                      messages=2, delay_seconds=1.0),
        connect_to=10, warmup_s=5.0, seed=2,
        gossipsub=(jc if mod is jsim else tc).attack_gossipsub(
            flood_publish=False))


def test_rebind_graph_then_publish(attacked):
    from dst_libp2p_test_node_tpu_torch.config.topology import (
        TopoParams as TTopo)

    _, _, _, _, _, _, att = attacked
    js = jsim.Simulator(_sim_cfg(jsim, TopoParams))
    ts = tsim.Simulator(_sim_cfg(tsim, TTopo), device="cpu")
    for s in (js, ts):
        s.warmup()
    pj = jrep.RepairParams(**REPAIR).apply(js.params)
    pt = trep.RepairParams(**REPAIR).apply(ts.params)
    sj, _ = jadv.run_attacked_heartbeats(
        js.state, js.arrays["conns"], js.arrays["rev"],
        js.arrays["out_mask"], jnp.asarray(att), js.params,
        jadv.AdversaryParams(), 12)
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    (sj, *gj), _ = jrep.run_recovery_heartbeats(
        sj, js.arrays["conns"], js.arrays["rev"], js.arrays["out_mask"],
        jnp.asarray(att), pj, 12, publisher=4)
    (st, *gt), _ = trep.run_recovery_heartbeats(
        st, ts.arrays["conns"], ts.arrays["rev"], ts.arrays["out_mask"],
        torch.from_numpy(att), pt, 12, publisher=4)
    _same_graph(gj, gt)
    assert not np.array_equal(np.asarray(gj[0]), js.graph.conns)
    js.state, ts.state = sj, st
    js.rebind_graph(*gj)
    ts.rebind_graph(*gt)
    tables_j = {"lat_edge": js._lat_edge, "valid_edge": js._valid_edge,
                **_leaves(js._ans_tables)}
    tables_t = {"lat_edge": ts._lat_edge, "valid_edge": ts._valid_edge,
                **{f.name: getattr(ts._ans_tables, f.name)
                   for f in dataclasses.fields(ts._ans_tables)}}
    # the port keeps its slot permutations as int64 (torch's index type)
    got_t = {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
             for k, v in interop.obs_to_numpy(tables_t).items()}
    assert interop.leaf_mismatches(
        {k: np.asarray(v) for k, v in tables_j.items()}, got_t) == []
    cen_j = jadv.censor_mask(jnp.asarray(att), js.arrays["conns"])
    cen_t = torch.from_numpy(att)[:, None] & (ts.arrays["conns"] >= 0)
    for _ in range(2):
        rj = js.publish(4, censor_edge=cen_j)
        rt = ts.publish(4, censor_edge=cen_t)
        assert rj.msg_id == rt.msg_id
        for k in ("delays_ms", "received", "sends", "copies_rx"):
            assert np.array_equal(getattr(rj, k), getattr(rt, k)), k
        js.advance(1000.0)
        ts.advance(1000.0)
    _same_state(js.state, ts.state)
    # the epoch graph stays the simulator's graph (checkpoints hash it)
    assert np.array_equal(ts.graph.conns, js.graph.conns)


def test_repair_params_apply_and_validate():
    for kw in (dict(), REPAIR, dict(evict=True, eviction_threshold=-5.0),
               dict(px=True, px_count=3, redial_patience=1)):
        pj = jrep.RepairParams(**kw).apply(jst.SimParams(n=8, capacity=8))
        pt = trep.RepairParams(**kw).apply(tst.SimParams(n=8, capacity=8))
        assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
        assert trep.RepairParams(**kw).enabled == bool(kw)
    for bad in (dict(eviction_threshold=1.0), dict(px_count=0),
                dict(redial_patience=0)):
        with pytest.raises(ValueError) as te:
            trep.RepairParams(**bad).validate()
        with pytest.raises(ValueError) as je:
            jrep.RepairParams(**bad).validate()
        assert str(te.value) == str(je.value)
