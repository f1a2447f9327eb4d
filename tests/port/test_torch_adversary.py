"""The port's static attack canon (ops/adversary.py) and the censored
publish against the reference, on the CPU, bitwise (no tolerance):

  - every scenario's attack window (run_attacked_heartbeats: heartbeat_step
    then adversary_round, 8 rounds at 128 peers, flight recorder armed):
    every SimState leaf and every obs curve;
  - the host-side trial setup: attacker_cohort, heartbeats_to_graylist,
    eclipse_setup, censorship_penalty_update;
  - disseminate(censor_edge=) at fractional latencies, exact and bounded,
    sender-side and receiver-side (the pull budget lowered), lossless and
    tcp-lossy, from an attacked state whose graylist gate binds;
  - the adaptive policy's validation, which once refused the controller
    by name and now arms it as the reference does."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dst_libp2p_test_node_tpu.ops.pull as jpull
import dst_libp2p_test_node_tpu_torch.ops.pull as tpull
from dst_libp2p_test_node_tpu.config.topology import Topology, TopoParams
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import disseminate as jd
from dst_libp2p_test_node_tpu.ops import heartbeat as jhb
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops import telemetry as jtel
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import disseminate as td
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.ops import telemetry as ttel

torch.set_num_threads(1)

N = 128
ARMED = dict(slow_weight=-10.0, slow_decay=0.9, graylist_threshold=-50.0,
             gossip_threshold=-10.0, publish_threshold=-20.0)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _obs_mismatches(want: dict, got: dict) -> list:
    return interop.leaf_mismatches(
        {k: np.asarray(v) for k, v in want.items()},
        interop.obs_to_numpy(got)) + sorted(set(got) ^ set(want))


@pytest.fixture(scope="module")
def world():
    g = build_connection_graph(N, 10, seed=1, max_degree=40)
    pj = jst.SimParams(n=N, capacity=g.capacity, **ARMED)
    pt = tst.SimParams(n=N, capacity=g.capacity, **ARMED)
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    sj = jhb.run_heartbeats(jst.init_state(pj, 3), aj["conns"], aj["rev"],
                            aj["out_mask"], pj, 10)
    att = jadv.attacker_cohort(N, 0.2, seed=0)
    return g, pj, pt, aj, at, sj, att


@pytest.mark.parametrize("scenario", jadv.SCENARIOS)
def test_attack_window_bitwise(world, scenario):
    g, pj, pt, aj, at, sj, att = world
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    want, obs_j = jadv.run_attacked_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att), pj,
        jadv.AdversaryParams(scenario=scenario), 8,
        telemetry=jtel.TelemetryParams(record=True))
    got, obs_t = tadv.run_attacked_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], torch.from_numpy(att),
        pt, tadv.AdversaryParams(scenario=scenario), 8,
        telemetry=ttel.TelemetryParams(record=True))
    assert interop.leaf_mismatches(_leaves(want),
                                   interop.state_to_numpy(got)) == []
    assert _obs_mismatches(obs_j, obs_t) == []
    assert obs_t["graylisted_frac"].shape == (8,)
    # the scenario did something: grafts, penalties, spam counters or the
    # uplink (censorship acts on publishes only)
    moved = [bool((getattr(got, k) != getattr(st, k)).any())
             for k in ("grafts_rx", "slow_penalty", "ihave_rx", "iwant_rx",
                       "uplink_free_ms")]
    assert any(moved) == (scenario != "censorship")


def test_trial_setup_host_side(world):
    g, pj, pt, aj, at, sj, att = world
    for n, frac, seed, ecl in ((128, 0.2, 0, False), (128, 0.1, 7, True),
                               (64, 0.0, 1, False), (300, 0.35, 2, True)):
        conns = build_connection_graph(n, 6, seed=seed).conns
        want = jadv.attacker_cohort(n, frac, seed, conns=conns, publisher=4,
                                    eclipse=ecl)
        got = tadv.attacker_cohort(n, frac, seed, conns=conns, publisher=4,
                                   eclipse=ecl)
        assert np.array_equal(want, got) and not got[4]
    for scen in jadv.SCENARIOS:
        for kw in (ARMED, {}, dict(ARMED, slow_decay=0.2)):
            p_j = jst.SimParams(n=N, capacity=40, **kw)
            p_t = tst.SimParams(n=N, capacity=40, **kw)
            for extra in ({}, dict(rotation_period_hb=9),
                          dict(violation_penalty=6.0)):
                bj = jadv.heartbeats_to_graylist(
                    jadv.AdversaryParams(scenario=scen, **extra), p_j)
                bt = tadv.heartbeats_to_graylist(
                    tadv.AdversaryParams(scenario=scen, **extra), p_t)
                assert bj == bt or (math.isinf(bj) and math.isinf(bt))
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    pub = int(np.nonzero(~att)[0][0])
    want = jadv.eclipse_setup(sj, aj["conns"], jnp.asarray(att), pub)
    got = tadv.eclipse_setup(st, at["conns"], torch.from_numpy(att), pub)
    assert interop.leaf_mismatches(_leaves(want),
                                   interop.state_to_numpy(got)) == []
    received = np.random.default_rng(5).random(N) < 0.7
    for adv in (dict(), dict(censor_penalty=2.5), dict(censor_penalty=0.0)):
        want = jadv.censorship_penalty_update(
            sj, aj["conns"], aj["rev"], jnp.asarray(att),
            jnp.asarray(received), pj, jadv.AdversaryParams(**adv))
        got = tadv.censorship_penalty_update(
            st, at["conns"], at["rev"], torch.from_numpy(att),
            torch.from_numpy(received), pt, tadv.AdversaryParams(**adv))
        assert interop.leaf_mismatches(_leaves(want),
                                       interop.state_to_numpy(got)) == []


@pytest.mark.parametrize("mode,budget,lossy", [
    ("exact", "default", False), ("exact", "lowered", False),
    ("bounded", "default", False), ("bounded", "lowered", False),
    ("exact", "default", True)])
def test_censored_publish_at_fractional_latencies(world, mode, budget, lossy,
                                                  monkeypatch):
    g, pj, pt, aj, at, sj, att = world
    serialize = mode == "exact"
    pj = dataclasses.replace(pj, serialize_answers=serialize)
    pt = dataclasses.replace(pt, serialize_answers=serialize)
    # an attacked state: the graylist gate binds beside the censor mask
    sj, _ = jadv.run_attacked_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att), pj,
        jadv.AdversaryParams(), 10)
    topo = Topology.build(TopoParams(
        network_size=N, anchor_stages=5, min_bandwidth=50, max_bandwidth=150,
        min_latency=40, max_latency=130, packet_loss=0.05 if lossy else 0.0))
    rng = np.random.default_rng(3)
    lat = topo.latency_ms + rng.uniform(0.0, 1.0, topo.latency_ms.shape)
    lat = (np.triu(lat) + np.triu(lat, 1).T).astype(np.float32)
    assert lat[0, 1] != np.round(lat[0, 1])
    if budget == "lowered":
        monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
        monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
        jd.disseminate.clear_cache()
    try:
        st = interop.state_from_numpy(_leaves(sj), "cpu")
        arrays = (topo.stage_of_peer, lat, topo.bw_up_mbit)
        cj = [jnp.asarray(x) for x in arrays]
        ct = [torch.from_numpy(x) for x in arrays]
        loss_kw_j = dict(loss_stage=jnp.asarray(topo.packet_loss)) \
            if lossy else {}
        loss_kw_t = dict(loss_stage=torch.from_numpy(topo.packet_loss)) \
            if lossy else {}
        cen_j = jadv.censor_mask(jnp.asarray(att), aj["conns"])
        cen_t = tadv.censor_mask(torch.from_numpy(att), at["conns"])
        t_base = float(sj.t_ms)
        for publisher, dt in ((7, 250.5), (40, 900.25)):
            kw = dict(publisher=publisher, t0_ms=t_base + dt,
                      payload_bytes=15000, fragments=1)
            rj, sj = jd.disseminate(sj, aj["conns"], aj["rev"], *cj,
                                    params=pj, censor_edge=cen_j,
                                    **loss_kw_j, **kw)
            rt, st = td.disseminate(st, at["conns"], at["rev"], *ct,
                                    params=pt, censor_edge=cen_t,
                                    **loss_kw_t, **kw)
            assert interop.leaf_mismatches(
                _leaves(rj), {f.name: getattr(rt, f.name).numpy()
                              for f in dataclasses.fields(rt)}) == []
            assert interop.leaf_mismatches(
                _leaves(sj), interop.state_to_numpy(st)) == []
        # the censors withheld copies: the same publish uncensored differs
        free, _ = td.disseminate(st, at["conns"], at["rev"], *ct, params=pt,
                                 **loss_kw_t, **kw)
        assert not torch.equal(free.copies_rx, rt.copies_rx)
    finally:
        monkeypatch.undo()
        jd.disseminate.clear_cache()


def test_adaptive_controller_is_refused_by_name():
    # the controller is ported (tests/port/test_torch_adaptive.py): an
    # armed policy validates, and the reference's refusals stay refusals
    for scenario in tadv.ADAPTIVE_SCENARIOS:
        tadv.AdversaryParams(scenario=scenario, adaptive=tadv.AdaptivePolicy(
            enabled=True)).validate()
    for pol in (dict(throttle_margin=1.5), dict(enabled=True, regraft=False,
                                                px_poison=False,
                                                slot_race=False,
                                                duty_cycle=False)):
        with pytest.raises(ValueError) as te:
            tadv.AdaptivePolicy(**pol).validate()
        with pytest.raises(ValueError) as je:
            jadv.AdaptivePolicy(**pol).validate()
        assert str(te.value) == str(je.value)
    for bad in (dict(scenario="nope"), dict(violation_penalty=0.0),
                dict(mimic_margin=1.0), dict(rotation_period_hb=1),
                dict(scenario="iwant_spam",
                     adaptive=dict(enabled=True))):
        tkw, jkw = dict(bad), dict(bad)
        if "adaptive" in bad:
            tkw["adaptive"] = tadv.AdaptivePolicy(**bad["adaptive"])
            jkw["adaptive"] = jadv.AdaptivePolicy(**bad["adaptive"])
        with pytest.raises(ValueError) as te:
            tadv.AdversaryParams(**tkw).validate()
        with pytest.raises(ValueError) as je:
            jadv.AdversaryParams(**jkw).validate()
        assert str(te.value) == str(je.value)
