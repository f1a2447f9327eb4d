"""The port's adaptive attacker (ops/adversary.adaptive_round and its
windows) against the reference, on the CPU, bitwise (no tolerance):

  - the controller at fractional estimates chosen where the reference's
    contracted `viol_est * slow_decay + penalty` (one FMA) and the
    two-rounding form disagree, on both the throttle decision and the
    estimate (ROADMAP C5): adaptive_round alone and its window;
  - run_adaptive_heartbeats on both graft-flood scenarios, with the repair
    leaves live (the PX poisoner runs) and stripped (it does not), the
    flight recorder armed at fractional scores: state, controller, curves;
  - run_adaptive_recovery_heartbeats with the slot race, and without it
    over a DHT pool (sybils refuse): state, controller, graph, pool;
  - the policy's validation messages, and the disabled policy as the
    static runner;
  - an adaptive eclipse campaign with a recovery window and checkpoints:
    TrialResult fields equal to the reference's vmapped run, and a
    resumed sweep (the controller restarts from zero) equal to the
    reference's own resumed sweep."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import heartbeat as jhb
from dst_libp2p_test_node_tpu.ops import repair as jrep
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops import telemetry as jtel
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import repair as trep
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.ops import telemetry as ttel
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 128
WEIGHTS = dict(fmd_weight=0.7, slow_weight=-3.3, slow_decay=0.93,
               graylist_threshold=-50.0, gossip_threshold=-10.0,
               publish_threshold=-20.0)
REPAIR = dict(evict=True, px=True, redial=True)
# c_req * 0.93 = 14.0909...; at this estimate fma(est, 0.93, 0.37) and
# est * 0.93 + 0.37 fall on either side of it
EDGE_EST = 14.753665


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _bad(want, got) -> list:
    return interop.leaf_mismatches(_leaves(want),
                                   interop.leaves_to_numpy(got))


def _obs_bad(want: dict, got: dict) -> list:
    return interop.leaf_mismatches(
        {k: np.asarray(v) for k, v in want.items()},
        interop.obs_to_numpy(got)) + sorted(set(got) ^ set(want))


def _policy(mod, **kw):
    return mod.AdversaryParams(
        scenario=kw.pop("scenario", "sybil_graft_flood"),
        violation_penalty=kw.pop("violation_penalty", 1.0),
        adaptive=mod.AdaptivePolicy(enabled=True, **kw))


@pytest.fixture(scope="module")
def world():
    g = build_connection_graph(N, 10, seed=1, max_degree=40)
    out = {}
    for name, extra in (("plain", {}), ("repair", REPAIR)):
        pj = jst.SimParams(n=N, capacity=g.capacity, **WEIGHTS, **extra)
        pt = tst.SimParams(n=N, capacity=g.capacity, **WEIGHTS, **extra)
        out[name] = (pj, pt)
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    pj = out["plain"][0]
    sj = jhb.run_heartbeats(jst.init_state(pj, 3), aj["conns"], aj["rev"],
                            aj["out_mask"], pj, 10)
    rng = np.random.default_rng(2)
    sj = sj.replace(
        fmd=jnp.asarray(rng.uniform(0, 4, (N, g.capacity))
                        .astype(np.float32)),
        slow_penalty=jnp.asarray(rng.uniform(0, 3, (N, g.capacity))
                                 .astype(np.float32)))
    att = jadv.attacker_cohort(N, 0.2, seed=0, publisher=4)
    return out, aj, at, sj, att


def test_controller_at_fractional_estimates(world):
    params, aj, at, sj, att = world
    pj, pt = params["plain"]
    est = np.random.default_rng(5).uniform(0, 14, N).astype(np.float32)
    est = est * att
    est[np.nonzero(att)[0][:3]] = np.float32(EDGE_EST)
    zeros = np.zeros(N, np.int32)
    leaves = dict(viol_est=est, regrafts=zeros, px_injected=zeros,
                  throttled_hb=zeros)
    cj = jst.AdaptiveCtrl(**{k: jnp.asarray(v) for k, v in leaves.items()})
    ct = interop.dataclass_from_numpy(tst.AdaptiveCtrl, leaves, "cpu")
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    kw = dict(violation_penalty=0.37, throttle_margin=0.93)
    advj, advt = _policy(jadv, **kw), _policy(tadv, **kw)
    (wj, cj1), oj = jadv.adaptive_round(sj, cj, aj["conns"], aj["rev"],
                                        jnp.asarray(att), pj, advj)
    (wt, ct1), ot = tadv.adaptive_round(st, ct, at["conns"], at["rev"],
                                        torch.from_numpy(att), pt, advt)
    assert _bad(cj1, ct1) == [] and _obs_bad(oj, ot) == []
    assert interop.leaf_mismatches(_leaves(wj),
                                   interop.state_to_numpy(wt)) == []
    # the edge estimates throttled this round
    assert float(ot["adv_throttled_frac"]) > 0.0
    (wj, cj2), oj = jadv.run_adaptive_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att), pj,
        advj, 6, ctrl=cj)
    (wt, ct2), ot = tadv.run_adaptive_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], torch.from_numpy(att),
        pt, advt, 6, ctrl=ct)
    assert _bad(cj2, ct2) == [] and _obs_bad(oj, ot) == []
    assert interop.leaf_mismatches(_leaves(wj),
                                   interop.state_to_numpy(wt)) == []


@pytest.mark.parametrize("scenario,repair", [
    ("sybil_graft_flood", "repair"), ("eclipse_publisher", "plain")])
def test_adaptive_window_bitwise(world, scenario, repair):
    params, aj, at, sj, att = world
    pj, pt = params[repair]
    (wj, cj), oj = jadv.run_adaptive_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att), pj,
        _policy(jadv, scenario=scenario), 8,
        telemetry=jtel.TelemetryParams(record=True))
    (wt, ct), ot = tadv.run_adaptive_heartbeats(
        interop.state_from_numpy(_leaves(sj), "cpu"), at["conns"],
        at["rev"], at["out_mask"], torch.from_numpy(att), pt,
        _policy(tadv, scenario=scenario), 8,
        telemetry=ttel.TelemetryParams(record=True))
    assert interop.leaf_mismatches(_leaves(wj),
                                   interop.state_to_numpy(wt)) == []
    assert _bad(cj, ct) == [] and _obs_bad(oj, ot) == []
    assert ct.regrafts.sum() > 0
    # the poisoner runs only where the pool is live
    assert bool(ct.px_injected.any()) == (repair == "repair")
    assert bool(ot["adv_px_sybil_frac"].gt(0).any()) == (repair == "repair")


@pytest.mark.parametrize("race", [True, False])
def test_adaptive_recovery_window(world, race):
    params, aj, at, sj, att = world
    pj, pt = params["repair"]
    pool = None
    if not race:
        # a DHT pool whose head entries are sybils: refused dials
        rng = np.random.default_rng(4)
        pool = rng.integers(-1, N, (N, 16)).astype(np.int32)
    kw = dict(scenario="eclipse_publisher", slot_race=race)
    cj, oj = jrep.run_adaptive_recovery_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att), pj,
        8, adv=_policy(jadv, **kw),
        dht_pool=None if pool is None else jnp.asarray(pool), publisher=4,
        telemetry=jtel.TelemetryParams(record=True))
    ct, ot = trep.run_adaptive_recovery_heartbeats(
        interop.state_from_numpy(_leaves(sj), "cpu"), at["conns"],
        at["rev"], at["out_mask"], torch.from_numpy(att), pt, 8,
        adv=_policy(tadv, **kw),
        dht_pool=None if pool is None else torch.from_numpy(pool),
        publisher=4, telemetry=ttel.TelemetryParams(record=True))
    assert len(cj) == len(ct) == (5 if race else 6)
    assert interop.leaf_mismatches(_leaves(cj[0]),
                                   interop.state_to_numpy(ct[0])) == []
    assert _bad(cj[1], ct[1]) == []
    for w, g in zip(cj[2:], ct[2:]):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype and np.array_equal(w, g.numpy())
    assert _obs_bad(oj, ot) == []
    assert int(ct[0].redials.sum()) > 0


def test_policy_validation_and_disabled_path(world):
    for bad in (dict(throttle_margin=1.5), dict(px_poison_per_hb=0),
                dict(regraft=False, px_poison=False, slot_race=False,
                     duty_cycle=False)):
        with pytest.raises(ValueError) as te:
            tadv.AdaptivePolicy(enabled=True, **bad).validate()
        with pytest.raises(ValueError) as je:
            jadv.AdaptivePolicy(enabled=True, **bad).validate()
        assert str(te.value) == str(je.value)
    for scenario in ("ihave_spam", "identity_rotation"):
        with pytest.raises(ValueError) as te:
            _policy(tadv, scenario=scenario).validate()
        with pytest.raises(ValueError) as je:
            _policy(jadv, scenario=scenario).validate()
        assert str(te.value) == str(je.value)
    _policy(tadv, scenario="cold_boot_join").validate()
    params, aj, at, sj, att = world
    pt = params["plain"][1]
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    off = tadv.AdversaryParams()
    got, obs = tadv.run_adaptive_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], torch.from_numpy(att),
        pt, off, 3)
    ref, ref_obs = tadv.run_attacked_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], torch.from_numpy(att),
        pt, off, 3)
    assert interop.leaf_mismatches(interop.state_to_numpy(ref),
                                   interop.state_to_numpy(got)) == []
    assert interop.leaf_mismatches(interop.obs_to_numpy(ref_obs),
                                   interop.obs_to_numpy(obs)) == []
    with pytest.raises(ValueError, match="ctrl given"):
        tadv.run_adaptive_heartbeats(
            st, at["conns"], at["rev"], at["out_mask"],
            torch.from_numpy(att), pt, off, 3,
            ctrl=tst.init_adaptive_ctrl(N, "cpu"))
    with pytest.raises(ValueError, match="armed AdaptivePolicy"):
        tadv.adaptive_round(st, tst.init_adaptive_ctrl(N, "cpu"),
                            at["conns"], at["rev"], torch.from_numpy(att),
                            pt, off)


def _cfg(pkg, ckpt):
    camp, sim, topo, adv, rep = (
        (jc, jsim, JTopo, jadv, jrep) if pkg == "jax"
        else (tc, tsim, TTopo, tadv, trep))
    return camp.CampaignConfig(
        scenario="eclipse_publisher", fractions=(0.2,), seeds=(0, 1),
        experiment=sim.ExperimentConfig(
            topo=topo(network_size=64, anchor_stages=3, msg_size_bytes=2000,
                      messages=1, delay_seconds=1.0),
            connect_to=8, warmup_s=5.0, seed=1, serialize_answers=False,
            gossipsub=camp.attack_gossipsub(flood_publish=False)),
        adversary=_policy(adv, scenario="eclipse_publisher"),
        attack_heartbeats=6, recovery_heartbeats=6,
        repair=rep.RepairParams(**REPAIR), checkpoint_dir=ckpt)


def test_adaptive_campaign_and_resume(tmp_path):
    rj = jc.run_campaign(_cfg("jax", str(tmp_path / "j")))
    rt = tc.run_campaign(_cfg("torch", str(tmp_path / "t")), device="cpu")
    assert (interop.result_fields(rt, walls=False)
            == interop.result_fields(rj, walls=False))
    assert all(t.redials_total > 0 for t in rt.trials)
    # a resumed adaptive trial restarts its controller from zero, as the
    # reference's does: both resumed sweeps agree
    again_j = jc.run_campaign(_cfg("jax", str(tmp_path / "j")))
    again_t = tc.run_campaign(_cfg("torch", str(tmp_path / "t")),
                              device="cpu")
    assert (interop.result_fields(again_t, walls=False)
            == interop.result_fields(again_j, walls=False))
    assert all(w["resumed"] for w in again_t.phase_walls)
