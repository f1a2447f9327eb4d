"""The port's episub tree backend (ops/episub.py) against the reference, on
the CPU, bitwise (no tolerance):

  - each runner (benign, attacked, adaptive, fault-armed with the static
    and with the adaptive attacker) from a warm tree, with the reference
    tests' ARMED scoring (tests/test_episub.py) so the graylist gate is
    compiled in and with the flight recorder on: every state leaf, the
    tree carry, the attacker's controller and every obs curve;
  - the disabled adaptive window is the attacked one, and the carry
    refusals are the reference's;
  - the reference's vmapped window over two stacked trials
    (runtime/campaign._episub_windows, with and without faults) against
    the port's loop of single-trial windows;
  - scores that straddle the graylist floor by one rounding: the
    reference's episub programs contract one product of the score into
    an FMA, in the step's gate and in the observables;
  - the tree forms and its hops are well founded."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import episub as jep
from dst_libp2p_test_node_tpu.ops import faults as jf
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops import telemetry as jtel
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import episub as tep
from dst_libp2p_test_node_tpu_torch.ops import faults as tf
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.ops import telemetry as ttel
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 96
ROOT = 4
STEPS = 8
ARMED = dict(slow_weight=-10.0, slow_decay=0.9, gossip_threshold=-10.0,
             publish_threshold=-20.0, graylist_threshold=-50.0)
COMPOSED = dict(crash_frac=0.1, crash_window=(1, 4), partition_frac=0.4,
                partition_window=(2, 7), spike_frac=0.1, spike_window=(0, 3),
                spike_ms=37.5)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _bad(want: dict, got: dict) -> list:
    return interop.leaf_mismatches(want, got) + sorted(set(want) ^ set(got))


def _obs_bad(want: dict, got: dict) -> list:
    return _bad({k: np.asarray(v) for k, v in want.items()},
                interop.obs_to_numpy(got))


def _carry_bad(want, got) -> list:
    """Mismatches of a runner's (state, ctrl[, actrl]) tuple."""
    bad = _bad(_leaves(want[0]), interop.state_to_numpy(got[0]))
    for w, g in zip(want[1:], got[1:]):
        bad += _bad(_leaves(w), interop.leaves_to_numpy(g))
    return bad


def _world(weights: dict):
    g = build_connection_graph(N, 10, seed=1, max_degree=40)
    pj = jst.SimParams(n=N, capacity=g.capacity, **weights)
    pt = tst.SimParams(n=N, capacity=g.capacity, **weights)
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    sj, cj = jep.run_episub_heartbeats(
        jst.init_state(pj, 3), jep.init_episub_ctrl(N), aj["conns"],
        aj["rev"], aj["out_mask"], pj, jep.EpisubParams(root=ROOT), 8)
    return dict(pj=pj, pt=pt, aj=aj, at=at, sj=sj, cj=cj)


def _port_carry(w, sj=None):
    return (interop.state_from_numpy(_leaves(sj or w["sj"]), "cpu"),
            interop.dataclass_from_numpy(tep.EpisubCtrl, _leaves(w["cj"]),
                                         "cpu"))


@pytest.fixture(scope="module")
def world():
    return _world(ARMED)


def _both(w, runner: str, sj=None, steps=STEPS, telemetry=True):
    """Run `runner` on both packages from the warm tree: ((out_j, obs_j),
    (out_t, obs_t))."""
    pj, pt, aj, at = w["pj"], w["pt"], w["aj"], w["at"]
    sj = sj or w["sj"]
    st, ct = _port_carry(w, sj)
    epj, ept = jep.EpisubParams(root=ROOT), tep.EpisubParams(root=ROOT)
    gj = (aj["conns"], aj["rev"], aj["out_mask"])
    gt = (at["conns"], at["rev"], at["out_mask"])
    if runner == "benign":
        return ((jep.run_episub_heartbeats(sj, w["cj"], *gj, pj, epj, steps),
                 {}),
                (tep.run_episub_heartbeats(st, ct, *gt, pt, ept, steps), {}))
    att = jadv.attacker_cohort(N, 0.2, seed=0, publisher=ROOT)
    adaptive = runner in ("adaptive", "faulted_adaptive")
    advj = jadv.AdversaryParams(adaptive=jadv.AdaptivePolicy(
        enabled=adaptive))
    advt = tadv.AdversaryParams(adaptive=tadv.AdaptivePolicy(
        enabled=adaptive))
    telj = jtel.TelemetryParams(record=True) if telemetry else None
    telt = ttel.TelemetryParams(record=True) if telemetry else None
    aj_, at_ = jnp.asarray(att), torch.from_numpy(att)
    if runner == "attacked":
        return (jep.run_episub_attacked_heartbeats(
                    sj, w["cj"], *gj, aj_, pj, epj, advj, steps,
                    telemetry=telj),
                tep.run_episub_attacked_heartbeats(
                    st, ct, *gt, at_, pt, ept, advt, steps, telemetry=telt))
    if runner == "adaptive":
        return (jep.run_episub_adaptive_heartbeats(
                    sj, w["cj"], *gj, aj_, pj, epj, advj, steps,
                    telemetry=telj),
                tep.run_episub_adaptive_heartbeats(
                    st, ct, *gt, at_, pt, ept, advt, steps, telemetry=telt))
    fj, ft = jf.FaultParams(**COMPOSED), tf.FaultParams(**COMPOSED)
    m = jf.fault_masks(N, fj, seed=0, publisher=ROOT)
    mt = interop.obs_from_numpy(m, "cpu")
    return (jep.run_episub_faulted_heartbeats(
                sj, w["cj"], *gj, aj_, pj, epj, advj, fj,
                jnp.asarray(m["crash"]), jnp.asarray(m["side"]),
                jnp.asarray(m["spike"]), steps, telemetry=telj),
            tep.run_episub_faulted_heartbeats(
                st, ct, *gt, at_, pt, ept, advt, ft, mt["crash"],
                mt["side"], mt["spike"], steps, telemetry=telt))


@pytest.mark.parametrize("runner", ["benign", "attacked", "adaptive",
                                    "faulted", "faulted_adaptive"])
def test_runner_bitwise(world, runner):
    (out_j, obs_j), (out_t, obs_t) = _both(world, runner)
    assert _carry_bad(out_j, out_t) == []
    assert _obs_bad(obs_j, obs_t) == []
    if runner != "benign":
        assert {"tree_reach_frac", "tree_depth_mean",
                "tel_score_q"} <= set(obs_t)
    if runner.startswith("faulted"):
        assert {"cross_mesh_edges", "restarted_mean_degree"} <= set(obs_t)
    if runner.endswith("adaptive"):
        assert "adv_px_sybil_frac" in obs_t and len(out_t) == 3


def test_disabled_adaptive_is_the_attacked_runner(world):
    st, ct = _port_carry(world)
    at = world["at"]
    g = (at["conns"], at["rev"], at["out_mask"])
    att = torch.from_numpy(jadv.attacker_cohort(N, 0.25, seed=1))
    adv = tadv.AdversaryParams(scenario="sybil_graft_flood")
    ep = tep.EpisubParams(root=ROOT)
    base, obs_b = tep.run_episub_attacked_heartbeats(
        st, ct, *g, att, world["pt"], ep, adv, 6)
    deleg, obs_d = tep.run_episub_adaptive_heartbeats(
        st, ct, *g, att, world["pt"], ep, adv, 6)
    assert _bad(interop.state_to_numpy(base[0]),
                interop.state_to_numpy(deleg[0])) == []
    assert _bad(interop.leaves_to_numpy(base[1]),
                interop.leaves_to_numpy(deleg[1])) == []
    assert _bad(interop.obs_to_numpy(obs_b), interop.obs_to_numpy(obs_d)) \
        == []
    # the carry refusals are the reference's
    actrl = tst.init_adaptive_ctrl(N, "cpu")
    jactrl = jst.init_adaptive_ctrl(N)
    sj, cj, aj = world["sj"], world["cj"], world["aj"]
    jg = (aj["conns"], aj["rev"], aj["out_mask"])
    jatt = jnp.asarray(att.numpy())
    jadv_ = jadv.AdversaryParams(scenario="sybil_graft_flood")
    with pytest.raises(ValueError) as te:
        tep.run_episub_adaptive_heartbeats(st, ct, *g, att, world["pt"], ep,
                                           adv, 2, actrl=actrl)
    with pytest.raises(ValueError) as je:
        jep.run_episub_adaptive_heartbeats(
            sj, cj, *jg, jatt, world["pj"], jep.EpisubParams(root=ROOT),
            jadv_, 2, actrl=jactrl)
    assert str(te.value) == str(je.value)
    fp = dict(crash_frac=0.1, crash_window=(0, 2))
    m = tf.fault_masks(N, tf.FaultParams(**fp), 0)
    mt = interop.obs_from_numpy(m, "cpu")
    with pytest.raises(ValueError) as te:
        tep.run_episub_faulted_heartbeats(
            st, ct, *g, att, world["pt"], ep, adv, tf.FaultParams(**fp),
            mt["crash"], mt["side"], mt["spike"], 2, actrl=actrl)
    with pytest.raises(ValueError) as je:
        jep.run_episub_faulted_heartbeats(
            sj, cj, *jg, jatt, world["pj"], jep.EpisubParams(root=ROOT),
            jadv_, jf.FaultParams(**fp), jnp.asarray(m["crash"]),
            jnp.asarray(m["side"]), jnp.asarray(m["spike"]), 2,
            actrl=jactrl)
    assert str(te.value) == str(je.value)
    for bad in (dict(root=N), dict(root=-1), dict(lazy_degree=-1)):
        with pytest.raises(ValueError) as te:
            tep.EpisubParams(**bad).validate(N)
        with pytest.raises(ValueError) as je:
            jep.EpisubParams(**bad).validate(N)
        assert str(te.value) == str(je.value)


def _exp(mod_topo, mod_sim, mod_camp):
    return mod_sim.ExperimentConfig(
        topo=mod_topo(network_size=64, anchor_stages=3, msg_size_bytes=2000,
                      messages=2, delay_seconds=0.5),
        connect_to=8, gossipsub=mod_camp.attack_gossipsub(
            flood_publish=False),
        publisher_id=4, warmup_s=8.0, seed=0)


@pytest.mark.parametrize("faulted", [False, True])
def test_vmapped_windows_equal_the_loop(faulted):
    simj = jsim.Simulator(_exp(JTopo, jsim, jc))
    simt = tsim.Simulator(_exp(TTopo, tsim, tc), device="cpu")
    n, a = simj.params.n, simj.arrays
    epj, ept = jep.EpisubParams(root=4), tep.EpisubParams(root=4)
    seeds = (0, 1)
    states, ctrls = [], []
    for s in seeds:
        st, ct = jep.run_episub_heartbeats(
            jst.init_state(simj.params, seed=s), jep.init_episub_ctrl(n),
            a["conns"], a["rev"], a["out_mask"], simj.params, epj, 8)
        states.append(st)
        ctrls.append(ct)
    att = [jadv.attacker_cohort(n, 0.25, seed=s, publisher=4)
           for s in seeds]
    advj = jadv.AdversaryParams(scenario="sybil_graft_flood",
                                adaptive=jadv.AdaptivePolicy(enabled=True))
    advt = tadv.AdversaryParams(scenario="sybil_graft_flood",
                                adaptive=tadv.AdaptivePolicy(enabled=True))
    kw_j, kw_t = {}, {}
    if faulted:
        masks = [jf.fault_masks(n, jf.FaultParams(**COMPOSED), seed=s,
                                publisher=4) for s in seeds]
        kw_j = dict(faults=jf.FaultParams(**COMPOSED),
                    fmasks=[{k: jnp.asarray(v) for k, v in m.items()}
                            for m in masks])
        kw_t = dict(faults=tf.FaultParams(**COMPOSED),
                    fmasks=[interop.obs_from_numpy(m, "cpu")
                            for m in masks])
    want = jc._episub_windows(
        simj, epj, [jnp.asarray(x) for x in att], states, ctrls, advj, 6,
        telemetry=jtel.TelemetryParams(record=True), **kw_j)
    got = tc._episub_windows(
        simt, ept, [torch.from_numpy(x) for x in att],
        [interop.state_from_numpy(_leaves(s), "cpu") for s in states],
        [interop.dataclass_from_numpy(tep.EpisubCtrl, _leaves(c), "cpu")
         for c in ctrls],
        advt, 6, telemetry=ttel.TelemetryParams(record=True), **kw_t)
    for j in range(len(seeds)):
        assert _bad(_leaves(want[0][j]),
                    interop.state_to_numpy(got[0][j])) == [], j
        assert _bad(_leaves(want[1][j]),
                    interop.leaves_to_numpy(got[1][j])) == [], j
        assert _bad({k: np.asarray(v) for k, v in want[2][j].items()},
                    got[2][j]) == [], j


def _straddling(fw: float, sw: float, thr: float, product: str, k: int,
                seed: int) -> np.ndarray:
    """(k, 2) float32 (fmd, slow_penalty) pairs whose score fw*fmd +
    sw*slow lies on one side of `thr` with both products rounded and on
    the other with `product` ("first" or "slow") contracted into the add
    (one FMA)."""
    f32, f64 = np.float32, np.float64
    rng = np.random.default_rng(seed)
    found = []
    while sum(len(x) for x in found) < k:
        fmd = rng.uniform(0.5, 4.0, 4096).astype(f32)
        slow = ((thr - f64(f32(fw)) * fmd) / sw).astype(f32)
        for _ in range(4):
            slow = np.nextafter(slow, f32(-np.inf))
        for _ in range(9):
            a, b = f32(fw) * fmd, f32(sw) * slow
            two = a + b
            if product == "first":
                fused = (f64(f32(fw)) * f64(fmd) + f64(b)).astype(f32)
            else:
                fused = (f64(a) + f64(f32(sw)) * f64(slow)).astype(f32)
            m = (two >= thr) != (fused >= thr)
            found.append(np.stack([fmd[m], slow[m]], axis=-1))
            slow = np.nextafter(slow, f32(np.inf))
    return np.concatenate(found)[:k]


@pytest.mark.parametrize("weights", [(0.7, -3.3), (1.0, -10.0)])
def test_scores_straddling_the_graylist_floor(weights):
    # every edge sits one rounding from the floor: a gate or observable
    # computed with the other contraction flips (ROADMAP C's FMA hazard)
    fw, sw = weights
    w = _world(dict(ARMED, fmd_weight=fw, slow_weight=sw, slow_decay=0.93))
    thr = ARMED["graylist_threshold"]
    # at fmd_weight 1.0 the first multiply folds away and only the
    # slow-peer product can be contracted
    kinds = ("first", "slow") if fw != 1.0 else ("slow",)
    pool = np.concatenate([_straddling(fw, sw, thr, p, 512, seed=i)
                           for i, p in enumerate(kinds)])
    idx = np.random.default_rng(7).integers(0, len(pool),
                                            w["sj"].fmd.shape)
    sj = w["sj"].replace(fmd=jnp.asarray(pool[idx, 0]),
                         slow_penalty=jnp.asarray(pool[idx, 1]))
    for runner in ("benign", "adaptive"):
        (out_j, obs_j), (out_t, obs_t) = _both(w, runner, sj=sj, steps=2)
        assert _carry_bad(out_j, out_t) == [], runner
        assert _obs_bad(obs_j, obs_t) == [], runner


def test_tree_forms_and_hops_are_well_founded():
    g = build_connection_graph(32, 6, seed=0)
    p = tst.SimParams(n=32, capacity=g.capacity, **ARMED)
    a = tst.graph_arrays(g, "cpu")
    _, ctrl = tep.run_episub_heartbeats(
        tst.init_state(p, seed=0, device="cpu"),
        tep.init_episub_ctrl(32, "cpu"), a["conns"], a["rev"],
        a["out_mask"], p, tep.EpisubParams(root=ROOT), 12)
    hops, parent = ctrl.hops.numpy(), ctrl.parent.numpy()
    reached = hops < 1e30
    assert hops[ROOT] == 0.0 and parent[ROOT] < 0
    assert reached.mean() >= 0.9
    for i in np.nonzero(reached)[0]:
        if i == ROOT:
            continue
        q = g.conns[i, parent[i]]
        assert reached[q] and hops[q] == hops[i] - 1, i
