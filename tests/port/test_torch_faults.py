"""The port's fault injection (ops/faults.py) against the reference, on the
CPU, bitwise (no tolerance):

  - the host-side cohorts (fault_masks), the cut (partition_edge_mask)
    and the schedule's validation messages;
  - run_faulted_heartbeats for each family alone and all three composed,
    with the adaptive attacker, with the repair leaves live, the flight
    recorder armed, at fractional scores and inexact weights (the
    observables' score and quantile contractions): every state leaf, the
    controller and every obs curve;
  - two seeds: the reference's one vmapped window over the stacked trials
    against the port's loop of single-trial windows;
  - the disabled schedule is the un-faulted runner;
  - a faulted campaign (crash + partition still open over the publishes +
    spike) with checkpoints: TrialResult fields, checkpoint files and a
    resume, each equal to the reference's."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import faults as jf
from dst_libp2p_test_node_tpu.ops import heartbeat as jhb
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops import telemetry as jtel
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import faults as tf
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.ops import telemetry as ttel
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 128
# fractional weights: the observables' score contraction shows (C4)
WEIGHTS = dict(fmd_weight=0.7, slow_weight=-3.3, slow_decay=0.93,
               graylist_threshold=-50.0, gossip_threshold=-10.0,
               publish_threshold=-20.0, evict=True, px=True, redial=True)
FAMILIES = {
    "crash": dict(crash_frac=0.1, crash_window=(1, 4)),
    "partition": dict(partition_frac=0.4, partition_window=(2, 5)),
    "spike": dict(spike_frac=0.1, spike_window=(0, 3), spike_ms=37.5),
    "composed": dict(crash_frac=0.1, crash_window=(1, 4),
                     partition_frac=0.4, partition_window=(2, 9),
                     spike_frac=0.1, spike_window=(0, 3), spike_ms=37.5),
}


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _obs_bad(want: dict, got: dict) -> list:
    return interop.leaf_mismatches(
        {k: np.asarray(v) for k, v in want.items()},
        interop.obs_to_numpy(got)) + sorted(set(got) ^ set(want))


@pytest.fixture(scope="module")
def world():
    g = build_connection_graph(N, 10, seed=1, max_degree=40)
    pj = jst.SimParams(n=N, capacity=g.capacity, **WEIGHTS)
    pt = tst.SimParams(n=N, capacity=g.capacity, **WEIGHTS)
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    sj = jhb.run_heartbeats(jst.init_state(pj, 3), aj["conns"], aj["rev"],
                            aj["out_mask"], pj, 10)
    rng = np.random.default_rng(2)
    sj = sj.replace(
        fmd=jnp.asarray(rng.uniform(0, 4, (N, g.capacity))
                        .astype(np.float32)),
        slow_penalty=jnp.asarray(rng.uniform(0, 3, (N, g.capacity))
                                 .astype(np.float32)))
    att = jadv.attacker_cohort(N, 0.2, seed=0, publisher=4)
    return pj, pt, aj, at, sj, att


def test_fault_masks_and_validation():
    for n, seed, pub in ((128, 0, 4), (300, 7, None), (64, 3, 0)):
        for fam in FAMILIES.values():
            mj = jf.fault_masks(n, jf.FaultParams(**fam), seed, pub)
            mt = tf.fault_masks(n, tf.FaultParams(**fam), seed, pub)
            assert interop.leaf_mismatches(mj, mt) == []
            if pub is not None:
                assert not mt["crash"][pub]
    g = build_connection_graph(N, 10, seed=1, max_degree=40)
    side = jf.fault_masks(N, jf.FaultParams(**FAMILIES["partition"]),
                          0)["side"]
    want = jf.partition_edge_mask(jnp.asarray(side), jnp.asarray(g.conns))
    got = tf.partition_edge_mask(torch.from_numpy(side),
                                 torch.as_tensor(g.conns))
    assert np.array_equal(np.asarray(want), got.numpy()) and got.any()
    assert not tf.FaultParams().enabled
    assert not tf.FaultParams(spike_frac=0.1, spike_window=(0, 3)).spike
    for bad in (dict(crash_frac=1.0), dict(partition_window=(3, 1)),
                dict(spike_window=(-1, 2)), dict(spike_ms=-1.0)):
        with pytest.raises(ValueError) as te:
            tf.FaultParams(**bad).validate()
        with pytest.raises(ValueError) as je:
            jf.FaultParams(**bad).validate()
        assert str(te.value) == str(je.value)


def _run_both(world, fam: dict, adaptive: bool, steps: int = 10):
    pj, pt, aj, at, sj, att = world
    fj, ft = jf.FaultParams(**fam), tf.FaultParams(**fam)
    m = jf.fault_masks(N, fj, seed=0, publisher=4)
    mt = interop.obs_from_numpy(m, "cpu")
    advj = jadv.AdversaryParams(adaptive=jadv.AdaptivePolicy(
        enabled=adaptive))
    advt = tadv.AdversaryParams(adaptive=tadv.AdaptivePolicy(
        enabled=adaptive))
    want, obs_j = jf.run_faulted_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att), pj,
        advj, fj, jnp.asarray(m["crash"]), jnp.asarray(m["side"]),
        jnp.asarray(m["spike"]), steps,
        telemetry=jtel.TelemetryParams(record=True))
    got, obs_t = tf.run_faulted_heartbeats(
        interop.state_from_numpy(_leaves(sj), "cpu"), at["conns"],
        at["rev"], at["out_mask"], torch.from_numpy(att), pt, advt, ft,
        mt["crash"], mt["side"], mt["spike"], steps,
        telemetry=ttel.TelemetryParams(record=True))
    return want, got, obs_j, obs_t


@pytest.mark.parametrize("family,adaptive", [
    ("crash", False), ("partition", True), ("spike", False),
    ("composed", False), ("composed", True)])
def test_faulted_window_bitwise(world, family, adaptive):
    want, got, obs_j, obs_t = _run_both(world, FAMILIES[family], adaptive)
    if adaptive:
        (want, cj), (got, ct) = want, got
        assert interop.leaf_mismatches(
            _leaves(cj), interop.leaves_to_numpy(ct)) == []
        assert "adv_px_sybil_frac" in obs_t
    assert interop.leaf_mismatches(_leaves(want),
                                   interop.state_to_numpy(got)) == []
    assert _obs_bad(obs_j, obs_t) == []
    fam = tf.FaultParams(**FAMILIES[family])
    assert ("cross_mesh_edges" in obs_t) == fam.partition
    assert ("restarted_mean_degree" in obs_t) == fam.crash
    if fam.partition:
        # the cut empties the cross mesh inside the window only
        ps, pe = fam.partition_window
        assert obs_t["cross_mesh_edges"][ps:pe].eq(0).all()
        assert obs_t["cross_mesh_edges"][pe:].gt(0).any()


def test_two_seeds_vmapped_against_the_loop(world):
    pj, pt, aj, at, sj, att = world
    fam = FAMILIES["composed"]
    fj, ft = jf.FaultParams(**fam), tf.FaultParams(**fam)
    adv_j = jadv.AdversaryParams(adaptive=jadv.AdaptivePolicy(enabled=True))
    adv_t = tadv.AdversaryParams(adaptive=tadv.AdaptivePolicy(enabled=True))
    seeds = (0, 1)
    masks = [jf.fault_masks(N, fj, seed=s, publisher=4) for s in seeds]
    atts = [jadv.attacker_cohort(N, 0.2, seed=s, publisher=4) for s in seeds]
    states = [sj, sj.replace(key=jax.random.PRNGKey(9))]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)

    def one(st, a, cr, sd, sp):
        return jf.run_faulted_heartbeats(
            st, aj["conns"], aj["rev"], aj["out_mask"], a, pj, adv_j, fj,
            cr, sd, sp, 8, batch_factor=2)

    (out_j, ctrl_j), obs_j = jax.vmap(one)(
        stacked, jnp.stack([jnp.asarray(a) for a in atts]),
        *(jnp.stack([jnp.asarray(m[k]) for m in masks])
          for k in ("crash", "side", "spike")))
    for i in range(2):
        mt = interop.obs_from_numpy(masks[i], "cpu")
        (got, ctrl), obs_t = tf.run_faulted_heartbeats(
            interop.state_from_numpy(_leaves(states[i]), "cpu"),
            at["conns"], at["rev"], at["out_mask"],
            torch.from_numpy(atts[i]), pt, adv_t, ft, mt["crash"],
            mt["side"], mt["spike"], 8)
        pick = (lambda x, i=i: np.asarray(x)[i])
        want = {k: pick(v) for k, v in _leaves(out_j).items()}
        assert interop.leaf_mismatches(want,
                                       interop.state_to_numpy(got)) == []
        assert interop.leaf_mismatches(
            {k: pick(v) for k, v in _leaves(ctrl_j).items()},
            interop.leaves_to_numpy(ctrl)) == []
        assert _obs_bad({k: pick(v) for k, v in obs_j.items()}, obs_t) == []


def test_disabled_schedule_is_the_attacked_runner(world):
    pj, pt, aj, at, sj, att = world
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    adv = tadv.AdversaryParams()
    off = tf.FaultParams(crash_frac=0.1)        # no window: not armed
    got, obs = tf.run_faulted_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], torch.from_numpy(att),
        pt, adv, off, None, None, None, 4)
    ref, ref_obs = tadv.run_attacked_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], torch.from_numpy(att),
        pt, adv, 4)
    assert interop.leaf_mismatches(interop.state_to_numpy(ref),
                                   interop.state_to_numpy(got)) == []
    assert interop.leaf_mismatches(interop.obs_to_numpy(ref_obs),
                                   interop.obs_to_numpy(obs)) == []
    with pytest.raises(ValueError, match="ctrl given"):
        tf.run_faulted_heartbeats(
            st, at["conns"], at["rev"], at["out_mask"],
            torch.from_numpy(att), pt, adv, off, None, None, None, 4,
            ctrl=tst.init_adaptive_ctrl(N, "cpu"))


def _cfg(pkg, ckpt):
    camp, sim, topo, fmod = ((jc, jsim, JTopo, jf) if pkg == "jax"
                             else (tc, tsim, TTopo, tf))
    return camp.CampaignConfig(
        scenario="sybil_graft_flood", fractions=(0.2,), seeds=(0, 1),
        experiment=sim.ExperimentConfig(
            topo=topo(network_size=64, anchor_stages=3, msg_size_bytes=2000,
                      messages=1, delay_seconds=1.0),
            connect_to=8, warmup_s=5.0, seed=1, serialize_answers=False,
            gossipsub=camp.attack_gossipsub()),
        attack_heartbeats=6, checkpoint_dir=ckpt,
        # the partition stays open over the publishes
        faults=fmod.FaultParams(
            crash_frac=0.1, crash_window=(1, 4), partition_frac=0.4,
            partition_window=(3, 40), spike_frac=0.1, spike_window=(0, 3),
            spike_ms=40.0))


def test_faulted_campaign_checkpoints_and_resume(tmp_path):
    rj = jc.run_campaign(_cfg("jax", str(tmp_path / "j")))
    rt = tc.run_campaign(_cfg("torch", str(tmp_path / "t")), device="cpu")
    fields = interop.result_fields(rt, walls=False)
    assert fields == interop.result_fields(rj, walls=False)
    att = [t for t in rt.trials if t.fraction > 0]
    assert all(0.0 < t.coverage_under_partition < 1.0 for t in att)
    assert all(t.post_churn_reconvergence_hb != 0 for t in att)
    # the open partition cut the publishes: coverage below the benign one
    assert any(t.honest_coverage < t.benign_coverage for t in att)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 4
    for name in names:
        with np.load(tmp_path / "j" / name) as zj, \
                np.load(tmp_path / "t" / name) as zt:
            assert zj.files == zt.files, name
            for k in zj.files:
                assert zj[k].tobytes() == zt[k].tobytes(), (name, k)
    again = tc.run_campaign(_cfg("torch", str(tmp_path / "t")),
                            device="cpu")
    assert interop.result_fields(again, walls=False) == fields
    assert all(w["resumed"] for w in again.phase_walls if w["fraction"] > 0)
