"""The port's DHT adversary (ops/dht_adversary.py) and the DHT-backed
recovery against the reference, on the CPU, bitwise (no tolerance):

  - the host-side cohort material: minted sybil keys, the sybil
    directory, the poison inserts and the closed-form poison budget;
  - build_attacked_dht for each attack family and all composed (with a
    retry budget on the evictions), then dht_repair_pool attacked and
    healed: every KadState leaf, the directory, both pools and the
    measured poison fraction;
  - run_dht_recovery_heartbeats (sybils refuse, consume-on-examine):
    state, graph, pool and curves; no pool is the plain recovery window;
  - interop: AdaptiveCtrl, fault cohorts, KadState and pools cross
    between the packages and back unchanged;
  - a DHT campaign (eclipse + poison + cluster, healing at round 3: two
    recovery legs, the second resuming the dialed graph) with
    checkpoints: TrialResult fields, checkpoint files (kad/* leaves
    included) and a resume, each equal to the reference's."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import Topology
from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import dht_adversary as jda
from dst_libp2p_test_node_tpu.ops import faults as jf
from dst_libp2p_test_node_tpu.ops import heartbeat as jhb
from dst_libp2p_test_node_tpu.ops import kad as jkad
from dst_libp2p_test_node_tpu.ops import repair as jrep
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import dht_adversary as tda
from dst_libp2p_test_node_tpu_torch.ops import kad as tkad
from dst_libp2p_test_node_tpu_torch.ops import repair as trep
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 128
ARMED = dict(slow_weight=-10.0, slow_decay=0.9, graylist_threshold=-50.0,
             gossip_threshold=-10.0, publish_threshold=-20.0, evict=True,
             px=True, redial=True)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _same(want, got):
    want = np.asarray(want)
    assert want.dtype == got.numpy().dtype
    assert want.tobytes() == got.numpy().tobytes()


@pytest.fixture(scope="module")
def net():
    topo = Topology.build(JTopo(network_size=N, anchor_stages=3))
    att = jadv.attacker_cohort(N, 0.2, seed=0, publisher=4)
    return (jnp.asarray(topo.stage_of_peer), jnp.asarray(topo.latency_ms),
            torch.as_tensor(topo.stage_of_peer),
            torch.as_tensor(topo.latency_ms), att)


def test_cohort_material_host_side(net):
    att = net[4]
    keys = jkad.make_keys(N, 3)
    for bits in (0, 5, 16, 40, 128):
        assert np.array_equal(jda.mint_sybil_keys(keys, att, 4, bits, 1),
                              tda.mint_sybil_keys(keys, att, 4, bits, 1))
    for size in (1, 16, 64):
        assert np.array_equal(jda.sybil_directory(keys, att, 4, size),
                              tda.sybil_directory(keys, att, 4, size))
    none = np.zeros(N, bool)
    assert np.array_equal(jda.sybil_directory(keys, none, 4, 8),
                          tda.sybil_directory(keys, none, 4, 8))
    for a in (att, none):
        assert np.array_equal(jda.poison_candidates(N, a, 8, 2),
                              tda.poison_candidates(N, a, 8, 2))
    for args in ((8, 16, 8, 0), (8, 16, 8, 16), (64, 4, 2, 3), (1, 1, 1, 0)):
        assert (jda.rtable_poison_budget(*args)
                == tda.rtable_poison_budget(*args))
    for bad in (dict(poison_per_peer=0), dict(cluster_prefix_bits=129),
                dict(warmup_waves=0), dict(evict_max_fails=0)):
        with pytest.raises(ValueError) as te:
            tda.DhtAdversaryParams(**bad).validate()
        with pytest.raises(ValueError) as je:
            jda.DhtAdversaryParams(**bad).validate()
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("flags", [
    dict(discovery=True),
    dict(lookup_eclipse=True, evict_max_fails=3, evict_backoff_ms=250.0),
    dict(rtable_poison=True),
    dict(lookup_eclipse=True, rtable_poison=True, sybil_cluster=True)],
    ids=["discovery", "eclipse_retry", "poison", "composed"])
def test_build_attacked_dht_and_pools(net, flags):
    stage_j, lat_j, stage_t, lat_t, att = net
    dj, dt = jda.DhtAdversaryParams(**flags), tda.DhtAdversaryParams(**flags)
    kj, dir_j = jda.build_attacked_dht(N, 0, dj, att, 4, stage_j, lat_j)
    kt, dir_t = tda.build_attacked_dht(N, 0, dt, att, 4, stage_t, lat_t)
    assert interop.leaf_mismatches(interop.leaves_to_numpy(kj),
                                   interop.leaves_to_numpy(kt)) == []
    assert (dir_j is None) == (dir_t is None) == (not dj.lookup_eclipse)
    if dir_j is not None:
        _same(dir_j, dir_t)
    frac = tda.rtable_poison_frac(kt, att)
    assert frac == jda.rtable_poison_frac(kj, att)
    if dj.rtable_poison:
        assert 0.0 < frac
    att_j, att_t = jnp.asarray(att), torch.from_numpy(att)
    for healed in (False, True):
        pj, kj = jda.dht_repair_pool(kj, dj, stage_j, lat_j, attacker=att_j,
                                     directory=dir_j, healed=healed)
        pt, kt = tda.dht_repair_pool(kt, dt, stage_t, lat_t, attacker=att_t,
                                     directory=dir_t, healed=healed)
        _same(pj, pt)
        assert interop.leaf_mismatches(interop.leaves_to_numpy(kj),
                                       interop.leaves_to_numpy(kt)) == []
        assert not (pt == torch.arange(N)[:, None]).any()


def test_dht_recovery_window(net):
    att = net[4]
    g = build_connection_graph(N, 10, seed=1, max_degree=40)
    pj = jst.SimParams(n=N, capacity=g.capacity, **ARMED)
    pt = tst.SimParams(n=N, capacity=g.capacity, **ARMED)
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    sj = jhb.run_heartbeats(jst.init_state(pj, 3), aj["conns"], aj["rev"],
                            aj["out_mask"], pj, 10)
    sj, _ = jadv.run_attacked_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att), pj,
        jadv.AdversaryParams(), 8)
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    pool = np.random.default_rng(3).integers(-1, N, (N, 16)).astype(np.int32)
    cj, oj = jrep.run_dht_recovery_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att), pj, 8,
        dht_pool=jnp.asarray(pool), publisher=4)
    ct, ot = trep.run_dht_recovery_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], torch.from_numpy(att),
        pt, 8, dht_pool=torch.from_numpy(pool), publisher=4)
    assert interop.leaf_mismatches(_leaves(cj[0]),
                                   interop.state_to_numpy(ct[0])) == []
    for w, g_ in zip(cj[1:], ct[1:]):
        _same(w, g_)
    assert interop.leaf_mismatches(
        {k: np.asarray(v) for k, v in oj.items()},
        interop.obs_to_numpy(ot)) == []
    assert set(ot) >= {"dht_pool_left", "starve_max"}
    # examined entries are consumed: the pool only empties
    assert bool((ot["dht_pool_left"][1:] <= ot["dht_pool_left"][:-1]).all())
    # no pool: the plain recovery window
    (s1, *g1), o1 = trep.run_dht_recovery_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], torch.from_numpy(att),
        pt, 3, publisher=4)
    (s2, *g2), o2 = trep.run_recovery_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], torch.from_numpy(att),
        pt, 3, publisher=4)
    assert interop.leaf_mismatches(interop.state_to_numpy(s2),
                                   interop.state_to_numpy(s1)) == []
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_state_crosses_between_packages(net):
    att = net[4]
    zeros = np.zeros(N, np.int32)
    ctrl = jst.AdaptiveCtrl(
        viol_est=jnp.asarray(np.linspace(0, 3, N, dtype=np.float32)),
        regrafts=jnp.asarray(zeros + 2), px_injected=jnp.asarray(zeros),
        throttled_hb=jnp.asarray(zeros + 1))
    leaves = interop.leaves_to_numpy(ctrl)
    ct = interop.dataclass_from_numpy(tst.AdaptiveCtrl, leaves, "cpu")
    assert isinstance(ct, tst.AdaptiveCtrl)
    assert interop.leaf_mismatches(leaves, interop.leaves_to_numpy(ct)) == []
    masks = jf.fault_masks(N, jf.FaultParams(
        crash_frac=0.1, crash_window=(1, 3), partition_frac=0.3,
        partition_window=(0, 2)), 0, 4)
    mt = interop.obs_from_numpy(masks, "cpu")
    assert all(v.dtype == torch.bool for v in mt.values())
    assert interop.leaf_mismatches(masks, interop.obs_to_numpy(mt)) == []
    kj, _ = jda.build_attacked_dht(
        N, 1, jda.DhtAdversaryParams(rtable_poison=True), att, 4,
        net[0], net[1])
    kl = interop.leaves_to_numpy(kj)
    kt = interop.dataclass_from_numpy(tkad.KadState, kl, "cpu")
    assert isinstance(kt, tkad.KadState) and kt.keys.dtype == torch.int64
    assert interop.leaf_mismatches(kl, interop.leaves_to_numpy(kt)) == []
    pool = {"pool": np.arange(-1, 15, dtype=np.int32).reshape(4, 4)}
    assert interop.leaf_mismatches(pool, interop.obs_to_numpy(
        interop.obs_from_numpy(pool, "cpu"))) == []


def _cfg(pkg, ckpt):
    camp, sim, topo, rep, da = (
        (jc, jsim, JTopo, jrep, jda) if pkg == "jax"
        else (tc, tsim, TTopo, trep, tda))
    return camp.CampaignConfig(
        scenario="eclipse_publisher", fractions=(0.2,), seeds=(0, 1),
        experiment=sim.ExperimentConfig(
            topo=topo(network_size=64, anchor_stages=3, msg_size_bytes=2000,
                      messages=1, delay_seconds=1.0),
            connect_to=8, warmup_s=5.0, seed=1, serialize_answers=False,
            gossipsub=camp.attack_gossipsub(flood_publish=False)),
        attack_heartbeats=6, recovery_heartbeats=6,
        repair=rep.RepairParams(evict=True, px=True, redial=True),
        checkpoint_dir=ckpt,
        dht=da.DhtAdversaryParams(lookup_eclipse=True, rtable_poison=True,
                                  sybil_cluster=True, heal_hb=3))


def test_dht_campaign_two_legs_and_resume(tmp_path):
    rj = jc.run_campaign(_cfg("jax", str(tmp_path / "j")))
    rt = tc.run_campaign(_cfg("torch", str(tmp_path / "t")), device="cpu")
    fields = interop.result_fields(rt, walls=False)
    assert fields == interop.result_fields(rj, walls=False)
    assert all(0.0 < t.rtable_poison_frac < 1.0 for t in rt.trials)
    assert all("dht_build" in w for w in rt.phase_walls)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 4
    for name in names:
        with np.load(tmp_path / "j" / name) as zj, \
                np.load(tmp_path / "t" / name) as zt:
            assert zj.files == zt.files, name
            if not name.endswith(".obs.npz"):
                assert any(k.startswith("kad/") for k in zt.files)
            for k in zj.files:
                assert zj[k].tobytes() == zt[k].tobytes(), (name, k)
    again = tc.run_campaign(_cfg("torch", str(tmp_path / "t")),
                            device="cpu")
    assert interop.result_fields(again, walls=False) == fields
    assert all(w["resumed"] for w in again.phase_walls)
    # the reference's own checkpoint files resume in the port
    cross = tc.run_campaign(_cfg("torch", str(tmp_path / "j")),
                            device="cpu")
    assert interop.result_fields(cross, walls=False) == fields
