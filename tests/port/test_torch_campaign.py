"""The port's campaign runner (runtime/campaign.py) against the reference,
on the CPU:

  - a two-seed eclipse campaign with a recovery window (evict + px +
    redial), the flight recorder armed and checkpoints on, against the
    reference's vmapped run: every TrialResult field outside the walls
    equal, float fields included (no tolerance was needed: the reference
    pins its vmapped windows at rtol 1e-5, tests/test_telemetry.py);
  - the trial checkpoints and .obs.npz sidecars equal array for array, in
    the reference's key order; a second sweep on the same directory
    resumes every trial and gives the same result, and the port resumes
    from the reference's files;
  - single-trial cells (vmap_trials=False) equal;
  - the fraction-0.0 contract: the benign trial is a plain Simulator's
    bytes (the reference's tests/test_adversary.py:60-95);
  - CampaignMetrics text and the interop round trip;
  - the paths of later slices raise naming their slice, and the fault,
    DHT and adaptive configs that once did now run as the reference's
    (or fail with its error)."""

import os

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.ops.repair import RepairParams as JRepair
from dst_libp2p_test_node_tpu.ops.telemetry import TelemetryParams as JTel
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu.runtime import metrics as jmetrics
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops.repair import RepairParams as TRepair
from dst_libp2p_test_node_tpu_torch.ops.telemetry import (
    TelemetryParams as TTel)
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc
from dst_libp2p_test_node_tpu_torch.runtime import metrics as tmetrics
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

_PKG = {"jax": (jc, jsim, JTopo, JRepair, JTel),
        "torch": (tc, tsim, TTopo, TRepair, TTel)}


def _cfg(pkg, scenario="eclipse_publisher", ckpt=None, recovery=8,
         fractions=(0.0, 0.2), seeds=(0, 1), **kw):
    camp, sim, topo, repair, tel = _PKG[pkg]
    return camp.CampaignConfig(
        scenario=scenario, fractions=fractions, seeds=seeds,
        experiment=sim.ExperimentConfig(
            topo=topo(network_size=128, anchor_stages=3, msg_size_bytes=2000,
                      messages=2, delay_seconds=1.0),
            connect_to=10, warmup_s=5.0, seed=1,
            gossipsub=camp.attack_gossipsub(
                flood_publish=scenario != "eclipse_publisher")),
        attack_heartbeats=6, recovery_heartbeats=recovery,
        repair=repair(evict=True, px=True, redial=True),
        telemetry=tel(record=True), checkpoint_dir=ckpt, **kw)


def _fields(res):
    return interop.result_fields(res, walls=False)


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    d = tmp_path_factory.mktemp("camp")
    rj = jc.run_campaign(_cfg("jax", ckpt=str(d / "j")))
    rt = tc.run_campaign(_cfg("torch", ckpt=str(d / "t")), device="cpu")
    return d, rj, rt


def test_campaign_matches_vmapped_reference(campaigns):
    _, rj, rt = campaigns
    assert _fields(rt) == _fields(rj)
    att = [t for t in rt.trials if t.fraction > 0]
    assert att and all(t.redials_total > 0 for t in att)
    assert any(t.recovery_time_ms > 0 for t in att)
    assert all(t.coverage90_hb != -1 for t in rt.trials if t.fraction > 0)
    assert rt.to_dict()["trials"][0]["hb_budget"] == rj.hb_budget


def test_trial_checkpoints_array_for_array(campaigns):
    d, _, _ = campaigns
    names = sorted(os.listdir(d / "j"))
    assert names == sorted(os.listdir(d / "t")) and len(names) == 4
    for name in names:
        with np.load(d / "j" / name) as zj, np.load(d / "t" / name) as zt:
            assert zj.files == zt.files, name
            for k in zj.files:
                assert zj[k].dtype == zt[k].dtype, (name, k)
                assert zj[k].tobytes() == zt[k].tobytes(), (name, k)


def test_resume_equals_uninterrupted(campaigns):
    d, rj, rt = campaigns
    again = tc.run_campaign(_cfg("torch", ckpt=str(d / "t")), device="cpu")
    assert _fields(again) == _fields(rt)
    resumed = [w for w in again.phase_walls if w["fraction"] > 0]
    assert resumed and all(w["resumed"] for w in resumed)
    assert all("attack_window" not in w for w in resumed)
    # and from the reference's own checkpoint files
    cross = tc.run_campaign(_cfg("torch", ckpt=str(d / "j")), device="cpu")
    assert _fields(cross) == _fields(rj)


def test_single_trial_cells():
    kw = dict(scenario="iwant_spam", recovery=0, fractions=(0.1,),
              vmap_trials=False)
    rj = jc.run_campaign(_cfg("jax", **kw))
    rt = tc.run_campaign(_cfg("torch", **kw), device="cpu")
    assert _fields(rt) == _fields(rj)
    assert [t.seed for t in rt.trials] == [0, 1]


def _exp(mod, topo, seed=3):
    camp = jc if mod is jsim else tc
    return mod.ExperimentConfig(
        topo=topo(network_size=64, msg_size_bytes=2000, messages=3,
                  delay_seconds=1.0),
        connect_to=8, gossipsub=camp.attack_gossipsub(), warmup_s=5.0,
        seed=seed)


def test_zero_attacker_campaign_is_a_plain_simulator():
    plain = tsim.Simulator(_exp(tsim, TTopo), device="cpu")
    plain_records = plain.run()
    sim = tsim.Simulator(_exp(tsim, TTopo), device="cpu")
    tc._reset_trial(sim, 3)
    sim.warmup()
    records = tc._publish_schedule(sim)
    assert len(records) == len(plain_records) > 0
    for rp, rc in zip(plain_records, records):
        assert rp.msg_id == rc.msg_id
        assert rp.delays_ms.tobytes() == rc.delays_ms.tobytes()
        assert np.array_equal(rp.received, rc.received)
    assert interop.leaf_mismatches(interop.state_to_numpy(plain.state),
                                   interop.state_to_numpy(sim.state)) == []
    res = tc.run_campaign(tc.CampaignConfig(
        scenario="sybil_graft_flood", fractions=(0.0,), seeds=(3,),
        experiment=_exp(tsim, TTopo), attack_heartbeats=2), device="cpu")
    t = res.trials[0]
    pool = np.concatenate([r.delays_ms[r.received] for r in plain_records])
    assert t.latency_p50_ms == float(np.percentile(pool, 50))
    assert t.honest_coverage == float(
        np.mean([r.received.mean() for r in plain_records]))
    assert t.latency_inflation == 1.0 and t.attackers == 0


def test_campaign_metrics_and_interop(campaigns):
    _, rj, rt = campaigns
    mj, mt = jmetrics.CampaignMetrics(), tmetrics.CampaignMetrics()
    dj, dt = rj.to_dict(), rt.to_dict()
    mj.fill_from_campaign(dj)
    mt.fill_from_campaign(dt)
    assert mt.render() == mj.render()
    # the same dict renders the same text in both packages
    mj2 = jmetrics.CampaignMetrics()
    mj2.fill_from_campaign(dt)
    assert mj2.render() == mt.render()
    back = interop.campaign_from_fields(interop.result_fields(rj))
    assert back.to_dict() == dj
    obs = {"graylisted_frac": np.arange(4, dtype=np.float32),
           "tel_score_q": np.ones((4, 3), np.float32)}
    again = interop.obs_to_numpy(interop.obs_from_numpy(obs, "cpu"))
    assert interop.leaf_mismatches(obs, again) == []


def test_later_slices_raise_by_name(campaigns):
    cfg = _cfg("torch", recovery=0)
    # the peer mesh is a later slice; a trial grid must be a grid; a DCN
    # campaign without a checkpoint directory fails as the reference's does
    with pytest.raises(NotImplementedError, match="peer mesh"):
        tc.run_campaign(cfg, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="make_trial_mesh"):
        tc.run_campaign(cfg, device="cpu", trial_mesh=object())
    with pytest.raises(ValueError) as te:
        tc.run_campaign(cfg, device="cpu", dcn=True)
    with pytest.raises(ValueError) as je:
        jc.run_campaign(_cfg("jax", recovery=0), dcn=True)
    assert str(te.value) == str(je.value)
    # the conformance certificate is ported now (the conformance slice;
    # tests/port/test_torch_conformance.py runs it): the config validates
    _cfg("torch", recovery=0, conformance=True).validate()
    # ported with this campaign's slice: the same config gives the
    # reference's fields, or its error
    from dst_libp2p_test_node_tpu.ops import adversary as jadv
    from dst_libp2p_test_node_tpu.ops import dht_adversary as jda
    from dst_libp2p_test_node_tpu.ops import faults as jf
    from dst_libp2p_test_node_tpu_torch.ops import dht_adversary as tda
    from dst_libp2p_test_node_tpu_torch.ops import faults as tf

    for over in (
            lambda f, d, a: dict(faults=f.FaultParams(
                partition_frac=0.3, partition_window=(1, 3))),
            lambda f, d, a: dict(dht=d.DhtAdversaryParams(
                lookup_eclipse=True)),
            lambda f, d, a: dict(adversary=a.AdversaryParams(
                scenario="eclipse_publisher",
                adaptive=a.AdaptivePolicy(enabled=True)))):
        out = []
        for pkg, mods in (("jax", (jf, jda, jadv)),
                          ("torch", (tf, tda, tadv))):
            c = _cfg(pkg, recovery=0, seeds=(0,), **over(*mods))
            run = (jc.run_campaign if pkg == "jax" else
                   lambda c: tc.run_campaign(c, device="cpu"))
            try:
                out.append(_fields(run(c)))
            except ValueError as e:
                out.append(str(e))
        assert out[0] == out[1]
    # the reference's own config errors stay errors
    with pytest.raises(ValueError, match="flood_publish"):
        c = _cfg("torch", recovery=0)
        c.experiment.gossipsub = tc.attack_gossipsub()
        c.validate()
