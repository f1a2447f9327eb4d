"""The port's conformance gate (analysis/conformance.py) against the
reference's, on the CPU: every entry of the certificate's canon (the eight
attack scenarios, adaptive, faults, churn, opportunistic graft and the
waived gossip_fragments row, whose wait is the one float a clean
certificate carries) equal to JAX's field by field; both mutants caught
with JAX's records; classification, strict JSON, the `conform` command,
one fuzz sample, and a campaign's attached certificate."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.analysis import conformance as jc
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import faults as jf
from dst_libp2p_test_node_tpu.runtime import campaign as jcamp
from dst_libp2p_test_node_tpu_torch import cli
from dst_libp2p_test_node_tpu_torch.analysis import conformance as tc
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import faults as tf
from dst_libp2p_test_node_tpu_torch.ops.repair import RepairParams
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tcamp
from dst_libp2p_test_node_tpu_torch.runtime.simulator import ExperimentConfig

torch.set_num_threads(1)

# the reference's own CPU reading of the waived row's wait (ms)
GOSSIP_FRAGMENTS_WAIT = 5.81817626953125

META = dict(seeds=[0], n=48, steps=8)


def _entry(mod, name, **dev):
    if name in jadv.SCENARIOS:
        divs = mod.run_scenario_differential(name, **dev)
    elif name == "gossip_fragments":
        divs = mod.cross_fragment_check(**dev)
    else:
        divs = {"adaptive": mod.run_adaptive_differential,
                "faults": mod.run_faults_differential,
                "churn": mod.run_churn_differential,
                "opportunistic_graft": mod.run_og_differential}[name](**dev)
    return mod.certificate_entry(name, divs, mod.load_waivers(), **META)


@pytest.mark.parametrize("name", list(jadv.SCENARIOS) + [
    "adaptive", "faults", "churn", "opportunistic_graft",
    "gossip_fragments"])
def test_certificate_entry_equals_reference(name):
    want = _entry(jc, name)
    got = _entry(tc, name, device="cpu")
    assert got == want
    if name == "gossip_fragments":
        (d,) = got["divergences"]
        assert d["max_abs_err"] == GOSSIP_FRAGMENTS_WAIT
        assert d["sim_sample"] == GOSSIP_FRAGMENTS_WAIT
        assert got["status"] == "waived"
        assert d["waiver"] == "cross-fragment-answer-serialization"
    else:
        assert got["status"] == "pass"


@pytest.mark.parametrize("mutant", sorted(tc.MUTANTS))
def test_mutant_is_caught_with_the_reference_records(mutant):
    got = tc.run_scenario_differential("sybil_graft_flood", device="cpu",
                                       mutate=tc.MUTANTS[mutant])
    want = jc.run_scenario_differential("sybil_graft_flood",
                                        mutate=jc.MUTANTS[mutant])
    assert got and got == want
    classified = tc.classify(got, tc.load_waivers())
    assert all(d["classification"] == "sim_bug" for d in classified)
    entry = tc.certificate_entry("sybil_graft_flood", got,
                                 tc.load_waivers())
    assert entry["status"] == "fail"


def test_unknown_divergence_classifies_as_sim_bug():
    fake = [{"scenario": "sybil_graft_flood", "seed": 0, "step": 1,
             "field": "mesh_mask", "count": 3, "max_abs_err": 1.0,
             "sim_sample": True, "spec_sample": False}]
    out = tc.classify(fake, tc.load_waivers())
    assert out[0]["classification"] == "sim_bug"
    assert out[0]["waiver"] is None
    assert tc.load_waivers() == jc.load_waivers()


def test_certificate_is_strict_json(tmp_path):
    cert = tc.conformance_certificate(
        scenarios=("sybil_graft_flood",), seeds=(0, 1),
        include_adaptive=False, include_faults=False, include_churn=False,
        include_gossip=True, include_og=False, device="cpu")
    path = tc.write_certificate(cert, tmp_path / "conformance.json")

    def _refuse(tok):
        raise AssertionError(f"non-finite {tok}")

    loaded = json.loads(path.read_text(), parse_constant=_refuse)
    assert loaded == jc.conformance_certificate(
        scenarios=("sybil_graft_flood",), seeds=(0, 1),
        include_adaptive=False, include_faults=False, include_churn=False,
        include_gossip=True, include_og=False)
    assert loaded["clean"] is True and loaded["sim_bugs"] == 0
    assert [e["scenario"] for e in loaded["entries"]] == [
        "sybil_graft_flood", "gossip_fragments"]


def test_conform_command_in_process(tmp_path, capsys):
    out = tmp_path / "cert.json"
    rc = cli.main(["conform", "--device", "cpu", "--scenario",
                   "eclipse_publisher", "--out", str(out)])
    assert rc == 0
    cert = json.loads(out.read_text())
    assert cert["clean"] is True
    # as in the reference CLI, --scenario leaves the og walk in
    assert [e["scenario"] for e in cert["entries"]] == [
        "eclipse_publisher", "opportunistic_graft"]
    assert "conform: eclipse_publisher" in capsys.readouterr().err


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.run_scenario_differential("sybil_graft_flood")
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.conformance_certificate(scenarios=("ihave_spam",))
    for argv in (["conform", "--scenario", "ihave_spam"], ["trace"]):
        with pytest.raises(SystemExit):
            cli.main(argv)


def test_fuzz_sample_equals_reference():
    kw = dict(n=48, connect_to=8, seed=0, steps=4, warm_steps=2, fuzz_seed=1)
    ((name, knobs, divs),) = tc.run_fuzz_differential(1, device="cpu", **kw)
    ((jname, jknobs, jdivs),) = jc.run_fuzz_differential(1, **kw)
    assert (name, knobs, divs) == (jname, jknobs, jdivs)
    assert name.startswith("fuzz:") and divs == []


def _campaign_cfg(conformance):
    exp = ExperimentConfig(
        topo=TopoParams(network_size=128, anchor_stages=3,
                        msg_size_bytes=2000, messages=2, delay_seconds=1.0),
        connect_to=10, warmup_s=5.0, seed=1,
        gossipsub=tcamp.attack_gossipsub(flood_publish=False))
    return tcamp.CampaignConfig(
        scenario="eclipse_publisher", fractions=(0.0, 0.2), seeds=(0,),
        experiment=exp, attack_heartbeats=6, recovery_heartbeats=4,
        repair=RepairParams(evict=True, px=True, redial=True),
        adversary=tadv.AdversaryParams(
            scenario="eclipse_publisher",
            adaptive=tadv.AdaptivePolicy(enabled=True)),
        faults=tf.FaultParams(crash_frac=0.1, crash_window=(1, 4),
                              spike_frac=0.1, spike_window=(0, 3)),
        conformance=conformance)


def test_campaign_attaches_the_reference_certificate():
    on = tcamp.run_campaign(_campaign_cfg(True), device="cpu")
    off = tcamp.run_campaign(_campaign_cfg(False), device="cpu")
    assert off.conformance is None
    strip = ("wall_s",)
    assert ([{k: v for k, v in t.to_dict().items() if k not in strip}
             for t in on.trials]
            == [{k: v for k, v in t.to_dict().items() if k not in strip}
                for t in off.trials])
    jcfg = dataclasses.replace(
        jcamp.CampaignConfig(scenario="eclipse_publisher"),
        adversary=jadv.AdversaryParams(
            scenario="eclipse_publisher",
            adaptive=jadv.AdaptivePolicy(enabled=True)),
        faults=jf.FaultParams(crash_frac=0.1, crash_window=(1, 4),
                              spike_frac=0.1, spike_window=(0, 3)))
    want = jcamp._campaign_conformance(jcfg, jcfg.adversary_params())
    assert on.conformance == want
    assert [e["scenario"] for e in want["entries"]] == [
        "eclipse_publisher", "adaptive", "faults"]
    assert on.conformance["clean"] is True
    assert on.to_dict()["conformance"] == want
    assert np.isfinite([t.honest_coverage for t in on.trials]).all()
