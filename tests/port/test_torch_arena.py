"""The port's protocol arena (runtime/campaign.run_arena_campaign and the
`arena` command) against the reference, on the CPU:

  - the artifact equal to the reference's field by field (wall_s aside)
    at 64 peers in the reference's arena-probe shape (bench.py: benign
    plus sybil_graft_flood against the adaptive attacker, 2 messages 0.5
    s apart, 8 s warm-up, 6 attack heartbeats), once as the probe runs it
    and once with two seeds and the three fault families composed (the
    partition still open over the publishes);
  - the pairing: one graph, and per (scenario, seed) cell the same cohort
    sha on both protocols' rows; the probe's gate (benign coverage >=
    0.95 for both, episub's benign bandwidth below GossipSub's);
  - the three refusals and trial_mesh naming its slice;
  - the `arena` command: the reference's scenario refusals,
    --trial-groups naming its slice, --json strict and equal to an
    in-process run."""

import json

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import faults as jf
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import cli
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import faults as tf
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 64
SCENARIO = "sybil_graft_flood"
FAULTS = dict(crash_frac=0.1, crash_window=(1, 4), partition_frac=0.4,
              partition_window=(2, 9), spike_frac=0.1, spike_window=(0, 3),
              spike_ms=37.5)
CASES = {"probe": ((0,), {}), "faults": ((0, 1), FAULTS)}


def _cfg(ref: bool, seeds=(0,), faults=None, flood=False, fractions=(0.25,),
         adaptive=True, n=N):
    topo, adv, camp, sim, flt = ((JTopo, jadv, jc, jsim, jf) if ref
                                 else (TTopo, tadv, tc, tsim, tf))
    return camp.CampaignConfig(
        scenario=SCENARIO, fractions=fractions, seeds=seeds,
        experiment=sim.ExperimentConfig(
            topo=topo(network_size=n, anchor_stages=3, msg_size_bytes=2000,
                      messages=2, delay_seconds=0.5),
            connect_to=8,
            gossipsub=camp.attack_gossipsub(flood_publish=flood),
            publisher_id=4, warmup_s=8.0, seed=0),
        adversary=adv.AdversaryParams(
            scenario=SCENARIO,
            adaptive=adv.AdaptivePolicy(enabled=adaptive)),
        attack_heartbeats=6, faults=flt.FaultParams(**(faults or {})))


@pytest.fixture(scope="module")
def arenas():
    out = {}
    for case, (seeds, faults) in CASES.items():
        want = jc.run_arena_campaign(_cfg(True, seeds, faults))
        got = tc.run_arena_campaign(_cfg(False, seeds, faults),
                                    device="cpu")
        out[case] = (want, got)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_arena_matches_reference(arenas, case):
    want, got = (dict(a) for a in arenas[case])
    assert want.pop("wall_s") >= 0.0 and got.pop("wall_s") >= 0.0
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
    assert json.loads(json.dumps(got, allow_nan=False)) == got


def test_pairing_and_the_probe_gate(arenas):
    art = arenas["faults"][1]
    ident = art["identity"]
    assert len(ident["graph_sha256"]) == 64
    assert ident["flood_publish"] is False
    assert ident["episub_root"] == ident["publisher"] == 4
    rows = {(t["scenario"], t["protocol"], t["seed"]): t
            for t in art["trials"]}
    assert len(rows) == len(art["trials"]) == 2 * 2 * 2
    zero = tc._cohort_sha(np.zeros(N, dtype=bool))
    assert zero == jc._cohort_sha(np.zeros(N, dtype=bool))
    for sc in art["scenarios"]:
        for s in (0, 1):
            g, e = rows[(sc, "gossipsub", s)], rows[(sc, "episub", s)]
            assert g["cohort_sha256"] == e["cohort_sha256"] \
                == ident["cohort_sha256"][sc][str(s)]
            assert (g["cohort_sha256"] == zero) == (sc == "benign")
    assert len({rows[(SCENARIO, "gossipsub", s)]["cohort_sha256"]
                for s in (0, 1)}) == 2
    cells = sum(len(v) for v in art["wins"].values())
    assert cells == 2 * len(tc.ARENA_OBJECTIVES)
    assert sum(art["win_counts"].values()) + art["ties"] == cells
    # the reference probe's gate (bench.py)
    agg = {(r["scenario"], r["protocol"]): r
           for r in arenas["probe"][1]["rows"]}
    for proto in ("gossipsub", "episub"):
        assert agg[("benign", proto)]["coverage"] >= 0.95
    assert (agg[("benign", "episub")]["bandwidth_bytes"]
            < agg[("benign", "gossipsub")]["bandwidth_bytes"])


def test_refusals():
    for kw in (dict(flood=True), dict(fractions=(0.0,)),
               dict(adaptive=False)):
        with pytest.raises(ValueError) as te:
            tc.run_arena_campaign(_cfg(False, **kw), device="cpu")
        with pytest.raises(ValueError) as je:
            jc.run_arena_campaign(_cfg(True, **kw))
        assert str(te.value) == str(je.value)
    with pytest.raises(NotImplementedError, match="A13"):
        tc.run_arena_campaign(_cfg(False), trial_mesh=object(),
                              device="cpu")


def test_cli_refusals(capsys):
    for argv in (["--scenarios", "benign,not_a_scenario"],
                 ["--scenarios", "benign"], ["--fraction", "1.5"],
                 ["--trial-groups", "2"]):
        with pytest.raises(SystemExit) as e:
            cli.cmd_arena(argv + ["--device", "cpu"])
        assert e.value.code == 2
    assert "multi-GPU (A13)" in capsys.readouterr().err


def test_cli_json_is_strict_and_the_run(tmp_path, capsys):
    out = tmp_path / "arena.json"
    rc = cli.main(["arena", "-n", "32", "--seeds", "0", "--attack-heartbeats",
                   "4", "--warmup-s", "4", "--lazy-degree", "2", "--json",
                   str(out), "--device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "gossipsub" in text and "episub" in text
    assert text.splitlines()[-1].startswith("[torch backend device=cpu]")

    def refuse(tok):
        raise ValueError(tok)

    art = json.loads(out.read_text(), parse_constant=refuse)
    from dst_libp2p_test_node_tpu_torch.ops.episub import EpisubParams

    cfg = _cfg(False, n=32)
    cfg.attack_heartbeats = 4
    cfg.experiment.warmup_s = 4.0
    want = tc.run_arena_campaign(cfg, ep=EpisubParams(root=4, lazy_degree=2),
                                 device="cpu")
    want.pop("wall_s")
    art.pop("wall_s")
    assert art == json.loads(json.dumps(want))
