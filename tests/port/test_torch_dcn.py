"""The port's DCN campaign (runtime/campaign.run_campaign(dcn=),
merge_dcn_rank_results, parallel/sharding.dcn_allreduce) on the CPU:

  - merge_dcn_rank_results against the reference's on the same rank
    payloads (host code, called directly): the merged result field for
    field, and the same errors for a gap in the ranks, a seed two ranks
    claim and a seed no rank claims;
  - dcn_allreduce without a process group (the identity) and its op check
    against the reference's message;
  - scripts/dcn_campaign_torch.py: two gloo processes over a FileStore,
    each on its own one-group grid, with the conformance certificate on;
    the merged result equal to the single-process campaign
    outside the walls, the counts cross-checked against the all-reduce in
    every rank, and the rank files carrying rank 0's certificate (rank 1's
    none), which the merged result keeps;
  - scripts/dcn_smoke_torch.py: two gloo processes over localhost, its
    step 5 (one heartbeat and one disseminate on each process's rows of
    a 64-peer peer mesh over the two processes, the fixpoints through
    converge_sharded) equal, row for row, to the single-process run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.parallel import sharding as jsh
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.parallel import sharding as tsh
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc
from dst_libp2p_test_node_tpu_torch.runtime.summarize import (
    sanitize_nonfinite)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEEDS = (0, 1, 2)


def _payloads(res, nproc=2):
    """Rank files of `res`'s trials dealt round-robin over nproc ranks,
    through the strict-JSON round trip a rank file takes."""
    out = []
    for r in range(nproc):
        seeds = list(SEEDS)[r::nproc]
        out.append(json.loads(json.dumps(sanitize_nonfinite({
            "format_version": tc.DCN_RANK_FORMAT, "rank": r, "nproc": nproc,
            "seeds": seeds, "scenario": res.scenario,
            "network_size": res.network_size, "hb_budget": res.hb_budget,
            "wall_s": 1.5 + r, "degraded": r == 1, "retries_total": r,
            "quarantined_trials": [], "conformance": None,
            "trials": [t.to_dict() for t in res.trials if t.seed in seeds],
        }), allow_nan=False)))
    return out


def test_merge_matches_reference():
    cfg = tc.CampaignConfig(
        fractions=(0.0, 0.2), seeds=SEEDS, attack_heartbeats=2,
        experiment=tc.ExperimentConfig(
            topo=tc.ExperimentConfig().topo.__class__(
                network_size=32, anchor_stages=2, messages=1),
            connect_to=6, gossipsub=tc.attack_gossipsub(), warmup_s=2.0))
    res = tc.run_campaign(cfg, device="cpu")
    jcfg = jc.CampaignConfig(fractions=(0.0, 0.2), seeds=SEEDS)
    payloads = _payloads(res)
    for wall in (None, 7.25):
        got = tc.merge_dcn_rank_results(cfg, payloads, wall_s=wall)
        want = jc.merge_dcn_rank_results(jcfg, payloads, wall_s=wall)
        assert interop.result_fields(got) == interop.result_fields(want)
    assert (interop.result_fields(got, walls=False)["trials"]
            == interop.result_fields(res, walls=False)["trials"])
    assert got.retries_total == 1 and got.degraded
    bad = (
        [dict(payloads[0], rank=0), dict(payloads[1], rank=2)],
        [payloads[0], dict(payloads[1], seeds=[1, 2])],
        [payloads[0], dict(payloads[1], seeds=[])],
    )
    for ps in bad:
        with pytest.raises(ValueError) as te:
            tc.merge_dcn_rank_results(cfg, ps)
        with pytest.raises(ValueError) as je:
            jc.merge_dcn_rank_results(jcfg, ps)
        assert str(te.value) == str(je.value)


def test_dcn_allreduce_without_a_group():
    v = np.array([1.5, -2.0, 3.0], np.float32)
    for op in ("sum", "max"):
        out = tsh.dcn_allreduce(v, op=op)
        assert out.dtype == np.float32 and out.tolist() == v.tolist()
    with pytest.raises(ValueError) as te:
        tsh.dcn_allreduce(v, op="mean")
    with pytest.raises(ValueError) as je:
        jsh.dcn_allreduce(v, op="mean")
    assert str(te.value) == str(je.value)
    assert tsh.process_count() == 1 and tsh.process_index() == 0


def test_two_process_dcn_campaign(tmp_path):
    work = tmp_path / "work"
    out = tmp_path / "dcn.json"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "dcn_campaign_torch.py"),
         "--device", "cpu", "--seeds", "3", "--conformance",
         "--workdir", str(work), "--out", str(out), "--timeout", "120"],
        env=env, capture_output=True, text=True, timeout=280)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = json.loads(out.read_text())
    assert result["bit_identical"] is True
    assert result["trials"] == 6 and result["nproc"] == 2
    ranks = [json.loads((work / "dcn" / f"dcn_rank{r}.trials.json")
                        .read_text()) for r in range(2)]
    assert [r["seeds"] for r in ranks] == [[0, 2], [1]]
    assert ranks[0]["conformance"]["clean"] is True
    assert ranks[1]["conformance"] is None
    merged = json.loads((work / "dcn" / tc.DCN_MERGED_BASENAME).read_text())
    single = json.loads((work / "single.json").read_text())
    assert merged["conformance"] == ranks[0]["conformance"] \
        == single["conformance"]


def test_dcn_smoke_step5_shards_the_fixpoint(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "dcn_smoke_torch.py"),
         "--device", "cpu"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=280)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "dcn_smoke_torch: PASS" in out
    oks = [ln for ln in out.splitlines()
           if "sharded==single-process OK" in ln]
    assert len(oks) == 2
    assert "fixpoint rows=[0, 32)" in oks[0] + oks[1]
    assert "fixpoint rows=[32, 64)" in oks[0] + oks[1]
