"""The sharding auditor (analysis/sharding_audit.py) and the six mesh
contracts (analysis/registry.py) on CPU ranks (tests/port/conftest.py's
cpu_mesh: 2 ranks, each its own trial group; cpu_grid: 2 x 2):

  - (a) the port's contract names are the reference's 26, in its order;
    each mesh contract's spec inputs equal the reference spec's leaf by
    leaf (the port keeps the repair leaves the reference strips; the dcn
    spec against the reference's built at the port's 2 x 1 placement),
    and its output equals the port's one-device loop over the same
    trials (the window's own body, one trial after another), bitwise;
  - the facts: exactly the legacy layout's two GA-S001 findings (conns,
    rev), waived with the reference's rationale; zero cross-block bytes
    in the dcn contract; every collective byte counted by kind;
  - (b) one mutant per rule fires and its clean twin does not: GA-S001 (a
    replicated table: the legacy layout without its waiver), GA-S002 (an
    undeclared kind), GA-S003 (a budget one byte under the measured
    bytes), GA-S006 (blocks one rank wide, so each peer group spans two);
    GA-S004 on facts dicts (no allocator peak on the CPU);
  - (e) `lint --sharding --device cpu` as a process (the contract
    engine off: tests/port/test_torch_lint.py runs it): exit 0, clean, 26
    entry points, the waived notices under --format github; lint exits
    1 on each mutant, with its ::error annotation."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dst_libp2p_test_node_tpu.analysis import registry as jreg
from dst_libp2p_test_node_tpu_torch import cli
from dst_libp2p_test_node_tpu_torch.analysis import registry as treg
from dst_libp2p_test_node_tpu_torch.analysis import sharding_audit as sa
from dst_libp2p_test_node_tpu_torch.analysis.contracts import numpy_leaves
from dst_libp2p_test_node_tpu_torch.ops.pull import batch_scope
from dst_libp2p_test_node_tpu_torch.parallel.sharding import tree_map
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
MESH = ("campaign/faulted_window_nested", "campaign/attack_window_sharded",
        "campaign/attack_window_nested", "campaign/attack_window_dcn",
        "campaign/dht_attack_window", "protocol/arena_window")
# the reference strips these where its params leave repair inert; the
# port's windows take them along either way
REPAIR = ("px_pool", "starve_hb", "evictions", "px_grafts", "redials")


@pytest.fixture(scope="module")
def port(cpu_mesh, cpu_grid):
    return {c.name: c for c in treg.default_contracts(
        "cpu", pool=cpu_mesh, grid=cpu_grid)}


@pytest.fixture(scope="module")
def facts(port):
    return {name: sa.audit_sharding_contract(port[name]) for name in MESH}


def test_port_names_are_the_references_26(port):
    names = [c.name for c in jreg.default_contracts()]
    assert list(port) == names and len(names) == 26
    assert [n for n in names if n in MESH] == list(MESH)


@pytest.mark.parametrize("name", MESH)
def test_mesh_spec_inputs_equal_the_references(port, name, monkeypatch):
    # the reference's dcn spec at the port's placement: 2 blocks x 1 group
    monkeypatch.setattr(jreg, "_dcn_audit_shape", lambda: (2, 1))
    ref = {c.name: c for c in jreg.default_contracts()}[name].build()
    spec = port[name].build()
    want, got = numpy_leaves(ref.args), numpy_leaves(spec.args)
    extra = set(got) - set(want)
    if name == "campaign/dht_attack_window":
        assert extra == set()
    else:
        assert extra == {f"[0].{k}" for k in REPAIR}
    assert set(want) <= set(got)
    for k, a in want.items():
        assert (got[k].dtype, got[k].shape) == (a.dtype, a.shape), k
        assert got[k].tobytes() == a.tobytes(), k
    for k in ("steps", "local_trials", "publisher", "nested"):
        assert spec.kwargs.get(k) == ref.kwargs.get(k), k


def _one_device_loop(body, trial_mesh, n_rows, stacked_args, shared,
                     nested=True, batch_factor=None):
    """_run_nested_window's result from the window's own body run on one
    device, one trial after another."""
    lead = []
    tree_map(lambda x: lead.append(x.shape[0]), tuple(stacked_args))
    outs = []
    with batch_scope(batch_factor or 1):
        for j in range(lead[0]):
            outs.append(body(*tree_map(lambda x: x[j], tuple(stacked_args)),
                             shared))
    return tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])


@pytest.mark.parametrize("name", MESH)
def test_mesh_contract_output_equals_the_one_device_loop(port, name,
                                                         monkeypatch):
    spec = port[name].build()
    got = numpy_leaves(spec.thunk()())
    monkeypatch.setattr(tc, "_run_nested_window", _one_device_loop)
    want = numpy_leaves(port[name].build().thunk()())
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].tobytes() == a.tobytes(), k


def test_facts_the_legacy_waivers_and_the_dcn_blocks(facts):
    for name, (violations, waived, f) in facts.items():
        assert violations == [], name
        json.dumps(f, allow_nan=False)
        assert f["memory"] == {"peak_measured": False,
                               "rank_peak_bytes": None, "peak": None}
        if name == "campaign/attack_window_sharded":
            assert sorted(w["message"].split()[1] for w in waived) == [
                "shared.conns", "shared.rev"]
            assert {w["rule"] for w in waived} == {"GA-S001"}
            assert all("replicated-peer-submesh" in w["rationale"]
                       for w in waived)
            assert f["collectives"] == {} and f["running_ranks"] == 2
        else:
            assert waived == [] and f["replicated_operands"] == []
            assert f["running_ranks"] == 4
            assert {"all_gather", "all_reduce"} <= set(f["collectives"])
            assert f["collective_bytes"] == max(f["rank_collective_bytes"])
            assert f["collective_bytes"] == max(
                sum(c["per_rank_bytes"] for c in f["collectives"].values()),
                f["collective_bytes"])
    dcn = facts["campaign/attack_window_dcn"][2]
    assert dcn["collective_bytes_by_scope"]["cross_dcn"] == 0
    assert dcn["collective_bytes_by_scope"]["intra_block"] == \
        dcn["collective_bytes"] > 0


def _fires(contract, rule):
    v, w, _ = sa.audit_sharding_contract(contract)
    return [x.rule for x in v].count(rule)


@pytest.mark.parametrize("rule", ["GA-S001", "GA-S002", "GA-S003",
                                  "GA-S006"])
def test_each_rule_fires_on_its_mutant_not_on_its_twin(port, facts, rule):
    nested = port["campaign/attack_window_nested"]
    measured = facts["campaign/attack_window_nested"][2]["collective_bytes"]
    if rule == "GA-S001":
        legacy = port["campaign/attack_window_sharded"]
        mutant, twin = dataclasses.replace(legacy, waivers=()), nested
        assert _fires(mutant, rule) == 2
    elif rule == "GA-S002":
        mutant = dataclasses.replace(nested,
                                     collectives=frozenset({"all_gather"}))
        twin = nested
        assert _fires(mutant, rule) == 1
    elif rule == "GA-S003":
        mutant = dataclasses.replace(nested,
                                     collective_bytes_budget=measured - 1)
        twin = dataclasses.replace(nested, collective_bytes_budget=measured)
        assert _fires(mutant, rule) == 1
    else:
        dcn = port["campaign/attack_window_dcn"]
        mutant = dataclasses.replace(dcn, dcn_block_devices=1)
        twin = dcn
        assert _fires(mutant, rule) == 1
    assert _fires(twin, rule) == 0


def test_one_run_serves_the_feedback_check_too(port):
    nested = port["campaign/attack_window_nested"]
    spec = nested.build()

    def drifting(*args, **kwargs):
        (states, obs) = spec.fn(*args, **kwargs)
        return states.replace(grafts=states.grafts.long()), obs

    bad = dataclasses.replace(
        nested, build=lambda: dataclasses.replace(spec, fn=drifting))
    v, w, _ = sa.audit_sharding_contract(bad, feedback=True)
    assert [x.rule for x in v] == ["GA-J005"] and "grafts" in v[0].message
    assert sa.audit_sharding_contract(bad)[0] == []


def test_a_waiver_moves_its_finding_to_waived(port):
    nested = port["campaign/attack_window_nested"]
    mutant = dataclasses.replace(
        nested, collectives=frozenset({"all_gather"}),
        waivers=(("GA-S002", "pinned for the test"),))
    v, w, _ = sa.audit_sharding_contract(mutant)
    assert v == [] and [x["rule"] for x in w] == ["GA-S002"]
    assert w[0]["rationale"] == "pinned for the test"


@pytest.mark.parametrize("peak,fires", [(treg.NESTED_HBM + 1, 1),
                                        (treg.NESTED_HBM, 0), (None, 0)])
def test_ga_s004_on_a_facts_dict(port, facts, peak, fires):
    nested = port["campaign/attack_window_nested"]
    f = dict(facts["campaign/attack_window_nested"][2])
    f["memory"] = {"peak_measured": peak is not None,
                   "rank_peak_bytes": None if peak is None else [peak] * 4,
                   "peak": peak}
    found = sa.sharding_findings(nested, f)
    assert [x.rule for x in found] == ["GA-S004"] * fires


def _lint(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "dst_libp2p_test_node_tpu_torch", "lint",
         *args], capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=600)


def test_lint_sharding_process_is_clean_with_26_entry_points(tmp_path):
    out = tmp_path / "report.json"
    proc = _lint("--device", "cpu", "--no-jaxpr", "--sharding", "--out",
                 str(out), "--format", "github")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    notices = proc.stdout.splitlines()
    assert len(notices) == 2 and all(
        n.startswith("::notice ") and "GA-S001 waived" in n
        for n in notices)
    report = json.loads(out.read_text())
    assert report["clean"] is True and report["checked_entrypoints"] == 26
    assert sorted(report["sharding"]) == sorted(
        c.name for c in jreg.default_contracts())
    assert [w["entrypoint"] for w in report["waived"]] == [
        "campaign/attack_window_sharded"] * 2
    scope = report["sharding"]["campaign/attack_window_dcn"][
        "collective_bytes_by_scope"]
    assert scope["cross_dcn"] == 0


@pytest.mark.parametrize("rule", ["GA-S001", "GA-S002", "GA-S003",
                                  "GA-S006"])
def test_lint_exits_nonzero_on_each_mutant(monkeypatch, capsys, rule):
    real = treg.default_contracts

    def mutants(device=None, pool=None, grid=None):
        c = {x.name: x for x in real(device, grid=grid)}
        nested = c["campaign/attack_window_nested"]
        return [{
            "GA-S001": dataclasses.replace(
                c["campaign/attack_window_sharded"], waivers=()),
            "GA-S002": dataclasses.replace(
                nested, collectives=frozenset({"broadcast"})),
            "GA-S003": dataclasses.replace(nested,
                                           collective_bytes_budget=1024),
            "GA-S006": dataclasses.replace(c["campaign/attack_window_dcn"],
                                           dcn_block_devices=1),
        }[rule]]

    monkeypatch.setattr(treg, "default_contracts", mutants)
    rc = cli.main(["lint", "--device", "cpu", "--no-ast", "--no-jaxpr",
                   "--sharding", "--format", "github"])
    out = capsys.readouterr().out
    assert rc == 1
    errors = [ln for ln in out.splitlines() if ln.startswith("::error ")]
    assert errors and all(f"title={rule} " in ln for ln in errors)
    report = json.loads(out[out.index("{"):])
    assert report["clean"] is False and rule in report["counts"]


def test_the_rules_and_the_reference_share_their_catalog():
    from dst_libp2p_test_node_tpu.analysis import sharding_audit as jsa

    assert sa.REPLICATED_FLOOR_BYTES == jsa.REPLICATED_FLOOR_BYTES
    assert sa.RUNG_PEERS == jsa.RUNG_PEERS
    assert (sa.RUNG_TRIAL_GROUPS, sa.RUNG_PEER_WIDTH) == (
        jsa.RUNG_TRIAL_GROUPS, jsa.RUNG_PEER_WIDTH)
    assert sa.H100_GPUS == 8
    assert treg._dcn_audit_shape() == (2, 1)
