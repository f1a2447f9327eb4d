"""The port's `lint` (analysis/ast_lint.py, analysis/report.py and the
contract engine) on the CPU: the golden GA-A005 fixtures
(tests/fixtures/graft_audit/, parsed, never imported) trip exactly their
rule and their clean twins pass; the reference's GA-A001-A004 fixtures
trip nothing here (the port has no jitted scope); the report is the
reference's byte for byte; the `lint` process exits nonzero on a bad
fixture, 0 on the repo (26 entry points), and its mesh flags give their
blocks (--sharding: the sharding facts and the waived findings;
--predict-rung and its --rung-* options: the rung certificate).
And the registry drift gate, the twin of tests/test_registry_drift.py:
every port module that calls a native kernel is reached from a registered
contract or sits on an allowlist that must stay exact."""

import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from dst_libp2p_test_node_tpu.analysis import report as jreport
from dst_libp2p_test_node_tpu_torch.analysis import report as treport
from dst_libp2p_test_node_tpu_torch.analysis.ast_lint import (lint_paths,
                                                              lint_source)
from dst_libp2p_test_node_tpu_torch.analysis.registry import (
    default_contracts)

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "dst_libp2p_test_node_tpu_torch"
FIXTURES = REPO / "tests" / "fixtures" / "graft_audit"
FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("ga_a00*_*.py"))


def _lint(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "dst_libp2p_test_node_tpu_torch", "lint",
         *args], capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=300)


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_golden_fixture_trips_exactly_ga_a005_where_it_should(name):
    path = FIXTURES / name
    found = lint_source(path.read_text(), str(path))
    if name == "ga_a005_bad.py":
        assert [v.rule for v in found] == ["GA-A005"]
        assert found[0].file == str(path) and found[0].line == 8
    else:
        assert found == [], found


def test_suppression_comment_waives_the_line():
    src = ("import json\n"
           "json.dumps({})  # graft-audit: ok\n"
           "json.dumps({})\n"
           "json.dumps({}, allow_nan=False)\n"
           "json.dump({}, f, allow_nan=True)\n"
           "json.dump(sanitize_nonfinite({}), f)\n")
    assert [v.line for v in lint_source(src, "x.py")] == [3, 5]
    assert [v.rule for v in lint_source("def f(:\n", "y.py")] == ["GA-A001"]


def test_report_is_the_references_byte_for_byte():
    vs = [treport.Violation(rule="GA-A005", file="b.py", line=3,
                            message="m"),
          treport.Violation(rule="GA-J005", file="a.py", line=9,
                            message="drift", entrypoint="run_heartbeats")]
    jvs = [jreport.Violation(**v.__dict__) for v in vs]
    assert treport.RULES == jreport.RULES
    assert treport.render_report(vs, checked_files=2, checked_entrypoints=1) \
        == jreport.render_report(jvs, checked_files=2, checked_entrypoints=1)
    assert treport.github_annotations(vs) == jreport.github_annotations(jvs)
    doc = json.loads(treport.render_report(vs))
    assert (doc["tool"], doc["version"], doc["clean"]) == (
        "graft-audit", 1, False)


def test_the_port_and_the_smoke_lint_clean():
    violations, files = lint_paths([str(PKG), str(REPO / "chip_smoke.py")],
                                   str(REPO))
    assert violations == []
    assert files > 50


def test_lint_process_fails_on_a_bad_fixture():
    bad = FIXTURES / "ga_a005_bad.py"
    proc = _lint("--no-jaxpr", "--device", "cpu", str(bad))
    assert proc.returncode == 1, proc.stderr
    report = json.loads(proc.stdout)
    assert report["clean"] is False and report["checked_files"] == 1
    assert [(v["file"], v["rule"], v["line"]) for v in report["violations"]
            ] == [(os.path.relpath(bad, PKG.parent), "GA-A005", 8)]


def test_lint_process_is_clean_on_the_repo(tmp_path):
    out = tmp_path / "report.json"
    proc = _lint("--device", "cpu", "--checkify", "--out", str(out),
                 "--format", "github")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""              # no finding, no annotation
    report = json.loads(out.read_text())
    assert report["clean"] is True
    assert report["checked_entrypoints"] == 26
    assert report["checked_files"] > 50


@pytest.mark.parametrize("flag", [
    ["--sharding", "--only", "campaign/attack_window_sharded"],
    ["--predict-rung"], ["--predict-rung", "4096"],
    ["--predict-rung", "--rung-dcn", "2"],
    ["--predict-rung", "--rung-scenario", "arena"],
    ["--predict-rung", "--rung-out", "RUNG_OUT"]])
def test_mesh_flags_give_their_blocks(flag, tmp_path, monkeypatch):
    from dst_libp2p_test_node_tpu_torch import cli
    from dst_libp2p_test_node_tpu_torch.analysis import sharding_audit

    # the rung fits at small points (each runs the window on 4 CPU ranks)
    monkeypatch.setattr(sharding_audit, "RUNG_FIT_POINTS", (64, 128, 256))
    flag = [str(tmp_path / "r.json") if x == "RUNG_OUT" else x
            for x in flag]
    out = tmp_path / "report.json"
    assert cli.main(["lint", "--device", "cpu", "--no-ast", "--no-jaxpr",
                     *flag, "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["clean"] is True
    if flag[0] == "--sharding":
        assert report["checked_entrypoints"] == 1
        assert list(report["sharding"]) == ["campaign/attack_window_sharded"]
        assert [w["rule"] for w in report["waived"]] == ["GA-S001"] * 2
        assert "rung_certificate" not in report
        return
    cert = report["rung_certificate"]
    assert "sharding" not in report and "waived" not in report
    assert cert["validation"]["within_10pct"]
    assert [p["peers"] for p in cert["fit_points"]] == [64, 128, 256]
    assert cert["rung"]["peers"] == (4096 if "4096" in flag else 1048576)
    dcn = int(flag[flag.index("--rung-dcn") + 1]) if "--rung-dcn" in flag \
        else 1
    assert cert["rung"]["dcn"] == dcn and cert["rung"]["trials"] == 4 * dcn
    assert cert["modeled_device"]["chips"] == 8 * dcn
    assert cert["rung"]["scenario"] == (
        "protocol_arena/episub" if "arena" in flag else "sybil_graft_flood")
    if "--rung-out" in flag:
        assert json.loads((tmp_path / "r.json").read_text()) == cert


def test_lint_without_a_card_refuses_the_default_device():
    env_probe = ("import torch,sys; sys.exit(0 if torch.cuda.is_available()"
                 " else 1)")
    has_card = subprocess.run([sys.executable, "-c", env_probe]).returncode
    proc = _lint("--no-ast", "--no-jaxpr")
    if has_card == 1:
        assert proc.returncode == 2
        assert "no CUDA device" in proc.stderr
    else:
        assert proc.returncode == 0


# ---------------------------------------------------- registry drift gate

_KERNEL_CALL = re.compile(r"(?<!def )\b(vmem_gather|score_update)\(")

# modules that call a kernel but are not the module of a registered
# contract's entry point, each with the reason
ALLOWLIST = {
    "parallel/exchange": (
        "the receiver-side fixpoint's gather runs only above the row-gather "
        "budget (N*C*128*4 bytes over 6 GiB: the 1M class, config 4's 4 "
        "fragments), never at the registry's audit shapes; chip_smoke.py "
        "phases 2-5 drive it, and the microbench sweep times its kernel"),
    "runtime/microbench": (
        "the tuning harness calls both kernels to MEASURE launch "
        "candidates; it is never a production entry point"),
}


def _kernel_modules() -> set[str]:
    found = set()
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(PKG).with_suffix("")
        if rel.parts[0] == "native":
            continue
        if _KERNEL_CALL.search(f.read_text()):
            found.add("/".join(rel.parts))
    return found


def _covered_modules() -> set[str]:
    prefix = "dst_libp2p_test_node_tpu_torch."
    covered = set()
    for c in default_contracts("cpu"):
        fn = c.build().fn
        while isinstance(fn, functools.partial):
            fn = fn.func
        mod = getattr(fn, "__module__", "") or ""
        if mod.startswith(prefix):
            covered.add(mod[len(prefix):].replace(".", "/"))
    return covered


def test_every_kernel_calling_module_has_a_contract_or_waiver():
    uncovered = sorted(_kernel_modules() - _covered_modules()
                       - set(ALLOWLIST))
    assert not uncovered, (
        f"modules calling a native kernel with no EntrypointContract and no "
        f"allowlist entry: {uncovered}")


def test_allowlist_entries_are_live_and_necessary():
    kernel = _kernel_modules()
    covered = _covered_modules()
    assert sorted(m for m in ALLOWLIST if m not in kernel) == []
    assert sorted(m for m in ALLOWLIST if m in covered) == []
    assert all(ALLOWLIST.values())


def test_drift_scan_sees_the_known_callers():
    kernel = _kernel_modules()
    assert {"ops/heartbeat", "ops/telemetry", "parallel/exchange"} <= kernel
    assert {"ops/heartbeat", "ops/telemetry", "native/score_update"} <= (
        _covered_modules())
