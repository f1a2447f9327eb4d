"""Violation model + strict-JSON report, the reference's
(dst_libp2p_test_node_tpu/analysis/report.py) unchanged: the same rule
ids, the same `"tool": "graft-audit"`, `"version": 1` report shape
(`allow_nan=False`, sorted keys, deterministic violation order), so a
report of the port's `lint` diffs byte for byte against the reference's.

Every finding is a Violation with a stable rule id, a repo-relative
file:line anchor, and (for contract findings) the registered entry point
it ran under. The catalog keeps every reference id; the port's engines
emit GA-A005 (analysis/ast_lint.py), GA-J005 (analysis/
jaxpr_audit.py: feedback drift, a failed runtime check), GA-J001 for
an entry point that fails to run, the reference's id for one that fails
to trace, and GA-S001-S004 and GA-S006 (analysis/sharding_audit.py; the
reference's catalog has no slug for GA-S006, and neither has this one).
README.md says why the others have no torch meaning.

  GA-J001  host/io/debug callback inside a scan/while_loop body
  GA-J002  x64 dtype or weak-type promotion drift in a loop carry
  GA-J003  declared lax.cond elided (vmapped cond lowered to select_n)
  GA-J004  declared buffer donation does not hold in the lowering
  GA-J005  compile-key count / feedback aval drift across the bench ladder
  GA-A001  np./math. call on a traced value inside a jitted scope
  GA-A002  float()/int()/bool() host coercion of a traced value
  GA-A003  Python `if`/`while`/ternary branching on a traced value
  GA-A004  device_get/block_until_ready/.item() host sync in a jitted scope
  GA-A005  json.dump without allow_nan=False or sanitize_nonfinite()
  GA-S001  large operand replicated inside a sharded (multi-partition)
           contract
  GA-S002  collective kind in the compiled HLO not in the contract's
           declared `collectives` budget set
  GA-S003  summed per-device collective byte volume over the declared
           budget
  GA-S004  per-device peak memory over the declared HBM budget
  GA-S005  donation declared but not aliased in the COMPILED output
"""

from __future__ import annotations

import dataclasses
import json

SUPPRESS_COMMENT = "# graft-audit: ok"

RULES = {
    "GA-J001": "callback-in-loop",
    "GA-J002": "x64-or-weak-carry",
    "GA-J003": "cond-elided",
    "GA-J004": "donation-not-honored",
    "GA-J005": "compile-key-drift",
    "GA-A001": "np-math-on-tracer",
    "GA-A002": "host-coercion-of-tracer",
    "GA-A003": "python-branch-on-tracer",
    "GA-A004": "host-sync-in-traced-scope",
    "GA-A005": "nonfinite-reachable-json",
    "GA-S001": "replicated-large-operand",
    "GA-S002": "undeclared-collective",
    "GA-S003": "collective-bytes-over-budget",
    "GA-S004": "peak-memory-over-budget",
    "GA-S005": "donation-not-aliased-compiled",
}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str              # GA-Jxxx / GA-Axxx id from RULES
    file: str              # repo-relative path (or module path for traces)
    line: int              # 1-based; 0 when no source anchor exists
    message: str
    entrypoint: str | None = None  # registry name for jaxpr-engine findings

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["slug"] = RULES.get(self.rule, "unknown")
        return d


def render_report(violations: list[Violation], *, checked_files: int = 0,
                  checked_entrypoints: int = 0,
                  sharding: dict | None = None,
                  waived: list[dict] | None = None,
                  rung: dict | None = None) -> str:
    """Strict-JSON audit report; deterministic ordering, refuses NaN/Inf.

    Optional blocks (present only when the corresponding engine ran):
    `sharding` — per-contract GSPMD facts from the sharding auditor;
    `waived` — findings suppressed by a pinned contract waiver, each with
    its rationale; `rung` — the 1M-rung feasibility certificate."""
    vs = sorted(violations, key=lambda v: (v.file, v.line, v.rule, v.message))
    counts: dict[str, int] = {}
    for v in vs:
        counts[v.rule] = counts.get(v.rule, 0) + 1
    out = {
        "tool": "graft-audit",
        "version": 1,
        "clean": not vs,
        "checked_files": checked_files,
        "checked_entrypoints": checked_entrypoints,
        "counts": counts,
        "violations": [v.to_dict() for v in vs],
    }
    if sharding is not None:
        out["sharding"] = sharding
    if waived is not None:
        out["waived"] = sorted(
            waived, key=lambda w: (w.get("entrypoint") or "", w.get("rule")
                                   or "", w.get("message") or ""))
    if rung is not None:
        out["rung_certificate"] = rung
    return json.dumps(out, indent=2, sort_keys=True, allow_nan=False)


def _gh_escape(text: str) -> str:
    """GitHub Actions workflow-command payload escaping."""
    return (text.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A"))


def github_annotations(violations: list[Violation],
                       waived: list[dict] | None = None) -> list[str]:
    """`::error`/`::notice` workflow-command lines (`lint --format github`):
    one per finding, anchored at the violation's file:line so GA-* findings
    render inline on PRs. Waived findings come through as notices — visible
    on the diff, not failing the gate."""
    lines = []
    for v in sorted(violations,
                    key=lambda v: (v.file, v.line, v.rule, v.message)):
        who = f" [{v.entrypoint}]" if v.entrypoint else ""
        lines.append(
            f"::error file={_gh_escape(v.file)},line={max(v.line, 1)},"
            f"title={v.rule} {RULES.get(v.rule, 'unknown')}::"
            f"{_gh_escape(v.message + who)}")
    for w in waived or []:
        lines.append(
            f"::notice file={_gh_escape(w.get('file') or 'unknown')},"
            f"line={max(int(w.get('line') or 1), 1)},"
            f"title={w.get('rule')} waived::"
            f"{_gh_escape((w.get('message') or '') + ' — waiver: ' + (w.get('rationale') or ''))}")
    return lines


def suppressed_lines(source: str) -> set[int]:
    """1-based line numbers carrying the in-line waiver comment."""
    return {
        i
        for i, text in enumerate(source.splitlines(), start=1)
        if SUPPRESS_COMMENT in text
    }
