"""AST lint of the port's sources: the reference's GA-A005, verbatim.

Static source analysis, no imports of the linted modules: the rule works on
the parse tree alone, so the linter runs in milliseconds.

  GA-A005  json.dump/json.dumps without allow_nan=False and without routing
           through runtime.summarize.sanitize_nonfinite(): non-finite
           floats would poison the strict-JSON artifact chain. Applies to
           whole files.

A line ending in ``# graft-audit: ok`` waives any rule on that line. A file
that does not parse is reported under GA-A001, as the reference reports
it.

The reference's GA-A001-A004 are a taint analysis over jitted scopes
(functions under ``jax.jit`` and the scan/while/cond bodies nested in
them): host math, host coercion, Python branching and host syncs on a
tracer. The port has no jitted scope: every function runs eagerly, and a
Python branch on a device value is a host sync by design (the serial
engine's loop, the campaign's window conds). Their torch meaning is the
host-sync count, which runtime/profiling.py records per contract (the
aten._local_scalar_dense calls in its op log) and reports without gating
on it.
"""

from __future__ import annotations

import ast
import os

from .report import Violation, suppressed_lines


def _check_json_calls(tree: ast.Module, path: str, suppressed: set[int],
                      violations: list[Violation]) -> None:
    """GA-A005 over the whole file (artifact writers live outside jit)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in ("dump", "dumps")
                and isinstance(f.value, ast.Name) and f.value.id == "json"):
            continue
        ok = any(
            kw.arg == "allow_nan"
            and isinstance(kw.value, ast.Constant) and kw.value.value is False
            for kw in node.keywords)
        if not ok and node.args:
            first = node.args[0]
            if (isinstance(first, ast.Call)
                    and ((isinstance(first.func, ast.Name)
                          and first.func.id == "sanitize_nonfinite")
                         or (isinstance(first.func, ast.Attribute)
                             and first.func.attr == "sanitize_nonfinite"))):
                ok = True
        if not ok and node.lineno not in suppressed:
            violations.append(Violation(
                rule="GA-A005", file=path, line=node.lineno,
                message=f"json.{f.attr}() without allow_nan=False — wrap the "
                        "payload in runtime.summarize.sanitize_nonfinite() "
                        "or pass allow_nan=False (strict-JSON artifacts)"))


def lint_source(source: str, path: str) -> list[Violation]:
    """Lint one file's source text; `path` is used only for reporting."""
    violations: list[Violation] = []
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation(rule="GA-A001", file=path, line=e.lineno or 0,
                          message=f"syntax error: {e.msg}")]
    _check_json_calls(tree, path, suppressed_lines(source), violations)
    return violations


def lint_paths(paths: list[str], repo_root: str) -> tuple[list[Violation], int]:
    """Lint every .py file under `paths`; returns (violations, file_count)."""
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                files.extend(os.path.join(dirpath, fn)
                             for fn in filenames if fn.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    violations: list[Violation] = []
    for fp in sorted(set(files)):
        with open(fp, encoding="utf-8") as f:
            source = f.read()
        rel = os.path.relpath(fp, repo_root)
        violations.extend(lint_source(source, rel))
    return violations, len(set(files))
