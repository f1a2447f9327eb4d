"""The contract engine: run every registered entry point and certify it
against its declared contract (the port's half of the reference's jaxpr
auditor, dst_libp2p_test_node_tpu/analysis/jaxpr_audit.py; the module keeps
its name so the two trees line up).

Eager torch has no jaxpr: each contract's spec RUNS, once, on the device
its contract was built for, at the registry's audit shapes (a mesh
contract's window on its rank pool, the stacked outputs back on that
device). What carries over:

  GA-J005  the feedback half: every carried output's leaves equal the
           argument leaves it is fed back into in dtype, shape and device.
           Dtype drift (an int32 leaf that comes back int64, a float32 one
           promoted to float64) is the torch form of the reference's aval
           drift: the next call would compute in the wrong type, and a
           checkpoint would write other bytes.
  GA-J005  run_checkify: each contract's runtime_check asserts the
           reference's checkify invariants in plain torch (registry.py).
  GA-S004  on CUDA, the call's device-memory rise over the contract's
           hbm_budget_bytes (torch.cuda.max_memory_allocated); for a
           mesh contract, whose budget is a rank's, the sharding auditor
           checks each rank's rise instead (analysis/sharding_audit.py).
  GA-J001  an entry point that fails to run, the reference's id for one
           that fails to trace.

What has no torch meaning: GA-J001's callback census (no scan body to
hold a callback; the host work per round is counted as host syncs by
runtime/profiling.py instead), GA-J002 (no loop carry is traced: a
carried leaf's dtype drift is GA-J005's feedback check above), GA-J003 (no
lax.cond to elide: every branch is a Python branch), GA-J004 (no buffer
donation) and the compile-key count of GA-J005 (nothing is compiled per
shape).
"""

from __future__ import annotations

import functools
import inspect
import os

import torch

from .contracts import EntrypointContract, TraceSpec, leaves
from .report import Violation


def _src_anchor(fn) -> tuple[str, int]:
    """(file, line) of the entry point's def, through partials/wrappers."""
    target = fn
    while isinstance(target, functools.partial):
        target = target.func
    target = inspect.unwrap(target)
    try:
        path = inspect.getsourcefile(target) or "<unknown>"
        _, line = inspect.getsourcelines(target)
        return os.path.relpath(path), line
    except (TypeError, OSError):
        return "<unknown>", 0


def spec_device(spec: TraceSpec) -> torch.device:
    """The device of the spec's first tensor argument."""
    for x in leaves((spec.args, spec.kwargs), strict=False).values():
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def run_spec(spec: TraceSpec):
    """Run the spec once and wait for the device."""
    out = spec.thunk()()
    dev = spec_device(spec)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def _fingerprint(tree) -> dict:
    out = {}
    for path, x in leaves(tree).items():
        if isinstance(x, torch.Tensor):
            out[path] = (tuple(x.shape), str(x.dtype), str(x.device))
        else:
            out[path] = (type(x).__name__,)
    return out


def check_feedback(contract: EntrypointContract, spec: TraceSpec, out,
                   file: str, line: int) -> list[Violation]:
    violations = []
    for out_get, arg_get in contract.feedback:
        fed, arg = _fingerprint(out_get(out)), _fingerprint(arg_get(spec))
        if fed == arg:
            continue
        if set(fed) != set(arg):
            what = (f"leaves {sorted(set(fed) ^ set(arg))[:4]} on one side "
                    "only")
        else:
            k = next(k for k in arg if fed[k] != arg[k])
            what = f"leaf {k}: out {fed[k]} vs arg {arg[k]}"
        violations.append(Violation(
            rule="GA-J005", file=file, line=line, entrypoint=contract.name,
            message=f"feedback drift ({what}) — feeding this output back "
                    "changes the next call's types or placement"))
    return violations


def audit_contract(contract: EntrypointContract) -> list[Violation]:
    """Run one registered entry point and check its contract."""
    spec = contract.build()
    file, line = _src_anchor(spec.fn)
    dev = spec_device(spec)
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        out = run_spec(spec)
    except Exception as e:  # a run failure is itself a finding
        return [Violation(
            rule="GA-J001", file=file, line=line, entrypoint=contract.name,
            message=f"entrypoint failed to run: {e!r}")]
    violations = check_feedback(contract, spec, out, file, line)
    if (dev.type == "cuda" and contract.hbm_budget_bytes is not None
            and spec_pool(spec) is None):
        rise = torch.cuda.max_memory_allocated(dev) - base
        if rise > contract.hbm_budget_bytes:
            violations.append(Violation(
                rule="GA-S004", file=file, line=line,
                entrypoint=contract.name,
                message=f"device memory rose {rise} B over the call, above "
                        f"the {contract.hbm_budget_bytes} B budget"))
    return violations


def spec_pool(spec: TraceSpec):
    """The parallel/ranks.RankPool a mesh contract's window runs on, or
    None (the spec runs in this process)."""
    from ..parallel.ranks import RankPool

    pool = spec.kwargs.get("trial_mesh")
    return pool if isinstance(pool, RankPool) else None


def audit_contracts(contracts) -> list[Violation]:
    out: list[Violation] = []
    for c in contracts:
        out.extend(audit_contract(c))
    return out


def run_checkify(contracts) -> list[Violation]:
    """Run each contract's runtime check on the canonical small config. A
    failed check surfaces as a violation with the check's message."""
    out: list[Violation] = []
    for c in contracts:
        if c.runtime_check is None:
            continue
        file, line = _src_anchor(c.build().fn)
        try:
            c.runtime_check()
        except Exception as e:
            out.append(Violation(
                rule="GA-J005", file=file, line=line, entrypoint=c.name,
                message=f"runtime contract failed: {e}"))
    return out
