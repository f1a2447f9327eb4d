"""Cost and retrace accounting per registered entry point, and trace
export: the reference's runtime/profiling.py in torch terms.

  entrypoint_cost   {flops, hbm_bytes, peak_memory_bytes} of one call of a
                    contract's spec (analysis/registry.py): flops is None
                    (the entry points do no matmul-class work, and torch's
                    flop counter would report a false 0 for them);
                    hbm_bytes is the byte bound's numerator, the bytes of
                    every distinct tensor input read once and every output
                    written once; peak_memory_bytes is the rise of
                    torch.cuda.max_memory_allocated over the call on CUDA,
                    None on the CPU.
  count_retraces    counts the one-time work inside a block: nvcc builds
                    and kernel library loads (native/build.py's counters),
                    what a second same-shape call must not repeat. Eager
                    torch has no trace cache, so this is the retrace of
                    the port. The caching allocator's new segments are NOT
                    added: a second call may legitimately map a segment
                    when the first call's freed blocks split differently,
                    so roofline reports them beside, as new_segments.
  measure_retraces  the count of a SECOND same-shape call of a contract's
                    spec; EntrypointContract.retrace_budget (default 0)
                    turns any excess into a failure (check_retrace_budgets)
  op_log            {op: count} of one call: every dispatched aten op and
                    the port's kernel launches (a TorchDispatchMode)
  host_syncs        the aten._local_scalar_dense calls (a device value
                    read on the host: .item(), a Python branch on a
                    tensor) in one call's op log: the torch meaning of the
                    reference's GA-A001-A004 census, reported, never gated
                    (the serial engine syncs by design)
  roofline          the strict-JSON per-entry-point block: {flops,
                    hbm_bytes, peak_memory_bytes, retraces,
                    retrace_budget, new_segments, host_syncs}
  chrome_trace      flight-recorder curves (ops/telemetry.py) rendered as
                    Chrome-trace/perfetto JSON — one "X" slice per
                    heartbeat with the channel values in args, plus "C"
                    counter tracks for the scalar channels (host numpy,
                    the reference's bytes)
  profiler_trace    a torch.profiler capture (CPU, plus CUDA on a CUDA
                    device) around a block: writes the profiler's Chrome
                    trace and the launch log (launches per device kernel)
                    into the directory. A capture that fails, or that saw
                    no device activity on a CUDA device, raises.

The reference's lower_spec has no counterpart: there is no program to
lower, every spec runs eagerly.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager

import numpy as np
import torch

PROFILE_TRACE = "torch_profile.json"
KERNEL_COUNTS = "kernels.json"


@contextmanager
def profiler_trace(log_dir: str | None, device=None):
    """torch.profiler capture around the block when `log_dir` is set; a
    plain passthrough otherwise. On a CUDA `device` the capture includes
    the device activity, and finds at least one kernel or raises. Writes
    `torch_profile.json` (the profiler's Chrome trace) and `kernels.json`
    ({kernel name: launches}, device kernels only) into `log_dir`."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cpu" if device is None else device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, PROFILE_TRACE))
    counts: dict[str, int] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            counts[ev.name] = counts.get(ev.name, 0) + 1
    if dev.type == "cuda" and not counts:
        raise RuntimeError(
            f"torch.profiler captured no device activity on {dev}: the "
            "CUDA capture failed")
    with open(os.path.join(log_dir, KERNEL_COUNTS), "w") as fh:
        json.dump(dict(sorted(counts.items())), fh, indent=2,
                  allow_nan=False)


# ------------------------------------------------- cost and retraces


class RetraceCounter:
    """Live count of the one-time work since the counter was made."""

    def __init__(self):
        from ..native import build

        self._build = build
        self._base = (build.nvcc_builds, build.library_loads)

    @property
    def builds(self) -> int:
        return self._build.nvcc_builds - self._base[0]

    @property
    def loads(self) -> int:
        return self._build.library_loads - self._base[1]

    @property
    def count(self) -> int:
        return self.builds + self.loads


@contextmanager
def count_retraces():
    """Count nvcc builds and kernel library loads inside the block."""
    yield RetraceCounter()


def _segments(dev) -> int | None:
    if dev.type != "cuda":
        return None
    return int(torch.cuda.memory_stats(dev).get("segment.all.allocated", 0))


def entrypoint_cost(contract) -> dict:
    """{flops, hbm_bytes, peak_memory_bytes} of one call of the contract's
    spec (see module doc)."""
    from ..analysis.contracts import tensor_bytes
    from ..analysis.jaxpr_audit import run_spec, spec_device

    spec = contract.build()
    dev = spec_device(spec)
    base = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = run_spec(spec)
    peak = (None if base is None
            else int(torch.cuda.max_memory_allocated(dev) - base))
    return {"flops": None,
            "hbm_bytes": float(tensor_bytes((spec.args, spec.kwargs), out)),
            "peak_memory_bytes": peak}


def measure_retraces(contract, with_segments: bool = False):
    """One-time work of a SECOND same-shape call of the contract's spec:
    the first call (a fresh build) builds and loads what the path needs,
    the second (built again: same shapes, same seeds) must do none of it.
    With `with_segments` returns (count, new allocator segments or None)."""
    from ..analysis.jaxpr_audit import run_spec, spec_device

    run_spec(contract.build())
    spec = contract.build()
    dev = spec_device(spec)
    seg0 = _segments(dev)
    with count_retraces() as counter:
        run_spec(spec)
    if not with_segments:
        return counter.count
    seg1 = _segments(dev)
    return counter.count, (None if seg0 is None else seg1 - seg0)


def op_log(thunk, device) -> dict:
    """{op: count} of one call of `thunk`: every aten op it dispatched
    (a TorchDispatchMode sees each one, on any device) and the launches of
    the port's own kernels, which are not aten ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..native import score_update as su
    from ..native import vmem_gather as vg

    class _Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts: dict = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.counts[str(func)] = self.counts.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))

    before = (vg.launches, su.launches)
    with _Log() as log:
        thunk()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    log.counts["kernel vmem_gather"] = vg.launches - before[0]
    log.counts["kernel score_update"] = su.launches - before[1]
    return log.counts


def host_syncs(contract) -> int:
    """The device values one call of the contract's spec reads on the
    host: its aten._local_scalar_dense ops (.item(), a Python branch on a
    tensor), from the op log; torch.profiler's aten::_local_scalar_dense
    rows count the same calls, at the cost of a capture."""
    from ..analysis.jaxpr_audit import run_spec, spec_device

    spec = contract.build()
    log = op_log(lambda: run_spec(spec), spec_device(spec))
    return log.get("aten._local_scalar_dense.default", 0)


def roofline(contracts=None, with_retraces: bool = True,
             name_prefix: str = "", device=None) -> dict:
    """The per-entry-point block: contract name -> {flops, hbm_bytes,
    peak_memory_bytes, retraces, retrace_budget, new_segments,
    host_syncs} (strict-JSON safe; a contract that fails to run reports an
    `error` string instead of crashing the caller).

    `name_prefix` restricts the sweep to contracts whose name starts with
    it. `contracts` default: the registry built for `device`."""
    if contracts is None:
        from ..analysis.registry import default_contracts

        contracts = default_contracts(device)
    if name_prefix:
        contracts = [c for c in contracts if c.name.startswith(name_prefix)]
    block: dict = {}
    for c in contracts:
        entry: dict = {}
        try:
            entry.update(entrypoint_cost(c))
            if with_retraces:
                entry["retraces"], entry["new_segments"] = measure_retraces(
                    c, with_segments=True)
                entry["retrace_budget"] = int(c.retrace_budget)
            entry["host_syncs"] = host_syncs(c)
        except Exception as e:  # noqa: BLE001 — per-entry degradation
            entry["error"] = repr(e)[:200]
        block[c.name] = entry
    return block


def check_retrace_budgets(contracts=None, device=None) -> list[dict]:
    """[{name, retraces, budget}] for every contract whose second call
    does one-time work above its declared budget (empty = all clean)."""
    if contracts is None:
        from ..analysis.registry import default_contracts

        contracts = default_contracts(device)
    bad = []
    for c in contracts:
        got = measure_retraces(c)
        if got > c.retrace_budget:
            bad.append({"name": c.name, "retraces": got,
                        "budget": int(c.retrace_budget)})
    return bad


# ------------------------------------------------------- trace export


def chrome_trace(curves: dict, heartbeat_ms: float, t0_ms: float = 0.0,
                 pid: int = 0, name: str = "trial") -> dict:
    """Render flight-recorder curves as Chrome-trace JSON (perfetto loads
    it directly). One "X" (complete) slice per heartbeat carries every
    channel value in args; scalar channels additionally get "C" counter
    tracks so perfetto draws them as time series. `ts`/`dur` are
    microseconds per the trace-event spec; sim time is milliseconds."""
    curves = {k: np.asarray(v) for k, v in curves.items()}
    steps = min((c.shape[0] for c in curves.values()), default=0)
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": name}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "heartbeats"}},
    ]
    for i in range(steps):
        ts = (t0_ms + i * heartbeat_ms) * 1000.0
        args = {}
        for k, c in curves.items():
            v = c[i]
            args[k] = (float(v) if np.ndim(v) == 0
                       else [float(x) for x in np.ravel(v)])
        events.append({
            "name": "heartbeat", "ph": "X", "ts": ts,
            "dur": heartbeat_ms * 1000.0, "pid": pid, "tid": 0,
            "args": {"hb": i, **args},
        })
        for k, c in curves.items():
            if np.ndim(c[i]) == 0:
                events.append({
                    "name": k, "ph": "C", "ts": ts, "pid": pid,
                    "args": {"value": float(c[i])},
                })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
