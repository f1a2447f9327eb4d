"""Trace export: flight-recorder curves as a Chrome trace, and the
torch.profiler capture around a block (the `trace` command's pieces).

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

The reference module's XLA cost and retrace analyses come with the
microbench slice (ROADMAP A14).
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
        json.dump(dict(sorted(counts.items())), fh, indent=2)


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
