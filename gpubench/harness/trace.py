"""Reading a torch.profiler slice: kernels, spans, host syncs, idle gaps.

The slice holds whole cycles. Kernel time and the spans' GPU extent are
read as chip_smoke.device_time reads them (copied): the spans' device
rows are not kernels, and a span's GPU extent is the device row's time
range. A host sync is an `aten::_local_scalar_dense` (a tensor read as a
Python number), counted inside the harness's `gpubench.publish` spans.
"""

from __future__ import annotations

SPANS = ("gpubench.advance", "gpubench.publish",
         "disseminate.fast_pipeline", "disseminate.refinement")
SYNC = "aten::_local_scalar_dense"


def _union(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def digest(prof, wall_s: float, publishes: int, heartbeats: int) -> dict:
    """The slice's numbers in plain Python (microseconds, profiler clock)."""
    from torch.autograd import DeviceType

    evs = prof.events()
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in dev if e.name not in SPANS]
    span_dev = {s: [(e.time_range.start, e.time_range.end)
                    for e in dev if e.name == s] for s in SPANS}
    span_cpu = {s: [(e.time_range.start, e.time_range.end)
                    for e in cpu if e.name == s] for s in SPANS}
    syncs = [(e.time_range.start, e.time_range.end)
             for e in cpu if e.name == SYNC]
    busy_us = _union([(s, e) for _, s, e in kernels])
    by_name: dict = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return {
        "wall_s": wall_s,
        "publishes": publishes,
        "heartbeats": heartbeats,
        "kernels": kernels,
        "span_dev": span_dev,
        "span_cpu": span_cpu,
        "syncs": syncs,
        "busy_s": busy_us * 1e-6,
        "by_name_s": {k: v * 1e-6 for k, v in by_name.items()},
    }


def _label(t: float, t_end: float, d: dict) -> str:
    """What the host did in the gap [t, t_end): the innermost span open
    at its start, and whether a host sync fell inside it."""
    inner, width = "outside the spans", float("inf")
    for name, ranges in d["span_cpu"].items():
        for s, e in ranges:
            if s <= t < e and e - s < width:
                inner, width = name, e - s
    waiting = any(s < t_end and e > t for s, e in d["syncs"])
    return f"{inner}: {'host sync' if waiting else 'host work'}"


def breakdown(d: dict) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps between kernels, each gap named by what the host did."""
    ops = sorted(d["by_name_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], None
    for _, s, e in sorted(d["kernels"], key=lambda k: k[1]):
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    return {
        "device_ops": [[name, sec] for name, sec in ops],
        "idle_gaps": [[_label(at, at + us, d), us * 1e-6]
                      for us, at in gaps[:10]],
    }
