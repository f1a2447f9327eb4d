"""Finding a cell's pieces by name.

BENCHMARK.json (the checkout's root) lists the cells, each naming a
configuration and a traffic mix, and the metrics. Everything that belongs
to one configuration, traffic mix or per-layer metric is a file of its
own under gpubench/, found by that name:

    gpubench/configs/<config>.json    sizes, source, guarantees, limits
    gpubench/traffic/<traffic>.json   heartbeats per message, episode
    gpubench/metrics/<metric>.py      read(ctx) -> float or None

so a later change adds a cell, a configuration, a mix or a metric as new
files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # metric entries this cell reports untraced
    per_layer: list       # ... and traced


def _load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None,
              base: str = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration and traffic
    files read; `base` is the directory holding configs/ and traffic/."""
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    w = entries[name]
    config = _load_json(os.path.join(base, "configs", w["config"] + ".json"))
    traffic = _load_json(os.path.join(base, "traffic",
                                      w["traffic"] + ".json"))
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)],
    )


def metric_reader(name: str, base: str = HERE):
    """The read(ctx) function of gpubench/metrics/<name>.py."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
