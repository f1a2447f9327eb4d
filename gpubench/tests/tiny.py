"""Cells of the benchmark made small enough for a CPU test, written as
new files under a directory of the test's own (the way a later change
adds a cell)."""

import json
import os

from gpubench.harness import cells

SIZES = {"c4-100k-exact": 1500, "c5-1m-mix": 2000}


def tiny_cell(base, name: str, n: int | None = None, messages: int = 2,
              heartbeats: int | None = None, config_name: str | None = None,
              traffic_name: str | None = None):
    """The cell `name` of BENCHMARK.json at n peers (SIZES by default) and
    `messages` per episode, its files written as new ones under `base`."""
    bench = cells.benchmark()
    w = {x["name"]: x for x in bench["workloads"]}[name]
    src = os.path.join(cells.HERE, "configs", w["config"] + ".json")
    with open(src) as fh:
        config = json.load(fh)
    n = n or SIZES[w["config"]]
    config["experiment"]["topo"]["network_size"] = n
    config["model"]["n"] = n
    with open(os.path.join(cells.HERE, "traffic",
                           w["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    traffic["messages_per_episode"] = messages
    if heartbeats is not None:
        traffic["heartbeats_per_message"] = heartbeats
    cfg_name = config_name or w["config"]
    trf_name = traffic_name or w["traffic"]
    config["name"], traffic["name"] = cfg_name, trf_name
    for sub, obj, nm in (("configs", config, cfg_name),
                         ("traffic", traffic, trf_name)):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
        with open(os.path.join(base, sub, nm + ".json"), "w") as fh:
            json.dump(obj, fh)
    cell_name = f"{cfg_name}.{trf_name}"
    entry = dict(w, name=cell_name, config=cfg_name, traffic=trf_name)
    bench = dict(bench, workloads=[entry])
    for kind in ("end_to_end", "per_layer"):
        bench[kind] = [dict(m, workloads=[cell_name]) if "workloads" in m
                       and name in m["workloads"] else m
                       for m in bench[kind]]
    return cells.load_cell(cell_name, bench=bench, base=str(base))
