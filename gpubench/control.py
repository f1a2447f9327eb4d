#!/usr/bin/env python3
"""Readings of a cell's control: the reference put in the program's place
with one guarantee of its configuration broken (the configuration's
"control" object says which), judged by the same comparison as a run.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3

prints one JSON line per seed with its numbers. The benchmark's own runs
do not run it; PERF.md gives its readings, from which each limit's upper
end was set.

  {"serialize_answers": false}   exact delivery made bounded: answers are
                                 not serialized in the arrival times
  {"sweep_cap": k}               every fixpoint cut after k passes
"""

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_outputs(config: dict, traffic: dict, seed: int, device):
    """window.Outputs of the control for one episode."""
    from gpubench.harness import judge, window
    from gpubench.reference import model as ref_model

    ctl = dict(config["control"])
    cap = int(ctl.pop("sweep_cap", 4000))
    m = dataclasses.replace(ref_model.Model.from_config(config), **ctl)
    last = int(traffic["messages_per_episode"]) - 1
    r = judge.reference_run(config, traffic, seed, device, final_cycle=last,
                            model=m, sweep_cap=cap)
    out = window.Outputs(graph=r.graph, s0=r.s0, final=r.final,
                         final_cycle=last)
    out.messages = [(i, x.delays_ms, x.received, x.converged)
                    for i, x in enumerate(r.messages)]
    return out


def readings(cell, seed: int, device) -> dict:
    from gpubench.harness import judge

    out = control_outputs(cell.config, cell.traffic, seed, device)
    ref = judge.reference_run(cell.config, cell.traffic, seed, device,
                              final_cycle=out.final_cycle)
    nums, _ = judge.compare(out, ref,
                            with_mix="mix_mismatch" in cell.config["limits"])
    return nums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gpubench.harness import cells

    cell = cells.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = readings(cell, seed, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "numbers": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
