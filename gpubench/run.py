#!/usr/bin/env python3
"""The benchmark of dst_libp2p_test_node_tpu_torch on one NVIDIA GPU.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`)
names a configuration (gpubench/configs/) and a traffic mix
(gpubench/traffic/). The run builds the experiment from the seed,
warms up, measures `--seconds` of whole cycles, checks what they
produced against the plain reference (gpubench/reference/), and prints
one JSON line last on standard output; the numbers of the check, each
beside its limit, are the last lines on standard error. `--trace 1`
reports the per-layer metrics (gpubench/metrics/) from host walls and a
profiled slice of whole cycles instead of the end-to-end ones.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names the run may not load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "dst_libp2p_test_node_tpu")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "unread"


def end_to_end(cell, run, peak_bytes) -> dict:
    rate = run.n * run.heartbeats / run.window_s
    values = {
        "setup_s": run.setup_s,
        # the cells whose work the drawn network moves report the rate
        # under a name of their own, with the wider bound (PERF.md)
        "peer_rounds_per_s": rate,
        "peer_rounds_per_s.varied": rate,
        "peak_device_gib": peak_bytes / 2**30,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, run) -> dict:
    from gpubench.harness import cells

    ctx = {"run": run, "slice": run.slice, "n": run.n, "c": run.capacity,
           "cell": cell.name}
    out = {}
    for m in cell.per_layer:
        value = cells.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    # caches of anything the program compiles stay inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "gpubench", ".cache", "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    from gpubench.harness import cells, judge, trace, window

    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    run = window.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          dev, T_START)
    peak = torch.cuda.max_memory_allocated(dev)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips, "memory_peak_bytes": peak,
              "card": power_limit()}
    if args.trace:
        metrics = per_layer(cell, run)
        device.update(busy_s=run.slice["busy_s"],
                      window_s=run.slice["wall_s"])
    else:
        metrics = end_to_end(cell, run, peak)
    out, run.outputs = run.outputs, None
    gc.collect()
    torch.cuda.empty_cache()
    correct, failed, rows = judge.check(cell, out, args.seed, dev)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}", file=sys.stderr)
        return 4
    result = {"correct": correct, "attempted": len(out.messages),
              "failed": failed, "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = trace.breakdown(run.slice)
    result["check"] = {name: {"value": val, "limit": lim}
                       for name, val, lim in rows}
    for name, val, lim in rows:
        print(f"check {name} {val!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
