"""The muxer-axis sensitivity table through the PyTorch port (the twin of
scripts/muxer_sensitivity.py).

Per-hop processing enters delay as hops x crossings x EVENT_LOOP_MS
(runtime/simulator.py: MUXER_PROC_MS = EVENT_LOOP_MS x each stack's
crossing count, quic 3, yamux 4, mplex 4.4). The reference script's four
runs bound what that count can matter: the Shadow-parity config-1 shape
(100 peers, 15 KB, 5 messages 2 s apart) under quic, yamux and mplex,
then yamux with a deliberately out-of-range 8 crossings, set by replacing
the Simulator's params (`proc_delay_ms`, read at publish time). It
asserts the same claims: the three muxers' p50 span and the 8-crossing
p50 shift both under 5%.

--write writes {"muxer_sensitivity": <the table>, "device": ...} to its
own file; it never merges into docs/event_loop_calibration.json, which
holds the host measurement (scripts/calibrate_event_loop.py). "device"
is "cpu", or the card's name and power limit. The kernels' launches over
the four runs go to stderr as one JSON line.

Run:  python scripts/muxer_sensitivity_torch.py [--device cpu]
                                                [--write docs/muxer_sensitivity_torch.json]
(on CUDA unless --device names another; raises without a card)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams  # noqa: E402
from dst_libp2p_test_node_tpu_torch.device import (  # noqa: E402
    device_label, resolve_device)
from dst_libp2p_test_node_tpu_torch.native import launch_counts  # noqa: E402
from dst_libp2p_test_node_tpu_torch.runtime.simulator import (  # noqa: E402
    EVENT_LOOP_MS, MUXER_PROC_MS, ExperimentConfig, Simulator)
from dst_libp2p_test_node_tpu_torch.runtime.summarize import sanitize_nonfinite  # noqa: E402

N = 100
MSG_SIZE = 15000
MESSAGES = 5

CALIBRATION = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "event_loop_calibration.json")


def _run(muxer: str, proc_ms_override=None, device=None) -> dict:
    topo = TopoParams(
        network_size=N, anchor_stages=5, min_bandwidth=50, max_bandwidth=150,
        min_latency=40, max_latency=130, msg_size_bytes=MSG_SIZE,
        messages=MESSAGES, delay_seconds=2.0, muxer=muxer,
    )
    cfg = ExperimentConfig(topo=topo, connect_to=10, warmup_s=60.0, seed=0)
    sim = Simulator(cfg, device=device)
    if proc_ms_override is not None:
        sim.params = dataclasses.replace(
            sim.params, proc_delay_ms=proc_ms_override)
    sim.warmup()
    for i in range(MESSAGES):
        if i:
            sim.advance(2000.0)
        sim.publish(4)
    delays = np.concatenate([r.delays_ms for r in sim.records])
    ok = np.isfinite(delays)
    return {
        "muxer": muxer,
        "proc_ms": round(float(proc_ms_override
                               if proc_ms_override is not None
                               else MUXER_PROC_MS[muxer]), 3),
        "coverage": round(float(ok.mean()), 4),
        "p50_ms": round(float(np.percentile(delays[ok], 50)), 1),
        "p99_ms": round(float(np.percentile(delays[ok], 99)), 1),
    }


def table(device=None) -> dict:
    """The four runs, their spans and the config, as the reference's
    artifact holds them under "muxer_sensitivity"."""
    rows = [
        _run("quic", device=device),            # 3 crossings
        _run("yamux", device=device),           # 4 crossings
        _run("mplex", device=device),           # 4.4 crossings
        # out-of-range bound: double yamux's crossing count
        _run("yamux", proc_ms_override=8.0 * EVENT_LOOP_MS, device=device),
    ]
    rows[-1]["muxer"] = "bound_8_crossings"
    in_range = rows[:3]
    p50s = [r["p50_ms"] for r in in_range]
    p99s = [r["p99_ms"] for r in in_range]
    span = {
        "p50_span_pct": round((max(p50s) - min(p50s)) / min(p50s) * 100, 2),
        "p99_span_pct": round((max(p99s) - min(p99s)) / min(p99s) * 100, 2),
        "p50_bound_shift_pct": round(
            (rows[-1]["p50_ms"] - rows[1]["p50_ms"])
            / rows[1]["p50_ms"] * 100, 2),
    }
    return {"runs": rows, "span": span,
            "config": {"peers": N, "msg_size_bytes": MSG_SIZE,
                       "messages": MESSAGES, "connect_to": 10, "seed": 0,
                       "event_loop_ms": EVENT_LOOP_MS}}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--write", metavar="PATH", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu for the CPU)")
    a = p.parse_args()
    if a.write and os.path.realpath(a.write) == os.path.realpath(CALIBRATION):
        p.error(f"--write never merges into {CALIBRATION}")
    dev = resolve_device(a.device)

    tab = table(dev)
    # the claim the table certifies: the whole muxer axis (and a doubled
    # crossing count) moves the statistics by low single digits
    assert tab["span"]["p50_span_pct"] < 5.0, tab["span"]
    assert abs(tab["span"]["p50_bound_shift_pct"]) < 5.0, tab["span"]

    out = sanitize_nonfinite({"muxer_sensitivity": tab,
                              "device": device_label(dev)})
    print(json.dumps(out, indent=2, allow_nan=False))
    print(json.dumps({"launches": launch_counts()}, allow_nan=False),
          file=sys.stderr)
    if a.write:
        with open(a.write, "w") as f:
            json.dump(out, f, indent=2, allow_nan=False)
            f.write("\n")


if __name__ == "__main__":
    main()
