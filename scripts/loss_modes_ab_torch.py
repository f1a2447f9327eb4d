"""The packet-loss models' before/after artifact through the PyTorch port
(the twin of scripts/loss_modes_ab.py).

Runs the reference script's seeded 1000-peer, 15 KB experiment the same
seven ways: lossless; loss 0.01 and 0.20 under each of the tcp and
message models; loss 0.50 under each with gossip off. It asserts the
same three findings (scripts/loss_modes_ab.py explains them):

  1. at 0.01 both models sit on the lossless numbers (coverage >= 0.999,
     p99 within 25 ms);
  2. at 0.20 tcp keeps coverage >= 0.999 and its p99 grows by > 50 ms;
  3. at 0.50 with gossip off tcp keeps coverage >= 0.999 with a p99 over
     200 ms above the lossless one, and message mode loses coverage.

The artifact keeps the reference artifact's keys and layout and adds
"device": "cpu", or the card's name and power limit. The kernels'
launches over the seven runs go to stderr as one JSON line.

Run:  python scripts/loss_modes_ab_torch.py [--device cpu]
                                            [--write docs/LOSS_MODES_torch.json]
(on CUDA unless --device names another; raises without a card)
"""

from __future__ import annotations

import argparse
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
    ExperimentConfig, Simulator)
from dst_libp2p_test_node_tpu_torch.runtime.summarize import sanitize_nonfinite  # noqa: E402

LOSS = 0.01           # run.sh positional 9 / topogen -l (run.sh:33)
STRESS = 0.20         # rate at which the latency tails separate measurably
SPLIT = 0.50          # gossip-off rate where coverage itself splits
N = 1000
MSG_SIZE = 15000
MESSAGES = 3

REF_ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "LOSS_MODES.json")

# the seven (loss, loss_mode, with_gossip) runs, in the artifact's order
RUNS = (
    (0.0, "tcp", True),          # lossless baseline (mode irrelevant)
    (LOSS, "tcp", True),
    (LOSS, "message", True),
    (STRESS, "tcp", True),
    (STRESS, "message", True),
    (SPLIT, "tcp", False),
    (SPLIT, "message", False),
)


def _run(loss: float, loss_mode: str, with_gossip: bool = True,
         device=None) -> dict:
    topo = TopoParams(
        network_size=N, anchor_stages=5, min_bandwidth=50, max_bandwidth=150,
        min_latency=40, max_latency=130, msg_size_bytes=MSG_SIZE,
        packet_loss=loss, messages=MESSAGES, delay_seconds=2.0,
    )
    cfg = ExperimentConfig(topo=topo, connect_to=10, warmup_s=60.0, seed=0,
                           loss_mode=loss_mode, with_gossip=with_gossip)
    sim = Simulator(cfg, device=device)
    sim.warmup()
    for i in range(MESSAGES):
        if i:
            sim.advance(2000.0)
        sim.publish(4)
    delays = np.concatenate([r.delays_ms for r in sim.records])
    ok = np.isfinite(delays)
    return {
        "loss": loss,
        "loss_mode": loss_mode,
        "gossip": with_gossip,
        "coverage": round(float(ok.mean()), 4),
        "p50_ms": round(float(np.percentile(delays[ok], 50)), 1),
        "p99_ms": round(float(np.percentile(delays[ok], 99)), 1),
        "max_ms": round(float(delays[ok].max()), 1),
    }


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--write", metavar="PATH", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu for the CPU)")
    a = p.parse_args()
    if a.write and os.path.realpath(a.write) == os.path.realpath(REF_ARTIFACT):
        p.error(f"--write never overwrites the reference's {REF_ARTIFACT}")
    dev = resolve_device(a.device)

    rows = [_run(loss, mode, gossip, device=dev)
            for loss, mode, gossip in RUNS]
    (clean, tcp_lo, msg_lo, tcp_hi, msg_hi,
     tcp_split, msg_split) = rows
    # finding 1: redundancy hides -l 0.01 in both models (within a few ms)
    for r in (tcp_lo, msg_lo):
        assert r["coverage"] >= 0.999, r
        assert abs(r["p99_ms"] - clean["p99_ms"]) < 25.0, (r, clean)
    # finding 2: at the stress rate the latency models separate as designed
    assert tcp_hi["coverage"] >= 0.999, tcp_hi
    assert tcp_hi["p99_ms"] > clean["p99_ms"] + 50.0, (tcp_hi, clean)
    # finding 3: with gossip recovery off at the split rate, the modes
    # diverge on coverage
    assert tcp_split["coverage"] >= 0.999, tcp_split
    assert msg_split["coverage"] < 0.999, msg_split
    assert tcp_split["coverage"] > msg_split["coverage"], (
        tcp_split, msg_split)
    assert tcp_split["p99_ms"] > clean["p99_ms"] + 200.0, (tcp_split, clean)

    out = {
        "config": {
            "peers": N, "msg_size_bytes": MSG_SIZE, "messages": MESSAGES,
            "connect_to": 10, "stages": 5, "bandwidth_mbit": [50, 150],
            "latency_ms": [40, 130],
            "loss_rates": [LOSS, STRESS, SPLIT], "seed": 0,
        },
        "runs": rows,
        "device": device_label(dev),
    }
    out = sanitize_nonfinite(out)
    print(json.dumps(out, indent=2, allow_nan=False))
    print(json.dumps({"launches": launch_counts()}, allow_nan=False),
          file=sys.stderr)
    if a.write:
        with open(a.write, "w") as f:
            json.dump(out, f, indent=2, allow_nan=False)
            f.write("\n")


if __name__ == "__main__":
    main()
