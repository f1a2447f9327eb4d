"""The external validity anchor, an Ethereum-mainnet-like GossipSub run,
through the PyTorch port (the twin of scripts/eth_anchor.py).

The same shape as the reference script: 10,000 peers, 128 KB blocks, the
consensus spec's gossipsub parameters (D=8, D_low=6, D_high=12, D_lazy=6,
heartbeat 700 ms, mcache_gossip=3), a staged global WAN (20-150 ms
one-way, 50-150 Mbit), one publish per 12 s slot, five slots.
scripts/eth_anchor.py names the published reference points (median block
arrival ~1-2 s, the 4 s attestation deadline); this script checks the
same claims:

  - coverage >= 0.999, 400 <= p50 <= 2,000 ms, >= 99% of deliveries
    inside the 4 s deadline;
  - without --write, p50 within 20% of the committed anchor
    (docs/VALIDITY_ANCHOR_torch.json where it exists, else the
    reference's docs/VALIDITY_ANCHOR.json).

The artifact keeps the reference artifact's keys and layout and adds
"device": "cpu", or the card's name and power limit. The kernels'
launches in the run go to stderr as one JSON line.

Run:  python scripts/eth_anchor_torch.py [--device cpu]
                                         [--write docs/VALIDITY_ANCHOR_torch.json]
(on CUDA unless --device names another; raises without a card)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dst_libp2p_test_node_tpu_torch.config.env import GossipSubParams  # noqa: E402
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams  # noqa: E402
from dst_libp2p_test_node_tpu_torch.device import (  # noqa: E402
    device_label, resolve_device)
from dst_libp2p_test_node_tpu_torch.native import launch_counts  # noqa: E402
from dst_libp2p_test_node_tpu_torch.runtime.simulator import (  # noqa: E402
    ExperimentConfig, Simulator)
from dst_libp2p_test_node_tpu_torch.runtime.summarize import sanitize_nonfinite  # noqa: E402

N = 10_000               # mainnet consensus nodes: order 10^4
BLOCK_BYTES = 128_000    # ~100 KB average pre-blob block, rounded up
SLOTS = 5                # one block per 12 s slot
SLOT_MS = 12_000.0
DEADLINE_MS = 4_000.0    # attestation deadline: SECONDS_PER_SLOT / 3

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docs")
ARTIFACT = os.path.join(DOCS, "VALIDITY_ANCHOR_torch.json")
REF_ARTIFACT = os.path.join(DOCS, "VALIDITY_ANCHOR.json")
PIN_TOL = 0.20   # trips on a 1.25x model shift


def run(device=None) -> dict:
    gs = GossipSubParams(
        # ethereum/consensus-specs phase0/p2p-interface.md gossip params
        d=8, d_low=6, d_high=12, d_lazy=6,
        heartbeat_ms=700,
        history_gossip=3,        # mcache_gossip
        flood_publish=True,      # go-libp2p-pubsub default, used by clients
    )
    topo = TopoParams(
        network_size=N, anchor_stages=5,
        min_bandwidth=50, max_bandwidth=150,   # Mbit; home->DC node mix
        min_latency=20, max_latency=150,       # one-way ms, global WAN
        msg_size_bytes=BLOCK_BYTES, messages=SLOTS,
        delay_seconds=SLOT_MS / 1000.0,
    )
    cfg = ExperimentConfig(
        topo=topo, connect_to=12, gossipsub=gs, warmup_s=60.0, seed=0,
    )
    sim = Simulator(cfg, device=device)
    sim.warmup()
    for i in range(SLOTS):
        if i:
            sim.advance(SLOT_MS)
        sim.publish(4 + i)     # a different proposer each slot
    delays = np.concatenate([r.delays_ms for r in sim.records])
    ok = np.isfinite(delays)
    d = delays[ok]
    return {
        "coverage": round(float(ok.mean()), 4),
        "p50_ms": round(float(np.percentile(d, 50)), 1),
        "p90_ms": round(float(np.percentile(d, 90)), 1),
        "p99_ms": round(float(np.percentile(d, 99)), 1),
        "max_ms": round(float(d.max()), 1),
        "within_deadline": round(float((d <= DEADLINE_MS).mean()), 4),
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
    ours = run(dev)

    # the anchor claims (docs/VALIDITY.md): same order as the published
    # mainnet band, and the spec deadline met
    assert ours["coverage"] >= 0.999, ours
    assert 400.0 <= ours["p50_ms"] <= 2000.0, ours
    assert ours["within_deadline"] >= 0.99, ours
    # tripwire against the committed anchor: a model change that moves p50
    # beyond +-PIN_TOL must consciously regenerate the artifact
    pinned = next((f for f in (ARTIFACT, REF_ARTIFACT)
                   if os.path.exists(f)), None)
    if pinned and not a.write:
        with open(pinned) as f:
            pin = json.load(f)["ours"]["p50_ms"]
        assert abs(ours["p50_ms"] - pin) <= PIN_TOL * pin, (
            f"p50 {ours['p50_ms']} drifted beyond +-{PIN_TOL:.0%} of the "
            f"committed anchor {pin}; regenerate with --write if the "
            f"model legitimately changed")

    out = {
        "config": {
            "peers": N, "msg_size_bytes": BLOCK_BYTES, "slots": SLOTS,
            "slot_ms": SLOT_MS, "connect_to": 12,
            "gossipsub": {"d": 8, "d_low": 6, "d_high": 12, "d_lazy": 6,
                          "heartbeat_ms": 700, "mcache_gossip": 3},
            "latency_ms": [20, 150], "bandwidth_mbit": [50, 150],
            "seed": 0,
        },
        "published_anchor": {
            "source_config": "ethereum/consensus-specs "
                             "phase0/p2p-interface.md (gossip params), "
                             "phase0/validator.md (4 s attestation "
                             "deadline, SECONDS_PER_SLOT=12)",
            "source_measurement": "mainnet block-arrival studies (ProbeLab "
                                  "gossipsub reports; Xatu/blockprint-based "
                                  "client dashboards)",
            "median_block_arrival_ms": [1000, 2000],
            "deadline_ms": DEADLINE_MS,
            "network_size_order": 10_000,
            "note": "mainnet arrival includes block production and "
                    "per-hop consensus+execution validation; pure "
                    "network dissemination sits below it",
        },
        "ours": ours,
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
