"""The second external validity anchor, Ethereum attestation-scale gossip,
run through the PyTorch port (the twin of scripts/attestation_anchor.py).

The same shape as the reference script: 10,000 peers, a 600 B
single-MTU attestation, the consensus spec's gossipsub parameters (D=8,
D_low=6, D_high=12, D_lazy=6, heartbeat 700 ms, mcache_gossip=3), a
staged global WAN (20-150 ms one-way, 50-150 Mbit), one publish per 12 s
slot, five slots. scripts/attestation_anchor.py names the published
reference points; this script checks the same claims:

  - coverage >= 0.999 and >= 99.9% of deliveries inside the 4 s window;
  - p50 <= 1,000 ms;
  - the block anchor's p50 >= 1.5x ours (the block anchor's artifact:
    docs/VALIDITY_ANCHOR_torch.json where it exists, else the
    reference's docs/VALIDITY_ANCHOR.json);
  - without --write, p50 within 20% of the committed anchor
    (docs/VALIDITY_ANCHOR2_torch.json where it exists, else the
    reference's).

The artifact keeps the reference artifact's keys and layout and adds
"device": "cpu", or the card's name and power limit. The kernels'
launches in the run go to stderr as one JSON line.

Run:  python scripts/attestation_anchor_torch.py [--device cpu]
                                                 [--write docs/VALIDITY_ANCHOR2_torch.json]
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

N = 10_000
ATT_BYTES = 600          # unaggregated attestation envelope, single MTU
SLOTS = 5
SLOT_MS = 12_000.0
WINDOW_MS = 4_000.0      # produced at 1/3 slot, aggregated at 2/3 slot

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docs")
ARTIFACT = os.path.join(DOCS, "VALIDITY_ANCHOR2_torch.json")
REF_ARTIFACT = os.path.join(DOCS, "VALIDITY_ANCHOR2.json")
BLOCK_ARTIFACT = os.path.join(DOCS, "VALIDITY_ANCHOR_torch.json")
REF_BLOCK_ARTIFACT = os.path.join(DOCS, "VALIDITY_ANCHOR.json")
PIN_TOL = 0.20


def committed(own: str, ref: str) -> str | None:
    """The port's own committed artifact where it exists, else the
    reference's (None if neither does)."""
    for path in (own, ref):
        if os.path.exists(path):
            return path
    return None


def run(device=None) -> dict:
    gs = GossipSubParams(
        d=8, d_low=6, d_high=12, d_lazy=6,
        heartbeat_ms=700,
        history_gossip=3,
        flood_publish=True,
    )
    topo = TopoParams(
        network_size=N, anchor_stages=5,
        min_bandwidth=50, max_bandwidth=150,
        min_latency=20, max_latency=150,       # same WAN as the block anchor
        msg_size_bytes=ATT_BYTES, messages=SLOTS,
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
        sim.publish(4 + i)     # a different attester each slot
    delays = np.concatenate([r.delays_ms for r in sim.records])
    ok = np.isfinite(delays)
    d = delays[ok]
    return {
        "coverage": round(float(ok.mean()), 4),
        "p50_ms": round(float(np.percentile(d, 50)), 1),
        "p90_ms": round(float(np.percentile(d, 90)), 1),
        "p99_ms": round(float(np.percentile(d, 99)), 1),
        "max_ms": round(float(d.max()), 1),
        "within_window": round(float((d <= WINDOW_MS).mean()), 4),
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

    assert ours["coverage"] >= 0.999, ours
    assert ours["within_window"] >= 0.999, ours
    # single-flight small messages: hop latency + proc only — sub-second
    assert ours["p50_ms"] <= 1000.0, ours
    # the size axis must separate the two anchors in the right direction
    # by a transfer-dynamics-sized margin
    block = committed(BLOCK_ARTIFACT, REF_BLOCK_ARTIFACT)
    if block:
        with open(block) as f:
            block_p50 = json.load(f)["ours"]["p50_ms"]
        assert block_p50 >= 1.5 * ours["p50_ms"], (block_p50, ours)
    # tripwire against the committed artifact: drift must be a conscious
    # regeneration
    pinned = committed(ARTIFACT, REF_ARTIFACT)
    if pinned and not a.write:
        with open(pinned) as f:
            pin = json.load(f)["ours"]["p50_ms"]
        assert abs(ours["p50_ms"] - pin) <= PIN_TOL * pin, (
            f"p50 {ours['p50_ms']} drifted beyond +-{PIN_TOL:.0%} of the "
            f"committed anchor {pin}; regenerate with --write if the "
            f"model legitimately changed")

    out = {
        "config": {
            "peers": N, "msg_size_bytes": ATT_BYTES, "slots": SLOTS,
            "slot_ms": SLOT_MS, "connect_to": 12,
            "gossipsub": {"d": 8, "d_low": 6, "d_high": 12, "d_lazy": 6,
                          "heartbeat_ms": 700, "mcache_gossip": 3},
            "latency_ms": [20, 150], "bandwidth_mbit": [50, 150],
            "seed": 0,
        },
        "published_anchor": {
            "source_config": "ethereum/consensus-specs "
                             "phase0/p2p-interface.md (gossip params; "
                             "attestation SSZ sizes), phase0/validator.md "
                             "(1/3-slot attestation, 2/3-slot aggregation "
                             "timeline)",
            "source_measurement": "mainnet attestation participation / "
                                  "inclusion >= 99% (beaconcha.in network "
                                  "statistics; client-team dashboards) — an "
                                  "outcome only reachable if small-message "
                                  "gossip blankets the network well inside "
                                  "the ~4 s window every slot",
            "window_ms": WINDOW_MS,
            "network_size_order": 10_000,
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
