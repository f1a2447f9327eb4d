#!/usr/bin/env python
"""Overload/chaos driver for the PyTorch port's resident service (the twin
of scripts/service_load.py, over runtime/traffic.run_service_load).

Drives a NodeService with the ETH2-style traffic mix: sustained load,
deliberate overload (per-tick offered load vs the dispatcher's per-round
batch capacity), an optional forced dispatch failure for the supervisor,
and an optional kill-and-restart chaos leg that asserts warm-restart
bit-identity. Emits one strict-JSON report and exits nonzero if a gate
fails: the queue bound, a finite p99, and the chaos leg's
`bit_identical`.

The simulators run on CUDA unless --device names another device; without
a card and without --device cpu it raises.

Examples:
  # 2x overload on the CPU, small mix
  python scripts/service_load_torch.py --device cpu \\
      --peers 48 --subnets 2 --ticks 12 --per-tick 4 --max-batch 2 \\
      --queue-depth 4 --json load.json

  # chaos on the card: one injected dispatch failure + kill at tick 6,
  # restart from the periodic checkpoint, require bit-identical replay
  python scripts/service_load_torch.py \\
      --peers 48 --subnets 2 --ticks 12 --per-tick 4 --max-batch 2 \\
      --queue-depth 4 --inject-failures 1 --retry-backoff-s 0 \\
      --kill-at-tick 6 --checkpoint svc.npz --checkpoint-every 2 \\
      --no-http --json chaos.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--peers", type=int, default=64)
    ap.add_argument("--subnets", type=int, default=2,
                    help="attestation subnet count (64 = mainnet shape)")
    ap.add_argument("--connect-to", type=int, default=6)
    ap.add_argument("--warmup-s", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=12)
    ap.add_argument("--per-tick", type=int, default=4,
                    help="offered requests per service round")
    ap.add_argument("--tick-ms", type=float, default=150.0,
                    help="sim ms advanced per service round")
    ap.add_argument("--msg-scale", type=float, default=1.0)
    ap.add_argument("--queue-depth", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=2,
                    help="dispatch capacity per service round")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request sim-time deadline (0 = none)")
    ap.add_argument("--dispatch-timeout-s", type=float, default=0.0)
    ap.add_argument("--max-retries", type=int, default=1)
    ap.add_argument("--retry-backoff-s", type=float, default=0.05)
    ap.add_argument("--inject-failures", type=int, default=0)
    ap.add_argument("--dispatch-mode", default="batched",
                    choices=("batched", "sequential"),
                    help="batched = one stacked device dispatch per "
                    "same-shape group; sequential = the pinned per-request "
                    "reference (bit-identical record streams either way)")
    ap.add_argument("--kill-at-tick", type=int, default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--no-http", action="store_true",
                    help="drive submit()/pump() in-process, no sockets")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the report here as well as stdout")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for the CPU)")
    a = ap.parse_args(argv)

    from dst_libp2p_test_node_tpu_torch.runtime.traffic import (
        run_service_load)

    out = run_service_load(
        n_peers=a.peers, subnets=a.subnets, connect_to=a.connect_to,
        warmup_s=a.warmup_s, seed=a.seed, ticks=a.ticks,
        per_tick=a.per_tick, tick_ms=a.tick_ms, msg_scale=a.msg_scale,
        max_queue_depth=a.queue_depth, max_batch=a.max_batch,
        deadline_ms=a.deadline_ms, dispatch_timeout_s=a.dispatch_timeout_s,
        max_retries=a.max_retries, retry_backoff_s=a.retry_backoff_s,
        inject_failures=a.inject_failures, dispatch_mode=a.dispatch_mode,
        kill_at_tick=a.kill_at_tick,
        checkpoint_path=a.checkpoint, checkpoint_every=a.checkpoint_every,
        via_http=not a.no_http, device=a.device,
    )
    text = json.dumps(out, indent=2, allow_nan=False)
    print(text)
    if a.json_out:
        with open(a.json_out, "w") as f:
            f.write(text + "\n")
    # chaos/health gates: a failed invariant is a nonzero exit, not just a
    # field in the report
    ok = out["queue_bound_held"]
    if out["p99_ms"] is not None:
        ok = ok and math.isfinite(out["p99_ms"])
    if out["kill"] is not None:
        ok = ok and out["kill"]["bit_identical"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
