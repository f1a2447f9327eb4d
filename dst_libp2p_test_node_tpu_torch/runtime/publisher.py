"""Publisher controller: the HTTP injector for the `serve` mode.

The port of the injector half of the reference's runtime/publisher.py
(:147-218). The reference drives publishing from outside the nodes:
Shadow bakes vacp2p/pod-api-requester into the runner image
(shadow/Dockerfile:45-53) and the generated shadow.yaml starts
`traffic_sync.py -s <size> -m <messages> -d <delay> -n <n>
--peer-selection id` on the injector node at t=500 s
(shadow/topogen.py:124-136); under K8s the 10ksim publisher does the same
(README.md:21). Either way the controller POSTs
`{"topic","msgSize","version"}` to the chosen node's :8645 /publish at a
fixed inter-message delay.

Peer selection mirrors the reference surface: `id` pins one publisher
(run.sh publisher_id, run.sh:34), `rotation` advances to the next target
after every message (run.sh:35, publisher_rotation), and `burst` posts
back-to-back request groups so the resident service's batched dispatcher
sees multi-request pump rounds. Pure stdlib; nothing here touches a
tensor, apart from the batched dispatch below.

The batched dispatch is the reference's (its runtime/publisher.py:115, a
lax.scan over padded seed columns) as the port runs it: `publish_columns`
runs one disseminate per active column from one t0, the state carried
from column to column; Simulator.publish_batch builds its records from
those columns. `publish_batch_scan` stacks the same columns into the
reference's ys, the padding columns zero: the registry's
publisher/batch_scan contract.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from dataclasses import dataclass

from ..config.env import HTTP_CONTROL_PORT


@dataclass
class InjectResult:
    ok: int = 0
    failed: int = 0
    replies: list = None

    def __post_init__(self):
        if self.replies is None:
            self.replies = []


def publish_once(
    target: str, msg_size: int, topic: str = "test", version: int = 1,
    timeout_s: float = 10.0,
) -> dict:
    """POST one /publish to `target` (host[:port] or full URL)."""
    if not target.startswith("http"):
        if ":" not in target:
            target = f"{target}:{HTTP_CONTROL_PORT}"
        target = f"http://{target}"
    req = urllib.request.Request(
        f"{target}/publish",
        data=json.dumps(
            {"topic": topic, "msgSize": msg_size, "version": version},
            allow_nan=False,
        ).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


def inject(
    targets: list[str],
    msg_size: int,
    messages: int,
    delay_s: float,
    topic: str = "test",
    peer_selection: str = "id",
    publisher_id: int = 0,
    timeout_s: float = 10.0,
    burst: int = 1,
    sleep=time.sleep,
) -> InjectResult:
    """Drive `messages` publishes at `delay_s` spacing against `targets`.

    peer_selection: 'id' always hits targets[publisher_id % len];
    'rotation' advances one target per message (traffic_sync --peer-selection
    / run.sh publisher_rotation). `burst` > 1 posts that many messages
    back-to-back before sleeping, so a resident service's pump round sees a
    multi-request fair batch and the batched dispatcher has columns to
    stack."""
    if peer_selection not in ("id", "rotation"):
        raise ValueError(f"unknown peer_selection {peer_selection!r}")
    if burst < 1:
        raise ValueError(f"burst must be >= 1, got {burst}")
    res = InjectResult()
    idx = publisher_id % len(targets)
    for i in range(messages):
        if i > 0 and i % burst == 0 and delay_s > 0:
            sleep(delay_s)
        try:
            reply = publish_once(
                targets[idx], msg_size, topic=topic, timeout_s=timeout_s)
            res.ok += 1
            res.replies.append(reply)
        except (urllib.error.URLError, OSError, ValueError) as e:
            res.failed += 1
            res.replies.append({"status": "error", "message": str(e)})
        if peer_selection == "rotation":
            idx = (idx + 1) % len(targets)
    return res


# the per-column results the batch stacks (the reference's ys keys)
_BATCH_YS = ("delay_ms", "received", "sends", "copies_rx", "ihave_sent",
             "iwant_sent", "answer_wait_max_ms", "converged")


def publish_columns(state, conns, rev, stage, lat_ms, bw, rows, active,
                    t0_ms, params, payload_bytes, fragments, with_gossip,
                    loss_stage, loss_mode, lat_edge, loss_edge, ans_tables,
                    valid_edge, with_fanout):
    """Publish from each active column's row in order, all at `t0_ms`.

    `rows` is the (B,) publisher-row column and `active` the (B,) padding
    mask, host arrays. Returns (results, new_state): one
    DisseminationResult per column, None in the padding columns, which
    leave the state untouched."""
    from ..ops.disseminate import disseminate

    results = []
    for row, live in zip(rows, active):
        if not bool(live):
            results.append(None)
            continue
        res, state = disseminate(
            state, conns, rev, stage, lat_ms, bw, publisher=int(row),
            t0_ms=t0_ms, params=params, payload_bytes=payload_bytes,
            fragments=fragments, with_gossip=with_gossip, mesh=None,
            loss_stage=loss_stage, loss_mode=loss_mode, lat_edge=lat_edge,
            loss_edge=loss_edge, ans_tables=ans_tables,
            valid_edge=valid_edge, with_fanout=with_fanout)
        results.append(res)
    return results, state


def publish_batch_scan(state, conns, rev, stage, lat_ms, bw, rows, active,
                       t0_ms, params, payload_bytes, fragments, with_gossip,
                       loss_stage, loss_mode, lat_edge, loss_edge, ans_tables,
                       valid_edge, with_fanout):
    """`publish_columns` with the per-column results stacked as the
    reference's ys. Returns (ys, new_state): each ys leaf stacked along
    the batch axis, zero in the padding columns. The reference's
    `topic_blocks` (its multi-topic fold) has no caller here:
    MultiTopicSimulator.publish_batch publishes one message at a time."""
    import torch

    results, state = publish_columns(
        state, conns, rev, stage, lat_ms, bw, rows, active, t0_ms, params,
        payload_bytes, fragments, with_gossip, loss_stage, loss_mode,
        lat_edge, loss_edge, ans_tables, valid_edge, with_fanout)
    n, dev = conns.shape[0], conns.device
    f32, i32 = torch.float32, torch.int32
    dtypes = {"delay_ms": f32, "received": torch.bool, "sends": i32,
              "copies_rx": i32, "ihave_sent": i32, "iwant_sent": i32}
    zeros = {k: torch.zeros((n,), dtype=d, device=dev)
             for k, d in dtypes.items()}
    zeros["answer_wait_max_ms"] = torch.zeros((), dtype=f32, device=dev)
    zeros["converged"] = torch.zeros((), dtype=torch.bool, device=dev)
    cols = [zeros if res is None else {k: getattr(res, k) for k in _BATCH_YS}
            for res in results]
    ys = {k: torch.stack([c[k] for c in cols]) for k in _BATCH_YS}
    return ys, state
