"""Mix-routing relay (the MOUNTSMIX / USESMIX surface of BASELINE config 5).

The port of the reference's ops/mix.py. A publisher that uses the mix
network wraps its message in MIXD Sphinx layers and sends it through MIXD
distinct mix nodes drawn from the NUMMIX peers that mount the protocol
(peer ids [0, NUMMIX), the ordinal role rule). The last one, the exit,
publishes into GossipSub on the origin's behalf; receivers measure latency
from the origin's send, so the path delay (per-hop link latency, uplink
serialization of the fixed-size packets, per-hop unwrap) is part of every
delay.

The path is one uniform draw per peer, masked to the eligible mix nodes and
stable-argsorted; the hop prices are gathers into the stage tables. With
the occupancy arrays, every hop queues behind the sender's uplink and the
relay's downlink and writes both back (mix and GossipSub traffic share
each node's links).

On a rank of the peer mesh (parallel/peer.py) every per-peer input is the
rank's rows: the draw is the rank's row block of the whole draw, and
since the mix nodes are the first NUMMIX peers and every other peer sorts
last, the path is the stable argsort of the draw's first NUMMIX rows,
all-gathered (peer.prefix_rows; NUMMIX may span several ranks). The
stage of the publisher and the 2 x MIXD occupancy values the chain reads
are broadcast from their owners (peer.read_row), the chain runs the same
on every rank, and each owner writes its rows back (peer.write_row): the
path, its delay and every written value are the one-device bits.

Float arithmetic follows the reference term by term; every division by a
constant divides by a device tensor (see ops/disseminate.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..parallel import peer

# Sphinx packets are fixed-size whatever the payload; a message larger
# than the body is ceil(payload / body) serialized packets
SPHINX_PACKET_BYTES = 2413
SPHINX_BODY_BYTES = 2048


@dataclass(frozen=True)
class MixParams:
    """Static mix-network parameters."""

    num_mix: int            # NUMMIX: peers [0, num_mix) mount the protocol
    mix_d: int = 4          # MIXD: hops to traverse
    proc_delay_ms: float = 5.0   # per-hop Sphinx unwrap and re-forward
    packet_bytes: int = SPHINX_PACKET_BYTES
    body_bytes: int = SPHINX_BODY_BYTES

    def validate(self) -> None:
        if self.mix_d < 1:
            raise ValueError("MIXD must be >= 1")
        if self.num_mix < self.mix_d:
            raise ValueError(
                f"need NUMMIX >= MIXD distinct mix nodes, got "
                f"{self.num_mix} < {self.mix_d}"
            )


def mix_node_mask(n: int, num_mix: int, device=None) -> torch.Tensor:
    """(N,) bool: which peers mount the mix protocol (ordinal rule)."""
    return torch.arange(n, device=device) < num_mix


def eligible_mix_count(alive, publisher: int, n: int, num_mix: int) -> int:
    """Mix nodes that can relay for this publisher now (mounted, alive,
    not the publisher). Callers check it is >= mix_d before mix_route.
    A torch `alive` is this process's rows (a rank's under a peer mesh):
    the count is summed over every row."""
    if isinstance(alive, torch.Tensor):
        ids = peer.row_ids(alive.shape[0], alive.device)
        m = (ids < num_mix) & alive & (ids != int(publisher))
        return int(peer.isum(m))
    m = (np.arange(n) < num_mix) & np.asarray(alive)
    if publisher < num_mix:
        m = m.copy()
        m[publisher] = False
    return int(m.sum())


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def mix_route(key, publisher: int, alive, stage, lat_ms,
              bw_up_mbit_per_stage, params: MixParams, n: int,
              payload_bytes, uplink_free_ms=None, rx_free_ms=None,
              t0_ms=0.0):
    """Sample a MIXD-hop path and price it.

    Returns (path, exit_node, path_delay_ms): the MIXD relay ids (int32),
    the exit peer and the time from the origin's send until the exit is
    ready to publish (a 0-dim float32 tensor); with the occupancy arrays
    also (uplink_free_new, rx_free_new). Dead mix nodes are left out of the
    draw and the publisher never relays its own packet; the caller checks
    eligible_mix_count first, else the path tail picks up ineligible
    peers."""
    dev = alive.device
    f32 = torch.float32
    publisher = int(publisher)
    rows = alive.shape[0]                  # a rank's rows under a mesh
    ids = peer.row_ids(rows, dev)
    mix_ok = (ids < params.num_mix) & alive & (ids != publisher)
    u = peer.uniform(key, (rows,))
    # ineligible nodes sort last; every eligible one is a prefix row
    m = min(params.num_mix, n)
    order = torch.argsort(peer.prefix_rows(torch.where(mix_ok, u, 2.0), m),
                          stable=True)
    path = order[: params.mix_d]

    hops_from = torch.cat([torch.tensor([publisher], device=dev),
                           path[:-1]])
    hops_to = path
    # the stage of every hop's ends: the path's from the prefix rows, the
    # publisher's from its owner
    stage_mix = peer.prefix_rows(stage, m).long()
    stage_pub = peer.read_row(stage, publisher).long().reshape(1)
    st_from = torch.cat([stage_pub, stage_mix[path[:-1]]])
    st_to = stage_mix[path]
    hop_lat = lat_ms[st_from, st_to]                            # (MIXD,)

    # each hop serializes ceil(payload / body) packets on the sender's
    # uplink, then pays the unwrap at the receiver
    n_packets = torch.ceil(_div(
        torch.tensor(float(payload_bytes), dtype=f32, device=dev),
        float(params.body_bytes)))
    wire_bytes = n_packets * float(params.packet_bytes)

    def _hop_ms(st):
        return (wire_bytes * 8.0) / (bw_up_mbit_per_stage[st] * 1e6) * 1e3

    tx_ms = _hop_ms(st_from)
    path32 = path.to(torch.int32)
    if uplink_free_ms is None:
        # the reference's jnp.sum over the MIXD hops, in order
        hop = hop_lat + tx_ms
        delay = hop[0]
        for h in range(1, params.mix_d):
            delay = delay + hop[h]
        delay = delay + float(params.mix_d * params.proc_delay_ms)
        return path32, path32[-1], delay.to(f32)

    # occupancy-coupled chain: absolute times, hop by hop (the packet is at
    # one relay at a time). The senders are distinct and so are the
    # receivers, so each hop reads a value no earlier hop wrote: the 2 x
    # MIXD reads happen up front, from their owners.
    uplink = uplink_free_ms.to(f32).clone()
    rx_free = (torch.zeros((rows,), dtype=f32, device=dev)
               if rx_free_ms is None else rx_free_ms.to(f32).clone())
    from_ids = [int(i) for i in hops_from.tolist()]
    to_ids = [int(i) for i in hops_to.tolist()]
    up_at = [peer.read_row(uplink, i) for i in from_ids]
    rx_at = [peer.read_row(rx_free, i) for i in to_ids]
    # reference topology: bw_down == bw_up per stage
    rx_hop = _hop_ms(st_to)
    t0 = torch.as_tensor(t0_ms, dtype=f32).to(dev)
    ready = t0
    for h in range(params.mix_d):
        start = torch.maximum(ready, up_at[h])
        peer.write_row(uplink, from_ids[h], start + tx_ms[h])
        wire = start + tx_ms[h] + hop_lat[h]
        done = torch.maximum(wire, rx_at[h] + rx_hop[h])
        peer.write_row(rx_free, to_ids[h], done)
        ready = done + params.proc_delay_ms      # Sphinx unwrap
    return path32, path32[-1], (ready - t0).to(f32), uplink, rx_free


def mix_wire_bytes(params: MixParams, payload_bytes: int) -> int:
    """Bytes each mix hop puts on the wire for one message (padding
    included)."""
    n_packets = -(-payload_bytes // params.body_bytes)
    return n_packets * params.packet_bytes
