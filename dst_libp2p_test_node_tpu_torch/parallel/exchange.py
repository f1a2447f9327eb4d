"""Receiver-side fixpoint of the dissemination (single device).

The reference's parallel/exchange.py reformulates the earliest-arrival
fixpoint so that an iteration touches only the (N,) arrival-time vector:

    inc[q, j] = t_rx[p] + A[q, j]                          (mesh edges)
    inc[q, j] = nextHB(t_rx[p] + proc, phase[p]) + G[q, j] (gossip edges)
    t_rx'[q]  = min(t_rx[q], min_j inc[q, j])     with p = conns[q, j]

with A and G per-edge constants gathered once through the reverse-slot
map. ops/disseminate.py takes this path above the pull memory budget (the
1M-peer class), and its hot gather `t_rx[src]` is the vmem_gather kernel
(native/vmem_gather.py) on every sweep. With `packed` (SimParams.
packed_state) the relative cost tables a_ms, g_ms, g_off and phase are
stored as bfloat16 and upcast to float32 at the start of each sweep;
u_ms, rx_c and the flags stay float32 / int8. The sharded variant
(converge_sharded) is a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..native.vmem_gather import vmem_gather
from ..ops.xlamath import fma_f32

INF = 3.4e38


@dataclass
class RecvConstants:
    """Per-receiver-slot constants of one fixpoint (fragment x phase); the
    reference's fields (f32 or, packed, bf16 relative tables; int8 flags
    word)."""

    src: torch.Tensor      # (N, C) int32 sender peer id (conns), -1 pad
    a_ms: torch.Tensor     # (N, C) f32/bf16 mesh-edge additive constant
    g_ms: torch.Tensor     # (N, C) f32/bf16 gossip additive constant
    g_off: torch.Tensor    # (N, C) f32/bf16 gossip-round heartbeat offset
    phase: torch.Tensor    # (N, C) f32/bf16 sender heartbeat phase
    u_ms: torch.Tensor     # (N, C) f32 sender uplink-free time
    flags: torch.Tensor    # (N, C) int8: bit 0 mesh edge, bit 1 gossip edge
    rx_c: torch.Tensor     # (N,) f32 receiver downlink clamp
    proc_ms: torch.Tensor  # () f32
    hb_ms: torch.Tensor    # () f32


def _edge_gather(sender_val, conns, rev):
    """recv[q, j] = sender_val[conns[q,j], rev[q,j]] (one-time gather)."""
    return sender_val[conns.clamp_min(0), rev.clamp_min(0)]


def build_recv_constants(
    conns, rev, lat_edge, tx_ms, rank, k_p, frag_idx, send_mask, can_send,
    g_tgt, g_off_s, hb_phase, uplink_free, rx_const, proc_ms: float,
    hb_ms: float, with_gossip: bool, lat_deliver=None, ld_gossip=None,
    packed: bool = False, mesh_scale=None, contract: str = "lat",
) -> RecvConstants:
    """Gather every sender-side term of the offers through the reverse-slot
    map once (see the reference's build_recv_constants for each term).
    `mesh_scale` (lossless publishes): the mesh delivery latency is
    lat_edge * mesh_scale, and XLA's CPU backend contracts one multiply of
    the reference's `queue + lat_edge * scale` into an FMA, which the port
    reproduces: `contract` "lat" is fma(lat_edge, scale, queue), "queue"
    fma(queue slot, tx_ms, lat_edge * scale) (ops/disseminate says which
    fixpoint rounds which way).
    `packed`: store the relative cost tables as bfloat16 (round to
    nearest even, as XLA's convert; INF rounds up to inf)."""
    valid = (conns >= 0) & (rev >= 0)
    slot = rank + 1.0 + frag_idx * k_p[:, None]
    queue = slot * tx_ms[:, None]
    if lat_deliver is None:
        lat_deliver = lat_edge
    if ld_gossip is None:
        ld_gossip = lat_deliver
    if mesh_scale is None:
        a_sender = queue + lat_deliver
    elif contract == "queue":
        a_sender = fma_f32(slot, tx_ms[:, None], lat_deliver)
    else:
        a_sender = fma_f32(lat_edge, mesh_scale, queue)
    a_ms = torch.where(valid, _edge_gather(a_sender, conns, rev), INF)
    mesh_ok = valid & _edge_gather(send_mask & can_send[:, None], conns, rev)
    if with_gossip:
        g_sender = 2.0 * lat_edge + ld_gossip + tx_ms[:, None]
        g_ms = torch.where(valid, _edge_gather(g_sender, conns, rev), INF)
        g_ok = valid & _edge_gather(g_tgt & can_send[:, None], conns, rev)
        g_off = _edge_gather(g_off_s, conns, rev)
    else:
        g_ms = torch.full_like(a_ms, INF)
        g_ok = torch.zeros_like(mesh_ok)
        g_off = torch.zeros_like(a_ms)
    phase = _edge_gather(hb_phase[:, None].expand(conns.shape), conns, rev)
    u_ms = _edge_gather(uplink_free[:, None].expand(conns.shape), conns, rev)
    dev = conns.device
    table = torch.bfloat16 if packed else torch.float32
    return RecvConstants(
        src=torch.where(valid, conns, -1).to(torch.int32).contiguous(),
        a_ms=a_ms.to(table),
        g_ms=g_ms.to(table),
        g_off=g_off.to(table),
        phase=phase.to(table),
        u_ms=u_ms,
        flags=mesh_ok.to(torch.int8) | (g_ok.to(torch.int8) << 1),
        rx_c=rx_const.to(torch.float32),
        proc_ms=torch.tensor(proc_ms, dtype=torch.float32, device=dev),
        hb_ms=torch.tensor(hb_ms, dtype=torch.float32, device=dev),
    )


def _src_gather(t_all: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """t of every slot's sender: the vmem_gather kernel on CUDA, its plain
    version on the CPU (chosen by the tensors' device)."""
    return vmem_gather(t_all.contiguous(), src)


def _inc_from(t_all: torch.Tensor, c: RecvConstants) -> torch.Tensor:
    """Incoming offers of every receiver slot given the global t_rx. The
    (possibly bf16) relative tables are upcast to f32 first; the clamp to
    INF keeps a packed table's inf from leaking out."""
    t_src = _src_gather(t_all, c.src)
    live = (c.src >= 0) & (t_src < INF)
    mesh_ok = (c.flags & 1) > 0
    g_ok = (c.flags & 2) > 0
    f32 = torch.float32
    a_ms, g_ms = c.a_ms.to(f32), c.g_ms.to(f32)
    g_off, phase = c.g_off.to(f32), c.phase.to(f32)
    base = t_src + c.proc_ms
    start = torch.maximum(base, c.u_ms)
    inc = torch.where(mesh_ok & live, start + a_ms, INF)
    hb = (torch.floor((base - phase) / c.hb_ms) + 1.0) * c.hb_ms + phase
    inc_g = torch.where(g_ok & live,
                        torch.maximum(hb + g_off, c.u_ms) + g_ms, INF)
    return torch.clamp_max(torch.minimum(inc, inc_g), INF)


def converge_recv(t0: torch.Tensor, c: RecvConstants, max_iters: int,
                  g_floor=None):
    """Single-device receiver-side fixpoint. Returns (t_rx, inc, converged):
    the fixpoint, the (N, C) incoming-offer matrix of the last sweep, and
    False only when the iteration cap cut the loop. Each sweep ends in one
    device-to-host sync (the change bit), the counterpart of the
    reference's while_loop predicate."""
    t_rx = t0
    inc = torch.full(c.src.shape, INF, device=t0.device)
    changed, it = True, 0
    while changed and it < max_iters:
        inc = _inc_from(t_rx, c)
        inc_min = inc.amin(dim=-1)
        if g_floor is not None:
            inc_min = torch.minimum(inc_min, g_floor)
        t_new = torch.minimum(t_rx, torch.maximum(inc_min, c.rx_c))
        changed = bool((t_new < t_rx).any())
        t_rx, it = t_new, it + 1
    return t_rx, inc, not changed
