"""Message dissemination as an earliest-arrival-time fixpoint (the hot path).

The port of the reference's ops/disseminate.py, bounded delivery mode. One
call propagates one message (all fragments) and returns per-peer arrival
times plus the accounting the reference derives from them:

    t_rx[q] = max( min over senders p of
                     max(t_rx[p] + proc, uplink_free[p])
                     + (rank_p(q)+1) * tx_p + LAT[stage_p, stage_q],
                   rx_free[q] + rx_ms[q] )

with IHAVE/IWANT gossip as extra candidate edges quantized to the
emitter's heartbeat ticks, TCP slow-start flights on data transfers, and
the uplink/downlink occupancy carried in SimState across messages (the
reference module's docstring derives each term).

The fixpoint runs twice per fragment: once to find each peer's first
sender, then with that back-edge removed from the send order. Below the
pull memory budget (ops/pull.exceeds_budget) the loop pulls sender-side
offers; above it (the 1M-peer class) it runs the receiver-side
formulation of parallel/exchange.converge_recv, whose sweep gathers t
through the vmem_gather kernel. Fragments are a Python loop (the
reference vmaps them).

Bounded mode (serialize_answers=False): arrival times keep the
unserialized gossip-answer offers; one answer-queue fold at the final
times supplies the accounting triple and the `answer_wait_max_ms` error
bar. Everything outside this slice raises NotImplementedError naming the
slice that brings it (ROADMAP A).

Float arithmetic follows the reference's association order term by term,
and every division by a constant divides by a device tensor: CUDA turns a
division by a host scalar into a multiply by its reciprocal, which would
move results by an ulp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import prng
from ..parallel.exchange import build_recv_constants, converge_recv
from .pull import (
    exceeds_budget,
    neighbor_pull_bool,
    neighbor_pull_min,
    reciprocal_pull_bool,
    reciprocal_pull_min,
)
from .state import SimParams, SimState

INF = 3.4e38


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice "
        "(ROADMAP A)")


def tcp_flights(nbytes: int, params) -> int:
    """Number of RTT-gated TCP flights a cold-started transfer of `nbytes`
    needs: smallest F >= 1 with IW * (2^F - 1) >= nbytes (IW = initcwnd
    segments x MSS; see the reference for the model)."""
    if not params.slow_start:
        return 1
    iw = params.mss_bytes * params.initcwnd_segments
    if nbytes <= iw:
        return 1
    f = max(1, math.ceil(math.log2(nbytes / iw + 1.0)))
    while f > 1 and iw * (2 ** (f - 1) - 1) >= nbytes:
        f -= 1
    while iw * (2 ** f - 1) < nbytes:
        f += 1
    return f


@dataclass
class DisseminationResult:
    t_rx_ms: torch.Tensor        # (N,) f32 absolute full-receipt time, INF never
    delay_ms: torch.Tensor       # (N,) f32 t_rx - t0, INF if never
    received: torch.Tensor       # (N,) bool (all fragments)
    sends: torch.Tensor          # (N,) int32 message copies sent
    copies_rx: torch.Tensor      # (N,) int32 copies received
    ihave_sent: torch.Tensor     # (N,) int32
    iwant_sent: torch.Tensor     # (N,) int32
    lost_tx: torch.Tensor        # (N,) int32 (0 without a loss model)
    answer_wait_max_ms: torch.Tensor  # () f32 bounded-mode error bar
    answer_interleaved: torch.Tensor  # () int32 lanes with interleaved rounds
    converged: torch.Tensor      # () bool every fixpoint met its certificate
    refine_passes: torch.Tensor  # () int32 (0 in bounded mode)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division on every device (see module doc)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _stage_select(stage, n_stages, conns, rev):
    """(N, C, S+1) one-hot of each neighbor slot's stage id."""
    stage_iota = torch.arange(n_stages, dtype=torch.float32,
                              device=conns.device)
    stage_q = neighbor_pull_min(stage.to(torch.float32), conns, rev)
    return stage_q[..., None] == stage_iota


def edge_tables(stage, lat_ms, conns, rev, loss_stage=None):
    """Per-slot link latency lat_edge[p, i] = lat_ms[stage[p],
    stage[conns[p, i]]] (0 on pads): an experiment constant."""
    if loss_stage is not None:
        raise _later("a lossy topology (packet loss models)", "loss-models")
    sel = _stage_select(stage, lat_ms.shape[0], conns, rev)
    lat_edge = torch.where(sel, lat_ms[stage.long()][:, None, :], 0.0
                           ).sum(dim=-1)
    return lat_edge, None


@dataclass
class AnswerTables:
    """Lat-sorted views of the connection slots: the static service order
    of the answer-queue fold (experiment constants, built once)."""

    perm_lat: torch.Tensor     # (N, C) int64 lat-ascending slot permutation
    inv_lat: torch.Tensor      # (N, C) int64 its inverse
    lat_sorted: torch.Tensor   # (N, C) f32 slot latency in that order
    conns_sorted: torch.Tensor  # (N, C) int32 neighbor ids in that order


def answer_tables(lat_edge, conns) -> AnswerTables:
    slot_lat = torch.where(conns >= 0, lat_edge, INF)
    perm_lat = torch.argsort(slot_lat, dim=-1, stable=True)
    inv_lat = torch.argsort(perm_lat, dim=-1, stable=True)
    return AnswerTables(
        perm_lat=perm_lat,
        inv_lat=inv_lat,
        lat_sorted=torch.gather(slot_lat, 1, perm_lat),
        conns_sorted=torch.gather(conns, 1, perm_lat),
    )


def _ranks_f32(priority: torch.Tensor) -> torch.Tensor:
    order = torch.argsort(priority, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True).to(torch.float32)


def _mask_count_smallest(prio: torch.Tensor, count: torch.Tensor):
    """Row mask of the ceil(count[i]) smallest entries via one value sort
    and a per-row threshold (strict <, as the reference)."""
    c_ = prio.shape[-1]
    kk = torch.ceil(count).to(torch.int32)
    s = torch.sort(prio, dim=-1).values
    thresh = torch.gather(s, 1, torch.clamp(kk, 0, c_ - 1)[:, None].long())
    thresh = torch.where(kk[:, None] >= c_, INF, thresh)
    return prio < thresh


def _next_heartbeat(t, phase, hb_ms: float):
    """First heartbeat tick of a peer strictly after time t."""
    return (torch.floor(_div(t - phase, hb_ms)) + 1.0) * hb_ms + phase


def _check_slice(params, *, with_gossip, mesh, loss_stage, with_fanout,
                 return_plan, censor_edge, loss_mode):
    if loss_mode not in ("message", "tcp"):
        raise ValueError(f"unknown loss_mode {loss_mode!r}")
    if with_gossip and params.serialize_answers:
        raise _later("exact delivery mode (serialize_answers=True)",
                     "exact-mode")
    if mesh is not None:
        raise _later("a peer-sharded mesh", "multi-GPU")
    if loss_stage is not None:
        raise _later("a lossy topology (packet loss models)", "loss-models")
    if with_fanout:
        raise _later("fanout publish (unsubscribed publisher)",
                     "fanout/warm-start")
    if params.warm_start:
        raise _later("warm_start", "fanout/warm-start")
    if return_plan:
        raise _later("return_plan (the DES cross-check seam)", "tooling")
    if censor_edge is not None:
        raise _later("censor_edge (adversarial drops)", "campaign-stack")
    if params.slow_weight != 0.0 or params.fmd_weight < 0.0:
        raise _later("binding score thresholds (nonzero slow-peer weight "
                     "or negative fmd weight)", "campaign-stack")


def disseminate(
    state: SimState,
    conns: torch.Tensor,
    rev: torch.Tensor,
    stage: torch.Tensor,
    lat_ms: torch.Tensor,
    bw_up_mbit_per_stage: torch.Tensor,
    publisher: int,
    t0_ms,
    params: SimParams,
    payload_bytes: int,
    fragments: int = 1,
    with_gossip: bool = True,
    mesh=None,
    loss_stage=None,
    with_fanout: bool = False,
    return_plan: bool = False,
    bw_down_mbit_per_stage=None,
    loss_mode: str = "tcp",
    lat_edge=None,
    loss_edge=None,
    ans_tables=None,
    valid_edge=None,
    censor_edge=None,
):
    """Propagate one message through the mesh; returns (DisseminationResult,
    new_state). The signature is the reference's; the arguments outside
    this slice raise NotImplementedError."""
    _check_slice(params, with_gossip=with_gossip, mesh=mesh,
                 loss_stage=loss_stage, with_fanout=with_fanout,
                 return_plan=return_plan, censor_edge=censor_edge,
                 loss_mode=loss_mode)
    n, c = conns.shape
    dev = conns.device
    f32 = torch.float32
    publisher = int(publisher)
    t0_ms = torch.as_tensor(t0_ms, dtype=f32).to(dev)
    keys = prng.split(state.key, 3)
    key, k_rank, k_gossip = keys[0], keys[1], keys[2]

    frag_bytes = max(payload_bytes // fragments, 16)
    stage_l = stage.long()

    def _per_stage_ms(bw):
        num = torch.full((n,), frag_bytes * 8.0, dtype=f32, device=dev)
        return num / (bw[stage_l] * 1e6) * 1e3

    tx_ms = _per_stage_ms(bw_up_mbit_per_stage)                    # (N,)
    bw_down = (bw_up_mbit_per_stage if bw_down_mbit_per_stage is None
               else bw_down_mbit_per_stage)
    rx_ms = _per_stage_ms(bw_down)                                 # (N,)
    rx_const = state.rx_free_ms + rx_ms

    if lat_edge is None:
        lat_edge, _ = edge_tables(stage, lat_ms, conns, rev)

    if valid_edge is not None:
        valid = valid_edge
    else:
        valid = (conns >= 0) & neighbor_pull_bool(
            state.alive & state.subscribed, conns, rev)
    is_pub = torch.arange(n, device=dev) == publisher

    tgt = state.mesh_mask & valid
    if params.flood_publish:
        tgt = torch.where(is_pub[:, None], valid, tgt)

    # randomized send order per peer (one draw per message)
    rprio = torch.where(tgt, prng.uniform(k_rank, (n, c)), INF)

    # gossip targets: a fresh sample per mcache round of
    # max(D_lazy, gossip_factor * |candidates|) non-mesh topic peers
    g_cand = valid & ~tgt
    n_gc = g_cand.sum(dim=-1).to(f32)
    g_count = torch.clamp_min(params.gossip_factor * n_gc,
                              float(params.d_lazy))
    n_rounds = params.history_gossip if with_gossip else 1
    gkeys = prng.split(k_gossip, n_rounds)
    g_tgt_w = torch.stack([
        g_cand & _mask_count_smallest(
            torch.where(g_cand, prng.uniform(gkeys[h], (n, c)), INF),
            g_count)
        for h in range(n_rounds)
    ])                                                  # (W, N, C)
    g_tgt = g_tgt_w.any(dim=0)
    rounds = torch.arange(n_rounds, dtype=f32, device=dev)[:, None, None]
    g_off = torch.where(g_tgt_w, rounds, float(n_rounds)).amin(dim=0) \
        * params.heartbeat_ms
    hb_phase = state.hb_phase
    can_send = state.alive & state.subscribed
    uplink = state.uplink_free_ms

    # TCP slow-start flights of the data transfers (see tcp_flights)
    ss_scale = torch.tensor(
        [1.0 + 2.0 * float(tcp_flights((f + 1) * frag_bytes, params) - 1)
         for f in range(fragments)], dtype=f32, device=dev)
    ans_scale = 1.0 + 2.0 * float(tcp_flights(frag_bytes, params) - 1)

    def _ld_mesh(f: int):
        return lat_edge * ss_scale[f]

    def _ld_ans():
        return lat_edge * ans_scale

    if with_gossip:
        if ans_tables is None:
            ans_tables = answer_tables(lat_edge, conns)
        perm_lat = ans_tables.perm_lat
        inv_lat = ans_tables.inv_lat
        lat_sorted = ans_tables.lat_sorted
        conns_sorted = ans_tables.conns_sorted
        gw_sorted = [torch.gather(g_tgt_w[h], 1, perm_lat)
                     for h in range(n_rounds)]

    def gossip_fold(t_rx):
        """Serialized gossip-answer offers via the per-round fold in the
        static lat order: (g_abs, req_any, drain, mixed, wait_max)."""
        base = t_rx + params.proc_delay_ms
        tick = _next_heartbeat(base, hb_phase, params.heartbeat_ms)
        live = can_send & (t_rx < INF)
        lda_s = lat_sorted * ans_scale
        q_t_s = t_rx[conns_sorted.clamp_min(0).long()]
        txp = tx_ms[:, None]
        busy = uplink
        g_sorted = torch.full((n, c), INF, device=dev)
        req_any_s = torch.zeros((n, c), dtype=torch.bool, device=dev)
        had_req = torch.zeros((n,), dtype=torch.bool, device=dev)
        mixed = torch.zeros((), dtype=torch.bool, device=dev)
        wait_max = torch.zeros((), dtype=f32, device=dev)
        prev_max_w = torch.full((n,), -INF, device=dev)
        neg_col = torch.full((n, 1), -INF, device=dev)
        zero_col = torch.zeros((n, 1), dtype=f32, device=dev)
        for h in range(n_rounds):
            a_h = torch.maximum(tick + h * params.heartbeat_ms,
                                uplink)[:, None]
            samp = gw_sorted[h] & live[:, None]
            req = samp & (q_t_s > a_h + lat_sorted)
            w = a_h + 2.0 * lat_sorted
            min_w = torch.where(req, w, INF).amin(dim=-1)
            mixed = mixed | (min_w < prev_max_w - 1e-4).any()
            prev_max_w = torch.maximum(
                prev_max_w, torch.where(req, w, -INF).amax(dim=-1))
            rf = req.to(f32)
            R = torch.cumsum(rf, dim=-1)
            m_term = torch.where(req, w - (R - 1.0) * txp, -INF)
            M = torch.cummax(m_term, dim=-1).values
            M_prev = torch.cat([neg_col, M[:, :-1]], dim=-1)
            R_prev = torch.cat([zero_col, R[:, :-1]], dim=-1)
            serve = torch.maximum(
                w, torch.maximum(busy[:, None], M_prev) + R_prev * txp)
            offer = serve + txp + lda_s
            g_sorted = torch.minimum(g_sorted, torch.where(samp, offer, INF))
            wait_max = torch.maximum(
                wait_max, torch.where(req, serve - w, 0.0).amax())
            req_any_s = req_any_s | req
            r_last = R[:, -1]
            busy = torch.where(
                r_last > 0.0,
                torch.maximum(busy, M[:, -1]) + r_last * tx_ms, busy)
            had_req = had_req | (r_last > 0.0)
        g_abs = torch.gather(g_sorted, 1, inv_lat)
        g_abs = torch.where(g_abs < INF, g_abs, INF)
        req_any = torch.gather(req_any_s, 1, inv_lat)
        drain = torch.where(had_req, busy, 0.0)
        return g_abs, req_any, drain, mixed, wait_max

    def _queue(rank, k_p, frag_idx):
        return (rank + 1.0 + frag_idx * k_p[:, None]) * tx_ms[:, None]

    def offers(t_rx, rank, k_p, f, frag_idx, send_mask, g_abs=None):
        """Arrival-time offers made by every peer on every neighbor slot
        (transmit side: nothing is lost without a loss model)."""
        start = torch.maximum(t_rx + params.proc_delay_ms, uplink)
        cand = start[:, None] + _queue(rank, k_p, frag_idx) + _ld_mesh(f)
        live = can_send[:, None] & (t_rx[:, None] < INF)
        cand = torch.where(send_mask & live, cand, INF)
        if with_gossip:
            cand = torch.minimum(cand, g_abs)
        return cand

    def pull(cand):
        return reciprocal_pull_min(cand, conns, rev, batch_factor=fragments)

    def _converge_dyn(rank, k_p, f, frag_idx, t_pub, send_mask, t_init=None):
        """Unserialized fixpoint; returns (t, inc, converged) with `inc` the
        deliver-only offer matrix of the last (no-change) sweep."""
        t0 = (torch.full((n,), INF, device=dev) if t_init is None
              else t_init.clone())
        t0[publisher] = t_pub
        ld = _ld_mesh(f)
        if exceeds_budget(f32, conns.shape, fragments):
            # large N: receiver-side constants gathered once, then each
            # sweep is elementwise plus the vmem_gather of the (N,) times
            cst = build_recv_constants(
                conns, rev, lat_edge, tx_ms, rank, k_p, frag_idx, send_mask,
                can_send, g_tgt, g_off, hb_phase, uplink, rx_const,
                params.proc_delay_ms, params.heartbeat_ms, with_gossip,
                lat_deliver=ld, ld_gossip=_ld_ans(),
                packed=params.packed_state,
            )
            return converge_recv(t0, cst, params.max_relax_iters)
        # below the budget: sender-major offers, row-gather pull per sweep
        a_base = torch.where(send_mask & can_send[:, None],
                             _queue(rank, k_p, frag_idx) + ld, INF)
        g_base = torch.where(
            g_tgt & can_send[:, None],
            2.0 * lat_edge + _ld_ans() + tx_ms[:, None], INF)
        t_rx = t0
        inc = torch.full(conns.shape, INF, device=dev)
        changed, it = True, 0
        while changed and it < params.max_relax_iters:
            live = (t_rx < INF)[:, None]
            base = t_rx + params.proc_delay_ms
            start = torch.maximum(base, uplink)
            cand = torch.where(live, start[:, None] + a_base, INF)
            if with_gossip:
                hb = _next_heartbeat(base, hb_phase, params.heartbeat_ms)
                cand = torch.minimum(
                    cand,
                    torch.where(live,
                                torch.maximum(hb[:, None] + g_off,
                                              uplink[:, None]) + g_base,
                                INF))
            inc = pull(cand)
            t_new = torch.minimum(
                t_rx, torch.maximum(inc.amin(dim=-1), rx_const))
            changed = bool((t_new < t_rx).any())
            t_rx, it = t_new, it + 1
        return t_rx, inc, not changed

    def queue_drop(tgt_mask, frag_idx: int):
        """Publisher priority-queue drop (main.nim:264-299): fragments
        beyond send_queue_cap never leave the publisher."""
        if params.send_queue_cap >= fragments:
            return tgt_mask
        if frag_idx + 1.0 > params.send_queue_cap:
            return tgt_mask & ~is_pub[:, None]
        return tgt_mask

    def _phase2_masks_from_inc(inc1, t1, rank1, k1, tgt_f):
        """Back-edge removal: drop each peer's slot toward its first sender
        from the send order and shift the later ranks down by one."""
        first_slot = torch.argmin(inc1, dim=-1)
        got_remote = ((inc1.amin(dim=-1) <= t1 + 0.01 + 1e-5 * t1)
                      & (t1 < INF) & ~is_pub)
        back = ((torch.arange(c, device=dev) == first_slot[:, None])
                & got_remote[:, None])
        send_mask = tgt_f & ~back
        fs = first_slot[:, None]
        rm = got_remote & torch.gather(tgt_f, 1, fs)[:, 0]
        r0 = torch.where(rm, torch.gather(rank1, 1, fs)[:, 0], INF)
        rank2 = rank1 - (rank1 > r0[:, None]).to(f32)
        k2 = k1 - rm.to(f32)
        return rank2, k2, send_mask

    def phases_fast(f: int, frag_idx, t_pub):
        """The bounded-mode two-phase pipeline of one fragment."""
        tgt_f = queue_drop(tgt, f)
        rank1 = _ranks_f32(torch.where(tgt_f, rprio, INF))
        k1 = tgt_f.sum(dim=-1).to(f32)
        t1, inc1, ok1 = _converge_dyn(rank1, k1, f, frag_idx, t_pub, tgt_f)
        if not params.exclude_first_sender:
            t_fin, inc_fin, ok = t1, inc1, ok1
            rank_o, k_o, mask_o = rank1, k1, tgt_f
        else:
            rank2, k2, send_mask = _phase2_masks_from_inc(
                inc1, t1, rank1, k1, tgt_f)
            # t1 is a guaranteed upper bound for phase 2
            t2, inc2, ok2 = _converge_dyn(rank2, k2, f, frag_idx, t_pub,
                                          send_mask, t_init=t1)
            t_fin, inc_fin, ok = t2, inc2, ok1 and ok2
            rank_o, k_o, mask_o = rank2, k2, send_mask
        if with_gossip:
            g_f, req_f, drain_f, mixed_o, wait_o = gossip_fold(t_fin)
        else:
            g_f = req_f = drain_f = None
            mixed_o = torch.zeros((), dtype=torch.bool, device=dev)
            wait_o = torch.zeros((), dtype=f32, device=dev)
        return (t_fin, rank_o, k_o, mask_o, g_f, req_f, drain_f, inc_fin,
                wait_o, mixed_o, ok)

    def frag_accounting(f, frag_idx, t_rx_one, rank, k_p, send_mask,
                        g_abs_f, req_any_f, drain_f, inc):
        """Bytes, copies, gossip counters, first-delivery slot, downlink
        arrivals and uplink drain of one fragment at its final times."""
        cand = offers(t_rx_one, rank, k_p, f, frag_idx, send_mask,
                      g_abs=g_abs_f)
        made_offer = cand < INF
        first_slot = torch.argmin(inc, dim=-1)
        q_t = neighbor_pull_min(t_rx_one, conns, rev, batch_factor=fragments)
        start_tx = torch.maximum(t_rx_one + params.proc_delay_ms, uplink)
        if payload_bytes >= params.idontwant_threshold_bytes:
            # IDONTWANT (v1.2): target announced receipt before our send
            send_start = start_tx[:, None] \
                + (rank + frag_idx * k_p[:, None]) * tx_ms[:, None]
            idw_arrived = q_t + lat_edge < send_start
            made_offer = made_offer & ~(idw_arrived & send_mask)
        eff_send = made_offer & send_mask
        sends = eff_send.sum(dim=-1)
        last_pos = torch.where(eff_send, rank + 1.0, 0.0).amax(dim=-1)
        up_end = torch.where(
            last_pos > 0.0,
            start_tx + (frag_idx * k_p + last_pos) * tx_ms, 0.0)
        zeros_n = torch.zeros((n,), dtype=f32, device=dev)
        if with_gossip:
            havers = (t_rx_one < INF) & can_send
            ihave_ct = torch.zeros((n, c), dtype=f32, device=dev)
            for h in range(n_rounds):
                ihave_ct = ihave_ct + (g_tgt_w[h] & havers[:, None])
            gossip_sent = req_any_f
            up_end = torch.maximum(up_end, drain_f)
            ihave_pp = ihave_ct.sum(dim=-1)
            iwant_rx_pp = gossip_sent.sum(dim=-1).to(f32)
            sends = sends + (gossip_sent & made_offer).sum(dim=-1)
            arrived = eff_send | (gossip_sent & made_offer)
            # one pull for the IHAVE count, the IWANT flag and the copy
            pack = (ihave_ct * 4.0 + gossip_sent.to(f32) * 2.0
                    + arrived.to(f32))
            slot_ok = (conns >= 0) & (rev >= 0)
            pulled = torch.where(slot_ok, pull(pack), 0.0)
            q_ihave = torch.floor(pulled / 4.0)
            rem = pulled - q_ihave * 4.0
            q_gs = torch.floor(rem / 2.0)
            ihave_rx_pp = q_ihave.sum(dim=-1)
            iwant_pp = q_gs.sum(dim=-1)
            arrived_rx = rem - q_gs * 2.0 > 0.5
        else:
            ihave_pp = iwant_pp = ihave_rx_pp = iwant_rx_pp = zeros_n
            arrived_rx = reciprocal_pull_bool(
                eff_send, conns, rev, batch_factor=fragments)
        copies = arrived_rx.sum(dim=-1).to(f32)
        arr_t = torch.where(arrived_rx, inc, -INF)
        return (sends, copies, ihave_pp, iwant_pp, ihave_rx_pp, iwant_rx_pp,
                first_slot, arr_t, up_end)

    # publisher emits fragments back-to-back (main.nim:177-179)
    frag_ids = torch.arange(fragments, dtype=f32, device=dev)
    t_pubs = t0_ms + frag_ids * tx_ms[publisher]
    fast = [phases_fast(f, frag_ids[f], t_pubs[f]) for f in range(fragments)]
    answer_wait = torch.stack([x[8] for x in fast]).amax()
    answer_interleaved = torch.stack([x[9] for x in fast]).sum(
        dtype=torch.int32)
    converged = all(x[10] for x in fast)

    t_rx_f = torch.stack([x[0] for x in fast])
    received = (t_rx_f < INF).all(dim=0)
    t_rx = torch.where(received, t_rx_f.amax(dim=0), INF)
    delay = torch.where(received, t_rx - t0_ms, INF)

    acct = [frag_accounting(f, frag_ids[f], *fast[f][:8])
            for f in range(fragments)]

    def total(i):
        return torch.stack([a[i] for a in acct]).sum(dim=0).to(torch.int32)

    sends, copies = total(0), total(1)
    ihave_pp, iwant_pp = total(2), total(3)
    ihave_rx_pp, iwant_rx_pp = total(4), total(5)

    # firstMessageDeliveries: credit the edge that delivered fragment 0
    fs = acct[0][6]
    got = received & ~is_pub
    credit = (torch.arange(c, device=dev) == fs[:, None]) & got[:, None]
    fmd = torch.clamp_max(state.fmd + credit.to(f32), params.fmd_cap)

    # IDONTWANT announce traffic, once per message
    if payload_bytes >= params.idontwant_threshold_bytes:
        idw_edge = (state.mesh_mask & valid & ~credit
                    & (got & can_send)[:, None])
        idw_tx_pp = idw_edge.sum(dim=-1, dtype=torch.int32)
        idw_rx_pp = reciprocal_pull_bool(idw_edge, conns, rev).sum(
            dim=-1, dtype=torch.int32)
    else:
        idw_tx_pp = idw_rx_pp = torch.zeros((n,), dtype=torch.int32,
                                            device=dev)

    result = DisseminationResult(
        t_rx_ms=t_rx,
        delay_ms=delay,
        received=received,
        sends=sends,
        copies_rx=copies,
        ihave_sent=ihave_pp,
        iwant_sent=iwant_pp,
        lost_tx=torch.zeros((n,), dtype=torch.int32, device=dev),
        answer_wait_max_ms=answer_wait,
        answer_interleaved=answer_interleaved,
        converged=torch.tensor(converged, device=dev),
        refine_passes=torch.zeros((), dtype=torch.int32, device=dev),
    )
    dup = torch.clamp_min(copies - fragments, 0)
    up_end_f = torch.stack([a[8] for a in acct])
    uplink_new = torch.maximum(uplink, up_end_f.amax(dim=0))
    # downlink occupancy: fold all delivered copies through each receiver's
    # single-server queue in arrival order (one sort plus elementwise)
    arr_all = torch.stack([a[7] for a in acct], dim=1).reshape(
        n, fragments * c)
    d_sorted = -torch.sort(-arr_all, dim=-1).values
    m_copies = copies.to(f32)
    pos = torch.arange(fragments * c, dtype=f32, device=dev)
    fold = torch.where(pos[None, :] < m_copies[:, None],
                       d_sorted + pos[None, :] * rx_ms[:, None], -INF)
    rx_free_new = torch.maximum(state.rx_free_ms + m_copies * rx_ms,
                                fold.amax(dim=-1))
    warm_new = torch.where(received, t_rx - t0_ms, INF)
    new_state = state.replace(
        key=key,
        warm_offset_ms=warm_new,
        uplink_free_ms=uplink_new,
        rx_free_ms=rx_free_new,
        fmd=fmd,
        bytes_tx=state.bytes_tx + sends.to(f32) * frag_bytes,
        bytes_rx=state.bytes_rx + copies.to(f32) * frag_bytes,
        dup_rx=state.dup_rx + dup.to(torch.int32),
        ihave_tx=state.ihave_tx + ihave_pp,
        iwant_tx=state.iwant_tx + iwant_pp,
        ihave_rx=state.ihave_rx + ihave_rx_pp,
        iwant_rx=state.iwant_rx + iwant_rx_pp,
        idontwant_tx=state.idontwant_tx + idw_tx_pp,
        idontwant_rx=state.idontwant_rx + idw_rx_pp,
    )
    return result, new_state
