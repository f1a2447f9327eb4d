"""Message dissemination as an earliest-arrival-time fixpoint (the hot path).

The port of the reference's ops/disseminate.py, exact and bounded delivery
modes. One call propagates one message (all fragments) and returns per-peer
arrival times plus the accounting the reference derives from them:

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
bar.

Exact mode (serialize_answers=True, the model of record): an answered
IWANT queues on the answering peer's uplink, and the arrival times must
include that wait. The fast pipeline still runs the unserialized fixpoint,
folds the answer queues at both phase results and checks whether a queued
answer could have been somebody's first delivery (`_diverged`). If any
fragment says so, the whole message is refined, once per message (one host
sync): by Jacobi iteration on the lat-sorted fold (`_converge_prefix`,
below the pull budget under answer_queue_mode "parallel_prefix"), falling
back to the global-sort engine when the prefix certificate fails; else by
the global-sort engine directly (`_converge_serialized`: per outer pass a
stable argsort of every peer's answer jobs and a from-INF mesh fixpoint
against the frozen answer floor, receiver-side above the budget).
`engine_counts` counts the routes taken.

Lossy topologies (`loss_stage`, the topogen `-l` packet loss) draw one
loss outcome per (fragment, directed edge) from one extra key:
`loss_mode="tcp"` (the default, Shadow's real TCP stacks: a geometric
number of RTO-doubling retransmissions becomes added latency, `retx_ms`,
and a copy is abandoned only after MAX_RETRIES) or `"message"` (the copy
is lost outright). A negative slow-peer or first-message-deliveries weight
arms the v1.1 score gates (publish, gossip, graylist) and the slow-peer
accrual. A lost or graylisted copy keeps its uplink slot and its tx bytes:
`survive` gates delivery only, and `lost_tx` counts the copies the network
dropped (the loss-only mask, without the graylist).

An unsubscribed publisher (`with_fanout`, gossipsub v1.1 fanout publish)
sends to its persistent fanout set: the unexpired members still valid,
topped back up to D by rank from one extra key's draws, written back with
a TTL from this publish (flood publish still floods, and still maintains
the set). With `params.warm_start` phase 1 is seeded from the previous
message's arrival offsets; a certificate checks the seed, and if any
fragment fails it the whole message reruns cold (one host decision per
message, counted in `engine_counts`), so the result equals a cold start.

`censor_edge` (ops/adversary.censor_mask) is an adversarial per-edge
drop mask folded into `survive` like the graylist gate: delivery only,
and not counted in `lost_tx`. `return_plan` adds the message's sampled
plan as a third output (the seam of the independent discrete-event
cross-check); it changes no result byte.

`mesh` (a rank's parallel/peer.PeerGroup; the caller drives the peer
mesh through Simulator(mesh=), runtime/sharded.py) runs the call on the
rank's rows, as the reference dispatches a mesh: every fixpoint
receiver-side through parallel/exchange.converge_sharded, the serial
engine for exact refinement (never the prefix engine), fragments
unrolled. Writes at a global row (the publisher's t0) are done by the
owning rank, reads of one (its tx time, its warm-start carry) are
broadcast, the pulls and the answer folds' reads of t at the neighbors
all-gather, and every host decision is all-reduced. The FMA site of the
lossless mesh base stays the one-device program's for the same global
shape (_contraction), so the rows equal the one-device run's.

`run_fused_rounds` chains R rounds of a heartbeat burst (through the
public heartbeat runners) and one publish at the carried clock, the
reference's bench chain.

Float arithmetic follows the reference's association order term by term,
and every division by a constant divides by a device tensor: CUDA turns a
division by a host scalar into a multiply by its reciprocal, which would
move results by an ulp. Where XLA's CPU backend contracts a multiply-add
into one FMA (the lossless mesh base, where the multiply it contracts
depends on the fixpoint), the port computes it in float64 and rounds once
(ops/xlamath.fma_f32).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch
from torch.profiler import record_function

from .. import prng
from ..parallel import peer
from ..parallel.exchange import (
    build_recv_constants,
    converge_recv,
)
from .pull import (
    exceeds_budget,
    neighbor_pull_bool,
    neighbor_pull_min,
    reciprocal_pull_bool,
    reciprocal_pull_min,
)
from .state import SimParams, SimState
from .xlamath import exp2_int, fma_f32, log_f32

INF = 3.4e38

# the (side, mode, phase) cases whose unserialized fixpoint has XLA's CPU
# backend contract the queue multiply of the lossless mesh base, not the
# latency one (see disseminate's mesh_scale)
_QUEUE_CONTRACTED = frozenset({("send", "exact", 2), ("recv", "bounded", 1),
                               ("recv", "exact", 2)})

# tcp loss model (the reference's constants): RTO = max(RTO_MIN_MS,
# 1.5 * RTT), doubling per failure; a copy is abandoned after MAX_RETRIES
RTO_MIN_MS = 200.0
MAX_RETRIES = 6

# any warm_offset_ms at or above this is "no valid carry" (INF after init,
# churn or a membership change, and for peers the message never reached)
WARM_VALID = 1e30

# exact-mode messages by route since the last reset: kept on the fast
# pipeline, refined by the prefix engine, refined by the serial engine
# directly, and prefix refinements that fell back to the serial engine;
# with warm_start, messages whose warm seed was certified and messages
# that reran cold (chip_smoke.py zeroes and reads them; they change no
# result)
ROUTES = ("fast", "prefix", "serial", "prefix_fallback")
engine_counts = dict.fromkeys(ROUTES + ("warm_certified", "warm_cold_rerun"),
                              0)


def reset_engine_counts() -> None:
    for k in engine_counts:
        engine_counts[k] = 0


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
    stage[conns[p, i]]] (0 on pads) and, with loss_stage, the same
    contraction of the loss matrix: experiment constants."""
    sel = _stage_select(stage, lat_ms.shape[0], conns, rev)
    lat_edge = torch.where(sel, lat_ms[stage.long()][:, None, :], 0.0
                           ).sum(dim=-1)
    loss_edge = None
    if loss_stage is not None:
        loss_edge = torch.where(sel, loss_stage[stage.long()][:, None, :],
                                0.0).sum(dim=-1)
    return lat_edge, loss_edge


def tcp_retries(u, loss_edge, lat_edge):
    """The tcp model at draws u (F, N, C): the retry count j = floor(log
    u / log p) in XLA's float32 log (ops/xlamath.py), survive iff j <=
    MAX_RETRIES, and the stall RTO * (2^j - 1). Returns (survive,
    retx_ms)."""
    f32 = torch.float32
    dev = u.device
    u = torch.maximum(u, torch.tensor(1e-12, dtype=f32, device=dev))
    # float32 bounds, as jnp.clip has them: 1 - 1e-9 rounds to 1.0, so a
    # loss of exactly 1.0 gives log p = +0, j = -inf: the copy survives
    # with no stall (a reference quirk the port keeps)
    safe_p = torch.clamp(loss_edge,
                         torch.tensor(1e-9, dtype=f32, device=dev),
                         torch.tensor(1.0 - 1e-9, dtype=f32, device=dev))
    j = torch.where(loss_edge > 0.0,
                    torch.floor(log_f32(u) / log_f32(safe_p)), 0.0)
    j = torch.clamp_max(j, float(MAX_RETRIES + 1))
    survive = j <= float(MAX_RETRIES)
    rto = torch.clamp_min(3.0 * lat_edge, RTO_MIN_MS)
    retx_ms = torch.where(survive & (j > 0.0), rto * (exp2_int(j) - 1.0),
                          0.0)
    return survive, retx_ms


def loss_draws(k_loss, loss_edge, lat_edge, fragments: int,
               loss_mode: str):
    """One loss outcome per (fragment, directed edge) from k_loss:
    (survive, retx_ms), each (F, N, C); message mode loses a copy with
    probability p outright and has no stall (retx_ms None)."""
    u = peer.uniform(k_loss, (fragments, *loss_edge.shape), axis=1)
    if loss_mode == "tcp":
        return tcp_retries(u, loss_edge, lat_edge)
    return u >= loss_edge, None


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


def _check_slice(*, mesh, loss_mode):
    if loss_mode not in ("message", "tcp"):
        raise ValueError(f"unknown loss_mode {loss_mode!r}")
    if mesh is not None and not isinstance(mesh, peer.PeerGroup):
        raise TypeError(
            "disseminate(mesh=) takes a rank's parallel/peer.PeerGroup; a "
            "caller drives a peer mesh through Simulator(mesh=)")


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
    new_state), and with `return_plan` also the message's sampled plan
    (below). The signature is the reference's; `mesh` is a rank's
    PeerGroup (module doc), and the arrays are then its rows.

    The plan is what this call drew and the model inputs it read, under the
    reference's keys: "tgt" (N, C) data send set (before the queue drop),
    "rprio" (N, C) send-order priorities, "g_tgt_w" (W, N, C) per-round
    gossip targets, "survive" (F, N, C) per-fragment delivery mask, (N, C)
    graylist-only, or None, "retx_ms" (F, N, C) tcp stall or None,
    "hb_phase", "uplink" and "rx_free" (N,) phases and pre-message
    occupancy, "rx_ms", "can_send" and "tx_ms" (N,), "lat_edge" (N, C) and
    "t_pubs" (F,) per-fragment publish times."""
    _check_slice(mesh=mesh, loss_mode=loss_mode)
    if mesh is None and peer.active() is not None:
        mesh = peer.active()
    with peer.using(mesh):
        return _disseminate(
            state, conns, rev, stage, lat_ms, bw_up_mbit_per_stage,
            publisher, t0_ms, params, payload_bytes, fragments, with_gossip,
            mesh, loss_stage, with_fanout, return_plan,
            bw_down_mbit_per_stage, loss_mode, lat_edge, loss_edge,
            ans_tables, valid_edge, censor_edge)


def _disseminate(state, conns, rev, stage, lat_ms, bw_up_mbit_per_stage,
                 publisher, t0_ms, params, payload_bytes, fragments,
                 with_gossip, mesh, loss_stage, with_fanout, return_plan,
                 bw_down_mbit_per_stage, loss_mode, lat_edge, loss_edge,
                 ans_tables, valid_edge, censor_edge):
    n, c = conns.shape
    dev = conns.device
    f32 = torch.float32
    publisher = int(publisher)
    t0_ms = torch.as_tensor(t0_ms, dtype=f32).to(dev)
    # one extra key each for loss and fanout, in that order: they move
    # k_rank and k_gossip too
    lossy = loss_stage is not None
    keys = prng.split(state.key, 3 + lossy + bool(with_fanout))
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

    if lat_edge is None or (loss_stage is not None and loss_edge is None):
        lat_c, loss_c = edge_tables(stage, lat_ms, conns, rev, loss_stage)
        lat_edge = lat_c if lat_edge is None else lat_edge
        loss_edge = loss_c if loss_edge is None else loss_edge

    if valid_edge is not None:
        valid = valid_edge
    else:
        valid = (conns >= 0) & neighbor_pull_bool(
            state.alive & state.subscribed, conns, rev)

    # v1.1 score thresholds: with non-negative weights no score can fall
    # below them, and the gates are left out
    thresholds_can_bind = params.slow_weight < 0.0 or params.fmd_weight < 0.0
    if thresholds_can_bind:
        sc = state.score(params)                       # my score of each nbr
        pub_ok = sc >= params.publish_threshold
        # graylist: the receiver ignores senders it scores below the
        # threshold; pulled to the sender side it gates delivery only
        gray_ok = reciprocal_pull_bool(sc >= params.graylist_threshold,
                                       conns, rev)
    survive = retx_ms = None
    if loss_stage is not None:
        survive, retx_ms = loss_draws(keys[3], loss_edge, lat_edge,
                                      fragments, loss_mode)
    # lost_tx counts the copies the network dropped: the loss-only mask,
    # before the graylist joins it
    survive_loss = survive
    if thresholds_can_bind:
        survive = gray_ok if survive is None else survive & gray_ok
    if censor_edge is not None:
        # an in-mesh censor silently withholds the copy: delivery only,
        # like the graylist, and not a network loss
        survive = (~censor_edge if survive is None
                   else survive & ~censor_edge)
    is_pub = peer.row_ids(n, dev) == publisher

    if with_fanout:
        # fanout set: the still-valid unexpired members, topped back up to
        # D by rank from fresh draws over the remaining topic peers (every
        # row is computed; only the publisher's is used and written back)
        fan_active = (state.fanout_mask & valid
                      & (state.fanout_expire[:, None] > t0_ms))
        if thresholds_can_bind:
            fan_active = fan_active & pub_ok
        need_fan = torch.clamp_min(
            float(params.d) - fan_active.sum(dim=-1).to(f32), 0.0)
        fan_cand = valid & ~fan_active
        if thresholds_can_bind:
            fan_cand = fan_cand & pub_ok
        fprio = torch.where(fan_cand, peer.uniform(keys[3 + lossy], (n, c)),
                            INF)
        fan_row = fan_active | (fan_cand
                                & (_ranks_f32(fprio) < need_fan[:, None]))

    tgt = state.mesh_mask & valid
    flood_set = valid & pub_ok if thresholds_can_bind else valid
    if with_fanout:
        # with flood publish the publisher floods; the fanout set is still
        # maintained
        pub_tgt = flood_set if params.flood_publish else fan_row
        tgt = torch.where(is_pub[:, None], pub_tgt, tgt)
    elif params.flood_publish:
        tgt = torch.where(is_pub[:, None], flood_set, tgt)

    # randomized send order per peer (one draw per message)
    rprio = torch.where(tgt, peer.uniform(k_rank, (n, c)), INF)

    # gossip targets: a fresh sample per mcache round of
    # max(D_lazy, gossip_factor * |candidates|) non-mesh topic peers
    g_cand = valid & ~tgt
    if thresholds_can_bind:
        # no IHAVE to peers scored below gossipThreshold
        g_cand = g_cand & (sc >= params.gossip_threshold)
    n_gc = g_cand.sum(dim=-1).to(f32)
    g_count = torch.clamp_min(params.gossip_factor * n_gc,
                              float(params.d_lazy))
    n_rounds = params.history_gossip if with_gossip else 1
    gkeys = prng.split(k_gossip, n_rounds)
    g_tgt_w = torch.stack([
        g_cand & _mask_count_smallest(
            torch.where(g_cand, peer.uniform(gkeys[h], (n, c)), INF),
            g_count)
        for h in range(n_rounds)
    ])                                                  # (W, N, C)
    g_tgt = g_tgt_w.any(dim=0)
    rounds = torch.arange(n_rounds, dtype=f32, device=dev)[:, None, None]
    g_off = torch.where(g_tgt_w, rounds, float(n_rounds)).amin(dim=0) \
        * params.heartbeat_ms
    hb_phase = state.hb_phase
    can_send = state.alive & state.subscribed
    if with_fanout:
        # the unsubscribed publisher originates (and gossips) the message
        can_send = can_send | (is_pub & state.alive)
    uplink = state.uplink_free_ms

    # TCP slow-start flights of the data transfers (see tcp_flights)
    ss_scale = torch.tensor(
        [1.0 + 2.0 * float(tcp_flights((f + 1) * frag_bytes, params) - 1)
         for f in range(fragments)], dtype=f32, device=dev)
    ans_scale = 1.0 + 2.0 * float(tcp_flights(frag_bytes, params) - 1)

    def _frag_slice(x, f: int):
        """Fragment f's view of a per-fragment (F, N, C) draw; a
        graylist-only survive mask is (N, C), shared by the fragments."""
        if x is None or x.dim() == 2:
            return x
        return x[f]

    def _deliver(mask, f: int):
        """The edges of `mask` whose copy of fragment f arrives: lost (or
        graylisted) copies never relax an edge, though their queue slots
        still count."""
        sv = _frag_slice(survive, f)
        return mask if sv is None else mask & sv

    def _deliver_g(g_abs, f: int):
        """Answer offers on the edges whose copy of fragment f arrives."""
        sv = _frag_slice(survive, f)
        return g_abs if sv is None else torch.where(sv, g_abs, INF)

    # delivery latency of a mesh copy (slow-start flights x wire latency)
    # and of a gossip answer (cold flights), each plus the tcp stall of
    # the fragment's draw (one draw per fragment-edge serves both)
    ld_mesh = [lat_edge * ss_scale[f] for f in range(fragments)]
    ld_ans = [lat_edge * ans_scale] * fragments
    if retx_ms is not None:
        ld_mesh = [ld + retx_ms[f] for f, ld in enumerate(ld_mesh)]
        ld_ans = [ld + retx_ms[f] for f, ld in enumerate(ld_ans)]
    # lossless, XLA's CPU backend contracts one of the two multiplies of the
    # mesh base `slot * tx_ms + lat_edge * ss_scale` into an FMA (it shows
    # only at fractional latencies, where lat_edge * ss_scale is inexact):
    # "lat" is fma(lat_edge, ss_scale, queue), "queue" fma(slot, tx_ms,
    # lat_edge * ss_scale). Which one is fixed per fused kernel, read off
    # the reference's object code and held bitwise in tests/port: every
    # fixpoint rounds "lat" except the unserialized one (_converge_dyn) in
    # the cases of _QUEUE_CONTRACTED. With a stall the latency is a sum
    # and the base rounds twice.
    mesh_scale = ([ss_scale[f] for f in range(fragments)]
                  if retx_ms is None else [None] * fragments)

    def _mesh_term(rank, k_p, frag_idx, f: int, contract: str):
        """queue + fragment f's mesh delivery latency, rounded as XLA."""
        slot = rank + 1.0 + frag_idx * k_p[:, None]
        if mesh_scale[f] is None:
            return slot * tx_ms[:, None] + ld_mesh[f]
        if contract == "queue":
            return fma_f32(slot, tx_ms[:, None], ld_mesh[f])
        return fma_f32(lat_edge, mesh_scale[f], slot * tx_ms[:, None])

    if with_gossip:
        if ans_tables is None:
            ans_tables = answer_tables(lat_edge, conns)
        perm_lat = ans_tables.perm_lat
        inv_lat = ans_tables.inv_lat
        lat_sorted = ans_tables.lat_sorted
        conns_sorted = ans_tables.conns_sorted
        gw_sorted = [torch.gather(g_tgt_w[h], 1, perm_lat)
                     for h in range(n_rounds)]

        def _sorted(x):
            """Per-fragment (N, C) slices of a draw, in lat order."""
            return [None if _frag_slice(x, f) is None
                    else torch.gather(_frag_slice(x, f), 1, perm_lat)
                    for f in range(fragments)]

        sv_sorted, retx_sorted = _sorted(survive), _sorted(retx_ms)

    neg_col = torch.full((n, 1), -INF, device=dev)
    zero_col = torch.zeros((n, 1), dtype=f32, device=dev)

    def _round_req(h, tick, live, q_t, lat, gw_h, sv):
        """The request semantics shared by the lat-sorted fold and the
        global-sort engine: round h's IHAVE leaves at a_h = max(tick +
        h*hb, uplink); a sampled live edge is requested iff the receiver
        still lacks the message when the IHAVE lands (q_t > a_h + lat),
        and a lossy edge loses the IHAVE with the copy (`sv`).
        Returns (a_h (N, 1), sampled, requested)."""
        a_h = torch.maximum(tick + h * params.heartbeat_ms, uplink)[:, None]
        samp = gw_h & live[:, None]
        req = samp & (q_t > a_h + lat)
        return a_h, samp, req if sv is None else req & sv

    def gossip_fold(t_rx, f: int):
        """Serialized gossip-answer offers via the per-round fold in the
        static lat order: (g_abs, req_any, drain, mixed, wait_max)."""
        base = t_rx + params.proc_delay_ms
        tick = _next_heartbeat(base, hb_phase, params.heartbeat_ms)
        live = can_send & (t_rx < INF)
        lda_s = lat_sorted * ans_scale
        if retx_sorted[f] is not None:
            lda_s = lda_s + retx_sorted[f]
        q_t_s = peer.all_rows(t_rx)[conns_sorted.clamp_min(0).long()]
        txp = tx_ms[:, None]
        busy = uplink
        g_sorted = torch.full((n, c), INF, device=dev)
        req_any_s = torch.zeros((n, c), dtype=torch.bool, device=dev)
        had_req = torch.zeros((n,), dtype=torch.bool, device=dev)
        mixed = torch.zeros((), dtype=torch.bool, device=dev)
        wait_max = torch.zeros((), dtype=f32, device=dev)
        prev_max_w = torch.full((n,), -INF, device=dev)
        for h in range(n_rounds):
            a_h, samp, req = _round_req(h, tick, live, q_t_s, lat_sorted,
                                        gw_sorted[h], sv_sorted[f])
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

    def _gossip_jobs(t_rx, f: int):
        """Every sampled (round h, slot i) answer job: its IWANT arrival
        W = announce departure + 2 link traversals (INF if not sampled) and
        whether it is requested; (N, H*C), column h*C + i."""
        base = t_rx + params.proc_delay_ms
        tick = _next_heartbeat(base, hb_phase, params.heartbeat_ms)
        live = can_send & (t_rx < INF)
        q_t = peer.all_rows(t_rx)[conns.clamp_min(0).long()]
        ws, reqs = [], []
        for h in range(n_rounds):
            a_h, samp, req = _round_req(h, tick, live, q_t, lat_edge,
                                        g_tgt_w[h], _frag_slice(survive, f))
            ws.append(torch.where(samp, a_h + 2.0 * lat_edge, INF))
            reqs.append(req)
        return torch.cat(ws, dim=-1), torch.cat(reqs, dim=-1)

    def _offers_from_serve(serve_u, f: int):
        """Per-edge answer offer from per-job serve starts: + one tx + the
        answer's cold-flight latency, min over the edge's sampled rounds;
        overflowed sums map back to the INF sentinel."""
        g_abs = (serve_u.reshape(n, n_rounds, c) + tx_ms[:, None, None]
                 + ld_ans[f][:, None, :]).amin(dim=1)
        return torch.where(g_abs < INF, g_abs, INF)

    def gossip_serial_exact(t_rx, f: int):
        """Exact serialized answer offers at the estimate t_rx: each peer's
        answer jobs form one single-server queue in IWANT-arrival order
        (stable: ties by (round, slot)), rounds chaining through the busy
        time. Returns (g_abs, req_any, drain)."""
        wf, req_b = _gossip_jobs(t_rx, f)
        req_any = req_b.reshape(n, n_rounds, c).any(dim=1)
        txp = tx_ms[:, None]
        perm = torch.argsort(wf, dim=-1, stable=True)
        ws = torch.gather(wf, 1, perm)
        rs = torch.gather(req_b.to(f32), 1, perm)
        R = torch.cumsum(rs, dim=-1)
        m_term = torch.where(rs > 0.0, ws - (R - 1.0) * txp, -INF)
        M = torch.cummax(m_term, dim=-1).values
        M_prev = torch.cat([neg_col, M[:, :-1]], dim=-1)
        R_prev = torch.cat([zero_col, R[:, :-1]], dim=-1)
        serve = torch.maximum(ws, M_prev + R_prev * txp)
        inv = torch.argsort(perm, dim=-1, stable=True)
        serve_u = torch.gather(serve, 1, inv)
        drain = torch.where(R[:, -1] > 0.0, M[:, -1] + R[:, -1] * tx_ms, 0.0)
        return _offers_from_serve(serve_u, f), req_any, drain

    def _queue(rank, k_p, frag_idx):
        return (rank + 1.0 + frag_idx * k_p[:, None]) * tx_ms[:, None]

    def offers(t_rx, rank, k_p, f, frag_idx, send_mask, g_abs=None,
               deliver_only=False):
        """Arrival-time offers made by every peer on every neighbor slot.
        `deliver_only` masks the copies the network loses (or the receiver
        graylists): for the receiver side; the transmit-side accounting
        leaves it off."""
        start = torch.maximum(t_rx + params.proc_delay_ms, uplink)
        cand = start[:, None] + _queue(rank, k_p, frag_idx) + ld_mesh[f]
        live = can_send[:, None] & (t_rx[:, None] < INF)
        sm = _deliver(send_mask, f) if deliver_only else send_mask
        cand = torch.where(sm & live, cand, INF)
        if with_gossip:
            cand = torch.minimum(
                cand, _deliver_g(g_abs, f) if deliver_only else g_abs)
        return cand

    def pull(cand):
        return reciprocal_pull_min(cand, conns, rev, batch_factor=fragments)

    # above the pull budget the fixpoints run receiver-side (the 1M-peer
    # class and, with 4 fragments, 100k peers), and always on a mesh
    recv_side_1d = exceeds_budget(f32, (peer.global_rows(n), c), fragments)
    recv_side = recv_side_1d or mesh is not None
    exact = with_gossip and params.serialize_answers

    def _contraction(phase: int) -> str:
        """The mesh base's FMA (see _mesh_term) in phase 1 or 2 of the
        unserialized fixpoint: the one-device program's for this global
        shape, on a mesh too."""
        key = ("recv" if recv_side_1d else "send",
               "exact" if exact else "bounded", phase)
        return "queue" if key in _QUEUE_CONTRACTED else "lat"

    def _recv_cst(rank, k_p, f, frag_idx, send_mask, gossip, contract):
        """Receiver-side constants of one fixpoint (large N): gathered
        once, then each sweep is elementwise plus the vmem_gather of the
        (N,) times."""
        return build_recv_constants(
            conns, rev, lat_edge, tx_ms, rank, k_p, frag_idx,
            _deliver(send_mask, f), can_send, _deliver(g_tgt, f), g_off,
            hb_phase, uplink, rx_const, params.proc_delay_ms,
            params.heartbeat_ms, gossip, lat_deliver=ld_mesh[f],
            ld_gossip=ld_ans[f], packed=params.packed_state,
            mesh_scale=mesh_scale[f], contract=contract,
        )

    def _mesh_base(rank, k_p, f, frag_idx, send_mask, contract="lat"):
        """Sender-side mesh offset of each slot (queue position + deliver
        latency), INF where the slot does not send or its copy is lost."""
        return torch.where(_deliver(send_mask, f) & can_send[:, None],
                           _mesh_term(rank, k_p, frag_idx, f, contract), INF)

    def _mesh_cand(t, a_base):
        """Mesh offers of one sender-side sweep at the estimate t: (live,
        cand) with live the reached senders as an (N, 1) column."""
        live = (t < INF)[:, None]
        start = torch.maximum(t + params.proc_delay_ms, uplink)
        return live, torch.where(live, start[:, None] + a_base, INF)

    def _converge_dyn(rank, k_p, f, frag_idx, t_pub, send_mask, phase,
                      t_init=None):
        """Unserialized fixpoint of phase 1 or 2; returns (t, inc,
        converged) with `inc` the deliver-only offer matrix of the last
        (no-change) sweep."""
        t0 = (torch.full((n,), INF, device=dev) if t_init is None
              else t_init.clone())
        peer.write_row(t0, publisher, t_pub)
        contract = _contraction(phase)
        if recv_side:
            return converge_recv(
                t0, _recv_cst(rank, k_p, f, frag_idx, send_mask, with_gossip,
                              contract), params.max_relax_iters)
        # below the budget: sender-major offers, row-gather pull per sweep
        a_base = _mesh_base(rank, k_p, f, frag_idx, send_mask, contract)
        g_base = torch.where(
            _deliver(g_tgt, f) & can_send[:, None],
            2.0 * lat_edge + ld_ans[f] + tx_ms[:, None], INF)
        t_rx = t0
        inc = torch.full(conns.shape, INF, device=dev)
        changed, it = True, 0
        while changed and it < params.max_relax_iters:
            live, cand = _mesh_cand(t_rx, a_base)
            if with_gossip:
                hb = _next_heartbeat(t_rx + params.proc_delay_ms, hb_phase,
                                     params.heartbeat_ms)
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

    def _floor_solver(rank, k_p, f, frag_idx, t_pub, send_mask):
        """The mesh-only fixpoint from INF against a frozen per-receiver
        gossip floor (the serialized answer offers of one outer pass,
        pulled and row-minimized): returns g_floor -> t. Its constants
        are built once per solver; each call restarts from INF."""
        t0 = torch.full((n,), INF, device=dev)
        peer.write_row(t0, publisher, t_pub)
        if recv_side:
            cst = _recv_cst(rank, k_p, f, frag_idx, send_mask, False, "lat")
            return lambda g_floor: converge_recv(
                t0, cst, params.max_relax_iters, g_floor=g_floor)[0]
        a_base = _mesh_base(rank, k_p, f, frag_idx, send_mask)

        def solve(g_floor):
            t_rx, changed, it = t0, True, 0
            while changed and it < params.max_relax_iters:
                _, cand = _mesh_cand(t_rx, a_base)
                t_new = torch.minimum(
                    t_rx,
                    torch.maximum(
                        torch.minimum(pull(cand).amin(dim=-1), g_floor),
                        rx_const))
                changed = bool((t_new < t_rx).any())
                t_rx, it = t_new, it + 1
            return t_rx

        return solve

    def _converge_serialized(rank, k_p, f, frag_idx, t_pub, send_mask,
                             t_seed):
        """Exact fixpoint of the serialized answer model as an outer
        iteration on the gossip estimate: each pass freezes the serialized
        offers at the estimate and re-relaxes the network from INF against
        them. The from-INF restart is required: the serialized system is
        not monotone in t (a later IHAVE can remove a requested job and
        make other answers earlier), so a warm-started min-only relaxation
        could undershoot and stick. A pass that reproduces its estimate
        bitwise is self-consistent, hence the exact fixpoint.
        Returns (t, converged, passes)."""
        solve = _floor_solver(rank, k_p, f, frag_idx, t_pub, send_mask)
        t_g = t_seed.clone()
        peer.write_row(t_g, publisher, t_pub)
        changed, it = True, 0
        while changed and it < params.max_relax_iters:
            g_abs, _, _ = gossip_serial_exact(t_g, f)
            t_new = solve(pull(_deliver_g(g_abs, f)).amin(dim=-1))
            changed = peer.any_(t_new != t_g)
            t_g, it = t_new, it + 1
        return t_g, not changed, it

    def _converge_prefix(rank, k_p, f, frag_idx, t_pub, send_mask, t_seed):
        """Exact fixpoint of the serialized answer model by Jacobi
        iteration: each pass evaluates the whole candidate map at the
        estimate (lat-sorted answer fold + mesh offers, one pull) and takes
        the result as it stands, with no min against the previous estimate
        (the map is not monotone; see _converge_serialized). Exits on a
        bitwise no-change pass. Returns (t, g_abs, req, drain, mixed,
        converged, passes) with the fold outputs of the last pass."""
        a_base = _mesh_base(rank, k_p, f, frag_idx, send_mask)
        t_g = t_seed.clone()
        t_g[publisher] = t_pub
        g_abs = torch.full((n, c), INF, device=dev)
        req = torch.zeros((n, c), dtype=torch.bool, device=dev)
        drain = torch.zeros((n,), dtype=f32, device=dev)
        mixed = torch.zeros((), dtype=torch.bool, device=dev)
        changed, it = True, 0
        while changed and it < params.max_relax_iters:
            g_abs, req, drain, mixed, _ = gossip_fold(t_g, f)
            live, cand = _mesh_cand(t_g, a_base)
            cand = torch.minimum(
                cand, torch.where(live, _deliver_g(g_abs, f), INF))
            t_new = torch.where(
                ~is_pub, torch.maximum(pull(cand).amin(dim=-1), rx_const),
                t_pub)
            changed = bool((t_new != t_g).any())
            t_g, it = t_new, it + 1
        return t_g, g_abs, req, drain, mixed, not changed, it

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

    def _diverged(t, inc, mixed):
        """Trigger of the exact refinement: a reached non-publisher peer
        strictly below every serialized candidate (beyond float tolerance)
        relied on a queued answer that really arrives later; interleaved
        announce rounds (`mixed`) also force it. A 0-dim bool tensor."""
        tol = 0.05 + 1e-5 * torch.where(t < INF, t, 0.0)
        bad = (t < inc.amin(dim=-1) - tol) & (t < INF) & ~is_pub
        return bad.any() | mixed

    def _attribution(t, rank, k_p, f, frag_idx, send_mask, g_abs, req):
        """Deliver-only offers pulled to the receivers, the gossip offers
        masked to answered edges (an unanswered edge's offer must not take
        the first-sender argmin)."""
        return pull(offers(t, rank, k_p, f, frag_idx, send_mask,
                           g_abs=torch.where(req, g_abs, INF),
                           deliver_only=True))

    def _phase1_order(f: int):
        """(send set, send ranks, send count) of phase 1 of fragment f."""
        tgt_f = queue_drop(tgt, f)
        rank1 = _ranks_f32(torch.where(tgt_f, rprio, INF))
        return tgt_f, rank1, tgt_f.sum(dim=-1).to(f32)

    def phases_fast(f: int, frag_idx, t_pub, warm: bool):
        """The unserialized two-phase pipeline of one fragment. Returns
        (t, rank, k, send_mask, g_abs, req_any, drain, inc, wait, mixed,
        ok, hint, bad): `wait` and `mixed` feed bounded mode's error bar,
        `hint` asks exact mode for the refinement, `bad` (a 0-dim bool
        tensor) flags a warm seed the certificate rejects.

        `warm` seeds phase 1 from the cross-publish carry, re-based to this
        publish: t_pub + offset[q] + offset[publisher] + one heartbeat. The
        seed is a heuristic upper bound, so the result is certified: at a
        fixpoint every reached non-publisher peer equals max(min incoming
        offer, downlink clamp) bitwise, while an undershot seed sticks
        strictly below it (or the loop was capped)."""
        tgt_f, rank1, k1 = order[f]
        if warm:
            w = state.warm_offset_ms
            w_pub = peer.read_row(w, publisher)
            seed = torch.where((w < WARM_VALID) & (w_pub < WARM_VALID),
                               t_pub + w + w_pub + params.heartbeat_ms,
                               INF)
            t1, inc1, ok1 = _converge_dyn(rank1, k1, f, frag_idx, t_pub,
                                          tgt_f, 1, t_init=seed)
            supported = torch.maximum(inc1.amin(dim=-1), rx_const)
            bad = (((t1 < supported) & (t1 < INF) & ~is_pub).any()
                   | torch.tensor(not ok1, device=dev))
        else:
            t1, inc1, ok1 = _converge_dyn(rank1, k1, f, frag_idx, t_pub,
                                          tgt_f, 1)
            bad = torch.zeros((), dtype=torch.bool, device=dev)
        if exact:
            # the answer queues folded at both phase results ride in the
            # attribution pulls and the accounting; the fixpoint itself
            # stays unserialized, certified by _diverged
            g1, req1, drain1, mixed1, _ = gossip_fold(t1, f)
            inc1p = _attribution(t1, rank1, k1, f, frag_idx, tgt_f, g1, req1)
            hint1 = _diverged(t1, inc1p, mixed1)
            if not params.exclude_first_sender:
                return (t1, rank1, k1, tgt_f, g1, req1, drain1, inc1p,
                        None, None, ok1, hint1, bad)
            rank2, k2, send_mask = _phase2_masks_from_inc(
                inc1p, t1, rank1, k1, tgt_f)
            t2, _, ok2 = _converge_dyn(rank2, k2, f, frag_idx, t_pub,
                                       send_mask, 2, t_init=t1)
            g2, req2, drain2, mixed2, _ = gossip_fold(t2, f)
            inc2 = _attribution(t2, rank2, k2, f, frag_idx, send_mask, g2,
                                req2)
            return (t2, rank2, k2, send_mask, g2, req2, drain2, inc2,
                    None, None, ok1 and ok2,
                    hint1 | _diverged(t2, inc2, mixed2), bad)
        if not params.exclude_first_sender:
            t_fin, inc_fin, ok = t1, inc1, ok1
            rank_o, k_o, mask_o = rank1, k1, tgt_f
        else:
            rank2, k2, send_mask = _phase2_masks_from_inc(
                inc1, t1, rank1, k1, tgt_f)
            # t1 is a guaranteed upper bound for phase 2
            t2, inc2, ok2 = _converge_dyn(rank2, k2, f, frag_idx, t_pub,
                                          send_mask, 2, t_init=t1)
            t_fin, inc_fin, ok = t2, inc2, ok1 and ok2
            rank_o, k_o, mask_o = rank2, k2, send_mask
        if with_gossip:
            g_f, req_f, drain_f, mixed_o, wait_o = gossip_fold(t_fin, f)
        else:
            g_f = req_f = drain_f = None
            mixed_o = torch.zeros((), dtype=torch.bool, device=dev)
            wait_o = torch.zeros((), dtype=f32, device=dev)
        return (t_fin, rank_o, k_o, mask_o, g_f, req_f, drain_f, inc_fin,
                wait_o, mixed_o, ok, None, bad)

    def phases_serial(f: int, frag_idx, t_pub, t_seed):
        """The two-phase pipeline with the global-sort engine supplying
        both fixpoints (exact answer queues in the delivery times and the
        accounting). `t_seed`: the previous engine's times, a near-correct
        gossip estimate. Returns the first 8 elements of phases_fast plus
        (converged, passes)."""
        tgt_f, rank1, k1 = order[f]
        t1, conv1, it1 = _converge_serialized(rank1, k1, f, frag_idx, t_pub,
                                              tgt_f, t_seed)
        g1, req1, drain1 = gossip_serial_exact(t1, f)
        inc1 = _attribution(t1, rank1, k1, f, frag_idx, tgt_f, g1, req1)
        if not params.exclude_first_sender:
            return t1, rank1, k1, tgt_f, g1, req1, drain1, inc1, conv1, it1
        rank2, k2, send_mask = _phase2_masks_from_inc(
            inc1, t1, rank1, k1, tgt_f)
        t2, conv2, it2 = _converge_serialized(rank2, k2, f, frag_idx, t_pub,
                                              send_mask, t1)
        g2, req2, drain2 = gossip_serial_exact(t2, f)
        inc2 = _attribution(t2, rank2, k2, f, frag_idx, send_mask, g2, req2)
        return (t2, rank2, k2, send_mask, g2, req2, drain2, inc2,
                conv1 and conv2, it1 + it2)

    def phases_prefix(f: int, frag_idx, t_pub, t_seed):
        """phases_serial's structure with _converge_prefix supplying both
        fixpoints. Element 8 is the certificate as a 0-dim bool tensor:
        both loops ended on a no-change pass and neither final fold saw
        interleaved announce rounds; a False one sends the message to the
        serial engine."""
        tgt_f, rank1, k1 = order[f]
        t1, g1, req1, drain1, mixed1, conv1, it1 = _converge_prefix(
            rank1, k1, f, frag_idx, t_pub, tgt_f, t_seed)
        inc1 = _attribution(t1, rank1, k1, f, frag_idx, tgt_f, g1, req1)
        if not params.exclude_first_sender:
            return (t1, rank1, k1, tgt_f, g1, req1, drain1, inc1,
                    ~mixed1 & conv1, it1)
        rank2, k2, send_mask = _phase2_masks_from_inc(
            inc1, t1, rank1, k1, tgt_f)
        t2, g2, req2, drain2, mixed2, conv2, it2 = _converge_prefix(
            rank2, k2, f, frag_idx, t_pub, send_mask, t1)
        inc2 = _attribution(t2, rank2, k2, f, frag_idx, send_mask, g2, req2)
        return (t2, rank2, k2, send_mask, g2, req2, drain2, inc2,
                ~mixed1 & ~mixed2 & (conv1 and conv2), it1 + it2)

    def exact_repair(fast):
        """The once-per-message engine dispatch of exact mode: returns the
        per-fragment 8-tuples the accounting reads, `converged` and the
        refinement passes (max over fragments)."""
        if not peer.any_(torch.stack([x[11] for x in fast])):
            engine_counts["fast"] += 1
            return [x[:8] for x in fast], all(x[10] for x in fast), 0
        seeds, spent = [x[0] for x in fast], [0] * fragments
        if params.answer_queue_mode == "parallel_prefix" and not recv_side:
            engine_counts["prefix"] += 1
            pref = [phases_prefix(f, frag_ids[f], t_pubs[f], seeds[f])
                    for f in range(fragments)]
            if bool(torch.stack([p[8] for p in pref]).all()):
                return ([p[:8] for p in pref], True,
                        max(p[9] for p in pref))
            # interleaved rounds or a capped loop: every fragment reruns
            # through the serial engine, seeded from the prefix times
            engine_counts["prefix_fallback"] += 1
            seeds, spent = [p[0] for p in pref], [p[9] for p in pref]
        else:
            engine_counts["serial"] += 1
        ser = [phases_serial(f, frag_ids[f], t_pubs[f], seeds[f])
               for f in range(fragments)]
        return ([s[:8] for s in ser], all(s[8] for s in ser),
                max(s[9] + spent[f] for f, s in enumerate(ser)))

    def frag_accounting(f, frag_idx, t_rx_one, rank, k_p, send_mask,
                        g_abs_f, req_any_f, drain_f, inc):
        """Bytes, copies, gossip counters, first-delivery slot, downlink
        arrivals, uplink drain, network-lost copies and slow-peer marks of
        one fragment at its final times."""
        sv_loss = _frag_slice(survive_loss, f)
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
            sent_any = eff_send | (gossip_sent & made_offer)
            arrived = _deliver(sent_any, f)
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
            sent_any = eff_send
            arrived_rx = reciprocal_pull_bool(
                _deliver(sent_any, f), conns, rev, batch_factor=fragments)
        lost_pp = (zeros_n if sv_loss is None
                   else (sent_any & ~sv_loss).sum(dim=-1).to(f32))
        copies = arrived_rx.sum(dim=-1).to(f32)
        arr_t = torch.where(arrived_rx, inc, -INF)
        # slow-peer penalty (main.nim:264-299): a delivery that waited
        # longer than the threshold in the sender's queue (earlier traffic
        # on its uplink included) marks the sender slow in the receiver's
        # score of it, the reciprocal slot
        slow_inc = None
        if params.slow_weight != 0.0:
            qdelay = torch.clamp_min(
                uplink - (t_rx_one + params.proc_delay_ms), 0.0
            )[:, None] + (rank + frag_idx * k_p[:, None]) * tx_ms[:, None]
            slow_send = send_mask & made_offer & (
                qdelay > params.slow_threshold_ms)
            slow_inc = reciprocal_pull_bool(
                slow_send, conns, rev, batch_factor=fragments).to(f32)
        return (sends, copies, ihave_pp, iwant_pp, ihave_rx_pp, iwant_rx_pp,
                first_slot, arr_t, up_end, lost_pp, slow_inc)

    # publisher emits fragments back-to-back (main.nim:177-179)
    frag_ids = torch.arange(fragments, dtype=f32, device=dev)
    t_pubs = t0_ms + frag_ids * peer.read_row(tx_ms, publisher)
    order = [_phase1_order(f) for f in range(fragments)]
    # profiler spans (chip_smoke.py reads them; no cost without a profiler)
    with record_function("disseminate.fast_pipeline"):
        fast = [phases_fast(f, frag_ids[f], t_pubs[f], params.warm_start)
                for f in range(fragments)]
        if params.warm_start:
            # one host decision per message: if any fragment's certificate
            # rejects its warm seed, every fragment reruns cold
            if peer.any_(torch.stack([x[12] for x in fast])):
                engine_counts["warm_cold_rerun"] += 1
                fast = [phases_fast(f, frag_ids[f], t_pubs[f], False)
                        for f in range(fragments)]
            else:
                engine_counts["warm_certified"] += 1
    if exact:
        # the refinement makes the times exact: no error bar to report
        with record_function("disseminate.refinement"):
            final, converged, refine_passes = exact_repair(fast)
        answer_wait = torch.zeros((), dtype=f32, device=dev)
        answer_interleaved = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        final, converged, refine_passes = ([x[:8] for x in fast],
                                           all(x[10] for x in fast), 0)
        answer_wait = peer.max_(torch.stack([x[8] for x in fast])).amax()
        answer_interleaved = peer.or_(torch.stack([x[9] for x in fast])).sum(
            dtype=torch.int32)

    t_rx_f = torch.stack([x[0] for x in final])
    received = (t_rx_f < INF).all(dim=0)
    t_rx = torch.where(received, t_rx_f.amax(dim=0), INF)
    delay = torch.where(received, t_rx - t0_ms, INF)

    acct = [frag_accounting(f, frag_ids[f], *final[f])
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
        lost_tx=total(9),
        answer_wait_max_ms=answer_wait,
        answer_interleaved=answer_interleaved,
        converged=torch.tensor(converged, device=dev),
        refine_passes=torch.tensor(refine_passes, dtype=torch.int32,
                                   device=dev),
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
    slow_penalty = state.slow_penalty
    if params.slow_weight != 0.0:
        # the counter accrues unweighted; score() applies the weight
        slow_penalty = slow_penalty + torch.stack(
            [a[10] for a in acct]).sum(dim=0)
    warm_new = torch.where(received, t_rx - t0_ms, INF)
    new_state = state.replace(
        key=key,
        warm_offset_ms=warm_new,
        uplink_free_ms=uplink_new,
        rx_free_ms=rx_free_new,
        fmd=fmd,
        slow_penalty=slow_penalty,
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
    if with_fanout:
        # persist the publisher's (replenished) fanout set and restart its
        # TTL from this publish: float32 t0 plus the TTL, rounded once
        ttl = torch.tensor(params.fanout_ttl_ms, dtype=f32, device=dev)
        new_state = new_state.replace(
            fanout_mask=torch.where(is_pub[:, None], fan_row,
                                    state.fanout_mask),
            fanout_expire=torch.where(is_pub, t0_ms + ttl,
                                      state.fanout_expire))
    if return_plan:
        plan = {
            "tgt": tgt,
            "rprio": rprio,
            "g_tgt_w": g_tgt_w,
            "survive": survive,
            "retx_ms": retx_ms,
            "hb_phase": hb_phase,
            "uplink": uplink,
            "rx_free": state.rx_free_ms,
            "rx_ms": rx_ms,
            "can_send": can_send,
            "tx_ms": tx_ms,
            "lat_edge": lat_edge,
            "t_pubs": t_pubs,
        }
        return result, new_state, plan
    return result, new_state


# ---------------------------------------------------------------------------
# Round chains: R x [heartbeat burst -> publish at the carried clock]


def run_fused_rounds(state: SimState, conns, rev, stage, lat_ms, bw,
                     out_mask, publishers, params: SimParams,
                     payload_bytes: int, hb_per_round: int, *,
                     fragments: int = 1, with_gossip: bool = True,
                     loss_stage=None, loss_mode: str = "tcp", lat_edge=None,
                     loss_edge=None, ans_tables=None, valid_edge=None,
                     censor_edge=None, attacker=None, adv=None, ctrl=None,
                     faults=None, crash=None, side=None, spike=None,
                     telemetry=None):
    """Run R = len(publishers) rounds, each `hb_per_round` heartbeats and
    then one publish from `publishers[r]` at the carried sim clock (t0_ms
    = state.t_ms, the bench chain's convention).

    The heartbeat runner of a round is the public one the arms select, in
    the reference's order: run_faulted_heartbeats (a fault schedule; it
    needs the attacker), run_adaptive_heartbeats (an armed adaptive
    policy: the controller `ctrl` rides along, default a fresh one),
    run_attacked_heartbeats (attacker and adv), run_recorded_heartbeats
    (armed telemetry), else run_heartbeats.

    `params.fused_rounds` selects the reference's one-scan program; the
    port runs the same host loop either way (no capture yet), so both
    modes give the phase-split chain's bytes, which the reference's fused
    scan matches within its own rtol. The repair leaves stay on the state:
    no path that runs with repair inert reads or writes them.

    Returns (state, results, obs): the DisseminationResult leaves stacked
    (R, ...), obs mapping each observable channel to its (R,
    hb_per_round, ...) curve ({} when nothing is armed). With an armed
    adaptive policy the first element is (state, ctrl)."""
    from .adversary import run_adaptive_heartbeats, run_attacked_heartbeats
    from .faults import run_faulted_heartbeats
    from .heartbeat import run_heartbeats
    from .state import init_adaptive_ctrl
    from .telemetry import run_recorded_heartbeats

    faulted = faults is not None and faults.enabled
    attacked = attacker is not None and adv is not None
    adaptive = attacked and adv.adaptive.enabled
    if telemetry is not None and not telemetry.enabled:
        telemetry = None
    if (adv is None) != (attacker is None):
        raise ValueError("attacker and adv arm together — pass both or "
                         "neither")
    if faulted and not attacked:
        raise ValueError("faults compose on the attack window — pass "
                         "attacker and adv (a zero-attacker cohort is fine)")
    if ctrl is not None and not adaptive:
        raise ValueError("ctrl given but adv.adaptive is disabled — the "
                         "base runners carry none")
    if adaptive and ctrl is None:
        ctrl = init_adaptive_ctrl(params.n, conns.device)

    results, obs_list = [], []
    for pub in publishers:
        if faulted:
            out, obs = run_faulted_heartbeats(
                state, conns, rev, out_mask, attacker, params, adv, faults,
                crash, side, spike, hb_per_round, telemetry=telemetry,
                ctrl=ctrl)
            state, ctrl = out if adaptive else (out, ctrl)
        elif adaptive:
            (state, ctrl), obs = run_adaptive_heartbeats(
                state, conns, rev, out_mask, attacker, params, adv,
                hb_per_round, ctrl=ctrl, telemetry=telemetry)
        elif attacked:
            state, obs = run_attacked_heartbeats(
                state, conns, rev, out_mask, attacker, params, adv,
                hb_per_round, telemetry=telemetry)
        elif telemetry is not None:
            state, obs = run_recorded_heartbeats(
                state, conns, rev, out_mask, params, hb_per_round,
                telemetry)
        else:
            state = run_heartbeats(state, conns, rev, out_mask, params,
                                   hb_per_round)
            obs = {}
        res, state = disseminate(
            state, conns, rev, stage, lat_ms, bw, publisher=int(pub),
            t0_ms=state.t_ms, params=params, payload_bytes=payload_bytes,
            fragments=fragments, with_gossip=with_gossip,
            loss_stage=loss_stage, loss_mode=loss_mode, lat_edge=lat_edge,
            loss_edge=loss_edge, ans_tables=ans_tables,
            valid_edge=valid_edge, censor_edge=censor_edge)
        results.append(res)
        obs_list.append(obs)
    stacked = DisseminationResult(**{
        f.name: torch.stack([getattr(r, f.name) for r in results])
        for f in fields(DisseminationResult)})
    obs = {k: torch.stack([o[k] for o in obs_list])
           for k in sorted(obs_list[0])}
    return ((state, ctrl) if adaptive else state), stacked, obs
