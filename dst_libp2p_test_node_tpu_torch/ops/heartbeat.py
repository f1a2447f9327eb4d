"""GossipSub heartbeat as tensor ops (the reference's ops/heartbeat.py).

One call of `heartbeat_step` is one heartbeat: mesh rebalance (graft when
|mesh| < D_low up to D, prune when |mesh| > D_high down to D keeping the
D_score best-scored and at least D_out outbound members), PRUNE backoff,
optional churn and opportunistic grafting, fanout expiry, and the decay
protocol, and the opt-in mesh-repair branches (`params.evict`: score
eviction, counted as a PRUNE in both ledgers; `params.px`: PX capture on
PRUNE into `px_pool`, acted on by ops/repair.py). Reciprocity
(GRAFT/PRUNE) is one reverse-slot pull (ops/pull.py).

The reference's `lax.cond`s become Python `if`s on a device predicate
(`bool(t.any())`, one device-to-host sync each); `lax.scan` becomes a
Python loop. Key consumption is the reference's: five keys split per step
whether or not a branch runs, so the PRNG stream stays in step.

On a rank of the peer mesh (parallel/peer.py) the step runs on the
rank's rows: its draws are those rows of the whole draw, its branch
predicates are all-reduced over the ranks (every rank takes the branch the
one-device run takes), and the pulls and the PX advert read all-gathered
tables. Everything else is row-local.

`run_heartbeats` keeps the reference's two scan-level protocols: the
deferred decay (two carried f32 scales, materialized once after the loop
by the score_update kernel) and, with churn off, the hoisted validity mask
with the carried mesh degree.
"""

from __future__ import annotations

import torch

from .. import prng
from ..native.score_update import score_update
from ..parallel import peer
from .pull import neighbor_pull_bool, reciprocal_pull_bool
from .state import PX_POOL_WIDTH, SimParams, SimState

BIG = 1e30


def _ranks(priority: torch.Tensor) -> torch.Tensor:
    """Per-row rank of each slot under ascending priority (a stable double
    argsort, like jnp.argsort: BIG-padded slots tie)."""
    order = torch.argsort(priority, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _apply_decay(arr: torch.Tensor, scale, params: SimParams) -> torch.Tensor:
    """Geometric decay with the zero-cutoff: where(arr*scale < z, 0, ...)."""
    eff = arr * scale
    return torch.where(eff < params.decay_to_zero, 0.0, eff)


def _churny(params: SimParams) -> bool:
    return params.churn_down_per_hb > 0.0 or params.churn_up_per_hb > 0.0


def heartbeat_step(
    state: SimState,
    conns: torch.Tensor,
    rev: torch.Tensor,
    out_mask: torch.Tensor,
    params: SimParams,
    nbr_ok: torch.Tensor | None = None,
    valid_pre: torch.Tensor | None = None,
    decay_scales=None,
    deg_in: torch.Tensor | None = None,
    edge_ok: torch.Tensor | None = None,
):
    """One heartbeat. The optional arguments are the reference's:
    `nbr_ok` / `valid_pre` hoisted neighbor and edge validity (churn off),
    `decay_scales` the deferred-decay (fmd_scale, slow_scale) pair,
    `deg_in` the carried (N,) mesh degree (requires valid_pre, churn off,
    no edge_ok); with `deg_in` the step returns (state, deg_out).
    `edge_ok`: an (N, C) per-edge availability mask ANDed into validity
    (a partitioned edge, ops/faults.py)."""
    if deg_in is not None and (valid_pre is None or edge_ok is not None
                               or _churny(params)):
        raise ValueError("deg_in requires valid_pre, no edge_ok, and churn "
                         "off (run_heartbeats' churn-free scan protocol)")
    n, c = conns.shape
    key, k_graft, k_keep, k_churn_d, k_churn_u = prng.split(state.key, 5)
    t = state.t_ms

    # -- churn ---------------------------------------------------------------
    alive = state.alive
    if _churny(params):
        dies = peer.uniform(k_churn_d, (n,)) < params.churn_down_per_hb
        revives = peer.uniform(k_churn_u, (n,)) < params.churn_up_per_hb
        alive = torch.where(alive, ~dies, revives)
        nbr_ok = None
        valid_pre = None
        # the warm-start carry was measured on the old liveness set
        warm = torch.full_like(state.warm_offset_ms, 3.4e38)
    else:
        warm = state.warm_offset_ms

    if valid_pre is not None:
        valid = valid_pre
    else:
        if nbr_ok is None:
            nbr_ok = neighbor_pull_bool(alive & state.subscribed, conns, rev)
        valid = ((conns >= 0) & alive[:, None] & nbr_ok
                 & state.subscribed[:, None])
    if edge_ok is not None:
        valid = valid & edge_ok

    if deg_in is not None:
        mesh = state.mesh_mask           # mesh ⊆ valid by the protocol
        deg = deg_in
    else:
        mesh = state.mesh_mask & valid
        deg = mesh.sum(dim=-1, dtype=torch.int32)

    def _score_now():
        if decay_scales is None:
            return state.score(params)
        f_sc, s_sc = decay_scales
        return state.replace(
            fmd=_apply_decay(state.fmd, f_sc, params),
            slow_penalty=_apply_decay(state.slow_penalty, s_sc, params),
        ).score(params)

    og_enabled = params.opportunistic_graft_threshold > -9999.0
    shared_scores = _score_now() if og_enabled else None

    def get_scores():
        return shared_scores if shared_scores is not None else _score_now()

    zeros_n = torch.zeros((n,), dtype=torch.int32, device=conns.device)

    # -- GRAFT: |mesh| < D_low -> add random eligible peers up to D ----------
    need = torch.where(deg < params.d_low, params.d - deg, 0)
    graft_fired = peer.any_(need > 0)
    if graft_fired:
        eligible = (valid & ~mesh & (state.backoff_until <= t)
                    & (get_scores() >= 0.0))
        g_prio = torch.where(eligible, peer.uniform(k_graft, (n, c)), BIG)
        grafted = (_ranks(g_prio) < need[:, None]) & eligible
        graft_rx = reciprocal_pull_bool(grafted, conns, rev)
        mesh = (mesh | grafted | graft_rx) & valid
        deg2 = mesh.sum(dim=-1, dtype=torch.int32)
        graft_tx_inc = grafted.sum(dim=-1, dtype=torch.int32)
        graft_rx_inc = graft_rx.sum(dim=-1, dtype=torch.int32)
    else:
        deg2, graft_tx_inc, graft_rx_inc = deg, zeros_n, zeros_n

    # -- PRUNE: |mesh| > D_high -> keep D (D_score best, >= D_out outbound) --
    over = deg2 > params.d_high
    prune_fired = peer.any_(over)
    backoff = state.backoff_until
    prune_tx_inc = prune_rx_inc = zeros_n
    if prune_fired:
        rand_keep = peer.uniform(k_keep, (n, c))
        scores = get_scores()
        s_prio = torch.where(mesh, -scores + 1e-3 * rand_keep, BIG)
        top_score = (_ranks(s_prio) < params.d_score) & mesh
        out_in_top = (top_score & out_mask).sum(dim=-1, dtype=torch.int32)
        need_out = torch.clamp(params.d_out - out_in_top, 0, params.d)
        o_mask = mesh & out_mask & ~top_score
        o_prio = torch.where(o_mask, rand_keep, BIG)
        keep_out = (_ranks(o_prio) < need_out[:, None]) & o_mask
        base = top_score | keep_out
        need_fill = torch.clamp(
            params.d - base.sum(dim=-1, dtype=torch.int32), 0, params.d)
        f_mask = mesh & ~base
        f_prio = torch.where(f_mask, rand_keep, BIG)
        keep = base | ((_ranks(f_prio) < need_fill[:, None]) & f_mask)
        pruned = mesh & ~keep & over[:, None]
        mesh = mesh & ~pruned
        pruned_by_peer = reciprocal_pull_bool(pruned, conns, rev)
        backoff = torch.where(pruned | pruned_by_peer,
                              t + params.prune_backoff_ms, backoff)
        mesh = mesh & ~pruned_by_peer
        prune_tx_inc = pruned.sum(dim=-1, dtype=torch.int32)
        prune_rx_inc = pruned_by_peer.sum(dim=-1, dtype=torch.int32)
    got_pruned = None              # the PRUNEs received, for PX capture
    if params.px:
        got_pruned = (pruned_by_peer if prune_fired
                      else torch.zeros_like(mesh))

    # -- score eviction (mesh repair, params.evict): PRUNE members scoring
    # below the floor, with backoff on both sides ----------------------------
    ev_tx_inc = ev_rx_inc = zeros_n
    evict_fired = False
    if params.evict:
        ev_cand = mesh & (get_scores() < params.eviction_threshold)
        evict_fired = peer.any_(ev_cand)
        if evict_fired:
            ev_rx = reciprocal_pull_bool(ev_cand, conns, rev)
            backoff = torch.where(ev_cand | ev_rx,
                                  t + params.prune_backoff_ms, backoff)
            mesh = mesh & ~ev_cand & ~ev_rx
            ev_tx_inc = ev_cand.sum(dim=-1, dtype=torch.int32)
            ev_rx_inc = ev_rx.sum(dim=-1, dtype=torch.int32)
            if params.px:
                got_pruned = got_pruned | ev_rx

    # -- PX on PRUNE (mesh repair, params.px): every prunee stores the
    # pruner's best-scored valid neighbors (no PRNG: slot-index tiebreak) ---
    px_pool = state.px_pool
    if params.px and peer.any_(got_pruned):
        px_pool = _px_capture(state.px_pool, got_pruned, valid, conns,
                              get_scores(), params)

    # -- opportunistic grafting (v1.1, main.nim:292) --------------------------
    og_tx_inc = og_rx_inc = zeros_n
    og_fired = False
    if og_enabled:
        scores = get_scores()
        deg3 = mesh.sum(dim=-1, dtype=torch.int32)
        msort = torch.sort(torch.where(mesh, scores, BIG), dim=-1).values
        k_med = torch.clamp(deg3 // 2, 0, c - 1)
        median = torch.gather(msort, 1, k_med[:, None].long())[:, 0]
        low = (median < params.opportunistic_graft_threshold) & (deg3 > 0)
        og_elig = (valid & ~mesh & (backoff <= t)
                   & (scores > median[:, None]) & low[:, None])
        og_prio = torch.where(og_elig, -scores, BIG)
        og = (_ranks(og_prio) < 2) & og_elig
        og_fired = peer.any_(og)
        if og_fired:
            rx = reciprocal_pull_bool(og, conns, rev)
            mesh = (mesh | og | rx) & valid
            og_tx_inc = og.sum(dim=-1, dtype=torch.int32)
            og_rx_inc = rx.sum(dim=-1, dtype=torch.int32)

    # -- score decay (decayInterval == heartbeat; main.nim:272-273) ----------
    fmd, slow = state.fmd, state.slow_penalty
    if decay_scales is None and peer.any_((fmd > 0) | (slow > 0)):
        fmd = _apply_decay(fmd, params.fmd_decay, params)
        slow = _apply_decay(slow, params.slow_decay, params)

    # -- fanout expiry (v1.1 fanoutTTL) --------------------------------------
    fanout = state.fanout_mask
    if peer.any_(state.fanout_expire > 0.0):
        fanout = fanout & (t < state.fanout_expire)[:, None]

    new_state = state.replace(
        mesh_mask=mesh,
        fanout_mask=fanout,
        backoff_until=backoff,
        fmd=fmd,
        slow_penalty=slow,
        alive=alive,
        warm_offset_ms=warm,
        t_ms=t + params.heartbeat_ms,
        key=key,
        grafts=state.grafts + graft_tx_inc + og_tx_inc,
        grafts_rx=state.grafts_rx + graft_rx_inc + og_rx_inc,
        # an eviction is a PRUNE control message: counted in both ledgers
        prunes=state.prunes + prune_tx_inc + ev_tx_inc,
        prunes_rx=state.prunes_rx + prune_rx_inc + ev_rx_inc,
        evictions=state.evictions + ev_tx_inc,
        px_pool=px_pool,
    )
    if deg_in is None:
        return new_state
    # carried degree: re-reduce only when a branch touched the mesh
    if graft_fired or prune_fired or og_fired or evict_fired:
        return new_state, mesh.sum(dim=-1, dtype=torch.int32)
    return new_state, deg_in


def _px_capture(pool, got_pruned, valid, conns, scores, params):
    """The prunee's px_pool after this round's PRUNEs: each pruner
    advertises its first px_count valid neighbors scoring >= 0 (best score
    first, slot index breaking ties); a prunee reads the advert off its
    lowest pruning slot and drops its own id from it."""
    n, c = conns.shape
    dev = conns.device
    elig = valid & (scores >= 0.0)
    prio = (torch.where(elig, -scores, BIG)
            + 1e-4 * torch.arange(c, dtype=torch.float32, device=dev))
    w = min(PX_POOL_WIDTH, c)
    order = torch.argsort(prio, dim=-1, stable=True)[:, :w]
    take_ok = (torch.gather(elig, 1, order)
               & (torch.arange(w, device=dev) < params.px_count))
    cand = torch.where(take_ok, torch.gather(conns, 1, order), -1)
    if w < PX_POOL_WIDTH:
        cand = torch.nn.functional.pad(cand, (0, PX_POOL_WIDTH - w),
                                       value=-1)
    got = got_pruned.any(dim=-1)
    i0 = torch.argmax(got_pruned.to(torch.uint8), dim=-1)
    pruner = torch.gather(conns, 1, i0[:, None])[:, 0]
    advert = peer.all_rows(cand)[pruner.clamp_min(0).long()]
    me = peer.row_ids(n, dev).to(advert.dtype)
    advert = torch.where(advert == me[:, None], -1, advert)
    return torch.where(got[:, None], advert, pool)


def run_heartbeats(
    state: SimState,
    conns: torch.Tensor,
    rev: torch.Tensor,
    out_mask: torch.Tensor,
    params: SimParams,
    steps: int,
) -> SimState:
    """`steps` heartbeats with the deferred decay, materialized once at the
    end by the score_update kernel (on CUDA) or its plain version (CPU)."""
    nbr_ok = valid_pre = None
    if not _churny(params):
        # alive/subscribed are invariant across the loop without churn:
        # hoist the neighbor pull and the whole validity conjunction
        nbr_ok = neighbor_pull_bool(state.alive & state.subscribed, conns,
                                    rev)
        valid_pre = ((conns >= 0) & state.alive[:, None] & nbr_ok
                     & state.subscribed[:, None])

    f_sc = torch.ones((), dtype=torch.float32, device=conns.device)
    s_sc = f_sc
    if valid_pre is not None:
        # carried-degree protocol: establish mesh ⊆ valid once
        mesh0 = state.mesh_mask & valid_pre
        state = state.replace(mesh_mask=mesh0)
        deg = mesh0.sum(dim=-1, dtype=torch.int32)
        for _ in range(steps):
            state, deg = heartbeat_step(
                state, conns, rev, out_mask, params, nbr_ok=nbr_ok,
                valid_pre=valid_pre, decay_scales=(f_sc, s_sc), deg_in=deg)
            f_sc = f_sc * params.fmd_decay
            s_sc = s_sc * params.slow_decay
    else:
        for _ in range(steps):
            state = heartbeat_step(
                state, conns, rev, out_mask, params, nbr_ok=nbr_ok,
                valid_pre=valid_pre, decay_scales=(f_sc, s_sc))
            f_sc = f_sc * params.fmd_decay
            s_sc = s_sc * params.slow_decay
    # materialize the deferred decay once (exact: geometric decay with a
    # monotone zero-cutoff commutes with deferral); the fused kernel also
    # emits the score, which this site does not read
    fmd, slow, _ = score_update(state.fmd, state.slow_penalty,
                                torch.stack([f_sc, s_sc]), params)
    return state.replace(fmd=fmd, slow_penalty=slow)
