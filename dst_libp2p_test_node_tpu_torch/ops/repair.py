"""Mesh repair: score eviction, PX-on-PRUNE and re-dial recovery (the
reference's ops/repair.py).

Eviction and PX capture are heartbeat branches (ops/heartbeat.py,
`params.evict` / `params.px`); `repair_round` here acts on the PX pool
and re-dials starved peers, and `run_recovery_heartbeats` is the
post-attack window of [heartbeat_step -> repair_round] rounds.

A dial makes the connection graph dynamic, under the reference's contract:

  * new edges only fill padding slots (conns == -1), and the reverse-slot
    involution is extended in the same round (conns/rev/out_mask are
    returned, never written in place);
  * at most one dial per peer per round, and an acceptor takes one inbound
    dial per round: the lowest dialer id wins (a scatter-min, which gives
    the same bytes however the colliding writes are ordered) and a dialing
    peer does not accept;
  * a committed dial sets the whole warm-start carry to INF, and the host
    re-derives every per-edge table before the next publish
    (Simulator.rebind_graph).

The static runner passes actor=~attacker: attackers do not run the
controller. `run_dht_recovery_heartbeats` draws the re-dial candidates
from a DHT shortlist (ops/dht_adversary.dht_repair_pool) instead of a
random peer, with sybils refusing every dial, and
`run_adaptive_recovery_heartbeats` contests each round with the adaptive
attacker (ops/adversary.adaptive_round), which with slot_race runs the
dial controller too and accepts dials.

On a rank of the peer mesh (parallel/peer.py) a round runs on the rank's
rows. What a dial reads of its target (liveness, a free slot, its score
and backoff on the reciprocal slot) comes from the all-gathered rows; what
it writes into the target's row goes through the peer helpers that give
the one-device bytes whatever rank writes: the acceptor's winner is a
scatter-min over the ranks, the counterpart's mesh slot an OR, its graft
count an integer sum. The branch predicate, the window's counts and the
publisher's row are taken over every rank.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .. import prng
from ..parallel import peer
from .adversary import (AdversaryParams, adaptive_round, attack_observables,
                        cohort_order)
from .heartbeat import heartbeat_step
from .state import AdaptiveCtrl, SimParams, SimState, init_adaptive_ctrl
from .telemetry import stack_obs, telemetry_observables

INF = 3.4e38


@dataclass(frozen=True)
class RepairParams:
    """The repair knobs as a standalone config surface; `apply` folds them
    into a SimParams. Defaults are all off."""

    evict: bool = False
    eviction_threshold: float = -50.0
    px: bool = False
    px_count: int = 6
    redial: bool = False
    redial_patience: int = 3

    @property
    def enabled(self) -> bool:
        return self.evict or self.px or self.redial

    def validate(self) -> None:
        if self.eviction_threshold > 0:
            raise ValueError("eviction_threshold must be <= 0")
        if self.px_count < 1:
            raise ValueError("px_count must be >= 1")
        if self.redial_patience < 1:
            raise ValueError("redial_patience must be >= 1")

    def apply(self, params: SimParams) -> SimParams:
        out = dataclasses.replace(
            params,
            evict=self.evict,
            eviction_threshold=self.eviction_threshold,
            px=self.px,
            px_count=self.px_count,
            redial=self.redial,
            redial_patience=self.redial_patience,
        )
        out.validate()
        return out


def _row_take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[i, idx[i]] for every row i."""
    return torch.gather(a, 1, idx[:, None].long())[:, 0]


def repair_round(state: SimState, conns, rev, out_mask, params: SimParams,
                 actor=None, dht_pool=None, refuse=None):
    """One round of the repair controller, after heartbeat_step. Returns
    (state, conns, rev, out_mask). `actor`: the (N,) peers that run the
    controller (default all live ones); every live peer accepts dials.

    Per acting peer, at most one action: graft the first live PX
    candidate it is already connected to (both sides' backoff and score
    permitting), or dial an unconnected candidate (PX first, else a
    uniform random peer once starved for redial_patience rounds) into a
    free slot on each side, grafting the fresh edge.

    `dht_pool`: an (N, K) DHT shortlist that replaces the random fallback
    (the candidate lattice becomes PX -> DHT -> nothing); its examined
    entry is consumed whether or not the dial lands, and the pool is
    returned as a fifth result. `refuse`: (N,) peers that never accept a
    dial (sybils): the dial is attempted, the candidate consumed, nothing
    commits."""
    n_loc, c = conns.shape
    n = peer.global_rows(n_loc)
    dev = conns.device
    i32 = torch.int32
    me = peer.row_ids(n_loc, dev).to(i32)
    iota_c = torch.arange(c, dtype=i32, device=dev)
    t = state.t_ms
    alive_sub = state.alive & state.subscribed
    # the (N,) tables a dial reads at its target
    alive_all = peer.all_rows(alive_sub)
    act = alive_sub if actor is None else (actor & alive_sub)
    deg = state.mesh_mask.sum(dim=-1, dtype=i32)

    starve = state.starve_hb
    if params.redial:
        starve = torch.where(act & (deg < params.d_low), state.starve_hb + 1,
                             0)

    key, k_dial = prng.split(state.key)

    pool = state.px_pool
    cand_ok = ((pool >= 0) & (pool != me[:, None])
               & alive_all[pool.clamp_min(0).long()])
    has_cand = cand_ok.any(dim=-1)
    k0 = torch.argmax(cand_ok.to(torch.uint8), dim=-1)
    cand = _row_take(pool, k0)

    # the ambient known-peer table: one uniform draw over [0, n) \ {me}
    r = peer.randint(k_dial, (n_loc,), 0, n - 1)
    r = torch.where(r >= me, r + 1, r)

    px_want = torch.zeros((n_loc,), dtype=torch.bool, device=dev)
    redial_want = torch.zeros((n_loc,), dtype=torch.bool, device=dev)
    if params.px:
        px_want = act & (deg < params.d) & has_cand
    if params.redial:
        redial_want = act & (starve >= params.redial_patience)
    use_px = px_want | (redial_want & has_cand)
    if dht_pool is None:
        use_rand = redial_want & ~has_cand & alive_all[r.long()]
        want = use_px | use_rand
        tgt = torch.where(use_px, cand, torch.where(use_rand, r, -1))
    else:
        d_ok = ((dht_pool >= 0) & (dht_pool != me[:, None])
                & alive_all[dht_pool.clamp_min(0).long()])
        dk0 = torch.argmax(d_ok.to(torch.uint8), dim=-1)
        dcand = _row_take(dht_pool, dk0)
        use_dht = redial_want & ~has_cand & d_ok.any(dim=-1)
        want = use_px | use_dht
        tgt = torch.where(use_px, cand, torch.where(use_dht, dcand, -1))
    tgt_c = tgt.clamp_min(0).long()

    new = dict(starve_hb=starve, key=key)
    if peer.any_(want):
        hit = (conns == tgt_c[:, None]) & want[:, None]
        connected = hit.any(dim=-1)
        slot_a = torch.argmax(hit.to(torch.uint8), dim=-1)

        # path A: the candidate is already connected -> plain GRAFT
        sc = state.score(params)
        j_a = _row_take(rev, slot_a).long()
        my_ok = ((_row_take(state.backoff_until, slot_a) <= t)
                 & (_row_take(sc, slot_a) >= 0.0)
                 & ~_row_take(state.mesh_mask, slot_a))
        graft_a = (want & connected & my_ok
                   & (peer.all_rows(state.backoff_until)[tgt_c, j_a] <= t)
                   & (peer.all_rows(sc)[tgt_c, j_a] >= 0.0))
        mesh = state.mesh_mask | (graft_a[:, None]
                                  & (iota_c[None, :] == slot_a[:, None]))
        # the counterpart's side: distinct grafting rows own distinct
        # (tgt, j) slots through the involution, so the writes never
        # collide
        mesh = mesh | peer.scatter_or(mesh.shape, tgt_c[graft_a],
                                      j_a[graft_a], dev)

        # path B: unconnected -> dial into a free padding slot
        free = conns < 0
        has_free = free.any(dim=-1)
        free_slot = torch.argmax(free.to(torch.uint8), dim=-1).to(i32)
        dial_try = want & ~connected & has_free
        has_free_all = peer.all_rows(has_free)
        free_slot_all = peer.all_rows(free_slot)
        # a dialer never accepts in the same round
        attempt = (dial_try & has_free_all[tgt_c] & alive_all[tgt_c]
                   & ~peer.all_rows(dial_try)[tgt_c])
        if refuse is not None:
            attempt = attempt & ~peer.all_rows(refuse)[tgt_c]
        # one inbound dial per acceptor: lowest dialer id wins
        winner = peer.scatter_amin(n, torch.where(attempt, tgt_c, 0),
                                   torch.where(attempt, me, n), n)
        committed = attempt & (winner[tgt_c] == me)
        accepted = peer.local(winner) < n
        dialer = torch.where(accepted, peer.local(winner), 0).long()

        my_hot = committed[:, None] & (iota_c[None, :] == free_slot[:, None])
        acc_hot = accepted[:, None] & (iota_c[None, :] == free_slot[:, None])
        j_t = free_slot_all[tgt_c]
        i_d = free_slot_all[dialer]
        conns2 = torch.where(my_hot, tgt_c[:, None].to(conns.dtype), conns)
        conns2 = torch.where(acc_hot, dialer[:, None].to(conns.dtype),
                             conns2)
        rev2 = torch.where(my_hot, j_t[:, None].to(rev.dtype), rev)
        rev2 = torch.where(acc_hot, i_d[:, None].to(rev.dtype), rev2)
        out2 = out_mask | my_hot

        # a fresh edge: scrub per-edge state and graft both sides
        hot = my_hot | acc_hot
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        mesh = mesh | hot
        new.update(
            mesh_mask=mesh,
            backoff_until=torch.where(hot, zero, state.backoff_until),
            fmd=torch.where(hot, zero, state.fmd),
            slow_penalty=torch.where(hot, zero, state.slow_penalty),
        )
        if peer.any_(committed):
            new["warm_offset_ms"] = torch.full_like(state.warm_offset_ms,
                                                    INF)

        one_a = graft_a.to(i32)
        new["grafts"] = state.grafts + (graft_a | committed).to(i32)
        grafts_rx = peer.index_add(
            state.grafts_rx, torch.where(graft_a, tgt_c, 0), one_a)
        new["grafts_rx"] = grafts_rx + accepted.to(i32)
        new["px_grafts"] = state.px_grafts + (
            graft_a | (committed & use_px)).to(i32)
        new["redials"] = state.redials + committed.to(i32)

        # consume the examined pool entry (success or fail)
        pw = pool.shape[1]
        new["px_pool"] = torch.where(
            use_px[:, None]
            & (torch.arange(pw, device=dev)[None, :] == k0[:, None]),
            -1, pool)
        if dht_pool is not None:
            # the same consume-on-examine rule for the DHT shortlist
            dht_pool = torch.where(
                use_dht[:, None]
                & (torch.arange(dht_pool.shape[1], device=dev)[None, :]
                   == dk0[:, None]), -1, dht_pool)
        conns, rev, out_mask = conns2, rev2, out2
    if dht_pool is not None:
        return state.replace(**new), conns, rev, out_mask, dht_pool
    return state.replace(**new), conns, rev, out_mask


def _recovery_loop(state, conns, rev, out_mask, attacker, params, steps,
                   publisher, telemetry, dht_pool=None, actor=None,
                   refuse=None, adv=None, ctrl=None):
    """The recovery windows' shared loop: [heartbeat_step -> repair_round
    (-> adaptive_round when `adv` is given)] with the graph, and the DHT
    pool and controller when given, carried from round to round."""
    if telemetry is not None and not telemetry.enabled:
        telemetry = None
    f32 = torch.float32
    if adv is not None:
        att_sorted, n_att = cohort_order(attacker)
    rounds = []
    attacker_all = peer.all_rows(attacker)
    for hb in range(steps):
        ev0 = peer.isum(state.evictions)
        px0 = peer.isum(state.px_grafts)
        rd0 = peer.isum(state.redials)
        state = heartbeat_step(state, conns, rev, out_mask, params)
        fired = repair_round(state, conns, rev, out_mask, params,
                             actor=actor, dht_pool=dht_pool, refuse=refuse)
        if dht_pool is not None:
            state, conns, rev, out_mask, dht_pool = fired
        else:
            state, conns, rev, out_mask = fired
        if adv is not None:
            # the controller reacts after the repair pass: it re-grafts
            # the slots eviction freed and re-poisons the consumed pool
            (state, ctrl), obs = adaptive_round(
                state, ctrl, conns, rev, attacker, params, adv, hb_idx=hb,
                att_sorted=att_sorted, n_att=n_att)
        else:
            obs = attack_observables(state, conns, rev, attacker, params)
        nbr = peer.read_row(conns, publisher)
        att_n = (nbr >= 0) & attacker_all[nbr.clamp_min(0).long()]
        obs["pub_honest_degree"] = (
            peer.read_row(state.mesh_mask, publisher) & (nbr >= 0) & ~att_n
        ).sum(dtype=torch.int64).to(f32)
        obs["evictions"] = (peer.isum(state.evictions) - ev0).to(f32)
        obs["px_grafts"] = (peer.isum(state.px_grafts) - px0).to(f32)
        obs["redials"] = (peer.isum(state.redials) - rd0).to(f32)
        if dht_pool is not None:
            obs["dht_pool_left"] = peer.isum(dht_pool >= 0).to(f32)
            # a peer whose every candidate refuses keeps counting up
            obs["starve_max"] = peer.max_(state.starve_hb.max()).to(f32)
        if telemetry is not None:
            obs.update(telemetry_observables(
                state, conns, rev, params, telemetry, contract_score="first"))
        rounds.append(obs)
    carry = (state, conns, rev, out_mask)
    if adv is not None:
        carry = (state, ctrl, conns, rev, out_mask)
    if dht_pool is not None:
        carry = carry + (dht_pool,)
    return carry, stack_obs(rounds)


def run_recovery_heartbeats(state: SimState, conns, rev, out_mask,
                            attacker, params: SimParams, steps: int,
                            publisher: int = 0, telemetry=None):
    """The post-attack recovery window: `steps` rounds of [heartbeat_step
    (evict / px armed) -> repair_round] with the connection graph carried
    from round to round (nothing hoisted). Returns ((state, conns, rev,
    out_mask), obs) with obs leaves shaped (steps,): the attack
    observables, the publisher's honest mesh degree and the round's
    evictions, PX grafts and re-dials."""
    return _recovery_loop(state, conns, rev, out_mask, attacker, params,
                          steps, publisher, telemetry, actor=~attacker)


def run_dht_recovery_heartbeats(state: SimState, conns, rev, out_mask,
                                attacker, params: SimParams, steps: int,
                                dht_pool=None, publisher: int = 0,
                                telemetry=None):
    """run_recovery_heartbeats with the DHT shortlist as the re-dial
    candidate source (sybils refuse every dial). Returns ((state, conns,
    rev, out_mask, dht_pool), obs) with the `dht_pool_left` and
    `starve_max` channels. `dht_pool=None` is run_recovery_heartbeats."""
    if dht_pool is None:
        return run_recovery_heartbeats(state, conns, rev, out_mask,
                                       attacker, params, steps,
                                       publisher=publisher,
                                       telemetry=telemetry)
    return _recovery_loop(state, conns, rev, out_mask, attacker, params,
                          steps, publisher, telemetry, dht_pool=dht_pool,
                          actor=~attacker, refuse=attacker)


def run_adaptive_recovery_heartbeats(
        state: SimState, conns, rev, out_mask, attacker, params: SimParams,
        steps: int, adv: AdversaryParams | None = None,
        ctrl: AdaptiveCtrl | None = None, dht_pool=None,
        publisher: int = 0, telemetry=None):
    """The recovery window contested by the adaptive attacker: each round
    [heartbeat_step -> repair_round -> adaptive_round]. With slot_race the
    cohort runs the dial controller too and its sybils accept dials
    (actor = everyone, nobody refuses). Disabled (`adv` None or its
    policy off) this is run_dht_recovery_heartbeats and `ctrl` must be
    None; armed the result is ((state, ctrl, conns, rev, out_mask[,
    dht_pool]), obs) with the adv_* channels."""
    if adv is None or not adv.adaptive.enabled:
        if ctrl is not None:
            raise ValueError("ctrl given but the adaptive policy is "
                             "disabled — the delegating path carries none")
        return run_dht_recovery_heartbeats(
            state, conns, rev, out_mask, attacker, params, steps,
            dht_pool=dht_pool, publisher=publisher, telemetry=telemetry)
    if ctrl is None:
        ctrl = init_adaptive_ctrl(params.n, conns.device)
    race = adv.adaptive.slot_race
    actor = None if race else ~attacker
    refuse = None if race or dht_pool is None else attacker
    return _recovery_loop(state, conns, rev, out_mask, attacker, params,
                          steps, publisher, telemetry, dht_pool=dht_pool,
                          actor=actor, refuse=refuse, adv=adv, ctrl=ctrl)
