"""Executable GossipSub v1.1 reference model — the conformance oracle's spec side.

A pure-host (numpy) transcription of the per-heartbeat transition relation
the engine implements: mesh GRAFT/PRUNE with backoff, score-floor
eviction, PX capture on PRUNE, opportunistic grafting, score decay with the
zero-cutoff, fanout TTL expiry, the eight attack-round behaviors of
ops/adversary.py, the adaptive controller state machine, and the fault
transforms of ops/faults.py. The transition functions follow the ACL2s
formalization of GossipSub (arXiv:2311.08859): state is explicit, every
transition is a total function of (state, topology, params), and the honest
defense rules (backoff violation, graylist refusal, score-gated graft
acceptance) are written as guards, not side effects.

The one deliberate deviation from the ACL2s spec: where the formal model
leaves peer SELECTION nondeterministic (graft targets, prune survivors), this
model fixes the selection oracle to the engine's PRNG stream — it performs
the same threefry `split`/`uniform` draws (prng.py, bit-exact to the
reference's `jax.random`) on a CPU copy of the carried key and resolves ties
with the same stable-sort ranks. That turns the spec's transition RELATION
into a transition FUNCTION pointwise-comparable with the engine's step, so
the differential harness (analysis/conformance.py) can diff full state
trajectories field-by-field instead of checking membership in a set of
allowed successors.

Nothing here runs on a device; prng.py is used on the CPU only as the
selection oracle. Numerics discipline: every float array stays float32 and
every scalar constant is wrapped in np.float32 so host arithmetic performs
the same IEEE-754 single ops, in the same order, as the engine's step — on
matching op order the two sides agree bitwise, which is what lets the
harness demand exact equality on bool/int fields and ulp-tight tolerance on
floats.
"""

from __future__ import annotations

import numpy as np

from .. import prng
from .state import PX_POOL_WIDTH, SimParams, SimState, repair_inert

BIG = np.float32(1e30)
INF = np.float32(3.4e38)

# every SimState leaf the oracle tracks and the differential compares;
# `key` rides alongside (as a CPU key tensor) but is compared via the
# trajectory it induces, not bit-by-bit
SPEC_FIELDS = (
    "mesh_mask", "fanout_mask", "fanout_expire", "backoff_until", "fmd",
    "slow_penalty", "alive", "subscribed", "hb_phase", "uplink_free_ms",
    "rx_free_ms", "warm_offset_ms", "t_ms", "grafts", "grafts_rx", "prunes",
    "prunes_rx", "bytes_tx", "bytes_rx", "dup_rx", "ihave_tx", "iwant_tx",
    "ihave_rx", "iwant_rx", "idontwant_tx", "idontwant_rx", "px_pool",
    "starve_hb", "evictions", "px_grafts", "redials",
)


def host_state(state: SimState) -> dict:
    """SimState (on any device) -> the oracle's state dict: one host numpy
    array per leaf, plus a CPU copy of the carried PRNG key (for
    splitting)."""
    st = {f: getattr(state, f).detach().cpu().numpy() for f in SPEC_FIELDS}
    st["key"] = state.key.detach().cpu().clone()
    return st


def _uniform(key, shape) -> np.ndarray:
    """The selection oracle's float32 draw on the host."""
    return prng.uniform(key, shape).numpy()


def _ranks(priority: np.ndarray) -> np.ndarray:
    """Per-row rank under ascending priority — the double argsort of
    ops/heartbeat._ranks. kind="stable" matches the engine's stable sort,
    so equal keys rank in slot order on both sides."""
    return np.argsort(np.argsort(priority, axis=-1, kind="stable"),
                      axis=-1, kind="stable")


def _apply_decay(arr: np.ndarray, scale: float, params: SimParams):
    eff = (arr * np.float32(scale)).astype(np.float32)
    return np.where(eff < np.float32(params.decay_to_zero),
                    np.float32(0.0), eff)


def _pull(edge_mask: np.ndarray, conns: np.ndarray, rev: np.ndarray):
    """out[q, j] = edge_mask[conns[q,j], rev[q,j]] — the reciprocal-view
    gather through the edge involution (ops/pull.reciprocal_pull_bool)."""
    out = edge_mask[np.clip(conns, 0, None), np.clip(rev, 0, None)]
    return out & (conns >= 0) & (rev >= 0)


def _nbr_pull(per_peer: np.ndarray, conns: np.ndarray, rev: np.ndarray):
    """out[q, j] = per_peer[conns[q,j]] (ops/pull.neighbor_pull_bool)."""
    return per_peer[np.clip(conns, 0, None)] & (conns >= 0) & (rev >= 0)


def spec_score(st: dict, params: SimParams) -> np.ndarray:
    """v1.1 score subset (ops/state.SimState.score): P2 firstMessageDeliveries
    capped, plus the negative-weighted slow-peer penalty counter."""
    fmd = np.minimum(st["fmd"], np.float32(params.fmd_cap))
    return (np.float32(params.fmd_weight) * fmd
            + np.float32(params.slow_weight) * st["slow_penalty"])


def _score_of(fmd, slow_penalty, params: SimParams) -> np.ndarray:
    fmd = np.minimum(fmd, np.float32(params.fmd_cap))
    return (np.float32(params.fmd_weight) * fmd
            + np.float32(params.slow_weight) * slow_penalty)


def opportunistic_graft_candidates(mesh, valid, backoff, t, scores,
                                   params: SimParams,
                                   highest_slot_ties: bool = False):
    """v1.1 opportunistic-grafting selection with the tie policy made
    explicit — the spec-side transcription of the engine's og block
    (ops/heartbeat.py) and of the ACL2s formalization's opportunistic-
    grafting rule (arXiv:2311.08859).

    Rule: when a row's UPPER-MEDIAN mesh score (sorted[deg // 2], the
    libp2p implementations' median) sinks below
    params.opportunistic_graft_threshold and the mesh is non-empty, graft
    up to 2 eligible peers (valid, non-mesh, backoff expired) scoring
    STRICTLY above that median, preferring the highest-scored.

    Tie policy: the ACL2s model leaves the choice among equally-scored
    candidates NONDETERMINISTIC (any maximal subset of size <= 2 is an
    allowed successor). This executable spec — per the module-wide
    selection-oracle convention — resolves it deterministically to the
    LOWEST NEIGHBOR SLOT: ranks come from a stable double argsort, so
    among equal -score keys the earlier slot wins, exactly matching the
    engine's torch.argsort(stable=True). Two further
    median-rule consequences the differential pins: candidates scoring
    EXACTLY the median are excluded (strict >), and the median index for
    even degrees is the upper middle, not the average.

    Returns (og, median, low): the (N, C) selected graft edge set and the
    per-row median/low-quality diagnostics the caller's guards reuse."""
    n, c = mesh.shape
    deg = mesh.sum(axis=-1)
    msort = np.sort(np.where(mesh, scores, BIG), axis=-1, kind="stable")
    k_med = np.clip(deg // 2, 0, c - 1)
    median = np.take_along_axis(msort, k_med[:, None], axis=-1)[:, 0]
    low = ((median < np.float32(params.opportunistic_graft_threshold))
           & (deg > 0))
    og_elig = (valid & ~mesh & (backoff <= t)
               & (scores > median[:, None]) & low[:, None])
    og_prio = np.where(og_elig, -scores, BIG)
    if highest_slot_ties:
        # the OTHER admissible resolution of the ACL2s nondeterminism
        # (highest slot first among equal scores) — the differential's
        # tie-policy witness: flipping this knob must produce divergence
        # whenever a tie was decisive, proving the walk pins the policy
        og = (_ranks(og_prio[:, ::-1])[:, ::-1] < 2) & og_elig
    else:
        og = (_ranks(og_prio) < 2) & og_elig
    return og, median, low


def _validity(st, conns, rev, alive, edge_ok):
    nbr_ok = _nbr_pull(alive & st["subscribed"], conns, rev)
    valid = ((conns >= 0) & alive[:, None] & nbr_ok
             & st["subscribed"][:, None])
    if edge_ok is not None:
        valid = valid & edge_ok
    return valid


def spec_heartbeat(st: dict, conns, rev, out_mask, params: SimParams,
                   edge_ok=None, og_tie_highest: bool = False) -> dict:
    """One heartbeat of the reference transition relation — the spec twin of
    ops/heartbeat.heartbeat_step on its per-step (non-deferred-decay) path.
    Branch guards mirror the engine's branch predicates exactly: a guard
    that does not fire leaves its fields untouched AND consumes no extra
    randomness (both k_graft and k_keep are split unconditionally)."""
    st = dict(st)
    n, c = conns.shape
    key, k_graft, k_keep, k_churn_d, k_churn_u = prng.split(st["key"], 5)
    t = np.float32(st["t_ms"])

    # -- churn --------------------------------------------------------------
    alive = st["alive"]
    if params.churn_down_per_hb > 0.0 or params.churn_up_per_hb > 0.0:
        dies = (_uniform(k_churn_d, (n,))
                < np.float32(params.churn_down_per_hb))
        revives = (_uniform(k_churn_u, (n,))
                   < np.float32(params.churn_up_per_hb))
        alive = np.where(alive, ~dies, revives)
        warm = np.full_like(st["warm_offset_ms"], INF)
    else:
        warm = st["warm_offset_ms"]

    valid = _validity(st, conns, rev, alive, edge_ok)
    mesh = st["mesh_mask"] & valid
    deg = mesh.sum(axis=-1)

    # score() is read at several guard points within one step; none of the
    # in-step writes (mesh, backoff) feed it, so one evaluation serves all
    scores = spec_score(st, params)
    zeros_n = np.zeros((n,), np.int32)

    # -- GRAFT --------------------------------------------------------------
    need = np.where(deg < params.d_low, params.d - deg, 0)
    graft_tx_inc = graft_rx_inc = zeros_n
    if (need > 0).any():
        eligible = (valid & ~mesh & (st["backoff_until"] <= t)
                    & (scores >= np.float32(0.0)))
        u = _uniform(k_graft, (n, c))
        g_prio = np.where(eligible, u, BIG)
        grafted = (_ranks(g_prio) < need[:, None]) & eligible
        graft_rx = _pull(grafted, conns, rev)
        mesh = (mesh | grafted | graft_rx) & valid
        deg2 = mesh.sum(axis=-1)
        graft_tx_inc = grafted.sum(axis=-1, dtype=np.int32)
        graft_rx_inc = graft_rx.sum(axis=-1, dtype=np.int32)
    else:
        deg2 = deg

    # -- PRUNE --------------------------------------------------------------
    over = deg2 > params.d_high
    backoff = st["backoff_until"]
    prune_tx_inc = prune_rx_inc = zeros_n
    pruned_rx = np.zeros((n, c), dtype=bool)
    if over.any():
        rand_keep = _uniform(k_keep, (n, c))
        s_prio = np.where(mesh, -scores + np.float32(1e-3) * rand_keep, BIG)
        top_score = (_ranks(s_prio) < params.d_score) & mesh
        out_in_top = (top_score & out_mask).sum(axis=-1)
        need_out = np.clip(params.d_out - out_in_top, 0, params.d)
        o_prio = np.where(mesh & out_mask & ~top_score, rand_keep, BIG)
        keep_out = ((_ranks(o_prio) < need_out[:, None])
                    & mesh & out_mask & ~top_score)
        base = top_score | keep_out
        need_fill = np.clip(params.d - base.sum(axis=-1), 0, params.d)
        f_prio = np.where(mesh & ~base, rand_keep, BIG)
        keep = base | ((_ranks(f_prio) < need_fill[:, None]) & mesh & ~base)
        pruned = mesh & ~keep & over[:, None]
        mesh = mesh & ~pruned
        pruned_by_peer = _pull(pruned, conns, rev)
        backoff = np.where(pruned | pruned_by_peer,
                           t + np.float32(params.prune_backoff_ms), backoff)
        mesh = mesh & ~pruned_by_peer
        prune_tx_inc = pruned.sum(axis=-1, dtype=np.int32)
        prune_rx_inc = pruned_by_peer.sum(axis=-1, dtype=np.int32)
        pruned_rx = pruned_by_peer

    # -- score eviction (opt-in) --------------------------------------------
    ev_tx_inc = ev_rx_inc = zeros_n
    ev_rx_edges = np.zeros((n, c), dtype=bool)
    if params.evict:
        ev_cand = mesh & (scores < np.float32(params.eviction_threshold))
        if ev_cand.any():
            ev_rx = _pull(ev_cand, conns, rev)
            backoff = np.where(ev_cand | ev_rx,
                               t + np.float32(params.prune_backoff_ms),
                               backoff)
            mesh = mesh & ~ev_cand & ~ev_rx
            ev_tx_inc = ev_cand.sum(axis=-1, dtype=np.int32)
            ev_rx_inc = ev_rx.sum(axis=-1, dtype=np.int32)
            ev_rx_edges = ev_rx

    # -- PX on PRUNE (opt-in) -----------------------------------------------
    px_pool = st["px_pool"]
    if params.px:
        got_pruned = pruned_rx | ev_rx_edges
        if got_pruned.any():
            elig = valid & (scores >= np.float32(0.0))
            prio = (np.where(elig, -scores, BIG)
                    + np.float32(1e-4) * np.arange(c, dtype=np.float32))
            w = min(PX_POOL_WIDTH, c)
            order = np.argsort(prio, axis=-1, kind="stable")[:, :w]
            take_ok = (np.take_along_axis(elig, order, axis=-1)
                       & (np.arange(w) < params.px_count))
            cand = np.where(take_ok,
                            np.take_along_axis(conns, order, axis=-1),
                            np.int32(-1)).astype(np.int32)
            if w < PX_POOL_WIDTH:
                cand = np.pad(cand, ((0, 0), (0, PX_POOL_WIDTH - w)),
                              constant_values=-1)
            got = got_pruned.any(axis=-1)
            i0 = got_pruned.argmax(axis=-1)
            pruner = np.take_along_axis(conns, i0[:, None], axis=1)[:, 0]
            advert = cand[np.clip(pruner, 0, None)]
            advert = np.where(
                advert == np.arange(n, dtype=np.int32)[:, None],
                np.int32(-1), advert)
            px_pool = np.where(got[:, None], advert, px_pool)

    # -- opportunistic grafting (opt-in) ------------------------------------
    og_tx_inc = og_rx_inc = zeros_n
    if params.opportunistic_graft_threshold > -9999.0:
        og, _, _ = opportunistic_graft_candidates(
            mesh, valid, backoff, t, scores, params,
            highest_slot_ties=og_tie_highest)
        if og.any():
            rx = _pull(og, conns, rev)
            mesh = (mesh | og | rx) & valid
            og_tx_inc = og.sum(axis=-1, dtype=np.int32)
            og_rx_inc = rx.sum(axis=-1, dtype=np.int32)

    # -- score decay --------------------------------------------------------
    fmd, slow = st["fmd"], st["slow_penalty"]
    if ((fmd > 0) | (slow > 0)).any():
        fmd = _apply_decay(fmd, params.fmd_decay, params)
        slow = _apply_decay(slow, params.slow_decay, params)

    # -- fanout TTL expiry --------------------------------------------------
    fanout = st["fanout_mask"]
    if (st["fanout_expire"] > 0.0).any():
        fanout = fanout & (t < st["fanout_expire"])[:, None]

    prunes_new = st["prunes"] + prune_tx_inc
    prunes_rx_new = st["prunes_rx"] + prune_rx_inc
    if params.evict:
        prunes_new = prunes_new + ev_tx_inc
        prunes_rx_new = prunes_rx_new + ev_rx_inc
        st["evictions"] = st["evictions"] + ev_tx_inc
    if params.px:
        st["px_pool"] = px_pool
    st.update(
        mesh_mask=mesh, fanout_mask=fanout, backoff_until=backoff,
        fmd=fmd, slow_penalty=slow, alive=alive, warm_offset_ms=warm,
        t_ms=np.float32(t + np.float32(params.heartbeat_ms)), key=key,
        grafts=st["grafts"] + graft_tx_inc + og_tx_inc,
        grafts_rx=st["grafts_rx"] + graft_rx_inc + og_rx_inc,
        prunes=prunes_new, prunes_rx=prunes_rx_new,
    )
    return st


def spec_adversary_round(st: dict, conns, rev, attacker, params: SimParams,
                         adv, hb_idx: int, edge_ok=None) -> dict:
    """One attacker round + honest defense accounting, applied after
    spec_heartbeat — the spec twin of ops/adversary.adversary_round. The
    scenario dispatch mirrors the engine's derived-behavior properties
    (graft_flood covers the sybil/eclipse/cold-boot/rotation family)."""
    st = dict(st)
    n, c = conns.shape
    t = np.float32(st["t_ms"])
    valid = _validity(st, conns, rev, st["alive"], edge_ok)
    att_row = attacker[:, None] & valid

    mesh = st["mesh_mask"]
    slow_penalty = st["slow_penalty"]
    uplink_free_ms = st["uplink_free_ms"]
    backoff_until = st["backoff_until"]
    fmd = st["fmd"]

    if adv.identity_rotation:
        if (hb_idx % adv.rotation_period_hb) == adv.rotation_period_hb - 1:
            inc = ((attacker[:, None] | _nbr_pull(attacker, conns, rev))
                   & (conns >= 0))
            mesh = mesh & ~inc
            slow_penalty = np.where(inc, np.float32(0.0), slow_penalty)
            fmd = np.where(inc, np.float32(0.0), fmd)
            backoff_until = np.where(inc, np.float32(0.0), backoff_until)

    if adv.graft_flood:
        flood = att_row
        rx = _pull(flood, conns, rev)
        violation = rx & ((backoff_until > t) | mesh)
        # rotation reads the post-scrub counters; everything else the
        # pre-round ones — for non-rotation scenarios the locals ARE the
        # pre-round arrays, so one formula serves both branches
        sc = _score_of(fmd, slow_penalty, params)
        accept = rx & ~violation & (sc >= np.float32(0.0))
        mesh = (mesh | flood | accept) & valid
        slow_penalty = slow_penalty + np.where(
            violation, np.float32(adv.violation_penalty), np.float32(0.0))
        st["grafts"] = st["grafts"] + flood.sum(axis=-1, dtype=np.int32)
        st["grafts_rx"] = st["grafts_rx"] + rx.sum(axis=-1, dtype=np.int32)

    if adv.ihave_spam:
        ann = att_row
        rx_ann = _pull(ann, conns, rev)
        k = np.int32(adv.spam_ihaves_per_hb)
        st["ihave_tx"] = st["ihave_tx"] + ann.sum(axis=-1, dtype=np.int32) * k
        st["ihave_rx"] = (st["ihave_rx"]
                          + rx_ann.sum(axis=-1, dtype=np.int32) * k)
        st["iwant_tx"] = (st["iwant_tx"]
                          + rx_ann.sum(axis=-1, dtype=np.int32) * k)
        st["iwant_rx"] = st["iwant_rx"] + ann.sum(axis=-1, dtype=np.int32) * k
        slow_penalty = slow_penalty + np.where(
            rx_ann, np.float32(adv.violation_penalty), np.float32(0.0))

    if adv.iwant_spam:
        req = att_row
        rx_req = _pull(req, conns, rev)
        k = np.int32(adv.spam_iwants_per_hb)
        sc0 = spec_score(st, params)
        serve = rx_req & (sc0 >= np.float32(params.graylist_threshold))
        served = serve.sum(axis=-1, dtype=np.int32) * k
        st["iwant_tx"] = st["iwant_tx"] + req.sum(axis=-1, dtype=np.int32) * k
        st["iwant_rx"] = (st["iwant_rx"]
                          + rx_req.sum(axis=-1, dtype=np.int32) * k)
        uplink_free_ms = np.where(
            served > 0,
            np.maximum(uplink_free_ms, t)
            + served.astype(np.float32) * np.float32(adv.iwant_answer_ms),
            uplink_free_ms)
        slow_penalty = slow_penalty + np.where(
            rx_req, np.float32(adv.violation_penalty), np.float32(0.0))

    if adv.slow_mimicry and params.slow_weight < 0.0:
        c_req = params.graylist_threshold / params.slow_weight
        att_view = _nbr_pull(attacker, conns, rev)
        slow_penalty = np.where(
            valid & att_view,
            np.float32(adv.mimic_margin * c_req), slow_penalty)

    st.update(mesh_mask=mesh, slow_penalty=slow_penalty,
              uplink_free_ms=uplink_free_ms)
    if adv.identity_rotation:
        st.update(fmd=fmd, backoff_until=backoff_until)
    return st


def spec_adaptive_round(st: dict, ctrl: dict, conns, rev, attacker,
                        params: SimParams, adv, hb_idx: int,
                        edge_ok=None) -> tuple[dict, dict]:
    """The adaptive controller round (ops/adversary.adaptive_round):
    PREDICT -> ACT/THROTTLE -> OBSERVE -> POISON over the ctrl dict
    {viol_est, regrafts, px_injected, throttled_hb}."""
    pol = adv.adaptive
    st, ctrl = dict(st), dict(ctrl)
    n, c = conns.shape
    t = np.float32(st["t_ms"])
    valid = _validity(st, conns, rev, st["alive"], edge_ok)
    att_row = attacker[:, None] & valid
    me = np.arange(n, dtype=np.int32)

    if pol.duty_cycle and params.slow_weight < 0.0:
        c_req = np.float32(params.graylist_threshold / params.slow_weight)
        predicted = (ctrl["viol_est"] * np.float32(params.slow_decay)
                     + np.float32(adv.violation_penalty))
        act = attacker & (predicted < np.float32(pol.throttle_margin) * c_req)
    else:
        act = attacker

    legal = att_row & (st["backoff_until"] <= t) & ~st["mesh_mask"]
    graft = att_row & act[:, None]
    if pol.regraft:
        graft = graft | legal
    rx = _pull(graft, conns, rev)
    violation = rx & ((st["backoff_until"] > t) | st["mesh_mask"])
    sc = spec_score(st, params)
    accept = rx & ~violation & (sc >= np.float32(0.0))
    mesh = (st["mesh_mask"] | graft | accept) & valid
    slow_penalty = st["slow_penalty"] + np.where(
        violation, np.float32(adv.violation_penalty), np.float32(0.0))
    st["grafts"] = st["grafts"] + graft.sum(axis=-1, dtype=np.int32)
    st["grafts_rx"] = st["grafts_rx"] + rx.sum(axis=-1, dtype=np.int32)

    self_viol = (graft & ((st["backoff_until"] > t)
                          | st["mesh_mask"])).any(axis=-1)
    ctrl["viol_est"] = (ctrl["viol_est"] * np.float32(params.slow_decay)
                        + np.where(attacker & self_viol,
                                   np.float32(adv.violation_penalty),
                                   np.float32(0.0)))
    if pol.regraft:
        ctrl["regrafts"] = ctrl["regrafts"] + np.where(
            attacker, legal.sum(axis=-1, dtype=np.int32), np.int32(0))
    ctrl["throttled_hb"] = (ctrl["throttled_hb"]
                            + (attacker & ~act).astype(np.int32))

    if pol.px_poison and not repair_inert(params):
        att_sorted = np.sort(np.where(attacker, me, np.int32(n)))
        n_att = np.int32(attacker.sum())
        att_nbr = _nbr_pull(attacker, conns, rev)
        victim = (~attacker & st["alive"] & st["subscribed"]
                  & (att_nbr & valid).any(axis=-1))
        pool = st["px_pool"].copy()
        base = me + np.int32(hb_idx) * np.int32(pol.px_poison_per_hb)
        denom = max(int(n_att), 1)
        for k in range(pol.px_poison_per_hb):
            cand = att_sorted[(base + np.int32(k)) % denom]
            empty = pool < 0
            slot = empty.argmax(axis=-1)
            do = victim & (n_att > 0) & (cand < n) & empty.any(axis=-1)
            pool[me, slot] = np.where(do, cand, pool[me, slot])
            ctrl["px_injected"] = ctrl["px_injected"] + do.astype(np.int32)
        st["px_pool"] = pool

    st.update(mesh_mask=mesh, slow_penalty=slow_penalty)
    return st, ctrl


def spec_censorship_penalty(st: dict, conns, rev, attacker, received,
                            params: SimParams, adv) -> dict:
    """Post-publish P3 analog (ops/adversary.censorship_penalty_update)."""
    if float(adv.censor_penalty) == 0.0:
        return st
    st = dict(st)
    att_nbr = _nbr_pull(attacker, conns, rev)
    deficit = (st["mesh_mask"] & att_nbr
               & (received & ~attacker)[:, None])
    st["slow_penalty"] = st["slow_penalty"] + np.where(
        deficit, np.float32(adv.censor_penalty), np.float32(0.0))
    return st


def spec_eclipse_setup(st: dict, conns, attacker, publisher: int) -> dict:
    """ops/adversary.eclipse_setup: the publisher's mesh row collapses onto
    its attacker edges the moment the eclipse closes."""
    st = dict(st)
    row = np.where(conns[publisher] >= 0,
                   attacker[np.clip(conns[publisher], 0, None)], False)
    mesh = st["mesh_mask"].copy()
    mesh[publisher] = row
    st["mesh_mask"] = mesh
    return st


# -- fault transforms (ops/faults.py scan-body conds, as host functions) ----

def spec_go_dark(st: dict, crash) -> dict:
    st = dict(st)
    st["alive"] = st["alive"] & ~crash
    st["warm_offset_ms"] = np.full_like(st["warm_offset_ms"], INF)
    return st


def spec_restart(st: dict, crash, conns, rev, params: SimParams) -> dict:
    st = dict(st)
    crash_nbr = _nbr_pull(crash, conns, rev)
    inc = (crash[:, None] | crash_nbr) & (conns >= 0)
    st["alive"] = st["alive"] | crash
    st["mesh_mask"] = st["mesh_mask"] & ~inc
    st["fmd"] = np.where(inc, np.float32(0.0), st["fmd"])
    st["slow_penalty"] = np.where(inc, np.float32(0.0), st["slow_penalty"])
    st["backoff_until"] = np.where(inc, np.float32(0.0), st["backoff_until"])
    st["warm_offset_ms"] = np.full_like(st["warm_offset_ms"], INF)
    if not repair_inert(params):
        st["px_pool"] = np.where(crash[:, None], np.int32(-1), st["px_pool"])
        st["starve_hb"] = np.where(crash, np.int32(0), st["starve_hb"])
    return st


def spec_partition_edge_mask(side, conns) -> np.ndarray:
    return (conns >= 0) & (side[:, None] ^ side[np.clip(conns, 0, None)])


def spec_freeze(st: dict, cross) -> tuple[dict, np.ndarray]:
    st = dict(st)
    frozen = st["mesh_mask"] & cross
    st["mesh_mask"] = st["mesh_mask"] & ~cross
    return st, frozen


def spec_thaw(st: dict, frozen, conns) -> tuple[dict, np.ndarray]:
    st = dict(st)
    ok = st["alive"] & st["subscribed"]
    keep = frozen & ok[:, None] & ok[np.clip(conns, 0, None)]
    st["mesh_mask"] = st["mesh_mask"] | keep
    return st, np.zeros_like(frozen)


def spec_spike(st: dict, spike, spike_ms: float) -> dict:
    st = dict(st)
    t = np.float32(st["t_ms"])
    st["uplink_free_ms"] = np.where(
        spike,
        np.maximum(st["uplink_free_ms"], t) + np.float32(spike_ms),
        st["uplink_free_ms"])
    return st
