"""Episub: a Topiary-style eager-push tree backend (arXiv:2312.06800), the
reference's ops/episub.py.

The arena's second protocol (ops/protocol.py). Where GossipSub keeps a
redundant D-regular mesh, episub keeps a spanning tree rooted at the
publisher: each peer adopts its minimum-hop valid neighbor as parent (one
Bellman-Ford relaxation through a neighbor pull per heartbeat),
eager-pushes along parent and child edges only, and advertises lazily
(IHAVE) along up to d_lazy non-tree edges.

  * SimState is shared unchanged: the tree IS mesh_mask, the edge set
    disseminate eager-pushes along, so publish, telemetry, faults and the
    adversary compose without a new path.
  * The per-protocol carry (hop estimates, parent slots) is EpisubCtrl,
    threaded beside the state like the adaptive attacker's AdaptiveCtrl.
  * An edge whose score sank below params.graylist_threshold is neither a
    parent candidate nor an accepted child; the test is made only when a
    score weight is negative (with none, the floor cannot bind).
  * A lost parent drops out of validity and the next relaxation re-parents.
    Candidates are clamped at N hops, so a component cut from the root
    drains to unreached within N rounds instead of counting up forever.

Ties in the parent choice go to the lowest neighbor slot (jnp.argmin's
first occurrence, taken here as the least slot among the minima). The
step draws PRNG only for churn, but splits the key three ways every round,
as the reference does.

`episub_window` is the one window loop. `run_episub_heartbeats`,
`run_episub_attacked_heartbeats`, `run_episub_adaptive_heartbeats` and
`run_episub_faulted_heartbeats` are calls into it: the benign window, the
attack window (adversary_round after each step), the adaptive one
(adaptive_round and its controller carry) and the fault-armed one. The
fault schedule differs from GossipSub's window (ops/faults.py) on
purpose: a crash goes through `edge_ok` only (no alive surgery, no cold
restart scrub: the tree re-derives every round) and a partition banks no
mesh edges. The reference's round-index conds are Python ints of the
loop. Decay is per round (the cond-gated _apply_decay), so no episub
window reaches the score_update kernel; the neighbor pulls run in
ops/pull.py. The repair leaves stay on the state: no episub step reads
or writes them, and the adaptive PX poisoner runs only where the
reference keeps them (repair armed).

On a rank of the peer mesh (parallel/peer.py) the step and the carry are
the rank's rows: the hop clamp is the whole N, the churn draws are those
rows of the whole draw, the decay's predicate is taken over every rank
and the tree observables are counted and summed over every peer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import prng
from ..device import resolve_device
from ..parallel import peer
from .adversary import (AdversaryParams, adaptive_round, adversary_round,
                        cohort_order)
from .faults import FaultParams, fault_observables, partition_edge_mask
from .heartbeat import _apply_decay
from .pull import neighbor_pull_bool, neighbor_pull_min, reciprocal_pull_bool
from .state import SimParams, SimState, init_adaptive_ctrl, repair_inert
from .telemetry import (contracted_score, stack_obs,
                        telemetry_observables)

INF = 3.4e38


@dataclass(frozen=True)
class EpisubParams:
    """Static episub configuration. `root`: the tree root's peer id (the
    arena pins it to the trial's publisher). `lazy_degree`: the per-round
    IHAVE budget along non-tree edges; None defers to params.d_lazy."""

    root: int = 0
    lazy_degree: int | None = None

    def validate(self, n: int) -> None:
        if not (0 <= self.root < n):
            raise ValueError(f"root must be in [0, {n}), got {self.root}")
        if self.lazy_degree is not None and self.lazy_degree < 0:
            raise ValueError("lazy_degree must be >= 0")


@dataclass
class EpisubCtrl:
    """Per-peer tree state, (N,): `hops` the hop estimate to the root (INF
    unreached), `parent` the neighbor SLOT of the parent edge (-1 none:
    the root or a detached peer), `reparents` the parent changes so far."""

    hops: torch.Tensor       # (N,) f32
    parent: torch.Tensor     # (N,) int32
    reparents: torch.Tensor  # (N,) int32


def init_episub_ctrl(n: int, device=None) -> EpisubCtrl:
    """A fresh, fully detached tree carry for one trial window of n peers
    (on a rank of the peer mesh, its rows of it)."""
    dev = resolve_device(device)
    n = peer.local_count(n)
    return EpisubCtrl(
        hops=torch.full((n,), INF, dtype=torch.float32, device=dev),
        parent=torch.full((n,), -1, dtype=torch.int32, device=dev),
        reparents=torch.zeros((n,), dtype=torch.int32, device=dev),
    )


def episub_observables(ctrl: EpisubCtrl, alive: torch.Tensor,
                       subscribed: torch.Tensor) -> dict:
    """tree_reach_frac: the share of live subscribed peers with a finite
    hop estimate; tree_depth_mean: the mean hop count over those."""
    f32 = torch.float32
    n = peer.global_rows(ctrl.hops.shape[0])
    live = alive & subscribed
    reached = live & (ctrl.hops <= float(n))
    n_r = peer.isum(reached)
    zero = torch.zeros((), dtype=f32, device=ctrl.hops.device)
    return {
        "tree_reach_frac": (n_r.to(f32)
                            / peer.isum(live).clamp_min(1).to(f32)),
        "tree_depth_mean": (peer.sum_f32(torch.where(reached, ctrl.hops,
                                                     zero))
                            / n_r.clamp_min(1).to(f32)),
    }


def episub_heartbeat_step(state: SimState, ctrl: EpisubCtrl, conns, rev,
                          out_mask, params: SimParams, ep: EpisubParams,
                          nbr_ok=None, edge_ok=None):
    """One episub heartbeat: hop relaxation -> parent adoption -> tree edge
    set -> lazy IHAVE budget -> score decay. `nbr_ok` is the hoisted
    liveness pull (churn off), `edge_ok` the fault hook. Returns (state,
    ctrl); mesh_mask on return is the tree (the parent edge plus the
    accepted child edges)."""
    n_loc, c = conns.shape
    n = peer.global_rows(n_loc)
    dev = conns.device
    i32 = torch.int32
    key, k_churn_d, k_churn_u = prng.split(state.key, 3)
    t = state.t_ms

    alive = state.alive
    if params.churn_down_per_hb > 0.0 or params.churn_up_per_hb > 0.0:
        dies = peer.uniform(k_churn_d, (n_loc,)) < params.churn_down_per_hb
        revives = peer.uniform(k_churn_u, (n_loc,)) < params.churn_up_per_hb
        alive = torch.where(alive, ~dies, revives)
        nbr_ok = None   # alive just changed
        warm = torch.full_like(state.warm_offset_ms, INF)
    else:
        warm = state.warm_offset_ms

    if nbr_ok is None:
        nbr_ok = neighbor_pull_bool(alive & state.subscribed, conns, rev)
    valid = ((conns >= 0) & alive[:, None] & nbr_ok
             & state.subscribed[:, None])
    if edge_ok is not None:
        valid = valid & edge_ok

    gray = params.slow_weight < 0.0 or params.fmd_weight < 0.0
    # the reference's step contracts the score's first product (one FMA)
    ok_edge = (valid & (contracted_score(state, params, "first")
                        >= params.graylist_threshold) if gray else valid)

    # relax by one hop; estimates at or past N hops are dropped, so a
    # detached subtree drains instead of counting up
    is_root = peer.row_ids(n_loc, dev) == ep.root
    nbr_hops = neighbor_pull_min(ctrl.hops, conns, rev)
    cand = torch.where(ok_edge & (nbr_hops < float(n)), nbr_hops + 1.0, INF)
    best = cand.amin(dim=-1)
    slots = torch.arange(c, dtype=i32, device=dev)
    # the lowest slot among the minima (argmin's first occurrence)
    best_slot = torch.where(cand == best[:, None], slots, c).amin(dim=-1)
    # parent damping: keep the incumbent while it still achieves the
    # minimum
    old = ctrl.parent
    old_slot = old.clamp_min(0)
    old_cand = torch.gather(cand, 1, old_slot[:, None].long())[:, 0]
    keep_old = (old >= 0) & (old_cand <= best)
    slot = torch.where(keep_old, old_slot, best_slot)
    reachable = best <= float(n)
    has_parent = reachable & ~is_root & alive & state.subscribed
    root_live = is_root & alive & state.subscribed
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    hops = torch.where(
        root_live, zero,
        torch.where(has_parent,
                    torch.gather(cand, 1, slot[:, None].long())[:, 0], INF))
    parent = torch.where(has_parent, slot, -1).to(i32)

    # the tree: my parent edge and the child edges that point at me
    parent_edge = (slots[None, :] == parent[:, None]) & has_parent[:, None]
    child_edge = reciprocal_pull_bool(parent_edge, conns, rev)
    if gray:
        child_edge = child_edge & ok_edge   # graylisted children refused
    tree = (parent_edge | child_edge) & valid

    # a parent change is a GRAFT to the new parent and, with an old one,
    # a PRUNE of the old edge
    moved = parent != old
    dropped = (moved & (old >= 0)).to(i32)
    reparents = ctrl.reparents + dropped
    grafts = state.grafts + (moved & has_parent).to(i32)
    prunes = state.prunes + dropped

    # lazy IHAVE along up to lazy_degree non-tree edges, lowest slots first
    budget = params.d_lazy if ep.lazy_degree is None else ep.lazy_degree
    lazy = valid & ~tree
    sel = lazy & (torch.cumsum(lazy, dim=-1) <= budget)
    ihave_tx = state.ihave_tx + sel.sum(dim=-1, dtype=i32)
    ihave_rx = state.ihave_rx + reciprocal_pull_bool(
        sel, conns, rev).sum(dim=-1, dtype=i32)

    fmd, slow = state.fmd, state.slow_penalty
    if peer.any_((fmd > 0) | (slow > 0)):
        fmd = _apply_decay(fmd, params.fmd_decay, params)
        slow = _apply_decay(slow, params.slow_decay, params)

    new_state = state.replace(
        mesh_mask=tree, fmd=fmd, slow_penalty=slow, alive=alive,
        warm_offset_ms=warm, t_ms=t + params.heartbeat_ms, key=key,
        grafts=grafts, prunes=prunes, ihave_tx=ihave_tx, ihave_rx=ihave_rx)
    return new_state, EpisubCtrl(hops=hops, parent=parent,
                                 reparents=reparents)


def episub_window(state: SimState, ctrl: EpisubCtrl, conns, rev, out_mask,
                  params: SimParams, ep: EpisubParams, steps: int, *,
                  attacker=None, adv: AdversaryParams | None = None,
                  adaptive: bool = False, actrl=None,
                  faults: FaultParams = FaultParams(), crash=None, side=None,
                  spike=None, telemetry=None):
    """`steps` rounds of [fault hooks -> episub_heartbeat_step ->
    adversary_round (adaptive_round when `adaptive`) -> spike ->
    observables]. Without `attacker` only the steps run. Returns (state,
    ctrl, actrl, obs): `actrl` the adaptive controller (None unless
    `adaptive`, default a fresh one), obs the stacked curves ({} benign).
    A fault family that is off skips its hooks and needs no cohort."""
    ep.validate(params.n)
    if telemetry is not None and not telemetry.enabled:
        telemetry = None
    if adaptive:
        att_sorted, n_att = cohort_order(attacker)
        if actrl is None:
            actrl = init_adaptive_ctrl(params.n, conns.device)
    live = not repair_inert(params)
    nbr_ok = None
    if params.churn_down_per_hb == 0.0 and params.churn_up_per_hb == 0.0:
        # a crash goes through edge_ok, so liveness is window-invariant
        nbr_ok = neighbor_pull_bool(state.alive & state.subscribed, conns,
                                    rev)
    cross = partition_edge_mask(side, conns) if faults.partition else None
    if faults.crash:
        crash_edges = ((crash[:, None] | neighbor_pull_bool(crash, conns,
                                                            rev))
                       & (conns >= 0))
    if faults.spike:
        spike_ms = torch.tensor(faults.spike_ms, dtype=torch.float32,
                                device=conns.device)
    rounds = []
    s, c = state, ctrl
    for hb in range(steps):
        edge_ok = None
        if faults.crash and faults.crash_window[0] <= hb < \
                faults.crash_window[1]:
            edge_ok = ~crash_edges
        if faults.partition and faults.partition_window[0] <= hb < \
                faults.partition_window[1]:
            edge_ok = ~cross if edge_ok is None else edge_ok & ~cross
        s, c = episub_heartbeat_step(s, c, conns, rev, out_mask, params, ep,
                                     nbr_ok=nbr_ok, edge_ok=edge_ok)
        if attacker is None:
            continue
        if adaptive:
            (s, actrl), obs = adaptive_round(
                s, actrl, conns, rev, attacker, params, adv, nbr_ok=nbr_ok,
                edge_ok=edge_ok, hb_idx=hb, att_sorted=att_sorted,
                n_att=n_att, px_pool_live=live)
        else:
            s, obs = adversary_round(s, conns, rev, attacker, params, adv,
                                     nbr_ok=nbr_ok, hb_idx=hb,
                                     edge_ok=edge_ok)
        if faults.spike and faults.spike_window[0] <= hb < \
                faults.spike_window[1]:
            s = s.replace(uplink_free_ms=torch.where(
                spike, torch.maximum(s.uplink_free_ms, s.t_ms) + spike_ms,
                s.uplink_free_ms))
        obs.update(episub_observables(c, s.alive, s.subscribed))
        obs.update(fault_observables(s, faults, cross, crash))
        if telemetry is not None:
            # the episub windows contract the score's first product, as
            # the attack windows do
            obs.update(telemetry_observables(s, conns, rev, params,
                                             telemetry,
                                             contract_score="first"))
        rounds.append(obs)
    return s, c, actrl, stack_obs(rounds)


def run_episub_heartbeats(state: SimState, ctrl: EpisubCtrl, conns, rev,
                          out_mask, params: SimParams, ep: EpisubParams,
                          steps: int):
    """`steps` episub heartbeats -> (state, ctrl)."""
    s, c, _, _ = episub_window(state, ctrl, conns, rev, out_mask, params,
                               ep, steps)
    return s, c


def run_episub_attacked_heartbeats(state: SimState, ctrl: EpisubCtrl, conns,
                                   rev, out_mask, attacker,
                                   params: SimParams, ep: EpisubParams,
                                   adv: AdversaryParams, steps: int,
                                   telemetry=None):
    """[episub_heartbeat_step -> adversary_round] x steps -> ((state,
    ctrl), obs): GossipSub's adversary_round against the tree, the obs
    gaining tree_reach_frac and tree_depth_mean."""
    s, c, _, obs = episub_window(
        state, ctrl, conns, rev, out_mask, params, ep, steps,
        attacker=attacker, adv=adv, telemetry=telemetry)
    return (s, c), obs


def run_episub_adaptive_heartbeats(state: SimState, ctrl: EpisubCtrl, conns,
                                   rev, out_mask, attacker,
                                   params: SimParams, ep: EpisubParams,
                                   adv: AdversaryParams, steps: int,
                                   actrl=None, telemetry=None):
    """The adaptive attack window against the tree. Disabled this is
    run_episub_attacked_heartbeats (and `actrl` must be None); armed, the
    controller carry rides along (default a fresh one) and the result is
    ((state, ctrl, actrl), obs)."""
    if not adv.adaptive.enabled:
        if actrl is not None:
            raise ValueError("actrl given but adv.adaptive is disabled — "
                             "the disabled path delegates to "
                             "run_episub_attacked_heartbeats and carries "
                             "none")
        return run_episub_attacked_heartbeats(
            state, ctrl, conns, rev, out_mask, attacker, params, ep, adv,
            steps, telemetry)
    s, c, a, obs = episub_window(
        state, ctrl, conns, rev, out_mask, params, ep, steps,
        attacker=attacker, adv=adv, adaptive=True, actrl=actrl,
        telemetry=telemetry)
    return (s, c, a), obs


def run_episub_faulted_heartbeats(state: SimState, ctrl: EpisubCtrl, conns,
                                  rev, out_mask, attacker,
                                  params: SimParams, ep: EpisubParams,
                                  adv: AdversaryParams, faults: FaultParams,
                                  crash, side, spike, steps: int,
                                  telemetry=None, actrl=None):
    """The fault-armed episub window (crash / partition / spike cohorts as
    (N,) tensors): ((state, ctrl), obs), or ((state, ctrl, actrl), obs)
    with the adaptive attacker armed. Disabled it is the adaptive (or
    attacked) episub window. The obs gain cross_mesh_edges (partition) and
    restarted_mean_degree (crash)."""
    if not adv.adaptive.enabled and actrl is not None:
        raise ValueError("actrl given but the adaptive policy is disabled")
    s, c, a, obs = episub_window(
        state, ctrl, conns, rev, out_mask, params, ep, steps,
        attacker=attacker, adv=adv, adaptive=adv.adaptive.enabled,
        actrl=actrl, faults=faults, crash=crash, side=side, spike=spike,
        telemetry=telemetry)
    return ((s, c, a) if adv.adaptive.enabled else (s, c)), obs
