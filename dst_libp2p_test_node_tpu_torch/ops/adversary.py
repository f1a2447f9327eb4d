"""Adversarial perturbations: the static v1.1 attack canon as tensor masks
(the reference's ops/adversary.py, arXiv:2007.02754).

Every attacker behavior is a masked (N,)/(N, C) op over the reverse-slot
involution (ops/pull.py), applied after each heartbeat:

  sybil_graft_flood   attacker rows force-graft every valid edge each
                      heartbeat; a re-GRAFT of a backed-off or meshed edge
                      is a violation that accrues the penalty counter
  ihave_spam          bogus IHAVEs on every attacker edge, never answered
  iwant_spam          unsolicited IWANTs; each answered id occupies the
                      victim's uplink for iwant_answer_ms
  censorship          attackers withhold every copy (censor_mask, folded
                      into disseminate's delivery mask)
  eclipse_publisher   the cohort fills the publisher's connected slots and
                      its mesh row (eclipse_setup)
  cold_boot_join      the graft flood from the un-warmed state
  slow_peer_mimicry   the attacker pins its penalty counter just above
                      the graylist floor
  identity_rotation   graft flood whose sybils scrub the honest side's
                      per-edge memory every rotation_period_hb heartbeats

Violations accrue into `state.slow_penalty` (the v1.1 P7 shape), so the
defense chain is the engine's own: score -> gates -> graylist -> prune.
Each `lax.cond` of the reference is one host predicate; the identity
rotation's scrub cadence reads the window's round index on the host.

The adaptive attacker (AdaptivePolicy armed) replaces adversary_round with
`adaptive_round`: a per-attacker controller carry (ops/state.AdaptiveCtrl)
predicts its next penalty counter, floods or throttles to legal re-grafts
(duty cycle), updates its estimate from its own tx view and plants sybil
ids in honest px_pool rows. `run_adaptive_heartbeats` is its window;
disabled it is run_attacked_heartbeats.

On a rank of the peer mesh (parallel/peer.py) every per-peer mask and
leaf is the rank's rows; the observables' counts are summed over the
ranks and their float sums read the gathered rows, the cohort order and
the PX poisoner's sybil lookups read the whole cohort, and the eclipse
writes the publisher's row on its owner.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..parallel import peer
from .heartbeat import heartbeat_step
from .pull import neighbor_pull_bool, reciprocal_pull_bool
from .state import (PX_POOL_WIDTH, AdaptiveCtrl, SimParams, SimState,
                    init_adaptive_ctrl, repair_inert)
from .telemetry import (adaptive_observables, contracted_score, stack_obs,
                        telemetry_observables)
from .xlamath import fma_f32

SCENARIOS = (
    "sybil_graft_flood",
    "ihave_spam",
    "iwant_spam",
    "censorship",
    "eclipse_publisher",
    "cold_boot_join",
    "slow_peer_mimicry",
    "identity_rotation",
)

# the scenarios the adaptive controller composes with (the graft-flood
# family, whose round behavior is mesh pressure a controller can modulate)
ADAPTIVE_SCENARIOS = ("sybil_graft_flood", "eclipse_publisher",
                      "cold_boot_join")


@dataclass(frozen=True)
class AdaptivePolicy:
    """The reference's per-round adaptive attacker policy. Disabled (the
    default) every runner takes the static path. Armed: `regraft` re-grafts
    every edge whose backoff expired, `px_poison` plants px_poison_per_hb
    sybil ids per victim px_pool row per round, `slot_race` has the cohort
    run the dial controller in recovery windows, `duty_cycle` stops the
    flood when one more violation would push the predicted counter past
    throttle_margin * c_req."""

    enabled: bool = False
    regraft: bool = True
    px_poison: bool = True
    slot_race: bool = True
    duty_cycle: bool = True
    throttle_margin: float = 0.8
    px_poison_per_hb: int = 2

    def validate(self, scenario: str | None = None) -> None:
        if not (0.0 < self.throttle_margin < 1.0):
            raise ValueError("throttle_margin must be in (0, 1) — at >= 1 "
                             "the controller graylists itself, defeating "
                             "the duty cycle")
        if not (1 <= self.px_poison_per_hb <= PX_POOL_WIDTH):
            raise ValueError(
                f"px_poison_per_hb must be in [1, {PX_POOL_WIDTH}] "
                f"(the px_pool width), got {self.px_poison_per_hb}")
        if self.enabled and not (self.regraft or self.px_poison
                                 or self.slot_race or self.duty_cycle):
            raise ValueError("adaptive policy is enabled but every behavior "
                             "is off — use enabled=False (the delegating "
                             "path) instead of an armed no-op")
        if self.enabled and scenario is not None \
                and scenario not in ADAPTIVE_SCENARIOS:
            raise ValueError(
                f"adaptive policy composes with {ADAPTIVE_SCENARIOS} only "
                f"(the graft-flood family), not scenario {scenario!r}: the "
                "spam scenarios have no backoff/mesh loop to adapt to, "
                "mimicry is already an adaptive policy, and rotation's "
                "identity scrubs erase the controller's own estimate")


@dataclass(frozen=True)
class AdversaryParams:
    """Static attack-scenario parameters (the reference's fields and
    defaults)."""

    scenario: str = "sybil_graft_flood"
    violation_penalty: float = 1.0
    censor_penalty: float = 1.0
    spam_ihaves_per_hb: int = 8
    spam_iwants_per_hb: int = 16
    iwant_answer_ms: float = 2.0
    mimic_margin: float = 0.9
    rotation_period_hb: int = 4
    adaptive: AdaptivePolicy = AdaptivePolicy()

    def validate(self) -> None:
        self.adaptive.validate(self.scenario)
        if self.scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r}; "
                             f"expected one of {SCENARIOS}")
        if self.violation_penalty <= 0.0 or self.censor_penalty < 0.0:
            raise ValueError(
                "violation_penalty must be > 0, censor_penalty >= 0")
        if self.spam_ihaves_per_hb < 1:
            raise ValueError("spam_ihaves_per_hb must be >= 1")
        if self.spam_iwants_per_hb < 1:
            raise ValueError("spam_iwants_per_hb must be >= 1")
        if self.iwant_answer_ms < 0.0:
            raise ValueError("iwant_answer_ms must be >= 0")
        if not (0.0 < self.mimic_margin < 1.0):
            raise ValueError("mimic_margin must be in (0, 1) — at >= 1 the "
                             "mimic graylists itself, defeating the scenario")
        if self.rotation_period_hb < 2:
            raise ValueError("rotation_period_hb must be >= 2 (a period of 1 "
                             "scrubs every round: no accrual ever survives)")

    @property
    def graft_flood(self) -> bool:
        return self.scenario in ("sybil_graft_flood", "eclipse_publisher",
                                 "cold_boot_join", "identity_rotation")

    @property
    def ihave_spam(self) -> bool:
        return self.scenario == "ihave_spam"

    @property
    def iwant_spam(self) -> bool:
        return self.scenario == "iwant_spam"

    @property
    def eclipse(self) -> bool:
        return self.scenario == "eclipse_publisher"

    @property
    def cold_boot(self) -> bool:
        return self.scenario == "cold_boot_join"

    @property
    def slow_mimicry(self) -> bool:
        return self.scenario == "slow_peer_mimicry"

    @property
    def identity_rotation(self) -> bool:
        return self.scenario == "identity_rotation"


def attacker_cohort(n: int, fraction: float, seed: int, conns=None,
                    publisher: int | None = None,
                    eclipse: bool = False) -> np.ndarray:
    """(N,) bool attacker membership, drawn on the host once per trial
    (deterministic in seed and fraction). `eclipse` fills the cohort from
    the publisher's connected neighbors first; the publisher is never an
    attacker."""
    if not (0.0 <= fraction < 1.0):
        raise ValueError(
            f"attacker fraction must be in [0, 1), got {fraction}")
    k = int(round(fraction * n))
    mask = np.zeros(n, dtype=bool)
    if k == 0:
        return mask
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, int(fraction * 1e6), 0xAD5E]))
    candidates = np.arange(n)
    if publisher is not None:
        candidates = candidates[candidates != publisher]
    if eclipse:
        if conns is None or publisher is None:
            raise ValueError("eclipse cohort needs conns and publisher")
        nbrs = np.asarray(conns)[publisher]
        nbrs = np.unique(nbrs[nbrs >= 0])
        nbrs = nbrs[nbrs != publisher]
        take = nbrs[:k] if len(nbrs) > k else nbrs
        mask[take] = True
        k -= len(take)
        candidates = candidates[~mask[candidates]]
    if k > 0:
        mask[rng.choice(candidates, size=k, replace=False)] = True
    return mask


def heartbeats_to_graylist(adv: AdversaryParams, params: SimParams) -> float:
    """The closed-form engagement budget: heartbeats from attack start
    until every violated honest->attacker edge scores below the graylist
    threshold (c_k = d*c_{k-1} + p; see the reference for the derivation
    and the eviction, mimicry and rotation cases). inf when it can never
    engage."""
    if adv.slow_mimicry:
        return math.inf
    if adv.adaptive.enabled and adv.adaptive.duty_cycle \
            and params.slow_weight < 0.0:
        return math.inf
    if params.slow_weight >= 0.0:
        return math.inf
    c_req = params.graylist_threshold / params.slow_weight
    p = adv.violation_penalty
    d = params.slow_decay
    lead_in = 1.0 if (adv.ihave_spam or adv.iwant_spam) else 2.0
    if c_req <= p:
        base = lead_in
    else:
        rhs = 1.0 - c_req * (1.0 - d) / p
        if rhs <= 0.0:
            return math.inf
        base = lead_in - 1.0 + math.ceil(math.log(rhs) / math.log(d))
    if adv.identity_rotation and base >= adv.rotation_period_hb:
        return math.inf
    return base


def censor_mask(attacker: torch.Tensor, conns: torch.Tensor) -> torch.Tensor:
    """(N, C) per-edge delivery drop mask: every out-edge of an attacker."""
    return attacker[:, None] & (conns >= 0)


def eclipse_setup(state: SimState, conns: torch.Tensor,
                  attacker: torch.Tensor, publisher: int) -> SimState:
    """Overwrite the publisher's mesh row with its attacker edges only."""
    nb = peer.read_row(conns, publisher)
    row = torch.where(nb >= 0,
                      peer.all_rows(attacker)[nb.clamp_min(0).long()], False)
    mesh = state.mesh_mask.clone()
    peer.write_row(mesh, publisher, row)
    return state.replace(mesh_mask=mesh)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _accrue(counter: torch.Tensor, mask: torch.Tensor, amount: float):
    """counter + where(mask, amount, 0) in float32."""
    return counter + torch.where(mask, _f32(amount, counter),
                                 _f32(0.0, counter))


def _valid_edges(state, conns, rev, nbr_ok):
    if nbr_ok is None:
        nbr_ok = neighbor_pull_bool(state.alive & state.subscribed, conns,
                                    rev)
    return ((conns >= 0) & state.alive[:, None] & nbr_ok
            & state.subscribed[:, None])


def _isum(x: torch.Tensor) -> torch.Tensor:
    """A count over every peer's rows."""
    return peer.isum(x)


def _ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """int32 count / float32(int32 count), as jnp promotes it."""
    return num.to(torch.float32) / den.to(torch.float32)


def attack_observables(state: SimState, conns, rev, attacker,
                       params: SimParams, valid=None) -> dict:
    """The per-round scalar observables the campaign's engagement and
    recovery metrics are built from (0-d float32 tensors)."""
    if valid is None:
        valid = _valid_edges(state, conns, rev, None)
    honest = ~attacker & state.alive & state.subscribed
    mesh = state.mesh_mask
    sc = contracted_score(state, params)
    att_nbr = neighbor_pull_bool(attacker, conns, rev)
    h_att_edge = valid & att_nbr & honest[:, None]
    n_e = _isum(h_att_edge).clamp_min(1)
    return {
        "graylisted_frac": _ratio(
            _isum(h_att_edge & (sc < params.graylist_threshold)), n_e),
        "attacker_score_mean": (
            peer.sum_f32(torch.where(h_att_edge, sc, _f32(0.0, sc)))
            / n_e.to(torch.float32)),
        "attacker_mesh_share": _ratio(
            _isum(mesh & att_nbr & honest[:, None]),
            _isum(mesh & honest[:, None]).clamp_min(1)),
        "honest_mean_degree": _ratio(_isum(mesh & honest[:, None]),
                                     _isum(honest).clamp_min(1)),
    }


def adversary_round(state: SimState, conns, rev, attacker,
                    params: SimParams, adv: AdversaryParams, nbr_ok=None,
                    hb_idx: int | None = None, edge_ok=None):
    """One heartbeat of attacker behavior and honest defense accounting,
    applied after heartbeat_step. Returns (new_state, obs). `hb_idx`: the
    window's 0-based round index (identity_rotation's scrub cadence);
    `edge_ok`: heartbeat_step's per-edge availability mask (a partitioned
    edge carries no attack traffic either)."""
    if adv.identity_rotation and hb_idx is None:
        raise ValueError("identity_rotation needs the scan round index "
                         "(hb_idx) to schedule the identity scrubs")
    t = state.t_ms
    valid = _valid_edges(state, conns, rev, nbr_ok)
    if edge_ok is not None:
        valid = valid & edge_ok
    att_row = attacker[:, None] & valid

    mesh = state.mesh_mask
    slow_penalty = state.slow_penalty
    uplink_free_ms = state.uplink_free_ms
    backoff_until = state.backoff_until
    fmd = state.fmd
    grafts, grafts_rx = state.grafts, state.grafts_rx
    ihave_tx, ihave_rx = state.ihave_tx, state.ihave_rx
    iwant_tx, iwant_rx = state.iwant_tx, state.iwant_rx
    i32 = torch.int32

    if adv.identity_rotation and (
            hb_idx % adv.rotation_period_hb == adv.rotation_period_hb - 1):
        # a new identity on every attacker-incident slot: the honest side's
        # memory of the old one (mesh, credit, penalty, backoff) resets
        inc = (attacker[:, None]
               | neighbor_pull_bool(attacker, conns, rev)) & (conns >= 0)
        zero = _f32(0.0, slow_penalty)
        mesh = mesh & ~inc
        slow_penalty = torch.where(inc, zero, slow_penalty)
        fmd = torch.where(inc, zero, fmd)
        backoff_until = torch.where(inc, zero, backoff_until)

    if adv.graft_flood:
        flood = att_row
        rx = reciprocal_pull_bool(flood, conns, rev)
        violation = rx & ((backoff_until > t) | mesh)
        # rotation reads the post-scrub counters (a fresh identity is
        # accepted); every other scenario the round's entry state
        sc = (state.replace(fmd=fmd, slow_penalty=slow_penalty).score(params)
              if adv.identity_rotation else state.score(params))
        accept = rx & ~violation & (sc >= 0.0)
        mesh = (mesh | flood | accept) & valid
        slow_penalty = _accrue(slow_penalty, violation, adv.violation_penalty)
        grafts = grafts + flood.sum(dim=-1, dtype=i32)
        grafts_rx = grafts_rx + rx.sum(dim=-1, dtype=i32)

    if adv.ihave_spam:
        ann = att_row
        rx_ann = reciprocal_pull_bool(ann, conns, rev)
        k = adv.spam_ihaves_per_hb
        ann_n = ann.sum(dim=-1, dtype=i32) * k
        rx_n = rx_ann.sum(dim=-1, dtype=i32) * k
        ihave_tx = ihave_tx + ann_n
        ihave_rx = ihave_rx + rx_n
        iwant_tx = iwant_tx + rx_n
        iwant_rx = iwant_rx + ann_n
        slow_penalty = _accrue(slow_penalty, rx_ann, adv.violation_penalty)

    if adv.iwant_spam:
        req = att_row
        rx_req = reciprocal_pull_bool(req, conns, rev)
        k = adv.spam_iwants_per_hb
        sc0 = state.score(params)
        serve = rx_req & (sc0 >= params.graylist_threshold)
        served = serve.sum(dim=-1, dtype=i32) * k
        iwant_tx = iwant_tx + req.sum(dim=-1, dtype=i32) * k
        iwant_rx = iwant_rx + rx_req.sum(dim=-1, dtype=i32) * k
        uplink_free_ms = torch.where(
            served > 0,
            torch.maximum(uplink_free_ms, t)
            + served.to(torch.float32) * _f32(adv.iwant_answer_ms, t),
            uplink_free_ms)
        slow_penalty = _accrue(slow_penalty, rx_req, adv.violation_penalty)

    if adv.slow_mimicry and params.slow_weight < 0.0:
        c_req = params.graylist_threshold / params.slow_weight
        att_view = neighbor_pull_bool(attacker, conns, rev)
        slow_penalty = torch.where(
            valid & att_view, _f32(adv.mimic_margin * c_req, slow_penalty),
            slow_penalty)

    new_state = state.replace(
        mesh_mask=mesh, slow_penalty=slow_penalty,
        uplink_free_ms=uplink_free_ms,
        grafts=grafts, grafts_rx=grafts_rx,
        ihave_tx=ihave_tx, ihave_rx=ihave_rx,
        iwant_tx=iwant_tx, iwant_rx=iwant_rx,
        fmd=fmd, backoff_until=backoff_until,
    )
    obs = attack_observables(new_state, conns, rev, attacker, params,
                             valid=valid)
    return new_state, obs


def run_attacked_heartbeats(state: SimState, conns, rev, out_mask, attacker,
                            params: SimParams, adv: AdversaryParams,
                            steps: int, telemetry=None):
    """`steps` rounds of [heartbeat_step -> adversary_round]: the attack
    window with no fault schedule (ops/faults.attack_window). Decay is per
    round (the window writes the penalty counter mid-run, so nothing is
    deferred and score_update is not reached); the neighbor pull hoists
    when churn is off. Returns (state, obs) with obs leaves shaped
    (steps,). `telemetry`: an armed TelemetryParams adds the tel_*
    channels (no PRNG, no state write)."""
    from .faults import attack_window  # faults imports this module

    return attack_window(state, conns, rev, out_mask, attacker, params, adv,
                         steps, telemetry=telemetry)


def _decayed_plus(est: torch.Tensor, decay: float, add: torch.Tensor):
    """est * decay + add in float32 with one rounding: XLA's CPU backend
    contracts both of the controller's multiply-adds into FMAs in every
    reference program that runs it (ROADMAP C5)."""
    return fma_f32(est, _f32(decay, est), add)


def adaptive_round(state: SimState, ctrl: AdaptiveCtrl, conns, rev,
                   attacker, params: SimParams, adv: AdversaryParams,
                   nbr_ok=None, edge_ok=None, hb_idx: int | None = None,
                   att_sorted=None, n_att=None, px_pool_live: bool = True):
    """One heartbeat of the adaptive attacker controller and the honest
    defense accounting, applied after heartbeat_step (and after
    repair_round in the recovery windows). Returns ((state, ctrl), obs):
    the attack observables plus the adv_* controller channels. No PRNG.

    Per attacker row: PREDICT the next counter (viol_est * slow_decay +
    violation_penalty); ACT (flood every valid edge) while that stays under
    throttle_margin * c_req, else THROTTLE to legal re-grafts (backoff
    expired, edge not meshed); OBSERVE its own violations into viol_est;
    POISON empty px_pool slots of honest peers beside the cohort with
    sybil ids, rotating through the sorted cohort by round.

    `hb_idx`: the window's 0-based round; `att_sorted` / `n_att`: the
    window-invariant sorted cohort ids and cohort size the runners hoist.
    `px_pool_live`: False where the reference strips the repair leaves
    from its window (repair fully off), so the poisoner does not run and
    adv_px_sybil_frac reads 0."""
    pol = adv.adaptive
    if not pol.enabled:
        raise ValueError("adaptive_round requires an armed AdaptivePolicy; "
                         "the disabled path is run_attacked_heartbeats")
    i32 = torch.int32
    t = state.t_ms
    valid = _valid_edges(state, conns, rev, nbr_ok)
    if edge_ok is not None:
        valid = valid & edge_ok
    att_row = attacker[:, None] & valid
    n_loc = conns.shape[0]
    n = peer.global_rows(n_loc)
    dev = conns.device
    me = peer.row_ids(n_loc, dev).to(i32)
    zero = _f32(0.0, state.slow_penalty)
    pen = _f32(adv.violation_penalty, zero)

    # -- 1/2: the score-aware duty cycle ----------------------------------
    if pol.duty_cycle and params.slow_weight < 0.0:
        c_req = _f32(params.graylist_threshold / params.slow_weight, zero)
        predicted = _decayed_plus(ctrl.viol_est, params.slow_decay,
                                  pen.expand_as(ctrl.viol_est))
        act = attacker & (predicted < _f32(pol.throttle_margin, zero)
                          * c_req)
    else:
        act = attacker

    # -- the graft set: the flood when acting, legal re-grafts otherwise --
    legal = att_row & (state.backoff_until <= t) & ~state.mesh_mask
    graft = att_row & act[:, None]
    if pol.regraft:
        graft = graft | legal
    rx = reciprocal_pull_bool(graft, conns, rev)
    violation = rx & ((state.backoff_until > t) | state.mesh_mask)
    sc = state.score(params)
    accept = rx & ~violation & (sc >= 0.0)
    mesh = (state.mesh_mask | graft | accept) & valid
    slow_penalty = _accrue(state.slow_penalty, violation,
                           adv.violation_penalty)
    grafts = state.grafts + graft.sum(dim=-1, dtype=i32)
    grafts_rx = state.grafts_rx + rx.sum(dim=-1, dtype=i32)

    # -- 3: the estimate, from the attacker's own tx view -----------------
    self_viol = (graft & ((state.backoff_until > t)
                          | state.mesh_mask)).any(dim=-1)
    viol_est = _decayed_plus(ctrl.viol_est, params.slow_decay,
                             torch.where(attacker & self_viol, pen, zero))
    regrafts = ctrl.regrafts
    if pol.regraft:
        regrafts = regrafts + torch.where(
            attacker, legal.sum(dim=-1, dtype=i32), 0)
    throttled_hb = ctrl.throttled_hb + (attacker & ~act).to(i32)

    # -- 4: PX poisoning: sybil answers to PX demand ----------------------
    px_injected = ctrl.px_injected
    extra = {}
    if pol.px_poison and px_pool_live:
        pool = state.px_pool.clone()
        if att_sorted is None or n_att is None:
            att_sorted, n_att = cohort_order(attacker)
        att_nbr = neighbor_pull_bool(attacker, conns, rev)
        victim = (~attacker & state.alive & state.subscribed
                  & (att_nbr & valid).any(dim=-1))
        hb = hb_idx if hb_idx is not None else 0
        base = me.long() + hb * pol.px_poison_per_hb
        denom = n_att.clamp_min(1)
        rows = torch.arange(n_loc, device=dev)
        for k in range(pol.px_poison_per_hb):
            cand = att_sorted[(base + k) % denom]
            empty = pool < 0
            slot = torch.argmax(empty.to(torch.uint8), dim=-1)
            do = victim & (n_att > 0) & (cand < n) & empty.any(dim=-1)
            pool[rows, slot] = torch.where(do, cand.to(pool.dtype),
                                           pool[rows, slot])
            px_injected = px_injected + do.to(i32)
        extra["px_pool"] = pool

    new_state = state.replace(
        mesh_mask=mesh, slow_penalty=slow_penalty,
        grafts=grafts, grafts_rx=grafts_rx, **extra)
    new_ctrl = AdaptiveCtrl(viol_est=viol_est, regrafts=regrafts,
                            px_injected=px_injected,
                            throttled_hb=throttled_hb)
    obs = attack_observables(new_state, conns, rev, attacker, params,
                             valid=valid)
    obs.update(adaptive_observables(
        new_state, new_ctrl, attacker, acting=act,
        violations=violation.sum(dtype=torch.int64),
        px_pool_live=px_pool_live))
    return (new_state, new_ctrl), obs


def cohort_order(attacker: torch.Tensor):
    """(sorted cohort ids, padded with n; cohort size): the PX poisoner's
    sybil-id schedule, invariant over a window; over the whole cohort on
    a rank of the peer mesh."""
    attacker = peer.all_rows(attacker)
    n = attacker.shape[0]
    me = torch.arange(n, dtype=torch.int32, device=attacker.device)
    return (torch.sort(torch.where(attacker, me, n)).values,
            attacker.sum(dtype=torch.int64))


def run_adaptive_heartbeats(state: SimState, conns, rev, out_mask, attacker,
                            params: SimParams, adv: AdversaryParams,
                            steps: int, ctrl: AdaptiveCtrl | None = None,
                            telemetry=None):
    """The adaptive attack window: `steps` rounds of [heartbeat_step ->
    adaptive_round] with the controller carry (ops/faults.attack_window
    with no fault schedule). Disabled this is run_attacked_heartbeats (and
    `ctrl` must be None); armed, `ctrl` defaults to a fresh
    init_adaptive_ctrl and the result is ((state, ctrl), obs) with the
    adv_* channels beside the attack observables."""
    from .faults import attack_window  # faults imports this module

    if not adv.adaptive.enabled and ctrl is not None:
        raise ValueError("ctrl given but adv.adaptive is disabled — the "
                         "disabled path is run_attacked_heartbeats and "
                         "carries none")
    return attack_window(state, conns, rev, out_mask, attacker, params, adv,
                         steps, adaptive=adv.adaptive.enabled, ctrl=ctrl,
                         telemetry=telemetry)


def censorship_penalty_update(state: SimState, conns, rev, attacker,
                              received, params: SimParams,
                              adv: AdversaryParams) -> SimState:
    """Post-publish P3 analog: a receiver of the message penalizes its mesh
    members that are censoring attackers."""
    if float(adv.censor_penalty) == 0.0:
        return state
    att_nbr = neighbor_pull_bool(attacker, conns, rev)
    deficit = (state.mesh_mask & att_nbr
               & (received & ~attacker)[:, None])
    return state.replace(slow_penalty=_accrue(state.slow_penalty, deficit,
                                              adv.censor_penalty))
