"""Fault injection: node churn, partitions and latency spikes as masks
(the reference's ops/faults.py).

Three fault families, each a [start, end) window in heartbeat rounds of
the fault-armed attack window:

  crash/restart   the cohort goes dark at crash_window[0] (alive=False)
                  and returns at crash_window[1] cold: mesh membership,
                  delivery credit, penalty counters and backoffs are
                  scrubbed on every edge incident to a restarted peer, both
                  directions (and its PX pool and starvation clock when
                  repair is armed)
  partition/heal  `side` 2-colors the peers and every cross-color edge
                  falls out of validity (partition_edge_mask ->
                  heartbeat_step / adversary_round `edge_ok`) for the
                  window; the cross mesh edges are banked at the cut and
                  the still-valid ones restored at the heal (mesh memory
                  survives a network-layer cut)
  latency spike   the spiked cohort's uplink clock is pushed to
                  max(uplink_free_ms, t_ms) + spike_ms each window round

`attack_window` is the one attack-window loop: with `FaultParams()`
(all-off) every fault hook is skipped, and ops/adversary's
run_attacked_heartbeats and run_adaptive_heartbeats are that loop with
no schedule. Cohorts are drawn on the host in `fault_masks`; the
armed window draws no device PRNG, so the key schedule is the un-faulted
run's. The reference's per-round `lax.cond`s on the round index are host
comparisons of the loop's Python int here, so they cost no host sync.

On a rank of the peer mesh (parallel/peer.py) the cohorts are the rank's
rows like every per-peer mask; the cut and the heal read the neighbors'
side and liveness from the gathered rows, and the fault observables'
counts are summed over the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel import peer
from .adversary import (AdversaryParams, adaptive_round, adversary_round,
                        cohort_order)
from .heartbeat import heartbeat_step
from .pull import neighbor_pull_bool
from .state import SimParams, SimState, init_adaptive_ctrl, repair_inert
from .telemetry import stack_obs, telemetry_observables

INF = 3.4e38


@dataclass(frozen=True)
class FaultParams:
    """The fault schedule (the reference's fields and defaults). A family
    is armed iff its fraction is > 0 and its window is non-empty (the
    spike also needs spike_ms > 0)."""

    crash_frac: float = 0.0
    crash_window: tuple[int, int] = (0, 0)
    partition_frac: float = 0.0
    partition_window: tuple[int, int] = (0, 0)
    spike_frac: float = 0.0
    spike_window: tuple[int, int] = (0, 0)
    spike_ms: float = 0.0

    @property
    def crash(self) -> bool:
        return self.crash_frac > 0.0 and self.crash_window[1] > self.crash_window[0]

    @property
    def partition(self) -> bool:
        return (self.partition_frac > 0.0
                and self.partition_window[1] > self.partition_window[0])

    @property
    def spike(self) -> bool:
        return (self.spike_frac > 0.0 and self.spike_ms > 0.0
                and self.spike_window[1] > self.spike_window[0])

    @property
    def enabled(self) -> bool:
        return self.crash or self.partition or self.spike

    def validate(self) -> None:
        for name, frac in (("crash_frac", self.crash_frac),
                           ("partition_frac", self.partition_frac),
                           ("spike_frac", self.spike_frac)):
            if not (0.0 <= frac < 1.0):
                raise ValueError(f"{name} must be in [0, 1), got {frac}")
        for name, win in (("crash_window", self.crash_window),
                          ("partition_window", self.partition_window),
                          ("spike_window", self.spike_window)):
            a, b = win
            if a < 0 or b < a:
                raise ValueError(
                    f"{name} must be [start, end) with 0 <= start <= end, "
                    f"got {win}")
        if self.spike_ms < 0.0:
            raise ValueError("spike_ms must be >= 0")


def fault_masks(n: int, faults: FaultParams, seed: int,
                publisher: int | None = None) -> dict[str, np.ndarray]:
    """The per-trial fault cohorts as (N,) bool numpy arrays, drawn on the
    host (the reference's draw): 'crash' (never the publisher), 'side'
    (True = side A, |A| = round(partition_frac * n)) and 'spike'.
    Disabled families are all False."""
    crash = np.zeros(n, dtype=bool)
    side = np.zeros(n, dtype=bool)
    spike = np.zeros(n, dtype=bool)
    if faults.crash:
        k = int(round(faults.crash_frac * n))
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0xFA17, 0]))
        cand = np.arange(n)
        if publisher is not None:
            cand = cand[cand != publisher]
        k = min(k, len(cand))
        if k > 0:
            crash[rng.choice(cand, size=k, replace=False)] = True
    if faults.partition:
        k = int(round(faults.partition_frac * n))
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0xFA17, 1]))
        if k > 0:
            side[rng.choice(n, size=min(k, n), replace=False)] = True
    if faults.spike:
        k = int(round(faults.spike_frac * n))
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, 0xFA17, 2]))
        if k > 0:
            spike[rng.choice(n, size=min(k, n), replace=False)] = True
    return {"crash": crash, "side": side, "spike": spike}


def partition_edge_mask(side: torch.Tensor, conns: torch.Tensor
                        ) -> torch.Tensor:
    """(N, C) bool: True on every connected edge that crosses the cut."""
    return (conns >= 0) & (side[:, None]
                           ^ peer.all_rows(side)[conns.clamp_min(0).long()])


def _go_dark(s: SimState, crash) -> SimState:
    # the warm-start offsets were measured on the old liveness set
    return s.replace(alive=s.alive & ~crash,
                     warm_offset_ms=torch.full_like(s.warm_offset_ms, INF))


def _restart(s: SimState, crash, crash_nbr, conns, params) -> SimState:
    # cold return: every edge incident to a restarted peer forgets the old
    # session on both sides
    inc = (crash[:, None] | crash_nbr) & (conns >= 0)
    zero = torch.zeros((), dtype=torch.float32, device=conns.device)
    repl = dict(
        alive=s.alive | crash,
        mesh_mask=s.mesh_mask & ~inc,
        fmd=torch.where(inc, zero, s.fmd),
        slow_penalty=torch.where(inc, zero, s.slow_penalty),
        backoff_until=torch.where(inc, zero, s.backoff_until),
        warm_offset_ms=torch.full_like(s.warm_offset_ms, INF),
    )
    if not repair_inert(params):
        # a restarted peer's PX pool and starvation clock reset with it
        repl["px_pool"] = torch.where(crash[:, None], -1, s.px_pool)
        repl["starve_hb"] = torch.where(crash, 0, s.starve_hb)
    return s.replace(**repl)


def _thaw(s: SimState, frozen, conns) -> SimState:
    # heal: restore the banked edges whose endpoints both still stand
    ok = s.alive & s.subscribed
    keep = frozen & ok[:, None] & peer.all_rows(ok)[conns.clamp_min(0)
                                                    .long()]
    return s.replace(mesh_mask=s.mesh_mask | keep)


def fault_observables(s: SimState, faults: FaultParams, cross,
                      crash) -> dict:
    """The fault channels of a round: cross_mesh_edges (partition armed:
    mesh edges across the cut) and restarted_mean_degree (crash armed:
    the restarting cohort's mean mesh degree), counts over every row."""
    f32 = torch.float32
    obs = {}
    if faults.partition:
        obs["cross_mesh_edges"] = peer.isum(s.mesh_mask & cross).to(f32)
    if faults.crash:
        obs["restarted_mean_degree"] = (
            peer.isum(s.mesh_mask & crash[:, None]).to(f32)
            / peer.isum(crash).clamp_min(1).to(f32))
    return obs


def run_faulted_heartbeats(state: SimState, conns, rev, out_mask, attacker,
                           params: SimParams, adv: AdversaryParams,
                           faults: FaultParams, crash, side, spike,
                           steps: int, telemetry=None, ctrl=None):
    """The fault-armed attack window: run_attacked_heartbeats with the
    fault schedule in each round. `crash` / `side` / `spike` are the (N,)
    fault_masks cohorts as tensors. Disabled this is the un-faulted window
    (run_adaptive_heartbeats with the adaptive attacker armed). Armed with
    the adaptive attacker the controller carry rides along (`ctrl`,
    default a fresh one) and the result is ((state, ctrl), obs). The obs
    gain `cross_mesh_edges` (partition armed: mesh edges across the cut)
    and `restarted_mean_degree` (crash armed: mean mesh degree of the
    restarting cohort)."""
    adaptive = adv.adaptive.enabled
    if not adaptive and ctrl is not None:
        raise ValueError("ctrl given but the adaptive policy is disabled")
    return attack_window(state, conns, rev, out_mask, attacker, params, adv,
                         steps, adaptive=adaptive, ctrl=ctrl, faults=faults,
                         crash=crash, side=side, spike=spike,
                         telemetry=telemetry)


def attack_window(state: SimState, conns, rev, out_mask, attacker,
                  params: SimParams, adv: AdversaryParams, steps: int, *,
                  adaptive: bool = False, ctrl=None,
                  faults: FaultParams = FaultParams(), crash=None, side=None,
                  spike=None, telemetry=None):
    """`steps` rounds of [fault hooks -> heartbeat_step -> adversary_round
    (adaptive_round when `adaptive`) -> spike -> telemetry]. A fault family
    that is off skips its hooks and needs no cohort. Returns (state, obs),
    or ((state, ctrl), obs) when `adaptive` (`ctrl` default a fresh
    init_adaptive_ctrl)."""
    if telemetry is not None and not telemetry.enabled:
        telemetry = None
    if adaptive and ctrl is None:
        ctrl = init_adaptive_ctrl(params.n, conns.device)
    f32 = torch.float32
    live = not repair_inert(params)
    if adaptive:
        att_sorted, n_att = cohort_order(attacker)
    nbr_ok = None
    if (not faults.crash and params.churn_down_per_hb == 0.0
            and params.churn_up_per_hb == 0.0):
        # liveness is window-invariant without crash or churn
        nbr_ok = neighbor_pull_bool(state.alive & state.subscribed, conns,
                                    rev)
    cross = partition_edge_mask(side, conns) if faults.partition else None
    crash_nbr = (neighbor_pull_bool(crash, conns, rev) if faults.crash
                 else None)
    frozen = torch.zeros_like(state.mesh_mask) if faults.partition else None
    if faults.spike:
        spike_ms = torch.tensor(faults.spike_ms, dtype=f32,
                                device=conns.device)
    rounds = []
    s = state
    for hb in range(steps):
        if faults.crash:
            cs, ce = faults.crash_window
            if hb == cs:
                s = _go_dark(s, crash)
            if hb == ce:
                s = _restart(s, crash, crash_nbr, conns, params)
        edge_ok = None
        if faults.partition:
            ps, pe = faults.partition_window
            if hb == ps:
                # bank the cross mesh edges: heartbeat's mesh & valid
                # would scrub them for good
                frozen = s.mesh_mask & cross
                s = s.replace(mesh_mask=s.mesh_mask & ~cross)
            if hb == pe:
                s = _thaw(s, frozen, conns)
                frozen = torch.zeros_like(frozen)
            if ps <= hb < pe:
                edge_ok = ~cross
        s = heartbeat_step(s, conns, rev, out_mask, params, nbr_ok=nbr_ok,
                           edge_ok=edge_ok)
        if adaptive:
            (s, ctrl), obs = adaptive_round(
                s, ctrl, conns, rev, attacker, params, adv, nbr_ok=nbr_ok,
                edge_ok=edge_ok, hb_idx=hb, att_sorted=att_sorted,
                n_att=n_att, px_pool_live=live)
        else:
            s, obs = adversary_round(s, conns, rev, attacker, params, adv,
                                     nbr_ok=nbr_ok, hb_idx=hb,
                                     edge_ok=edge_ok)
        if faults.spike:
            ss, se = faults.spike_window
            if ss <= hb < se:
                s = s.replace(uplink_free_ms=torch.where(
                    spike, torch.maximum(s.uplink_free_ms, s.t_ms)
                    + spike_ms, s.uplink_free_ms))
        obs.update(fault_observables(s, faults, cross, crash))
        if telemetry is not None:
            obs.update(telemetry_observables(
                s, conns, rev, params, telemetry, contract_score="first"))
        rounds.append(obs)
    obs = stack_obs(rounds)
    return ((s, ctrl) if adaptive else s), obs
