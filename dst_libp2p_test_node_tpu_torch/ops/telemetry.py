"""The flight recorder: opt-in per-heartbeat telemetry channels (the
reference's ops/telemetry.py).

`telemetry_observables` reduces the live SimState to a fixed set of
per-round float32 channels; the window runners stack them into (steps,)
or (steps, k) curves beside their obs dicts. Armed or not, the recorder
consumes no PRNG and writes no state leaf, so the protocol trajectory is
the same bytes either way; `TelemetryParams(record=False)` makes every
runner take its unrecorded path.

Channels (all float32): tel_mesh_coverage, tel_mean_degree,
tel_degree_hist (degree_bins,), tel_score_q (len(quantiles),),
tel_graylisted_frac, tel_bytes_tx, tel_bytes_rx, tel_ihave, tel_iwant,
tel_queue_depth_ms. Float sums follow XLA's CPU order (xlamath.sum_f32);
the score quantiles are jnp.nanquantile's linear rule, step for step.

On a rank of the peer mesh (parallel/peer.py) the channels come out the
same on every rank and equal to the one-device run's: counts are summed
over the ranks, float sums and the score quantiles read the all-gathered
rows (one place, XLA's order).

`run_recorded_heartbeats` is run_heartbeats with a per-round emission:
the same hoisted validity, carried degree and deferred decay (the
recorded scores apply the running scales on the fly), materialized once
at the end by the score_update kernel. `adaptive_observables` is the
adaptive attacker's channel set (adv_*), emitted by its windows.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..native.score_update import score_update
from ..parallel import peer
from .heartbeat import _apply_decay, heartbeat_step, run_heartbeats
from .pull import neighbor_pull_bool
from .state import SimParams, SimState
from .xlamath import fma_f32


@dataclass(frozen=True)
class TelemetryParams:
    """Flight-recorder configuration (the reference's fields)."""

    record: bool = False
    degree_bins: int = 12
    quantiles: tuple = (0.1, 0.5, 0.9)

    @property
    def enabled(self) -> bool:
        return self.record

    def validate(self) -> None:
        if self.degree_bins < 2:
            raise ValueError(
                f"degree_bins must be >= 2, got {self.degree_bins}")
        if not self.quantiles:
            raise ValueError("need at least one score quantile")
        for q in self.quantiles:
            if not (0.0 <= q <= 1.0):
                raise ValueError(f"quantile {q} outside [0, 1]")


def stack_obs(rounds: list[dict]) -> dict:
    """Per-round obs dicts -> {key: (steps, ...) tensor}, the scan's
    stacked output, keys sorted as the reference's pytree leaves them."""
    if not rounds:
        return {}
    return {k: torch.stack([r[k] for r in rounds]) for k in sorted(rounds[0])}


def nanquantile_f32(x: torch.Tensor, qs) -> torch.Tensor:
    """jnp.nanquantile(x, qs) over all of x (float32, method "linear") as
    the recorder's programs compute it: NaNs sort last, the count of the
    rest is a float32, the index is q * (count - 1), and the two
    neighbors are mixed as lo*(1-w) + hi*w, with XLA's CPU backend
    contracting the hi*w product into the add (one FMA). On a rank of the
    peer mesh: over every peer's rows (all-gathered)."""
    f32 = torch.float32
    a = torch.sort(peer.all_rows(x).reshape(-1)).values
    dev = a.device
    q = torch.tensor(qs, dtype=f32, device=dev)
    counts = (~torch.isnan(a)).sum(dtype=torch.int64).to(f32)
    q = q * (counts - 1.0)
    low = torch.floor(q)
    high = torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    top = counts - 1.0
    low = torch.clamp_min(torch.minimum(low, top), 0.0).long()
    high = torch.clamp_min(torch.minimum(high, top), 0.0).long()
    return fma_f32(a[high], hw, a[low] * lw)


def contracted_score(state: SimState, params: SimParams,
                     product: str = "first") -> torch.Tensor:
    """state.score as XLA's CPU backend fuses it in the programs that read
    it for their observables, one product contracted into the add (one
    FMA). "first" (the attack and recovery windows): fma(fmd_weight, capped
    fmd, slow_weight * slow_penalty), or at fmd_weight 1.0, where that
    multiply folds away, fma(slow_weight, slow_penalty, capped fmd).
    "slow" (the churn-free recorded heartbeats): fma(slow_weight,
    slow_penalty, fmd_weight * capped fmd)."""
    fmd = torch.clamp_max(state.fmd, params.fmd_cap)
    if product == "slow" or params.fmd_weight == 1.0:
        return fma_f32(torch.full_like(fmd, params.slow_weight),
                       state.slow_penalty, params.fmd_weight * fmd)
    return fma_f32(torch.full_like(fmd, params.fmd_weight), fmd,
                   params.slow_weight * state.slow_penalty)


def telemetry_observables(state: SimState, conns, rev, params: SimParams,
                          telemetry: TelemetryParams, valid=None,
                          decay_scales=None, deg=None,
                          contract_score: str | None = None) -> dict:
    """One round's channels as a dict of float32 0-d / 1-d tensors.
    `valid` / `deg` are the hoisted validity mask and the carried degree
    when the caller holds them; `decay_scales` the deferred-decay pair.
    `contract_score`: the calling program's score contraction
    (contracted_score's `product`; None rounds both products, as the
    churned recorded heartbeats do)."""
    f32 = torch.float32
    live = state.alive & state.subscribed
    if valid is None:
        if deg is not None:
            raise ValueError("deg requires valid (the carried-degree "
                             "protocol's hoisted validity mask)")
        nbr_ok = neighbor_pull_bool(live, conns, rev)
        valid = ((conns >= 0) & state.alive[:, None] & nbr_ok
                 & state.subscribed[:, None])
    if deg is None:
        deg = (state.mesh_mask & valid).sum(dim=-1, dtype=torch.int32)
    n_live = peer.isum(live).clamp_min(1).to(f32)

    if decay_scales is not None:
        state = state.replace(
            fmd=_apply_decay(state.fmd, decay_scales[0], params),
            slow_penalty=_apply_decay(state.slow_penalty, decay_scales[1],
                                      params))
    sc = (state.score(params) if contract_score is None
          else contracted_score(state, params, contract_score))

    b = telemetry.degree_bins
    idx = torch.clamp(deg, 0, b - 1)
    hist = peer.psum(((idx[:, None] == torch.arange(b, device=idx.device))
                      & live[:, None]).sum(dim=0, dtype=torch.int64))
    scv = torch.where(valid, sc, torch.tensor(float("nan"), device=sc.device))
    n_edges = peer.isum(valid).clamp_min(1).to(f32)
    backlog = torch.clamp_min(state.uplink_free_ms - state.t_ms, 0.0)
    zero = torch.zeros((), dtype=f32, device=sc.device)

    def isum(x):
        return peer.isum(x).to(f32)

    return {
        "tel_mesh_coverage": isum(live & (deg >= 1)) / n_live,
        "tel_mean_degree": isum(torch.where(live, deg, 0)) / n_live,
        "tel_degree_hist": hist.to(f32) / n_live,
        "tel_score_q": nanquantile_f32(scv, telemetry.quantiles),
        "tel_graylisted_frac": (
            isum(valid & (sc < params.graylist_threshold)) / n_edges),
        "tel_bytes_tx": peer.sum_f32(state.bytes_tx),
        "tel_bytes_rx": peer.sum_f32(state.bytes_rx),
        "tel_ihave": isum(state.ihave_tx),
        "tel_iwant": isum(state.iwant_tx),
        "tel_queue_depth_ms": (peer.sum_f32(torch.where(live, backlog,
                                                        zero))
                               / n_live),
    }


def adaptive_observables(state: SimState, ctrl, attacker, acting,
                         violations, px_pool_live: bool = True) -> dict:
    """The adaptive attacker's per-round channels (float32 0-d tensors):
    adv_violation_rate (violations this round per attacker),
    adv_throttled_frac (share of the cohort duty-cycled off),
    adv_regraft_attempts (cumulative re-grafts), adv_px_sybil_frac (share
    of occupied honest px_pool entries holding attacker ids; 0 where the
    window carries no live pool). `ctrl` is the AdaptiveCtrl carry,
    `acting` the (N,) flood mask, `violations` the round's count."""
    f32 = torch.float32
    n_att = peer.isum(attacker).clamp_min(1).to(f32)
    if px_pool_live:
        honest = ~attacker & state.alive & state.subscribed
        occ = (state.px_pool >= 0) & honest[:, None]
        sybil = occ & peer.all_rows(attacker)[state.px_pool.clamp_min(0)
                                              .long()]
        px_sybil_frac = (peer.isum(sybil).to(f32)
                         / peer.isum(occ).clamp_min(1).to(f32))
    else:
        px_sybil_frac = torch.zeros((), dtype=f32, device=attacker.device)
    return {
        "adv_violation_rate": peer.psum(violations).to(f32) / n_att,
        "adv_throttled_frac": (peer.isum(attacker & ~acting).to(f32)
                               / n_att),
        "adv_regraft_attempts": peer.isum(ctrl.regrafts).to(f32),
        "adv_px_sybil_frac": px_sybil_frac,
    }


def run_recorded_heartbeats(state: SimState, conns, rev, out_mask,
                            params: SimParams, steps: int,
                            telemetry: TelemetryParams | None = None):
    """run_heartbeats with the recorder: (state, trace), trace mapping each
    tel_* channel to its (steps, ...) curve. Disarmed it is run_heartbeats
    and the trace is {}."""
    if telemetry is None or not telemetry.enabled:
        return run_heartbeats(state, conns, rev, out_mask, params, steps), {}
    telemetry.validate()
    churny = params.churn_down_per_hb > 0.0 or params.churn_up_per_hb > 0.0
    nbr_ok = valid_pre = None
    if not churny:
        nbr_ok = neighbor_pull_bool(state.alive & state.subscribed, conns,
                                    rev)
        valid_pre = ((conns >= 0) & state.alive[:, None] & nbr_ok
                     & state.subscribed[:, None])
    f_sc = torch.ones((), dtype=torch.float32, device=conns.device)
    s_sc = f_sc
    rounds = []
    deg = None
    if valid_pre is not None:
        mesh0 = state.mesh_mask & valid_pre
        state = state.replace(mesh_mask=mesh0)
        deg = mesh0.sum(dim=-1, dtype=torch.int32)
    for _ in range(steps):
        if valid_pre is not None:
            state, deg = heartbeat_step(
                state, conns, rev, out_mask, params, nbr_ok=nbr_ok,
                valid_pre=valid_pre, decay_scales=(f_sc, s_sc), deg_in=deg)
        else:
            state = heartbeat_step(state, conns, rev, out_mask, params,
                                   decay_scales=(f_sc, s_sc))
        f_sc = f_sc * params.fmd_decay
        s_sc = s_sc * params.slow_decay
        # the step deferred its own end-of-round decay into the new scales
        rounds.append(telemetry_observables(
            state, conns, rev, params, telemetry, valid=valid_pre,
            decay_scales=(f_sc, s_sc), deg=deg,
            contract_score="slow" if valid_pre is not None else None))
    fmd, slow, _ = score_update(state.fmd, state.slow_penalty,
                                torch.stack([f_sc, s_sc]), params,
                                with_score=False)
    return state.replace(fmd=fmd, slow_penalty=slow), stack_obs(rounds)
