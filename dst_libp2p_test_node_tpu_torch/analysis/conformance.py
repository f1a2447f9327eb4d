"""Conformance oracle: the spec-differential gate (docs/CONFORMANCE.md).

Drives BOTH sides of the faithfulness claim over the same small adversarial
instance and diffs the full state trajectory field-by-field, every round:

  spec side    ops/spec.py — the pure-numpy transcription of the GossipSub
               v1.1 transition relation (ACL2s formalization,
               arXiv:2311.08859) with the engine's PRNG stream as the
               selection oracle, so the relation becomes a function. It
               always runs on the host.
  sim side     the engine on `device` — one `differential_round`
               (heartbeat_step -> adversary_round) per heartbeat, the same
               step composition every attack runner loops over.

The harness closes the loop twice: after the per-round walk it re-runs the
REAL runner (run_attacked_heartbeats / run_adaptive_heartbeats /
run_faulted_heartbeats) from the same initial state and demands the final
states agree bit-for-bit with the per-round walk ("runner coherence") — so
a refactor of a runner's loop cannot drift from the per-round composition
without tripping the gate.

Divergence policy: every field mismatch becomes a record; records are
classified against the waiver table in docs/CONFORMANCE.md (first
fnmatch(scenario) & fnmatch(field) row wins) as `documented_choice`, or
`sim_bug` when no row matches. Any sim_bug fails the certificate — an
unwaivered divergence is a hard failure, never a warning. Certificates are
strict JSON (json.dump(allow_nan=False) over sanitize_nonfinite output):
a NaN anywhere in the artifact is itself a bug.

Comparison discipline: bool/int leaves must match EXACTLY; float leaves get
np.isclose(rtol=1e-5, atol=1e-4) — spec.py keeps every host op in float32
with the engine's op order, so observed deltas are 0 ulp and the tolerance
is headroom for fused-multiply-add contraction, not a semantic allowance.
"""

from __future__ import annotations

import fnmatch
import json
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "FLOAT_RTOL", "FLOAT_ATOL", "ARMED", "MUTANTS",
    "differential_round", "differential_adaptive_round",
    "run_scenario_differential", "run_adaptive_differential",
    "run_faults_differential", "run_churn_differential",
    "run_og_differential",
    "cross_fragment_check", "load_waivers", "classify",
    "conformance_certificate", "certificate_entry", "write_certificate",
]

FLOAT_RTOL = 1e-5
FLOAT_ATOL = 1e-4

# the armed-defense config every differential runs under (the onset-fixture
# arming of the adversary tests): thresholds live, so the score-gated
# guards (graft acceptance, graylist refusal) are real branches on both sides
ARMED = dict(slow_weight=-10.0, slow_decay=0.9, gossip_threshold=-10.0,
             publish_threshold=-20.0, graylist_threshold=-50.0)

_DEFAULT_WAIVERS = Path(__file__).resolve().parents[2] / "docs" / "CONFORMANCE.md"


# ---------------------------------------------------------------------------
# sim side: the per-round unit


def differential_round(state, conns, rev, out_mask, attacker, params, adv,
                       hb_idx, edge_ok=None):
    """One conformance heartbeat: the exact [heartbeat_step ->
    adversary_round] composition every attack runner loops over."""
    from ..ops.adversary import adversary_round
    from ..ops.heartbeat import heartbeat_step

    state = heartbeat_step(state, conns, rev, out_mask, params,
                           edge_ok=edge_ok)
    state, _obs = adversary_round(state, conns, rev, attacker, params, adv,
                                  edge_ok=edge_ok, hb_idx=hb_idx)
    return state


def differential_adaptive_round(state, ctrl, conns, rev, out_mask, attacker,
                                params, adv, hb_idx):
    """heartbeat_step -> adaptive_round with the controller carry."""
    from ..ops.adversary import adaptive_round
    from ..ops.heartbeat import heartbeat_step

    state = heartbeat_step(state, conns, rev, out_mask, params)
    (state, ctrl), _obs = adaptive_round(state, ctrl, conns, rev, attacker,
                                         params, adv, hb_idx=hb_idx)
    return state, ctrl


# ---------------------------------------------------------------------------
# trajectory diffing


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _diff_field(field, sim, spec, scenario, seed, step):
    """One field comparison -> a divergence record, or None on agreement."""
    sim = _host(sim)
    spec = _host(spec)
    if sim.dtype == bool or np.issubdtype(sim.dtype, np.integer):
        bad = sim != spec
        max_err = float(np.abs(sim.astype(np.int64)
                               - spec.astype(np.int64)).max()) if bad.any() else 0.0
    else:
        bad = ~np.isclose(sim, spec, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
        max_err = float(np.abs(sim - spec)[bad].max()) if bad.any() else 0.0
    if not bad.any():
        return None
    idx = tuple(int(v) for v in np.argwhere(bad)[0])
    return {
        "scenario": scenario, "seed": int(seed), "step": int(step),
        "field": field, "count": int(bad.sum()), "max_abs_err": max_err,
        "sim_sample": _scalar(sim[idx] if sim.shape else sim),
        "spec_sample": _scalar(spec[idx] if spec.shape else spec),
    }


def _scalar(v):
    v = np.asarray(v)
    if v.dtype == bool:
        return bool(v)
    if np.issubdtype(v.dtype, np.integer):
        return int(v)
    return float(v)


def _diff_states(sim_state, spec_st, scenario, seed, step, prefix=""):
    from ..ops.spec import SPEC_FIELDS

    divs = []
    for f in SPEC_FIELDS:
        sim = getattr(sim_state, f)
        if sim is None or spec_st.get(f) is None:
            continue
        d = _diff_field(prefix + f, sim, spec_st[f], scenario, seed, step)
        if d is not None:
            divs.append(d)
    return divs


def _walk_ref(state) -> dict:
    """The per-round walk's final state as the runner-coherence reference."""
    from ..ops.spec import SPEC_FIELDS

    return {f: _host(getattr(state, f)) for f in SPEC_FIELDS
            if getattr(state, f) is not None}


# a mutant trajectory diverges every subsequent round; cap the walk so a
# deliberately broken step yields a bounded record set, not steps*fields
_MAX_DIV_STEPS = 3


# ---------------------------------------------------------------------------
# scenario differentials


def _fixture(scenario, n, connect_to, seed, params=None, adv=None,
             warm_steps=4, fraction=0.2, publisher=3, device=None):
    """Shared trial setup: graph, armed params, warm (or cold) state, cohort.
    Mirrors the campaign's trial sequencing — warmup runs BEFORE the window
    except for cold_boot_join (mesh formation under fire), and the eclipse
    closes (eclipse_setup) after warmup, before round 0."""
    from ..ops.adversary import AdversaryParams, attacker_cohort, eclipse_setup
    from ..ops.graph import build_connection_graph
    from ..ops.heartbeat import run_heartbeats
    from ..ops.state import SimParams, graph_arrays, init_state

    dev = resolve_device(device)
    g = build_connection_graph(n, connect_to, seed=seed)
    if params is None:
        params = SimParams(n=n, capacity=g.capacity, **ARMED)
    if adv is None:
        adv = AdversaryParams(scenario=scenario)
    a = graph_arrays(g, dev)
    state = init_state(params, seed=seed, device=dev)
    if warm_steps and not adv.cold_boot:
        state = run_heartbeats(state, a["conns"], a["rev"], a["out_mask"],
                               params, warm_steps)
    att_np = attacker_cohort(n, fraction, seed=seed + 1,
                             conns=np.asarray(g.conns), publisher=publisher,
                             eclipse=adv.eclipse)
    att = torch.as_tensor(att_np, device=dev)
    if adv.eclipse:
        state = eclipse_setup(state, a["conns"], att, publisher)
    hosts = dict(conns=np.asarray(g.conns), rev=np.asarray(g.rev),
                 out_mask=np.asarray(g.out_mask), att=att_np)
    return g, params, adv, a, state, att, hosts


def run_scenario_differential(scenario, n=48, connect_to=8, seed=0, steps=8,
                              warm_steps=4, params=None, adv=None,
                              mutate=None, fraction=0.2, device=None):
    """Walk `steps` heartbeats of one attack scenario through both models
    and return the divergence records (empty == conformant).

    `mutate(pre_state, post_state) -> state` is the fault-injection hook:
    applied to the SIM side after each round, it models a spec violation in
    the engine's step (tests use it to prove the differential actually
    discriminates — see MUTANTS)."""
    from ..ops.adversary import censorship_penalty_update, run_attacked_heartbeats
    from ..ops.spec import (host_state, spec_adversary_round,
                            spec_censorship_penalty, spec_heartbeat)

    g, params, adv, a, state, att, hosts = _fixture(
        scenario, n, connect_to, seed, params, adv, warm_steps, fraction,
        device=device)
    state0 = state
    st = host_state(state)
    received = ~hosts["att"]

    divs = []
    div_steps = 0
    for i in range(steps):
        pre = state
        state = differential_round(state, a["conns"], a["rev"],
                                   a["out_mask"], att, params, adv, i)
        if mutate is not None:
            state = mutate(pre, state)
        st = spec_heartbeat(st, hosts["conns"], hosts["rev"],
                            hosts["out_mask"], params)
        st = spec_adversary_round(st, hosts["conns"], hosts["rev"],
                                  hosts["att"], params, adv, i)
        if scenario == "censorship":
            # the censorship dynamics live in the per-publish penalty
            # update, not adversary_round; one update per heartbeat is the
            # onset-test convention (the adversary tests)
            state = censorship_penalty_update(
                state, a["conns"], a["rev"], att,
                torch.as_tensor(received, device=att.device), params, adv)
            st = spec_censorship_penalty(st, hosts["conns"], hosts["rev"],
                                         hosts["att"], received, params, adv)
        step_divs = _diff_states(state, st, scenario, seed, i)
        if step_divs:
            divs.extend(step_divs)
            div_steps += 1
            if div_steps >= _MAX_DIV_STEPS:
                return divs

    if mutate is None and scenario != "censorship":
        # runner coherence: the real runner must reproduce the per-round
        # composition bit-for-bit (skipped for censorship, whose
        # per-publish update is campaign-side, outside the runner's loop)
        final, _obs = run_attacked_heartbeats(
            state0, a["conns"], a["rev"], a["out_mask"], att, params, adv,
            steps)
        divs.extend(_diff_states(final, _walk_ref(state), scenario, seed,
                                 steps, prefix="runner_coherence:"))
    return divs


def run_adaptive_differential(scenario="sybil_graft_flood", n=48,
                              connect_to=8, seed=0, steps=8, warm_steps=4,
                              fraction=0.2, device=None):
    """The AdaptivePolicy differential: heartbeat -> adaptive_round with the
    controller carry compared alongside the state (ctrl.* fields). Repair
    leaves are LIVE (evict+px armed) so the PX poisoner writes real px_pool
    rows on both sides."""
    from ..ops.adversary import (AdaptivePolicy, AdversaryParams,
                                 run_adaptive_heartbeats)
    from ..ops.graph import build_connection_graph
    from ..ops.spec import host_state, spec_adaptive_round, spec_heartbeat
    from ..ops.state import SimParams, init_adaptive_ctrl

    adv = AdversaryParams(scenario=scenario,
                          adaptive=AdaptivePolicy(enabled=True))
    g = build_connection_graph(n, connect_to, seed=seed)
    params = SimParams(n=n, capacity=g.capacity, evict=True, px=True, **ARMED)
    g, params, adv, a, state, att, hosts = _fixture(
        scenario, n, connect_to, seed, params, adv, warm_steps, fraction,
        device=device)
    state0 = state
    ctrl = init_adaptive_ctrl(n, att.device)
    st = host_state(state)
    sctrl = dict(viol_est=np.zeros(n, np.float32),
                 regrafts=np.zeros(n, np.int32),
                 px_injected=np.zeros(n, np.int32),
                 throttled_hb=np.zeros(n, np.int32))

    divs = []
    div_steps = 0
    for i in range(steps):
        state, ctrl = differential_adaptive_round(
            state, ctrl, a["conns"], a["rev"], a["out_mask"], att, params,
            adv, i)
        st = spec_heartbeat(st, hosts["conns"], hosts["rev"],
                            hosts["out_mask"], params)
        st, sctrl = spec_adaptive_round(st, sctrl, hosts["conns"],
                                        hosts["rev"], hosts["att"], params,
                                        adv, i)
        step_divs = _diff_states(state, st, "adaptive", seed, i)
        for f in ("viol_est", "regrafts", "px_injected", "throttled_hb"):
            d = _diff_field("ctrl." + f, getattr(ctrl, f), sctrl[f],
                            "adaptive", seed, i)
            if d is not None:
                step_divs.append(d)
        if step_divs:
            divs.extend(step_divs)
            div_steps += 1
            if div_steps >= _MAX_DIV_STEPS:
                return divs

    (final, fctrl), _obs = run_adaptive_heartbeats(
        state0, a["conns"], a["rev"], a["out_mask"], att, params, adv,
        steps, ctrl=init_adaptive_ctrl(n, att.device))
    divs.extend(_diff_states(final, _walk_ref(state), "adaptive", seed,
                             steps, prefix="runner_coherence:"))
    for f in ("viol_est", "regrafts", "px_injected", "throttled_hb"):
        d = _diff_field("runner_coherence:ctrl." + f, getattr(fctrl, f),
                        getattr(ctrl, f), "adaptive", seed, steps)
        if d is not None:
            divs.append(d)
    return divs


def run_faults_differential(n=48, connect_to=8, seed=0, steps=8,
                            warm_steps=4, fraction=0.2, device=None):
    """One fault family through the oracle: crash/restart + partition
    freeze/thaw + latency spike layered over a sybil graft-flood. The sim
    side is ONE run_faulted_heartbeats call (the real runner, fault hooks
    in); the spec side replays the documented body order (crash hooks ->
    freeze/thaw + edge_ok -> heartbeat -> adversary -> spike) per round,
    and the FINAL states must agree."""
    from ..ops.faults import FaultParams, fault_masks, run_faulted_heartbeats
    from ..ops.spec import (host_state, spec_adversary_round, spec_freeze,
                            spec_go_dark, spec_heartbeat,
                            spec_partition_edge_mask, spec_restart,
                            spec_spike, spec_thaw)

    faults = FaultParams(crash_frac=0.2, crash_window=(1, 3),
                         partition_frac=0.3, partition_window=(2, 5),
                         spike_frac=0.2, spike_window=(0, 4), spike_ms=250.0)
    if steps <= faults.partition_window[1]:
        raise ValueError("the faults differential needs steps > "
                         f"{faults.partition_window[1]}: the thaw must land "
                         "in the window")
    g, params, adv, a, state, att, hosts = _fixture(
        "sybil_graft_flood", n, connect_to, seed, None, None, warm_steps,
        fraction, device=device)
    masks = fault_masks(n, faults, seed=seed + 2, publisher=3)
    crash, side, spike = masks["crash"], masks["side"], masks["spike"]

    st = host_state(state)
    cross = spec_partition_edge_mask(side, hosts["conns"])
    frozen = np.zeros_like(cross)
    cs, ce = faults.crash_window
    ps, pe = faults.partition_window
    ss, se = faults.spike_window
    for hb in range(steps):
        if hb == cs:
            st = spec_go_dark(st, crash)
        if hb == ce:
            st = spec_restart(st, crash, hosts["conns"], hosts["rev"], params)
        if hb == ps:
            st, frozen = spec_freeze(st, cross)
        if hb == pe:
            st, frozen = spec_thaw(st, frozen, hosts["conns"])
        edge_ok = ~cross if ps <= hb < pe else np.ones_like(cross)
        st = spec_heartbeat(st, hosts["conns"], hosts["rev"],
                            hosts["out_mask"], params, edge_ok=edge_ok)
        st = spec_adversary_round(st, hosts["conns"], hosts["rev"],
                                  hosts["att"], params, adv, hb,
                                  edge_ok=edge_ok)
        if ss <= hb < se:
            st = spec_spike(st, spike, faults.spike_ms)

    dev = att.device
    final, _obs = run_faulted_heartbeats(
        state, a["conns"], a["rev"], a["out_mask"], att, params, adv,
        faults, torch.as_tensor(crash, device=dev),
        torch.as_tensor(side, device=dev),
        torch.as_tensor(spike, device=dev), steps)
    return _diff_states(final, st, "faults", seed, steps)


def run_churn_differential(n=48, connect_to=8, seed=0, steps=8,
                           warm_steps=4, device=None):
    """Benign churn differential: a zero-attacker walk with churn armed, so
    the k_churn_d/k_churn_u PRNG draws and the liveness-driven validity
    algebra are covered (an all-False cohort makes adversary_round the
    identity on state)."""
    from ..ops.graph import build_connection_graph
    from ..ops.state import SimParams

    g = build_connection_graph(n, connect_to, seed=seed)
    params = SimParams(n=n, capacity=g.capacity, churn_down_per_hb=0.02,
                       churn_up_per_hb=0.05, **ARMED)
    return run_scenario_differential(
        "sybil_graft_flood", n=n, connect_to=connect_to, seed=seed,
        steps=steps, warm_steps=warm_steps, params=params, fraction=0.0,
        device=device)


def run_og_differential(n=48, connect_to=8, seed=0, steps=8, warm_steps=4,
                        fraction=0.35, og_threshold=-1.0, tie_highest=False,
                        device=None):
    """Opportunistic-grafting differential: og ARMED over a sybil graft
    flood whose violation penalties drag the honest mesh median under
    `og_threshold`, so the v1.1 og rule — median probe, strict-above-median
    eligibility, top-2 by score — fires on both sides and the walk pins the
    engine to the spec's tie policy (ops/spec.opportunistic_graft_candidates:
    lowest neighbor slot among equal scores, the executable resolution of
    the ACL2s nondeterministic choice).

    The fixture is self-checking: it RAISES unless (a) the og branch
    actually fired during the walk and (b) at least one fired round held
    a DECISIVE tie (the lowest-slot and highest-slot resolutions select
    different edges) — otherwise a bitwise-clean differential would say
    nothing about the tie policy. `tie_highest=True` runs the spec side
    under the other admissible resolution; the divergence it must produce
    is the discrimination proof."""
    from ..ops.adversary import run_attacked_heartbeats
    from ..ops.graph import build_connection_graph
    from ..ops.spec import (_validity, host_state,
                            opportunistic_graft_candidates,
                            spec_adversary_round, spec_heartbeat, spec_score)
    from ..ops.state import SimParams

    g = build_connection_graph(n, connect_to, seed=seed)
    params = SimParams(n=n, capacity=g.capacity,
                       opportunistic_graft_threshold=og_threshold, **ARMED)
    g, params, adv, a, state, att, hosts = _fixture(
        "sybil_graft_flood", n, connect_to, seed, params, None, warm_steps,
        fraction, device=device)
    state0 = state
    st = host_state(state)

    divs = []
    div_steps = 0
    fired = False
    decisive = False
    for i in range(steps):
        # fixture-quality probe (advisory, pre-step state): would the og
        # rule fire here, and does the tie policy decide the selection?
        valid = _validity(st, hosts["conns"], hosts["rev"], st["alive"],
                          None)
        scores = spec_score(st, params)
        pmesh = st["mesh_mask"] & valid
        og_lo, _, _ = opportunistic_graft_candidates(
            pmesh, valid, st["backoff_until"], np.float32(st["t_ms"]),
            scores, params)
        og_hi, _, _ = opportunistic_graft_candidates(
            pmesh, valid, st["backoff_until"], np.float32(st["t_ms"]),
            scores, params, highest_slot_ties=True)
        fired = fired or bool(og_lo.any())
        decisive = decisive or bool((og_lo != og_hi).any())

        state = differential_round(state, a["conns"], a["rev"],
                                   a["out_mask"], att, params, adv, i)
        st = spec_heartbeat(st, hosts["conns"], hosts["rev"],
                            hosts["out_mask"], params,
                            og_tie_highest=tie_highest)
        st = spec_adversary_round(st, hosts["conns"], hosts["rev"],
                                  hosts["att"], params, adv, i)
        step_divs = _diff_states(state, st, "opportunistic_graft", seed, i)
        if step_divs:
            divs.extend(step_divs)
            div_steps += 1
            if div_steps >= _MAX_DIV_STEPS:
                break
    if not fired:
        raise RuntimeError(
            "og differential fixture never exercised the opportunistic-"
            "grafting branch — raise fraction or og_threshold")
    if not decisive:
        raise RuntimeError(
            "og differential fixture never held a decisive score tie — "
            "the walk cannot pin the tie policy")

    if not tie_highest and div_steps < _MAX_DIV_STEPS:
        # runner coherence, same contract as run_scenario_differential
        final, _obs = run_attacked_heartbeats(
            state0, a["conns"], a["rev"], a["out_mask"], att, params, adv,
            steps)
        divs.extend(_diff_states(final, _walk_ref(state),
                                 "opportunistic_graft", seed, steps,
                                 prefix="runner_coherence:"))
    return divs


def cross_fragment_check(n=64, connect_to=8, seed=0, fragments=3,
                         payload_bytes=60000, loss=0.25, device=None):
    """The `with_gossip AND fragments>1` shape: lossy multi-fragment
    publish with gossip recovery live. The fragment lanes are independent
    — a peer answering IWANTs for fragments f and f+1 of ONE message
    serializes each lane's answers on an independent copy of its uplink
    clock; the cross-lane coupling is deliberately uncoupled
    (ops/disseminate.py). The run is in BOUNDED delivery mode because
    `answer_wait_max_ms` is that mode's per-hop queue witness (exact mode
    repairs within-lane times and reports 0.0 by construction, which says
    nothing about the cross-lane term). When waits fire here, answers
    really queue at this shape, the uncoupling is load-bearing, and the
    record below must carry the documented_choice waiver; if no wait fires
    the shape is pinned green."""
    from ..config.topology import TopoParams, Topology
    from ..ops.disseminate import disseminate
    from ..ops.graph import build_connection_graph
    from ..ops.heartbeat import run_heartbeats
    from ..ops.state import SimParams, graph_arrays, init_state

    dev = resolve_device(device)
    g = build_connection_graph(n, connect_to, seed=seed)
    params = SimParams(n=n, capacity=g.capacity, serialize_answers=False,
                       **ARMED)
    a = graph_arrays(g, dev)
    state = init_state(params, seed=seed, device=dev)
    state = run_heartbeats(state, a["conns"], a["rev"], a["out_mask"],
                           params, 4)
    t = Topology.build(TopoParams(
        network_size=n, anchor_stages=5, min_bandwidth=50, max_bandwidth=150,
        min_latency=40, max_latency=130))
    stage = torch.as_tensor(t.stage_of_peer, device=dev)
    lat = torch.as_tensor(t.latency_ms, device=dev)
    bw = torch.as_tensor(t.bw_up_mbit, device=dev)
    s1 = int(np.asarray(t.stage_of_peer).max()) + 2
    loss_stage = torch.full((s1, s1), loss, dtype=torch.float32, device=dev)
    res, _ = disseminate(state, a["conns"], a["rev"], stage, lat, bw,
                         publisher=3, t0_ms=0.0, params=params,
                         payload_bytes=payload_bytes, fragments=fragments,
                         with_gossip=True, loss_stage=loss_stage)
    wait = float(res.answer_wait_max_ms)
    inter = int(res.answer_interleaved)
    if wait <= 0.0:
        return []
    return [{
        "scenario": "gossip_fragments", "seed": int(seed), "step": -1,
        "field": "cross_fragment_answer_serialization",
        "count": max(inter, 1), "max_abs_err": wait,
        "sim_sample": wait, "spec_sample": 0.0,
    }]


# ---------------------------------------------------------------------------
# mutants: deliberately broken steps the differential must catch


def _drop_prune_backoff(pre, post):
    """Violates the PRUNE backoff rule: the engine 'forgets' to write
    backoff_until, so a pruned edge is immediately re-graftable."""
    return post.replace(backoff_until=pre.backoff_until)


def _drop_violation_penalty(pre, post):
    """Violates the behaviour-penalty rule (and decay): slow_penalty rolls
    back to its pre-round value every heartbeat."""
    return post.replace(slow_penalty=pre.slow_penalty)


MUTANTS = {
    "drop_prune_backoff": _drop_prune_backoff,
    "drop_violation_penalty": _drop_violation_penalty,
}


# ---------------------------------------------------------------------------
# waivers + classification


def load_waivers(path=None):
    """Parse the docs/CONFORMANCE.md waiver table: markdown rows of
    | `key` | scenario-glob | field-glob | rationale |. Returns the rows in
    file order (first match wins)."""
    path = Path(path) if path is not None else _DEFAULT_WAIVERS
    if not path.exists():
        return []
    rows = []
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line.startswith("|"):
            continue
        cells = [c.strip().strip("`").strip() for c in line.strip("|").split("|")]
        if len(cells) < 4:
            continue
        if cells[0].lower() in ("key", "waiver key") or set(cells[0]) <= {"-", ":", " "}:
            continue
        rows.append({"key": cells[0], "scenario": cells[1],
                     "field": cells[2], "rationale": cells[3]})
    return rows


def classify(divergences, waivers):
    """Attach classification to each record: the first waiver row whose
    scenario AND field globs both match makes it a documented_choice;
    anything unmatched is a sim_bug."""
    out = []
    for d in divergences:
        d = dict(d)
        waiver = next(
            (w for w in waivers
             if fnmatch.fnmatch(d["scenario"], w["scenario"])
             and fnmatch.fnmatch(d["field"], w["field"])), None)
        if waiver is not None:
            d["classification"] = "documented_choice"
            d["waiver"] = waiver["key"]
        else:
            d["classification"] = "sim_bug"
            d["waiver"] = None
        out.append(d)
    return out


def certificate_entry(scenario, divergences, waivers, **meta):
    divs = classify(divergences, waivers)
    bugs = sum(1 for d in divs if d["classification"] == "sim_bug")
    status = ("fail" if bugs else ("waived" if divs else "pass"))
    return dict(scenario=scenario, status=status, sim_bugs=bugs,
                divergences=divs, **meta)


# ---------------------------------------------------------------------------
# parameter-grid fuzzing: random SimParams through the same differential


def sample_sim_params(rng, capacity):
    """One random parameter grid for the differential, as a kwargs dict.

    The degree lattice respects the v1.1 invariants the router assumes:
    0 < d_low <= d <= d_high <= capacity, d_score <= d, and
    d_out < d_low with d_out <= d/2 (the outbound-quota constraints the
    reference enforces at config time). Score knobs stay in the armed
    regime — negative penalty weight, ordered thresholds
    gossip >= publish >= graylist — so every score-gated branch remains a
    live branch on both sides of the differential."""
    d_low = int(rng.integers(1, min(6, capacity) + 1))
    d = int(rng.integers(d_low, min(capacity, d_low + 6) + 1))
    d_high = int(rng.integers(d, capacity + 1))
    d_score = int(rng.integers(1, d + 1))
    d_out = int(rng.integers(1, max(1, min(d_low - 1, d // 2)) + 1))
    d_lazy = int(rng.integers(1, capacity + 1))
    gossip_threshold = round(float(rng.uniform(-20.0, -2.0)), 3)
    publish_threshold = round(
        gossip_threshold - float(rng.uniform(1.0, 20.0)), 3)
    graylist_threshold = round(
        publish_threshold - float(rng.uniform(1.0, 40.0)), 3)
    return dict(
        d=d, d_low=d_low, d_high=d_high, d_score=d_score, d_out=d_out,
        d_lazy=d_lazy,
        gossip_factor=round(float(rng.uniform(0.05, 0.5)), 3),
        slow_weight=round(float(rng.uniform(-20.0, -1.0)), 3),
        slow_decay=round(float(rng.uniform(0.1, 0.95)), 3),
        gossip_threshold=gossip_threshold,
        publish_threshold=publish_threshold,
        graylist_threshold=graylist_threshold,
    )


def run_fuzz_differential(n_samples, n=48, connect_to=8, seed=0, steps=8,
                          warm_steps=4, fuzz_seed=0, device=None):
    """`n_samples` random parameter grids through the scenario differential.

    Returns [(entry_name, knobs, divergences)] — one differential instance
    per sample, cycling through the attack canon so every scenario's
    branches meet fuzzed degree bounds / gossip factor / score weights, not
    just the ARMED point the fixed certificate pins. Deterministic in
    fuzz_seed (np.random.default_rng stream; graph/state/cohort reseed from
    `seed` exactly as the fixed entries do)."""
    from ..ops.adversary import SCENARIOS
    from ..ops.graph import build_connection_graph
    from ..ops.state import SimParams

    rng = np.random.default_rng(fuzz_seed)
    # capacity is a property of the topology, not a fuzzable knob: the
    # fixture will rebuild this exact graph (same n/connect_to/seed)
    g = build_connection_graph(n, connect_to, seed=seed)
    out = []
    for k in range(n_samples):
        knobs = sample_sim_params(rng, g.capacity)
        scenario = SCENARIOS[k % len(SCENARIOS)]
        params = SimParams(n=n, capacity=g.capacity, **knobs)
        divs = run_scenario_differential(
            scenario, n=n, connect_to=connect_to, seed=seed, steps=steps,
            warm_steps=warm_steps, params=params, device=device)
        out.append((f"fuzz:{scenario}:{k}", knobs, divs))
    return out


# ---------------------------------------------------------------------------
# the certificate


def conformance_certificate(scenarios=None, n=48, connect_to=8, seeds=(0,),
                            steps=8, warm_steps=4, waivers_path=None,
                            include_adaptive=True, include_faults=True,
                            include_churn=True, include_gossip=True,
                            include_og=True, fuzz=0, fuzz_seed=0,
                            device=None):
    """Run the full conformance fuzz sweep and build the certificate dict:
    every attack scenario x every seed through the per-round differential,
    plus the adaptive-controller, fault-family, churn, opportunistic-graft
    and cross-fragment entries. fuzz>0 appends that many random-parameter-
    grid entries (run_fuzz_differential). The sim side runs on `device`
    (CUDA unless the caller passes another). Strict-JSON-safe after
    sanitize_nonfinite (write_certificate)."""
    from ..ops.adversary import SCENARIOS

    dev = resolve_device(device)
    if scenarios is None:
        scenarios = SCENARIOS
    waivers = load_waivers(waivers_path)
    kw = dict(n=n, connect_to=connect_to, steps=steps,
              warm_steps=warm_steps, device=dev)
    meta = dict(seeds=list(seeds), n=n, steps=steps)
    entries = []
    for scenario in scenarios:
        divs = []
        for s in seeds:
            divs.extend(run_scenario_differential(scenario, seed=s, **kw))
        entries.append(certificate_entry(scenario, divs, waivers, **meta))
    for name, include, run in (
            ("adaptive", include_adaptive, run_adaptive_differential),
            ("faults", include_faults, run_faults_differential),
            ("churn", include_churn, run_churn_differential),
            ("opportunistic_graft", include_og, run_og_differential)):
        if not include:
            continue
        divs = []
        for s in seeds:
            divs.extend(run(seed=s, **kw))
        entries.append(certificate_entry(name, divs, waivers, **meta))
    if include_gossip:
        divs = cross_fragment_check(seed=seeds[0], device=dev)
        entries.append(certificate_entry("gossip_fragments", divs, waivers,
                                         seeds=[seeds[0]], n=64, steps=1))
    if fuzz:
        for name, knobs, divs in run_fuzz_differential(
                fuzz, seed=seeds[0], fuzz_seed=fuzz_seed, **kw):
            entries.append(certificate_entry(
                name, divs, waivers, seeds=[seeds[0]], n=n, steps=steps,
                params=knobs, fuzz_seed=fuzz_seed))
    sim_bugs = sum(e["sim_bugs"] for e in entries)
    return {
        "version": 1,
        "oracle": "ops/spec.py pure-numpy GossipSub v1.1 transition relation "
                  "(ACL2s transcription, arXiv:2311.08859; PRNG-stream "
                  "selection oracle)",
        "float_rtol": FLOAT_RTOL,
        "float_atol": FLOAT_ATOL,
        "entries": entries,
        "sim_bugs": sim_bugs,
        "clean": sim_bugs == 0,
    }


def write_certificate(cert, path):
    """Strict-JSON certificate artifact: sanitize_nonfinite maps any
    non-finite float to null FIRST, then allow_nan=False proves no NaN/inf
    survived anywhere in the tree."""
    from ..runtime.summarize import sanitize_nonfinite

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(sanitize_nonfinite(cert), f, indent=2, allow_nan=False)
        f.write("\n")
    return path
