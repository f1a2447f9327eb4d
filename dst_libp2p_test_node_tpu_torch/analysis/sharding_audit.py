"""The sharding auditor (GA-S rules) and the rung predictor: the port's
twin of the reference's analysis/sharding_audit.py.

The reference compiles each contract under GSPMD and walks the HLO for
the collectives XLA inserted. The port has no partitioner: its
collectives are explicit (parallel/peer.py), so the auditor RUNS each
contract's spec once and reads what happened, from three sources:

  placement     every nested window notes the placement it used
                (parallel/sharding.describe_placement: per leaf, its
                global and per-rank bytes, partitions per dim, whether
                every running rank holds it whole)
  collectives   each rank job sends back its collectives by kind and by
                the global ranks of their group, with their bytes
                (parallel/ranks.RankPool.recording, peer.ledger)
  memory        on a card, each rank's peak allocated-memory rise over
                the job (torch.cuda.max_memory_allocated); on the CPU
                there is no allocator peak ("peak_measured": false)

Rules (declarations on analysis/contracts.EntrypointContract):

  GA-S001  an operand of at least REPLICATED_FLOOR_BYTES held whole by
           every rank that runs a window of more than one rank
  GA-S002  a collective kind that ran but is not in ``collectives``
  GA-S003  one rank's collective bytes over ``collective_bytes_budget``
  GA-S004  one rank's peak rise over ``hbm_budget_bytes`` (on a card)
  GA-S006  collective bytes whose group spans two ``dcn_block_devices``
           blocks of ranks (rank // block), over
           ``dcn_collective_bytes_budget``

GA-S005 (a declared donation XLA dropped) has no torch meaning: torch
has no buffer donation, so nothing can be dropped. A finding whose rule
a contract waives lands in the report's "waived" block with the
rationale.

The rung predictor (`predict_rung_certificate`) runs the attack (or
arena) window at 3-4 peer counts on the 2 x 2 audit grid, fits a power
law per input leaf's global bytes and per rank's output and temp bytes,
holds out the largest point (within 10%, the reference's bar) and
extrapolates to the rung on a modeled node of 8 H100 80GB HBM3 GPUs (2
trial groups x 4 peer ranks), or `dcn` such nodes.
"""

from __future__ import annotations

import gc
import math
import subprocess

import torch

from ..device import resolve_device
from .contracts import EntrypointContract
from .jaxpr_audit import (_src_anchor, check_feedback, run_spec,
                          spec_device, spec_pool)
from .report import Violation

# operands below this are per-trial scalars and constants whose
# replication is the intended layout; at the audit shapes anything >= 2 KiB
# is a real per-peer table
REPLICATED_FLOOR_BYTES = 2048


def _run_recorded(spec):
    """Run the spec once: (outputs, placements, jobs, caller's peak rise
    or None). `jobs`: per pool job, per rank, the rank's facts. On a card
    the cyclic garbage collector is paused around the run (as the ranks
    pause it around a recorded job), so a peak does not depend on when it
    runs."""
    from ..parallel.sharding import recording_placements

    pool = spec_pool(spec)
    dev = spec_device(spec)
    if dev.type == "cuda":
        gc.collect()
        gc.disable()
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        with recording_placements() as placements:
            if pool is None:
                jobs: list = []
                out = run_spec(spec)
            else:
                with pool.recording() as jobs:
                    out = run_spec(spec)
    finally:
        if dev.type == "cuda":
            gc.enable()
    rise = (torch.cuda.max_memory_allocated(dev) - base
            if dev.type == "cuda" else None)
    return out, placements, jobs, rise


def _per_rank(jobs: list, size: int) -> list[dict]:
    """Each rank's facts over every job: collectives by kind and by group,
    its peak rise and its output bytes (max over jobs; peak None
    unmeasured)."""
    ranks = [{"kinds": {}, "groups": {}, "peak": None, "outs": 0}
             for _ in range(size)]
    for job in jobs:
        for r, facts in enumerate(job):
            if facts is None:
                continue
            mine = ranks[r]
            for c in facts["collectives"]:
                k = mine["kinds"].setdefault(c["kind"],
                                             {"count": 0, "bytes": 0})
                k["count"] += c["count"]
                k["bytes"] += c["bytes"]
                g = mine["groups"].setdefault(
                    (c["kind"], tuple(c["ranks"])), [0, 0])
                g[0] += c["count"]
                g[1] += c["bytes"]
            if facts["peak_rise"] is not None:
                mine["peak"] = max(mine["peak"] or 0, facts["peak_rise"])
            mine["outs"] = max(mine["outs"], facts["result_bytes"])
    return ranks


def contract_sharding_facts(contract: EntrypointContract, *,
                            repl_floor_bytes: int = REPLICATED_FLOOR_BYTES
                            ) -> dict:
    """Run the contract's spec once and collect its facts block (strict
    JSON). Pure measurement: the rules are `sharding_findings`."""
    return _audited_run(contract, repl_floor_bytes)[2]


def _audited_run(contract: EntrypointContract, repl_floor_bytes: int):
    """(spec, outputs, facts) of one recorded run of the contract."""
    spec = contract.build()
    pool = spec_pool(spec)
    out, placements, jobs, caller_rise = _run_recorded(spec)
    size = pool.size if pool is not None else 1
    ranks = _per_rank(jobs, size)
    operands = [leaf for p in placements for leaf in p]
    running = sorted({r for job in jobs for r, f in enumerate(job)
                      if f is not None}) or [0]
    kinds: dict = {}
    for rk in ranks:
        for kind, c in rk["kinds"].items():
            k = kinds.setdefault(kind, {"count": 0, "per_rank_bytes": 0})
            k["count"] = max(k["count"], c["count"])
            k["per_rank_bytes"] = max(k["per_rank_bytes"], c["bytes"])
    rank_bytes = [sum(c["bytes"] for c in rk["kinds"].values())
                  for rk in ranks]
    if pool is None:
        peaks = [caller_rise]
    else:
        peaks = [ranks[r]["peak"] for r in running]
    measured = all(p is not None for p in peaks)
    facts = {
        "ranks": size,
        "running_ranks": len(running),
        "collectives": kinds,
        "collective_bytes": max(rank_bytes) if rank_bytes else 0,
        "rank_collective_bytes": rank_bytes,
        "memory": {"peak_measured": measured,
                   "rank_peak_bytes": peaks if measured else None,
                   "peak": max(peaks) if measured else None},
        "replicated_operands": [
            {"name": o["name"], "bytes": o["global_bytes"]}
            for o in operands
            if o["replicated"] and o["global_bytes"] >= repl_floor_bytes],
        "operands": len(operands),
        "argument_bytes_per_rank": max(
            [sum(o["rank_bytes"][i] for o in operands)
             for i in range(len(running))] or [0]),
    }
    if contract.dcn_block_devices:
        block = int(contract.dcn_block_devices)
        cross, intra = [], []
        cross_kinds: dict = {}
        for rk in ranks:
            c_b = i_b = 0
            for (kind, group), (count, nbytes) in rk["groups"].items():
                if len({g // block for g in group}) > 1:
                    c_b += nbytes
                    cross_kinds[kind] = max(cross_kinds.get(kind, 0), count)
                else:
                    i_b += nbytes
            cross.append(c_b)
            intra.append(i_b)
        facts["collective_bytes_by_scope"] = {
            "intra_block": max(intra), "cross_dcn": max(cross)}
        facts["cross_dcn_collectives"] = cross_kinds
    return spec, out, facts


def sharding_findings(contract: EntrypointContract, facts: dict,
                      file: str = "<unknown>", line: int = 0
                      ) -> list[Violation]:
    """The GA-S findings of a facts block (waivers not applied)."""
    found: list[Violation] = []

    def add(rule, message):
        found.append(Violation(rule=rule, file=file, line=line,
                               entrypoint=contract.name, message=message))

    if facts["running_ranks"] > 1:
        for rep in facts["replicated_operands"]:
            add("GA-S001",
                f"operand {rep['name']} ({rep['bytes']} B) is held whole "
                f"by all {facts['running_ranks']} ranks that run this "
                "window — every rank pays its full footprint")
    if contract.collectives is not None:
        declared = {str(k) for k in contract.collectives}
        for kind in sorted(facts["collectives"]):
            if kind not in declared:
                c = facts["collectives"][kind]
                add("GA-S002",
                    f"{c['count']} {kind} collective(s) "
                    f"({c['per_rank_bytes']} B on a rank) ran, not in the "
                    f"contract's declared collectives {sorted(declared)}")
    if contract.collective_bytes_budget is not None:
        total = facts["collective_bytes"]
        if total > contract.collective_bytes_budget:
            add("GA-S003",
                f"a rank's collectives moved {total} B, over the declared "
                f"budget of {contract.collective_bytes_budget} B at the "
                "audit shape")
    mem = facts["memory"]
    if contract.hbm_budget_bytes is not None and mem["peak_measured"]:
        if mem["peak"] > contract.hbm_budget_bytes:
            add("GA-S004",
                f"a rank's peak device memory rose {mem['peak']} B, over "
                f"the declared budget of {contract.hbm_budget_bytes} B at "
                "the audit shape")
    if contract.dcn_block_devices:
        cross = facts["collective_bytes_by_scope"]["cross_dcn"]
        if cross > contract.dcn_collective_bytes_budget:
            add("GA-S006",
                f"collectives {sorted(facts['cross_dcn_collectives'])} move "
                f"{cross} B on a rank across the dcn axis (groups spanning "
                f">= 2 blocks of {contract.dcn_block_devices} ranks) — "
                f"budget {contract.dcn_collective_bytes_budget} B; "
                "peer-axis traffic must stay inside one block")
    return found


def apply_waivers(contract: EntrypointContract, found: list[Violation]
                  ) -> tuple[list[Violation], list[dict]]:
    """(violations, waived): findings whose rule the contract waives move
    to `waived`, each with the pinned rationale."""
    why = {rule: text for rule, text in contract.waivers}
    violations, waived = [], []
    for v in found:
        if v.rule in why:
            w = v.to_dict()
            w["rationale"] = why[v.rule]
            waived.append(w)
        else:
            violations.append(v)
    return violations, waived


def audit_sharding_contract(
        contract: EntrypointContract, *,
        repl_floor_bytes: int = REPLICATED_FLOOR_BYTES,
        feedback: bool = False,
) -> tuple[list[Violation], list[dict], dict]:
    """(violations, waived, facts) of one contract under the GA-S rules;
    with `feedback`, the contract engine's feedback check (GA-J005) on the
    same run, so one run serves both engines."""
    spec, out, facts = _audited_run(contract, repl_floor_bytes)
    file, line = _src_anchor(spec.fn)
    violations, waived = apply_waivers(
        contract, sharding_findings(contract, facts, file, line))
    if feedback:
        violations = check_feedback(contract, spec, out, file,
                                    line) + violations
    return violations, waived, facts


def audit_sharding_contracts(
        contracts, *, repl_floor_bytes: int = REPLICATED_FLOOR_BYTES,
        feedback: bool = False,
) -> tuple[list[Violation], list[dict], dict]:
    """Audit many contracts: (violations, waived, facts by name). A
    contract that fails to run is a GA-J001 finding with an `error` fact
    (the report keeps going)."""
    violations: list[Violation] = []
    waived: list[dict] = []
    facts: dict = {}
    for c in contracts:
        try:
            v, w, f = audit_sharding_contract(
                c, repl_floor_bytes=repl_floor_bytes, feedback=feedback)
        except Exception as e:  # noqa: BLE001 — reported as a finding
            file, line = _src_anchor(c.build().fn)
            facts[c.name] = {"error": repr(e)[:200]}
            violations.append(Violation(
                rule="GA-J001", file=file, line=line, entrypoint=c.name,
                message=f"entrypoint failed to run under the sharding "
                        f"auditor: {e!r}"))
            continue
        violations.extend(v)
        waived.extend(w)
        facts[c.name] = f
    return violations, waived, facts


# ------------------------------------------------------------ rung predictor

# the modeled target: one node of 8 H100 80GB HBM3 GPUs as config 8's grid,
# 2 trial groups of 4 peer ranks each
RUNG_PEERS = 1_048_576
# `lint --predict-rung`'s fit points, above the reference's 64-512: on a card
# the temp part is a rank's peak rise, which moved by up to 10% between
# repeats at 512-1,024 peers on an H100 (the garbage collector's timing,
# now paused in a measured job); at 512-4,096 such noise is a few percent
# of the held-out point
RUNG_FIT_POINTS = (512, 1024, 2048, 4096)
RUNG_TRIAL_GROUPS = 2
RUNG_PEER_WIDTH = 4
H100_GPUS = RUNG_TRIAL_GROUPS * RUNG_PEER_WIDTH
H100_NAME = "H100 80GB HBM3"
# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (chip_smoke.py phase 17(d) checks it against the card)
H100_HBM_BYTES = 85_017_493_504


def fit_power_law(ns, ys) -> tuple[float, float]:
    """(coeff, exponent) of y = coeff * n**exponent by least squares in
    log2-log2 space. A constant series fits exactly as exponent 0; an
    all-zero series returns (0, 0)."""
    pts = [(n, y) for n, y in zip(ns, ys) if y > 0]
    if not pts:
        return 0.0, 0.0
    if len(pts) == 1 or len({y for _, y in pts}) == 1:
        return float(pts[0][1]), 0.0
    lx = [math.log2(n) for n, _ in pts]
    ly = [math.log2(y) for _, y in pts]
    k = len(pts)
    mx, my = sum(lx) / k, sum(ly) / k
    sxx = sum((x - mx) ** 2 for x in lx)
    sxy = sum((x - mx) * (y - my) for x, y in zip(lx, ly))
    p = sxy / sxx if sxx else 0.0
    a = 2.0 ** (my - p * mx)
    return float(a), float(p)


def _eval_fit(fit: tuple[float, float], n: int) -> float:
    a, p = fit
    return a * float(n) ** p


def _rung_partitions(leaf: dict, trials: int, mesh_shape: dict,
                     dcn: int = 1) -> tuple[int, bool]:
    """(partition count on the MODELED rung grid, trial-axis flag) of one
    input leaf, from its partitions per dim on the audit grid: dim 0 of
    the stacked trial count is the trial axis (its count grows to the
    rung's trial groups, times `dcn`), any other partitioned dim the peer
    axis (its count grows to the rung's peer width)."""
    g_cur = int(mesh_shape.get("trials", 1))
    per_dim = leaf["partitions_per_dim"]
    shape = leaf["shape"]
    factor, on_trials = 1, False
    for d, (size, parts) in enumerate(zip(shape, per_dim)):
        if parts <= 1:
            continue
        on_trial_axis = (d == 0 and size == trials and parts <= g_cur)
        if on_trial_axis:
            on_trials = True
            factor *= RUNG_TRIAL_GROUPS * dcn
        else:
            factor *= RUNG_PEER_WIDTH
    return factor, on_trials


def card_identity() -> str:
    """The card's name and power limit as nvidia-smi gives them
    (name, power.limit); "cpu" where no card is visible."""
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _fit_point(spec) -> dict:
    """One fit point: every input leaf's placement facts, and the
    measured rank's (the one with the largest total) argument, output
    and temp bytes; temp is its peak rise beyond its arguments and
    outputs, on a card only."""
    pool = spec_pool(spec)
    _out, placements, jobs, _rise = _run_recorded(spec)
    operands = [leaf for p in placements for leaf in p]
    ranks = _per_rank(jobs, pool.size)
    running = sorted({r for job in jobs for r, f in enumerate(job)
                      if f is not None})
    best = None
    for i, r in enumerate(running):
        args = sum(o["rank_bytes"][i] for o in operands)
        outs = ranks[r]["outs"]
        peak = ranks[r]["peak"]
        temp = 0 if peak is None else max(0, peak - args - outs)
        cand = {"arguments": args, "outputs": outs, "temp": temp,
                "peak": peak}
        if best is None or (args + outs + temp
                            > best["arguments"] + best["outputs"]
                            + best["temp"]):
            best = cand
    return {"operands": operands, "memory": best,
            "temp_measured": all(ranks[r]["peak"] is not None
                                 for r in running)}


def rung_fit_points(peer_counts, spec_builder) -> list[dict]:
    """The measured fit points of `spec_builder(n)` at each peer count
    (sorted): per point its peers, every input leaf's placement facts and
    the measured rank's argument, output and temp bytes."""
    points = []
    for n in sorted(int(n) for n in peer_counts):
        pt = _fit_point(spec_builder(n))
        pt["peers"] = n
        points.append(pt)
    return points


def predict_rung_certificate(
        peer_counts=(64, 128, 256, 512), *, rung_peers: int = RUNG_PEERS,
        steps: int = 20, connect_to: int = 10, local_trials: int = 2,
        hbm_bytes: int = H100_HBM_BYTES, spec_builder=None, dcn: int = 1,
        scenario: str = "sybil_graft_flood", grid=None,
        device=None) -> dict:
    """Run the config-8 attack window (or `spec_builder(n)`'s) at several
    peer counts on the 2 x 2 `grid` (a RankPool), and certify the rung
    from those fit points (`rung_certificate`)."""
    from .registry import attack_rung_spec

    if grid is None:
        raise ValueError("the rung predictor runs on a 2 x 2 rank pool: "
                         "pass grid=")
    if spec_builder is None:
        def spec_builder(n):
            return attack_rung_spec(
                n, steps=steps, connect_to=connect_to,
                local_trials=local_trials, grid=grid, device=device)

    if len(peer_counts) < 3:
        raise ValueError("need >= 3 peer counts to fit and validate")
    return rung_certificate(
        rung_fit_points(peer_counts, spec_builder), rung_peers=rung_peers,
        steps=steps, connect_to=connect_to, local_trials=local_trials,
        hbm_bytes=hbm_bytes, dcn=dcn, scenario=scenario, grid=grid,
        device=device)


def rung_certificate(
        points: list, *, rung_peers: int = RUNG_PEERS, steps: int = 20,
        connect_to: int = 10, local_trials: int = 2,
        hbm_bytes: int = H100_HBM_BYTES, dcn: int = 1,
        scenario: str = "sybil_graft_flood", grid, device=None) -> dict:
    """The strict-JSON rung certificate for a modeled node of 8 H100
    80GB HBM3 GPUs (`dcn` such nodes), from `rung_fit_points` measured on
    the 2 x 2 `grid` with `local_trials` trials a group.

    Per fit point: every input leaf's global bytes (grid-independent),
    the measured rank's output bytes and, on a card, its temp bytes.
    Input leaves extrapolate as global_fit(rung_peers) / their partitions
    on the rung grid. Outputs are row blocks of the trials a rank runs:
    they rescale by the audit grid's peer width over the rung's. Temp is
    held per rank as measured, not rescaled: the port's host-staged
    gathers hold whole (N, ...) tables whatever the width (the reference
    divides both by the width ratio, exact at its 1:1 audit grid). The
    largest point is held out to validate the fit (within 10%); the
    final extrapolation refits on every point. With `dcn` > 1 a
    trial-axis leaf's global bytes and partitions both grow dcn-fold."""
    if len(points) < 3:
        raise ValueError("need >= 3 peer counts to fit and validate")
    if dcn < 1:
        raise ValueError(f"dcn must be >= 1, got {dcn}")
    mesh_shape = {"trials": grid.groups, "peers": grid.peer_width}
    trials = RUNG_TRIAL_GROUPS * local_trials
    audit_trials = grid.groups * local_trials
    width_scale = mesh_shape["peers"] / RUNG_PEER_WIDTH

    names = [o["name"] for o in points[0]["operands"]]
    if any([o["name"] for o in pt["operands"]] != names for pt in points):
        raise RuntimeError("operand tree drifted across fit points")

    def predict_per_rank(pts, n):
        """The fitted per-rank total at n on the audit grid."""
        ns = [pt["peers"] for pt in pts]
        total = 0.0
        for i in range(len(names)):
            fit = fit_power_law(ns, [pt["operands"][i]["global_bytes"]
                                     for pt in pts])
            parts = max(pt["operands"][i]["global_bytes"]
                        // max(pt["operands"][i]["rank_bytes"][0], 1)
                        for pt in pts) or 1
            total += _eval_fit(fit, n) / parts
        for key in ("outputs", "temp"):
            total += _eval_fit(fit_power_law(
                ns, [pt["memory"][key] for pt in pts]), n)
        return total

    held = points[-1]
    predicted = predict_per_rank(points[:-1], held["peers"])
    measured = sum(held["memory"][k] for k in ("arguments", "outputs",
                                               "temp"))
    rel_err = abs(predicted - measured) / max(measured, 1)

    ns_all = [pt["peers"] for pt in points]
    leaves_out = []
    arg_total = 0.0
    for i, name in enumerate(names):
        ys = [pt["operands"][i]["global_bytes"] for pt in points]
        fit = fit_power_law(ns_all, ys)
        parts, on_trials = _rung_partitions(
            points[-1]["operands"][i], audit_trials, mesh_shape, dcn=dcn)
        pred_global = _eval_fit(fit, rung_peers)
        if on_trials:
            pred_global *= dcn
        pred_dev = pred_global / parts
        arg_total += pred_dev
        leaves_out.append({
            "name": name,
            "bytes_at_largest_fit_point": ys[-1],
            "coeff": round(fit[0], 6),
            "exponent": round(fit[1], 6),
            "rung_partitions": parts,
            "predicted_global_bytes": int(pred_global),
            "predicted_per_device_bytes": int(pred_dev),
        })
    leaves_out.sort(key=lambda x: (-x["predicted_per_device_bytes"],
                                   x["name"]))
    mem_out = {}
    for key, scale in (("outputs", width_scale), ("temp", 1.0)):
        fit = fit_power_law(ns_all, [pt["memory"][key] for pt in points])
        mem_out[key] = int(_eval_fit(fit, rung_peers) * scale)
    total = int(arg_total) + mem_out["outputs"] + mem_out["temp"]
    temp_measured = all(pt["temp_measured"] for pt in points)
    return {
        "rung": {
            "peers": int(rung_peers), "trials": trials * dcn,
            "trial_groups": RUNG_TRIAL_GROUPS,
            "peer_width": RUNG_PEER_WIDTH,
            "dcn": int(dcn),
            "attack_heartbeats": int(steps),
            "connect_to": int(connect_to),
            "scenario": scenario,
        },
        "modeled_device": {
            "name": (f"{H100_GPUS}x {H100_NAME}" if dcn == 1
                     else f"{dcn} x {H100_GPUS}x {H100_NAME}"),
            "chips": H100_GPUS * dcn,
            "hbm_bytes_per_chip": int(hbm_bytes),
        },
        "measured_on": (card_identity() if resolve_device(device).type
                        == "cuda" else "cpu"),
        "temp_measured": temp_measured,
        "audit_grid": mesh_shape,
        "fit_points": [
            dict({k: pt["memory"][k] for k in ("arguments", "outputs",
                                                "temp")},
                 peers=pt["peers"],
                 per_device_peak_bytes=sum(pt["memory"][k] for k in (
                     "arguments", "outputs", "temp")))
            for pt in points],
        "validation": {
            "peers": held["peers"],
            "predicted_per_device_bytes": int(predicted),
            "measured_per_device_bytes": int(measured),
            "rel_err": round(rel_err, 6),
            "within_10pct": bool(rel_err <= 0.10),
        },
        "leaves": leaves_out,
        "predicted_per_device": {
            "arguments": int(arg_total),
            "outputs": mem_out["outputs"],
            "temp": mem_out["temp"],
            "total": total,
        },
        "hbm_utilization": round(total / hbm_bytes, 6),
        "verdict": "fits" if total <= hbm_bytes else "does-not-fit",
    }
