"""Latency-summary statistics: the reference awk pipeline, reimplemented.

Computes exactly what shadow/summary_latency.awk (small messages) and
shadow/summary_latency_large.awk (>=1000 B messages, run.sh:68-72 switch)
compute from a `latencies<i>` file:

  - network-wide MAX and average latency over all receive lines;
  - per message: average latency, receive count ("coverage", should == PEERS)
    and the hop-spread histogram with hop_lat = 100 ms buckets
    (summary_latency.awk:8,39); the large variant first rounds each receive
    time to the nearest 100 ms because transmit time inflates latency for big
    messages (summary_latency_large.awk:23-24);
  - large variant: per-message MAX dissemination latency and the average of
    per-message maxima — the p99-style headline stat (BASELINE.md).

Output is both a structured dict (for programmatic gates) and a text report
in the awk scripts' layout. The reference awk scripts themselves also run
unchanged on our latencies files — that is covered by tests running real awk.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np

HOP_LAT_MS = 100  # "should be consistent with shadow.yaml" (summary_latency.awk:8)


def sanitize_nonfinite(obj):
    """Recursively replace non-finite floats with None for strict-JSON
    artifact writers (json.dump refuses NaN/Inf only with allow_nan=False;
    without it they silently become invalid JSON literals).

    The canonical fix for graft-audit rule GA-A005: every artifact writer
    routes its payload through this helper (and keeps allow_nan=False as a
    backstop). Finite values pass through untouched, so the transform is
    the identity on healthy artifacts; numpy scalars are coerced to native
    Python so the sanitized payload is always json-serializable."""
    if isinstance(obj, dict):
        return {k: sanitize_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [sanitize_nonfinite(v) for v in obj]
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes, int)):
        # numpy / torch scalar: unwrap, then re-check finiteness
        try:
            return sanitize_nonfinite(obj.item())
        except (AttributeError, TypeError, ValueError):
            return obj
    return obj

# grep-style line: <path>:<lineno>:<msgId> milliseconds: <ms>
# accept both peer<i> (awk-compatible) and pod-<i> (reference topogen) naming
_LINE = re.compile(
    r"(?:peer|pod-)(\d+)/main[^:]*:(\d+):(\d+) milliseconds: (-?\d+)\s*$"
)


@dataclass
class MessageSummary:
    msg_id: int
    avg_latency_ms: float
    received: int
    max_latency_ms: int
    spread: dict[int, int] = field(default_factory=dict)  # bucket -> count


@dataclass
class LatencySummary:
    network_size: int             # max peer ordinal seen (awk's Total Nodes)
    total_messages: int
    max_latency_ms: int           # network-wide max
    avg_latency_ms: float         # network-wide average over all lines
    messages: list[MessageSummary]
    avg_max_latency_ms: float     # average of per-message maxima (large variant)

    def coverage(self) -> float:
        if not self.messages:
            return 0.0
        return sum(m.received for m in self.messages) / len(self.messages)


def parse_latencies(lines) -> tuple[list[tuple[int, int, int]], int]:
    """-> ([(peer_id, msg_id, delay_ms)], total_line_count) — non-matching
    rows are skipped like the awk numeric-$3 filter (summary_latency.awk:12-14)
    but still counted, because the awk's network-wide Average divides by NR
    (ALL lines, including any BW rows grep captured; summary_latency.awk:29)."""
    out = []
    total = 0
    for line in lines:
        total += 1
        m = _LINE.search(line)
        if m:
            out.append((int(m.group(1)), int(m.group(3)), int(m.group(4))))
    return out, total


def summarize(lines, large: bool = False) -> LatencySummary:
    rows, total_lines = parse_latencies(lines)
    if not rows:
        return LatencySummary(0, 0, 0, 0.0, [], 0.0)
    network_size = max(r[0] for r in rows)
    delays = [r[2] for r in rows]
    by_msg: dict[int, list[int]] = {}
    for _, mid, d in rows:
        by_msg.setdefault(mid, []).append(d)

    messages = []
    for mid, ds in by_msg.items():
        if large:
            # round receive times to the nearest hop_lat before bucketing
            # (summary_latency_large.awk:24); the per-message average is over
            # the ROUNDED times in the large variant (awk:48)
            rounded = [int(d / HOP_LAT_MS + 0.5) * HOP_LAT_MS for d in ds]
            spread_src = rounded
            avg = sum(rounded) / len(rounded)
        else:
            spread_src = ds
            avg = sum(ds) / len(ds)
        spread: dict[int, int] = {}
        for d in spread_src:
            # awk overwrites rather than accumulates the bucket with the last
            # (key,count) pair it visits; we accumulate — a deliberate fix,
            # noted so golden comparisons use counts from our parser only
            b = d // HOP_LAT_MS
            spread[b] = spread.get(b, 0) + 1
        messages.append(
            MessageSummary(
                msg_id=mid,
                avg_latency_ms=avg,
                received=len(ds),
                max_latency_ms=max(ds),
                spread=spread,
            )
        )

    avg_max = sum(m.max_latency_ms for m in messages) / len(messages)
    return LatencySummary(
        network_size=network_size,
        total_messages=len(messages),
        max_latency_ms=max(delays),
        avg_latency_ms=sum(delays) / total_lines,  # awk divides by NR
        messages=messages,
        avg_max_latency_ms=avg_max,
    )


def summarize_blocks(blocks, large: bool = False) -> LatencySummary:
    """summarize() of the latencies lines that (msg_id, peer_ids,
    delays_ms) blocks render to, in file order (LatenciesWriter.blocks),
    computed on the arrays: every such line parses, so the rows are the
    blocks' own, and each number is reached by the same integer sums,
    roundings and first-seen dict orders as summarize's."""
    blocks = [(int(m) & 0xFFFFFFFFFFFFFFFF, np.asarray(p, dtype=np.int64),
               np.asarray(d, dtype=np.int64)) for m, p, d in blocks]
    blocks = [b for b in blocks if len(b[1])]
    if not blocks:
        return LatencySummary(0, 0, 0, 0.0, [], 0.0)
    delays = np.concatenate([d for _, _, d in blocks])
    by_msg: dict[int, list[np.ndarray]] = {}
    for mid, _, d in blocks:
        by_msg.setdefault(mid, []).append(d)

    messages = []
    for mid, parts in by_msg.items():
        ds = np.concatenate(parts)
        if large:
            # int(d / HOP_LAT_MS + 0.5): float64 division, then truncation
            src = ((ds / HOP_LAT_MS + 0.5).astype(np.int64)) * HOP_LAT_MS
        else:
            src = ds
        buckets, first, counts = np.unique(src // HOP_LAT_MS,
                                           return_index=True,
                                           return_counts=True)
        order = np.argsort(first, kind="stable")
        messages.append(
            MessageSummary(
                msg_id=mid,
                avg_latency_ms=int(src.sum()) / len(src),
                received=len(ds),
                max_latency_ms=int(ds.max()),
                spread={int(buckets[i]): int(counts[i]) for i in order},
            )
        )

    avg_max = sum(m.max_latency_ms for m in messages) / len(messages)
    return LatencySummary(
        network_size=max(int(p.max()) for _, p, _ in blocks),
        total_messages=len(messages),
        max_latency_ms=int(delays.max()),
        avg_latency_ms=int(delays.sum()) / len(delays),
        messages=messages,
        avg_max_latency_ms=avg_max,
    )


def report(s: LatencySummary, large: bool = False) -> str:
    """Text report in the awk scripts' layout."""
    n_spread = 54 if large else 7
    out = [
        f"Total Nodes :  {s.network_size} Total Messages Published :  "
        f"{s.total_messages} Network Latency\t MAX :  {s.max_latency_ms} "
        f"\tAverage :  {s.avg_latency_ms:g}",
        "   Message ID \t       Avg Latency \t Messages Received",
    ]
    for m in s.messages:
        spread = " ".join(
            str(m.spread.get(b, 0)) for b in range(1, n_spread + 1)
        )
        out.append(
            f"{m.msg_id} \t {m.avg_latency_ms:g} \t   {m.received} spread is {spread}"
        )
    if large:
        for m in s.messages:
            out.append(f"MAX delay for  {m.msg_id} is \t {m.max_latency_ms}")
        out.append(
            f"Total Messages Published :  {s.total_messages} "
            f"Average Max Message Dissemination Latency :  {s.avg_max_latency_ms:g}"
        )
    return "\n".join(out) + "\n"


def summarize_file(path: str, large: bool = False) -> LatencySummary:
    with open(path) as f:
        return summarize(f, large=large)


def _cell(v, fmt: str = "g") -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return format(v, fmt)
    return str(v)


def _mcell(v, fmt: str = "g") -> str:
    """Milestone cell: the -1 sentinel ("never reached the milestone" /
    "family not armed", the recovery_time_ms convention) renders as an em
    dash instead of a misleading negative number. Only for columns whose
    legitimate range is non-negative — scores stay on _cell."""
    if isinstance(v, (int, float)) and not isinstance(v, bool) and v < 0:
        return "—"
    return _cell(v, fmt)


def _agg(vals, fmt: str = "g", milestone: bool = False) -> str:
    """Mean over one aggregate-row column. Milestone columns drop their -1
    sentinels first — a trial that never reached the milestone (or never
    armed the family, e.g. every zero-attacker trial) must not drag the
    average negative; all-sentinel columns render as the dash."""
    xs = [v for v in vals if v is not None]
    if milestone:
        xs = [v for v in xs if v >= 0]
        if not xs:
            return "—"
    if not xs:
        return "-"
    return format(sum(xs) / len(xs), fmt)


def report_campaign(campaign: dict) -> str:
    """Text report for an adversarial campaign (runtime/campaign.py
    CampaignResult.to_dict). Duck-typed on the dict so `summarize`-side
    tooling needs no import of the campaign module (and a JSON artifact
    reloads straight into this)."""
    hdr = (f"Attack campaign :  {campaign['scenario']}  Peers :  "
           f"{campaign['network_size']}  Graylist budget (hb) :  "
           f"{_cell(campaign.get('hb_budget'))}")
    cols = ("frac \t seed \t attackers \t coverage \t p50_ms \t inflation "
            "\t hb_gray \t recover_hb \t att_score \t evic \t px \t redial "
            "\t recover_ms \t heal_ms \t reconv_hb \t cov_part \t cov90_hb "
            "\t score_x_hb \t rt_poison")
    out = [hdr, cols]
    for t in campaign["trials"]:
        out.append(" \t ".join([
            _cell(t["fraction"]), str(t["seed"]), str(t["attackers"]),
            _cell(t["honest_coverage"], ".4f"),
            _cell(t["latency_p50_ms"], ".1f"),
            _cell(t["latency_inflation"], ".3f"),
            # milestone columns: the -1 "never reached / not armed"
            # sentinel renders as an em dash (_mcell)
            _mcell(t["hb_to_graylist"]), _mcell(t["mesh_recovery_hb"]),
            _cell(t["attacker_score_final"], ".1f"),
            # repair columns default for pre-repair artifacts (duck-typed:
            # an old JSON report still renders)
            str(t.get("mesh_evictions_total", 0)),
            str(t.get("px_grafts_total", 0)),
            str(t.get("redials_total", 0)),
            _mcell(t.get("recovery_time_ms", -1.0), ".1f"),
            # fault-injection columns (ops/faults.py); -1 = fault family
            # not scheduled in this trial, same convention as recover_ms
            _mcell(t.get("heal_time_ms", -1.0), ".1f"),
            _mcell(t.get("post_churn_reconvergence_hb", -1)),
            _mcell(t.get("coverage_under_partition", -1.0), ".3f"),
            # flight-recorder curve milestones (ops/telemetry.py); -1 =
            # recorder off or the curve never crossed inside the windows
            _mcell(t.get("coverage90_hb", -1)),
            _mcell(t.get("score_cross_hb", -1)),
            # cross-protocol DHT adversary (ops/dht_adversary.py); -1 =
            # DHT not armed for this trial
            _mcell(t.get("rtable_poison_frac", -1.0), ".4f"),
        ]))
    # one aggregate (mean) row per fraction; _agg excludes milestone
    # sentinels so zero-attacker and never-recovered trials stop dragging
    # the averages negative
    by_frac: dict = {}
    for t in campaign["trials"]:
        by_frac.setdefault(t["fraction"], []).append(t)
    for f in sorted(by_frac):
        ts = by_frac[f]

        def g(k, d=None, ts=ts):
            return [t.get(k, d) for t in ts]

        out.append(" \t ".join([
            f"mean {_cell(f)}", f"n={len(ts)}",
            _agg(g("attackers"), ".1f"),
            _agg(g("honest_coverage"), ".4f"),
            _agg(g("latency_p50_ms"), ".1f"),
            _agg(g("latency_inflation"), ".3f"),
            _agg(g("hb_to_graylist"), ".1f", milestone=True),
            _agg(g("mesh_recovery_hb"), ".1f", milestone=True),
            _agg(g("attacker_score_final"), ".1f"),
            _agg(g("mesh_evictions_total", 0), ".1f"),
            _agg(g("px_grafts_total", 0), ".1f"),
            _agg(g("redials_total", 0), ".1f"),
            _agg(g("recovery_time_ms", -1.0), ".1f", milestone=True),
            _agg(g("heal_time_ms", -1.0), ".1f", milestone=True),
            _agg(g("post_churn_reconvergence_hb", -1), ".1f",
                 milestone=True),
            _agg(g("coverage_under_partition", -1.0), ".3f",
                 milestone=True),
            _agg(g("coverage90_hb", -1), ".1f", milestone=True),
            _agg(g("score_cross_hb", -1), ".1f", milestone=True),
            _agg(g("rtable_poison_frac", -1.0), ".4f", milestone=True),
        ]))
    out.append(
        f"Trials :  {len(campaign['trials'])}  trials/s :  "
        f"{_cell(campaign.get('trials_per_s'), '.3f')}  wall :  "
        f"{_cell(campaign.get('wall_s'), '.2f')} s")
    quarantined = campaign.get("quarantined_trials") or []
    if campaign.get("degraded"):
        out.append(
            f"DEGRADED :  supervisor retries :  "
            f"{campaign.get('retries_total', 0)}  quarantined cells :  "
            f"{len(quarantined)}")
        for q in quarantined:
            out.append(
                f"  quarantined  frac {_cell(q.get('fraction'))}  seeds "
                f"{q.get('seeds')}  failures {q.get('failures')}  "
                f"{q.get('error', '')}")
    return "\n".join(out) + "\n"


def report_defense_sweep(sweep: dict) -> str:
    """Text report for a run_defense_sweep artifact (runtime/campaign.py):
    one row per swept defense config with its objective aggregates and
    membership of the Pareto front / beats-default sets. Duck-typed on
    the artifact dict like report_campaign, so a saved JSON artifact
    reloads straight into this."""
    obj = sweep.get("objectives", {})
    hdr = (f"Defense sweep :  {sweep['scenario']}  Peers :  "
           f"{sweep['network_size']}  objectives :  "
           + "  ".join(f"{k}({v})" for k, v in obj.items()))
    cols = ("idx \t d_low \t d \t d_high \t slow_w \t coverage "
            "\t bandwidth_B \t recover_ms \t recovered \t front "
            "\t beats_default")
    out = [hdr, cols]
    front = set(sweep.get("pareto", ()))
    beats = set(sweep.get("beats_default", ()))
    for i, r in enumerate(sweep["configs"]):
        out.append(" \t ".join([
            f"{i}{'*' if r.get('is_default') else ''}",
            str(r["d_low"]), str(r["d"]), str(r["d_high"]),
            _cell(r["slow_peer_penalty_weight"]),
            _cell(r["coverage"], ".4f"),
            _cell(r["bandwidth_bytes"], ".0f"),
            _mcell(r["recovery_time_ms"], ".1f"),
            _cell(r["recovered_frac"], ".2f"),
            "yes" if i in front else "",
            "yes" if i in beats else "",
        ]))
    out.append(
        f"Configs :  {len(sweep['configs'])} (* = default)  front :  "
        f"{sorted(front)}  beats default :  {sorted(beats)}  wall :  "
        f"{_cell(sweep.get('wall_s'), '.2f')} s")
    return "\n".join(out) + "\n"


def report_arena(arena: dict) -> str:
    """Text report for a run_arena_campaign artifact (runtime/campaign.py):
    one aggregate row per (scenario, protocol) cell with the objective
    columns, then the win matrix. Duck-typed on the artifact dict like
    report_campaign/report_defense_sweep, so a saved JSON artifact
    reloads straight into this (sanitized non-finite latencies render as
    the dash)."""
    obj = arena.get("objectives", {})
    hdr = (f"Protocol arena :  {' vs '.join(arena['protocols'])}  Peers :  "
           f"{arena['network_size']}  fraction :  {arena['fraction']:g}  "
           f"objectives :  " + "  ".join(f"{k}({v})"
                                         for k, v in obj.items()))
    cols = ("scenario \t protocol \t coverage \t bandwidth_B \t p50_ms "
            "\t p99_ms \t recover_ms \t trials")
    out = [hdr, cols]
    for r in arena["rows"]:
        out.append(" \t ".join([
            r["scenario"], r["protocol"],
            _cell(r["coverage"], ".4f"),
            _cell(r["bandwidth_bytes"], ".0f"),
            _cell(r["latency_p50_ms"], ".1f"),
            _cell(r["latency_p99_ms"], ".1f"),
            _mcell(r["recovery_time_ms"], ".1f"),
            str(r["trials"]),
        ]))
    for sc, wsc in arena.get("wins", {}).items():
        out.append(f"wins[{sc}] :  " + "  ".join(
            f"{k}={w}" for k, w in wsc.items()))
    wc = arena.get("win_counts", {})
    out.append(
        "Win counts :  " + "  ".join(f"{p}={c}" for p, c in wc.items())
        + f"  ties :  {arena.get('ties', 0)}  wall :  "
        f"{_cell(arena.get('wall_s'), '.2f')} s")
    return "\n".join(out) + "\n"
