"""ETH2-style sustained traffic model and the service overload/chaos load
generator.

The port of the reference's runtime/traffic.py. The reference's
deployments serve a production pub/sub workload, and the canonical one is
the Ethereum consensus gossip mix: beacon blocks, aggregate attestations,
sync-committee messages, and 64 attestation subnets, each its own topic
with its own message size and rate (Topiary, arXiv:2312.06800, measures
this mix at scale). This module turns that mix into a deterministic
request schedule and drives the resident NodeService
(runtime/node_service.py) with it: sustained load, deliberate overload,
forced dispatch failures, and kill-and-restart chaos, measuring sustained
requests/s, p50/p99 sojourn, shed rate, and warm-restart bit-identity.

Everything here is host-side orchestration over the public service surface
(HTTP or in-process submit/pump); the device never sees the traffic model.
The simulators live on `device` (CUDA unless the caller passes "cpu").

Determinism: the schedule is a pure function of (mix, ticks, per_tick,
seed); request deadlines are sim-time; admission is depth-bounded (the
wall-clock EWMA budget stays off in comparison runs), so an interrupted
run replayed from its checkpoint retraces the uninterrupted run exactly,
which is what the kill-and-restart bit-identity check asserts.

Beside the reference's report, the port's adds `walls` (set-up, warm-up,
drive and publish walls per lineage, the checkpoint's size and its
save/load walls) and `classes` (dissemination p50/p99 and coverage per traffic
class over the surviving lineage's records).
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
from dataclasses import dataclass

import numpy as np

from ..config.env import NodeConfig
from ..config.topology import TopoParams
from ..device import resolve_device
from .multitopic import MultiTopicConfig, MultiTopicSimulator
from .node_service import NodeService, PublishRequest, ServiceConfig


@dataclass(frozen=True)
class TrafficClass:
    """One topic of the mix: its tenant, relative publish rate, and size."""

    topic: str
    tenant: str
    weight: float
    msg_size: int


def eth2_mix(subnets: int = 64, msg_scale: float = 1.0) -> tuple[TrafficClass, ...]:
    """The ETH2 mainnet-shaped topic mix. `subnets` scales the attestation
    fan (64 on mainnet; a handful is plenty for CPU smokes — the aggregate
    attestation RATE is held constant by splitting one weight budget across
    the subnets). `msg_scale` scales payload bytes uniformly (CPU smokes
    shrink them; relative shape is what matters to the service)."""
    if subnets < 1:
        raise ValueError("subnets must be >= 1")
    s = float(msg_scale)
    mix = [
        # blocks: rare and big (one per slot, full beacon block)
        TrafficClass("blocks", "blocks", 1.0, max(1, int(18000 * s))),
        # aggregates: steady mid-size control traffic
        TrafficClass("aggregates", "aggregates", 8.0, max(1, int(3000 * s))),
        # sync committee: light
        TrafficClass("sync", "sync", 2.0, max(1, int(1200 * s))),
    ]
    # attestation subnets dominate message COUNT: one shared weight budget
    # split evenly, one tenant (the attestation pipeline) across all subnets
    att_w = 53.0 / subnets
    for i in range(subnets):
        mix.append(TrafficClass(f"att_{i}", "att", att_w,
                                max(1, int(600 * s))))
    return tuple(mix)


def topics_of(mix: tuple[TrafficClass, ...]) -> tuple[str, ...]:
    return tuple(t.topic for t in mix)


def build_schedule(
    mix: tuple[TrafficClass, ...], ticks: int, per_tick: int, seed: int,
) -> list[list[dict]]:
    """Deterministic request schedule: `ticks` service rounds of `per_tick`
    requests each, classes drawn by mix weight. Pure function of its
    arguments — the kill-and-restart replay depends on that."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7261666C]))
    w = np.asarray([t.weight for t in mix], dtype=np.float64)
    p = w / w.sum()
    sched: list[list[dict]] = []
    for _ in range(ticks):
        picks = rng.choice(len(mix), size=per_tick, p=p)
        sched.append([
            {"topic": mix[i].topic, "msg_size": mix[i].msg_size,
             "tenant": mix[i].tenant}
            for i in picks
        ])
    return sched


def _post_http(port: int, spec: dict, deadline_ms: float) -> int:
    body = {"topic": spec["topic"], "msgSize": spec["msg_size"],
            "tenant": spec["tenant"]}
    if deadline_ms > 0:
        body["deadlineMs"] = deadline_ms
    data = json.dumps(body, allow_nan=False).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/publish", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def _submit_local(svc: NodeService, spec: dict, deadline_ms: float) -> int:
    req = PublishRequest(
        topic=spec["topic"], msg_size=spec["msg_size"],
        tenant=spec["tenant"],
        deadline_ms=deadline_ms if deadline_ms > 0 else float("inf"))
    code, _, _ = svc.submit(req)
    return code


def _drive(svc: NodeService, sched: list[list[dict]], start_tick: int,
           tick_ms: float, deadline_ms: float, via_http: bool,
           codes: list[int]) -> None:
    """Run ticks [start_tick, len(sched)): post the tick's requests, then
    pump one service round advancing tick_ms of sim time."""
    for tick in range(start_tick, len(sched)):
        for spec in sched[tick]:
            if via_http:
                codes.append(_post_http(svc.control_port, spec, deadline_ms))
            else:
                codes.append(_submit_local(svc, spec, deadline_ms))
        svc.pump(advance_ms=tick_ms)
        svc.lines_out.clear()


def _records_key(records) -> list[tuple]:
    """The bit-identity fingerprint of a multitopic record stream: topic,
    msg id, publish time, and the full delay/received arrays bytewise."""
    out = []
    for topic, rec in records:
        out.append((
            topic, int(rec.msg_id), float(rec.t0_ms),
            np.asarray(rec.delays_ms).tobytes(),
            np.asarray(rec.received).tobytes(),
        ))
    return out


def _records_sha(records) -> str:
    """Hex digest of the record-stream fingerprint: lets two separate
    run_service_load invocations (e.g. one per dispatch_mode) assert
    bit-identity through a strict-JSON artifact without shipping the raw
    arrays."""
    import hashlib

    h = hashlib.sha256()
    for topic, msg_id, t0_ms, delays, received in _records_key(records):
        h.update(topic.encode())
        h.update(repr((msg_id, t0_ms)).encode())
        h.update(delays)
        h.update(received)
    return h.hexdigest()


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _class_stats(mix, records) -> dict:
    """Per traffic class (tenant): messages, dissemination p50/p99 over
    every receipt, and coverage (receipts over messages x peers)."""
    tenant = {t.topic: t.tenant for t in mix}
    by: dict[str, list] = {}
    for topic, rec in records:
        by.setdefault(tenant[topic], []).append(rec)
    out = {}
    for name, recs in by.items():
        d = np.concatenate([np.asarray(r.delays_ms)[np.asarray(r.received)]
                            for r in recs])
        seen = sum(int(np.asarray(r.received).sum()) for r in recs)
        out[name] = {
            "messages": len(recs),
            "p50_ms": float(np.percentile(d, 50)) if d.size else None,
            "p99_ms": float(np.percentile(d, 99)) if d.size else None,
            "coverage": seen / (len(recs) * len(recs[0].received)),
        }
    return out


def _scrape_counters(svc: NodeService) -> dict:
    """The service-family counters exactly as the /metrics scrape reports
    them (read from the same registry the exposition renders)."""
    m = svc.metrics
    return {
        "dropped_backpressure":
            m.service_dropped.get({"reason": "backpressure"}),
        "dropped_deadline": m.service_dropped.get({"reason": "deadline"}),
        "retries_total": m.service_retries.get(),
        "quarantined_total": m.service_quarantined.get(),
        "degraded": m.service_degraded.get(),
        "restarts_total": m.service_restarts.get(),
        "checkpoint_flushes_total": m.service_checkpoints.get(),
        "batch_splits_total": m.service_splits.get(),
        "device_dispatches_total": m.service_dispatches.get(),
    }


def run_service_load(
    *,
    n_peers: int = 64,
    subnets: int = 2,
    connect_to: int = 6,
    warmup_s: float = 10.0,
    seed: int = 0,
    ticks: int = 12,
    per_tick: int = 4,
    tick_ms: float = 150.0,
    msg_scale: float = 1.0,
    max_queue_depth: int = 8,
    max_batch: int = 2,
    deadline_ms: float = 0.0,
    dispatch_timeout_s: float = 0.0,
    max_retries: int = 1,
    retry_backoff_s: float = 0.0,
    inject_failures: int = 0,
    dispatch_mode: str = "batched",
    kill_at_tick: int | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 2,
    via_http: bool = True,
    device=None,
) -> dict:
    """Drive a resident service with the ETH2 mix and report a strict-JSON
    load profile. Overload is shaped by per_tick vs max_batch (offered vs
    per-round capacity); `kill_at_tick` additionally runs the chaos leg:
    an uninterrupted reference, then a run killed cold (no flush) at that
    tick and warm-restarted from its last periodic checkpoint, asserting
    the surviving lineage's record stream is bit-identical. The
    simulators live on `device` (CUDA unless the caller passes another;
    raises without a card).

    Returns a dict safe for json.dumps(..., allow_nan=False)."""
    device = resolve_device(device)
    if kill_at_tick is not None:
        if not checkpoint_path:
            raise ValueError("kill_at_tick requires checkpoint_path")
        if not (0 < kill_at_tick < ticks):
            raise ValueError("kill_at_tick must fall inside the run")
        if checkpoint_every < 1 or checkpoint_every > kill_at_tick:
            raise ValueError(
                "checkpoint_every must flush at least once before the kill")
    mix = eth2_mix(subnets, msg_scale=msg_scale)
    sched = build_schedule(mix, ticks, per_tick, seed)
    node_cfg = NodeConfig(my_id=1, network_size=n_peers,
                          connect_to=connect_to, topic=mix[0].topic)

    walls: dict = {"lineages": {}, "checkpoint_save_s": []}

    def build_sim(lineage: str) -> MultiTopicSimulator:
        cfg = MultiTopicConfig(
            topo=TopoParams(network_size=n_peers),
            topics=topics_of(mix), connect_to=connect_to,
            warmup_s=warmup_s, seed=seed)
        t0 = time.monotonic()
        sim = MultiTopicSimulator(cfg, device=device)
        _sync(device)
        t1 = time.monotonic()
        sim.warmup()
        _sync(device)
        walls["lineages"][lineage] = {
            "build_s": t1 - t0, "warmup_s": time.monotonic() - t1}
        return sim

    def drive(lineage: str, svc: NodeService, sched_part, start_tick: int,
              codes: list[int]) -> None:
        t0 = time.monotonic()
        before = svc.counters["dispatched"]
        dev_ms = svc.device_ms_total
        _drive(svc, sched_part, start_tick, tick_ms, deadline_ms, via_http,
               codes)
        _sync(device)
        lw = walls["lineages"].setdefault(lineage, {})
        lw["drive_s"] = time.monotonic() - t0
        lw["publish_s"] = (svc.device_ms_total - dev_ms) / 1000.0
        lw["dispatched"] = svc.counters["dispatched"] - before
        walls["checkpoint_save_s"] += svc.flush_walls
        svc.flush_walls = []

    def svc_cfg(inject: int, ckpt: str | None) -> ServiceConfig:
        return ServiceConfig(
            max_queue_depth=max_queue_depth, max_batch=max_batch,
            default_deadline_ms=deadline_ms,
            dispatch_timeout_s=dispatch_timeout_s,
            max_retries=max_retries, retry_backoff_s=retry_backoff_s,
            inject_failures=inject, dispatch_mode=dispatch_mode,
            checkpoint_path=ckpt, checkpoint_every=checkpoint_every)

    kill_block = None
    if kill_at_tick is not None:
        # uninterrupted reference lineage (same admission shape, no chaos)
        ref = NodeService(build_sim("reference"), node_cfg, control_port=0,
                          metrics_port=0, service=svc_cfg(0, None))
        if via_http:
            ref.start()
        ref_codes: list[int] = []
        drive("reference", ref, sched, 0, ref_codes)
        ref_key = _records_key(ref.sim.records)
        ref.stop()
        # victim lineage: chaos armed, killed COLD at kill_at_tick (no
        # drain, no final flush — only the periodic checkpoints survive)
        victim = NodeService(build_sim("victim"), node_cfg, control_port=0,
                             metrics_port=0,
                             service=svc_cfg(inject_failures,
                                             checkpoint_path))
        if via_http:
            victim.start()
        codes: list[int] = []
        drive("victim", victim, sched[:kill_at_tick], 0, codes)
        victim.stop()  # SIGKILL analog: HTTP gone, nothing flushed
        # warm restart from the last periodic flush; replay the schedule
        # from the restored round (requests after the flush were lost with
        # the process and get re-posted — same bytes, same order)
        t_load = time.monotonic()
        svc = NodeService.restore(checkpoint_path, node_cfg,
                                  control_port=0, metrics_port=0,
                                  service=svc_cfg(0, checkpoint_path),
                                  device=device)
        _sync(device)
        walls["checkpoint_load_s"] = time.monotonic() - t_load
        walls["checkpoint_bytes"] = os.path.getsize(checkpoint_path)
        resume_tick = svc.pump_rounds
        if via_http:
            svc.start()
        # drop the victim's post-restore-window admission codes: the
        # surviving lineage re-answers them on replay
        codes = codes[:resume_tick * per_tick]
        drive("restored", svc, sched, resume_tick, codes)
        got_key = _records_key(svc.sim.records)
        kill_block = {
            "kill_at_tick": kill_at_tick,
            "resume_tick": resume_tick,
            "replayed_ticks": ticks - resume_tick,
            "messages": len(got_key),
            "ref_messages": len(ref_key),
            "bit_identical": got_key == ref_key,
            "ref_codes_match": codes == ref_codes,
        }
    else:
        svc = NodeService(build_sim("run"), node_cfg, control_port=0,
                          metrics_port=0,
                          service=svc_cfg(inject_failures, checkpoint_path))
        if via_http:
            svc.start()
        codes = []

    t0 = time.monotonic()
    if kill_at_tick is None:
        drive("run", svc, sched, 0, codes)
    wall_s = max(time.monotonic() - t0, 1e-9)
    if kill_at_tick is None and checkpoint_path and walls["checkpoint_save_s"]:
        walls["checkpoint_bytes"] = os.path.getsize(checkpoint_path)

    offered = len(codes)
    admitted = sum(1 for c in codes if c == 200)
    rejected = sum(1 for c in codes if c == 429)
    c = svc.counters
    lat = sorted(ms for _, ms in svc.latencies)
    p50 = float(np.percentile(lat, 50)) if lat else None
    p99 = float(np.percentile(lat, 99)) if lat else None
    shed = rejected + c["shed_deadline"]
    out = {
        "config": {
            "n_peers": n_peers, "subnets": subnets, "topics": len(mix),
            "ticks": ticks, "per_tick": per_tick, "tick_ms": tick_ms,
            "max_queue_depth": max_queue_depth, "max_batch": max_batch,
            "deadline_ms": deadline_ms, "inject_failures": inject_failures,
            "dispatch_mode": dispatch_mode,
            "via_http": via_http, "seed": seed,
            "overload_factor": per_tick / max_batch,
        },
        "offered": offered,
        "admitted": admitted,
        "rejected": rejected,
        "shed_deadline": c["shed_deadline"],
        "dispatched": c["dispatched"],
        "quarantined": c["quarantined"],
        "retries": c["retries"],
        "batch_splits": c["batch_splits"],
        "device_dispatches": c["device_dispatches"],
        "degraded": svc.degraded,
        "shed_rate": (shed / offered) if offered else 0.0,
        "requests_per_s": (c["dispatched"] / wall_s
                           if kill_at_tick is None else None),
        "p50_ms": p50,
        "p99_ms": p99,
        "max_depth_seen": svc.max_depth_seen,
        "queue_bound_held": svc.max_depth_seen <= max_queue_depth,
        "records_sha": _records_sha(svc.sim.records),
        "scrape": _scrape_counters(svc),
        "kill": kill_block,
        "walls": walls,
        "classes": _class_stats(mix, svc.sim.records),
    }
    if via_http:
        # the CI smoke asserts against the real exposition, so prove the
        # family is actually served over HTTP, not just in the registry
        with urllib.request.urlopen(
                f"http://127.0.0.1:{svc.metrics_port}/metrics",
                timeout=30) as resp:
            out["scrape_serves_service_family"] = (
                "dst_service_" in resp.read().decode())
    svc.stop()
    return out
