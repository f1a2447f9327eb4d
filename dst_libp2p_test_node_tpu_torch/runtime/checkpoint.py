"""Checkpoint/resume of a running experiment, in the reference's format.

A snapshot holds everything a run needs to continue bit-exactly: every
SimState leaf (the PRNG key included, so the random stream resumes), the
host-side position (heartbeat carry, the msgId RNG's state, the completed
MessageRecords, the SUBSCRIBE/UNSUBSCRIBE counters), the whole config and
the dense topology matrices.

The file is one .npz written with numpy (`np.savez_compressed`, then an
atomic rename), with the reference's keys and dtypes, so a snapshot
crosses between the two packages in both directions:

  meta_json          JSON (version, kind, graph hash, config, position)
  host/*             host-side counters (single) or the subscription draw
                     (multi-topic)
  records/*          the completed records, stacked
  state/<leaf>       SimState leaves in field order; `key` is (2,) uint32,
                     `t_ms` a 0-d float32, masks bool, counters int32
  topo/*             latency_ms, bw_up_mbit, packet_loss, stage_of_peer
  service_json       optional sidecar of the resident service

FORMAT_VERSION is 10; v5-v9 files load with the defaults of their absent
leaves (an INF warm-start carry, an empty PX pool and zero repair
counters, `answer_wait_max_ms` 0.0). The format carries no record's
`converged` or `refine_passes`: a restored record has the defaults (True,
0). `save_checkpoint(kad_state=)` adds a KadState's leaves as kad/*
(written for offline audit; loading ignores them, as the reference's
loader does).

A run on a peer mesh (runtime/sharded.py) saves the gathered rows, so its
file is byte-identical to the one-device save at the same point;
`load_checkpoint(mesh=)` rebuilds the handle on that mesh and scatters
the leaves to its ranks (a run does not remember its mesh: the mesh is
the resuming host's).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict

import numpy as np

from .. import interop
from ..config.env import GossipSubParams
from ..config.topology import Topology, TopoParams
from ..ops.state import PX_POOL_WIDTH
from .simulator import ExperimentConfig, MessageRecord, Simulator

FORMAT_VERSION = 10
_READABLE = (5, 6, 7, 8, 9, FORMAT_VERSION)
_TOPO_KEYS = ("latency_ms", "bw_up_mbit", "packet_loss", "stage_of_peer")
_REPAIR_COUNTERS = ("starve_hb", "evictions", "px_grafts", "redials")


def _graph_hash(graph) -> str:
    """Fingerprint of the connection graph the state's slots index into.
    The graph is rebuilt from (n, connect_to, seed) on load; a different
    graph would silently remap every edge, so a mismatch is refused."""
    h = hashlib.sha256()
    for arr in (graph.conns, graph.rev, graph.out_mask):
        a = np.ascontiguousarray(np.asarray(arr))
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _check_graph(sim, meta: dict) -> None:
    got = _graph_hash(sim.graph)
    want = meta.get("graph_sha256", "")
    if want and got != want:
        raise ValueError(
            "checkpoint graph mismatch: the rebuilt connection graph "
            f"(sha256 {got[:12]}…) differs from the one the checkpoint was "
            f"written against ({want[:12]}…). Graph-construction code "
            "changed between save and load; the restored edge-slot state "
            "would silently refer to different edges.")


def _records_arrays(records: list[MessageRecord]) -> dict:
    if not records:
        return {}
    return {
        "records/msg_id": np.asarray([r.msg_id for r in records],
                                     dtype=np.int64),
        "records/publisher": np.asarray([r.publisher for r in records],
                                        dtype=np.int64),
        "records/t0_ms": np.asarray([r.t0_ms for r in records],
                                    dtype=np.float64),
        "records/ihave": np.asarray([r.ihave for r in records],
                                    dtype=np.int64),
        "records/iwant": np.asarray([r.iwant for r in records],
                                    dtype=np.int64),
        "records/answer_wait_max_ms": np.asarray(
            [r.answer_wait_max_ms for r in records], dtype=np.float64),
        "records/delays_ms": np.stack([r.delays_ms for r in records]),
        "records/received": np.stack([r.received for r in records]),
        "records/sends": np.stack([r.sends for r in records]),
        "records/copies_rx": np.stack([r.copies_rx for r in records]),
    }


def _records_from_arrays(z) -> list[MessageRecord]:
    if "records/msg_id" not in z:
        return []
    r = {k.split("/", 1)[1]: z[k] for k in z.files
         if k.startswith("records/")}
    # absent before v6: exact mode's bar is 0.0
    wait = r.get("answer_wait_max_ms", np.zeros(len(r["msg_id"])))
    return [
        MessageRecord(
            msg_id=int(r["msg_id"][i]), publisher=int(r["publisher"][i]),
            t0_ms=float(r["t0_ms"][i]), delays_ms=r["delays_ms"][i],
            received=r["received"][i], sends=r["sends"][i],
            copies_rx=r["copies_rx"][i], ihave=int(r["ihave"][i]),
            iwant=int(r["iwant"][i]), answer_wait_max_ms=float(wait[i]))
        for i in range(len(r["msg_id"]))
    ]


def save_checkpoint(sim, path: str, kad_state=None,
                    service_meta: dict | None = None) -> None:
    """Snapshot a Simulator or MultiTopicSimulator to `path` (.npz). The
    state comes off the device; a crash while writing leaves the previous
    snapshot in place. `kad_state`: an ops.kad.KadState whose leaves ride
    along as kad/* (the DHT of the run, for offline audit).
    `service_meta`: a strict-JSON sidecar, read only by
    load_service_meta."""
    multitopic = hasattr(sim, "topic_index")
    state = sim.state          # on a peer mesh: one gather of the rows
    meta = {
        "version": FORMAT_VERSION,
        "kind": "multitopic" if multitopic else "single",
        "graph_sha256": _graph_hash(sim.graph),
        "cfg": asdict(sim.cfg),
        "hb_carry_ms": sim._hb_carry_ms,
        "msg_rng_state": sim._msg_rng.bit_generator.state,
        "t_ms": float(state.t_ms),
    }
    arrays: dict = {}
    if multitopic:
        arrays["host/subscribed_np"] = sim.subscribed_np
        topic_of = {t: i for i, t in enumerate(sim.cfg.topics)}
        arrays.update(_records_arrays([rec for _, rec in sim.records]))
        if sim.records:
            arrays["records/topic_idx"] = np.asarray(
                [topic_of[t] for t, _ in sim.records], dtype=np.int64)
    else:
        meta["last_msg_id"] = sim._last_msg_id
        arrays["host/sub_events"] = sim._sub_events_np
        arrays["host/unsub_events"] = sim._unsub_events_np
        arrays.update(_records_arrays(sim.records))
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta, allow_nan=False).encode(), dtype=np.uint8)
    for k, v in interop.state_to_numpy(state).items():
        arrays[f"state/{k}"] = v
    for k in _TOPO_KEYS:
        arrays[f"topo/{k}"] = np.asarray(getattr(sim.topology, k))
    if kad_state is not None:
        for k, v in interop.leaves_to_numpy(kad_state).items():
            arrays[f"kad/{k}"] = v
    if service_meta is not None:
        arrays["service_json"] = np.frombuffer(
            json.dumps(service_meta, allow_nan=False).encode(),
            dtype=np.uint8)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_service_meta(path: str) -> dict:
    """The resident-service sidecar of a checkpoint; {} without one."""
    with np.load(path) as z:
        if "service_json" not in z:
            return {}
        return json.loads(bytes(z["service_json"]).decode())


def _config_parts(meta: dict):
    cfg_d = dict(meta["cfg"])
    topo_p = TopoParams(**cfg_d.pop("topo"))
    gs = GossipSubParams(**cfg_d.pop("gossipsub"))
    return topo_p, gs, cfg_d


def _state_leaves(z, n: int) -> dict:
    """The state/* leaves, with the defaults of the leaves older formats
    lack: an INF warm-start carry (pre-v7: the next publish runs cold) and
    an empty PX pool with zero repair counters (pre-v8)."""
    leaves = {k.split("/", 1)[1]: z[k] for k in z.files
              if k.startswith("state/")}
    if "warm_offset_ms" not in leaves:
        leaves["warm_offset_ms"] = np.full((n,), 3.4e38, dtype=np.float32)
    if "px_pool" not in leaves:
        leaves["px_pool"] = np.full((n, PX_POOL_WIDTH), -1, dtype=np.int32)
        for k in _REPAIR_COUNTERS:
            leaves[k] = np.zeros((n,), dtype=np.int32)
    return leaves


def load_checkpoint(path: str, mesh=None, device=None):
    """Rebuild the Simulator (or MultiTopicSimulator, for a snapshot of
    kind "multitopic") that continues where `path` left off, on `device`
    (CUDA unless the caller passes another), or on the peer mesh `mesh`
    (parallel/sharding.make_peer_mesh; `device` is then unused)."""
    if mesh is not None:
        from ..parallel.sharding import check_peer_mesh

        check_peer_mesh(mesh)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["version"] not in _READABLE:
            raise ValueError(
                f"checkpoint format {meta['version']} != supported "
                f"{FORMAT_VERSION}")
        if meta.get("kind", "single") == "multitopic":
            return _load_multitopic(z, meta, device, mesh)
        topo_p, gs, cfg_d = _config_parts(meta)
        cfg = ExperimentConfig(topo=topo_p, gossipsub=gs, **cfg_d)
        topology = Topology(topo_p, *(z[f"topo/{k}"] for k in _TOPO_KEYS))
        sim = Simulator(cfg, topology=topology, device=device, mesh=mesh)
        _check_graph(sim, meta)
        leaves = _state_leaves(z, cfg.topo.network_size)
        sim.state = interop.state_from_numpy(leaves, sim.device)
        # the publish path's fanout decision reads a host mirror
        sim._subscribed_np = np.asarray(leaves["subscribed"]).copy()
        sim._sub_events_np = np.asarray(z["host/sub_events"]).copy()
        sim._unsub_events_np = np.asarray(z["host/unsub_events"]).copy()
        # the constructor computed _valid_edge from its fresh state
        if sim._valid_edge is not None:
            sim._valid_edge = sim._compute_valid_edge()
        sim._hb_carry_ms = float(meta["hb_carry_ms"])
        sim._msg_rng.bit_generator.state = meta["msg_rng_state"]
        sim._last_msg_id = int(meta.get("last_msg_id", -1))
        sim.records = _records_from_arrays(z)
    return sim


def _load_multitopic(z, meta: dict, device, mesh=None):
    from .multitopic import MultiTopicConfig, MultiTopicSimulator

    topo_p, gs, cfg_d = _config_parts(meta)
    cfg_d["topics"] = tuple(cfg_d["topics"])
    cfg = MultiTopicConfig(topo=topo_p, gossipsub=gs, **cfg_d)
    topology = Topology(topo_p, *(z[f"topo/{k}"] for k in _TOPO_KEYS))
    sim = MultiTopicSimulator(cfg, topology=topology, device=device,
                              mesh=mesh)
    _check_graph(sim, meta)
    sim.state = interop.state_from_numpy(
        _state_leaves(z, sim.params.n), sim.device)
    sim.subscribed_np = np.asarray(z["host/subscribed_np"]).copy()
    sim._hb_carry_ms = float(meta["hb_carry_ms"])
    sim._msg_rng.bit_generator.state = meta["msg_rng_state"]
    recs = _records_from_arrays(z)
    idx = z["records/topic_idx"] if recs else []
    sim.records = [(cfg.topics[int(idx[i])], r) for i, r in enumerate(recs)]
    return sim
