"""Experiment runtime: what `shadow shadow.yaml` does for the reference.

The port of the reference Simulator's main path:

  boot     -> connection graph build (ops/graph.py, host numpy)
  warm-up  -> `warmup_s` heartbeats of mesh maintenance (ops/heartbeat.py)
  inject   -> one disseminate() per message, heartbeats advancing between
              messages at the configured spacing
  output   -> awk-compatible latencies lines (runtime/logemit.py), the
              shadowlog and summaries (runtime/summarize.py, bandwidth.py)

All state lives on one device: CUDA unless the caller passes device="cpu".
A lossy topology (packet_loss > 0) runs the loss model cfg.loss_mode names.
`set_subscribed` sets topic membership; an unsubscribed publisher takes the
v1.1 fanout path. With cfg.uses_mix every publish first relays through the
mix network (ops/mix.py). `publish_batch` injects several messages at one
sim time through the batched dispatch (runtime/publisher.py); `run(checkpoint_path=)` snapshots the
experiment (runtime/checkpoint.py), and a run loaded from the snapshot
continues its schedule. `record_telemetry` arms the flight recorder
(ops/telemetry.py) for later advances, `publish(censor_edge=)` threads an
adversarial drop mask, and `rebind_graph` adopts a graph the repair
controller dialed (runtime/campaign.py).

`mesh=` (parallel/sharding.make_peer_mesh) makes the Simulator a handle
on a peer mesh (runtime/sharded.py): each rank process holds its rows of
every peer-major leaf and runs this class's code on them, the handle
sends every call to the ranks and row-concatenates what they return, so
records, latencies and summaries come out in the one-device layout.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import prng
from ..config.env import GossipSubParams
from ..config.topology import Topology, TopoParams
from ..device import resolve_device
from ..ops.disseminate import (answer_tables, disseminate, edge_tables,
                               gathered_result)
from ..ops.graph import build_connection_graph
from ..ops.heartbeat import run_heartbeats
from ..ops.mix import MixParams, eligible_mix_count, mix_route, mix_wire_bytes
from ..ops.pull import neighbor_pull_bool
from ..ops.state import SimParams, graph_arrays, init_state
from ..parallel import peer
from .logemit import LatenciesWriter
from .summarize import LatencySummary, report, summarize

# per-hop processing cost by muxer: event-loop crossings x 0.2 ms each (the
# reference derives both numbers, runtime/simulator.py:37-67)
EVENT_LOOP_MS = 0.2
_MUXER_CROSSINGS = {"yamux": 4.0, "mplex": 4.4, "quic": 3.0}
MUXER_PROC_MS = {m: EVENT_LOOP_MS * x for m, x in _MUXER_CROSSINGS.items()}


class MixDegradedError(RuntimeError):
    """The mix network has fewer eligible nodes than MIXD (a publish-time
    condition, not an engine failure)."""


@dataclass
class ExperimentConfig:
    """The reference's ExperimentConfig fields; those outside this slice
    must keep their defaults (the Simulator raises otherwise)."""

    topo: TopoParams = field(default_factory=TopoParams)
    connect_to: int = 10
    gossipsub: GossipSubParams = field(default_factory=GossipSubParams)
    publisher_id: int = 4
    publisher_rotation: bool = False
    warmup_s: float = 500.0
    self_trigger: bool = True
    max_connections: int = 250
    seed: int = 0
    with_gossip: bool = True
    churn_down_per_hb: float = 0.0
    churn_up_per_hb: float = 0.0
    uses_mix: bool = False
    num_mix: int = 0
    mix_d: int = 4
    loss_mode: str = "tcp"
    serialize_answers: bool = True
    answer_queue_mode: str = "parallel_prefix"
    packed_state: bool = False
    warm_start: bool = False
    msgid_mode: str = "nim"


def drain_heartbeat_carry(carry_ms: float, ms: float, hb_ms: float):
    """Advance a fractional-heartbeat accumulator: (whole steps due, carry)."""
    carry = carry_ms + ms
    steps = int(carry // hb_ms)
    return steps, carry - steps * hb_ms


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclass
class MessageRecord:
    msg_id: int
    publisher: int
    t0_ms: float
    delays_ms: np.ndarray         # (N,) float, inf = never received
    received: np.ndarray          # (N,) bool
    sends: np.ndarray
    copies_rx: np.ndarray
    ihave: int
    iwant: int
    answer_wait_max_ms: float = 0.0
    # every fixpoint of this message met its no-change certificate
    converged: bool = True
    # exact mode: refinement passes the message took (0 = fast pipeline)
    refine_passes: int = 0

    @property
    def receivers(self) -> np.ndarray:
        return np.nonzero(self.received)[0]

    @property
    def delays_ms_int(self) -> np.ndarray:
        """Integer milliseconds as the reference logs them (truncated)."""
        return self.delays_ms[self.received].astype(np.int64)


def record_from_result(res, *, msg_id, publisher, t0_ms,
                       extra_delay_ms: float = 0.0, drop_self=None):
    """A MessageRecord from a DisseminationResult or a block view of one
    (multi-topic). `extra_delay_ms` (the mix path) is added to the float64
    delays on the host; `drop_self`: peer id(s) whose own delivery is not
    logged (SELFTRIGGER off, unsubscribed originators and exit nodes)."""
    delays = _host(res.delay_ms).astype(np.float64) + extra_delay_ms
    received = _host(res.received).copy()
    if drop_self is not None:
        received[np.asarray(drop_self)] = False
    delays = np.where(received, delays, np.inf)
    return MessageRecord(
        msg_id=msg_id,
        publisher=publisher,
        t0_ms=t0_ms,
        delays_ms=delays,
        received=received,
        sends=_host(res.sends),
        copies_rx=_host(res.copies_rx),
        ihave=int(_host(res.ihave_sent).sum()),
        iwant=int(_host(res.iwant_sent).sum()),
        answer_wait_max_ms=float(res.answer_wait_max_ms),
        converged=bool(res.converged),
        refine_passes=int(res.refine_passes),
    )


class Simulator:
    def __new__(cls, cfg=None, topology=None, device=None, mesh=None):
        if mesh is not None and cls is Simulator:
            from .sharded import ShardedSimulator

            return super().__new__(ShardedSimulator)
        return super().__new__(cls)

    def __init__(self, cfg: ExperimentConfig,
                 topology: Topology | None = None, device=None, mesh=None):
        """`mesh`: a peer mesh (make_peer_mesh); the constructor then
        returns a runtime/sharded.ShardedSimulator. On a rank of one
        (an active parallel/peer group) every device leaf is the rank's
        rows."""
        self.mesh = None
        self.device = dev = resolve_device(device)
        self._configure(cfg, topology)
        self.state = init_state(self.params, seed=cfg.seed, device=dev)
        self.arrays = graph_arrays(self.graph, device=dev)
        self._stage = torch.as_tensor(peer.local(self.topology.stage_of_peer),
                                      device=dev)
        self._lat = torch.as_tensor(self.topology.latency_ms, device=dev)
        self._bw = torch.as_tensor(self.topology.bw_up_mbit, device=dev)
        # per-stage-pair packet loss (topogen -l); None keeps the lossless
        # path free of the loss draws
        self._loss = (
            torch.as_tensor(self.topology.packet_loss, device=dev)
            if float(np.max(self.topology.packet_loss)) > 0.0 else None)
        # experiment constants, built once
        self._lat_edge, self._loss_edge = edge_tables(
            self._stage, self._lat, self.arrays["conns"], self.arrays["rev"],
            self._loss)
        self._ans_tables = (answer_tables(self._lat_edge, self.arrays["conns"])
                            if cfg.with_gossip else None)
        self._valid_edge = None if self._churny else self._compute_valid_edge()

    def _configure(self, cfg: ExperimentConfig, topology) -> None:
        """The host side of the constructor: config checks, topology,
        connection graph, params and the host counters."""
        cfg.topo.validate()
        cfg.gossipsub.validate()
        if cfg.msgid_mode not in ("nim", "go"):
            raise ValueError(f"unknown msgid_mode {cfg.msgid_mode!r}")
        if cfg.loss_mode not in ("message", "tcp"):
            raise ValueError(f"unknown loss_mode {cfg.loss_mode!r}")
        self.cfg = cfg
        self.topology = topology or Topology.build(cfg.topo)
        n = cfg.topo.network_size
        self.graph = build_connection_graph(
            n, cfg.connect_to, seed=cfg.seed,
            max_degree=min(cfg.max_connections, max(4 * cfg.connect_to, 16)),
        )
        proc_ms = MUXER_PROC_MS.get(cfg.topo.muxer.lower(), 2.0)
        self.params = SimParams.from_gossipsub(
            n, self.graph.capacity, cfg.gossipsub,
            proc_delay_ms=proc_ms,
            churn_down_per_hb=cfg.churn_down_per_hb,
            churn_up_per_hb=cfg.churn_up_per_hb,
            serialize_answers=cfg.serialize_answers,
            answer_queue_mode=cfg.answer_queue_mode,
            packed_state=cfg.packed_state,
            warm_start=cfg.warm_start,
        )
        self._churny = (cfg.churn_down_per_hb > 0.0
                        or cfg.churn_up_per_hb > 0.0)
        self._startup_membership()
        self._msg_rng = np.random.default_rng(cfg.seed ^ 0x6D736749)
        self._last_msg_id = -1
        self._hb_carry_ms = 0.0
        self.records: list[MessageRecord] = []
        # flight recorder: disarmed by default; last_telemetry holds the
        # latest armed advance's tel_* curves as host numpy
        self._telemetry = None
        self.last_telemetry: dict = {}
        self.mix_params = None
        if cfg.uses_mix:
            self.mix_params = MixParams(num_mix=cfg.num_mix, mix_d=cfg.mix_d)
            self.mix_params.validate()

    def _startup_membership(self) -> None:
        """The host mirror of state.subscribed (publish picks the fanout
        path without a device sync) and the cumulative SUBSCRIBE /
        UNSUBSCRIBE messages per peer: every node joins at startup."""
        n = self.params.n
        self._subscribed_np = np.ones(n, dtype=bool)
        self._sub_events_np = np.ones(n, dtype=np.int64)
        self._unsub_events_np = np.zeros(n, dtype=np.int64)

    def _compute_valid_edge(self):
        conns = self.arrays["conns"]
        return (conns >= 0) & neighbor_pull_bool(
            self.state.alive & self.state.subscribed, conns,
            self.arrays["rev"])

    # ---------------------------------------------------------------- phases

    def reset(self) -> None:
        """Rewind to the pre-warm-up state, keeping graph and topology."""
        self.state = init_state(self.params, seed=self.cfg.seed,
                                device=self.device)
        self._reset_host()
        if not self._churny:
            self._valid_edge = self._compute_valid_edge()

    def _reset_host(self) -> None:
        self._startup_membership()
        self._msg_rng = np.random.default_rng(self.cfg.seed ^ 0x6D736749)
        self._last_msg_id = -1
        self._hb_carry_ms = 0.0
        self.records = []
        self.last_telemetry = {}  # the recorder stays armed across resets

    def set_subscribed(self, mask) -> None:
        """Set per-peer topic membership. An unsubscribed peer can still
        publish, through the v1.1 fanout path."""
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != (self.params.n,):
            raise ValueError(f"subscribed mask must be ({self.params.n},)")
        if self._t_now() == 0.0 and not self.records:
            # before the warm-up this defines the startup membership: one
            # SUBSCRIBE per joined node, nothing for the others
            self._sub_events_np = mask.astype(np.int64)
            self._unsub_events_np = np.zeros_like(self._sub_events_np)
        else:
            # mid-run: every flip broadcasts one more control message
            self._sub_events_np = (
                self._sub_events_np + (mask & ~self._subscribed_np))
            self._unsub_events_np = (
                self._unsub_events_np + (~mask & self._subscribed_np))
        self._subscribed_np = mask
        self._apply_subscribed(mask)

    def _apply_subscribed(self, mask: np.ndarray) -> None:
        # the warm-start carry measured offsets on the old membership
        self.state = self.state.replace(
            subscribed=torch.as_tensor(peer.local(mask), device=self.device),
            warm_offset_ms=torch.full((peer.local_count(self.params.n),),
                                      3.4e38, dtype=torch.float32,
                                      device=self.device))
        if not self._churny:
            self._valid_edge = self._compute_valid_edge()

    def rebind_graph(self, conns, rev, out_mask) -> None:
        """Adopt a connection graph the repair controller extended
        (ops/repair.py): every per-edge table indexes conns/rev, so
        lat_edge/loss_edge, the answer tables and the edge validity are
        re-derived, and the warm-start carry is set to INF. `self.graph`
        keeps the epoch graph (checkpoints hash it)."""
        dev = self.device
        self.arrays = {
            "conns": torch.as_tensor(peer.local(conns), device=dev),
            "rev": torch.as_tensor(peer.local(rev), device=dev),
            "out_mask": torch.as_tensor(peer.local(out_mask), device=dev),
        }
        self._lat_edge, self._loss_edge = edge_tables(
            self._stage, self._lat, self.arrays["conns"], self.arrays["rev"],
            self._loss)
        self._ans_tables = (answer_tables(self._lat_edge,
                                          self.arrays["conns"])
                            if self.cfg.with_gossip else None)
        self.state = self.state.replace(warm_offset_ms=torch.full(
            (peer.local_count(self.params.n),), 3.4e38, dtype=torch.float32,
            device=dev))
        if not self._churny:
            self._valid_edge = self._compute_valid_edge()

    def record_telemetry(self, params=None) -> None:
        """Arm the flight recorder: later advances leave their per-heartbeat
        tel_* curves in `last_telemetry` (host numpy). None or a
        record=False TelemetryParams disarms it; the trajectory is the same
        bytes either way."""
        if params is not None:
            params.validate()
            if not params.enabled:
                params = None
        self._telemetry = params

    def advance(self, ms: float) -> None:
        """Advance simulated time by `ms`, running the heartbeats due."""
        steps, self._hb_carry_ms = drain_heartbeat_carry(
            self._hb_carry_ms, ms, self.params.heartbeat_ms)
        if steps > 0:
            a = self.arrays
            if self._telemetry is not None:
                from ..ops.telemetry import run_recorded_heartbeats

                self.state, trace = run_recorded_heartbeats(
                    self.state, a["conns"], a["rev"], a["out_mask"],
                    self.params, steps, telemetry=self._telemetry)
                self.last_telemetry = {k: _host(v) for k, v in trace.items()}
            else:
                self.state = run_heartbeats(self.state, a["conns"], a["rev"],
                                            a["out_mask"], self.params,
                                            steps)

    def warmup(self) -> None:
        self.advance(self.cfg.warmup_s * 1000.0)

    def publish(self, publisher: int, msg_size: int | None = None,
                censor_edge=None) -> MessageRecord:
        """Inject one message at the current sim time. `censor_edge`: an
        optional (N, C) adversarial drop mask (ops/adversary.censor_mask);
        None keeps the benign publish."""
        cfg = self.cfg
        size = msg_size if msg_size is not None else cfg.topo.msg_size_bytes
        t0_ms = self._t_now() + self._hb_carry_ms
        origin = publisher
        mix_delay = 0.0
        if self.mix_params is not None:
            mix_delay, publisher = self._mix_relay(origin, size, t0_ms)
        # an unsubscribed publisher takes the v1.1 fanout path
        res = self._disseminate(
            publisher, t0_ms + mix_delay, size,
            not bool(self._subscribed_np[publisher]), censor_edge)
        # a rank's record holds every peer, as one device's does
        res = gathered_result(res)
        if cfg.msgid_mode == "go":
            msg_id = max(int(t0_ms * 1e6), self._last_msg_id + 1)
            self._last_msg_id = msg_id
        else:
            msg_id = int(self._msg_rng.integers(0, 2**63, dtype=np.int64))
        rec = record_from_result(
            res, msg_id=msg_id, publisher=origin, t0_ms=t0_ms,
            extra_delay_ms=mix_delay,
            # a peer does not log its own message with SELFTRIGGER off, and
            # never when unsubscribed (no topic handler): the origin on the
            # fanout path, and an unsubscribed mix exit node
            drop_self=[
                p for p in {origin, publisher}
                if (p == origin and not cfg.self_trigger)
                or not self._subscribed_np[p]
            ] or None,
        )
        self.records.append(rec)
        return rec

    def _t_now(self) -> float:
        """The sim clock (ms) as a Python float."""
        return float(self.state.t_ms)

    def _disseminate(self, publisher: int, t0_ms: float, size: int,
                     with_fanout: bool, censor_edge=None):
        """One disseminate() call on this Simulator's state and tables;
        returns the DisseminationResult and keeps the new state."""
        cfg, a = self.cfg, self.arrays
        res, self.state = disseminate(
            self.state, a["conns"], a["rev"], self._stage, self._lat,
            self._bw, publisher=publisher, t0_ms=t0_ms,
            params=self.params, payload_bytes=size,
            fragments=cfg.topo.num_frags, with_gossip=cfg.with_gossip,
            loss_stage=self._loss, loss_mode=cfg.loss_mode,
            lat_edge=self._lat_edge, loss_edge=self._loss_edge,
            ans_tables=self._ans_tables, valid_edge=self._valid_edge,
            with_fanout=with_fanout, censor_edge=censor_edge,
        )
        return res

    def publish_batch(self, publishers, msg_size: int | None = None,
                      pad_to: int | None = None) -> list[MessageRecord]:
        """Inject len(publishers) messages at the current sim time, in
        order, through the batched dispatch (runtime/publisher.
        publish_columns): every message starts at the same t0, the state
        carried from one to the next, so the records and the state equal
        the reference's batched dispatch. All publishers must share one
        fanout bucket (all subscribed or all not), as there. Mix routing
        and a peer mesh keep the per-publish path, as there. `pad_to` keeps the
        reference's signature: its padding columns change nothing, so it
        is not used."""
        pubs = [int(p) for p in publishers]
        if not pubs:
            return []
        if self.mix_params is not None or self.mesh is not None:
            return [self.publish(p, msg_size=msg_size) for p in pubs]
        subbed = {bool(self._subscribed_np[p]) for p in pubs}
        if len(subbed) != 1:
            raise ValueError(
                "publish_batch requires a uniform fanout bucket: mixed "
                "subscribed/unsubscribed publishers in one batch — group "
                "them first (NodeService._group_batch does)")
        from .publisher import publish_columns

        cfg = self.cfg
        size = msg_size if msg_size is not None else cfg.topo.msg_size_bytes
        a = self.arrays
        t0_ms = self._t_now() + self._hb_carry_ms
        results, self.state = publish_columns(
            self.state, a["conns"], a["rev"], self._stage, self._lat,
            self._bw, pubs, [True] * len(pubs), t0_ms, self.params, size,
            cfg.topo.num_frags, cfg.with_gossip, self._loss, cfg.loss_mode,
            self._lat_edge, self._loss_edge, self._ans_tables,
            self._valid_edge, not subbed.pop())
        recs = []
        for pub, res in zip(pubs, results):
            if cfg.msgid_mode == "go":
                msg_id = max(int(t0_ms * 1e6), self._last_msg_id + 1)
                self._last_msg_id = msg_id
            else:
                msg_id = int(self._msg_rng.integers(0, 2**63,
                                                    dtype=np.int64))
            recs.append(record_from_result(
                res, msg_id=msg_id, publisher=pub, t0_ms=t0_ms,
                drop_self=([pub] if not cfg.self_trigger
                           or not self._subscribed_np[pub] else None)))
        self.records.extend(recs)
        return recs

    def _mix_relay(self, origin: int, size: int, t0_ms: float):
        """Relay one message through the mix network (occupancy-coupled);
        the exit node publishes on the origin's behalf. Returns (path
        delay in ms as a Python float, exit node). On a rank of the peer
        mesh every rank runs it on its rows (ops/mix.py)."""
        mp = self.mix_params
        eligible = eligible_mix_count(self.state.alive, origin,
                                      self.params.n, mp.num_mix)
        if eligible < mp.mix_d:
            raise MixDegradedError(
                f"mix network degraded: {eligible} eligible mix nodes "
                f"(alive, mounted, != publisher) < MIXD={mp.mix_d}")
        key, k_mix = prng.split(self.state.key)
        path, exit_node, path_delay, uplink_new, rx_new = mix_route(
            k_mix, origin, self.state.alive, self._stage, self._lat,
            self._bw, params=mp, n=self.params.n, payload_bytes=size,
            uplink_free_ms=self.state.uplink_free_ms,
            rx_free_ms=self.state.rx_free_ms, t0_ms=t0_ms)
        wire = float(mix_wire_bytes(mp, size))
        # per-hop bytes at both ends: senders are the origin and the first
        # mix_d - 1 relays, receivers the mix_d relays (distinct ids, so
        # each row gets one add: peer.add_rows)
        path = path.long()
        senders = torch.cat([torch.tensor([origin], device=self.device),
                             path[:-1]])

        def _add(x, idx):
            return peer.add_rows(x, idx, torch.full(idx.shape, wire,
                                                    dtype=x.dtype,
                                                    device=x.device))

        self.state = self.state.replace(
            key=key, bytes_tx=_add(self.state.bytes_tx, senders),
            bytes_rx=_add(self.state.bytes_rx, path),
            uplink_free_ms=uplink_new, rx_free_ms=rx_new)
        return float(path_delay), int(exit_node)

    def run(self, checkpoint_path: str | None = None,
            checkpoint_every: int = 1) -> list[MessageRecord]:
        """Full experiment: warm-up, then the injection schedule. A run
        with records (one resumed from a checkpoint) skips the warm-up and
        continues the schedule. `checkpoint_path`: snapshot after every
        `checkpoint_every`-th message and after the last one."""
        cfg = self.cfg
        n = cfg.topo.network_size
        done = len(self.records)
        if done == 0:
            self.warmup()
        delay_ms = cfg.topo.delay_seconds * 1000.0
        pub = cfg.publisher_id % n
        if cfg.publisher_rotation:
            pub = (pub + done) % n
        for i in range(done, cfg.topo.messages):
            if i > 0:
                self.advance(delay_ms)
            self.publish(pub)
            if cfg.publisher_rotation:
                pub = (pub + 1) % n
            if checkpoint_path is not None and (
                    (i + 1) % max(checkpoint_every, 1) == 0
                    or i == cfg.topo.messages - 1):
                from .checkpoint import save_checkpoint

                save_checkpoint(self, checkpoint_path)
        return self.records

    # --------------------------------------------------------------- outputs

    def latencies_writer(self) -> LatenciesWriter:
        w = LatenciesWriter()
        for rec in self.records:
            w.add_message(rec.msg_id, rec.receivers, rec.delays_ms_int)
        return w

    def write_latencies(self, path: str) -> int:
        return self.latencies_writer().write(path)

    def summary(self, large: bool | None = None) -> LatencySummary:
        if large is None:
            large = self.cfg.topo.msg_size_bytes >= 1000
        buf = io.StringIO()
        self.latencies_writer().write_to(buf)
        return summarize(buf.getvalue().splitlines(), large=large)

    def summary_report(self) -> str:
        large = self.cfg.topo.msg_size_bytes >= 1000
        return report(self.summary(large), large=large)

    def traffic(self):
        from .bandwidth import PeerTraffic

        return PeerTraffic.from_state(self.state)

    def write_shadowlog(self, path: str) -> int:
        """Shadow-heartbeat-shaped '[node]' lines (summary_shadowlog.awk)."""
        from .bandwidth import shadowlog_lines

        lines = shadowlog_lines(self.traffic())
        with open(path, "w") as f:
            for ln in lines:
                f.write(ln + "\n")
        return len(lines)

    def bandwidth_report(self) -> str:
        from .bandwidth import report as bw_report
        from .bandwidth import summarize_bandwidth

        return bw_report(summarize_bandwidth(self.traffic()))

    # ------------------------------------------------------------ statistics

    def peer_rounds_per_sec(self, wall_seconds: float) -> float:
        """Simulated peers x heartbeat rounds per wall second."""
        sim_rounds = self._t_now() / self.params.heartbeat_ms
        return self.cfg.topo.network_size * sim_rounds / max(wall_seconds,
                                                             1e-9)
