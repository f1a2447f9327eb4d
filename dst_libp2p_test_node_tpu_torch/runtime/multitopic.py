"""Multi-topic GossipSub simulation (BASELINE config 3: 10k peers, four
topics, IHAVE/IWANT heartbeat and peer scoring).

The port of the reference's runtime/multitopic.py. Topics are virtual
peers: topic t's copy of peer p is row t*N + p of one block-diagonal
connection graph (the same physical connections repeated per topic with a
t*N offset, so no edge crosses a topic block), and the single-topic engine
runs unchanged over the T*N rows:

  - one heartbeat loop advances every topic;
  - publish() targets row t*N + p, and dissemination cannot leave the
    topic's block;
  - per-topic metrics are reshapes of the flat (T*N, ...) state.

A physical node's heartbeat timer, uplink and downlink are shared by its
topics: one per-node heartbeat phase is tiled across the blocks, and after
every publish the uplink and downlink occupancy is folded across the
blocks (per-node max) and tiled back.

`subscribe_fraction` < 1 subscribes each peer to each topic independently
with that probability (seeded); a peer publishing on a topic it is not
subscribed to takes the v1.1 fanout path. `publish_batch` injects several
(topic, publisher) messages at one sim time, topics mixed.

`mesh=` (parallel/sharding.make_peer_mesh) makes it a handle on a peer
mesh (runtime/sharded.py): the T*N virtual-peer rows are split over the
ranks, each running this class's code on its rows; the per-node uplink /
downlink fold across topic blocks is a cross-row max, all-gathered on a
rank and folded there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..config.env import GossipSubParams
from ..config.topology import Topology, TopoParams
from ..device import resolve_device
from ..ops.disseminate import answer_tables, disseminate, edge_tables
from ..ops.graph import build_connection_graph
from ..ops.heartbeat import run_heartbeats
from ..ops.state import SimParams, init_state
from ..parallel import peer
from .simulator import (
    MUXER_PROC_MS,
    MessageRecord,
    drain_heartbeat_carry,
    record_from_result,
)


@dataclass
class MultiTopicConfig:
    topo: TopoParams = field(default_factory=TopoParams)
    topics: tuple = ("test",)
    connect_to: int = 10
    gossipsub: GossipSubParams = field(default_factory=GossipSubParams)
    subscribe_fraction: float = 1.0
    warmup_s: float = 60.0
    seed: int = 0
    with_gossip: bool = True
    max_connections: int = 250
    self_trigger: bool = True
    loss_mode: str = "tcp"

    def validate(self) -> None:
        self.topo.validate()
        self.gossipsub.validate()
        if self.loss_mode not in ("message", "tcp"):
            raise ValueError(f"unknown loss_mode {self.loss_mode!r}")
        if not self.topics:
            raise ValueError("need at least one topic")
        if len(set(self.topics)) != len(self.topics):
            raise ValueError("duplicate topic names")
        if not (0.0 < self.subscribe_fraction <= 1.0):
            raise ValueError("subscribe_fraction must be in (0, 1]")


class _TopicStateView:
    """Per-topic view of the flat (T*N, ...) state: every peer-major leaf
    reshapes to (T, N, ...); scalars pass through."""

    def __init__(self, state, n_topics: int, n_peers: int):
        self._state = state
        self._t = n_topics
        self._n = n_peers

    def __getattr__(self, name):
        leaf = getattr(self._state, name)
        if (isinstance(leaf, torch.Tensor) and leaf.dim() >= 1
                and leaf.shape[0] == self._t * self._n):
            return leaf.reshape((self._t, self._n) + tuple(leaf.shape[1:]))
        return leaf


@dataclass
class _BlockResult:
    """One topic's N-row window of a stacked DisseminationResult, with the
    publish-wide scalars (error bar, certificate, refine passes)."""

    delay_ms: torch.Tensor
    received: torch.Tensor
    sends: torch.Tensor
    copies_rx: torch.Tensor
    ihave_sent: torch.Tensor
    iwant_sent: torch.Tensor
    answer_wait_max_ms: torch.Tensor
    converged: torch.Tensor
    refine_passes: torch.Tensor

    @classmethod
    def of(cls, res, blk: slice) -> "_BlockResult":
        return cls(
            delay_ms=res.delay_ms[blk], received=res.received[blk],
            sends=res.sends[blk], copies_rx=res.copies_rx[blk],
            ihave_sent=res.ihave_sent[blk], iwant_sent=res.iwant_sent[blk],
            answer_wait_max_ms=res.answer_wait_max_ms,
            converged=res.converged, refine_passes=res.refine_passes)


class MultiTopicSimulator:
    """T topics over one shared connection graph, stacked as virtual peers,
    on one device (CUDA unless the caller passes device="cpu")."""

    def __new__(cls, cfg=None, topology=None, device=None, mesh=None):
        if mesh is not None and cls is MultiTopicSimulator:
            from .sharded import ShardedMultiTopicSimulator

            return super().__new__(ShardedMultiTopicSimulator)
        return super().__new__(cls)

    def __init__(self, cfg: MultiTopicConfig,
                 topology: Topology | None = None, device=None, mesh=None):
        """`mesh`: a peer mesh; the constructor then returns a
        runtime/sharded.ShardedMultiTopicSimulator."""
        self.mesh = None
        cfg.validate()
        self.device = dev = resolve_device(device)
        self._configure(cfg, topology)
        tcount, n = len(cfg.topics), self.n_peers
        # block-diagonal stack: per-topic copies of the same physical edges
        # shifted by t*N; padding (-1) stays padding, and rev/out_mask are
        # slot-local, so a plain tile suffices
        off = (np.arange(tcount) * n)[:, None, None]
        conns = np.where(self.graph.conns[None] >= 0,
                         self.graph.conns[None] + off, -1
                         ).reshape(tcount * n, -1)
        self.arrays = {
            "conns": torch.as_tensor(peer.local(conns), device=dev),
            "rev": torch.as_tensor(
                peer.local(np.tile(self.graph.rev, (tcount, 1))), device=dev),
            "out_mask": torch.as_tensor(
                peer.local(np.tile(self.graph.out_mask, (tcount, 1))),
                device=dev),
        }
        self._stage = torch.as_tensor(
            peer.local(np.tile(self.topology.stage_of_peer, tcount)),
            device=dev)
        self._lat = torch.as_tensor(self.topology.latency_ms, device=dev)
        self._bw = torch.as_tensor(self.topology.bw_up_mbit, device=dev)
        # the tiled stage array already indexes the stage-pair loss matrix
        self._loss = (
            torch.as_tensor(self.topology.packet_loss, device=dev)
            if float(np.max(self.topology.packet_loss)) > 0.0 else None)
        # experiment constants, built once (valid across topic blocks)
        self._lat_edge, self._loss_edge = edge_tables(
            self._stage, self._lat, self.arrays["conns"], self.arrays["rev"],
            self._loss)
        self._ans_tables = (answer_tables(self._lat_edge, self.arrays["conns"])
                            if cfg.with_gossip else None)
        self.state = self._initial_state()

    def _configure(self, cfg: MultiTopicConfig, topology) -> None:
        """The host side of the constructor: topology, connection graph,
        params, the subscription draw and the host counters."""
        self.cfg = cfg
        self.topology = topology or Topology.build(cfg.topo)
        n = cfg.topo.network_size
        tcount = len(cfg.topics)
        self.n_peers = n
        self.graph = build_connection_graph(
            n, cfg.connect_to, seed=cfg.seed,
            max_degree=min(cfg.max_connections, max(4 * cfg.connect_to, 16)),
        )
        proc_ms = MUXER_PROC_MS.get(cfg.topo.muxer.lower(), 2.0)
        self.params = SimParams.from_gossipsub(
            tcount * n, self.graph.capacity, cfg.gossipsub,
            proc_delay_ms=proc_ms,
        )
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0x709]))
        self.subscribed_np = np.ones((tcount, n), dtype=bool)
        if cfg.subscribe_fraction < 1.0:
            # a topic with no subscribers is legal ("no peers" health)
            self.subscribed_np = (rng.random((tcount, n))
                                  < cfg.subscribe_fraction)
        self._hb_carry_ms = 0.0
        self.records: list[tuple[str, MessageRecord]] = []
        self._msg_rng = np.random.default_rng(cfg.seed ^ 0x6D736749)

    def _initial_state(self):
        """init_state with the subscription draw and one heartbeat phase
        per physical node, tiled across the topic blocks."""
        tcount = len(self.cfg.topics)
        state = init_state(self.params, seed=self.cfg.seed,
                           device=self.device)
        phase_node = peer.all_rows(state.hb_phase)[: self.n_peers]
        return state.replace(
            subscribed=torch.as_tensor(
                peer.local(self.subscribed_np.reshape(-1)),
                device=self.device),
            hb_phase=peer.local(phase_node.repeat(tcount)))

    def reset(self) -> None:
        """Rewind to the pre-warm-up state, keeping the stacked graph,
        topology and subscription draw."""
        self.state = self._initial_state()
        self._hb_carry_ms = 0.0
        self.records = []
        self._msg_rng = np.random.default_rng(self.cfg.seed ^ 0x6D736749)

    # -------------------------------------------------------------- stepping

    @property
    def states(self) -> _TopicStateView:
        """(T, N, ...) reshaped view of the flat per-topic state."""
        return _TopicStateView(self.state, len(self.cfg.topics), self.n_peers)

    def advance(self, ms: float) -> None:
        """Advance all topics' meshes together."""
        steps, self._hb_carry_ms = drain_heartbeat_carry(
            self._hb_carry_ms, ms, self.params.heartbeat_ms)
        if steps <= 0:
            return
        a = self.arrays
        self.state = run_heartbeats(self.state, a["conns"], a["rev"],
                                    a["out_mask"], self.params, steps)

    def warmup(self) -> None:
        self.advance(self.cfg.warmup_s * 1000.0)

    # --------------------------------------------------------------- publish

    def topic_index(self, topic: str) -> int:
        try:
            return self.cfg.topics.index(topic)
        except ValueError:
            raise KeyError(f"topic not joined: {topic!r}") from None

    def publish(self, topic: str, publisher: int,
                msg_size: int | None = None) -> MessageRecord:
        """One message on one topic; dissemination stays inside the
        topic's block by construction. A publisher not subscribed to the
        topic sends through the v1.1 fanout path."""
        ti = self.topic_index(topic)
        size = (msg_size if msg_size is not None
                else self.cfg.topo.msg_size_bytes)
        n = self.n_peers
        t0_ms = self._t_now() + self._hb_carry_ms
        subscribed = bool(self.subscribed_np[ti][publisher])
        res = self._disseminate(ti * n + publisher, t0_ms, size,
                                not subscribed)
        rec = record_from_result(
            _BlockResult.of(res, slice(ti * n, (ti + 1) * n)),
            msg_id=int(self._msg_rng.integers(0, 2**63, dtype=np.int64)),
            publisher=publisher,
            t0_ms=t0_ms,
            # no self-delivery with SELFTRIGGER off, and never when
            # unsubscribed (the fanout publisher has no topic handler)
            drop_self=publisher
            if (not self.cfg.self_trigger or not subscribed) else None,
        )
        self.records.append((topic, rec))
        return rec

    def _t_now(self) -> float:
        """The sim clock (ms) as a Python float."""
        return float(self.state.t_ms)

    def _disseminate(self, row: int, t0_ms: float, size: int,
                     with_fanout: bool):
        """One disseminate() from virtual-peer row `row`, then the
        occupancy fold across topic blocks; returns the result."""
        a, n = self.arrays, self.n_peers
        res, self.state = disseminate(
            self.state, a["conns"], a["rev"], self._stage, self._lat,
            self._bw, publisher=row, t0_ms=t0_ms,
            params=self.params, payload_bytes=size,
            fragments=self.cfg.topo.num_frags,
            with_gossip=self.cfg.with_gossip, loss_stage=self._loss,
            loss_mode=self.cfg.loss_mode, lat_edge=self._lat_edge,
            loss_edge=self._loss_edge, ans_tables=self._ans_tables,
            with_fanout=with_fanout,
        )
        # one uplink and one downlink per physical node: fold the occupancy
        # across topic blocks so a publish on topic B queues behind topic
        # A's traffic (a cross-row max: on a rank, of the gathered rows)
        t_ct = len(self.cfg.topics)
        if t_ct > 1:
            def _fold(x):
                every = peer.all_rows(x)
                return peer.local(
                    every.reshape(t_ct, n).amax(dim=0).repeat(t_ct))

            self.state = self.state.replace(
                uplink_free_ms=_fold(self.state.uplink_free_ms),
                rx_free_ms=_fold(self.state.rx_free_ms))
        return res

    def publish_batch(self, items, msg_size: int | None = None,
                      pad_to: int | None = None) -> list[MessageRecord]:
        """Inject the (topic, publisher) pairs of `items` at the current
        sim time, in order: one publish() each, so one batch may mix
        topics and the cross-topic occupancy fold runs between messages.
        All pairs must share one fanout bucket. `pad_to` as in
        Simulator.publish_batch."""
        pairs = [(str(t), int(p)) for t, p in items]
        if len({bool(self.subscribed_np[self.topic_index(t)][p])
                for t, p in pairs}) > 1:
            raise ValueError(
                "publish_batch requires a uniform fanout bucket: mixed "
                "subscribed/unsubscribed (topic, publisher) pairs in one "
                "batch — group them first (NodeService._group_batch does)")
        return [self.publish(t, p, msg_size=msg_size) for t, p in pairs]

    # --------------------------------------------------------------- metrics

    def mesh_sizes(self) -> dict:
        """Per-topic mean mesh degree over subscribed and alive peers.
        The degrees are summed on the device and only (T, 2) integers
        move to the host; the integer sum and count give numpy's mean of
        the degrees exactly (float64 sums of integers below 2^53)."""
        member = (torch.as_tensor(self.subscribed_np, device=self.device)
                  & self.states.alive)                     # (T, N)
        deg = self.states.mesh_mask.sum(dim=-1)            # (T, N) int64
        tot_cnt = torch.stack([torch.where(member, deg, 0).sum(dim=-1),
                               member.sum(dim=-1)], dim=1).cpu().numpy()
        return {name: (float(np.float64(tot) / np.float64(cnt)) if cnt
                       else 0.0)
                for name, (tot, cnt) in zip(self.cfg.topics, tot_cnt)}

    def topic_health(self) -> dict:
        """The Go tracer's classifier: 'no' with no mesh peers, 'low' under
        D_lo, else 'healthy', from the mean mesh degree."""
        sizes = self.mesh_sizes()
        d_lo = self.params.d_low
        return {
            name: ("no" if s == 0 else "low" if s < d_lo else "healthy")
            for name, s in sizes.items()
        }
