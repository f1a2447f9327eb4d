"""Regression-node runtime: GossipSub over kad-dht discovery plus mesh
pings (the port of the reference's runtime/regression_runtime.py).

The reference regression node (nim-test-node/regression/{main,env,
ping_utils,kad_utils}.nim) runs the flagship's GossipSub core but forms its
mesh through Kademlia bootstrap:

  RoleBootstrap  kad-dht anchor only (main.nim:219-223)
  RoleNormal     GossipSub(+ping)+kad -> STARTSLEEP -> dial bootstrap ->
                 seedBootstraps + kad.bootstrap(forceRefresh)
                 (kad_utils.nim:88-94) -> mesh from DHT-discovered
                 connections -> pingMeshLoop every 45 s
                 (ping_utils.nim:8-15, 23-87)

Discovery is batched FIND_NODE waves (ops/kad.py): one self-lookup round
and warm-up random rounds. The GossipSub graph is then sampled from each
node's routing table and the port's Simulator runs on it, so each advance
runs the score_update kernel and receiver-side fixpoints the vmem_gather
one. As in the reference, the Simulator is built on a shuffle graph and
the discovered graph, its params and a fresh state are swapped in after;
the edge-latency, loss, answer-queue and neighbour-validity tables stay
those of the shuffle graph (a reference caveat the port reproduces).
Everything runs on one device, CUDA unless the caller passes device="cpu".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config.env import GossipSubParams, env_int, env_str
from ..config.topology import Topology, TopoParams
from ..device import resolve_device
from ..ops import kad
from ..ops.graph import ConnGraph, build_connection_graph
from .simulator import ExperimentConfig, MessageRecord, Simulator

MESH_PING_INTERVAL_S = 45.0     # ping_utils.nim:9
MESH_PING_TIMEOUT_MS = 4000.0   # ping_utils.nim:10


def regression_gossipsub_params() -> GossipSubParams:
    """The regression node's fixed GossipSub tuning (main.nim:141-152)."""
    return GossipSubParams(d=6, d_low=4, d_high=8, d_score=6, d_out=3,
                           d_lazy=6)


@dataclass
class RegressionConfig:
    network_size: int = 100
    n_bootstrap: int = 1
    connect_to: int = 10
    start_sleep_s: float = 180.0      # STARTSLEEP (env.nim:15)
    discovery_rounds: int = 3         # bootstrap + warm-up lookup waves
    muxer: str = "yamux"
    fragments: int = 1                # FRAGMENTS
    msg_size: int = 1000
    messages: int = 10
    delay_seconds: float = 4.0
    ping_rounds: int = 2              # pingMeshLoop iterations to simulate
    seed: int = 0
    topo: TopoParams | None = None

    def validate(self) -> None:
        if self.n_bootstrap < 1:
            raise ValueError("need at least one bootstrap")
        if self.n_bootstrap + self.connect_to >= self.network_size:
            raise ValueError("connect_to too large for network size")


@dataclass
class PingRecord:
    peer: int
    target: int
    ping_ms: float


@dataclass
class RegressionSummary:
    census_mean: float
    mesh_degree_mean: float
    coverage: float
    ping_count: int
    ping_ms_p50: float
    ping_ms_p99: float
    ping_timeouts: int

    def report(self) -> str:
        return "\n".join([
            "Regression summary",
            f"Routing table census: mean {self.census_mean:.1f}",
            f"Mesh degree: mean {self.mesh_degree_mean:.1f}",
            f"Coverage: {self.coverage * 100.0:.1f}%",
            f"Mesh pings: {self.ping_count} "
            f"({self.ping_timeouts} over the {MESH_PING_TIMEOUT_MS:.0f} ms "
            "timeout)",
            f"Ping RTT ms: p50 {self.ping_ms_p50:.0f} "
            f"p99 {self.ping_ms_p99:.0f}",
        ])


def discovery_graph(kstate: kad.KadState, connect_to: int,
                    bootstraps: np.ndarray, seed: int) -> ConnGraph:
    """Sample each node's dials from its routing table (host numpy,
    kad_utils.nim:8-11): nodes with fewer than connect_to entries dial what
    they have plus the anchors, then ring neighbours."""
    rtable = kstate.rtable.cpu().numpy()
    n = rtable.shape[0]
    rng = np.random.default_rng(seed ^ 0x4E6)
    dials = np.full((n, connect_to), -1, dtype=np.int64)
    for p in range(n):
        known = np.unique(rtable[p][rtable[p] >= 0])
        known = known[known != p]
        if len(known) >= connect_to:
            dials[p] = rng.choice(known, size=connect_to, replace=False)
        else:
            pool = np.unique(np.concatenate([known, bootstraps]))
            pool = pool[pool != p]
            take = min(len(pool), connect_to)
            dials[p, :take] = rng.choice(pool, size=take, replace=False)
            if take < connect_to:  # pad with ring neighbours (never self)
                pad = (p + 1 + np.arange(connect_to - take)) % n
                dials[p, take:] = np.where(pad == p, (p + 1) % n, pad)
    return build_connection_graph(n, connect_to, seed=seed, dials=dials)


class RegressionSimulator:
    """Discovery, then dissemination: ops/kad forms the graph, the port's
    Simulator runs GossipSub on it, plus mesh ping probes."""

    def __init__(self, cfg: RegressionConfig, device=None):
        cfg.validate()
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        n = cfg.network_size
        topo = cfg.topo or TopoParams(
            network_size=n, muxer=cfg.muxer, msg_size_bytes=cfg.msg_size,
            num_frags=cfg.fragments, messages=cfg.messages,
            delay_seconds=cfg.delay_seconds,
        )
        self.topo_params = topo
        self.topology = Topology.build(topo)
        self._stage = torch.as_tensor(self.topology.stage_of_peer, device=dev)
        self._lat = torch.as_tensor(self.topology.latency_ms, device=dev)
        self.kstate = kad.init_kad_state(n, seed=cfg.seed, device=dev)
        self.bootstraps = torch.arange(cfg.n_bootstrap, device=dev)
        self.lines: list[str] = []
        self.pings: list[PingRecord] = []
        self.sim: Simulator | None = None

    def _log(self, line: str) -> None:
        self.lines.append(line)

    # ---------------------------------------------------------------- phases

    def discover(self) -> None:
        """STARTSLEEP -> connectToBootstrap -> seedBootstraps (one
        self-lookup wave, the forceRefresh bootstrap round) -> warm-up
        random waves (main.nim:223-232)."""
        from .. import prng

        cfg = self.cfg
        self.kstate = kad.seed_bootstraps(self.kstate, self.bootstraps)
        self._log(f"kad-dht discovery active bootstraps={cfg.n_bootstrap}")
        origins = torch.arange(cfg.n_bootstrap, cfg.network_size,
                               device=self.device)
        _, self.kstate = kad.find_node(self.kstate, origins,
                                       self.kstate.keys[origins],
                                       self._stage, self._lat)
        key = prng.PRNGKey(cfg.seed ^ 0x4E62, self.device)
        for _ in range(cfg.discovery_rounds - 1):
            key, k = prng.split(key)
            _, self.kstate = kad.find_node(
                self.kstate, origins,
                kad.random_targets(k, origins.shape[0]),
                self._stage, self._lat)

    def build_sim(self) -> Simulator:
        from ..ops.state import SimParams, graph_arrays, init_state

        cfg = self.cfg
        graph = discovery_graph(self.kstate, cfg.connect_to,
                                np.arange(cfg.n_bootstrap), cfg.seed)
        exp = ExperimentConfig(
            topo=self.topo_params,
            connect_to=cfg.connect_to,
            gossipsub=regression_gossipsub_params(),
            publisher_id=cfg.n_bootstrap,      # first normal node publishes
            warmup_s=cfg.start_sleep_s / 4.0,  # meshes stabilize post-dial
            seed=cfg.seed,
        )
        sim = Simulator(exp, topology=self.topology, device=self.device)
        # swap in the discovered graph (the Simulator built a shuffle graph
        # and its edge tables)
        sim.graph = graph
        sim.params = SimParams.from_gossipsub(
            cfg.network_size, graph.capacity, regression_gossipsub_params())
        sim.state = init_state(sim.params, seed=cfg.seed, device=self.device)
        sim.arrays = graph_arrays(graph, device=self.device)
        self.sim = sim
        return sim

    def ping_round(self) -> None:
        """One pingMeshLoop pass: ping every mesh peer (ping_utils.nim:
        84-87), RTT = 2 x stage latency + dial/processing overhead."""
        assert self.sim is not None
        mesh = self.sim.state.mesh_mask.cpu().numpy()
        conns = np.asarray(self.sim.graph.conns)
        stage = np.asarray(self.topology.stage_of_peer)
        lat = np.asarray(self.topology.latency_ms)
        p_idx, s_idx = np.nonzero(mesh & (conns >= 0))
        targets = conns[p_idx, s_idx]
        rtt = 2.0 * lat[stage[p_idx], stage[targets]] + 2.0
        for p, q, ms in zip(p_idx, targets, rtt):
            self.pings.append(PingRecord(int(p), int(q), float(ms)))
        # log a sample (the reference logs every ping; keep lines bounded)
        for p, q, ms in list(zip(p_idx, targets, rtt))[:20]:
            self._log(f"mesh ping peerId={q} pingMs={ms:.0f}")

    def run(self) -> RegressionSummary:
        cfg = self.cfg
        self.discover()
        sim = self.build_sim()
        sim.warmup()
        mesh_deg = float(sim.state.mesh_mask.sum(dim=-1).cpu().numpy()
                         .mean())
        self._log(f"Mesh details meshSize={mesh_deg:.1f}")
        for i in range(cfg.messages):
            if i > 0:
                sim.advance(cfg.delay_seconds * 1000.0)
            sim.publish(cfg.n_bootstrap)
        for _ in range(cfg.ping_rounds):
            self.ping_round()
            sim.advance(MESH_PING_INTERVAL_S * 1000.0)
        return self.summary()

    # --------------------------------------------------------------- outputs

    def summary(self) -> RegressionSummary:
        assert self.sim is not None
        census = kad.rtable_census(self.kstate).cpu().numpy()
        deg = self.sim.state.mesh_mask.sum(dim=-1).cpu().numpy()
        recs = self.sim.records
        n = self.cfg.network_size
        cov = (np.mean([r.received.sum() / n for r in recs])
               if recs else 0.0)
        ping_ms = np.array([p.ping_ms for p in self.pings]) \
            if self.pings else np.zeros(1)
        return RegressionSummary(
            census_mean=float(census.mean()),
            mesh_degree_mean=float(deg.mean()),
            coverage=float(cov),
            ping_count=len(self.pings),
            ping_ms_p50=float(np.percentile(ping_ms, 50)),
            ping_ms_p99=float(np.percentile(ping_ms, 99)),
            ping_timeouts=int((ping_ms > MESH_PING_TIMEOUT_MS).sum()),
        )

    def records(self) -> list[MessageRecord]:
        return self.sim.records if self.sim else []


def config_from_env() -> RegressionConfig:
    """STARTSLEEP/FRAGMENTS/MUXER/NODE_ROLE surface (regression/env.nim)."""
    return RegressionConfig(
        network_size=env_int("PEERS", 100),
        n_bootstrap=env_int("REGRESSION_BOOTSTRAPS", 1),
        connect_to=env_int("CONNECTTO", 10),
        start_sleep_s=float(env_int("STARTSLEEP", 180)),
        muxer=env_str("MUXER", "yamux"),
        fragments=env_int("FRAGMENTS", 1),
        seed=env_int("SEED", 0),
    )
