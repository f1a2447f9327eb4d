"""kad-dht experiment runtime: the role-based DHT workload as sim phases
(the port of the reference's runtime/kad_runtime.py).

Replays the reference kad-dht node's role program (kad-dht/main.nim:15-72)
on the batched Kademlia substrate (ops/kad.py):

  RoleBootstrap  passive anchors: seeded into every table, serve queries
  RoleNormal     jittered start, bootstrap connect, warm-up = 5x
                 FIND_NODE(self) @ 1 s + 15x FIND_NODE(random) @ 2 s
                 (core.nim:12-35)
  RoleProbe      FIND_NODE(random) every 5 s with a 30 s timeout
                 (core.nim:38-55)

One batched lookup wave per phase tick. Log lines, records and the summary
are the reference's, byte for byte. Everything runs on one device, CUDA
unless the caller passes device="cpu".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..config.topology import Topology, TopoParams
from ..device import resolve_device
from ..ops import kad
from .simulator import _host


@dataclass
class KadConfig:
    network_size: int = 100
    n_bootstrap: int = 3          # RoleBootstrap anchors (ids 0..n_bootstrap-1)
    n_probe: int = 10             # RoleProbe tail (highest ids)
    discovery: str = "kad-dht"    # DISCOVERY: kad-dht | extended (env.nim:29)
    muxer: str = "yamux"
    probe_duration_s: float = 60.0
    probe_period_s: float = 5.0   # core.nim:55
    probe_timeout_s: float = 30.0  # core.nim:47
    seed: int = 0
    topo: TopoParams | None = None
    n_buckets: int = 24
    k_bucket: int = 16
    # extended-mode dial-failure handling (ops/kad.evict_failed); the
    # default (1, 0.0) evicts at the first failed dial
    evict_max_fails: int = 1
    evict_backoff_ms: float = 0.0

    def validate(self) -> None:
        if self.discovery not in ("kad-dht", "extended"):
            raise ValueError(f"Unknown DISCOVERY: {self.discovery}")
        if self.n_bootstrap < 1:
            raise ValueError("need at least one bootstrap")
        if self.n_probe < 0:
            raise ValueError("n_probe must be >= 0")
        if self.n_bootstrap + self.n_probe > self.network_size:
            raise ValueError("roles exceed network size")
        if self.evict_max_fails < 1:
            raise ValueError("evict_max_fails must be >= 1")
        if self.evict_backoff_ms < 0.0:
            raise ValueError("evict_backoff_ms must be >= 0")


@dataclass
class LookupRecord:
    origin: int
    target_hex: str
    self_lookup: bool
    hops: int
    latency_ms: float
    n_queries: int
    timed_out: bool


@dataclass
class KadSummary:
    census_mean: float
    census_min: int
    census_max: int
    warmup_lookups: int
    probe_lookups: int
    probe_success: int
    lookup_latency_ms_p50: float
    lookup_latency_ms_p99: float
    hops_mean: float
    queries_per_bootstrap: float

    def report(self) -> str:
        to = self.probe_lookups - self.probe_success
        return "\n".join([
            "Kad-DHT summary",
            f"Routing table census: mean {self.census_mean:.1f} "
            f"(min {self.census_min}, max {self.census_max})",
            f"Warmup lookups: {self.warmup_lookups}",
            f"Probe lookups: {self.probe_lookups} "
            f"({self.probe_success} ok, {to} timed out)",
            f"Lookup latency ms: p50 {self.lookup_latency_ms_p50:.0f} "
            f"p99 {self.lookup_latency_ms_p99:.0f}",
            f"Lookup hops: mean {self.hops_mean:.2f}",
            f"FIND_NODE served per bootstrap: {self.queries_per_bootstrap:.0f}",
        ])


def key_hex(key_row) -> str:
    return "".join(f"{int(w):08x}" for w in key_row)


class KadSimulator:
    """Batched role-program driver over ops/kad (one instance per run)."""

    def __init__(self, cfg: KadConfig, device=None):
        cfg.validate()
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        n = cfg.network_size
        topo = cfg.topo or TopoParams(
            network_size=n, muxer=cfg.muxer, msg_size_bytes=100)
        self.topology = Topology.build(topo)
        self._stage = torch.as_tensor(self.topology.stage_of_peer, device=dev)
        self._lat = torch.as_tensor(self.topology.latency_ms, device=dev)
        self.state = kad.init_kad_state(
            n, n_buckets=cfg.n_buckets, k_bucket=cfg.k_bucket, seed=cfg.seed,
            device=dev)
        self._probe_key = prng.PRNGKey(cfg.seed ^ 0x9406E, dev)
        self.bootstraps = torch.arange(cfg.n_bootstrap, device=dev)
        self.normals = torch.arange(cfg.n_bootstrap, n - cfg.n_probe,
                                    device=dev)
        self.probes = torch.arange(n - cfg.n_probe, n, device=dev)
        # DISCOVERY=extended mounts KademliaDiscovery instead of KadDHT
        # (kad-dht/helpers.nim:36-59): each wave ends with dial-backs
        self.extended = cfg.discovery == "extended"
        self.t_ms = 0.0
        self.lines: list[str] = []
        self.lookups: list[LookupRecord] = []

    def _log(self, line: str) -> None:
        self.lines.append(line)

    def _wave(self, origins, targets) -> kad.LookupResult:
        """One batched FIND_NODE wave; in extended mode the origins then
        evict the entries whose dial failed (under the retry budget) and
        connect to the peers they found."""
        # the device clock follows the role program's host clock, so the
        # eviction backoff deadlines are in sim time
        self.state = self.state.replace(t_ms=torch.tensor(
            self.t_ms, dtype=torch.float32, device=self.device))
        res, self.state = kad.find_node(self.state, origins, targets,
                                        self._stage, self._lat)
        if self.extended:
            self.state = kad.evict_failed(
                self.state, origins, res.closest,
                max_fails=self.cfg.evict_max_fails,
                backoff_base_ms=self.cfg.evict_backoff_ms)
            self.state = kad.connect_found(self.state, origins, res.closest)
        return res

    def _record_wave(self, origins, targets, res, self_lookup: bool) -> None:
        o, hops = _host(origins), _host(res.hops)
        lat, nq = _host(res.latency_ms), _host(res.n_queries)
        tg = _host(targets)
        timeout_ms = self.cfg.probe_timeout_s * 1000.0
        for i in range(len(o)):
            self.lookups.append(LookupRecord(
                origin=int(o[i]),
                target_hex=key_hex(tg[i]),
                self_lookup=self_lookup,
                hops=int(hops[i]),
                latency_ms=float(lat[i]),
                n_queries=int(nq[i]),
                timed_out=bool(lat[i] > timeout_ms),
            ))

    # ---------------------------------------------------------------- phases

    def boot(self) -> None:
        """Node starts and jittered bootstrap connects (main.nim:28-47):
        every node ends with the anchors in its table."""
        cfg = self.cfg
        for b in range(cfg.n_bootstrap):
            self._log(f"Node started peer={b} role=RoleBootstrap "
                      f"discovery={cfg.discovery}")
        self.state = kad.seed_bootstraps(self.state, self.bootstraps)
        max_jitter = (cfg.network_size - 1) * 200.0
        self.t_ms += max_jitter + 10_000.0  # jitter + dial/backoff envelope
        n_conn = cfg.network_size - cfg.n_bootstrap
        self._log(f"Connected to bootstrap nodes={n_conn} "
                  f"anchors={cfg.n_bootstrap}")

    def warmup(self) -> None:
        """5x FIND_NODE(self) @ 1 s + 15x FIND_NODE(random) @ 2 s over all
        RoleNormal nodes (core.nim:12-35)."""
        origins = self.normals
        if origins.shape[0] == 0:
            return
        self._log("Starting warmup phase")
        for i in range(1, 6):
            targets = self.state.keys[origins]
            res = self._wave(origins, targets)
            self._record_wave(origins, targets, res, True)
            census = _host(kad.rtable_census(self.state))
            self._log(f"Warmup: Finding self iteration={i}")
            self._log(f"Kad routing table peers={census.mean():.1f} "
                      f"buckets={self.cfg.n_buckets}")
            self.t_ms += 1000.0
        for i in range(1, 16):
            self._probe_key, k = prng.split(self._probe_key)
            targets = kad.random_targets(k, origins.shape[0])
            res = self._wave(origins, targets)
            self._record_wave(origins, targets, res, False)
            self._log(f"Warmup: Finding random node iteration={i}")
            self.t_ms += 2000.0
        self._log("Warmup complete")

    def probe(self, duration_s: float | None = None) -> None:
        """FIND_NODE(random) every probe_period_s over all RoleProbe nodes
        (core.nim:38-55); a lookup past the 30 s timeout is a 'Probe
        Failed'."""
        cfg = self.cfg
        origins = self.probes
        if origins.shape[0] == 0:
            return
        self._log("Starting probe loop")
        dur = duration_s if duration_s is not None else cfg.probe_duration_s
        ticks = max(int(dur / cfg.probe_period_s), 1)
        for _ in range(ticks):
            self._probe_key, k = prng.split(self._probe_key)
            targets = kad.random_targets(k, origins.shape[0])
            res = self._wave(origins, targets)
            self._record_wave(origins, targets, res, False)
            lat, tg = _host(res.latency_ms), _host(targets)
            for i in range(origins.shape[0]):
                t_hex = key_hex(tg[i])[:16]
                if lat[i] > cfg.probe_timeout_s * 1000.0:
                    self._log(f"Probe Failed target={t_hex} success=false")
                else:
                    self._log(f"Probe: Finding node target={t_hex}")
            self.t_ms += cfg.probe_period_s * 1000.0

    def run(self) -> KadSummary:
        self.boot()
        self.warmup()
        self.probe()
        return self.summary()

    # --------------------------------------------------------------- outputs

    def summary(self) -> KadSummary:
        census = _host(kad.rtable_census(self.state))
        first_probe = int(self.probes[0]) if len(self.probes) else None
        probes = [r for r in self.lookups if not r.self_lookup
                  and r.origin >= first_probe] if first_probe is not None \
            else []
        warm = [r for r in self.lookups if r.origin < first_probe] \
            if first_probe is not None else self.lookups
        lats = np.array([r.latency_ms for r in self.lookups]) \
            if self.lookups else np.zeros(1)
        hops = np.array([r.hops for r in self.lookups]) \
            if self.lookups else np.zeros(1)
        served = _host(self.state.queries_rx)
        return KadSummary(
            census_mean=float(census.mean()),
            census_min=int(census.min()),
            census_max=int(census.max()),
            warmup_lookups=len(warm),
            probe_lookups=len(probes),
            probe_success=sum(1 for r in probes if not r.timed_out),
            lookup_latency_ms_p50=float(np.percentile(lats, 50)),
            lookup_latency_ms_p99=float(np.percentile(lats, 99)),
            hops_mean=float(hops.mean()),
            queries_per_bootstrap=float(
                served[: self.cfg.n_bootstrap].mean()
            ) if self.cfg.n_bootstrap else 0.0,
        )


def config_from_env() -> KadConfig:
    """NODE_ROLE/DISCOVERY/MUXER env surface (kad-dht/env.nim:8-35) as a
    whole-experiment config: the per-process role becomes role counts."""
    from ..config.env import env_int, env_str

    return KadConfig(
        network_size=env_int("PEERS", 100),
        n_bootstrap=env_int("KAD_BOOTSTRAPS", 3),
        n_probe=env_int("KAD_PROBES", 10),
        discovery=env_str("DISCOVERY", "kad-dht"),
        muxer=env_str("MUXER", "yamux"),
        seed=env_int("SEED", 0),
    )
