"""Service-discovery experiment runtime (the port of the reference's
runtime/sd_runtime.py; nim-test-node/service-discovery/{main,core,env}.nim).

Role program (main.nim:8-62): RoleBootstrap anchors the DHT; RoleAdvertiser
advertises its ADVERTISE_SERVICES; RoleDiscoverer runs the lookup loop over
DISCOVER_SERVICES every LOOKUP_INTERVAL_SECONDS; RoleHybrid does both. One
advertise wave per (re-)advertise tick and service, one lookup wave per
interval tick and service. Log lines ("Advertising service", "Lookup
completed service=... advertisements=... uniquePeers=...") and the summary
are the reference's, byte for byte. Everything runs on one device, CUDA
unless the caller passes device="cpu".
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..config.topology import Topology, TopoParams
from ..device import resolve_device
from ..ops import kad
from ..ops.servicedisco import (
    SDParams,
    advertise,
    expire_sweep,
    init_advert_store,
    lookup,
    service_key,
)
from .simulator import _host


@dataclass
class SDConfig:
    network_size: int = 60
    n_bootstrap: int = 2
    n_advertisers: int = 10
    n_discoverers: int = 10
    n_hybrid: int = 0
    services: list[str] = field(default_factory=lambda: ["svc-a"])
    # DISCOVER_SERVICES; None = the advertised list (run.sh:19-45)
    discover_services: list[str] | None = None
    lookup_interval_s: int = 15   # LOOKUP_INTERVAL_SECONDS (env.nim:117)
    advertise_interval_s: int = 60  # re-advertise cadence (TTL refresh)
    duration_s: int = 60
    sd: SDParams = field(default_factory=SDParams)
    muxer: str = "yamux"
    seed: int = 0
    topo: TopoParams | None = None

    def validate(self) -> None:
        roles = (self.n_bootstrap + self.n_advertisers + self.n_discoverers
                 + self.n_hybrid)
        if any(c < 0 for c in (self.n_advertisers, self.n_discoverers,
                               self.n_hybrid)):
            raise ValueError("role counts must be >= 0")
        if roles > self.network_size:
            raise ValueError("roles exceed network size")
        if self.n_bootstrap < 1:
            raise ValueError("need at least one bootstrap")
        if (self.n_advertisers + self.n_hybrid) > 0 and not self.services:
            raise ValueError("ADVERTISE_SERVICES is required for advertisers")
        if (self.n_discoverers + self.n_hybrid) > 0 and not (
            self.discover_services if self.discover_services is not None
            else self.services
        ):
            raise ValueError("DISCOVER_SERVICES is required for discoverers")
        if self.lookup_interval_s <= 0:
            raise ValueError("LOOKUP_INTERVAL_SECONDS must be > 0")
        if self.sd.replication > kad.K_RESP:
            raise ValueError(
                f"replication {self.sd.replication} (k_store * "
                f"(1 + SD_SAFETY_PARAM)) exceeds the lookup response width "
                f"K_RESP={kad.K_RESP}; lower SD_SAFETY_PARAM or k_store"
            )


@dataclass
class SDSummary:
    lookups: int
    lookups_failed: int
    lookups_nonempty: int
    ads_mean: float
    unique_peers_mean: float
    unique_peers_max: int
    expected_providers: int
    lookup_latency_ms_p50: float
    lookup_latency_ms_p99: float
    advertise_latency_ms_p50: float

    def report(self) -> str:
        return "\n".join([
            "Service-discovery summary",
            f"Lookups: {self.lookups} ({self.lookups_nonempty} found >=1 ad, "
            f"{self.lookups_failed} failed)",
            f"Advertisements per lookup: mean {self.ads_mean:.1f}",
            f"Unique providers per lookup: mean {self.unique_peers_mean:.1f} "
            f"max {self.unique_peers_max} "
            f"(expected {self.expected_providers})",
            f"Lookup latency ms: p50 {self.lookup_latency_ms_p50:.0f} "
            f"p99 {self.lookup_latency_ms_p99:.0f}",
            f"Advertise latency ms: p50 {self.advertise_latency_ms_p50:.0f}",
        ])


class SDSimulator:
    """Batched role-program driver: bootstrap, then interleaved advertise
    and lookup ticks over `duration_s`."""

    def __init__(self, cfg: SDConfig, device=None):
        cfg.validate()
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        n = cfg.network_size
        topo = cfg.topo or TopoParams(
            network_size=n, muxer=cfg.muxer, msg_size_bytes=100)
        self.topology = Topology.build(topo)
        self._stage = torch.as_tensor(self.topology.stage_of_peer, device=dev)
        self._lat = torch.as_tensor(self.topology.latency_ms, device=dev)
        self.kstate = kad.init_kad_state(n, seed=cfg.seed, device=dev)
        self.store = init_advert_store(n, device=dev)

        b = cfg.n_bootstrap
        a = b + cfg.n_advertisers
        d = a + cfg.n_discoverers
        hy = d + cfg.n_hybrid
        self.bootstraps = torch.arange(b, device=dev)
        adv = list(range(b, a)) + list(range(d, hy))
        dis = list(range(a, d)) + list(range(d, hy))
        # one wave per (service, role), distinct origins per wave
        self.adv_nodes = (torch.tensor(adv, dtype=torch.int64, device=dev)
                          if adv else None)
        self.dis_nodes = (torch.tensor(dis, dtype=torch.int64, device=dev)
                          if dis else None)
        self.discover = (cfg.discover_services
                         if cfg.discover_services is not None
                         else cfg.services)
        union = list(dict.fromkeys(cfg.services + self.discover))
        self.all_services = union
        self.svc_index = {sid: i for i, sid in enumerate(union)}
        self.svc_keys = torch.from_numpy(np.stack(
            [service_key(sid) for sid in union]).astype(np.int64)).to(dev)
        self.seq_no = (torch.zeros((len(adv),), dtype=torch.int32,
                                   device=dev) if adv else None)
        self.t_ms = 0.0
        self.lines: list[str] = []
        self.lookup_records: list[tuple[int, int, int, float]] = []
        self.adv_latencies: list[float] = []
        self.lookups_failed = 0

    def _log(self, line: str) -> None:
        self.lines.append(line)

    def _now(self) -> torch.Tensor:
        return torch.tensor(self.t_ms, dtype=torch.float32,
                            device=self.device)

    # ---------------------------------------------------------------- phases

    def boot(self) -> None:
        cfg = self.cfg
        self.kstate = kad.seed_bootstraps(self.kstate, self.bootstraps)
        # startup jitter envelope (nodeIndex * STARTUP_JITTER_STEP_MS)
        self.t_ms += cfg.network_size * 10.0 + 5000.0
        for sid in cfg.services:
            self._log(f"Advertising service service={sid}")
        for sid in self.discover:
            self._log(f"Discovering service service={sid}")

    def advertise_tick(self) -> None:
        if self.adv_nodes is None:
            self._log("No services configured for advertising")
            return
        q = self.adv_nodes.shape[0]
        for sid in self.cfg.services:
            idx = torch.full((q,), self.svc_index[sid], dtype=torch.int32,
                             device=self.device)
            self.store, self.kstate, wave_ms = advertise(
                self.store, self.kstate, self.adv_nodes, idx, self.svc_keys,
                self.seq_no, self._stage, self._lat, self._now(),
                self.cfg.sd)
            self.adv_latencies.extend(_host(wave_ms).tolist())
        self.seq_no = self.seq_no + 1

    def lookup_tick(self) -> None:
        if self.dis_nodes is None:
            self._log("No services configured for discovery")
            return
        q = self.dis_nodes.shape[0]
        for sid in self.discover:
            si = self.svc_index[sid]
            idx = torch.full((q,), si, dtype=torch.int32, device=self.device)
            res, self.kstate = lookup(
                self.store, self.kstate, self.dis_nodes, idx, self.svc_keys,
                self._stage, self._lat, self._now(), self.cfg.sd)
            ads, uniq = _host(res.advertisements), _host(res.unique_peers)
            lat, ok = _host(res.latency_ms), _host(res.ok)
            for i in range(len(ads)):
                if not ok[i]:
                    # runLookupLoop's valueOr branch (core.nim:36-38)
                    self._log(f"Lookup failed service={sid} error=deadline "
                              f"exceeded")
                    self.lookups_failed += 1
                    continue
                self._log(f"Lookup completed service={sid} "
                          f"advertisements={ads[i]} uniquePeers={uniq[i]}")
                self.lookup_records.append(
                    (si, int(ads[i]), int(uniq[i]), float(lat[i])))

    def run(self) -> SDSummary:
        cfg = self.cfg
        self.boot()
        self.advertise_tick()           # startAdvertising at boot
        next_adv = cfg.advertise_interval_s
        next_lkp = cfg.lookup_interval_s
        for t in range(1, cfg.duration_s + 1):
            self.t_ms += 1000.0
            if t >= next_adv:
                self.advertise_tick()
                next_adv += cfg.advertise_interval_s
            if t >= next_lkp:
                self.store = expire_sweep(self.store, self._now())
                self.lookup_tick()
                next_lkp += cfg.lookup_interval_s
        return self.summary()

    # --------------------------------------------------------------- outputs

    def summary(self) -> SDSummary:
        recs = self.lookup_records
        ads = np.array([r[1] for r in recs]) if recs else np.zeros(1)
        uniq = np.array([r[2] for r in recs]) if recs else np.zeros(1)
        lats = np.array([r[3] for r in recs]) if recs else np.zeros(1)
        alat = np.array(self.adv_latencies) if self.adv_latencies \
            else np.zeros(1)
        return SDSummary(
            lookups=len(recs) + self.lookups_failed,
            lookups_failed=self.lookups_failed,
            lookups_nonempty=int((ads > 0).sum()),
            ads_mean=float(ads.mean()),
            unique_peers_mean=float(uniq.mean()),
            unique_peers_max=int(uniq.max()),
            expected_providers=self.cfg.n_advertisers + self.cfg.n_hybrid,
            lookup_latency_ms_p50=float(np.percentile(lats, 50)),
            lookup_latency_ms_p99=float(np.percentile(lats, 99)),
            advertise_latency_ms_p50=float(np.percentile(alat, 50)),
        )


def config_from_env() -> SDConfig:
    """The reference's env parser (getNodeConfig, env.nim:79-184), range
    checks raising ValueError; role counts are experiment-level."""
    import os

    from ..config.env import env_bool, env_float, env_int, env_str

    lookup_s = env_int("LOOKUP_INTERVAL_SECONDS", 15)
    if lookup_s <= 0:
        raise ValueError("LOOKUP_INTERVAL_SECONDS must be > 0")
    safety = env_float("SD_SAFETY_PARAM", 0.0)
    if safety < 0.0:
        raise ValueError("SD_SAFETY_PARAM must be >= 0")
    ip_sim = env_float("SD_IP_SIM_COEFF", 0.0)
    if ip_sim < 0.0:
        raise ValueError("SD_IP_SIM_COEFF must be >= 0")
    expiry_s = env_int("SD_ADVERT_EXPIRY_SECONDS", 900)
    if expiry_s <= 0:
        raise ValueError("SD_ADVERT_EXPIRY_SECONDS must be > 0")
    services = [s.strip() for s in
                env_str("ADVERTISE_SERVICES", "svc-a").split(",")
                if s.strip()]
    discover_raw = env_str("DISCOVER_SERVICES", "")
    discover = ([s.strip() for s in discover_raw.split(",") if s.strip()]
                if "DISCOVER_SERVICES" in os.environ else None)
    return SDConfig(
        network_size=env_int("PEERS", 60),
        n_bootstrap=env_int("SD_BOOTSTRAPS", 2),
        n_advertisers=env_int("SD_ADVERTISERS", 10),
        n_discoverers=env_int("SD_DISCOVERERS", 10),
        n_hybrid=env_int("SD_HYBRID", 0),
        services=services,
        discover_services=discover,
        lookup_interval_s=lookup_s,
        duration_s=env_int("SD_DURATION_S", 60),
        sd=SDParams(
            safety_param=safety,
            ip_sim_coefficient=ip_sim,
            advert_expiry_ms=expiry_s * 1000.0,
            xpr_publishing=env_bool("SD_XPR_PUBLISHING", True),
        ),
        muxer=env_str("MUXER", "yamux"),
        seed=env_int("SEED", 0),
    )
