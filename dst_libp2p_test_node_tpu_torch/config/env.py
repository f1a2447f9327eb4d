"""Node configuration layer (reference L2): env-var parsing, peer identity, ports.

Mirrors the env surface of every reference node:
  - flagship GossipSub node: nim-test-node/gossipsub-queues/env.nim:5-36 and
    the ~20 GOSSIPSUB_* overrides in main.nim:252-306;
  - go node: go-test-node/env.go:21-105; rust node: rust-test-node/src/env.rs:10-87;
  - role-based nodes (NODE_ROLE): connmanager/env.nim:7-105, kad-dht/env.nim:8-35,
    service-discovery/env.nim:6-189; regression/env.nim:5-37.

Deliberate quirk resolutions (SURVEY.md §7 "known reference quirks"):
  - SHADOWENV: topogen writes "1" but Nim/Go/Rust test == "true"
    (topogen.py:7,110 vs env.nim:6/env.go:28/env.rs:55-57). We accept
    1|true|yes|on, as service-discovery's parser already does (env.nim:66-74).
  - identity: hostname-ordinal. Nim takes the LAST '-'-separated field
    (env.nim:16), Go/Rust take field [1] (env.go:67, env.rs:34). We follow Nim
    (last field) — correct for StatefulSet names like "nimp2p-0" AND "pod-12".
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field

# Fixed port contract (SURVEY.md Appendix B).
LIBP2P_PORT = 5000       # env.nim:9 (overridable via PORT in role-based nodes)
PROMETHEUS_PORT = 8008   # env.nim:8, env.go:23, env.rs:12
HTTP_CONTROL_PORT = 8645  # env.nim:7, env.go:24, env.rs:11

_TRUTHY = {"1", "true", "yes", "on"}


def env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name, "")
    if v == "":
        return default
    return v.strip().lower() in _TRUTHY


def env_int(name: str, default: int) -> int:
    """Invalid values fall back to the default with no exception, matching the
    reference's getEnvInt (gossipsub-queues/main.nim:79-91)."""
    v = os.environ.get(name, "")
    if v == "":
        return default
    try:
        return int(v)
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    if v == "":
        return default
    try:
        return float(v)
    except ValueError:
        return default


def env_str(name: str, default: str) -> str:
    v = os.environ.get(name, "")
    return v if v != "" else default


def hostname_ordinal(hostname: str | None = None) -> int:
    """'pod-12' -> 12, 'nimp2p-service-3' -> 3 (env.nim:16: split('-')[^1]).

    An unparseable hostname falls back to ordinal 0. The reference is split on
    this: the flagship node's bare parseInt raises (env.nim:16) while
    connmanager deliberately catches and defaults to 0
    (connmanager/env.nim:93-95); we follow the forgiving rule so the framework
    also runs outside ordinal-named StatefulSet pods (tests, notebooks)."""
    h = hostname if hostname is not None else socket.gethostname()
    try:
        return int(h.split("-")[-1])
    except ValueError:
        return 0


@dataclass
class GossipSubParams:
    """GossipSub tunables with the reference's defaults.

    Sources: gossipsub-queues/main.nim:252-306 (env names + defaults),
    go-test-node/main.go:153-174, rust-test-node/src/main.rs:223-241.
    """

    d: int = 6
    d_low: int = 4
    d_high: int = 8
    d_score: int | None = None  # default = dLow (main.nim:257)
    d_out: int | None = None    # default = d div 2 (main.nim:258)
    d_lazy: int | None = None   # default = d (main.nim:259)

    heartbeat_ms: int = 1000
    prune_backoff_sec: int = 60

    max_high_priority_queue_len: int = 256
    max_medium_priority_queue_len: int = 512
    max_low_priority_queue_len: int = 1024

    slow_peer_penalty_weight: float = 0.0
    slow_peer_penalty_threshold: float = 2.0
    slow_peer_penalty_decay: float = 0.2

    decay_interval_ms: int = 1000
    decay_to_zero: float = 0.01

    flood_publish: bool = True
    opportunistic_graft_threshold: float = -10000.0
    gossip_factor: float = 0.25
    # score thresholds: the reference parses these but comments the
    # assignments out (main.nim:276-278,306-308), so nim-libp2p's defaults
    # apply — these values. The env names match the commented-out surface.
    gossip_threshold: float = -100.0
    publish_threshold: float = -1000.0
    graylist_threshold: float = -10000.0
    # mcache gossip window: IHAVE re-samples targets every heartbeat for this
    # many rounds after a message enters the cache (nim-libp2p
    # GossipSubHistoryGossip default; gossip every heartbeat over history,
    # main.nim:259,283)
    history_gossip: int = 3

    # topicParams (main.nim:335-340)
    topic_weight: float = 1.0
    first_message_deliveries_weight: float = 1.0
    first_message_deliveries_cap: float = 30.0
    first_message_deliveries_decay: float = 0.9

    # go node extension: IDONTWANT threshold (go-test-node/main.go:165)
    idontwant_message_threshold: int = 1000

    def __post_init__(self) -> None:
        # derived defaults follow their base params however the object is
        # built (env path and direct construction share one rule)
        if self.d_score is None:
            self.d_score = self.d_low
        if self.d_out is None:
            self.d_out = self.d // 2
        if self.d_lazy is None:
            self.d_lazy = self.d

    def validate(self) -> None:
        if not (self.d_low <= self.d <= self.d_high):
            raise ValueError(
                f"require D_low <= D <= D_high, got {self.d_low} <= {self.d} <= {self.d_high}"
            )
        if self.heartbeat_ms <= 0:
            raise ValueError("heartbeat_ms must be positive")
        if self.history_gossip < 1:
            raise ValueError(
                f"history_gossip must be >= 1, got {self.history_gossip}")
        for name in ("gossip_threshold", "publish_threshold",
                     "graylist_threshold"):
            if getattr(self, name) > 0:
                raise ValueError(f"{name} must be <= 0 (v1.1 spec)")


def gossipsub_params_from_env() -> GossipSubParams:
    d = env_int("GOSSIPSUB_D", 6)
    d_low = env_int("GOSSIPSUB_D_LOW", 4)
    p = GossipSubParams(
        d=d,
        d_low=d_low,
        d_high=env_int("GOSSIPSUB_D_HIGH", 8),
        d_score=env_int("GOSSIPSUB_D_SCORE", d_low),
        d_out=env_int("GOSSIPSUB_D_OUT", d // 2),
        d_lazy=env_int("GOSSIPSUB_D_LAZY", d),
        heartbeat_ms=env_int("GOSSIPSUB_HEARTBEAT_MS", 1000),
        prune_backoff_sec=env_int("GOSSIPSUB_PRUNE_BACKOFF_SEC", 60),
        max_high_priority_queue_len=env_int("GOSSIPSUB_MAX_HIGH_PRIORITY_QUEUE_LEN", 256),
        max_medium_priority_queue_len=env_int("GOSSIPSUB_MAX_MEDIUM_PRIORITY_QUEUE_LEN", 512),
        max_low_priority_queue_len=env_int("GOSSIPSUB_MAX_LOW_PRIORITY_QUEUE_LEN", 1024),
        slow_peer_penalty_weight=env_float("GOSSIPSUB_SLOW_PEER_PENALTY_WEIGHT", 0.0),
        slow_peer_penalty_threshold=env_float("GOSSIPSUB_SLOW_PEER_PENALTY_THRESHOLD", 2.0),
        slow_peer_penalty_decay=env_float("GOSSIPSUB_SLOW_PEER_PENALTY_DECAY", 0.2),
        decay_interval_ms=env_int("GOSSIPSUB_DECAY_INTERVAL_MS", 1000),
        decay_to_zero=env_float("GOSSIPSUB_DECAY_TO_ZERO", 0.01),
        flood_publish=env_bool("GOSSIPSUB_FLOOD_PUBLISH", True),
        opportunistic_graft_threshold=env_float("GOSSIPSUB_OPPORTUNISTIC_GRAFT_THRESHOLD", -10000.0),
        gossip_factor=env_float("GOSSIPSUB_GOSSIP_FACTOR", 0.25),
        gossip_threshold=env_float("GOSSIPSUB_GOSSIP_THRESHOLD", -100.0),
        publish_threshold=env_float("GOSSIPSUB_PUBLISH_THRESHOLD", -1000.0),
        graylist_threshold=env_float("GOSSIPSUB_GRAYLIST_THRESHOLD", -10000.0),
        history_gossip=env_int("GOSSIPSUB_HISTORY_GOSSIP", 3),
        idontwant_message_threshold=env_int("GOSSIPSUB_IDONTWANT_THRESHOLD", 1000),
    )
    p.validate()
    return p


VALID_MUXERS = ("yamux", "mplex", "quic")


@dataclass
class NodeConfig:
    """The shared node surface (getPeerDetails: env.nim:13-36, env.go:21-105)."""

    my_id: int = 0
    network_size: int = 100
    connect_to: int = 10
    muxer: str = "yamux"
    fragments: int = 1
    in_shadow: bool = False
    max_connections: int = 250       # main.nim:429
    self_trigger: bool = True        # SELFTRIGGER (main.nim:245)
    peer_id_offset: int = 0          # env.nim:17
    service: str = "nimp2p-service"  # main.nim:383
    file_path: str = "./"            # env.nim:22 (parsed but unused in reference)
    publishers: int = 10             # topogen env PUBLISHERS (topogen.py:111)
    topic: str = "test"              # main.nim:450
    role: str = ""                   # NODE_ROLE for role-based nodes

    # Mix-routing surface documented in the root README (README.md:30,42-46)
    # but absent from the reference snapshot's code — implemented here per
    # SURVEY.md §5 (BASELINE config 5 requires it).
    mounts_mix: bool = False
    uses_mix: bool = False
    num_mix: int = 0
    mix_d: int = 4

    gossipsub: GossipSubParams = field(default_factory=GossipSubParams)

    def validate(self) -> None:
        if self.muxer.lower() not in VALID_MUXERS:
            raise ValueError(f"Unknown muxer type : {self.muxer}")
        if self.connect_to >= self.network_size:
            raise ValueError(
                "Not enough peers to make target connections. Network size : "
                f"{self.network_size}"
            )
        if self.uses_mix and self.num_mix < self.mix_d + 1:
            # fail fast on the surface BASELINE config 5 depends on, rather
            # than silently running without anonymity. The +1: any peer may
            # publish via /publish, and a mix-node publisher is excluded
            # from its own relay path
            raise ValueError(
                f"USESMIX requires NUMMIX >= MIXD + 1, got "
                f"NUMMIX={self.num_mix} MIXD={self.mix_d}"
            )
        self.gossipsub.validate()

    @property
    def address(self) -> str:
        """Listen multiaddr (env.nim:23-26)."""
        if self.muxer.lower() == "quic":
            return f"/ip4/0.0.0.0/udp/{LIBP2P_PORT}/quic-v1"
        return f"/ip4/0.0.0.0/tcp/{LIBP2P_PORT}"


def get_peer_details(hostname: str | None = None) -> NodeConfig:
    """Parse the canonical env surface into a NodeConfig (env.nim:13-36)."""
    in_shadow = env_bool("SHADOWENV", False)
    cfg = NodeConfig(
        my_id=env_int("PEER_ID_OFFSET", 0) + hostname_ordinal(hostname),
        network_size=env_int("PEERS", 100),
        connect_to=env_int("CONNECTTO", 10),
        muxer=env_str("MUXER", "yamux"),
        fragments=env_int("FRAGMENTS", 1),
        in_shadow=in_shadow,
        max_connections=env_int("MAXCONNECTIONS", 250),
        self_trigger=env_bool("SELFTRIGGER", True),
        peer_id_offset=env_int("PEER_ID_OFFSET", 0),
        service=env_str("SERVICE", "nimp2p-service"),
        file_path="../" if in_shadow else env_str("FILEPATH", "./"),
        publishers=env_int("PUBLISHERS", 10),
        role=env_str("NODE_ROLE", ""),
        mounts_mix=env_bool("MOUNTSMIX", False),
        uses_mix=env_bool("USESMIX", False),
        num_mix=env_int("NUMMIX", 0),
        mix_d=env_int("MIXD", 4),
        gossipsub=gossipsub_params_from_env(),
    )
    cfg.validate()
    return cfg
