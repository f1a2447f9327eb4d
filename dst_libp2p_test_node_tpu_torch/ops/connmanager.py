"""Connection-manager stress workload: hub watermark dynamics, one tick per
simulated second (the port of the reference's ops/connmanager.py).

The reference connmanager node (nim-test-node/connmanager/{main,env}.nim)
stresses nim-libp2p's ConnManager: hubs trimming with
`withWatermark(lowWater, highWater, gracePeriod, silencePeriod)` and an
optional hard cap (main.nim:54-55), protected peers (main.nim:59-60), a
hub-to-hub full mesh (main.nim:80-91), and spoke peers with three reconnect
strategies (main.nim:115-139):

  ReconnectNone        dial each hub once, then idle
  ReconnectAggressive  every 1 s: if outbound conns < |hubs|, redial all
  ReconnectBeforeGrace dial, wait reconnectInterval, disconnect all, repeat

Connection state is an (H, M) matrix (hubs x peers) of booleans plus
connect timestamps. Each tick applies, in order: the peers' dial decisions,
the hard cap (a random-priority accept), and on silence-period ticks the
watermark trim (down to lowWater, sparing protected peers and connections
inside the grace period, oldest first). `run_conn_steps` loops the ticks
and returns the per-tick connection counts. Results are bitwise the
reference's; everything runs on one device, CUDA unless the caller passes
device="cpu".
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import prng
from ..device import resolve_device

RECONNECT_NONE = 0
RECONNECT_AGGRESSIVE = 1
RECONNECT_BEFORE_GRACE = 2

BIG = 1e30


@dataclass(frozen=True)
class ConnManagerParams:
    """Static workload parameters (hub + peer env surface, env.nim:14-105)."""

    n_hubs: int = 1               # NUM_HUBS
    n_peers: int = 40
    low_water: int = 10           # WATERMARK_LOW
    high_water: int = 20          # WATERMARK_HIGH
    grace_period_s: int = 0       # WATERMARK_GRACE_PERIOD_S
    silence_period_s: int = 2     # WATERMARK_SILENCE_PERIOD_S
    max_connections: int = 0      # MAX_CONNECTIONS; 0 = no hard cap
    reconnect_interval_s: int = 55  # RECONNECT_INTERVAL_S

    def validate(self) -> None:
        if not (0 < self.low_water <= self.high_water):
            raise ValueError("require 0 < low_water <= high_water")
        if self.silence_period_s < 1:
            raise ValueError("silence_period_s must be >= 1")
        if self.n_hubs < 1 or self.n_peers < 1:
            raise ValueError("need at least one hub and one peer")


@dataclass
class ConnState:
    """Hub-spoke connection state (the reference's leaves)."""

    conn: torch.Tensor          # (H, M) bool peer-to-hub connection up
    since_ms: torch.Tensor      # (H, M) float32 connect timestamp
    hub_conn: torch.Tensor      # (H, H) bool hub-to-hub mesh
    t_ms: torch.Tensor          # () float32
    key: torch.Tensor           # (2,) int64 PRNG key words
    dials: torch.Tensor         # () int32 successful connects
    rejected: torch.Tensor      # () int32 dials refused by the hard cap
    trims: torch.Tensor         # () int32 watermark disconnects
    cycles: torch.Tensor        # () int32 grace-abuse cycle disconnects

    def replace(self, **changes) -> "ConnState":
        return dataclasses.replace(self, **changes)


def init_conn_state(params: ConnManagerParams, seed: int = 0,
                    device=None) -> ConnState:
    dev = resolve_device(device)
    h, m = params.n_hubs, params.n_peers
    i32 = torch.int32
    return ConnState(
        conn=torch.zeros((h, m), dtype=torch.bool, device=dev),
        since_ms=torch.zeros((h, m), dtype=torch.float32, device=dev),
        hub_conn=(~torch.eye(h, dtype=torch.bool, device=dev)) if h > 1
        else torch.zeros((h, h), dtype=torch.bool, device=dev),
        t_ms=torch.zeros((), dtype=torch.float32, device=dev),
        key=prng.PRNGKey(seed, dev),
        dials=torch.zeros((), dtype=i32, device=dev),
        rejected=torch.zeros((), dtype=i32, device=dev),
        trims=torch.zeros((), dtype=i32, device=dev),
        cycles=torch.zeros((), dtype=i32, device=dev),
    )


def _ranks(priority: torch.Tensor) -> torch.Tensor:
    """Each entry's position in its row's stable ascending order."""
    order = torch.argsort(priority, dim=-1, stable=True)
    pos = torch.arange(priority.shape[-1], device=priority.device)
    return torch.empty_like(order).scatter_(-1, order, pos.expand_as(order))


def conn_step(state: ConnState, reconnect_mode: torch.Tensor,
              dial_out: torch.Tensor, protected: torch.Tensor,
              params: ConnManagerParams) -> ConnState:
    """One 1-second tick of the hub/peer programs."""
    h, m = state.conn.shape
    dev = state.conn.device
    t = state.t_ms + 1000.0
    key, k_dial = prng.split(state.key)
    conn, since = state.conn, state.since_ms

    # -- peer programs (main.nim:115-139) ----------------------------------
    # before_grace: on each reconnectInterval boundary, drop everything
    tick = torch.div(t, torch.tensor(1000.0, device=dev)).to(torch.int32)
    cycle_now = ((tick % params.reconnect_interval_s == 0)
                 & (reconnect_mode == RECONNECT_BEFORE_GRACE))
    dropped = conn & cycle_now[None, :]
    cycles = state.cycles + dropped.sum(dtype=torch.int32)
    conn = conn & ~cycle_now[None, :]

    # dial decisions: aggressive redials every tick while a hub is missing;
    # none dials once, before_grace on its cycle boundary
    missing = ~conn
    aggressive = ((reconnect_mode == RECONNECT_AGGRESSIVE)
                  & (conn.sum(dim=0) < h))
    first_dial = (since.amax(dim=0) == 0.0) & ~conn.any(dim=0)
    cycler = reconnect_mode == RECONNECT_BEFORE_GRACE
    wants = dial_out & (aggressive | first_dial | (cycler & cycle_now))
    dialing = missing & wants[None, :]

    # -- hard cap (MAX_CONNECTIONS semaphore, main.nim:54-55) --------------
    if params.max_connections > 0:
        room = params.max_connections - conn.sum(dim=-1)
        order = _ranks(torch.where(dialing, prng.uniform(k_dial, (h, m)),
                                   BIG))
        accepted = dialing & (order < room[:, None])
        rejected = (dialing & ~accepted).sum(dtype=torch.int32)
    else:
        accepted = dialing
        rejected = torch.zeros((), dtype=torch.int32, device=dev)

    since = torch.where(accepted & ~conn, t, since)
    conn = conn | accepted
    dials = state.dials + accepted.sum(dtype=torch.int32)

    # -- hub watermark trim, every silencePeriod ticks ---------------------
    trim_now = tick % params.silence_period_s == 0
    count = conn.sum(dim=-1)
    over = (count > params.high_water) & trim_now
    excess = torch.where(over, count - params.low_water, 0)
    age_ms = t - since
    in_grace = age_ms < float(np.float32(params.grace_period_s * 1000.0))
    evictable = conn & ~protected[None, :] & ~in_grace
    # oldest eligible first: rank by descending age
    prio = torch.where(evictable, -age_ms, BIG)
    evict = (_ranks(prio) < excess[:, None]) & evictable
    trims = state.trims + evict.sum(dtype=torch.int32)
    conn = conn & ~evict

    return state.replace(conn=conn, since_ms=since, t_ms=t, key=key,
                         dials=dials, rejected=state.rejected + rejected,
                         trims=trims, cycles=cycles)


def run_conn_steps(state: ConnState, reconnect_mode: torch.Tensor,
                   dial_out: torch.Tensor, protected: torch.Tensor,
                   params: ConnManagerParams, steps: int):
    """`steps` seconds; returns (state, per-tick hub connection counts
    (T, H) int32), a count including the hub-to-hub mesh edges."""
    counts = []
    hub_edges = state.hub_conn.sum(dim=-1)
    for _ in range(steps):
        state = conn_step(state, reconnect_mode, dial_out, protected, params)
        counts.append((state.conn.sum(dim=-1) + hub_edges).int())
    return state, torch.stack(counts)


# ---------------------------------------------------------------- experiment


@dataclass
class ConnManagerConfig:
    """Whole-experiment shape: the reference deploys role-per-pod via
    NODE_ROLE/RECONNECT env (env.nim:39-105); here the simulator owns all
    roles, with peer counts per strategy."""

    params: ConnManagerParams = field(default_factory=ConnManagerParams)
    n_none: int = 20
    n_aggressive: int = 10
    n_before_grace: int = 10
    n_protected: int = 0          # first peers of the none-group, protected
    duration_s: int = 120
    seed: int = 0

    def roles(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        m = self.params.n_peers
        assert self.n_none + self.n_aggressive + self.n_before_grace == m
        mode = np.concatenate([
            np.full(self.n_none, RECONNECT_NONE),
            np.full(self.n_aggressive, RECONNECT_AGGRESSIVE),
            np.full(self.n_before_grace, RECONNECT_BEFORE_GRACE),
        ]).astype(np.int32)
        dial_out = np.ones(m, bool)
        protected = np.zeros(m, bool)
        protected[: self.n_protected] = True
        return mode, dial_out, protected


@dataclass
class ConnManagerSummary:
    mean_conns: float
    max_conns: int
    min_conns_after_warm: int
    dials: int
    rejected: int
    trims: int
    cycles: int
    trace: np.ndarray            # (T, H) per-tick counts

    def report(self) -> str:
        return "\n".join([
            "ConnManager summary",
            f"Hub connections: mean {self.mean_conns:.1f} max {self.max_conns} "
            f"min-after-warmup {self.min_conns_after_warm}",
            f"Dials accepted: {self.dials}  rejected by cap: {self.rejected}",
            f"Watermark trims: {self.trims}",
            f"Grace-abuse cycles: {self.cycles}",
        ])


def run_connmanager(cfg: ConnManagerConfig, device=None
                    ) -> tuple[ConnManagerSummary, ConnState]:
    cfg.params.validate()
    if cfg.duration_s < 1:
        raise ValueError("duration_s must be >= 1")
    dev = resolve_device(device)
    mode, dial_out, protected = (torch.from_numpy(x).to(dev)
                                 for x in cfg.roles())
    state = init_conn_state(cfg.params, seed=cfg.seed, device=dev)
    state, trace = run_conn_steps(state, mode, dial_out, protected,
                                  cfg.params, cfg.duration_s)
    tr = trace.cpu().numpy()
    warm = min(5, len(tr) - 1)
    summary = ConnManagerSummary(
        mean_conns=float(tr.mean()),
        max_conns=int(tr.max()),
        min_conns_after_warm=int(tr[warm:].min()),
        dials=int(state.dials),
        rejected=int(state.rejected),
        trims=int(state.trims),
        cycles=int(state.cycles),
        trace=tr,
    )
    return summary, state


def config_from_env() -> ConnManagerConfig:
    """WATERMARK_*/MAX_CONNECTIONS/RECONNECT* env surface (env.nim:39-105)."""
    from ..config.env import env_int, env_str

    n_none = env_int("CONNMGR_PEERS_NONE", 20)
    n_agg = env_int("CONNMGR_PEERS_AGGRESSIVE", 10)
    n_bg = env_int("CONNMGR_PEERS_BEFORE_GRACE", 10)
    params = ConnManagerParams(
        n_hubs=env_int("NUM_HUBS", 1),
        n_peers=n_none + n_agg + n_bg,
        low_water=env_int("WATERMARK_LOW", 10),
        high_water=env_int("WATERMARK_HIGH", 20),
        grace_period_s=env_int("WATERMARK_GRACE_PERIOD_S", 0),
        silence_period_s=env_int("WATERMARK_SILENCE_PERIOD_S", 2),
        max_connections=env_int("MAX_CONNECTIONS", 0),
        reconnect_interval_s=env_int("RECONNECT_INTERVAL_S", 55),
    )
    n_protected = len([s for s in env_str("PROTECTED_PEERS", "").split(",")
                       if s.strip()])
    return ConnManagerConfig(
        params=params,
        n_none=n_none,
        n_aggressive=n_agg,
        n_before_grace=n_bg,
        n_protected=n_protected,
        duration_s=env_int("CONNMGR_DURATION_S", 120),
        seed=env_int("SEED", 0),
    )
