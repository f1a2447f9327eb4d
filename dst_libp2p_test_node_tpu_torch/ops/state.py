"""Simulation parameter and state containers.

SimParams is the reference engine's frozen parameter dataclass, copied
verbatim so both packages read the same fields with the same defaults
(gossipsub-queues/main.nim:252-332 is where the reference bakes them).

SimState is the peer-major state: one row per simulated peer, each leaf a
tensor on one device with the reference's leaf name and dtype (int32 where
the reference has int32, float32 times, bool masks). The PRNG key is a (2,)
int64 tensor holding two uint32 words (prng.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .. import prng
from ..config.env import GossipSubParams
from ..device import resolve_device
from ..parallel import peer

# Width of the per-peer PX candidate pool (SimState.px_pool). A CONSTANT, not
# a SimParams field: the pool is a state leaf, and keying its shape on a
# tunable would make checkpoints / stacked trial pytrees incompatible across
# repair configs. params.px_count (<= this) bounds how many entries a PRUNE
# actually fills; the rest stay -1.
PX_POOL_WIDTH = 8


@dataclass(frozen=True)
class SimParams:
    """Static simulation parameters (frozen and hashable)."""

    n: int                      # PEERS
    capacity: int               # neighbor-list capacity C
    d: int = 6
    d_low: int = 4
    d_high: int = 8
    d_score: int = 4
    d_out: int = 3
    d_lazy: int = 6
    heartbeat_ms: float = 1000.0
    prune_backoff_ms: float = 60_000.0
    gossip_factor: float = 0.25
    history_gossip: int = 3     # mcache gossip window in heartbeats
    flood_publish: bool = True
    fmd_weight: float = 1.0     # firstMessageDeliveries topic params (main.nim:335-340)
    fmd_cap: float = 30.0
    fmd_decay: float = 0.9
    decay_to_zero: float = 0.01
    # slow-peer penalty + priority-queue drop model (main.nim:264-299).
    # libp2p scoring convention: penalty WEIGHTS are negative and multiply a
    # non-negative counter into the score; state.slow_penalty holds the
    # counter, score() applies the weight.
    slow_weight: float = 0.0          # GOSSIPSUB_SLOW_PEER_PENALTY_WEIGHT (<0)
    slow_threshold_ms: float = 2000.0  # ..._THRESHOLD (seconds in the env)
    slow_decay: float = 0.2            # ..._DECAY
    send_queue_cap: int = 1024         # MAX_LOW_PRIORITY_QUEUE_LEN: data msgs
    # v1.1 opportunistic grafting (main.nim:292); -10000 = disabled
    opportunistic_graft_threshold: float = -10000.0
    # v1.1 score thresholds. The reference COMMENTS these out
    # (main.nim:276-278,306-308), deferring to nim-libp2p's defaults — which
    # are these values. With the default non-negative score weights they can
    # never bind and the gating is statically removed from the compiled step.
    gossip_threshold: float = -100.0     # no IHAVE to peers scored below
    publish_threshold: float = -1000.0   # flood/fanout skips peers below
    graylist_threshold: float = -10000.0  # receiver ignores peers below
    proc_delay_ms: float = 2.0  # per-hop validation/processing latency
    # TCP slow-start transfer dynamics (ops/disseminate.py tcp_flights):
    # under Shadow the nodes run REAL TCP stacks
    # (regression/Dockerfile_amd64_shadow:3-11), so a transfer larger than
    # the initial congestion window needs multiple RTT-gated flights —
    # the first flight carries at most initcwnd_segments * mss_bytes
    # (Linux IW10, RFC 6928) and the window doubles each RTT. Messages are
    # seconds apart, so every transfer starts from a slow-start-restarted
    # (cold) window. slow_start=False removes the term (datagram-style
    # transports with no window, and A/B isolation in tests).
    slow_start: bool = True
    mss_bytes: int = 1460
    initcwnd_segments: int = 10
    # Exact answered-IWANT serialization in the DELIVERY fixpoint (r5).
    # Always exact in the accounting (answer-queue drains, answered sets,
    # attribution offers ride the serialized fold regardless); this flag
    # additionally REPAIRS the arrival times when a queued answer would
    # have been somebody's first delivery — which at heartbeat <
    # dissemination-span shapes (the 100k bench) is every message, at the
    # honest cost of extra fixpoint passes. False = keep the unserialized
    # arrival times in exactly those binding cases (the r4-and-earlier
    # approximation, error <= the answer queue wait, a few tx_ms) — an
    # A/B attribution knob for the bench, NOT the model of record.
    serialize_answers: bool = True
    fanout_ttl_ms: float = 60_000.0  # v1.1 fanoutTTL (libp2p default 60 s)
    max_relax_iters: int = 48   # bound on the earliest-arrival fixpoint
    # Warm-started fixpoints: seed each publish's phase-1 relaxation from
    # the previous message's arrival offsets re-based to the new publish
    # time (state.warm_offset_ms; INF = no usable carry). The seed is a
    # heuristic upper bound only, so the fixpoint carries a self-
    # consistency certificate: any peer left strictly below its supported
    # value triggers ONE cold from-INF rerun (a scalar lax.cond), making
    # the result bit-identical to a cold start unconditionally. False
    # (the default) removes the seed, the certificate and the cond from
    # the trace — the cond's untaken branch still costs a second compile
    # of the whole fast pipeline, which long publish loops amortize but
    # one-shot calls should not pay.
    warm_start: bool = False
    # Exact-repair engine selection (only read when serialize_answers=True):
    # "parallel_prefix" (default) runs the scan-free Jacobi refinement —
    # one answer-queue fold + one candidate pull per iteration, with the
    # serialized global-sort pipeline kept as an in-trace fallback cond for
    # the cases the fold cannot certify (interleaved announce rounds, cap
    # cut). "serial" forces the legacy global-sort outer iteration
    # everywhere — the reference implementation the prefix path is
    # bit/rtol-pinned against (tests/test_exact_prefix.py).
    answer_queue_mode: str = "parallel_prefix"
    # Packed dissemination constants (ARCHITECTURE §6): store the per-edge
    # RELATIVE cost tables of the receiver-side fixpoint formulation
    # (parallel/exchange.py RecvConstants) as bf16 and fold the validity
    # masks into the bf16 +inf sentinel, halving the memory-bound carry's
    # HBM traffic on the budget/sharded dispatch paths. Absolute-time
    # fields and the accounting fold stay f32 (bf16's 8-bit mantissa
    # resolves only ~4 s at a 1e6 ms sim clock). OFF by default: the ~2 ms
    # per-edge quantization is inside the bounded mode's error bar but
    # breaks the exact mode's model-of-record bit guarantees.
    packed_state: bool = False
    # Fused mega-round scan (ARCHITECTURE §18): run the whole
    # heartbeat-burst + publish round chain as ONE lax.scan over rounds —
    # one device dispatch per round instead of one per phase. OFF by
    # default: run_fused_rounds (ops/disseminate.py) literally delegates to
    # the phase-split run_heartbeats + disseminate chain (same jit cache
    # entries, zero retraces, zero extra PRNG splits, bit-identical). ON,
    # the fused body calls the SAME per-phase programs under one trace, so
    # delivery outcomes stay bitwise equal; float delays carry an rtol
    # because XLA may re-fuse arithmetic inside the scan body.
    fused_rounds: bool = False
    exclude_first_sender: bool = True   # don't forward back to the delivering peer
    idontwant_threshold_bytes: int = 1000  # go-test-node/main.go:165 (v1.2)
    churn_down_per_hb: float = 0.0  # P(alive peer dies) per heartbeat
    churn_up_per_hb: float = 0.0    # P(dead peer revives) per heartbeat
    # Mesh-repair subsystem (ops/repair.py + the opt-in heartbeat branches).
    # All OFF by default: the compiled default step contains none of the
    # repair ops and is bit-identical to the repair-free engine (pinned by
    # tests/test_repair.py).
    evict: bool = False                 # score-based mesh eviction branch
    eviction_threshold: float = -50.0   # PRUNE mesh members scoring below this
    px: bool = False                    # peer exchange on PRUNE
    px_count: int = 6                   # candidate ids per PRUNE (<= PX_POOL_WIDTH)
    redial: bool = False                # re-dial controller for starved peers
    redial_patience: int = 3            # heartbeats below d_low before dialing

    def validate(self) -> None:
        if not (0 < self.d_low <= self.d <= self.d_high <= self.capacity):
            raise ValueError(
                "require 0 < d_low <= d <= d_high <= capacity, got "
                f"{self.d_low} <= {self.d} <= {self.d_high} <= {self.capacity}"
            )
        if self.n < 2:
            raise ValueError("need at least 2 peers")
        if self.heartbeat_ms <= 0:
            raise ValueError("heartbeat_ms must be positive")
        if self.history_gossip < 1:
            raise ValueError(
                f"history_gossip must be >= 1, got {self.history_gossip}")
        if self.mss_bytes < 1 or self.initcwnd_segments < 1:
            raise ValueError("mss_bytes and initcwnd_segments must be >= 1")
        # the spec requires non-positive thresholds; enforcing it keeps the
        # static can-thresholds-bind compile decision sound (scores are
        # non-negative unless a negative weight is configured)
        for name in ("gossip_threshold", "publish_threshold",
                     "graylist_threshold"):
            if getattr(self, name) > 0:
                raise ValueError(f"{name} must be <= 0")
        if self.eviction_threshold > 0:
            # eviction is a score defense: a positive threshold would evict
            # well-behaved zero-scored peers every heartbeat
            raise ValueError("eviction_threshold must be <= 0")
        if not (1 <= self.px_count <= PX_POOL_WIDTH):
            raise ValueError(
                f"px_count must be in [1, {PX_POOL_WIDTH}], got {self.px_count}")
        if self.redial_patience < 1:
            raise ValueError("redial_patience must be >= 1")
        if self.answer_queue_mode not in ("parallel_prefix", "serial"):
            raise ValueError(
                "answer_queue_mode must be 'parallel_prefix' or 'serial', "
                f"got {self.answer_queue_mode!r}")

    @classmethod
    def from_gossipsub(
        cls, n: int, capacity: int, g: GossipSubParams, **overrides
    ) -> "SimParams":
        return cls(
            n=n,
            capacity=capacity,
            d=g.d,
            d_low=g.d_low,
            d_high=g.d_high,
            d_score=g.d_score,
            d_out=g.d_out,
            d_lazy=g.d_lazy,
            heartbeat_ms=float(g.heartbeat_ms),
            prune_backoff_ms=float(g.prune_backoff_sec) * 1000.0,
            gossip_factor=g.gossip_factor,
            history_gossip=g.history_gossip,
            flood_publish=g.flood_publish,
            fmd_weight=g.first_message_deliveries_weight,
            fmd_cap=g.first_message_deliveries_cap,
            fmd_decay=g.first_message_deliveries_decay,
            decay_to_zero=g.decay_to_zero,
            idontwant_threshold_bytes=g.idontwant_message_threshold,
            slow_weight=g.slow_peer_penalty_weight,
            slow_threshold_ms=g.slow_peer_penalty_threshold * 1000.0,
            slow_decay=g.slow_peer_penalty_decay,
            send_queue_cap=g.max_low_priority_queue_len,
            opportunistic_graft_threshold=g.opportunistic_graft_threshold,
            gossip_threshold=g.gossip_threshold,
            publish_threshold=g.publish_threshold,
            graylist_threshold=g.graylist_threshold,
            **overrides,
        )


@dataclass
class SimState:
    """Per-peer protocol state (see the reference's SimState for the
    meaning of every leaf; the names, shapes and dtypes are the same)."""

    mesh_mask: torch.Tensor      # (N, C) bool
    fanout_mask: torch.Tensor    # (N, C) bool
    fanout_expire: torch.Tensor  # (N,) f32 ms
    backoff_until: torch.Tensor  # (N, C) f32 ms
    fmd: torch.Tensor            # (N, C) f32 firstMessageDeliveries counter
    slow_penalty: torch.Tensor   # (N, C) f32 slow-peer penalty counter
    alive: torch.Tensor          # (N,) bool
    subscribed: torch.Tensor     # (N,) bool
    hb_phase: torch.Tensor       # (N,) f32 ms per-peer heartbeat phase
    uplink_free_ms: torch.Tensor  # (N,) f32 ms uplink drain time
    rx_free_ms: torch.Tensor     # (N,) f32 ms downlink drain time
    warm_offset_ms: torch.Tensor  # (N,) f32 ms arrival-offset carry
    t_ms: torch.Tensor           # () f32 sim clock
    key: torch.Tensor            # (2,) int64 holding uint32 words
    grafts: torch.Tensor         # (N,) int32
    grafts_rx: torch.Tensor      # (N,) int32
    prunes: torch.Tensor         # (N,) int32
    prunes_rx: torch.Tensor      # (N,) int32
    bytes_tx: torch.Tensor       # (N,) f32
    bytes_rx: torch.Tensor       # (N,) f32
    dup_rx: torch.Tensor         # (N,) int32
    ihave_tx: torch.Tensor       # (N,) int32
    iwant_tx: torch.Tensor       # (N,) int32
    ihave_rx: torch.Tensor       # (N,) int32
    iwant_rx: torch.Tensor       # (N,) int32
    idontwant_tx: torch.Tensor   # (N,) int32
    idontwant_rx: torch.Tensor   # (N,) int32
    px_pool: torch.Tensor        # (N, PX_POOL_WIDTH) int32, -1 = empty
    starve_hb: torch.Tensor      # (N,) int32
    evictions: torch.Tensor      # (N,) int32
    px_grafts: torch.Tensor      # (N,) int32
    redials: torch.Tensor        # (N,) int32

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.mesh_mask.device

    def score(self, params: SimParams) -> torch.Tensor:
        """Peer score across each directed edge: weighted P2 first-message
        deliveries (capped) plus the weighted slow-peer penalty counter."""
        fmd = torch.clamp_max(self.fmd, params.fmd_cap)
        return params.fmd_weight * fmd + params.slow_weight * self.slow_penalty


def leaf_names() -> tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(SimState))


# the SimState leaves that are not peer-major: the same on every rank of
# the peer mesh
REPLICATED_LEAVES = ("t_ms", "key")


def gathered_state(state: SimState) -> SimState:
    """On a rank of the peer mesh, the whole state: every peer-major
    leaf's rows all-gathered (every rank must call it); the state itself
    on one device."""
    if peer.active() is None:
        return state
    return state.replace(**{k: peer.all_rows(getattr(state, k))
                            for k in leaf_names()
                            if k not in REPLICATED_LEAVES})


def local_leaves(leaves: dict) -> dict:
    """This rank's rows of a whole state's {leaf: array} dict."""
    return {k: (v if k in REPLICATED_LEAVES else peer.local(v))
            for k, v in leaves.items()}


def init_state(params: SimParams, seed: int = 0, device=None) -> SimState:
    """Fresh state on `device` (CUDA unless the caller passes another); on
    a rank of the peer mesh, its rows of it (parallel/peer.py)."""
    params.validate()
    device = resolve_device(device)
    n, c = peer.local_count(params.n), params.capacity
    key, k_phase = prng.split(prng.PRNGKey(seed, device))

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return SimState(
        mesh_mask=zeros((n, c), torch.bool),
        fanout_mask=zeros((n, c), torch.bool),
        fanout_expire=zeros((n,), f32),
        backoff_until=zeros((n, c), f32),
        fmd=zeros((n, c), f32),
        slow_penalty=zeros((n, c), f32),
        alive=full((n,), True, torch.bool),
        subscribed=full((n,), True, torch.bool),
        hb_phase=peer.uniform(k_phase, (n,)) * params.heartbeat_ms,
        uplink_free_ms=zeros((n,), f32),
        rx_free_ms=zeros((n,), f32),
        warm_offset_ms=full((n,), 3.4e38, f32),
        t_ms=zeros((), f32),
        key=key,
        grafts=zeros((n,), i32),
        grafts_rx=zeros((n,), i32),
        prunes=zeros((n,), i32),
        prunes_rx=zeros((n,), i32),
        bytes_tx=zeros((n,), f32),
        bytes_rx=zeros((n,), f32),
        dup_rx=zeros((n,), i32),
        ihave_tx=zeros((n,), i32),
        iwant_tx=zeros((n,), i32),
        ihave_rx=zeros((n,), i32),
        iwant_rx=zeros((n,), i32),
        idontwant_tx=zeros((n,), i32),
        idontwant_rx=zeros((n,), i32),
        px_pool=full((n, PX_POOL_WIDTH), -1, i32),
        starve_hb=zeros((n,), i32),
        evictions=zeros((n,), i32),
        px_grafts=zeros((n,), i32),
        redials=zeros((n,), i32),
    )


def graph_arrays(graph, device=None) -> dict:
    """Move a ConnGraph's arrays to the device (CUDA unless the caller
    passes another) once per experiment; on a rank of the peer mesh, its
    rows of them."""
    device = resolve_device(device)
    return {
        "conns": torch.as_tensor(peer.local(graph.conns), device=device),
        "rev": torch.as_tensor(peer.local(graph.rev), device=device),
        "out_mask": torch.as_tensor(peer.local(graph.out_mask),
                                    device=device),
    }


def repair_inert(params: SimParams) -> bool:
    """True iff no path reads or writes the repair leaves: eviction, PX on
    PRUNE and re-dial are all off. The reference strips the leaves from
    its compiled windows then; the port keeps them and skips what would
    read them (the adaptive controller's PX poisoner)."""
    return not (params.evict or params.px or params.redial)


@dataclass
class AdaptiveCtrl:
    """The adaptive attacker's controller state, (N,) per peer (honest rows
    stay zero): `viol_est` the attacker's own estimate of the worst
    honest-side penalty counter on its edges, and three attacker-side
    counters (re-grafts sent, sybil ids planted in px_pool rows, rounds
    spent duty-cycled off)."""

    viol_est: torch.Tensor      # (N,) f32
    regrafts: torch.Tensor      # (N,) int32
    px_injected: torch.Tensor   # (N,) int32
    throttled_hb: torch.Tensor  # (N,) int32


def init_adaptive_ctrl(n: int, device=None) -> AdaptiveCtrl:
    """Zeroed controller carry for a fresh trial window of n peers (on a
    rank of the peer mesh, its rows of it)."""
    dev = resolve_device(device)
    n = peer.local_count(n)
    return AdaptiveCtrl(
        viol_est=torch.zeros((n,), dtype=torch.float32, device=dev),
        regrafts=torch.zeros((n,), dtype=torch.int32, device=dev),
        px_injected=torch.zeros((n,), dtype=torch.int32, device=dev),
        throttled_hb=torch.zeros((n,), dtype=torch.int32, device=dev),
    )
