"""Kademlia DHT substrate: XOR-metric routing tables and FIND_NODE lookups
as batched tensor ops (the port of the reference's ops/kad.py).

The reference's kad-dht node (nim-test-node/kad-dht/{main,core,helpers}.nim)
delegates the protocol to nim-libp2p's KadDHT: a per-node routing table of
XOR-distance buckets, iterative FIND_NODE lookups (query the ALPHA closest
known peers, merge their K_RESP closest entries, repeat), and three roles
(bootstrap, normal, probe; runtime/kad_runtime.py). The regression and
service-discovery nodes reuse the machinery.

Layout, as in the reference:
  keys[p]    (N, W) uint32 words of the 128-bit node key, held as int64
             in [0, 2^32) (torch has no full uint32 arithmetic)
  rtable[p]  (N, B, K) int32: bucket b holds peers whose XOR distance to p
             has bit length KEY_BITS - b; -1 = empty slot
  find_node  the iterative lookup of Q origins at once: a loop over
             `rounds` lookup rounds of batched tensors where the reference
             scans a vmapped body.

Every order is the reference's: argsorts are stable (jnp.argsort is), so
ties break by position; the big-integer XOR comparison is a stable radix
sort over two 64-bit digits (two key words each, sign-flipped so signed
order is unsigned order), which gives the reference's four-pass order
exactly. Results and tables are bitwise the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import prng

KEY_WORDS = 4                    # 128-bit keys; collisions ~ N^2 / 2^129
KEY_BITS = 32 * KEY_WORDS
ALPHA = 3                        # parallel queries per lookup round
K_RESP = 16                      # closest entries returned per FIND_NODE
PROC_MS = 2.0                    # per-query handler latency
WORD_MAX = 0xFFFFFFFF
_HALF = 1 << 31


def make_keys(n: int, seed: int = 0) -> np.ndarray:
    """Uniform 128-bit node keys, host-generated once per experiment (the
    reference's draw, word for word)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x6AD]))
    return rng.integers(0, 1 << 32, size=(n, KEY_WORDS), dtype=np.uint32)


def _bitlen32(x: torch.Tensor) -> torch.Tensor:
    """Bit length of each uint32 lane (0 for 0), by a 5-step binary
    search."""
    bl = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for shift in (16, 8, 4, 2, 1):
        gt = x >= (1 << shift)
        bl = torch.where(gt, bl + shift, bl)
        x = torch.where(gt, x >> shift, x)
    return bl + (x > 0).long()


def xor_bitlen(d: torch.Tensor) -> torch.Tensor:
    """Bit length of the big integer whose words (most significant first)
    are the trailing axis."""
    w = torch.arange(KEY_WORDS, device=d.device)
    contrib = (KEY_WORDS - 1 - w) * 32 + _bitlen32(d)
    return torch.where(d > 0, contrib, 0).amax(dim=-1)


def bucket_slot(d: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Bucket index of an XOR distance: 0 = farthest half of the keyspace;
    closer than 2^(KEY_BITS - n_buckets) clamps into the last bucket."""
    return torch.clamp(KEY_BITS - xor_bitlen(d), 0, n_buckets - 1)


def _digit(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two uint32 words as one signed int64 with the same order."""
    return (hi - _HALF) * (1 << 32) + lo


def lex_argsort(d: torch.Tensor) -> torch.Tensor:
    """Stable ascending big-integer argsort over the trailing word axis of
    (..., M, W)."""
    lo = _digit(d[..., 2], d[..., 3])
    hi = _digit(d[..., 0], d[..., 1])
    idx = torch.argsort(lo, dim=-1, stable=True)
    refine = torch.argsort(torch.gather(hi, -1, idx), dim=-1, stable=True)
    return torch.gather(idx, -1, refine)


def _dist(keys: torch.Tensor, entries: torch.Tensor,
          target_key: torch.Tensor) -> torch.Tensor:
    """XOR distance of each entry (..., M) to its row's target (..., W);
    invalid entries (-1) get the maximum."""
    ek = keys[entries.clamp_min(0)]
    d = torch.bitwise_xor(ek, target_key.unsqueeze(-2))
    return torch.where((entries >= 0).unsqueeze(-1), d, WORD_MAX)


@dataclass
class KadState:
    """DHT state, one leaf per reference leaf (same names, shapes and
    dtypes, the keys and the PRNG key held as int64 words).

    rt_fails / rt_retry_ms shadow the routing table slot for slot: the
    per-entry dial-failure count and the sim-ms deadline before the entry
    may be re-dialed. Both stay zero unless `evict_failed` runs with a
    retry budget (max_fails > 1)."""

    rtable: torch.Tensor       # (N, B, K) int32, -1 empty
    keys: torch.Tensor         # (N, W) int64 words in [0, 2^32)
    alive: torch.Tensor        # (N,) bool
    t_ms: torch.Tensor         # () float32
    key: torch.Tensor          # (2,) int64 PRNG key words
    queries_tx: torch.Tensor   # (N,) int32 FIND_NODE requests sent
    queries_rx: torch.Tensor   # (N,) int32 FIND_NODE requests served
    rt_fails: torch.Tensor     # (N, B, K) int32
    rt_retry_ms: torch.Tensor  # (N, B, K) float32

    def replace(self, **changes) -> "KadState":
        return dataclasses.replace(self, **changes)

    @property
    def device(self) -> torch.device:
        return self.rtable.device


def init_kad_state(n: int, n_buckets: int = 24, k_bucket: int = 16,
                   seed: int = 0, device=None) -> KadState:
    from ..device import resolve_device

    dev = resolve_device(device)
    return KadState(
        rtable=torch.full((n, n_buckets, k_bucket), -1, dtype=torch.int32,
                          device=dev),
        keys=torch.from_numpy(make_keys(n, seed).astype(np.int64)).to(dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        t_ms=torch.zeros((), dtype=torch.float32, device=dev),
        key=prng.PRNGKey(seed ^ 0x6AD, dev),
        queries_tx=torch.zeros((n,), dtype=torch.int32, device=dev),
        queries_rx=torch.zeros((n,), dtype=torch.int32, device=dev),
        rt_fails=torch.zeros((n, n_buckets, k_bucket), dtype=torch.int32,
                             device=dev),
        rt_retry_ms=torch.zeros((n, n_buckets, k_bucket),
                                dtype=torch.float32, device=dev),
    )


def _segment_rank(sort_key: torch.Tensor) -> torch.Tensor:
    """rank[..., i] = occurrence index of sort_key[..., i] among the equal
    keys of its row, in array order."""
    m = sort_key.shape[-1]
    order = torch.argsort(sort_key, dim=-1, stable=True)
    sk = torch.gather(sort_key, -1, order)
    is_start = torch.ones_like(sk, dtype=torch.bool)
    is_start[..., 1:] = sk[..., 1:] != sk[..., :-1]
    pos = torch.arange(m, device=sort_key.device).expand_as(sk)
    start = torch.cummax(torch.where(is_start, pos, 0), dim=-1).values
    return torch.empty_like(order).scatter_(-1, order, pos - start)


def _first_occurrence(x: torch.Tensor) -> torch.Tensor:
    """True where x[..., i] equals no x[..., j] with j < i."""
    return _segment_rank(x) == 0


def _insert_rows(tables: torch.Tensor, keys: torch.Tensor,
                 owners: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Insert candidate ids (M, E) into their owners' (M, B, K) tables.

    Kademlia bucket policy: keep existing entries, append new distinct
    entries into free slots of their bucket, drop the rest."""
    m, b, k = tables.shape
    cands = cands.long()
    valid = (cands >= 0) & (cands != owners[:, None])
    slot = bucket_slot(_dist(keys, cands, keys[owners]), b)       # (M, E)
    # drop candidates already in their target bucket ...
    in_bucket = torch.gather(
        tables, 1, slot[..., None].expand(m, slot.shape[1], k))
    dup_existing = (in_bucket == cands[..., None]).any(dim=-1)
    # ... and repeats within the batch (the first occurrence stays)
    keep = valid & ~dup_existing & _first_occurrence(cands)
    occupancy = (tables >= 0).sum(dim=-1)                          # (M, B)
    rank = _segment_rank(torch.where(keep, slot, b))
    pos = torch.gather(occupancy, 1, slot) + rank
    ok = keep & (pos < k)
    out = tables.clone()
    row = torch.arange(m, device=tables.device)[:, None].expand_as(slot)
    out[row[ok], slot[ok], pos[ok]] = cands[ok].to(tables.dtype)
    return out


def rtable_insert(state: KadState, owners: torch.Tensor,
                  cands: torch.Tensor) -> KadState:
    """Batch insert: owners (M,) each learn cands (M, E). Owner rows must be
    distinct within a batch."""
    owners = owners.long()
    rows = _insert_rows(state.rtable[owners], state.keys, owners, cands)
    rtable = state.rtable.clone()
    rtable[owners] = rows
    return state.replace(rtable=rtable)


def _closest_from_tables(tables: torch.Tensor, keys: torch.Tensor,
                         targets: torch.Tensor, k_out: int) -> torch.Tensor:
    """The k_out closest entries of each (..., B, K) table to its target
    (..., W), -1 padded: a FIND_NODE response."""
    flat = tables.reshape(*tables.shape[:-2], -1).long()
    order = lex_argsort(_dist(keys, flat, targets))[..., :k_out]
    return torch.gather(flat, -1, order)


def _teach_learners(state: KadState, flat_peers: torch.Tensor,
                    flat_origin: torch.Tensor, extra_ok=None,
                    e_cap: int = 8) -> KadState:
    """Group flat (learner <- candidate) events by learner with
    capacity-bounded segment ranks and batch-insert into every learner's
    table: find_node's query-learning pass and connect_found's
    dial-backs."""
    n = state.rtable.shape[0]
    dev = state.device
    flat_peers = flat_peers.long()
    rank = _segment_rank(torch.where(flat_peers >= 0, flat_peers, n))
    ok = (flat_peers >= 0) & (rank < e_cap)
    if extra_ok is not None:
        ok = ok & extra_ok
    learn = torch.full((n, e_cap), -1, dtype=torch.int64, device=dev)
    learn[flat_peers[ok], rank[ok]] = flat_origin.long()[ok]
    return rtable_insert(state, torch.arange(n, device=dev), learn)


def _pick_alpha(sl: torch.Tensor, rank: torch.Tensor, cand: torch.Tensor,
                s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Select the ALPHA closest candidate shortlist entries by distance
    rank, and their ids as a dense (Q, ALPHA) block (-1 padded)."""
    pick_prio = torch.where(cand, rank, s + 1)
    order = torch.argsort(pick_prio, dim=-1, stable=True)
    pos = torch.empty_like(order).scatter_(
        -1, order, torch.arange(sl.shape[-1], device=sl.device)
        .expand_as(order))
    pick = (pos < ALPHA) & cand
    p_order = torch.argsort((~pick).to(torch.int8), dim=-1,
                            stable=True)[:, :ALPHA]
    p_ids = torch.gather(torch.where(pick, sl, -1), -1, p_order)
    return pick, p_ids


def _merge_shortlist(keys: torch.Tensor, sl: torch.Tensor,
                     queried: torch.Tensor, pick: torch.Tensor,
                     resp: torch.Tensor, targets: torch.Tensor, s: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge FIND_NODE responses into the shortlist: concatenate, drop
    duplicates keeping the queried copy of an id, sort by XOR distance,
    keep the closest S with their queried flags."""
    q = sl.shape[0]
    merged = torch.cat([sl, resp.reshape(q, -1)], dim=-1)
    mq = torch.cat([queried | pick,
                    torch.zeros((q, merged.shape[1] - s), dtype=torch.bool,
                                device=sl.device)], dim=-1)
    mkey = merged * 2 + torch.where(mq, 0, 1)
    dorder = torch.argsort(mkey, dim=-1, stable=True)
    msort = torch.gather(merged, -1, dorder)
    qsort = torch.gather(mq, -1, dorder)
    dup = torch.zeros_like(qsort)
    dup[:, 1:] = msort[:, 1:] == msort[:, :-1]
    msort = torch.where(dup | (msort < 0), -1, msort)
    morder = lex_argsort(_dist(keys, msort, targets))[:, :s]
    return (torch.gather(msort, -1, morder),
            torch.gather(qsort & ~dup, -1, morder))


def _distance_rank(keys, sl, targets) -> torch.Tensor:
    """Each shortlist entry's position in its row's distance order."""
    order = lex_argsort(_dist(keys, sl, targets))
    return torch.empty_like(order).scatter_(
        -1, order, torch.arange(sl.shape[-1], device=sl.device)
        .expand_as(order))


@dataclass
class LookupResult:
    closest: torch.Tensor     # (Q, K_RESP) final shortlist heads
    hops: torch.Tensor        # (Q,) int32 rounds until convergence
    latency_ms: torch.Tensor  # (Q,) float32 wall time of the lookup
    queried: torch.Tensor     # (Q, rounds*ALPHA) query log (-1 padded)
    n_queries: torch.Tensor   # (Q,) int32 FIND_NODE requests


def _find_node_impl(state: KadState, origins: torch.Tensor,
                    targets: torch.Tensor, stage: torch.Tensor,
                    lat_ms: torch.Tensor, rounds: int, shortlist: int,
                    attacker: torch.Tensor | None = None,
                    poison0: torch.Tensor | None = None,
                    ) -> tuple[LookupResult, KadState]:
    """The lookup body behind find_node, with the reference's poison hook:
    with attacker / poison0 given, every response from a live
    attacker-controlled peer is replaced by poison0 ((Q, K_RESP), the
    sybil directory's response per target)."""
    n = state.rtable.shape[0]
    dev = state.device
    origins = origins.long()
    q = origins.shape[0]
    s = shortlist
    keys, alive = state.keys, state.alive
    o_stage = stage[origins].long()

    sl = _closest_from_tables(state.rtable[origins], keys, targets, s)
    queried = torch.zeros((q, s), dtype=torch.bool, device=dev)
    t_acc = torch.zeros((q,), dtype=torch.float32, device=dev)
    hops = torch.zeros((q,), dtype=torch.int32, device=dev)
    nq = torch.zeros((q,), dtype=torch.int32, device=dev)
    picked_seq = []
    for _ in range(rounds):
        rank = _distance_rank(keys, sl, targets)
        # a node never queries itself, so the origin's own id (distance 0
        # on self-lookups) is not a candidate
        cand = ((sl >= 0) & ~queried & alive[sl.clamp_min(0)]
                & (sl != origins[:, None]))
        # done once every entry of the top-K_RESP head has been queried
        head_unqueried = (cand & (rank < K_RESP)).any(dim=-1)
        cand = cand & head_unqueried[:, None]
        pick, p_ids = _pick_alpha(sl, rank, cand, s)
        any_pick = pick.any(dim=-1)
        peer = p_ids.clamp_min(0)
        resp = _closest_from_tables(
            state.rtable[peer], keys,
            targets[:, None, :].expand(q, ALPHA, KEY_WORDS), K_RESP)
        resp = torch.where(alive[peer][..., None] & (p_ids >= 0)[..., None],
                           resp, -1)                      # (Q, ALPHA, K_RESP)
        if attacker is not None:
            is_att = (p_ids >= 0) & attacker[peer] & alive[peer]
            resp = torch.where(is_att[..., None], poison0.long()[:, None, :],
                               resp)
        # round RTT = max over the parallel queries
        rtt = 2.0 * lat_ms[o_stage[:, None], stage[peer].long()] + PROC_MS
        round_ms = torch.where(p_ids >= 0, rtt, 0.0).amax(dim=-1)
        sl_new, q_new = _merge_shortlist(keys, sl, queried, pick, resp,
                                         targets, s)
        improved = (sl_new != sl).any(dim=-1) & any_pick
        t_acc = t_acc + torch.where(any_pick, round_ms, 0.0)
        hops = hops + improved.int()
        nq = nq + (p_ids >= 0).sum(dim=-1, dtype=torch.int32)
        sl, queried = sl_new, q_new
        picked_seq.append(p_ids)
    picked = torch.stack(picked_seq, dim=1).reshape(q, -1)  # (Q, R*ALPHA)

    # the origin learns its final shortlist; each queried peer learns the
    # origins that queried it
    state = rtable_insert(state, origins, sl)
    flat_peers = picked.reshape(-1)
    flat_origin = origins[:, None].expand_as(picked).reshape(-1)
    state = _teach_learners(state, flat_peers, flat_origin)
    served = torch.bincount(flat_peers[flat_peers >= 0], minlength=n)
    state = state.replace(
        queries_tx=state.queries_tx.index_add(0, origins, nq),
        queries_rx=state.queries_rx + served.int(),
    )
    result = LookupResult(
        closest=sl[:, :K_RESP].int(), hops=hops, latency_ms=t_acc,
        queried=picked.int(), n_queries=nq)
    return result, state


def find_node(state: KadState, origins: torch.Tensor, targets: torch.Tensor,
              stage: torch.Tensor, lat_ms: torch.Tensor, rounds: int = 6,
              shortlist: int = 32) -> tuple[LookupResult, KadState]:
    """Batched iterative FIND_NODE (kad-dht/core.nim's warm-up and probe
    primitive) of distinct origins (Q,) toward targets (Q, W).

    Each round queries the ALPHA closest unqueried shortlist peers and
    merges their K_RESP closest entries; a round's wall time is the max
    RTT of its queries, counted while a query went out. Returns the
    per-origin results and the state with updated tables (the origin
    learns its final shortlist, queried peers learn the origin) and
    counters."""
    return _find_node_impl(state, origins, targets, stage, lat_ms, rounds,
                           shortlist)


def evict_failed(state: KadState, origins: torch.Tensor,
                 found: torch.Tensor, max_fails: int = 1,
                 backoff_base_ms: float = 0.0) -> KadState:
    """DISCOVERY=extended eviction after the dial-out to the found peers
    ((Q, K) LookupResult.closest): a failed dial (a dead entry) counts
    against the entry's retry budget, under exponential backoff
    (`backoff_base_ms * 2**(fails-1)` past state.t_ms, no new count while
    it runs), and evicts the entry once the count reaches `max_fails`; a
    successful dial resets both. Buckets are re-packed left. max_fails=1
    is the immediate eviction of the reference's default."""
    if max_fails > 14:
        # the reference's float32 exp2 is exp(x * ln 2), exact only up to
        # 2^12; larger backoff exponents are not reproduced
        raise ValueError("max_fails above 14 is not supported")
    origins = origins.long()
    found = found.long()
    dead = ~state.alive
    t = state.t_ms
    table = state.rtable[origins]                     # (Q, B, K)
    fails = state.rt_fails[origins]
    retry = state.rt_retry_ms[origins]
    fid = found[:, None, None, :]                     # (Q, 1, 1, F)
    f_dead = dead[found.clamp_min(0)][:, None, None, :]
    bad_ids = torch.where((fid >= 0) & f_dead, fid, -2)
    good_ids = torch.where((fid >= 0) & ~f_dead, fid, -2)
    entry = table.long()[..., None]
    is_bad = (entry == bad_ids).any(dim=-1)
    is_good = (entry == good_ids).any(dim=-1)
    # entries under backoff were not re-dialed: no new count
    fail_event = is_bad & ~(retry > t)
    fails = torch.where(fail_event, fails + 1, fails)
    fails = torch.where(is_good, 0, fails)
    evict = fail_event & (fails >= max_fails)
    exp2 = torch.ldexp(torch.ones_like(retry), (fails - 1).clamp_min(0))
    retry = torch.where(fail_event & ~evict, t + backoff_base_ms * exp2,
                        retry)
    retry = torch.where(is_good, 0.0, retry)
    marked = torch.where(evict, -1, table)
    fails = torch.where(evict, 0, fails)
    retry = torch.where(evict, 0.0, retry)
    # compact each bucket: entries left-packed, holes right; the shadow
    # arrays move with the table
    order = torch.argsort((marked < 0).to(torch.int8), dim=-1, stable=True)
    rtable, rt_fails = state.rtable.clone(), state.rt_fails.clone()
    rt_retry = state.rt_retry_ms.clone()
    rtable[origins] = torch.gather(marked, -1, order)
    rt_fails[origins] = torch.gather(fails, -1, order)
    rt_retry[origins] = torch.gather(retry, -1, order)
    return state.replace(rtable=rtable, rt_fails=rt_fails,
                         rt_retry_ms=rt_retry)


def connect_found(state: KadState, origins: torch.Tensor,
                  found: torch.Tensor) -> KadState:
    """DISCOVERY=extended dial-backs (kad-dht/helpers.nim:48-57): every
    live entry of an origin's final shortlist heads ((Q, K)) learns the
    origin."""
    flat_peers = found.long().reshape(-1)
    flat_origin = origins.long()[:, None].expand_as(found).reshape(-1)
    extra_ok = ((flat_peers != flat_origin)
                & state.alive[flat_peers.clamp_min(0)])
    return _teach_learners(state, flat_peers, flat_origin, extra_ok)


def seed_bootstraps(state: KadState, bootstraps: torch.Tensor) -> KadState:
    """Every peer seeds its table with the bootstrap anchors and every
    bootstrap learns every peer (kad-dht/helpers.nim:62-91,
    regression/kad_utils.nim:88-94)."""
    n = state.rtable.shape[0]
    bootstraps = bootstraps.long()
    all_peers = torch.arange(n, device=state.device)
    nb = bootstraps.shape[0]
    state = rtable_insert(state, all_peers, bootstraps[None, :].expand(n, nb))
    return rtable_insert(state, bootstraps, all_peers[None, :].expand(nb, n))


def rtable_census(state: KadState) -> torch.Tensor:
    """Per-peer routing-table population (kad-dht/core.nim:17-22)."""
    return (state.rtable >= 0).sum(dim=(-1, -2), dtype=torch.int32)


def random_targets(key: torch.Tensor, q: int) -> torch.Tensor:
    """Random lookup targets (getRandomPeerId, kad-dht/helpers.nim:10-12):
    jax.random.bits(key, (q, KEY_WORDS), uint32)."""
    return prng.random_bits(key, (q, KEY_WORDS))


def true_closest(keys: np.ndarray, target: np.ndarray, k: int = 1
                 ) -> np.ndarray:
    """Host brute-force ground truth: the k globally closest node indices
    to target under the XOR metric."""
    ints = np.zeros(keys.shape[0], dtype=object)
    t_int = 0
    for w in range(KEY_WORDS):
        ints = ints * (1 << 32) + keys[:, w].astype(object)
        t_int = t_int * (1 << 32) + int(target[w])
    d = np.array([x ^ t_int for x in ints], dtype=object)
    return np.argsort(d, kind="stable")[:k]
