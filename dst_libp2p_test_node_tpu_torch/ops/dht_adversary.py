"""The DHT adversary: poison the discovery layer, starve the mesh (the
reference's ops/dht_adversary.py).

Three attack families over ops/kad.KadState, each armed by a flag of
DhtAdversaryParams and composed by the campaign with the GossipSub attack
window:

  lookup eclipse     attacker responders answer FIND_NODE from a sybil
                     directory (the cohort's ids closest to the victim's
                     key), through kad._find_node_impl's attacker/poison0
                     hook
  rtable poisoning   one insert wave of sybil ids per routing table
                     (first-come-keep: squatting is free);
                     `rtable_poison_budget` is the closed-form ceiling of
                     the poisoned share
  sybil clustering   attacker keys re-minted inside the victim's keyspace
                     prefix

Cohort material is drawn on the host from seeded SeedSequences (no device
PRNG); keys travel as uint32 words on the host and as int64 words in the
KadState (ops/kad.py). `build_attacked_dht` builds one trial's DHT under
attack and `dht_repair_pool` gives the repair controller its shortlist.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import kad
from .kad import K_RESP, KEY_WORDS, KadState, _find_node_impl


@dataclass(frozen=True)
class DhtAdversaryParams:
    """The DHT adversary and discovery wiring knobs (the reference's
    fields and defaults). `discovery` arms the benign wiring alone; each
    attack flag implies it, so `enabled` is the union."""

    discovery: bool = False
    lookup_eclipse: bool = False
    rtable_poison: bool = False
    sybil_cluster: bool = False
    poison_per_peer: int = 8
    cluster_prefix_bits: int = 16
    # recovery-window round at which the DHT heals; -1 = never
    heal_hb: int = -1
    directory_size: int = 64
    n_buckets: int = 16
    k_bucket: int = 8
    bootstraps: int = 2
    warmup_waves: int = 2
    lookup_rounds: int = 3
    evict_max_fails: int = 1
    evict_backoff_ms: float = 0.0

    @property
    def attacked(self) -> bool:
        return self.lookup_eclipse or self.rtable_poison or self.sybil_cluster

    @property
    def enabled(self) -> bool:
        return self.discovery or self.attacked

    def validate(self) -> None:
        if self.poison_per_peer < 1:
            raise ValueError("poison_per_peer must be >= 1")
        if not (0 <= self.cluster_prefix_bits <= 32 * KEY_WORDS):
            raise ValueError("cluster_prefix_bits outside [0, KEY_BITS]")
        if self.directory_size < 1:
            raise ValueError("directory_size must be >= 1")
        if self.n_buckets < 1 or self.k_bucket < 1:
            raise ValueError("n_buckets/k_bucket must be >= 1")
        if self.bootstraps < 1:
            raise ValueError("bootstraps must be >= 1")
        if self.warmup_waves < 1:
            raise ValueError("warmup_waves must be >= 1")
        if self.lookup_rounds < 1:
            raise ValueError("lookup_rounds must be >= 1")
        if self.evict_max_fails < 1:
            raise ValueError("evict_max_fails must be >= 1")
        if self.evict_backoff_ms < 0.0:
            raise ValueError("evict_backoff_ms must be >= 0")


# ------------------------------------------------------------------ cohorts


def mint_sybil_keys(keys: np.ndarray, attacker: np.ndarray, victim: int,
                    prefix_bits: int, seed: int) -> np.ndarray:
    """(N, W) uint32 keys with every attacker's key re-minted inside the
    victim's prefix (top `prefix_bits` bits copied, the rest uniform)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5B11]))
    out = keys.copy()
    att = np.nonzero(attacker)[0]
    if att.size == 0 or prefix_bits == 0:
        return out
    rand = rng.integers(0, 1 << 32, size=(att.size, KEY_WORDS),
                        dtype=np.uint32)
    for w in range(KEY_WORDS):
        hi = min(32, max(0, prefix_bits - 32 * w))
        mask = np.uint32(((0xFFFFFFFF << (32 - hi)) & 0xFFFFFFFF) if hi
                         else 0)
        out[att, w] = (keys[victim, w] & mask) | (rand[:, w] & ~mask)
    return out


def sybil_directory(keys: np.ndarray, attacker: np.ndarray, victim: int,
                    size: int) -> np.ndarray:
    """(size,) int32: attacker ids by XOR distance to the victim's key,
    -1 padded — the eclipse cohort's shared answer sheet."""
    out = np.full((size,), -1, dtype=np.int32)
    att = np.nonzero(attacker)[0]
    if att.size == 0:
        return out
    k = min(size, att.size)
    order = kad.true_closest(keys[att], keys[victim], k=k)
    out[:k] = att[order].astype(np.int32)
    return out


def poison_candidates(n: int, attacker: np.ndarray, per_peer: int,
                      seed: int) -> np.ndarray:
    """(N, per_peer) int32 sybil insert batch: a random sample of attacker
    ids per peer, with replacement."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xD47]))
    att = np.nonzero(attacker)[0]
    if att.size == 0:
        return np.full((n, per_peer), -1, dtype=np.int32)
    return rng.choice(att, size=(n, per_peer)).astype(np.int32)


def rtable_poison_budget(per_peer: int, n_buckets: int, k_bucket: int,
                         prefix_bits: int = 0) -> float:
    """Closed-form ceiling on the routing-table poison fraction one insert
    wave of `per_peer` sybils per peer can reach: the capped expected
    bucket occupancy (bucket b holds a uniform key with probability
    2^-(b+1), the last bucket the tail; clustered keys restart that
    distribution at the prefix) over the whole (B, K) table."""
    total = 0.0
    p = min(prefix_bits, n_buckets - 1)
    for b in range(n_buckets):
        if b < p:
            mass = 0.0
        elif b == n_buckets - 1:
            mass = 2.0 ** -(b - p)
        else:
            mass = 2.0 ** -(b - p + 1)
        total += min(per_peer * mass, float(k_bucket))
    return min(total / (n_buckets * k_bucket), 1.0)


def rtable_poison_frac(state: KadState, attacker: np.ndarray) -> float:
    """Share of the occupied honest routing-table slots that point at
    attacker ids (host side)."""
    rt = state.rtable.detach().cpu().numpy()
    honest = ~np.asarray(attacker, dtype=bool)
    rows = rt[honest]
    occ = rows >= 0
    total = int(occ.sum())
    if total == 0:
        return 0.0
    att = np.asarray(attacker, dtype=bool)
    return float(att[np.clip(rows, 0, None)][occ].sum() / total)


# ----------------------------------------------------------- attacked lookup


def find_node_attacked(state: KadState, origins: torch.Tensor,
                       targets: torch.Tensor, stage: torch.Tensor,
                       lat_ms: torch.Tensor, dht: DhtAdversaryParams,
                       attacker: torch.Tensor | None = None,
                       directory: torch.Tensor | None = None,
                       rounds: int = 6, shortlist: int = 32
                       ) -> tuple[kad.LookupResult, KadState]:
    """find_node with the lookup eclipse armed: every attacker responder
    answers with the directory's K_RESP closest entries to the target.
    Disarmed (or no cohort material) this is kad.find_node."""
    if not dht.lookup_eclipse or attacker is None or directory is None:
        return kad.find_node(state, origins, targets, stage, lat_ms,
                             rounds=rounds, shortlist=shortlist)
    q = targets.shape[0]
    table = directory.reshape(1, 1, -1).expand(q, 1, directory.shape[0])
    poison0 = kad._closest_from_tables(table, state.keys, targets, K_RESP)
    return _find_node_impl(state, origins, targets, stage, lat_ms, rounds,
                           shortlist, attacker=attacker, poison0=poison0)


# ------------------------------------------------------------ campaign setup


def build_attacked_dht(n: int, seed: int, dht: DhtAdversaryParams,
                       attacker: np.ndarray, victim: int,
                       stage: torch.Tensor, lat_ms: torch.Tensor
                       ) -> tuple[KadState, torch.Tensor | None]:
    """One trial's DHT built under attack on stage's device: keys (minted
    into the victim's prefix with sybil_cluster), bootstrap seeding,
    `warmup_waves` self-lookup waves (eclipsed with lookup_eclipse), each
    followed by kad.evict_failed, then the rtable_poison insert wave.
    Returns (KadState, the sybil directory or None)."""
    dev = stage.device
    has_att = bool(np.asarray(attacker).any())
    kstate = kad.init_kad_state(n, n_buckets=dht.n_buckets,
                                k_bucket=dht.k_bucket, seed=seed, device=dev)
    if dht.sybil_cluster and has_att:
        keys = mint_sybil_keys(
            kstate.keys.cpu().numpy().astype(np.uint32), attacker, victim,
            dht.cluster_prefix_bits, seed)
        kstate = kstate.replace(
            keys=torch.from_numpy(keys.astype(np.int64)).to(dev))
    boots = torch.arange(min(dht.bootstraps, n), dtype=torch.int32,
                         device=dev)
    kstate = kad.seed_bootstraps(kstate, boots)
    directory = att_dev = None
    if dht.lookup_eclipse and has_att:
        directory = torch.from_numpy(sybil_directory(
            kstate.keys.cpu().numpy().astype(np.uint32), attacker, victim,
            dht.directory_size)).to(dev)
        att_dev = torch.as_tensor(np.asarray(attacker, dtype=bool),
                                  device=dev)
    origins = torch.arange(n, dtype=torch.int32, device=dev)
    for _ in range(dht.warmup_waves):
        res, kstate = find_node_attacked(
            kstate, origins, kstate.keys, stage, lat_ms, dht,
            attacker=att_dev, directory=directory,
            rounds=dht.lookup_rounds)
        kstate = kad.evict_failed(kstate, origins, res.closest,
                                  max_fails=dht.evict_max_fails,
                                  backoff_base_ms=dht.evict_backoff_ms)
    if dht.rtable_poison and has_att:
        cands = poison_candidates(n, attacker, dht.poison_per_peer, seed)
        kstate = kad.rtable_insert(kstate, origins,
                                   torch.from_numpy(cands).to(dev))
    return kstate, directory


def dht_repair_pool(kstate: KadState, dht: DhtAdversaryParams,
                    stage: torch.Tensor, lat_ms: torch.Tensor,
                    attacker: torch.Tensor | None = None,
                    directory: torch.Tensor | None = None,
                    healed: bool = False
                    ) -> tuple[torch.Tensor, KadState]:
    """The repair controller's DHT shortlist: every peer's FIND_NODE
    self-lookup over the (possibly attacked) DHT, its own id removed, as
    an (N, K_RESP) int32 pool. `healed=True` runs the honest lookup over
    the same evolved tables."""
    n = kstate.rtable.shape[0]
    origins = torch.arange(n, dtype=torch.int32, device=kstate.device)
    res, kstate = find_node_attacked(
        kstate, origins, kstate.keys, stage, lat_ms, dht,
        attacker=None if healed else attacker,
        directory=None if healed else directory,
        rounds=dht.lookup_rounds)
    pool = torch.where(res.closest == origins[:, None], -1, res.closest)
    return pool, kstate
