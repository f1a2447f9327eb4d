"""Service discovery over the DHT: advertise / lookup as batched tensor ops
(the port of the reference's ops/servicedisco.py).

The reference service-discovery node (nim-test-node/service-discovery/
{main,core,env,helpers}.nim) runs libp2p's service_discovery protocol on
kad-dht: advertisers `startAdvertising` (core.nim:7-16), discoverers run a
periodic `lookup(hashServiceId)` loop logging advertisement counts and
unique providers (core.nim:30-53).

On the ops/kad substrate:
  service keys   sha256 of the service id, in the node keyspace
  advert store   (N, A) record slots per node: provider, service index,
                 seqNo, expiry; expired slots are reusable
  advertise      one find_node toward the service key per advertiser, then
                 provider records into the R = k_store * (1 + safetyParam)
                 closest nodes, same-stage replicas demoted by
                 ipSimCoefficient; the Q x R store events apply in the
                 reference's flat order
  lookup         the request/response walk: dead nodes cost a query
                 timeout, live responders piggyback their matching
                 records, providers dedup across waves, and a lookup past
                 its deadline fails
Results are bitwise the reference's.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from . import kad


def service_key(service_id: str) -> np.ndarray:
    """hashServiceId: a stable 128-bit key for a service id string."""
    h = hashlib.sha256(service_id.encode()).digest()
    return np.frombuffer(h[:16], dtype=">u4").astype(np.uint32)


# record payload sizes for byte accounting (xprPublishing, env.nim:138-140)
AD_BYTES_CORE = 64       # peerId + seqNo + signature envelope
AD_BYTES_XPR = 256       # extended peer record: + addresses


@dataclass(frozen=True)
class SDParams:
    """Static service-discovery parameters (env.nim:120-184 surface)."""

    k_store: int = 8                 # base replication of provider records
    safety_param: float = 0.0        # SD_SAFETY_PARAM: widens replication
    ip_sim_coefficient: float = 0.0  # SD_IP_SIM_COEFF: same-stage demotion
    advert_expiry_ms: float = 900_000.0  # SD_ADVERT_EXPIRY_SECONDS default
    xpr_publishing: bool = True      # SD_XPR_PUBLISHING
    # a request to an unresponsive node stalls its wave this long; a lookup
    # past the deadline fails (kad-dht/core.nim:44's 30 s wait)
    query_timeout_ms: float = 5_000.0
    lookup_deadline_ms: float = 30_000.0

    @property
    def replication(self) -> int:
        return max(1, int(round(self.k_store * (1.0 + self.safety_param))))

    @property
    def ad_bytes(self) -> int:
        return AD_BYTES_XPR if self.xpr_publishing else AD_BYTES_CORE


@dataclass
class AdvertStore:
    """Per-node provider-record store (fixed capacity A per node)."""

    provider: torch.Tensor    # (N, A) int32, -1 empty
    service: torch.Tensor     # (N, A) int32 service index
    seq_no: torch.Tensor      # (N, A) int32
    expires_ms: torch.Tensor  # (N, A) float32


def init_advert_store(n: int, capacity: int = 64, device=None) -> AdvertStore:
    from ..device import resolve_device

    dev = resolve_device(device)
    return AdvertStore(
        provider=torch.full((n, capacity), -1, dtype=torch.int32, device=dev),
        service=torch.full((n, capacity), -1, dtype=torch.int32, device=dev),
        seq_no=torch.zeros((n, capacity), dtype=torch.int32, device=dev),
        expires_ms=torch.zeros((n, capacity), dtype=torch.float32,
                               device=dev),
    )


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row (0 when none, as argmax)."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


def _store_events(store: AdvertStore, nodes, provider, service, seq_no,
                  now_ms, expiry_ms: float) -> AdvertStore:
    """Apply store events (E,) in their order: the same (provider,
    service) refreshes its slot in place, else the record takes the first
    free or expired slot; a full store drops it; node -1 is no event.

    Events on distinct nodes commute, so the events are grouped by node
    (flat order kept within a node) and applied one depth at a time, each
    depth a batch of events on distinct nodes: the reference's sequential
    order, bitwise."""
    prov, svc = store.provider.clone(), store.service.clone()
    seq, exp = store.seq_no.clone(), store.expires_ms.clone()
    dev = prov.device
    ok = nodes >= 0
    nodes, provider = nodes[ok].long(), provider[ok]
    service, seq_no = service[ok], seq_no[ok]
    if nodes.numel() == 0:
        return store
    depth = kad._segment_rank(nodes)
    new_exp = now_ms + _f32(expiry_ms, dev)
    for r in range(int(depth.max()) + 1):
        at = depth == r
        rows, p, s = nodes[at], provider[at], service[at]
        rp, rs, rx = prov[rows], svc[rows], exp[rows]
        match = (rp == p[:, None]) & (rs == s[:, None])
        free = (rp < 0) | (rx <= now_ms)
        has_match = match.any(dim=-1)
        slot = torch.where(has_match, _first_true(match), _first_true(free))
        w = has_match | free.any(dim=-1)
        rows, slot = rows[w], slot[w]
        prov[rows, slot] = p[w]
        svc[rows, slot] = s[w]
        seq[rows, slot] = seq_no[at][w]
        exp[rows, slot] = new_exp
    return AdvertStore(provider=prov, service=svc, seq_no=seq,
                       expires_ms=exp)


def advertise(store: AdvertStore, kstate: kad.KadState,
              advertisers: torch.Tensor, service_idx: torch.Tensor,
              service_keys: torch.Tensor, seq_no: torch.Tensor,
              stage: torch.Tensor, lat_ms: torch.Tensor, now_ms,
              params: SDParams
              ) -> tuple[AdvertStore, kad.KadState, torch.Tensor]:
    """One advertise wave: locate the R closest nodes to each service key
    and place provider records there. Returns (store, kstate,
    wave_latency_ms)."""
    dev = kstate.device
    advertisers = advertisers.long()
    targets = service_keys[service_idx.long()]
    res, kstate = kad.find_node(kstate, advertisers, targets, stage, lat_ms)
    closest = res.closest.long()                      # (Q, K_RESP)

    # replica selection: closest first, same-stage entries demoted by
    # ipSimCoefficient (stage = IP-locality analog)
    q, k = closest.shape
    base_rank = torch.arange(k, dtype=torch.float32, device=dev).expand(q, k)
    adv_stage = stage[advertisers]
    same_stage = (stage[closest.clamp_min(0)] == adv_stage[:, None]).float()
    demoted = (base_rank
               + _f32(params.ip_sim_coefficient, dev) * same_stage
               * _f32(float(k), dev))
    demoted = torch.where(closest >= 0, demoted, _f32(1e9, dev))
    order = torch.argsort(demoted, dim=-1, stable=True)
    replicas = torch.gather(closest, -1, order)[:, :params.replication]

    r = replicas.shape[1]
    store = _store_events(
        store, replicas.reshape(-1),
        advertisers.int()[:, None].expand(q, r).reshape(-1),
        service_idx.int()[:, None].expand(q, r).reshape(-1),
        seq_no.int()[:, None].expand(q, r).reshape(-1),
        now_ms, params.advert_expiry_ms)

    # advertise latency = lookup walk + one store round trip to the
    # farthest chosen replica
    rep_lat = 2.0 * lat_ms[adv_stage.long()[:, None],
                           stage[replicas.clamp_min(0)].long()]
    rep_lat = torch.where(replicas >= 0, rep_lat, 0.0)
    return store, kstate, res.latency_ms + rep_lat.amax(dim=-1)


@dataclass
class SDLookupResult:
    advertisements: torch.Tensor  # (Q,) int32 record copies retrieved
    unique_peers: torch.Tensor    # (Q,) int32 distinct providers
    latency_ms: torch.Tensor      # (Q,) float32 wall time incl. timeouts
    ok: torch.Tensor              # (Q,) bool: False = deadline exceeded
    timeouts: torch.Tensor        # (Q,) int32 requests that timed out


def lookup(store: AdvertStore, kstate: kad.KadState,
           discoverers: torch.Tensor, service_idx: torch.Tensor,
           service_keys: torch.Tensor, stage: torch.Tensor,
           lat_ms: torch.Tensor, now_ms, params: SDParams, rounds: int = 6,
           shortlist: int = 32) -> tuple[SDLookupResult, kad.KadState]:
    """One lookup per discoverer (runLookupLoop, core.nim:30-53): the
    shortlist walk of kad.find_node without its liveness oracle (a request
    to a dead node stalls its wave by query_timeout_ms), live responders
    returning their matching unexpired records, providers deduplicated
    across waves, and waves past lookup_deadline_ms never started; a
    lookup that ran past the deadline fails with its counts zeroed."""
    n = kstate.rtable.shape[0]
    dev = kstate.device
    discoverers = discoverers.long()
    service_idx = service_idx.long()
    q, s = discoverers.shape[0], shortlist
    keys, alive = kstate.keys, kstate.alive
    targets = service_keys[service_idx]
    o_stage = stage[discoverers].long()
    deadline = _f32(params.lookup_deadline_ms, dev)

    sl = kad._closest_from_tables(kstate.rtable[discoverers], keys, targets,
                                  s)
    queried = torch.zeros((q, s), dtype=torch.bool, device=dev)
    t_acc = torch.zeros((q,), dtype=torch.float32, device=dev)
    nq = torch.zeros((q,), dtype=torch.int32, device=dev)
    nto = torch.zeros((q,), dtype=torch.int32, device=dev)
    ads = torch.zeros((q,), dtype=torch.int32, device=dev)
    pmask = torch.zeros((q, n + 1), dtype=torch.bool, device=dev)
    picked_seq = []
    for _ in range(rounds):
        rank = kad._distance_rank(keys, sl, targets)
        # no alive filter: the discoverer learns a peer is dead by timing
        # out on it
        cand = (sl >= 0) & ~queried & (sl != discoverers[:, None])
        head_unqueried = (cand & (rank < kad.K_RESP)).any(dim=-1)
        cand = cand & head_unqueried[:, None]
        # deadline abort: a wave starting past the budget never happens
        cand = cand & (t_acc < deadline)[:, None]
        pick, p_ids = kad._pick_alpha(sl, rank, cand, s)
        any_pick = pick.any(dim=-1)
        peer = p_ids.clamp_min(0)
        p_live = (p_ids >= 0) & alive[peer]
        resp = kad._closest_from_tables(
            kstate.rtable[peer], keys,
            targets[:, None, :].expand(q, kad.ALPHA, kad.KEY_WORDS),
            kad.K_RESP)
        resp = torch.where(alive[peer][..., None] & (p_ids >= 0)[..., None],
                           resp, -1)
        # per-request cost: the RTT of a live responder, the timeout of a
        # dead one; the wave waits for its slowest request
        rtt = (2.0 * lat_ms[o_stage[:, None], stage[peer].long()]
               + kad.PROC_MS)
        cost = torch.where(p_live, rtt,
                           _f32(params.query_timeout_ms, dev))
        round_ms = torch.where(p_ids >= 0, cost, 0.0).amax(dim=-1)

        # GET_PROVIDERS piggyback, providers deduplicated across waves
        rprov = store.provider[peer]                       # (Q, ALPHA, A)
        rvalid = (p_live[..., None] & (rprov >= 0)
                  & (store.service[peer] == service_idx[:, None, None])
                  & (store.expires_ms[peer] > now_ms))
        ads = ads + rvalid.sum(dim=(-1, -2), dtype=torch.int32)
        flat_p = torch.where(rvalid, rprov.long(), n).reshape(q, -1)
        pmask.scatter_(1, flat_p, True)

        sl_new, q_new = kad._merge_shortlist(keys, sl, queried, pick, resp,
                                             targets, s)
        t_acc = t_acc + torch.where(any_pick, round_ms, 0.0)
        nq = nq + (p_ids >= 0).sum(dim=-1, dtype=torch.int32)
        nto = nto + ((p_ids >= 0) & ~p_live).sum(dim=-1, dtype=torch.int32)
        sl, queried = sl_new, q_new
        picked_seq.append(p_ids)
    picked = torch.stack(picked_seq, dim=1).reshape(q, -1)

    # a lookup past the budget failed and reports nothing (strictly: the
    # worst all-timeout walk costs exactly the default deadline)
    ok = t_acc < deadline
    uniq = pmask[:, :n].sum(dim=-1, dtype=torch.int32)
    ads = torch.where(ok, ads, 0)
    uniq = torch.where(ok, uniq, 0)

    # learning and accounting as kad.find_node, live queried peers only
    kstate = kad.rtable_insert(kstate, discoverers, sl)
    flat_peers = picked.reshape(-1)
    flat_origin = discoverers[:, None].expand_as(picked).reshape(-1)
    live_ok = alive[flat_peers.clamp_min(0)]
    kstate = kad._teach_learners(kstate, flat_peers, flat_origin, live_ok)
    served = torch.bincount(flat_peers[(flat_peers >= 0) & live_ok],
                            minlength=n)
    kstate = kstate.replace(
        queries_tx=kstate.queries_tx.index_add(0, discoverers, nq),
        queries_rx=kstate.queries_rx + served.int(),
    )
    out = SDLookupResult(advertisements=ads, unique_peers=uniq,
                         latency_ms=t_acc, ok=ok, timeouts=nto)
    return out, kstate


def expire_sweep(store: AdvertStore, now_ms) -> AdvertStore:
    """Drop expired records (advertExpiry TTL); runs between waves."""
    live = (store.provider >= 0) & (store.expires_ms > now_ms)
    return AdvertStore(
        provider=torch.where(live, store.provider, -1),
        service=torch.where(live, store.service, -1),
        seq_no=torch.where(live, store.seq_no, 0),
        expires_ms=torch.where(live, store.expires_ms, 0.0),
    )
