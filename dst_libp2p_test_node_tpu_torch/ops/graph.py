"""Connection-graph substrate: the "dial phase" as array construction.

The reference forms its network by every peer shuffling [0..PEERS)\\{me} with a
per-process RNG and dialing the first CONNECTTO peers
(gossipsub-queues/main.nim:367-409; go-test-node/main.go:276-348;
rust-test-node/src/main.rs:303-345). Connections are symmetric and capped by
MAXCONNECTIONS (main.nim:429). This module reproduces that *distribution*
deterministically (seeded per run, SURVEY.md §7 RNG note) and lays the result
out TPU-first:

  conns[p, i]  int32  — i-th neighbor of peer p, -1 padding (capacity C)
  rev[p, i]    int32  — slot j such that conns[conns[p, i], j] == p
  out_mask[p,i] bool  — True iff p dialed that neighbor (outbound, for D_out)
  degree[p]    int32

The reverse-slot map makes every graft/prune *reciprocal* update a single
fixed-shape scatter (mesh_mask[q, rev] = v) with no collision handling — the
key trick that lets the whole GossipSub control plane run under jit.

Built host-side in numpy once per experiment epoch (the reference dials once
at startup, main.nim:466-471); everything steady-state runs on device. The
build is a pure function of its arguments, so a process keeps the last
_BUILT_KEEP graphs it built and hands out copies of them: Simulators of
one network built one after another (a sweep, a restart, a warm twin)
skip the numpy build, which takes seconds at 1M peers.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, fields

import numpy as np


def _stable_group_ranks(keys: np.ndarray):
    """(order, first, ranks): stable sort order, group-start flags in sorted
    order, and each element's occurrence rank among equal keys in ARRAY
    order — the shared core of the two ranking entry points below."""
    m = len(keys)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    first = np.ones(m, dtype=bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    group_start = np.maximum.accumulate(np.where(first, np.arange(m), 0))
    ranks = np.empty(m, dtype=np.int64)
    ranks[order] = np.arange(m) - group_start
    return order, first, ranks


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Occurrence rank of each element among equal keys, in array order."""
    return _stable_group_ranks(keys)[2]


def _cumcount_and_filtered(keys: np.ndarray, cap: int, half: int):
    """One-sort version of the build's two ranking passes.

    Returns (ok, slot_full) where ok marks edges whose BOTH endpoint
    occurrences rank below `cap` (keys holds the src half then the dst
    half, `half` elements each), and slot_full[i] is the occurrence rank of
    keys[i] among the KEPT occurrences — bit-identical to running _cumcount
    again on the filtered arrays, without the second 40M-element argsort
    (the kept elements keep their relative order, so their kept-prefix
    count within each key group IS their filtered cumcount)."""
    m = len(keys)
    order, first, ranks = _stable_group_ranks(keys)
    ok = (ranks[:half] < cap) & (ranks[half:] < cap)

    kept_sorted = np.concatenate([ok, ok])[order]
    c = np.cumsum(kept_sorted)
    before = c - kept_sorted                    # kept strictly before, global
    base = np.maximum.accumulate(np.where(first, before, 0))  # ... at group start
    slot_full = np.empty(m, dtype=np.int64)
    slot_full[order] = before - base            # kept-prefix within the group
    return ok, slot_full


def sample_dials(n: int, connect_to: int, seed: int) -> np.ndarray:
    """dials[p] = the connect_to distinct peers (!= p) that p dials.

    Matches the reference's per-peer independent shuffle-and-take
    (main.nim:376-381). Exact row permutation for small n; rejection sampling
    for large n (collision probability ~ connect_to^2/n)."""
    rng = np.random.default_rng(seed)
    if n <= 4096:
        r = rng.random((n, n))
        np.fill_diagonal(r, np.inf)
        return np.argsort(r, axis=1)[:, :connect_to].astype(np.int64)

    k = connect_to
    draw = max(2 * k + 8, k + 16)
    # NOTE: the draw must stay int64 — the generator's output stream depends
    # on the requested dtype, and graph construction is fingerprinted
    # (runtime/checkpoint.py); narrow AFTER drawing
    cand = rng.integers(0, n - 1, size=(n, draw))
    me = np.arange(n)[:, None]
    cand = np.where(cand >= me, cand + 1, cand).astype(np.int32)
    # ^ uniform over [0..n)\{me}; int32 for the row sort below
    # take the first k distinct per row. "Duplicate" = an equal value
    # appeared EARLIER in the row; a stable row sort puts the earliest
    # occurrence first within each equal run, so flagging equal-to-
    # predecessor in sorted order and scattering back marks exactly the
    # later occurrences (O(n·draw·log draw), vs the old per-column loop's
    # O(n·draw²) — ~2 s faster at 1M).
    ordr = np.argsort(cand, axis=1, kind="stable")
    srt = np.take_along_axis(cand, ordr, axis=1)
    dup_sorted = np.concatenate(
        [np.zeros((n, 1), bool), srt[:, 1:] == srt[:, :-1]], axis=1)
    dup = np.empty_like(dup_sorted)
    np.put_along_axis(dup, ordr, dup_sorted, axis=1)
    keep_rank = np.cumsum(~dup, axis=1) - 1
    out = np.full((n, k), -1, dtype=np.int64)
    rows, cols = np.nonzero(~dup & (keep_rank < k))
    out[rows, keep_rank[rows, cols]] = cand[rows, cols]
    # rows that still have holes (astronomically rare): fill with (p+1+i) mod n
    holes = out < 0
    if holes.any():
        hr, hc = np.nonzero(holes)
        out[hr, hc] = (hr + 1 + hc) % n
    return out


@dataclass
class ConnGraph:
    conns: np.ndarray      # (N, C) int32, -1 padded
    rev: np.ndarray        # (N, C) int32, -1 padded
    out_mask: np.ndarray   # (N, C) bool
    degree: np.ndarray     # (N,) int32

    @property
    def n(self) -> int:
        return int(self.conns.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.conns.shape[1])

    def copy(self) -> "ConnGraph":
        return ConnGraph(**{f.name: getattr(self, f.name).copy()
                            for f in fields(self)})

    def validate(self) -> None:
        """Reverse-map invariant: conns[conns[p,i], rev[p,i]] == p."""
        p, i = np.nonzero(self.conns >= 0)
        q = self.conns[p, i]
        j = self.rev[p, i]
        assert (self.conns[q, j] == p).all(), "reverse-slot map broken"


# the graphs built from sampled dials, by (n, connect_to, seed, max_degree),
# least recently used first (module doc)
_BUILT: OrderedDict = OrderedDict()
_BUILT_KEEP = 2


def build_connection_graph(
    n: int,
    connect_to: int,
    seed: int = 0,
    max_degree: int | None = None,
    dials: np.ndarray | None = None,
) -> ConnGraph:
    """Symmetrize per-peer dials into padded neighbor lists + reverse map.

    max_degree plays MAXCONNECTIONS (main.nim:429): an edge is kept only if
    both endpoints still have a free slot, in random edge order — mirroring
    dial-time rejection by a full peer. Without `dials` the result is a
    copy of the process's cached build of these arguments, if it has one
    (module doc): callers may write into it."""
    if dials is not None:
        return _build(n, connect_to, seed, max_degree, dials)
    key = (int(n), int(connect_to), int(seed),
           None if max_degree is None else int(max_degree))
    graph = _BUILT.pop(key, None)
    if graph is None:
        graph = _build(n, connect_to, seed, max_degree,
                       sample_dials(n, connect_to, seed))
    _BUILT[key] = graph
    while len(_BUILT) > _BUILT_KEEP:
        _BUILT.popitem(last=False)
    return graph.copy()


def _build(n, connect_to, seed, max_degree, dials) -> ConnGraph:
    k = dials.shape[1]
    if max_degree is None:
        # expected degree = 2*connect_to; generous slack keeps rejections rare
        max_degree = min(max(4 * k, 16), max(n - 1, 1))
    cap = max_degree

    # int32 endpoint ids: the stable argsorts below are the build's hot spot
    # and sort ~2x faster on the narrower dtype (peer ids fit easily)
    src = np.repeat(np.arange(n, dtype=np.int32), k)
    dst = dials.reshape(-1).astype(np.int32)
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    # dedupe undirected pairs, keeping the first dialer as the outbound side
    # (pair key needs the full int64 range: n^2 ids)
    pair_key = lo.astype(np.int64) * n + hi
    _, first_idx = np.unique(pair_key, return_index=True)
    first_idx.sort()
    e_src, e_dst = src[first_idx], dst[first_idx]

    # random edge order, then capacity filter (both endpoints must have room)
    rng = np.random.default_rng(seed + 0x5EED)
    order = rng.permutation(len(e_src))
    e_src, e_dst = e_src[order], e_dst[order]
    # a node occupies one slot per incident edge regardless of direction, so
    # slot ranks count appearances across BOTH endpoint arrays; the src copy
    # of edge e sits at position e, the dst copy at position E + e, keeping
    # slot order aligned with edge order
    m = len(e_src)
    ok, slot_full = _cumcount_and_filtered(
        np.concatenate([e_src, e_dst]), cap, m)
    slot_src, slot_dst = slot_full[:m][ok], slot_full[m:][ok]
    e_src, e_dst = e_src[ok], e_dst[ok]

    conns = np.full((n, cap), -1, dtype=np.int32)
    rev = np.full((n, cap), -1, dtype=np.int32)
    out = np.zeros((n, cap), dtype=bool)
    conns[e_src, slot_src] = e_dst
    conns[e_dst, slot_dst] = e_src
    rev[e_src, slot_src] = slot_dst
    rev[e_dst, slot_dst] = slot_src
    out[e_src, slot_src] = True  # dialer side is the outbound connection
    degree = (conns >= 0).sum(axis=1).astype(np.int32)
    return ConnGraph(conns=conns, rev=rev, out_mask=out, degree=degree)
