"""Frozen copy of the port's connection-graph build (numpy, host).

The reference re-derives the network from the seed instead of reading the
program's: the same per-peer dials (numpy's default_rng(seed)), the same
capacity filter in the same random edge order (default_rng(seed + 0x5EED)),
the same slot layout. `build(n, connect_to, seed, max_degree)` returns
(conns, rev, out_mask) as numpy arrays.
"""

from __future__ import annotations

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


def build(n: int, connect_to: int, seed: int, max_degree: int):
    """(conns, rev, out_mask) of the seeded network."""
    dials = sample_dials(n, connect_to, seed)
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
    return conns, rev, out
