"""The reciprocal-permutation pull: out[q, j] = vals[conns[q,j], rev[q,j]].

Every exchange across the static directed-edge involution (p, i) <->
(q = conns[p,i], j = rev[p,i]) is this gather: GRAFT/PRUNE reciprocity in
the heartbeat, the offer pull of the sender-side fixpoint and the
accounting pulls of disseminate.

Two formulations, chosen by `exceeds_budget` exactly as the reference
chooses them, so the port takes the same path for the same shapes:
  - the row gather `vals[conns]` (an (N, C, C) intermediate) plus a one-hot
    slot select, below the budget;
  - the direct two-index gather `vals[conns, rev]`, above it.
Both give the same values. On a rank of the peer mesh (parallel/peer.py)
the source table is all-gathered first and the same formula runs on the
local rows of conns / rev; the budget is judged on the whole (N, C)
shape, so every rank takes the path one device takes. The budget constant is the reference's, a rule
written for the TPU (128-lane padding of the last axis); re-deriving it for
the H100 is later work, and changing it would move the sender-side /
receiver-side fixpoint switch in ops/disseminate.py with it.
"""

from __future__ import annotations

import torch

from ..parallel import peer

INF = 3.4e38

# Peak-memory budget of the padded (N, C, C) row-gather intermediate,
# verbatim from the reference (N*C*max(128, C)*itemsize bytes).
_MAX_INTERMEDIATE_BYTES = 6 * 1024**3
_LANE = 128


def exceeds_budget(dtype, conns_shape, batch_factor: int = 1) -> bool:
    """Would the padded row-gather intermediate for this pull exceed the
    budget? `batch_factor`: the fragment multiplicity the reference's vmap
    allocates at once, kept so the dispatch matches it."""
    n, c = conns_shape[-2], conns_shape[-1]
    itemsize = 1 if dtype == torch.bool else dtype.itemsize
    padded = n * c * max(_LANE, c) * itemsize * max(batch_factor, 1)
    return padded > _MAX_INTERMEDIATE_BYTES


def _row_pull(vals, conns, rev, select, batch_factor):
    q, r = conns.clamp_min(0), rev.clamp_min(0)
    whole = (peer.global_rows(conns.shape[0]), conns.shape[-1])
    vals = peer.all_rows(vals)
    if exceeds_budget(vals.dtype, whole, batch_factor):
        return vals[q, r]
    rows = vals[q]                                   # (N, C, C)
    sel = torch.arange(conns.shape[-1], device=conns.device) == r[..., None]
    return select(rows, sel)


def reciprocal_pull_bool(edge_mask, conns, rev, batch_factor: int = 1):
    """out[q, j] = edge_mask[conns[q,j], rev[q,j]]; False on invalid slots."""
    out = _row_pull(edge_mask, conns, rev,
                    lambda rows, sel: (rows & sel).any(dim=-1), batch_factor)
    return out & (conns >= 0) & (rev >= 0)


def neighbor_pull_bool(per_peer, conns, rev, batch_factor: int = 1):
    """out[q, j] = per_peer[conns[q,j]] (False on invalid slots): the
    reciprocal pull of the slot-constant (N, C) table, read off the (N,)
    vector itself (the same values on either formulation).
    `batch_factor` is the reciprocal pulls' argument, unused here."""
    valid = (conns >= 0) & (rev >= 0)
    return peer.all_rows(per_peer)[conns.clamp_min(0)] & valid


def neighbor_pull_min(per_peer, conns, rev, batch_factor: int = 1):
    """out[q, j] = per_peer[conns[q,j]] for floats; INF on invalid slots."""
    valid = (conns >= 0) & (rev >= 0)
    return torch.where(valid, peer.all_rows(per_peer)[conns.clamp_min(0)],
                       INF)


def reciprocal_pull_min(vals, conns, rev, batch_factor: int = 1):
    """out[q, j] = vals[conns[q,j], rev[q,j]] for float vals; INF on invalid
    slots. The row form selects the one slot with a masked min (INF is
    both the identity of min and the 'absent' sentinel)."""
    out = _row_pull(
        vals, conns, rev,
        lambda rows, sel: torch.where(sel, rows, INF).amin(dim=-1),
        batch_factor)
    return torch.where((conns >= 0) & (rev >= 0), out, INF)
