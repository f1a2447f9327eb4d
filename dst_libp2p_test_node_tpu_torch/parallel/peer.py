"""The peer mesh on one rank: its row block of every peer-major leaf, and
the collectives a cross-row read or write needs.

The reference shards every (N, ...) peer-major array over a 1-D "peers"
device mesh and lets GSPMD insert the collectives. torch has no GSPMD, so
the port runs one process per device (SPMD ranks over torch.distributed,
parallel/ranks.py) and each rank runs the ordinary port modules on rows
[r*N/P, (r+1)*N/P) of every peer-major leaf. The modules reach across
rows in a few places only, and each goes through this module:

  all_rows(x)      the (N, ...) whole of a row-sharded x (one all-gather):
                   the pulls (ops/pull.py), the receiver-side constants and
                   every fixpoint sweep (parallel/exchange.py), the answer
                   folds' read of t at the neighbors, PX adverts
  any_(x)          a host predicate over every row (one all-reduce of a
                   bit): the heartbeat's branch conds, the fixpoints'
                   change bits, the exact route's host decisions
  or_(x), max_(x)  elementwise OR / MAX of a small tensor over the ranks
                   (per-fragment flags, the bounded mode's error bar)
  read_row(x, i)   x[i] on every rank (a broadcast from the owner): the
                   publisher's tx time and warm-start carry, the mix
                   relay's occupancy at its path's ends
  write_row(x,i,v) x[i] = v on the owning rank
  prefix_rows(x, m)
                   the whole rows [0, m) of x on every rank (one
                   all-gather of at most m rows): the mix relay's draw
                   over the mix nodes, which are the first NUMMIX peers
  add_rows(x, idx, val)
                   x.index_add(0, idx, val) for distinct global row ids:
                   each owner adds to its rows, no collective (the mix
                   relay's byte counters)
  row_ids(n)       the global peer ids of the local rows
  uniform(k, shp), randint(k, shp, lo, hi)
                   the local rows of a per-peer draw (prng.py's row
                   blocks: the same bits as the full draw's rows)
  isum(x), psum(x) an integer count over every row, an integer tensor
                   summed over the ranks (the observables' counts)
  sum_f32(x)       a float32 sum over every row: the rows all-gathered
                   and summed in one place, in XLA's order
                   (xlamath.sum_f32), never partial sums added up
  scatter_amin(n, idx, val, fill), index_add(x, idx, val),
  scatter_or(shape, rows, cols)
                   writes into other ranks' rows: each rank scatters into
                   a whole-size buffer, the buffers are reduced (MIN,
                   SUM, MAX) over the ranks, and a rank keeps its rows
                   (the repair controller's dial winner, its graft counts
                   and the counterpart's mesh slot)

Without an active group each helper is the single-device operation, so
the modules run unchanged in one process. A group is made active with
`using(group)` around a rank's calls (runtime/sharded.py).

Float reductions never sum local partials across ranks: every cross-row
float sum is all-gathered and summed in one place (XLA's order), and the
quantiles read the gathered values. Min, max and integer sums are exact
whatever the order, so those reduce over the ranks.

Counters: each PeerGroup's `stats` counts its all-gathers, all-reduces
and broadcasts and the bytes each moved (an all-gather's assembled
tensor, an all-reduce's buffer, a broadcast's row), and `ranks` holds the
global ranks of its group; `ledger()` has the same counts for the whole
process, keyed by (kind, the group's global ranks), which the rank pools
send back per job (parallel/ranks.py) for the sharding auditor
(analysis/sharding_audit.py). Counting moves no result byte.

Backend: NCCL when every rank has a distinct CUDA device, gloo otherwise
(ranks sharing one card, CPU ranks). gloo's collectives here run on
host tensors: a CUDA tensor is staged through the host explicitly (gloo
would stage it anyway), and bool tables travel as uint8. The list form
of all_gather is used (gloo lacks the into-one-tensor form in some torch
releases).
"""

from __future__ import annotations

import contextlib

import torch

from .. import prng
from ..ops.xlamath import sum_f32 as _sum_f32


class PeerGroup:
    """One rank's view of a peer mesh of `world` ranks over `n_rows` peer
    rows (torch.distributed must be initialized; `group` None is the
    default group, whose ranks are the mesh's). `stats` counts the
    collectives this rank took part in and their bytes (module doc);
    `ranks` the global ranks of its group."""

    def __init__(self, rank: int, world: int, n_rows: int, device,
                 backend: str | None = None, group=None):
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        if n_rows % world != 0:
            raise ValueError(
                f"peer rows {n_rows} must divide evenly over {world} "
                "devices")
        self.rank, self.world, self.n = int(rank), int(world), int(n_rows)
        self.rows_per = self.n // self.world
        self.r0 = self.rank * self.rows_per
        self.r1 = self.r0 + self.rows_per
        self.device = torch.device(device)
        if backend is None:
            import torch.distributed as dist

            backend = dist.get_backend(group)
        self.backend = str(backend)
        self.group = group
        # gloo reduces host tensors: stage CUDA tensors through the host
        self._host = self.backend == "gloo"
        if group is None:
            self.ranks = tuple(range(self.world))
        else:
            import torch.distributed as dist

            self.ranks = tuple(int(r) for r in
                               dist.get_process_group_ranks(group))
        self.stats = {"all_gather": 0, "all_gather_bytes": 0,
                      "all_reduce": 0, "all_reduce_bytes": 0,
                      "broadcast": 0, "broadcast_bytes": 0}

    def __repr__(self) -> str:
        return (f"PeerGroup(rank={self.rank}, world={self.world}, "
                f"rows=[{self.r0}, {self.r1}) of {self.n}, "
                f"{self.backend}, {self.device})")

    def owner(self, i: int) -> int:
        return int(i) // self.rows_per

    def _comm(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self._host else x.to(self.device)

    def _count(self, kind: str, t: torch.Tensor) -> None:
        nbytes = t.numel() * t.element_size()
        self.stats[kind] += 1
        self.stats[kind + "_bytes"] += nbytes
        entry = _LEDGER.setdefault((kind, self.ranks), [0, 0])
        entry[0] += 1
        entry[1] += nbytes

    def _gather(self, x: torch.Tensor, keep) -> torch.Tensor:
        """Every rank's `x` (equal shapes), each cut to its first
        keep[r] rows, concatenated in rank order."""
        import torch.distributed as dist

        is_bool = x.dtype == torch.bool
        src = self._comm((x.to(torch.uint8) if is_bool else x).contiguous())
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat([p[:k] for p, k in zip(parts, keep)],
                        dim=0).to(x.device)
        self._count("all_gather", out)
        return out.bool() if is_bool else out

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The (N, ...) tensor whose rows [r0, r1) are this rank's `x`."""
        if x.shape[0] != self.rows_per:
            raise ValueError(
                f"all_rows of {tuple(x.shape)}: a rank holds "
                f"{self.rows_per} rows")
        return self._gather(x, [self.rows_per] * self.world)

    def prefix(self, x: torch.Tensor, m: int) -> torch.Tensor:
        """The whole rows [0, m) of a row-sharded x: each rank sends its
        rows inside the prefix, padded to one length (at most m rows)."""
        if x.shape[0] != self.rows_per:
            raise ValueError(
                f"prefix of {tuple(x.shape)}: a rank holds "
                f"{self.rows_per} rows")
        m = max(0, min(int(m), self.n))
        keep = [max(0, min(m - r * self.rows_per, self.rows_per))
                for r in range(self.world)]
        width = max(min(m, self.rows_per), 1)
        mine = keep[self.rank]
        piece = torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device)
        piece[:mine] = x[:mine]
        return self._gather(piece, keep)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        buf = self._comm(t.contiguous()).clone()
        dist.all_reduce(buf, op=op, group=self.group)
        self._count("all_reduce", buf)
        return buf

    def any_(self, x: torch.Tensor) -> bool:
        import torch.distributed as dist

        bit = torch.tensor([int(bool(x.any()))], dtype=torch.int32)
        return bool(self._reduce(bit, dist.ReduceOp.MAX)[0])

    def or_(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        out = self._reduce(x.to(torch.int32), dist.ReduceOp.MAX)
        return out.to(x.device) > 0

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        return self._reduce(x, dist.ReduceOp.MAX).to(x.device)

    def min_(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        return self._reduce(x, dist.ReduceOp.MIN).to(x.device)

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks of an integer tensor (exact)."""
        import torch.distributed as dist

        if x.is_floating_point():
            raise TypeError("a float sum over the ranks would depend on "
                            "their order: gather the rows (sum_f32)")
        return self._reduce(x, dist.ReduceOp.SUM).to(x.device)

    def read_row(self, x: torch.Tensor, i: int) -> torch.Tensor:
        import torch.distributed as dist

        own = self.owner(i)
        if own == self.rank:
            val = x[int(i) - self.r0].clone()
        else:
            val = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
        is_bool = val.dtype == torch.bool
        buf = self._comm(
            (val.to(torch.uint8) if is_bool else val).contiguous()).clone()
        dist.broadcast(buf, src=(own if self.group is None else
                                 dist.get_global_rank(self.group, own)),
                       group=self.group)
        self._count("broadcast", buf)
        buf = buf.to(x.device)
        return buf.bool() if is_bool else buf

    def write_row(self, x: torch.Tensor, i: int, v) -> None:
        if self.r0 <= int(i) < self.r1:
            x[int(i) - self.r0] = v

    def row_ids(self, device) -> torch.Tensor:
        return torch.arange(self.r0, self.r1, device=device)

    def local(self, x):
        """Rows [r0, r1) of a whole (N, ...) array (numpy or torch)."""
        if x.shape[0] != self.n:
            raise ValueError(
                f"local rows of {tuple(x.shape)}: the mesh has {self.n} "
                "rows")
        return x[self.r0:self.r1]


_ACTIVE: PeerGroup | None = None

# this process's collectives: (kind, the group's global ranks) ->
# [count, bytes], over every PeerGroup it made
_LEDGER: dict = {}


def ledger() -> dict:
    """A copy of this process's collective counts (module doc)."""
    return {k: list(v) for k, v in _LEDGER.items()}


def active() -> PeerGroup | None:
    """The group whose rows this process computes, or None (one device)."""
    return _ACTIVE


@contextlib.contextmanager
def using(group: PeerGroup | None):
    """Make `group` the active one for the block (None: one device)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, group
    try:
        yield group
    finally:
        _ACTIVE = prev


def all_rows(x: torch.Tensor) -> torch.Tensor:
    return x if _ACTIVE is None else _ACTIVE.all_rows(x)


def any_(x: torch.Tensor) -> bool:
    return bool(x.any()) if _ACTIVE is None else _ACTIVE.any_(x)


def or_(x: torch.Tensor) -> torch.Tensor:
    return x if _ACTIVE is None else _ACTIVE.or_(x)


def max_(x: torch.Tensor) -> torch.Tensor:
    return x if _ACTIVE is None else _ACTIVE.max_(x)


def psum(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor summed elementwise over the ranks."""
    return x if _ACTIVE is None else _ACTIVE.sum_(x)


def isum(x: torch.Tensor) -> torch.Tensor:
    """x.sum(dtype=int64) over every row, as a 0-d int64 tensor."""
    return psum(x.sum(dtype=torch.int64))


def sum_f32(x: torch.Tensor) -> torch.Tensor:
    """xlamath.sum_f32 over every row of a row-sharded x (gathered)."""
    return _sum_f32(all_rows(x))


def scatter_amin(n: int, idx: torch.Tensor, val: torch.Tensor,
                 fill: int) -> torch.Tensor:
    """The whole (n,) full(fill).scatter_reduce(0, idx, val, "amin") of
    every rank's (idx, val) pairs: a min, so the same whatever rank or
    order each write comes from. Every rank gets all n entries."""
    out = torch.full((n,), fill, dtype=val.dtype, device=val.device)
    out = out.scatter_reduce(0, idx.long(), val, reduce="amin")
    return out if _ACTIVE is None else _ACTIVE.min_(out)


def index_add(x: torch.Tensor, idx: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """x.index_add(0, idx, val) for an integer x whose rows are sharded
    and global row ids idx: each rank adds its writes into a whole-size
    buffer, the buffers are summed over the ranks (exact) and a rank adds
    its rows of the sum."""
    if _ACTIVE is None:
        return x.index_add(0, idx, val)
    buf = torch.zeros((_ACTIVE.n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device).index_add(0, idx, val)
    return x + _ACTIVE.local(_ACTIVE.sum_(buf))


def scatter_or(shape, rows: torch.Tensor, cols: torch.Tensor,
               device) -> torch.Tensor:
    """This rank's rows of the (N, C) bool mask that is True at every
    (rows[k], cols[k]) any rank writes (global row ids)."""
    n = global_rows(shape[0])
    buf = torch.zeros((n,) + tuple(shape[1:]), dtype=torch.bool,
                      device=device)
    buf[rows.long(), cols.long()] = True
    if _ACTIVE is None:
        return buf
    return _ACTIVE.local(_ACTIVE.max_(buf.to(torch.uint8)) > 0)


def read_row(x: torch.Tensor, i: int) -> torch.Tensor:
    return x[int(i)] if _ACTIVE is None else _ACTIVE.read_row(x, i)


def write_row(x: torch.Tensor, i: int, v) -> None:
    if _ACTIVE is None:
        x[int(i)] = v
    else:
        _ACTIVE.write_row(x, i, v)


def prefix_rows(x: torch.Tensor, m: int) -> torch.Tensor:
    """The whole rows [0, m) of a row-sharded x (x[:m] on one device)."""
    return x[:int(m)] if _ACTIVE is None else _ACTIVE.prefix(x, m)


def add_rows(x: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """x.index_add(0, idx, val) for distinct global row ids `idx` of a
    row-sharded x: each owner adds to its own rows, so each row gets the
    one add it gets on one device (the same bits for a float x)."""
    if _ACTIVE is None:
        return x.index_add(0, idx, val)
    mine = (idx >= _ACTIVE.r0) & (idx < _ACTIVE.r1)
    return x.index_add(0, idx[mine] - _ACTIVE.r0, val[mine])


def row_ids(n: int, device) -> torch.Tensor:
    """Global peer ids of the n local rows."""
    if _ACTIVE is None:
        return torch.arange(n, device=device)
    if n != _ACTIVE.rows_per:
        raise ValueError(f"{n} rows on a rank of {_ACTIVE.rows_per}")
    return _ACTIVE.row_ids(device)


def global_rows(n: int) -> int:
    """The whole row count of a leaf with n local rows."""
    return n if _ACTIVE is None else _ACTIVE.n


def local_count(n_global: int) -> int:
    """The local row count of an n_global-row leaf."""
    return n_global if _ACTIVE is None else _ACTIVE.rows_per


def local(x):
    """This process's rows of a whole (N, ...) array (numpy or torch)."""
    return x if _ACTIVE is None else _ACTIVE.local(x)


def _block(shape, axis: int):
    """(the whole draw's shape, this rank's rows) of a per-peer draw."""
    if shape[axis] != _ACTIVE.rows_per:
        raise ValueError(
            f"a per-peer draw of {shape} on a rank of {_ACTIVE.rows_per} "
            "rows")
    whole = shape[:axis] + (_ACTIVE.n,) + shape[axis + 1:]
    return whole, (_ACTIVE.r0, _ACTIVE.r1)


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            axis: int = 0) -> torch.Tensor:
    """prng.randint over a per-peer shape (the local rows on a rank)."""
    shape = tuple(shape)
    if _ACTIVE is None:
        return prng.randint(key, shape, minval, maxval)
    whole, rows = _block(shape, axis)
    return prng.randint(key, whole, minval, maxval, rows=rows, axis=axis)


def uniform(key: torch.Tensor, shape, axis: int = 0) -> torch.Tensor:
    """prng.uniform over a per-peer shape whose `axis` holds the local
    rows: on a rank, those rows of the whole draw."""
    shape = tuple(shape)
    if _ACTIVE is None:
        return prng.uniform(key, shape)
    whole, rows = _block(shape, axis)
    return prng.uniform(key, whole, rows=rows, axis=axis)

