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
                   publisher's tx time and warm-start carry
  write_row(x,i,v) x[i] = v on the owning rank
  row_ids(n)       the global peer ids of the local rows
  uniform(k, shp)  the local rows of a per-peer draw (prng.py's row
                   blocks: the same bits as the full draw's rows)

Without an active group each helper is the single-device operation, so
the modules run unchanged in one process. A group is made active with
`using(group)` around a rank's calls (runtime/sharded.py).

Float reductions never sum local partials across ranks: a cross-row float
sum would be all-gathered and summed in one place (XLA's order). The ones
the slice needs are min and max, which are order-free, and counts.

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


class PeerGroup:
    """One rank's view of a peer mesh of `world` ranks over `n_rows` peer
    rows (torch.distributed must be initialized; `group` None is the
    default group, whose ranks are the mesh's). `stats` counts the
    collectives this rank took part in and the bytes each gathered
    (N, ...) tensor holds."""

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
        self.stats = {"all_gather": 0, "all_gather_bytes": 0,
                      "all_reduce": 0, "broadcast": 0}

    def __repr__(self) -> str:
        return (f"PeerGroup(rank={self.rank}, world={self.world}, "
                f"rows=[{self.r0}, {self.r1}) of {self.n}, "
                f"{self.backend}, {self.device})")

    def owner(self, i: int) -> int:
        return int(i) // self.rows_per

    def _comm(self, x: torch.Tensor) -> torch.Tensor:
        return x.cpu() if self._host else x.to(self.device)

    def all_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The (N, ...) tensor whose rows [r0, r1) are this rank's `x`."""
        import torch.distributed as dist

        if x.shape[0] != self.rows_per:
            raise ValueError(
                f"all_rows of {tuple(x.shape)}: a rank holds "
                f"{self.rows_per} rows")
        is_bool = x.dtype == torch.bool
        src = self._comm((x.to(torch.uint8) if is_bool else x).contiguous())
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=0).to(x.device)
        self.stats["all_gather"] += 1
        self.stats["all_gather_bytes"] += out.numel() * out.element_size()
        return out.bool() if is_bool else out

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist

        buf = self._comm(t.contiguous()).clone()
        dist.all_reduce(buf, op=op, group=self.group)
        self.stats["all_reduce"] += 1
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

    def read_row(self, x: torch.Tensor, i: int) -> torch.Tensor:
        import torch.distributed as dist

        own = self.owner(i)
        if own == self.rank:
            val = x[int(i) - self.r0].clone()
        else:
            val = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
        buf = self._comm(val.contiguous()).clone()
        dist.broadcast(buf, src=own, group=self.group)
        self.stats["broadcast"] += 1
        return buf.to(x.device)

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


def read_row(x: torch.Tensor, i: int) -> torch.Tensor:
    return x[int(i)] if _ACTIVE is None else _ACTIVE.read_row(x, i)


def write_row(x: torch.Tensor, i: int, v) -> None:
    if _ACTIVE is None:
        x[int(i)] = v
    else:
        _ACTIVE.write_row(x, i, v)


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


def uniform(key: torch.Tensor, shape, axis: int = 0) -> torch.Tensor:
    """prng.uniform over a per-peer shape whose `axis` holds the local
    rows: on a rank, those rows of the whole draw."""
    shape = tuple(shape)
    if _ACTIVE is None:
        return prng.uniform(key, shape)
    if shape[axis] != _ACTIVE.rows_per:
        raise ValueError(
            f"a per-peer draw of {shape} on a rank of {_ACTIVE.rows_per} "
            "rows")
    whole = shape[:axis] + (_ACTIVE.n,) + shape[axis + 1:]
    return prng.uniform(key, whole, rows=(_ACTIVE.r0, _ACTIVE.r1),
                        axis=axis)

