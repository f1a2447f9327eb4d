"""Rank processes of a trial grid (parallel/sharding.make_trial_mesh) and
of a peer mesh (parallel/sharding.make_peer_mesh).

A grid of G trial groups, each P devices wide, runs G x P rank processes,
one per device, rank g*P + p on device p of group g; the caller's process
keeps its own device for the work the reference keeps out of the grid
(benign cells, baselines, the conformance certificate). Trials are
independent, so between groups nothing but host objects crosses. Inside
a group wider than one device (`peer_width` P > 1) the ranks split each
trial's peer rows and exchange tensors over the group's own
torch.distributed subgroup (`peer_group`, parallel/peer.py), as a peer
mesh's ranks do over the whole pool: gloo or, for ranks on distinct GPUs,
NCCL:

  start    the processes forked from a `forkserver` that imported torch
           once (never forked from the caller, which may hold a CUDA
           context; the server never touches a card), so a rank starts
           in a fraction of a second once the server runs; a rank sees
           the environment the caller had when the server started. Each
           is limited to `threads` CPU threads when given; they join one
           group (gloo unless the
           pool names nccl) through a FileStore in a temporary directory
           (no TCP port), exchange a roll call over it, make the peer
           subgroups (every rank makes every subgroup, in order), then
           report ready with their start-up seconds. Kernels are built in
           the caller first (native/build.py) when any rank is on CUDA, so
           ranks only load them.
  run      one job per rank: `fn(payload, device)` with fn a module-level
           function (sent by import path); a None payload leaves the rank
           idle. Results come back over one pipe per rank, with the rank's
           kernel launches and seconds for the job, its collectives (by
           kind and group, parallel/peer.ledger), its peak device-memory
           rise over the job (measured inside `recording()` on a card,
           with Python's cyclic garbage collector paused so the peak does
           not depend on when it runs; None otherwise). Inside
           `recording()` the pool keeps these facts of every job, and the
           bytes of each rank's result (analysis/sharding_audit.py reads
           them).
  close    every rank told to exit, joined with a deadline, killed after.

Every wait on a rank has a deadline, and so has every collective (the
group's timeout). A rank whose job raises makes `run` raise RankError
with the rank's number and its traceback, after every rank has answered
(no result is assembled from the others); a rank that dies (inside a
collective too: the others are then stuck in it) or misses the deadline
makes it raise at once, and the pool is closed, its stuck ranks killed
(the next `run` starts it again).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import multiprocessing as mp
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

# seconds a rank may take to start, or to answer one job
RANK_DEADLINE_S = 3600.0


class RankError(RuntimeError):
    """A rank of a trial grid raised, died or missed its deadline."""


# in a rank process of a pool with peer_width > 1: (its trial group's
# subgroup, its index in the group, the width)
_SUBGROUP = None


def peer_group(n_rows: int, device):
    """This rank's parallel/peer.PeerGroup over `n_rows` peer rows inside
    its trial group (in a rank job of a pool with peer_width > 1); None
    in a pool one rank wide per group."""
    if _SUBGROUP is None:
        return None
    from .peer import PeerGroup

    grp, idx, width = _SUBGROUP
    return PeerGroup(idx, width, n_rows, device, group=grp)


def _join_subgroups(rank: int, world: int, width: int, backend: str):
    global _SUBGROUP
    import torch.distributed as dist

    for g in range(world // width):
        members = list(range(g * width, (g + 1) * width))
        sub = dist.new_group(members, backend=backend)
        if rank in members:
            _SUBGROUP = (sub, rank - g * width, width)


def _collectives_since(before: dict) -> list:
    from .peer import ledger

    out = []
    for (kind, ranks), (count, nbytes) in sorted(ledger().items()):
        c0, b0 = before.get((kind, ranks), (0, 0))
        if count > c0:
            out.append({"kind": kind, "ranks": list(ranks),
                        "count": count - c0, "bytes": nbytes - b0})
    return out


def _array_bytes(tree) -> int:
    """Bytes of the array and tensor leaves of a job's result tree
    (dicts, lists, tuples, dataclasses)."""
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_array_bytes(x) for x in tree)
    return 0


def _launch_counts() -> dict:
    from ..native import score_update, vmem_gather

    return {"vmem_gather": vmem_gather.launches,
            "score_update": score_update.launches}


def _rank_main(rank: int, world: int, device: str, store_path: str,
               threads, conn, t_spawn: float, deadline_s: float,
               backend: str = "gloo", peer_width: int = 1) -> None:
    """One rank: join the group, then serve jobs until told to stop."""
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)          # the context, up front
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=deadline_s))
        roll = [None] * world
        dist.all_gather_object(roll, (rank, os.getpid(), device))
        if peer_width > 1:
            _join_subgroups(rank, world, peer_width, backend)
        conn.send((True, {"startup_s": time.time() - t_spawn,
                          "roll": roll}))
    except Exception:  # noqa: BLE001 — reported to the caller, which raises
        conn.send((False, traceback.format_exc()))
        return
    from .peer import ledger

    try:
        while True:
            job = conn.recv()
            if job is None:
                break
            fn, payload, measure = job
            if payload is None:
                conn.send((True, None))
                continue
            before = _launch_counts()
            held = ledger()
            measure = measure and dev.type == "cuda"
            if measure:
                # a recorded job's own peak (module doc); otherwise the
                # peak counts on from what the caller last reset
                gc.collect()
                gc.disable()
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            try:
                out = fn(payload, dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            except Exception:  # noqa: BLE001 — the caller raises
                conn.send((False, traceback.format_exc()))
                continue
            finally:
                if measure:
                    gc.enable()
            after = _launch_counts()
            conn.send((True, {
                "result": out, "seconds": time.perf_counter() - t0,
                "launches": {k: after[k] - before[k] for k in after},
                "collectives": _collectives_since(held),
                "peak_rise": (torch.cuda.max_memory_allocated(dev) - base
                              if measure else None)}))
    except EOFError:
        pass                                    # the caller went away
    finally:
        dist.destroy_process_group()


class RankPool:
    """One rank process per device of `devices` (a device may repeat: two
    ranks can share one card), in groups of `peer_width` consecutive ranks
    (a trial group each; module doc). Started on the first `run`; reusable
    across jobs and campaigns until `close`. `startup_s`: each rank's
    seconds from spawn to ready at the last start; `roll`: the (rank, pid,
    device) each rank sent over the gloo group; `launches` / `seconds`:
    each rank's kernel launches and job seconds summed over its jobs."""

    def __init__(self, devices, threads: int | None = None,
                 backend: str = "gloo", peer_width: int = 1):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a RankPool needs at least one device")
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r} not in (gloo, nccl)")
        if peer_width < 1 or len(self.devices) % peer_width != 0:
            raise ValueError(
                f"peer_width {peer_width} must divide the rank count "
                f"{len(self.devices)}")
        self.threads = threads
        self.backend = backend
        self.peer_width = int(peer_width)
        self.startup_s: list[float] = []
        self.roll: list = []
        self.launches = [{"vmem_gather": 0, "score_update": 0}
                         for _ in self.devices]
        self.seconds = [0.0 for _ in self.devices]
        self._procs = None
        self._conns = None
        self._tmp = None
        self._record = None

    @contextlib.contextmanager
    def recording(self):
        """Within the block, every job's per-rank facts (collectives,
        peak_rise, launches, seconds, and result_bytes: the array bytes
        of the rank's result) are appended, one list a job, to the list
        this yields."""
        prev, self._record = self._record, []
        try:
            yield self._record
        finally:
            self._record = prev

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def groups(self) -> int:
        """The trial groups: size / peer_width."""
        return self.size // self.peer_width

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def start(self) -> None:
        if self._procs is not None:
            return
        if any(d.type == "cuda" for d in self.devices):
            from ..native import build

            build.build()                       # ranks only load them
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(["torch"])
        self._tmp = tempfile.mkdtemp(prefix="trial_grid_")
        store = os.path.join(self._tmp, "store")
        t0 = time.time()
        self._procs, self._conns = [], []
        for r, dev in enumerate(self.devices):
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_rank_main, name=f"trial-rank-{r}", daemon=True,
                args=(r, self.size, str(dev), store, self.threads, child, t0,
                      RANK_DEADLINE_S, self.backend, self.peer_width))
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        ready = self._collect("start-up", RANK_DEADLINE_S)
        self.startup_s = [r["startup_s"] for r in ready]
        self.roll = ready[0]["roll"]

    def run(self, fn, payloads: list, deadline_s: float | None = None):
        """fn(payloads[r], device_r) on every rank r (None: idle); the
        results in rank order (None for an idle rank)."""
        if len(payloads) != self.size:
            raise ValueError(
                f"{len(payloads)} payloads for {self.size} ranks")
        self.start()
        for conn, payload in zip(self._conns, payloads):
            try:
                conn.send((fn, payload, self._record is not None))
            except (BrokenPipeError, OSError):
                pass                            # a dead rank: _collect names it
        outs = self._collect(getattr(fn, "__name__", "a job"),
                             deadline_s or RANK_DEADLINE_S)
        if self._record is not None:
            self._record.append([None if out is None else dict(
                {k: v for k, v in out.items() if k != "result"},
                result_bytes=_array_bytes(out["result"])) for out in outs])
        results = []
        for r, out in enumerate(outs):
            if out is None:
                results.append(None)
                continue
            for k, v in out["launches"].items():
                self.launches[r][k] += v
            self.seconds[r] += out["seconds"]
            results.append(out["result"])
        return results

    def _collect(self, what: str, deadline_s: float) -> list:
        deadline = time.monotonic() + deadline_s
        pending = set(range(self.size))
        outs: list = [None] * self.size
        errors: dict[int, str] = {}
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                self.close(grace_s=2.0)
                raise RankError(
                    f"ranks {sorted(pending)} missed the {deadline_s:.0f} s "
                    f"deadline of {what}")
            multiprocessing.connection.wait(
                [self._conns[r] for r in pending]
                + [self._procs[r].sentinel for r in pending], timeout=left)
            for r in sorted(pending):
                if self._conns[r].poll():
                    try:
                        ok, val = self._conns[r].recv()
                    except EOFError:
                        ok, val = None, None
                    if ok is not None:
                        pending.discard(r)
                        if ok:
                            outs[r] = val
                        else:
                            errors[r] = val
                        continue
                if not self._procs[r].is_alive():
                    code = self._procs[r].exitcode
                    # the other ranks may wait in a collective with it
                    self.close(grace_s=2.0)
                    raise RankError(
                        f"rank {r} ({self.devices[r]}) exited with code "
                        f"{code} during {what}")
        if errors:
            if what == "start-up":
                self.close()
            raise RankError("; ".join(
                f"rank {r} ({self.devices[r]}) raised during {what}:\n"
                f"{tb}" for r, tb in sorted(errors.items())))
        return outs

    def close(self, grace_s: float = 30.0) -> None:
        """Stop every rank (told, joined within `grace_s`, then killed)."""
        if self._procs is None:
            return
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        deadline = time.monotonic() + grace_s
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5.0)
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._tmp, ignore_errors=True)
        self._procs = self._conns = self._tmp = None
