"""Rank processes of a trial grid (parallel/sharding.make_trial_mesh) and
of a peer mesh (parallel/sharding.make_peer_mesh).

A grid of G trial groups runs G rank processes, one per group, each on
its group's device; the caller's process keeps its own device for the
work the reference keeps out of the grid (benign cells, baselines, the
conformance certificate). Trials are independent, so nothing but host
objects crosses between a grid's processes. A peer mesh's ranks also
exchange tensors: its jobs run collectives over the group the ranks
joined (parallel/peer.py), gloo or, for ranks on distinct GPUs, NCCL:

  start    G processes started with the `spawn` method (never `fork`: the
           caller may hold a CUDA context), each limited to `threads`
           CPU threads when given; they join one group (gloo unless the
           pool names nccl) through a FileStore in a temporary directory
           (no TCP port) and exchange a
           roll call over it, then report ready with their start-up
           seconds. Kernels are built in the caller first (native/build.py)
           when any rank is on CUDA, so ranks only load them.
  run      one job per rank: `fn(payload, device)` with fn a module-level
           function (sent by import path); a None payload leaves the rank
           idle. Results come back over one pipe per rank, with the rank's
           kernel launches and seconds for the job.
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

import datetime
import multiprocessing as mp
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback

import torch

# seconds a rank may take to start, or to answer one job
RANK_DEADLINE_S = 3600.0


class RankError(RuntimeError):
    """A rank of a trial grid raised, died or missed its deadline."""


def _launch_counts() -> dict:
    from ..native import score_update, vmem_gather

    return {"vmem_gather": vmem_gather.launches,
            "score_update": score_update.launches}


def _rank_main(rank: int, world: int, device: str, store_path: str,
               threads, conn, t_spawn: float, deadline_s: float,
               backend: str = "gloo") -> None:
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
        conn.send((True, {"startup_s": time.time() - t_spawn,
                          "roll": roll}))
    except Exception:  # noqa: BLE001 — reported to the caller, which raises
        conn.send((False, traceback.format_exc()))
        return
    try:
        while True:
            job = conn.recv()
            if job is None:
                break
            fn, payload = job
            if payload is None:
                conn.send((True, None))
                continue
            before = _launch_counts()
            t0 = time.perf_counter()
            try:
                out = fn(payload, dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            except Exception:  # noqa: BLE001 — the caller raises
                conn.send((False, traceback.format_exc()))
                continue
            after = _launch_counts()
            conn.send((True, {
                "result": out, "seconds": time.perf_counter() - t0,
                "launches": {k: after[k] - before[k] for k in after}}))
    except EOFError:
        pass                                    # the caller went away
    finally:
        dist.destroy_process_group()


class RankPool:
    """G rank processes, one per device of `devices` (a device may repeat:
    two ranks can share one card). Started on the first `run`; reusable
    across jobs and campaigns until `close`. `startup_s`: each rank's
    seconds from spawn to ready at the last start; `roll`: the (rank, pid,
    device) each rank sent over the gloo group; `launches` / `seconds`:
    each rank's kernel launches and job seconds summed over its jobs."""

    def __init__(self, devices, threads: int | None = None,
                 backend: str = "gloo"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a RankPool needs at least one device")
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r} not in (gloo, nccl)")
        self.threads = threads
        self.backend = backend
        self.startup_s: list[float] = []
        self.roll: list = []
        self.launches = [{"vmem_gather": 0, "score_update": 0}
                         for _ in self.devices]
        self.seconds = [0.0 for _ in self.devices]
        self._procs = None
        self._conns = None
        self._tmp = None

    @property
    def size(self) -> int:
        return len(self.devices)

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
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="trial_grid_")
        store = os.path.join(self._tmp, "store")
        t0 = time.time()
        self._procs, self._conns = [], []
        for r, dev in enumerate(self.devices):
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_rank_main, name=f"trial-rank-{r}", daemon=True,
                args=(r, self.size, str(dev), store, self.threads, child, t0,
                      RANK_DEADLINE_S, self.backend))
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
                conn.send((fn, payload))
            except (BrokenPipeError, OSError):
                pass                            # a dead rank: _collect names it
        outs = self._collect(getattr(fn, "__name__", "a job"),
                             deadline_s or RANK_DEADLINE_S)
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
