"""Simulators on a peer mesh: the caller's handles and the ranks' side.

`Simulator(cfg, mesh=make_peer_mesh(...))` and `MultiTopicSimulator(cfg,
mesh=...)` return the handles of this module. A handle keeps the host
side of an experiment (config, topology, connection graph, params,
message ids, records, membership counters, the heartbeat carry) and
sends every call to the mesh's rank processes (parallel/ranks.py). Each
rank builds the ordinary port Simulator under its parallel/peer.PeerGroup,
so it holds rows [r*N/P, (r+1)*N/P) of every peer-major leaf (T*N virtual
peer rows for the multi-topic one) and runs the same modules on them;
the stage matrices are replicated. The ranks exchange only what a
cross-row read or write needs (parallel/peer.py).

  warmup / advance    the heartbeats on every rank
  publish             one disseminate on every rank (mesh= its group: the
                      receiver-side fixpoints through converge_sharded,
                      the serial engine); the handle row-concatenates the
                      ranks' result rows and builds the record as one
                      device does, so records, latencies and summaries
                      come out in the one-device layout
  publish_batch       a loop of publish, as the reference's mesh path
  set_subscribed, rebind_graph, reset
                      host bookkeeping in the handle, the leaves on ranks
  state               a gathered read-only copy (host tensors): metrics,
                      checkpoint saves; assigning it scatters the rows
                      (load_checkpoint(mesh=))

Mix relay and the flight recorder under a mesh are the next slice.
Launches: each rank counts its kernel launches per call and sends the
counts back over its pipe (RankPool.launches); `collectives()` has each
rank's all-gathers and their bytes; `rank_peak_bytes` each rank's peak
allocated device memory since the handle was built (None on the CPU).
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from .. import interop
from ..ops import disseminate as dsm
from ..parallel import peer
from ..parallel.sharding import (
    check_peer_mesh,
    peer_mesh_later,
    reshard_rows,
    shard_simulation,
)
from .multitopic import MultiTopicSimulator
from .simulator import Simulator

# the SimState leaves that are not peer-major (replicated on every rank)
_REPLICATED = ("t_ms", "key")

_RESULT_ROWS = ("t_rx_ms", "delay_ms", "received", "sends", "copies_rx",
                "ihave_sent", "iwant_sent", "lost_tx")
_RESULT_SCALARS = ("answer_wait_max_ms", "answer_interleaved", "converged",
                   "refine_passes")

_IDS = itertools.count()

# ------------------------------------------------------------ rank side

# in a rank process: handle id -> (PeerGroup, Simulator on its rows)
_RANK_SIMS: dict = {}


def rank_simulator(kind: str, cfg, topology, device, group):
    """The port Simulator ("single") or MultiTopicSimulator ("multi") on
    `group`'s rows: what each rank of a handle holds, and what a process
    of a multi-host run builds over its torch.distributed world."""
    with peer.using(group):
        if kind == "single":
            return Simulator(cfg, topology=topology, device=device)
        return MultiTopicSimulator(cfg, topology=topology, device=device)


def _reply(grp, sim, **extra) -> dict:
    """A rank's answer to a handle call: its clock, its collectives and,
    on a card, its peak allocated bytes since the handle was built."""
    out = {"t_ms": float(sim.state.t_ms), "stats": dict(grp.stats),
           "peak_bytes": (torch.cuda.max_memory_allocated(grp.device)
                          if grp.device.type == "cuda" else None)}
    out.update(extra)
    return out


def _op_create(sim_id, device, kind, cfg, topology, n_rows):
    import torch.distributed as dist

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    grp = peer.PeerGroup(dist.get_rank(), dist.get_world_size(), n_rows,
                         device)
    sim = rank_simulator(kind, cfg, topology, device, grp)
    _RANK_SIMS[sim_id] = (grp, sim)
    return _reply(grp, sim, rows=(grp.r0, grp.r1), backend=grp.backend,
                  seconds=time.perf_counter() - t0)


def _op_advance(sim_id, device, ms, carry_ms):
    grp, sim = _RANK_SIMS[sim_id]
    sim._hb_carry_ms = carry_ms             # the handle's heartbeat carry
    with peer.using(grp):
        sim.advance(ms)
    return _reply(grp, sim)


def _op_publish(sim_id, device, row, t0_ms, size, with_fanout, censor):
    grp, sim = _RANK_SIMS[sim_id]
    before = dict(dsm.engine_counts)
    with peer.using(grp):
        if isinstance(sim, MultiTopicSimulator):
            res = sim._disseminate(row, t0_ms, size, with_fanout)
        else:
            cens = (None if censor is None
                    else torch.as_tensor(censor, device=sim.device))
            res = sim._disseminate(row, t0_ms, size, with_fanout, cens)
    fields = {k: getattr(res, k).detach().cpu().numpy()
              for k in _RESULT_ROWS + _RESULT_SCALARS}
    engine = {k: dsm.engine_counts[k] - before[k] for k in before}
    return _reply(grp, sim, result=fields, engine=engine)


def _op_set_subscribed(sim_id, device, mask):
    grp, sim = _RANK_SIMS[sim_id]
    with peer.using(grp):
        sim._apply_subscribed(mask)          # the handle keeps the counters
    return _reply(grp, sim)


def _op_rebind_graph(sim_id, device, conns, rev, out_mask):
    grp, sim = _RANK_SIMS[sim_id]
    with peer.using(grp):
        sim.rebind_graph(conns, rev, out_mask)
    return _reply(grp, sim)


def _op_reset(sim_id, device):
    grp, sim = _RANK_SIMS[sim_id]
    with peer.using(grp):
        sim.reset()
    return _reply(grp, sim)


def _op_get_state(sim_id, device):
    grp, sim = _RANK_SIMS[sim_id]
    return _reply(grp, sim, leaves=interop.state_to_numpy(sim.state))


def _op_set_state(sim_id, device, leaves):
    grp, sim = _RANK_SIMS[sim_id]
    sim.state = interop.state_from_numpy(leaves, sim.device)
    if isinstance(sim, Simulator):
        if sim._valid_edge is not None:
            with peer.using(grp):
                sim._valid_edge = sim._compute_valid_edge()
    return _reply(grp, sim)


def _op_drop(sim_id, device):
    _RANK_SIMS.pop(sim_id, None)
    return {}


_OPS = {"create": _op_create, "advance": _op_advance,
        "publish": _op_publish, "set_subscribed": _op_set_subscribed,
        "rebind_graph": _op_rebind_graph, "reset": _op_reset,
        "get_state": _op_get_state, "set_state": _op_set_state,
        "drop": _op_drop}


def _rank_job(payload, device):
    """One call of a handle on one rank (a RankPool job)."""
    op, sim_id, args = payload
    return _OPS[op](sim_id, device, *args)


# ------------------------------------------------------------ the handle


class _MeshHandle:
    """What both handles share: the ranks, their calls and the state."""

    def _start(self, mesh, kind: str, n_rows: int) -> None:
        self.mesh = check_peer_mesh(mesh)
        if n_rows % mesh.size != 0:
            raise ValueError(
                f"peer rows {n_rows} must divide evenly over {mesh.size} "
                "devices")
        # the ranks' devices are the mesh's; gathered copies are host
        self.device = torch.device("cpu")
        self._id = f"{os.getpid()}-{next(_IDS)}"
        self._stats = [{} for _ in range(mesh.size)]
        outs = self._call("create", [(kind, self.cfg, self.topology,
                                      n_rows)] * mesh.size)
        self.rank_rows = [o["rows"] for o in outs]
        self.rank_build_s = [o["seconds"] for o in outs]
        self.backend = outs[0]["backend"]

    def _call(self, op: str, args: list) -> list:
        outs = self.mesh.pool.run(_rank_job, [(op, self._id, tuple(a))
                                              for a in args])
        if outs and "t_ms" in outs[0]:
            self._t_ms = outs[0]["t_ms"]
            self._stats = [o["stats"] for o in outs]
            self.rank_peak_bytes = [o["peak_bytes"] for o in outs]
        return outs

    def _all(self, op: str, *args) -> list:
        return self._call(op, [args] * self.mesh.size)

    def _t_now(self) -> float:
        return self._t_ms

    def advance(self, ms: float) -> None:
        """The heartbeats due in `ms` on every rank, from the handle's
        carry (a restored run's carry lives in the handle)."""
        from .simulator import drain_heartbeat_carry

        carry = self._hb_carry_ms
        _, self._hb_carry_ms = drain_heartbeat_carry(
            carry, ms, self.params.heartbeat_ms)
        self._all("advance", ms, carry)

    def collectives(self) -> list:
        """Each rank's collectives since it built its rows: all-gathers
        and the bytes of the (N, ...) tensors they assembled,
        all-reduces and broadcasts."""
        return [dict(s) for s in self._stats]

    @property
    def state(self):
        """A read-only copy of the whole state on the host, gathered from
        the ranks' rows."""
        outs = self._all("get_state")
        leaves = {}
        for k in outs[0]["leaves"]:
            parts = [o["leaves"][k] for o in outs]
            leaves[k] = (parts[0] if k in _REPLICATED
                         else np.concatenate(parts, axis=0))
        return interop.state_from_numpy(leaves, self.device)

    @state.setter
    def state(self, value) -> None:
        """Scatter a whole state (one device's layout) to the ranks."""
        per_rank = shard_simulation(value, {}, {}, self.mesh)
        self._call("set_state", [(interop.state_to_numpy(st),)
                                 for st, _, _ in per_rank])

    def _disseminate(self, row: int, t0_ms: float, size: int,
                     with_fanout: bool, censor_edge=None):
        """One publish from (virtual-peer) row `row` on every rank; the
        whole result, assembled."""
        cens = ([None] * self.mesh.size if censor_edge is None
                else reshard_rows(
                    np.asarray(torch.as_tensor(censor_edge).cpu()),
                    self.mesh))
        outs = self._call("publish", [(row, t0_ms, size, with_fanout,
                                       cens[r])
                                      for r in range(self.mesh.size)])
        for k, v in outs[0]["engine"].items():
            dsm.engine_counts[k] += v
        res = [o["result"] for o in outs]
        fields = {k: torch.from_numpy(np.concatenate([r[k] for r in res]))
                  for k in _RESULT_ROWS}
        for k in _RESULT_SCALARS:
            vals = [r[k] for r in res]
            if any(not np.array_equal(v, vals[0]) for v in vals[1:]):
                raise RuntimeError(
                    f"the ranks disagree on the publish's {k}: {vals}")
            fields[k] = torch.from_numpy(np.asarray(vals[0]))
        return dsm.DisseminationResult(**fields)

    def close(self) -> None:
        """Drop this handle's rows on the ranks (the mesh's pool stays)."""
        if self.mesh.pool._procs is not None:
            self._all("drop")


class ShardedSimulator(_MeshHandle, Simulator):
    """Simulator(cfg, mesh=) on a peer mesh (module doc)."""

    def __init__(self, cfg, topology=None, device=None, mesh=None):
        self._configure(cfg, topology)
        if self.mix_params is not None:
            raise peer_mesh_later("the mix relay under a peer mesh")
        self._valid_edge = None
        self._t_ms = 0.0
        self._arrays_np = {"conns": self.graph.conns, "rev": self.graph.rev,
                           "out_mask": self.graph.out_mask}
        self._start(mesh, "single", self.params.n)

    @property
    def arrays(self) -> dict:
        """The bound connection graph (host tensors)."""
        return {k: torch.as_tensor(v) for k, v in self._arrays_np.items()}

    def record_telemetry(self, params=None) -> None:
        if params is not None and params.enabled:
            raise peer_mesh_later("the flight recorder under a peer mesh")
        self._telemetry = None

    def _apply_subscribed(self, mask: np.ndarray) -> None:
        self._all("set_subscribed", mask)

    def rebind_graph(self, conns, rev, out_mask) -> None:
        self._arrays_np = {
            k: np.asarray(torch.as_tensor(v).cpu())
            for k, v in (("conns", conns), ("rev", rev),
                         ("out_mask", out_mask))}
        self._all("rebind_graph", self._arrays_np["conns"],
                  self._arrays_np["rev"], self._arrays_np["out_mask"])

    def reset(self) -> None:
        self._all("reset")
        self._reset_host()


class ShardedMultiTopicSimulator(_MeshHandle, MultiTopicSimulator):
    """MultiTopicSimulator(cfg, mesh=) on a peer mesh (module doc)."""

    def __init__(self, cfg, topology=None, device=None, mesh=None):
        cfg.validate()
        self._configure(cfg, topology)
        self._t_ms = 0.0
        self._start(mesh, "multi", self.params.n)

    def reset(self) -> None:
        self._all("reset")
        self._hb_carry_ms = 0.0
        self.records = []
        self._msg_rng = np.random.default_rng(self.cfg.seed ^ 0x6D736749)

