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

  warmup / advance    the heartbeats on every rank (with the flight
                      recorder armed by record_telemetry, every rank
                      records; the channels are counted and summed over
                      every peer, so `last_telemetry` comes back in the
                      one-device layout)
  publish             one disseminate on every rank (mesh= its group: the
                      receiver-side fixpoints through converge_sharded,
                      the serial engine); the handle row-concatenates the
                      ranks' result rows and builds the record as one
                      device does, so records, latencies and summaries
                      come out in the one-device layout
  publish (mix)       with cfg.uses_mix, the mix relay first, on every rank
                      (ops/mix.py on its rows: the path from the mix
                      nodes' prefix rows, the chain replicated, each
                      owner writing its rows), then the exit's publish
  publish_batch       a loop of publish, as the reference's mesh path
  set_subscribed, rebind_graph, reset
                      host bookkeeping in the handle, the leaves on ranks
  state               a gathered read-only copy (host tensors): metrics,
                      checkpoint saves; assigning it scatters the rows
                      (load_checkpoint(mesh=))
  attacked_trials     a campaign's attacked trials (runtime/campaign.py's
                      per-trial path) on the ranks' own Simulators, one
                      after another: run_campaign(mesh=)

Launches: each rank counts
its kernel launches per call and sends the counts back over its pipe
(RankPool.launches); `collectives()` has each rank's all-gathers,
all-reduces and broadcasts and their bytes (parallel/peer.py); `rank_peak_bytes` each rank's peak allocated device memory
since the handle was built (None on the CPU).
"""

from __future__ import annotations

import concurrent.futures
import itertools
import os
import time

import numpy as np
import torch

from .. import interop
from ..config.topology import Topology
from ..ops import disseminate as dsm
from ..ops.state import REPLICATED_LEAVES
from ..parallel import peer
from ..parallel.sharding import (
    check_peer_mesh,
    reshard_rows,
    shard_simulation,
)
from .multitopic import MultiTopicSimulator
from .simulator import Simulator

_RESULT_ROWS = dsm.RESULT_ROWS
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
    return _reply(grp, sim, telemetry=getattr(sim, "last_telemetry", None))


def _op_record_telemetry(sim_id, device, params):
    grp, sim = _RANK_SIMS[sim_id]
    sim.record_telemetry(params)
    return _reply(grp, sim)


def _op_trials(sim_id, device, cfg, fraction, seeds, cache, budget):
    from .campaign import _attacked_trials

    grp, sim = _RANK_SIMS[sim_id]
    walls: list = []
    with peer.using(grp):
        trials = _attacked_trials(sim, cfg, fraction, seeds, dict(cache),
                                  budget, walls)
    return _reply(grp, sim, trials=trials, walls=walls)


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


def _op_mix_relay(sim_id, device, origin, size, t0_ms):
    """The mix relay on this rank's rows: (path delay, exit node), or the
    degraded network's message (the handle raises MixDegradedError)."""
    from .simulator import MixDegradedError

    grp, sim = _RANK_SIMS[sim_id]
    with peer.using(grp):
        try:
            delay, exit_node = sim._mix_relay(origin, size, t0_ms)
        except MixDegradedError as e:
            return _reply(grp, sim, degraded=str(e))
    return _reply(grp, sim, degraded=None, relay=(delay, exit_node))


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


def _op_reset(sim_id, device, seed):
    grp, sim = _RANK_SIMS[sim_id]
    # the seed the handle resets to (a campaign's trial seed)
    base, sim.cfg.seed = sim.cfg.seed, seed
    try:
        with peer.using(grp):
            sim.reset()
    finally:
        sim.cfg.seed = base
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
        "record_telemetry": _op_record_telemetry, "trials": _op_trials,
        "publish": _op_publish, "mix_relay": _op_mix_relay,
        "set_subscribed": _op_set_subscribed,
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

    def _start(self, mesh, kind: str, n_rows: int, cfg=None,
               topology=None) -> None:
        """Have every rank build its rows of the experiment (`cfg` and
        `topology`, the handle's own by default)."""
        self.mesh = check_peer_mesh(mesh)
        if n_rows % mesh.size != 0:
            raise ValueError(
                f"peer rows {n_rows} must divide evenly over {mesh.size} "
                "devices")
        # the ranks' devices are the mesh's; gathered copies are host
        self.device = torch.device("cpu")
        self._id = f"{os.getpid()}-{next(_IDS)}"
        self._stats = [{} for _ in range(mesh.size)]
        cfg = self.cfg if cfg is None else cfg
        topology = self.topology if topology is None else topology
        outs = self._call("create", [(kind, cfg, topology, n_rows)]
                          * mesh.size)
        self.rank_rows = [o["rows"] for o in outs]
        self.rank_build_s = [o["seconds"] for o in outs]
        self.backend = outs[0]["backend"]

    def _call(self, op: str, args: list,
              deadline_s: float | None = None) -> list:
        outs = self.mesh.pool.run(_rank_job, [(op, self._id, tuple(a))
                                              for a in args],
                                  deadline_s=deadline_s)
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
        tel = self._all("advance", ms, carry)[0]["telemetry"]
        if tel is not None:
            self.last_telemetry = tel

    def attacked_trials(self, cfg, fraction: float, seeds: list,
                        cache: dict, budget: float,
                        deadline_s: float | None = None):
        """An attacked campaign cell (runtime/campaign.py) on the ranks,
        each on its rows of every trial, one trial after another:
        (TrialResults, phase walls) as one device gives them. `cache`: the
        seeds' benign baselines. The ranks' Simulators end on the last
        trial's state; the next reset rewinds them."""
        outs = self._call("trials", [(cfg, fraction, list(seeds), cache,
                                      budget)] * self.mesh.size,
                          deadline_s=deadline_s)
        return outs[0]["trials"], outs[0]["walls"]

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
            leaves[k] = (parts[0] if k in REPLICATED_LEAVES
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
        cfg.topo.validate()
        topology = topology or Topology.build(cfg.topo)
        # the ranks build their rows while the handle builds its host side
        # (each builds the same connection graph: at 1M peers a numpy build
        # of 12-19 s, paid once in parallel rather than twice in a row)
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            ranks = ex.submit(self._start, mesh, "single",
                              cfg.topo.network_size, cfg, topology)
            self._configure(cfg, topology)
            ranks.result()
        self._valid_edge = None
        self._t_ms = 0.0
        self._arrays_np = {"conns": self.graph.conns, "rev": self.graph.rev,
                           "out_mask": self.graph.out_mask}

    @property
    def arrays(self) -> dict:
        """The bound connection graph (host tensors)."""
        return {k: torch.as_tensor(v) for k, v in self._arrays_np.items()}

    def record_telemetry(self, params=None) -> None:
        """Arm (or disarm) the flight recorder on every rank
        (Simulator.record_telemetry)."""
        Simulator.record_telemetry(self, params)
        self._all("record_telemetry", self._telemetry)

    def _apply_subscribed(self, mask: np.ndarray) -> None:
        self._all("set_subscribed", mask)

    def _mix_relay(self, origin: int, size: int, t0_ms: float):
        """The mix relay on every rank (ops/mix.py on the ranks' rows):
        (path delay, exit node), as one device gives them."""
        from .simulator import MixDegradedError

        outs = self._all("mix_relay", origin, size, t0_ms)
        if outs[0]["degraded"] is not None:
            raise MixDegradedError(outs[0]["degraded"])
        relays = [o["relay"] for o in outs]
        if any(r != relays[0] for r in relays[1:]):
            raise RuntimeError(
                f"the ranks disagree on the mix relay: {relays}")
        return relays[0]

    def rebind_graph(self, conns, rev, out_mask) -> None:
        self._arrays_np = {
            k: np.asarray(torch.as_tensor(v).cpu())
            for k, v in (("conns", conns), ("rev", rev),
                         ("out_mask", out_mask))}
        self._all("rebind_graph", self._arrays_np["conns"],
                  self._arrays_np["rev"], self._arrays_np["out_mask"])

    def reset(self) -> None:
        self._all("reset", self.cfg.seed)
        self._reset_host()


class ShardedMultiTopicSimulator(_MeshHandle, MultiTopicSimulator):
    """MultiTopicSimulator(cfg, mesh=) on a peer mesh (module doc)."""

    def __init__(self, cfg, topology=None, device=None, mesh=None):
        cfg.validate()
        self._configure(cfg, topology)
        self._t_ms = 0.0
        self._start(mesh, "multi", self.params.n)

    def reset(self) -> None:
        self._all("reset", self.cfg.seed)
        self._hb_carry_ms = 0.0
        self.records = []
        self._msg_rng = np.random.default_rng(self.cfg.seed ^ 0x6D736749)

