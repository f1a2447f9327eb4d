"""One run of a cell: set-up, the measured window, the traced slice.

The window drives the port's Simulator as a user's experiment does:
cycles of `advance(k x heartbeat)` then `publish(p)`, the publisher
moving on by one peer each message. Cycles come in episodes of the
traffic's `messages_per_episode`, each replayed from the state s0 that
the warm-up left: the Simulator's calls return new state and leave their
input alone, so putting s0 back repeats the same work, and the window
measures the same network on every commit however fast it runs (churn
would otherwise thin it as the window goes on).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

# state leaves the check compares, moved to the host once the window has
# closed
STATE_LEAVES = ("mesh_mask", "backoff_until", "fmd", "alive", "subscribed",
                "hb_phase", "uplink_free_ms", "rx_free_ms", "t_ms", "key")


def experiment_config(config: dict, seed: int):
    """The port's ExperimentConfig of a configuration file, seeded."""
    from dst_libp2p_test_node_tpu_torch.config.env import GossipSubParams
    from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
    from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
        ExperimentConfig)

    e = dict(config["experiment"])
    topo = TopoParams(**e.pop("topo"))
    gossipsub = GossipSubParams(**e.pop("gossipsub"))
    return ExperimentConfig(topo=topo, gossipsub=gossipsub, seed=int(seed),
                            **e)


def host_state(state) -> dict:
    return {k: getattr(state, k).detach().cpu().numpy().copy()
            for k in STATE_LEAVES}


@dataclass
class Outputs:
    """What the timed path produced, on the host, for the check."""

    graph: tuple                      # (conns, rev, out_mask)
    s0: dict                          # the state every episode starts from
    final: dict                       # the state when the window closed
    final_cycle: int                  # its cycle's index in the episode
    messages: list = field(default_factory=list)
    # (index in the episode, delays_ms, received, converged)


@dataclass
class Run:
    setup_s: float = 0.0
    build_s: float = 0.0
    window_s: float = 0.0
    cycles: int = 0
    heartbeats: int = 0
    advance_walls: list = field(default_factory=list)   # s per advance
    publish_walls: list = field(default_factory=list)   # s per publish
    slice: dict | None = None         # the traced slice (trace.digest)
    outputs: Outputs | None = None
    n: int = 0
    capacity: int = 0


class Driver:
    """The cell's Simulator and its traffic."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
            Simulator)

        self.cfg = experiment_config(config, seed)
        self.k = int(traffic["heartbeats_per_message"])
        self.m = int(traffic["messages_per_episode"])
        self.rotate = bool(traffic["publisher_rotation"])
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.sim = Simulator(self.cfg, device=device)
        self._sync()
        self.build_s = time.perf_counter() - t0
        self.hb_ms = self.sim.params.heartbeat_ms
        self.n = self.cfg.topo.network_size

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def publisher(self, i: int) -> int:
        p = self.cfg.publisher_id + (i if self.rotate else 0)
        return p % self.n

    def cycle(self, i: int, walls: Run | None = None, spans=False):
        """Cycle i of an episode: k heartbeats, then message i. With
        `walls`, each call's host wall lands in it, each ending in a
        synchronize (a publish returns once its delays are on the host,
        while its state write-back may still run on the device)."""
        from torch.profiler import record_function

        sim = self.sim
        t0 = time.perf_counter()
        if spans:
            with record_function("gpubench.advance"):
                sim.advance(self.k * self.hb_ms)
        else:
            sim.advance(self.k * self.hb_ms)
        if walls is not None:
            self._sync()
            t1 = time.perf_counter()
            walls.advance_walls.append(t1 - t0)
            t0 = t1
        if spans:
            with record_function("gpubench.publish"):
                sim.publish(self.publisher(i))
        else:
            sim.publish(self.publisher(i))
        if walls is not None:
            self._sync()
            walls.publish_walls.append(time.perf_counter() - t0)

    def restore(self, s0) -> list:
        """Put s0 back and hand over the episode's records."""
        recs, self.sim.records = self.sim.records, []
        self.sim.state = s0
        return recs


def _keep(out: Outputs, recs):
    for j, r in enumerate(recs):
        out.messages.append((j, r.delays_ms, r.received,
                             bool(r.converged)))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Run:
    """Set-up, the window of `seconds`, and with `trace` the host walls
    and a profiled slice; `t_start` is the process's start on the
    perf_counter clock."""
    from . import trace as tr

    run = Run()
    drv = Driver(cell.config, cell.traffic, seed, device)
    sim = drv.sim
    run.build_s = drv.build_s
    run.n, run.capacity = drv.n, sim.params.capacity
    sim.warmup()
    s0 = sim.state
    # one cycle from s0 builds and warms every kernel and shape the window
    # uses; then s0 goes back
    drv.cycle(0)
    drv.restore(s0)
    drv._sync()
    run.setup_s = time.perf_counter() - t_start

    out = Outputs(graph=(sim.graph.conns, sim.graph.rev, sim.graph.out_mask),
                  s0={}, final={}, final_cycle=0)
    walls = run if trace else None
    t0 = time.perf_counter()
    i = 0
    while True:
        drv.cycle(i, walls)
        run.cycles += 1
        i += 1
        done = time.perf_counter() - t0 >= seconds
        if done or i == drv.m:
            if done:
                drv._sync()
                run.window_s = time.perf_counter() - t0
                break
            _keep(out, drv.restore(s0))
            i = 0
    run.heartbeats = run.cycles * drv.k
    out.final_cycle = i - 1
    out.final = host_state(sim.state)
    _keep(out, drv.restore(s0))
    if trace:
        from torch.profiler import ProfilerActivity, profile

        cycles = min(int(cell.traffic["profiled_cycles"]), drv.m)
        acts = [ProfilerActivity.CPU]
        if drv.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        drv._sync()
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            for j in range(cycles):
                drv.cycle(j, spans=True)
            drv._sync()
            wall = time.perf_counter() - t1
        run.slice = tr.digest(prof, wall, cycles, cycles * drv.k)
        _keep(out, drv.restore(s0))
    out.s0 = host_state(s0)
    run.outputs = out
    return run
