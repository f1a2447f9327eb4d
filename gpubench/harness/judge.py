"""The comparison that decides `correct`.

The reference (gpubench/reference/) re-derives the experiment from the
seed on its own: the topology, the graph, the warm-up, and one episode of
the traffic's cycles. Each number below compares what the timed path
produced with it and has a limit of its own, in the configuration file's
"limits" (PERF.md gives the readings each limit was set from):

  graph_mismatch     entries of conns / rev / out_mask that differ
  state_mismatch     entries of the compared state leaves (mesh, backoff,
                     first-delivery counters, liveness, uplink and
                     downlink drain, clock, PRNG key) that differ, at s0
                     and when the window closed
  received_mismatch  (message, peer) pairs received on one side only,
                     over every message of the window
  delay_gap_ms       the widest gap between a peer's delay and the
                     reference's, over every message of the window
  unconverged        messages whose fixpoints did not all converge
  mix_mismatch       messages whose exit node or mix path delay differs
                     (configurations with a mix network)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..reference import model as ref_model


@dataclasses.dataclass
class ReferenceRun:
    graph: tuple
    s0: dict
    final: dict | None
    messages: list               # one Message per cycle of the episode


def _host(st: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in st.items()}


def publisher(config: dict, traffic: dict, i: int) -> int:
    e = config["experiment"]
    n = config["model"]["n"]
    return (e["publisher_id"] + (i if traffic["publisher_rotation"] else 0)) \
        % n


def reference_run(config: dict, traffic: dict, seed: int, device,
                  final_cycle: int | None = None, model=None,
                  sweep_cap: int = 4000) -> ReferenceRun:
    """The seeded experiment through one episode. `model` replaces the
    configuration's (the control changes one guarantee)."""
    m = model or ref_model.Model.from_config(config)
    ex = ref_model.Experiment(m, seed, device, sweep_cap=sweep_cap)
    ex.warmup(config["experiment"]["warmup_s"])
    s0 = _host(ex.st)
    k = int(traffic["heartbeats_per_message"])
    msgs, final = [], None
    for i in range(int(traffic["messages_per_episode"])):
        ex.advance(k * m.heartbeat_ms)
        msgs.append(ex.publish(publisher(config, traffic, i)))
        if i == final_cycle:
            final = _host(ex.st)
    return ReferenceRun(ex.graph_np, s0, final, msgs)


def _mismatch(a: dict, b: dict) -> int:
    bad = 0
    for k, v in b.items():
        x = np.asarray(a[k])
        bad += (int(np.asarray(v).size) if x.shape != np.shape(v)
                else int(np.count_nonzero(x != v)))
    return bad


def message_numbers(msg, want, with_mix: bool) -> dict:
    """One message of the window against the reference's message of the
    same index in the episode."""
    _, delays, received, converged = msg
    both = received & want.received
    nums = {
        "received_mismatch": int(np.count_nonzero(received
                                                  != want.received)),
        "delay_gap_ms": float(np.max(np.abs(delays[both]
                                            - want.delays_ms[both])))
        if both.any() else 0.0,
        "unconverged": int(not converged),
    }
    if with_mix:
        exit_node = int(np.argmin(np.where(received, delays, np.inf)))
        nums["mix_mismatch"] = int(exit_node != want.mix_exit
                                   or delays[exit_node] != want.mix_delay_ms)
    return nums


def compare(out, ref: ReferenceRun, with_mix: bool) -> tuple:
    """(the numbers of `out` (window.Outputs) against the reference, and
    the per-message numbers of each message)."""
    per_msg = [message_numbers(msg, ref.messages[msg[0]], with_mix)
               for msg in out.messages]
    nums = {
        "graph_mismatch": _mismatch(dict(enumerate(out.graph)),
                                    dict(enumerate(ref.graph))),
        "state_mismatch": _mismatch(out.s0, ref.s0)
        + (_mismatch(out.final, ref.final) if ref.final is not None else 0),
    }
    for k in per_msg[0] if per_msg else ():
        agg = max if k == "delay_gap_ms" else sum
        nums[k] = agg(x[k] for x in per_msg)
    return nums, per_msg


def verdict(nums: dict, limits: dict) -> bool:
    return all(k in nums and nums[k] <= limits[k] for k in limits) \
        and all(k in limits for k in nums)


def report(nums: dict, limits: dict) -> list:
    """[[name, number, limit], ...] in a fixed order."""
    return [[k, nums.get(k), limits.get(k)] for k in sorted(set(nums)
                                                            | set(limits))]


def check(cell, out, seed: int, device) -> tuple:
    """(correct, failed messages, [[name, number, limit], ...]): the
    reference run (once the program's state is freed), then the
    comparison of `out` (window.Outputs) with it."""
    ref = reference_run(cell.config, cell.traffic, seed, device,
                        final_cycle=out.final_cycle)
    limits = cell.config["limits"]
    nums, per_msg = compare(out, ref, with_mix="mix_mismatch" in limits)
    failed = sum(any(x[k] > limits[k] for k in x) for x in per_msg)
    return verdict(nums, limits), failed, report(nums, limits)
