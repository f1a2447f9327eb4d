"""The protocol registry: the arena's dispatch table (the reference's
ops/protocol.py).

A ProtocolSpec names one pub/sub backend and holds its window runners.
GossipSub's fields ARE the port's module-level runner objects (ops/
heartbeat.py, ops/adversary.py, ops/faults.py, ops/disseminate.py), not
wrappers, so a call through the registry is the direct call
(tests/port/test_torch_protocol.py holds the `is` identity). Episub
(ops/episub.py) is registered lazily, with its controller carry
(`init_ctrl`), its static params (`protocol_params`) and the two
observables its windows add.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from .adversary import run_adaptive_heartbeats, run_attacked_heartbeats
from .disseminate import run_fused_rounds
from .faults import run_faulted_heartbeats
from .heartbeat import run_heartbeats


@dataclass(frozen=True)
class ProtocolSpec:
    """Frozen descriptor of one pub/sub protocol backend.

    The runner fields hold the module-level window runners; a protocol
    with its own carry (episub) takes it as the argument after the state
    and sets `init_ctrl` / `protocol_params`. `observables` names the
    per-round channels its attacked and adaptive windows add to the
    shared attack observables; `repair_hook` and `gossip_emission` say in
    words how the backend repairs and gossips."""

    name: str
    run_heartbeats: Callable
    run_attacked_heartbeats: Callable
    run_adaptive_heartbeats: Callable
    run_faulted_heartbeats: Callable
    # the round-chain runner; None = the protocol has none
    run_fused_rounds: Callable | None = None
    # a fresh per-protocol carry for one trial window; None = the protocol
    # keeps everything in SimState (GossipSub)
    init_ctrl: Callable | None = None
    # the protocol's static params class; None = SimParams alone
    protocol_params: Callable | None = None
    repair_hook: str = ""
    gossip_emission: str = ""
    observables: tuple[str, ...] = field(default=())

    def validate(self) -> None:
        if not self.name:
            raise ValueError("ProtocolSpec needs a name")
        for f in ("run_heartbeats", "run_attacked_heartbeats",
                  "run_adaptive_heartbeats", "run_faulted_heartbeats"):
            if not callable(getattr(self, f)):
                raise ValueError(f"ProtocolSpec.{f} must be callable")


_PROTOCOLS: dict[str, ProtocolSpec] = {}


def register_protocol(spec: ProtocolSpec) -> ProtocolSpec:
    spec.validate()
    if spec.name in _PROTOCOLS:
        raise ValueError(f"protocol {spec.name!r} already registered")
    _PROTOCOLS[spec.name] = spec
    return spec


def get_protocol(name: str) -> ProtocolSpec:
    _ensure_builtin()
    try:
        return _PROTOCOLS[name]
    except KeyError:
        raise KeyError(
            f"unknown protocol {name!r}; registered: "
            f"{sorted(_PROTOCOLS)}") from None


def protocol_names() -> list[str]:
    _ensure_builtin()
    return sorted(_PROTOCOLS)


_BUILTIN_DONE = False


def _ensure_builtin() -> None:
    # episub registers lazily: it imports the adversary and fault modules
    global _BUILTIN_DONE
    if _BUILTIN_DONE:
        return
    _BUILTIN_DONE = True
    register_protocol(ProtocolSpec(
        name="gossipsub",
        run_heartbeats=run_heartbeats,
        run_attacked_heartbeats=run_attacked_heartbeats,
        run_adaptive_heartbeats=run_adaptive_heartbeats,
        run_faulted_heartbeats=run_faulted_heartbeats,
        run_fused_rounds=run_fused_rounds,
        init_ctrl=None,
        protocol_params=None,
        repair_hook="IHAVE/IWANT gossip + mesh repair (ops/repair.py)",
        gossip_emission="gossip_factor sample of non-mesh peers, "
                        "d_lazy floor (ops/disseminate.py)",
        observables=(),
    ))

    from .episub import (EpisubParams, init_episub_ctrl,
                         run_episub_adaptive_heartbeats,
                         run_episub_attacked_heartbeats,
                         run_episub_faulted_heartbeats,
                         run_episub_heartbeats)

    register_protocol(ProtocolSpec(
        name="episub",
        run_heartbeats=run_episub_heartbeats,
        run_attacked_heartbeats=run_episub_attacked_heartbeats,
        run_adaptive_heartbeats=run_episub_adaptive_heartbeats,
        run_faulted_heartbeats=run_episub_faulted_heartbeats,
        run_fused_rounds=None,
        init_ctrl=init_episub_ctrl,
        protocol_params=EpisubParams,
        repair_hook="lazy IHAVE along non-tree edges + re-parenting "
                    "(ops/episub.py)",
        gossip_emission="d_lazy lowest-slot non-tree edges per round",
        observables=("tree_reach_frac", "tree_depth_mean"),
    ))
