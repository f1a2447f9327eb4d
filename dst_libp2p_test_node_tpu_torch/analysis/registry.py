"""The port's hot entry-point contract registry.

The reference's single-device contracts (dst_libp2p_test_node_tpu/
analysis/registry.py), under their names, each spec built with the same
shapes from the same seeds as the reference's spec function, through the
port's own copies of the graph, topology and state constructors: the canonical
N=32 single topic (connect_to 4), the T=2 x N=16 multitopic stack. Every
contract is built for one device, the card unless the caller asks for the
CPU (`default_contracts(device)`); its spec runs there (eager torch has no
abstract trace), and two builds of one contract give equal inputs.

  disseminate/cold        exact publish (the serialized-answer repair)
  disseminate/warm        warm-started exact publish
  disseminate/exact_serial
                          the serial refiner forced (answer_queue_mode)
  disseminate/bounded     bounded-accounting publish
  publisher/batch_scan    the batched dispatch: one publish per active
                          column from one t0, the state carried
                          (runtime/publisher.publish_batch_scan)
  heartbeat_step          one mesh-maintenance round
  run_heartbeats          the simulator's heartbeat loop (score_update at
                          its end)
  run_attacked_heartbeats the campaign attack window
  adversary/adaptive_window
                          the adaptive attacker's window, repair leaves live
  heartbeat_step/evict    the mesh-repair heartbeat (evict + px armed)
  repair/recovery_window  the recovery window, the graph in the carry
  faults/churn_window     crash + partition + spike over an attacked mesh
  telemetry/recorded_heartbeats, telemetry/recorded_attack_window
                          the flight recorder armed
  heartbeat/fused_round   the round chain (heartbeat burst + exact publish)
  native/score_update     the fused scoring-update kernel (csrc/
                          score_update.cu on the card, its plain version on
                          the CPU)
  kad/find_node           the DHT lookup
  multitopic/disseminate  the T*N block-diagonal publish
  conformance/differential_round
                          heartbeat_step -> adversary_round, the round the
                          conformance gate walks
  episub/heartbeat_step   one episub tree round, thresholds armed

The reference's six mesh contracts run the port's nested windows
(runtime/campaign.py) on rank pools the caller passes
(`default_contracts(device, grid=, pool=)`; without a grid, the list is the
20 above): `grid` a 2 x 2 RankPool (two trial groups of two ranks), `pool`
a 2-rank one for the legacy layout (two groups of one rank, or a
PeerMesh, whose pool it is; the grid's groups' first ranks without it).
Each spec is the reference's spec function's, from the same seeds at the
same shapes (N=32, connect_to 4, 4 stacked trials, 3 steps, 2 local
trials); the port keeps the repair leaves the reference strips, since its
windows take them along whether armed or not.

  campaign/faulted_window_nested
                          crash + partition + spike cohorts on the grid
  campaign/attack_window_sharded
                          the legacy trial-only layout (nested=False) on
                          `pool`: each trial whole on one rank
  campaign/attack_window_nested
                          the nested attack window on the grid
  campaign/attack_window_dcn
                          the grid as dcn 2 x trials 1 x peers 2: blocks
                          of 2 ranks, so the peer collectives exist and
                          GA-S006 checks them against the blocks
  campaign/dht_attack_window
                          the DHT-armed recovery window (repair live)
  protocol/arena_window   the adaptive episub window

`attack_rung_spec(n)` and `arena_rung_spec(n)` are the rung predictor's
programs (analysis/sharding_audit.predict_rung_certificate) at any peer
count, on the grid they are given.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device
from .contracts import COLLECTIVE_KINDS, EntrypointContract, TraceSpec


def _clone(tree):
    """A copy of a dataclass of tensors (every spec gets its own state)."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).clone()
        for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


@functools.lru_cache(maxsize=None)
def _topic_world(n: int, connect_to: int, device: str, over: tuple):
    from ..config.topology import Topology, TopoParams
    from ..ops.graph import build_connection_graph
    from ..ops.state import SimParams, graph_arrays, init_state

    g = build_connection_graph(n, connect_to, seed=0)
    params = SimParams(n=n, capacity=g.capacity, **dict(over))
    state = init_state(params, seed=0, device=device)
    a = graph_arrays(g, device)
    t = Topology.build(TopoParams(
        network_size=n, anchor_stages=5, min_bandwidth=50, max_bandwidth=150,
        min_latency=40, max_latency=130))
    topo = tuple(torch.as_tensor(x, device=device) for x in (
        t.stage_of_peer, t.latency_ms, t.bw_up_mbit))
    return g, params, state, a, topo


def _single_topic(device, n: int = 32, connect_to: int = 4, **over):
    """(graph, params, state, arrays, (stage, lat, bw)): the reference's
    canonical config on `device`, with fresh copies of the state and the
    graph arrays."""
    g, params, state, a, topo = _topic_world(
        n, connect_to, str(device), tuple(sorted(over.items())))
    return (g, params, _clone(state), {k: v.clone() for k, v in a.items()},
            topo)


# the armed-defense overrides every repair entry point runs under (the
# reference's _ARMED / _REPAIR)
_ARMED = dict(slow_weight=-10.0, slow_decay=0.9, gossip_threshold=-10.0,
              publish_threshold=-20.0, graylist_threshold=-50.0)
_REPAIR = dict(evict=True, px=True, redial=True, **_ARMED)


def _cohort(n, device, fraction=0.25, seed=1):
    from ..ops.adversary import attacker_cohort

    return torch.as_tensor(attacker_cohort(n, fraction, seed=seed),
                           device=device)


def _disseminate_spec(device, **params_over) -> TraceSpec:
    from ..ops.disseminate import disseminate

    g, params, state, a, (stage, lat, bw) = _single_topic(device,
                                                          **params_over)
    return TraceSpec(
        fn=disseminate,
        args=(state, a["conns"], a["rev"], stage, lat, bw),
        kwargs=dict(publisher=3, t0_ms=0.0, params=params,
                    payload_bytes=15000))


def _publish_batch_spec(device) -> TraceSpec:
    from ..runtime.publisher import publish_batch_scan

    g, params, state, a, (stage, lat, bw) = _single_topic(device)
    rows = np.full(4, 3, dtype=np.int32)
    active = np.ones(4, dtype=bool)
    return TraceSpec(
        fn=publish_batch_scan,
        args=(state, a["conns"], a["rev"], stage, lat, bw, rows, active),
        kwargs=dict(t0_ms=0.0, params=params, payload_bytes=15000,
                    fragments=1, with_gossip=True, loss_stage=None,
                    loss_mode="tcp", lat_edge=None, loss_edge=None,
                    ans_tables=None, valid_edge=None, with_fanout=False))


def _heartbeat_spec(device, fn_name: str, **params_over) -> TraceSpec:
    from ..ops import heartbeat

    g, params, state, a, _ = _single_topic(device, **params_over)
    kwargs = {"params": params}
    if fn_name == "run_heartbeats":
        kwargs["steps"] = 4
    return TraceSpec(
        fn=getattr(heartbeat, fn_name),
        args=(state, a["conns"], a["rev"], a["out_mask"]), kwargs=kwargs)


def _repair_spec(device) -> TraceSpec:
    from ..ops.repair import run_recovery_heartbeats

    g, params, state, a, _ = _single_topic(device, **_REPAIR)
    return TraceSpec(
        fn=run_recovery_heartbeats,
        args=(state, a["conns"], a["rev"], a["out_mask"],
              _cohort(params.n, device)),
        kwargs=dict(params=params, steps=4, publisher=3))


def _attack_spec(device) -> TraceSpec:
    from ..ops.adversary import AdversaryParams, run_attacked_heartbeats

    g, params, state, a, _ = _single_topic(device)
    return TraceSpec(
        fn=run_attacked_heartbeats,
        args=(state, a["conns"], a["rev"], a["out_mask"],
              _cohort(params.n, device)),
        kwargs=dict(params=params, adv=AdversaryParams(), steps=4))


def _adaptive_attack_spec(device) -> TraceSpec:
    from ..ops.adversary import (AdaptivePolicy, AdversaryParams,
                                 run_adaptive_heartbeats)
    from ..ops.state import init_adaptive_ctrl

    # repair leaves live: the PX-poison behavior writes px_pool rows
    g, params, state, a, _ = _single_topic(device, **_REPAIR)
    adv = AdversaryParams(adaptive=AdaptivePolicy(enabled=True))
    return TraceSpec(
        fn=run_adaptive_heartbeats,
        args=(state, a["conns"], a["rev"], a["out_mask"],
              _cohort(params.n, device)),
        kwargs=dict(params=params, adv=adv, steps=4,
                    ctrl=init_adaptive_ctrl(params.n, device)))


def _conform_spec(device) -> TraceSpec:
    from ..ops.adversary import AdversaryParams
    from .conformance import differential_round

    # the conformance fixture's arming: thresholds live, repair off
    g, params, state, a, _ = _single_topic(device, **_ARMED)
    return TraceSpec(
        fn=differential_round,
        args=(state, a["conns"], a["rev"], a["out_mask"],
              _cohort(params.n, device)),
        kwargs=dict(params=params, adv=AdversaryParams(), hb_idx=0))


def _faults_spec(device) -> TraceSpec:
    from ..ops.adversary import AdversaryParams
    from ..ops.faults import FaultParams, fault_masks, run_faulted_heartbeats

    g, params, state, a, _ = _single_topic(device, **_ARMED)
    # every fault family armed at once over an active adversary cohort
    faults = FaultParams(
        crash_frac=0.2, crash_window=(0, 2),
        partition_frac=0.3, partition_window=(1, 3),
        spike_frac=0.2, spike_window=(0, 4), spike_ms=250.0)
    fm = {k: torch.as_tensor(v, device=device)
          for k, v in fault_masks(params.n, faults, seed=1,
                                  publisher=3).items()}
    return TraceSpec(
        fn=run_faulted_heartbeats,
        args=(state, a["conns"], a["rev"], a["out_mask"],
              _cohort(params.n, device)),
        kwargs=dict(params=params, adv=AdversaryParams(), faults=faults,
                    crash=fm["crash"], side=fm["side"], spike=fm["spike"],
                    steps=4))


def _episub_step_spec(device) -> TraceSpec:
    from ..ops.episub import (EpisubParams, episub_heartbeat_step,
                              init_episub_ctrl)

    # graylist thresholds live: the armed program the arena runs
    g, params, state, a, _ = _single_topic(device, **_ARMED)
    return TraceSpec(
        fn=episub_heartbeat_step,
        args=(state, init_episub_ctrl(params.n, device), a["conns"],
              a["rev"], a["out_mask"]),
        kwargs=dict(params=params, ep=EpisubParams(root=3)))


def _telemetry_spec(device) -> TraceSpec:
    from ..ops.telemetry import TelemetryParams, run_recorded_heartbeats

    g, params, state, a, _ = _single_topic(device, **_ARMED)
    return TraceSpec(
        fn=run_recorded_heartbeats,
        args=(state, a["conns"], a["rev"], a["out_mask"]),
        kwargs=dict(params=params, steps=4,
                    telemetry=TelemetryParams(record=True)))


def _telemetry_attack_spec(device) -> TraceSpec:
    from ..ops.adversary import AdversaryParams, run_attacked_heartbeats
    from ..ops.telemetry import TelemetryParams

    g, params, state, a, _ = _single_topic(device, **_ARMED)
    return TraceSpec(
        fn=run_attacked_heartbeats,
        args=(state, a["conns"], a["rev"], a["out_mask"],
              _cohort(params.n, device)),
        kwargs=dict(params=params, adv=AdversaryParams(), steps=4,
                    telemetry=TelemetryParams(record=True)))


def _fused_rounds_spec(device) -> TraceSpec:
    from ..ops.disseminate import run_fused_rounds

    g, params, state, a, (stage, lat, bw) = _single_topic(
        device, fused_rounds=True)
    return TraceSpec(
        fn=run_fused_rounds,
        args=(state, a["conns"], a["rev"], stage, lat, bw, a["out_mask"],
              torch.arange(3, 6, dtype=torch.int32, device=device)),
        kwargs=dict(params=params, payload_bytes=15000, hb_per_round=2))


def _score_update_spec(device) -> TraceSpec:
    from ..native.score_update import score_update

    g, params, state, a, _ = _single_topic(device, slow_weight=-10.0)
    n, c = params.n, params.capacity
    idx = torch.arange(n * c, dtype=torch.float32, device=device
                       ).reshape(n, c)
    return TraceSpec(
        fn=score_update,
        args=((idx % 13) * 0.3, (idx % 7) * 0.2,
              torch.tensor([0.9, 0.8], dtype=torch.float32, device=device)),
        kwargs=dict(params=params))


def _kad_spec(device) -> TraceSpec:
    from ..ops import kad

    g, params, state, a, (stage, lat, bw) = _single_topic(device)
    st = kad.init_kad_state(params.n, seed=0, device=device)
    origins = torch.arange(4, dtype=torch.int32, device=device)
    return TraceSpec(
        fn=kad.find_node,
        args=(st, origins, st.keys[origins.long()], stage, lat),
        kwargs=dict(rounds=3))


@functools.lru_cache(maxsize=None)
def _multitopic_sim(device: str):
    from ..config.topology import TopoParams
    from ..runtime.multitopic import MultiTopicConfig, MultiTopicSimulator

    cfg = MultiTopicConfig(
        topo=TopoParams(network_size=16, anchor_stages=1),
        topics=("a", "b"), connect_to=3)
    return MultiTopicSimulator(cfg, device=device)


def _multitopic_spec(device) -> TraceSpec:
    from ..ops.disseminate import disseminate

    sim = _multitopic_sim(str(device))
    return TraceSpec(
        fn=disseminate,
        args=(_clone(sim.state), sim.arrays["conns"], sim.arrays["rev"],
              sim._stage, sim._lat, sim._bw),
        kwargs=dict(publisher=16 + 3, t0_ms=0.0, params=sim.params,
                    payload_bytes=500, lat_edge=sim._lat_edge,
                    ans_tables=sim._ans_tables))


# ------------------------------------------------------------ mesh contracts


def _rank_pool(x):
    """The parallel/ranks.RankPool of a pool argument (a RankPool, or a
    PeerMesh's pool)."""
    from ..parallel.sharding import PeerMesh

    return x.pool if isinstance(x, PeerMesh) else x


def _stacked(state, trials: int):
    from ..parallel.sharding import tree_map

    return tree_map(lambda x: torch.stack([x] * trials), state)


def _cohorts(n, device, trials: int, fraction: float = 0.25):
    return torch.stack([_cohort(n, device, fraction, seed=s)
                        for s in range(trials)])


def _shared(a: dict) -> dict:
    return {k: a[k] for k in ("conns", "rev", "out_mask")}


_LOCAL = 2          # the reference's local trials per group


def _faulted_nested_spec(device, grid) -> TraceSpec:
    from ..ops.adversary import AdversaryParams
    from ..ops.faults import FaultParams, fault_masks
    from ..runtime.campaign import sharded_faulted_window

    g, params, state, a, _ = _single_topic(device, **_ARMED)
    trials = grid.groups * _LOCAL
    faults = FaultParams(
        crash_frac=0.2, crash_window=(0, 2),
        partition_frac=0.3, partition_window=(1, 3),
        spike_frac=0.2, spike_window=(0, 4), spike_ms=250.0)
    fm = [fault_masks(params.n, faults, seed=s, publisher=3)
          for s in range(trials)]

    def stack(k):
        return torch.stack([torch.as_tensor(m[k], device=device)
                            for m in fm])

    return TraceSpec(
        fn=sharded_faulted_window,
        args=(_stacked(state, trials), _shared(a),
              _cohorts(params.n, device, trials), stack("crash"),
              stack("side"), stack("spike")),
        kwargs=dict(params=params, adv=AdversaryParams(), faults=faults,
                    steps=3, trial_mesh=grid, local_trials=_LOCAL))


def _attack_window_spec(device, pool, nested: bool = True) -> TraceSpec:
    from ..ops.adversary import AdversaryParams
    from ..runtime.campaign import sharded_attack_window

    g, params, state, a, _ = _single_topic(device)
    trials = pool.groups * _LOCAL
    kwargs = dict(params=params, adv=AdversaryParams(), steps=3,
                  trial_mesh=pool, local_trials=_LOCAL)
    if not nested:
        kwargs["nested"] = False
    return TraceSpec(
        fn=sharded_attack_window,
        args=(_stacked(state, trials), _shared(a),
              _cohorts(params.n, device, trials)),
        kwargs=kwargs)


def _dcn_audit_shape() -> tuple[int, int]:
    """(dcn blocks, per-block trial groups) of the dcn audit placement:
    2 x 1 over the 2 x 2 grid's 4 ranks, each block one trial group two
    ranks wide, so a peer-axis collective exists for GA-S006 to place
    (the reference's 4-device shape, 2 x 2 x 1, has peer width 1)."""
    return 2, 1


def _dcn_attack_window_spec(device, grid) -> TraceSpec:
    """The nested attack window on the dcn audit placement: the same
    window as attack_window_nested; the contract differs in its dcn
    blocks and budgets."""
    dcn, groups = _dcn_audit_shape()
    if grid.groups != dcn * groups:
        raise ValueError(
            f"the dcn audit placement needs {dcn * groups} trial groups, "
            f"the grid has {grid.groups}")
    return _attack_window_spec(device, grid)


def _dht_attack_window_spec(device, grid) -> TraceSpec:
    from ..ops.dht_adversary import (DhtAdversaryParams, build_attacked_dht,
                                     dht_repair_pool)
    from ..runtime.campaign import sharded_dht_recovery_window

    # repair armed: the window feeds the redial path a poisoned shortlist
    g, params, state, a, (stage, lat, bw) = _single_topic(device, **_REPAIR)
    trials = grid.groups * _LOCAL
    dht = DhtAdversaryParams(lookup_eclipse=True, warmup_waves=1,
                             lookup_rounds=2)
    atts, pools = [], []
    for s in range(trials):
        att = _cohort(params.n, device, seed=s)
        kstate, directory = build_attacked_dht(
            params.n, seed=s, dht=dht, attacker=att.cpu().numpy(),
            victim=3, stage=stage, lat_ms=lat)
        pool, _ = dht_repair_pool(kstate, dht, stage, lat, attacker=att,
                                  directory=directory)
        atts.append(att)
        pools.append(pool)
    return TraceSpec(
        fn=sharded_dht_recovery_window,
        args=(_stacked(state, trials), _shared(a), None, torch.stack(atts),
              torch.stack(pools)),
        kwargs=dict(rparams=params, steps=3, publisher=3, trial_mesh=grid,
                    local_trials=_LOCAL))


def _arena_window_spec(device, grid) -> TraceSpec:
    from ..ops.adversary import AdaptivePolicy, AdversaryParams
    from ..ops.episub import EpisubParams, init_episub_ctrl
    from ..runtime.campaign import sharded_episub_window

    g, params, state, a, _ = _single_topic(device, **_ARMED)
    trials = grid.groups * _LOCAL
    adv = AdversaryParams(adaptive=AdaptivePolicy(enabled=True))
    return TraceSpec(
        fn=sharded_episub_window,
        args=(_stacked(state, trials),
              _stacked(init_episub_ctrl(params.n, device), trials),
              _shared(a), _cohorts(params.n, device, trials)),
        kwargs=dict(params=params, ep=EpisubParams(root=3), adv=adv,
                    steps=3, trial_mesh=grid, local_trials=_LOCAL))


def attack_rung_spec(n: int, *, steps: int = 20, connect_to: int = 10,
                     local_trials: int = 2, trial_groups: int | None = None,
                     grid=None, device=None) -> TraceSpec:
    """The rung ladder's program at any peer count: the nested attack
    window as bench_configs config 8 dispatches it (sybil_graft_flood,
    connect_to 10, attacked fraction 0.1, 2 trial groups x 2 local
    trials) on `grid` (a RankPool of trial groups; `trial_groups`, when
    given, must be its group count), inputs on `device`."""
    from ..ops.adversary import AdversaryParams
    from ..runtime.campaign import sharded_attack_window

    grid = _rank_pool(grid)
    _check_groups(grid, trial_groups)
    dev = resolve_device(device)
    g, params, state, a, _ = _single_topic(dev, n=n, connect_to=connect_to)
    trials = grid.groups * local_trials
    return TraceSpec(
        fn=sharded_attack_window,
        args=(_stacked(state, trials), _shared(a),
              _cohorts(params.n, dev, trials, 0.1)),
        kwargs=dict(params=params,
                    adv=AdversaryParams(scenario="sybil_graft_flood"),
                    steps=steps, trial_mesh=grid,
                    local_trials=local_trials))


def arena_rung_spec(n: int, *, steps: int = 20, connect_to: int = 10,
                    local_trials: int = 2, trial_groups: int | None = None,
                    grid=None, device=None) -> TraceSpec:
    """The arena ladder's program at any peer count: the adaptive episub
    window (protocol/arena_window) at config 8's grid shape, thresholds
    armed, sybil_graft_flood at fraction 0.1, the EpisubCtrl carry
    stacked beside the state."""
    from ..ops.adversary import AdaptivePolicy, AdversaryParams
    from ..ops.episub import EpisubParams, init_episub_ctrl
    from ..runtime.campaign import sharded_episub_window

    grid = _rank_pool(grid)
    _check_groups(grid, trial_groups)
    dev = resolve_device(device)
    g, params, state, a, _ = _single_topic(dev, n=n, connect_to=connect_to,
                                           **_ARMED)
    trials = grid.groups * local_trials
    adv = AdversaryParams(scenario="sybil_graft_flood",
                          adaptive=AdaptivePolicy(enabled=True))
    return TraceSpec(
        fn=sharded_episub_window,
        args=(_stacked(state, trials),
              _stacked(init_episub_ctrl(params.n, dev), trials),
              _shared(a), _cohorts(params.n, dev, trials, 0.1)),
        kwargs=dict(params=params, ep=EpisubParams(root=3), adv=adv,
                    steps=steps, trial_mesh=grid,
                    local_trials=local_trials))


def _check_groups(grid, trial_groups) -> None:
    if grid is None:
        raise ValueError("a rung spec runs on a rank pool: pass grid=")
    if trial_groups is not None and trial_groups != grid.groups:
        raise ValueError(f"trial_groups {trial_groups} != the grid's "
                         f"{grid.groups} groups")


def _new_state_of(out):
    return out[1]


def _state_arg_of(spec):
    return spec.args[0]


def _first_out(out):
    return out[0]


def _require(cond: bool, msg: str) -> None:
    if not bool(cond):
        raise AssertionError(msg)


def _check_heartbeat(device) -> None:
    """From the canonical state, 8 heartbeats keep D_lo <= |mesh| <= D_hi
    for every live peer, and the score decay never goes negative."""
    from ..ops.heartbeat import run_heartbeats

    g, params, state, a, _ = _single_topic(device)
    s = run_heartbeats(state, a["conns"], a["rev"], a["out_mask"], params, 8)
    deg = s.mesh_mask.sum(dim=-1)
    _require(torch.all((deg >= params.d_low) & (deg <= params.d_high)),
             "mesh degree left [D_lo, D_hi]")
    _require(torch.all(s.fmd >= 0.0), "score decay went negative")


def _check_repair(device) -> None:
    """After a repair window the reverse-slot involution holds over the
    MUTATED graph, rev stays in range on every live slot, and the repair
    counters agree with the graft accounting (a PX graft is a graft).

    The reference's check asks rev >= 0 of every slot, pads included, whose
    rev is -1 by the graph's convention, so it fails on any padded graph,
    its own canonical one among them; this one asks it of the live slots
    (conns >= 0), which is what the involution needs."""
    from ..ops.heartbeat import run_heartbeats
    from ..ops.repair import run_recovery_heartbeats

    g, params, state, a, _ = _single_topic(device, **_REPAIR)
    state = run_heartbeats(state, a["conns"], a["rev"], a["out_mask"],
                           params, 8)
    att = _cohort(params.n, device)
    # force repair activity: a hostile penalty on the attacker edges
    conns = a["conns"]
    hostile = att[conns.clamp(min=0).long()] & (conns >= 0)
    state = state.replace(slow_penalty=torch.where(
        hostile, torch.tensor(100.0, device=device), state.slow_penalty))
    (s2, cn, rv, om), _obs = run_recovery_heartbeats(
        state, a["conns"], a["rev"], a["out_mask"], att, params,
        steps=8, publisher=3)
    me = torch.arange(cn.shape[0], dtype=cn.dtype, device=device)[:, None]
    back = cn[cn.clamp(min=0).long(), rv.long()]
    _require(torch.all(torch.where(cn >= 0, back == me, True)),
             "reverse-slot involution broken after repair window")
    _require(torch.all(torch.where(cn >= 0, (rv >= 0) & (rv < cn.shape[1]),
                                   True)),
             "rev slot out of range after repair window")
    _require((s2.px_grafts + s2.redials).sum()
             <= (s2.grafts - state.grafts).sum() * 2 + 1,
             "repair counters inconsistent with graft accounting")


def _check_disseminate(device) -> None:
    """Delays are non-negative where received, and the bounded-mode wait
    bar is finite (strict-JSON safe)."""
    from ..ops.disseminate import disseminate
    from ..ops.heartbeat import run_heartbeats

    g, params, state, a, (stage, lat, bw) = _single_topic(device)
    state = run_heartbeats(state, a["conns"], a["rev"], a["out_mask"],
                           params, 8)
    res, _s2 = disseminate(
        state, a["conns"], a["rev"], stage, lat, bw, publisher=3,
        t0_ms=0.0, params=params, payload_bytes=15000)
    _require(torch.all(torch.where(res.received, res.delay_ms, 0.0) >= 0.0),
             "negative dissemination delay")
    _require(torch.isfinite(res.answer_wait_max_ms),
             "non-finite answer wait bar (would poison strict JSON)")


def default_contracts(device=None, pool=None,
                      grid=None) -> list[EntrypointContract]:
    """The 20 single-device contracts, built for `device` (CUDA unless the
    caller asks for another), and with `grid` (a 2 x 2 RankPool) the 6
    mesh contracts, in the reference's order (module doc). The legacy
    layout runs on `pool` (2 ranks, each its own trial group, or a
    PeerMesh) when given, else on the grid's groups' first ranks."""
    dev = resolve_device(device)

    def on(make, *args, **kw):
        return functools.partial(make, dev, *args, **kw)

    single = _single_device_contracts(on)
    if grid is None:
        return single
    grid = _rank_pool(grid)
    mesh = _mesh_contracts(on, grid if pool is None else _rank_pool(pool),
                           grid)
    # the reference's order: the mesh contracts after faults/churn_window,
    # the arena window after episub/heartbeat_step
    at = [c.name for c in single].index("faults/churn_window") + 1
    return single[:at] + mesh[:-1] + single[at:] + mesh[-1:]


# the collective byte budgets: the most one rank's collectives moved at the
# audit shape on the 2 x 2 CPU grid (lint --sharding --device cpu),
# ratcheted about 4x, as the reference set its own from its GSPMD programs.
# Measured: 20,688 B (faulted), 20,096 B (nested and dcn: 28 all-gathers,
# 60 all-reduces), 49,064 B (dht, broadcasts too), 23,960 B (arena)
FAULTED_NESTED_BYTES = 80 * 1024
NESTED_BYTES = 80 * 1024
DHT_BYTES = 192 * 1024
ARENA_BYTES = 96 * 1024
# the per-rank memory budgets (GA-S004): the largest rank's peak rise on an
# NVIDIA H100 80GB HBM3 (700 W) through `lint --sharding` (chip_smoke.py
# 17(c), the collector paused in a measured job), ratcheted about 4x.
# Measured: 76,288 B (faulted), 110,080 B (legacy), 74,752 B (nested and
# dcn), 113,152 B (dht), 93,184 B (arena)
FAULTED_NESTED_HBM = 300 * 1024
LEGACY_HBM = 432 * 1024
NESTED_HBM = 292 * 1024
DHT_HBM = 448 * 1024
ARENA_HBM = 364 * 1024


def _mesh_contracts(on, pool, grid) -> list[EntrypointContract]:
    kinds = frozenset(COLLECTIVE_KINDS)
    return [
        EntrypointContract(
            name="campaign/faulted_window_nested",
            build=on(_faulted_nested_spec, grid),
            feedback=[(_first_out, _state_arg_of)],
            collectives=kinds,
            collective_bytes_budget=FAULTED_NESTED_BYTES,
            hbm_budget_bytes=FAULTED_NESTED_HBM,
            notes="the fault-armed nested window: the per-trial crash / "
                  "side / spike cohorts split over both grid axes like "
                  "the attacker masks; the stacked state feeds back "
                  "type-stable"),
        EntrypointContract(
            name="campaign/attack_window_sharded",
            build=on(_attack_window_spec, pool, nested=False),
            feedback=[(_first_out, _state_arg_of)],
            # each trial whole on one rank: no collective is legitimate
            collectives=frozenset(),
            hbm_budget_bytes=LEGACY_HBM,
            waivers=(("GA-S001",
                      "legacy nested=False layout replicates the shared "
                      "epoch graph (conns/rev) across trial groups by "
                      "design — it exists as the replicated-peer-submesh "
                      "equality baseline for the nested program "
                      "(docs/ARCHITECTURE.md §13)"),),
            notes="the legacy trial-only layout (nested=False): each "
                  "trial whole on its group's rank, the replicated "
                  "baseline the nested window is pinned against"),
        EntrypointContract(
            name="campaign/attack_window_nested",
            build=on(_attack_window_spec, grid),
            feedback=[(_first_out, _state_arg_of)],
            collectives=kinds,
            collective_bytes_budget=NESTED_BYTES,
            hbm_budget_bytes=NESTED_HBM,
            notes="the nested window the campaign dispatches: trials over "
                  "the groups, each trial's rows over its group's ranks; "
                  "the auditor pins its collective kinds and its byte and "
                  "memory budgets"),
        EntrypointContract(
            name="campaign/attack_window_dcn",
            build=on(_dcn_attack_window_spec, grid),
            feedback=[(_first_out, _state_arg_of)],
            collectives=kinds,
            collective_bytes_budget=NESTED_BYTES,
            hbm_budget_bytes=NESTED_HBM,
            # a dcn block is one process's ranks; trials are independent
            # across blocks, so no byte may cross one
            dcn_block_devices=2,
            dcn_collective_bytes_budget=0,
            notes="the dcn x trials x peers placement (2 x 1 x 2): the "
                  "nested attack window with every peer group inside one "
                  "block; GA-S006 proves no collective crosses a block"),
        EntrypointContract(
            name="campaign/dht_attack_window",
            build=on(_dht_attack_window_spec, grid),
            feedback=[(lambda out: out[0][0], _state_arg_of),
                      (lambda out: out[0][4], lambda spec: spec.args[4])],
            collectives=kinds,
            collective_bytes_budget=DHT_BYTES,
            hbm_budget_bytes=DHT_HBM,
            notes="the DHT-armed recovery window: repair leaves live, the "
                  "(T, N, K) shortlists split over both grid axes; the "
                  "state and the consumed pool feed back type-stable"),
        EntrypointContract(
            name="protocol/arena_window",
            build=on(_arena_window_spec, grid),
            feedback=[(lambda out: out[0][0], lambda spec: spec.args[0]),
                      (lambda out: out[0][1], lambda spec: spec.args[1])],
            collectives=kinds,
            collective_bytes_budget=ARENA_BYTES,
            hbm_budget_bytes=ARENA_HBM,
            notes="the arena's adaptive episub window on the grid: state "
                  "and tree carry feed back type-stable"),
    ]


def _single_device_contracts(on) -> list[EntrypointContract]:
    return [
        EntrypointContract(
            name="disseminate/cold",
            build=on(_disseminate_spec),
            feedback=[(_new_state_of, _state_arg_of)],
            runtime_check=on(_check_disseminate),
            notes="the exact publish: the serialized-answer repair (the "
                  "prefix engine, serial as its fallback)"),
        EntrypointContract(
            name="disseminate/warm",
            build=on(_disseminate_spec, warm_start=True),
            feedback=[(_new_state_of, _state_arg_of)],
            notes="warm-started exact publish (certified or rerun cold)"),
        EntrypointContract(
            name="disseminate/exact_serial",
            build=on(_disseminate_spec, answer_queue_mode="serial"),
            feedback=[(_new_state_of, _state_arg_of)],
            notes="the serial refiner forced by static param: the "
                  "bit-equality reference the prefix engine is pinned "
                  "against"),
        EntrypointContract(
            name="disseminate/bounded",
            build=on(_disseminate_spec, serialize_answers=False),
            feedback=[(_new_state_of, _state_arg_of)],
            notes="bounded accounting: no refinement"),
        EntrypointContract(
            name="publisher/batch_scan",
            build=on(_publish_batch_spec),
            feedback=[(_new_state_of, _state_arg_of)],
            notes="the batched dispatch: one exact publish per active "
                  "column from one t0, the state carried; the state feeds "
                  "back type-stable so every pump round takes the same "
                  "inputs"),
        EntrypointContract(
            name="heartbeat_step",
            build=on(_heartbeat_spec, "heartbeat_step"),
            notes="one mesh-maintenance round"),
        EntrypointContract(
            name="run_heartbeats",
            build=on(_heartbeat_spec, "run_heartbeats"),
            feedback=[(lambda out: out, _state_arg_of)],
            runtime_check=on(_check_heartbeat),
            notes="the simulator's heartbeat loop; score_update "
                  "materializes the deferred decay at its end"),
        EntrypointContract(
            name="run_attacked_heartbeats",
            build=on(_attack_spec),
            feedback=[(_first_out, _state_arg_of)],
            notes="the campaign's attack window, one trial"),
        EntrypointContract(
            name="adversary/adaptive_window",
            build=on(_adaptive_attack_spec),
            # the armed window carries (state, ctrl): BOTH feed the next
            # window, the controller estimate across the attack ->
            # recovery edge
            feedback=[(lambda out: out[0][0], _state_arg_of),
                      (lambda out: out[0][1],
                       lambda spec: spec.kwargs["ctrl"])],
            hbm_budget_bytes=2 * 1024 * 1024,
            notes="the adaptive attacker controller in the window: repair "
                  "leaves live so PX poison writes real px_pool rows"),
        EntrypointContract(
            name="heartbeat_step/evict",
            build=on(_heartbeat_spec, "heartbeat_step", **_REPAIR),
            notes="the opt-in repair branches armed: eviction and PX "
                  "capture"),
        EntrypointContract(
            name="repair/recovery_window",
            build=on(_repair_spec),
            # the WHOLE carry feeds back: (state, conns, rev, out_mask)
            feedback=[(_first_out, lambda spec: spec.args[:4])],
            runtime_check=on(_check_repair),
            notes="recovery window: the graph arrays ride the carry"),
        EntrypointContract(
            name="faults/churn_window",
            build=on(_faults_spec),
            feedback=[(_first_out, _state_arg_of)],
            hbm_budget_bytes=2 * 1024 * 1024,
            notes="crash + partition + spike armed over an attacked mesh; "
                  "the state feeds back type-stable so retried trials "
                  "resume from a checkpoint"),
        EntrypointContract(
            name="telemetry/recorded_heartbeats",
            build=on(_telemetry_spec),
            feedback=[(_first_out, _state_arg_of)],
            notes="flight recorder armed: the channel reductions ride the "
                  "obs stack"),
        EntrypointContract(
            name="telemetry/recorded_attack_window",
            build=on(_telemetry_attack_spec),
            feedback=[(_first_out, _state_arg_of)],
            notes="attack window with the recorder armed"),
        EntrypointContract(
            name="heartbeat/fused_round",
            build=on(_fused_rounds_spec),
            feedback=[(_first_out, _state_arg_of)],
            notes="the round chain: heartbeat burst + exact publish per "
                  "round, the state carried"),
        EntrypointContract(
            name="native/score_update",
            build=on(_score_update_spec),
            feedback=[(lambda out: out[0], lambda spec: spec.args[0]),
                      (lambda out: out[1], lambda spec: spec.args[1])],
            notes="the fused scoring-update kernel (csrc/score_update.cu) "
                  "on the card, its plain version on the CPU; the decayed "
                  "counters feed back type-stable; counters bitwise, "
                  "score within rtol 1e-5 / atol 1e-6 of the reference"),
        EntrypointContract(
            name="kad/find_node",
            build=on(_kad_spec),
            feedback=[(lambda out: out[1], _state_arg_of)],
            notes="the DHT lookup"),
        EntrypointContract(
            name="multitopic/disseminate",
            build=on(_multitopic_spec),
            feedback=[(_new_state_of, _state_arg_of)],
            notes="the T*N block-diagonal stack"),
        EntrypointContract(
            name="conformance/differential_round",
            build=on(_conform_spec),
            feedback=[(lambda out: out, _state_arg_of)],
            notes="the round the conformance gate walks "
                  "(analysis/conformance.py); the state feeds the next "
                  "round type-stable"),
        EntrypointContract(
            name="episub/heartbeat_step",
            build=on(_episub_step_spec),
            feedback=[(lambda out: out[0], lambda spec: spec.args[0]),
                      (lambda out: out[1], lambda spec: spec.args[1])],
            hbm_budget_bytes=2 * 1024 * 1024,
            notes="the episub tree round: eager push, lazy IHAVE repair, "
                  "graylist-gated re-parenting; state and ctrl feed back "
                  "type-stable"),
    ]
