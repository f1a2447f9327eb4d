"""Monte-Carlo adversarial campaigns on one device (the reference's
runtime/campaign.py, single-device path).

`run_campaign` sweeps attacker fraction x seed over one built network and
reports resilience metrics per trial. A trial:

  setup     the attacker cohort is drawn on the host
            (ops/adversary.attacker_cohort), and the fault cohorts when a
            fault schedule is armed (ops/faults.fault_masks); the trial's
            PRNG and state are re-seeded from the trial seed, the
            connection graph is shared
  warmup    benign mesh stabilization (cold_boot_join: inside the window)
  window    `attack_heartbeats` rounds of [heartbeat_step ->
            adversary_round], with the fault schedule
            (ops/faults.run_faulted_heartbeats) and the adaptive attacker
            (ops/adversary.adaptive_round, its controller carried into the
            recovery window) when armed; same-fraction seeds run as a loop
            of single-trial windows, which equal the reference's one
            vmapped scan over the stacked trials bitwise
  dht       with the DHT adversary armed, the trial's Kademlia state built
            under the shared cohort (ops/dht_adversary.build_attacked_dht)
            and one repair shortlist per recovery leg
  recovery  optional `recovery_heartbeats` rounds of [heartbeat_step
            (evict / px armed) -> repair_round], after the trial
            checkpoint: the DHT-backed window in two legs split at
            dht.heal_hb (the second resumes the trial's dialed graph), the
            arms-race window with the adaptive attacker; a dialed graph is
            rebound (Simulator.rebind_graph) for the publish schedule and
            the epoch graph restored after
  publish   the injection schedule with the censor mask (and the cross-cut
            mask while a partition is still open), and the P3-analog
            censorship penalty after each publish

A fraction-0.0 trial takes exactly the benign Simulator path, so its
outputs are the bytes of a plain Simulator on the same seed.
`checkpoint_dir` snapshots each trial after its window (the reference's
file format plus an `.obs.npz` sidecar of its curves, and the DHT's kad/*
leaves), and a later sweep resumes every trial it finds there; a resumed
adaptive trial restarts its controller from zero, as the reference's does.
`run_defense_sweep` races a grid of defense knobs against the adaptive
attacker and reports the coverage / bandwidth / recovery-time Pareto
front. `run_arena_campaign` races GossipSub against the episub tree
(ops/episub.py) on the same graph, cohorts, faults and traffic, each
protocol's windows resolved through the registry (ops/protocol.py), and
scores who wins each objective.

`conformance=True` attaches the small-N conformance certificate of the
campaign's scenario (analysis/conformance.py, its sim side on the
campaign's device) to the result.

`trial_mesh` (parallel/sharding.make_trial_mesh, or an open
parallel/ranks.RankPool) deals an attacked fraction's seed column over
the grid's trial groups, one rank process each: the column is split in
contiguous blocks of ceil(T/G) trials (the reference's padded
P("trials") split; the padded repeats of the last trial are dropped
before they run), each rank runs its block through the same per-trial
path on its own Simulator, and the trials come back in seed order.
Benign cells, the seeds' latency baselines and the certificate stay in
the caller, computed once. A one-group grid runs in the caller, as if
there were none. `dcn` runs the campaign over a torch.distributed
world (one process per host, each on its own grid) and merges the
ranks' files into one result (the reference's DCN engine). The peer
mesh (`mesh`, and grids wider than one device per group) is a later
slice and raises NotImplementedError naming it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..config.env import GossipSubParams
from ..ops.adversary import (
    AdversaryParams,
    attacker_cohort,
    censor_mask,
    censorship_penalty_update,
    eclipse_setup,
    heartbeats_to_graylist,
)
from ..ops.dht_adversary import (
    DhtAdversaryParams,
    build_attacked_dht,
    dht_repair_pool,
    rtable_poison_frac,
)
from ..ops.faults import FaultParams, fault_masks, partition_edge_mask
from ..ops.repair import (
    RepairParams,
    run_adaptive_recovery_heartbeats,
    run_dht_recovery_heartbeats,
)
from ..ops.telemetry import TelemetryParams
from ..parallel.ranks import RankPool
from ..parallel.sharding import check_trial_grid, peer_mesh_later
from .simulator import ExperimentConfig, MessageRecord, Simulator
from .summarize import sanitize_nonfinite
from .supervise import _call_with_timeout, _FailureInjector

GRAYLIST_ENGAGED_FRAC = 0.95


def attack_gossipsub(**overrides) -> GossipSubParams:
    """GossipSub params with the score defense armed (the reference's
    weights: an engagement budget of about 7 accrual rounds)."""
    base = dict(
        slow_peer_penalty_weight=-10.0,
        slow_peer_penalty_decay=0.9,
        gossip_threshold=-10.0,
        publish_threshold=-20.0,
        graylist_threshold=-50.0,
    )
    base.update(overrides)
    return GossipSubParams(**base)


@dataclass(frozen=True)
class SupervisorConfig:
    """Host-side trial supervision: timeout, bounded retry with
    exponential backoff (retry k sleeps retry_backoff_s * 2**(k-1)),
    quarantine; `inject_failures` makes the first K attempts raise."""

    trial_timeout_s: float = 0.0
    max_retries: int = 2
    retry_backoff_s: float = 0.5
    inject_failures: int = 0

    def validate(self) -> None:
        if self.trial_timeout_s < 0.0:
            raise ValueError("trial_timeout_s must be >= 0 (0 disables)")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_backoff_s < 0.0:
            raise ValueError("retry_backoff_s must be >= 0")
        if self.inject_failures < 0:
            raise ValueError("inject_failures must be >= 0")


def _supervise(sup: SupervisorConfig, injector: _FailureInjector, run,
               on_fail=None, sleep=time.sleep, device=None):
    """(result | None, retries used, last error | None) of one cell."""
    last_err = None
    for attempt in range(sup.max_retries + 1):
        if attempt > 0:
            sleep(sup.retry_backoff_s * (2 ** (attempt - 1)))
        try:
            injector.maybe_fail()
            return (_call_with_timeout(run, sup.trial_timeout_s, device),
                    attempt, None)
        except Exception as e:  # noqa: BLE001 — the supervisor is the handler
            last_err = e
            if on_fail is not None:
                on_fail()
    return None, sup.max_retries, last_err


@dataclass
class CampaignConfig:
    scenario: str = "sybil_graft_flood"
    fractions: tuple = (0.0, 0.1, 0.2)
    seeds: tuple = (0,)
    experiment: ExperimentConfig = field(
        default_factory=lambda: ExperimentConfig(gossipsub=attack_gossipsub()))
    adversary: AdversaryParams | None = None
    attack_heartbeats: int = 20
    mesh_recovery_share: float = 0.05
    recovery_heartbeats: int = 0
    repair: RepairParams = field(default_factory=RepairParams)
    vmap_trials: bool = True
    checkpoint_dir: str | None = None
    faults: FaultParams = field(default_factory=FaultParams)
    supervisor: SupervisorConfig = field(default_factory=SupervisorConfig)
    telemetry: TelemetryParams = field(default_factory=TelemetryParams)
    dht: DhtAdversaryParams = field(default_factory=DhtAdversaryParams)
    conformance: bool = False

    def adversary_params(self) -> AdversaryParams:
        return self.adversary or AdversaryParams(scenario=self.scenario)

    def validate(self) -> None:
        adv = self.adversary_params()
        adv.validate()
        if adv.scenario != self.scenario:
            raise ValueError(
                f"adversary.scenario {adv.scenario!r} != campaign scenario "
                f"{self.scenario!r}")
        if not self.fractions or not self.seeds:
            raise ValueError("need at least one fraction and one seed")
        for f in self.fractions:
            if not (0.0 <= f < 1.0):
                raise ValueError(f"attacker fraction {f} outside [0, 1)")
        if self.attack_heartbeats < 1:
            raise ValueError("attack_heartbeats must be >= 1")
        if self.recovery_heartbeats < 0:
            raise ValueError("recovery_heartbeats must be >= 0")
        self.repair.validate()
        self.faults.validate()
        self.supervisor.validate()
        self.telemetry.validate()
        self.dht.validate()
        if self.dht.enabled:
            if self.recovery_heartbeats < 1:
                raise ValueError(
                    "dht arming needs recovery_heartbeats >= 1: the DHT "
                    "candidate source only feeds the recovery window")
            if not self.repair.redial:
                raise ValueError(
                    "dht arming needs repair.redial=True: the DHT shortlist "
                    "is the re-dial path's candidate source")
            if self.dht.heal_hb >= self.recovery_heartbeats:
                raise ValueError(
                    f"dht.heal_hb {self.dht.heal_hb} must fall inside the "
                    f"recovery window ({self.recovery_heartbeats} rounds)")
        if self.faults.crash and (
                self.faults.crash_window[1] > self.attack_heartbeats):
            # the restart must land inside the window (a partition or
            # spike may spill past it: an open partition folds into the
            # publish schedule's delivery mask)
            raise ValueError(
                f"crash_window end {self.faults.crash_window[1]} exceeds "
                f"attack_heartbeats {self.attack_heartbeats}: the restart "
                "would never fire")
        if adv.eclipse:
            if self.experiment.gossipsub.flood_publish:
                raise ValueError(
                    "eclipse_publisher requires flood_publish=False "
                    "(flood publish bypasses the eclipsed mesh)")
            if self.experiment.publisher_rotation:
                raise ValueError(
                    "eclipse_publisher targets one publisher; disable "
                    "publisher_rotation")


@dataclass
class TrialResult:
    scenario: str
    fraction: float
    seed: int
    attackers: int
    honest_coverage: float
    benign_coverage: float
    latency_p50_ms: float
    latency_p99_ms: float
    benign_p50_ms: float
    latency_inflation: float
    hb_to_graylist: int
    hb_budget: float
    graylisted_frac_final: float
    mesh_recovery_hb: int
    attacker_mesh_share_final: float
    attacker_score_final: float
    wall_s: float
    mesh_evictions_total: int = 0
    px_grafts_total: int = 0
    redials_total: int = 0
    recovery_time_ms: float = -1.0
    bytes_tx_total: float = -1.0
    heal_time_ms: float = -1.0
    post_churn_reconvergence_hb: int = -1
    coverage_under_partition: float = -1.0
    coverage90_hb: int = -1
    score_cross_hb: int = -1
    rtable_poison_frac: float = -1.0

    def to_dict(self) -> dict:
        return sanitize_nonfinite(dict(self.__dict__))


@dataclass
class CampaignResult:
    scenario: str
    network_size: int
    trials: list[TrialResult]
    hb_budget: float
    wall_s: float
    degraded: bool = False
    quarantined_trials: list = field(default_factory=list)
    retries_total: int = 0
    conformance: dict | None = None
    # per-trial wall split of this run (seconds by phase), for the smoke's
    # report; not part of to_dict
    phase_walls: list = field(default_factory=list, repr=False)

    @property
    def trials_per_s(self) -> float:
        return len(self.trials) / max(self.wall_s, 1e-9)

    def to_dict(self) -> dict:
        return sanitize_nonfinite({
            "scenario": self.scenario,
            "network_size": self.network_size,
            "hb_budget": self.hb_budget,
            "wall_s": self.wall_s,
            "trials_per_s": self.trials_per_s,
            "degraded": self.degraded,
            "retries_total": self.retries_total,
            "quarantined_trials": list(self.quarantined_trials),
            "conformance": self.conformance,
            "trials": [t.to_dict() for t in self.trials],
        })


# --------------------------------------------------------------------- trials


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _sync(sim: Simulator) -> None:
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)


class _Walls:
    """Wall seconds by phase for one cell (device work synchronized at
    every boundary, so each phase is charged its own kernels)."""

    def __init__(self, sim: Simulator):
        self.sim = sim
        self.t = {}

    def add(self, phase: str, t0: float) -> float:
        _sync(self.sim)
        now = time.perf_counter()
        self.t[phase] = self.t.get(phase, 0.0) + (now - t0)
        return now


def _reset_trial(sim: Simulator, seed: int) -> None:
    """Rewind the shared Simulator onto a trial's seed (graph kept)."""
    base = sim.cfg.seed
    sim.cfg.seed = seed
    try:
        sim.reset()
    finally:
        sim.cfg.seed = base


def _publish_schedule(sim: Simulator, censor=None, attacker=None,
                      adv: AdversaryParams | None = None, cross=None,
                      partition_ms=None, advance=None) -> list[MessageRecord]:
    """The experiment's injection schedule with the censor mask threaded
    into every publish and the censorship penalty after each one. `cross`
    / `partition_ms`: a partition still open over the schedule folds its
    cross-cut mask into the delivery mask of every publish inside [lo,
    hi) sim-ms. `advance(ms)` runs the heartbeats between messages
    (default Simulator.advance, GossipSub's)."""
    exp = sim.cfg
    n = exp.topo.network_size
    delay_ms = exp.topo.delay_seconds * 1000.0
    pub = exp.publisher_id % n
    a = sim.arrays
    advance = sim.advance if advance is None else advance
    for i in range(exp.topo.messages):
        if i > 0:
            advance(delay_ms)
        eff = censor
        if cross is not None and partition_ms is not None:
            t_now = float(sim.state.t_ms)
            if partition_ms[0] <= t_now < partition_ms[1]:
                eff = cross if censor is None else (censor | cross)
        rec = sim.publish(pub, censor_edge=eff)
        if censor is not None:
            received = torch.as_tensor(rec.received, device=sim.device)
            sim.state = censorship_penalty_update(
                sim.state, a["conns"], a["rev"], attacker, received,
                sim.params, adv)
        if exp.publisher_rotation:
            pub = (pub + 1) % n
    return sim.records


def _delivery_metrics(records: list[MessageRecord], honest: np.ndarray):
    """(coverage, p50_ms, p99_ms) over honest peers, pooled over the
    schedule; inf latencies for an empty pool."""
    if not records:
        return 0.0, math.inf, math.inf
    cov = float(np.mean([r.received[honest].mean() for r in records]))
    pool = np.concatenate(
        [r.delays_ms[honest & r.received] for r in records])
    if pool.size == 0:
        return cov, math.inf, math.inf
    return (cov, float(np.percentile(pool, 50)),
            float(np.percentile(pool, 99)))


def _ensure_baseline(sim: Simulator, cache: dict, seed: int,
                     walls: _Walls | None = None) -> dict:
    """Benign metrics for `seed` (the fraction-0.0 path), at most once per
    seed per campaign."""
    if seed not in cache:
        t0 = time.perf_counter()
        _reset_trial(sim, seed)
        sim.warmup()
        if walls is not None:
            t0 = walls.add("baseline_warmup", t0)
        records = _publish_schedule(sim)
        if walls is not None:
            walls.add("baseline_publish", t0)
        honest = np.ones(sim.params.n, dtype=bool)
        cov, p50, p99 = _delivery_metrics(records, honest)
        cache[seed] = {"coverage": cov, "p50": p50, "p99": p99}
    return cache[seed]


def _benign_trial(sim: Simulator, cfg: CampaignConfig, seed: int,
                  cache: dict, budget: float, walls: list) -> TrialResult:
    t0 = time.time()
    w = _Walls(sim)
    cache.pop(seed, None)  # force the run: the trial is the baseline
    base = _ensure_baseline(sim, cache, seed, w)
    walls.append({"fraction": 0.0, "seed": seed, **w.t})
    return TrialResult(
        scenario=cfg.scenario, fraction=0.0, seed=seed, attackers=0,
        honest_coverage=base["coverage"], benign_coverage=base["coverage"],
        latency_p50_ms=base["p50"], latency_p99_ms=base["p99"],
        benign_p50_ms=base["p50"], latency_inflation=1.0,
        hb_to_graylist=-1, hb_budget=budget,
        graylisted_frac_final=0.0, mesh_recovery_hb=-1,
        attacker_mesh_share_final=0.0, attacker_score_final=0.0,
        wall_s=time.time() - t0,
        bytes_tx_total=float(_host(sim.state.bytes_tx).sum()),
    )


def _first_round(curve: np.ndarray, pred) -> int:
    """1-based index of the first round satisfying pred, -1 if none."""
    hits = np.nonzero(pred(curve))[0]
    return int(hits[0]) + 1 if hits.size else -1


def _obs_metrics(obs: dict, share_floor: float):
    gf = np.asarray(obs["graylisted_frac"], dtype=np.float64)
    share = np.asarray(obs["attacker_mesh_share"], dtype=np.float64)
    engaged = _first_round(gf, lambda c: c >= GRAYLIST_ENGAGED_FRAC)
    peak = int(np.argmax(share))
    if share.max() <= share_floor:
        recovery = 1  # never meaningfully compromised
    else:
        after = share[peak:]
        rel = _first_round(after, lambda c: c <= share_floor)
        recovery = peak + rel if rel > 0 else -1
    return engaged, float(gf[-1]), recovery, float(share[-1])


def _obs_to_host(obs: dict) -> dict:
    return {k: _host(v) for k, v in obs.items()}


def _trial_ckpt(cfg: CampaignConfig, fraction: float, seed: int):
    """(checkpoint, obs-sidecar) paths for one (fraction, seed) cell."""
    base = os.path.join(cfg.checkpoint_dir,
                        f"{cfg.scenario}_f{fraction:g}_s{seed}")
    return base + ".npz", base + ".obs.npz"


def _try_resume(sim: Simulator, cfg: CampaignConfig, fraction: float,
                seed: int):
    """(post-window state, window obs) from a prior run's trial
    checkpoint and obs sidecar, or None. A snapshot of another format
    version or another epoch graph is recomputed, never trusted."""
    from .. import interop
    from .checkpoint import FORMAT_VERSION, _graph_hash

    ck, sc = _trial_ckpt(cfg, fraction, seed)
    if not (os.path.exists(ck) and os.path.exists(sc)):
        return None
    try:
        with np.load(ck) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
            if meta["version"] != FORMAT_VERSION:
                return None
            if meta.get("graph_sha256") != _graph_hash(sim.graph):
                return None
            sd = {k.split("/", 1)[1]: z[k]
                  for k in z.files if k.startswith("state/")}
        state = interop.state_from_numpy(sd, sim.device)
        with np.load(sc) as zo:
            obs = {k: np.asarray(zo[k]) for k in zo.files}
    except Exception:
        return None  # unreadable or truncated: recompute the trial
    return state, obs


def _save_trial(sim: Simulator, cfg: CampaignConfig, fraction: float,
                seed: int, obs: dict, kad_state=None) -> None:
    from .checkpoint import save_checkpoint

    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    ck, sc = _trial_ckpt(cfg, fraction, seed)
    save_checkpoint(sim, ck, kad_state=kad_state)
    # the obs sidecar: the window's curves, which the state alone cannot
    # give back to a resumed trial
    tmp = sc + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **{k: np.asarray(v) for k, v in obs.items()})
    os.replace(tmp, sc)


def _dht_legs(dht: DhtAdversaryParams, steps: int) -> tuple[int, int]:
    """(attacked rounds, healed rounds) of a recovery window: dht.heal_hb
    splits the window at the heal edge; -1 = the DHT never heals."""
    if dht.heal_hb < 0:
        return steps, 0
    return dht.heal_hb, steps - dht.heal_hb


def _protocol_window_runner(protocol: str, runner: str):
    """A window's heartbeat runner resolved through the protocol registry
    (ops/protocol.py): for "gossipsub" the module-level runner object
    itself. A protocol with its own carry (episub) is refused: its
    windows thread the carry (_episub_windows)."""
    from ..ops.protocol import get_protocol

    spec = get_protocol(protocol)
    if spec.init_ctrl is not None:
        raise ValueError(
            f"protocol {protocol!r} carries a per-protocol ctrl; route it "
            "through its ctrl-threading windows (_episub_windows), not the "
            "SimState-only attack/fault windows")
    return getattr(spec, runner)


def _attack_window(sim: Simulator, cfg: CampaignConfig, adv, att_j, fm,
                   steps: int, tel):
    """One trial's attack window from the bound state: (state, obs, ctrl),
    ctrl the adaptive attacker's carry (None when disarmed). `fm`: the
    trial's fault cohorts as tensors (None when no fault is armed)."""
    a = sim.arrays
    if fm is None:
        fm = {k: None for k in ("crash", "side", "spike")}
    run_faulted = _protocol_window_runner("gossipsub",
                                          "run_faulted_heartbeats")
    st, obs = run_faulted(
        sim.state, a["conns"], a["rev"], a["out_mask"], att_j, sim.params,
        adv, cfg.faults, fm["crash"], fm["side"], fm["spike"], steps,
        telemetry=tel)
    if adv.adaptive.enabled:
        st, ctrl = st
        return st, obs, ctrl
    return st, obs, None


def _recovery(sim: Simulator, cfg: CampaignConfig, adv, att_j, pub: int,
              tel, ctrl, kad):
    """The trial's recovery window from the bound state: ((state, conns,
    rev, out_mask), host obs). `kad`: the trial's DHT context (two legs,
    the second resuming the first's dialed graph) or None."""
    rparams = cfg.repair.apply(sim.params)
    a = sim.arrays
    cur = (sim.state, a["conns"], a["rev"], a["out_mask"])
    adaptive = adv.adaptive.enabled
    if kad is None:
        legs = ((cfg.recovery_heartbeats, None),)
    else:
        steps1, steps2 = _dht_legs(cfg.dht, cfg.recovery_heartbeats)
        legs = ((steps1, kad[1]), (steps2, kad[2]))
    leg_obs = []
    for steps, pool in legs:
        if steps <= 0:
            continue
        if adaptive:
            # the controller carry crosses the heal edge
            carry, lobs = run_adaptive_recovery_heartbeats(
                *cur, att_j, rparams, steps, adv=adv, ctrl=ctrl,
                dht_pool=pool, publisher=pub, telemetry=tel)
            ctrl = carry[1]
            cur = (carry[0],) + tuple(carry[2:5])
        else:
            carry, lobs = run_dht_recovery_heartbeats(
                *cur, att_j, rparams, steps, dht_pool=pool, publisher=pub,
                telemetry=tel)
            cur = tuple(carry[:4])
        leg_obs.append(_obs_to_host(lobs))
    robs = {k: np.concatenate([lo[k] for lo in leg_obs])
            for k in leg_obs[0]}
    return cur, robs


def _attacked_trials(sim: Simulator, cfg: CampaignConfig, fraction: float,
                     seeds: list[int], cache: dict, budget: float,
                     walls: list) -> list[TrialResult]:
    adv = cfg.adversary_params()
    exp = cfg.experiment
    n = sim.params.n
    conns_np = np.asarray(sim.graph.conns)
    pub = exp.publisher_id % n
    hb_ms = sim.params.heartbeat_ms
    warm_steps = int(exp.warmup_s * 1000.0 // hb_ms)
    # cold boot joins mid-attack: the warm-up rounds run inside the window
    steps = cfg.attack_heartbeats + (warm_steps if adv.cold_boot else 0)
    # without PX or re-dial no dial can commit: the graph stays the epoch's
    graph_static = not (cfg.repair.px or cfg.repair.redial)
    tel = cfg.telemetry if cfg.telemetry.enabled else None
    faults = cfg.faults
    dev = sim.device

    t0 = time.time()
    cohorts: dict[int, tuple] = {}
    state_by_seed: dict[int, object] = {}
    obs_by_seed: dict[int, dict] = {}
    # the adaptive controller per trial; a trial resumed from a checkpoint
    # has none and restarts it from zero (the reference's warm restart)
    ctrl_by_seed: dict[int, object] = {}
    fmasks: dict[int, tuple] = {}
    wall_by_seed: dict[int, _Walls] = {s: _Walls(sim) for s in seeds}
    resumed: set[int] = set()
    for s in seeds:
        att = attacker_cohort(n, fraction, seed=s, conns=conns_np,
                              publisher=pub, eclipse=adv.eclipse)
        cohorts[s] = (att, torch.as_tensor(att, device=dev))
        if faults.enabled:
            fm = fault_masks(n, faults, seed=s, publisher=pub)
            fmasks[s] = (fm, {k: torch.as_tensor(v, device=dev)
                              for k, v in fm.items()})
    if cfg.checkpoint_dir:
        for s in seeds:
            got = _try_resume(sim, cfg, fraction, s)
            if got is not None:
                state_by_seed[s], obs_by_seed[s] = got
                resumed.add(s)
    a = sim.arrays
    for s in seeds:
        if s in resumed:
            continue
        w = wall_by_seed[s]
        tw = time.perf_counter()
        _reset_trial(sim, s)
        tw = w.add("setup", tw)
        if not adv.cold_boot:
            sim.warmup()
        if adv.eclipse:
            sim.state = eclipse_setup(sim.state, a["conns"], cohorts[s][1],
                                      pub)
        tw = w.add("warmup", tw)
        st, obs, ctrl = _attack_window(
            sim, cfg, adv, cohorts[s][1],
            fmasks[s][1] if s in fmasks else None, steps, tel)
        state_by_seed[s] = st
        obs_by_seed[s] = _obs_to_host(obs)
        if ctrl is not None:
            ctrl_by_seed[s] = ctrl
        w.add("attack_window", tw)

    epoch_arrays = dict(sim.arrays)
    dht_on = cfg.dht.enabled and cfg.recovery_heartbeats > 0
    steps1, steps2 = _dht_legs(cfg.dht, cfg.recovery_heartbeats)
    out = []
    for s in seeds:
        w = wall_by_seed[s]
        att, att_j = cohorts[s]
        kad = None
        if dht_on:
            # the trial's DHT under the shared cohort (the same ids attack
            # both layers) and one shortlist per recovery leg; rebuilt on
            # resume, as the reference does (deterministic per seed)
            tw = time.perf_counter()
            kstate, directory = build_attacked_dht(
                n, seed=s, dht=cfg.dht, attacker=att, victim=pub,
                stage=sim._stage, lat_ms=sim._lat)
            pfrac = rtable_poison_frac(kstate, att)
            pool_a = pool_b = None
            if steps1 > 0:
                pool_a, kstate = dht_repair_pool(
                    kstate, cfg.dht, sim._stage, sim._lat, attacker=att_j,
                    directory=directory)
            if steps2 > 0:
                pool_b, kstate = dht_repair_pool(
                    kstate, cfg.dht, sim._stage, sim._lat, attacker=att_j,
                    directory=directory, healed=True)
            kad = (kstate, pool_a, pool_b, pfrac)
            w.add("dht_build", tw)
        base = _ensure_baseline(sim, cache, s, w)
        tw = time.perf_counter()
        _reset_trial(sim, s)
        sim.state = state_by_seed[s]
        tw = w.add("setup", tw)
        part_ms = None
        if faults.partition:
            # the partition window in sim ms, anchored on the post-window
            # clock (so a resumed trial gets it too): a window reaching
            # past the attack window stays open over the publishes
            t_win0 = float(sim.state.t_ms) - steps * hb_ms
            pws, pwe = faults.partition_window
            part_ms = (t_win0 + pws * hb_ms, t_win0 + pwe * hb_ms)
        if cfg.checkpoint_dir and s not in resumed:
            _save_trial(sim, cfg, fraction, s, obs_by_seed[s],
                        kad_state=kad[0] if kad is not None else None)
            tw = w.add("checkpoint_save", tw)
        obs_j = obs_by_seed[s]
        recovery_time_ms = -1.0
        if cfg.recovery_heartbeats > 0:
            # after the checkpoint, which hashes the epoch graph
            (st2, cn2, rv2, om2), robs = _recovery(
                sim, cfg, adv, att_j, pub, tel, ctrl_by_seed.get(s), kad)
            sim.state = st2
            tw = w.add("recovery_window", tw)
            if not graph_static:
                sim.rebind_graph(cn2, rv2, om2)
                tw = w.add("rebind_graph", tw)
            # the shared observables concatenate over attack + recovery
            obs_j = {k: (np.concatenate([np.asarray(obs_j[k]),
                                         np.asarray(robs[k])])
                         if k in robs else np.asarray(obs_j[k]))
                     for k in obs_j}
            if kad is not None:
                # a host channel, constant over the window, shaped as a
                # curve
                obs_j["rtable_poison_frac"] = np.full(
                    cfg.recovery_heartbeats, kad[3], np.float32)
            rec_ok = ((robs["attacker_mesh_share"]
                       <= cfg.mesh_recovery_share)
                      & (robs["pub_honest_degree"] >= 1.0))
            hit = np.nonzero(rec_ok)[0]
            if hit.size:
                recovery_time_ms = float((hit[0] + 1) * hb_ms)
        censor = censor_mask(att_j, sim.arrays["conns"])
        part_cross = None
        if part_ms is not None:
            # the cut over the current (possibly dialed) conns
            part_cross = partition_edge_mask(fmasks[s][1]["side"],
                                             sim.arrays["conns"])
        records = _publish_schedule(sim, censor=censor, attacker=att_j,
                                    adv=adv, cross=part_cross,
                                    partition_ms=part_ms)
        tw = w.add("publish", tw)
        honest = ~att
        cov, p50, p99 = _delivery_metrics(records, honest)
        heal_time_ms = -1.0
        reconv_hb = -1
        cov_part = -1.0
        if faults.partition:
            pwe = faults.partition_window[1]
            curve = np.asarray(obs_j.get("cross_mesh_edges", ()))
            if curve.size > pwe:
                hit = np.nonzero(curve[pwe:] > 0)[0]
                if hit.size:
                    heal_time_ms = float((hit[0] + 1) * hb_ms)
            side_np = fmasks[s][0]["side"]
            same_side = side_np == side_np[pub]
            cov_part = float((same_side & honest).sum()
                             / max(int(honest.sum()), 1))
        if faults.crash:
            cwe = faults.crash_window[1]
            curve = np.asarray(obs_j.get("restarted_mean_degree", ()))
            if curve.size > cwe:
                hit = np.nonzero(curve[cwe:] >= sim.params.d_low)[0]
                if hit.size:
                    reconv_hb = int(hit[0] + 1)
        engaged, gf_final, recovery, share_final = _obs_metrics(
            obs_j, cfg.mesh_recovery_share)
        cov90_hb = -1
        score_cross_hb = -1
        tel_cov = np.asarray(obs_j.get("tel_mesh_coverage", ()))
        if tel_cov.size:
            cov90_hb = _first_round(tel_cov, lambda c: c >= 0.9)
        tel_q = np.asarray(obs_j.get("tel_score_q", ()))
        if tel_q.size:
            med = tel_q[:, tel_q.shape[1] // 2]
            thr = float(sim.params.graylist_threshold)
            score_cross_hb = _first_round(med, lambda c: c < thr)
        # the final honest-side view of attacker edges over the current
        # (possibly dialed) conns
        cn_now = _host(sim.arrays["conns"])
        sc = _host(sim.state.score(sim.params)).astype(np.float64)
        att_edge = (cn_now >= 0) & att[np.clip(cn_now, 0, None)]
        h_att = att_edge & honest[:, None]
        score_final = float(sc[h_att].mean()) if h_att.any() else 0.0
        out.append(TrialResult(
            scenario=cfg.scenario, fraction=fraction, seed=s,
            attackers=int(att.sum()),
            honest_coverage=cov, benign_coverage=base["coverage"],
            latency_p50_ms=p50, latency_p99_ms=p99,
            benign_p50_ms=base["p50"],
            latency_inflation=(p50 / base["p50"]
                               if base["p50"] > 0 and math.isfinite(p50)
                               else math.inf),
            hb_to_graylist=engaged, hb_budget=budget,
            graylisted_frac_final=gf_final, mesh_recovery_hb=recovery,
            attacker_mesh_share_final=share_final,
            attacker_score_final=score_final,
            wall_s=(time.time() - t0) / len(seeds),
            mesh_evictions_total=int(_host(sim.state.evictions).sum()),
            px_grafts_total=int(_host(sim.state.px_grafts).sum()),
            redials_total=int(_host(sim.state.redials).sum()),
            recovery_time_ms=recovery_time_ms,
            bytes_tx_total=float(_host(sim.state.bytes_tx).sum()),
            heal_time_ms=heal_time_ms,
            post_churn_reconvergence_hb=reconv_hb,
            coverage_under_partition=cov_part,
            coverage90_hb=cov90_hb,
            score_cross_hb=score_cross_hb,
            rtable_poison_frac=(kad[3] if kad is not None else -1.0),
        ))
        if cfg.recovery_heartbeats > 0 and not graph_static:
            # restore the epoch graph for the next trial
            tw = time.perf_counter()
            sim.rebind_graph(epoch_arrays["conns"], epoch_arrays["rev"],
                             epoch_arrays["out_mask"])
            w.add("rebind_graph", tw)
        walls.append({"fraction": fraction, "seed": s,
                      "resumed": s in resumed, **w.t})
    return out


# ----------------------------------------------------------------- trial grid


@contextlib.contextmanager
def _grid_pool(trial_mesh):
    """The RankPool behind `trial_mesh`: the caller's own when it passes
    one (left open), else one opened over the grid for the call (its
    ranks start at the first grid cell) and closed after; None without a
    grid."""
    if trial_mesh is None or isinstance(trial_mesh, RankPool):
        yield trial_mesh
        return
    grid = check_trial_grid(trial_mesh)
    devices = grid.group_devices
    cpu_ranks = sum(d.type == "cpu" for d in devices)
    threads = (max(1, (os.cpu_count() or 1) // cpu_ranks) if cpu_ranks
               else None)
    with RankPool(devices, threads=threads) as pool:
        yield pool


def _deal(items: list, groups: int) -> list[list]:
    """Contiguous blocks of ceil(T/G) items per group, the reference's
    split of a column padded to a multiple of G by repeating its last
    item, with the padded repeats dropped (a group may get none)."""
    local = -(-len(items) // groups)
    return [list(items[g * local:(g + 1) * local]) for g in range(groups)]


def _rank_attacked_trials(payload, device):
    """One rank's block of an attacked cell on its own Simulator:
    (trials, phase walls)."""
    cfg, fraction, seeds, cache, budget = payload
    sim = Simulator(cfg.experiment, device=device)
    walls: list = []
    trials = _attacked_trials(sim, cfg, fraction, seeds, dict(cache), budget,
                              walls)
    return trials, walls


def _grid_attacked_trials(sim: Simulator, cfg: CampaignConfig,
                          fraction: float, seeds: list[int], cache: dict,
                          budget: float, walls: list, pool: RankPool,
                          deadline_s: float | None) -> list[TrialResult]:
    """An attacked cell dealt over the grid's ranks; the seeds' baselines
    are computed here first, once."""
    for s in seeds:
        _ensure_baseline(sim, cache, s)
    blocks = _deal(seeds, pool.size)
    outs = pool.run(_rank_attacked_trials, [
        (cfg, fraction, b, {s: cache[s] for s in b}, budget) if b else None
        for b in blocks], deadline_s=deadline_s)
    trials: list[TrialResult] = []
    for out in outs:
        if out is not None:
            trials.extend(out[0])
            walls.extend(out[1])
    return trials


def run_campaign(cfg: CampaignConfig, mesh=None, trial_mesh=None, dcn=None,
                 device=None) -> CampaignResult:
    """Execute the sweep: every (fraction, seed) cell, on `device` (CUDA
    unless the caller passes another).

    `trial_mesh`: a make_trial_mesh grid (or an open RankPool): an
    attacked fraction's seed column (with cfg.vmap_trials and more than
    one seed) is dealt over its rank processes (module doc). `dcn`: a
    make_dcn_mesh grid (or True for the default one) over a
    torch.distributed world; every process calls this on its seed slice
    and all return the merged result (_run_campaign_dcn). `mesh` (the
    peer mesh) raises NotImplementedError naming its slice."""
    if dcn is not None:
        if mesh is not None or trial_mesh is not None:
            raise ValueError(
                "dcn owns the full dcn x trials x peers grid; "
                "drop mesh/trial_mesh")
        return _run_campaign_dcn(cfg, dcn, device)
    if mesh is not None and trial_mesh is not None:
        raise ValueError(
            "pass either mesh (peer-axis sharding) or trial_mesh "
            "(trial-axis sharding), not both")
    if mesh is not None:
        raise peer_mesh_later("run_campaign(mesh=)")
    cfg.validate()
    with _grid_pool(trial_mesh) as pool:
        return _run_campaign(cfg, pool, device)


def _run_campaign(cfg: CampaignConfig, pool: RankPool | None,
                  device) -> CampaignResult:
    adv = cfg.adversary_params()
    t0 = time.time()
    sim = Simulator(cfg.experiment, device=device)
    budget = heartbeats_to_graylist(adv, sim.params)
    if ((adv.graft_flood or adv.ihave_spam or adv.iwant_spam)
            and not adv.identity_rotation
            and not adv.adaptive.enabled
            and any(f > 0 for f in cfg.fractions) and math.isinf(budget)):
        raise ValueError(
            "score defense cannot engage under this config "
            "(heartbeats_to_graylist is inf): raise |slow_peer_penalty_weight|"
            ", lower |graylist_threshold|, or raise the penalty/decay — "
            "attack_gossipsub() is the armed default")
    cache: dict[int, dict] = {}
    trials: list[TrialResult] = []
    walls: list[dict] = []
    sup = cfg.supervisor
    injector = _FailureInjector(sup.inject_failures)
    quarantined: list[dict] = []
    retries_total = 0
    # a failed attempt may die mid-recovery with a dialed graph bound
    graph_can_mutate = (cfg.recovery_heartbeats > 0
                        and (cfg.repair.px or cfg.repair.redial))
    epoch = dict(sim.arrays) if graph_can_mutate else None

    def _on_fail():
        if epoch is not None:
            sim.rebind_graph(epoch["conns"], epoch["rev"], epoch["out_mask"])

    def _on_grid(f: float, ss: list[int]) -> bool:
        return (f > 0.0 and pool is not None and pool.size > 1
                and cfg.vmap_trials and len(ss) > 1)

    def _cell(f: float, ss: list[int]) -> list[TrialResult]:
        if f == 0.0:
            return [_benign_trial(sim, cfg, s, cache, budget, walls)
                    for s in ss]
        if _on_grid(f, ss):
            # the trial timeout is the ranks' deadline: a watchdog thread
            # would abandon a job the ranks are still running
            return _grid_attacked_trials(
                sim, cfg, f, ss, cache, budget, walls, pool,
                sup.trial_timeout_s or None)
        if cfg.vmap_trials and len(ss) > 1:
            return _attacked_trials(sim, cfg, f, ss, cache, budget, walls)
        res: list[TrialResult] = []
        for s in ss:
            res.extend(_attacked_trials(sim, cfg, f, [s], cache, budget,
                                        walls))
        return res

    def _quarantine(f: float, ss: list[int], err) -> None:
        quarantined.append({
            "fraction": f, "seeds": list(ss),
            "failures": sup.max_retries + 1,
            "error": repr(err)[:500] if err is not None else "unknown",
        })

    for f in cfg.fractions:
        seeds = list(cfg.seeds)
        cell_sup = (replace(sup, trial_timeout_s=0.0) if _on_grid(f, seeds)
                    else sup)
        res, used, err = _supervise(
            cell_sup, injector, lambda f=f, ss=seeds: _cell(f, ss), _on_fail,
            device=sim.device)
        retries_total += used
        if res is not None:
            trials.extend(res)
            continue
        if len(seeds) == 1:
            _quarantine(f, seeds, err)
            continue
        # the batch is poisoned: isolate per seed so siblings survive
        for s in seeds:
            res1, used1, err1 = _supervise(
                sup, injector, lambda f=f, s=s: _cell(f, [s]), _on_fail,
                device=sim.device)
            retries_total += used1
            if res1 is not None:
                trials.extend(res1)
            else:
                _quarantine(f, [s], err1)
    conformance = (_campaign_conformance(cfg, adv, sim.device)
                   if cfg.conformance else None)
    return CampaignResult(
        scenario=cfg.scenario,
        network_size=sim.params.n,
        trials=trials,
        hb_budget=budget,
        wall_s=time.time() - t0,
        degraded=bool(quarantined) or retries_total > 0,
        quarantined_trials=quarantined,
        retries_total=retries_total,
        conformance=conformance,
        phase_walls=walls,
    )


# ----------------------------------------------------------------- DCN engine


DCN_RANK_FORMAT = 1
DCN_MERGED_BASENAME = "dcn_merged.json"
# how long one rank waits for its siblings' result files before declaring
# the group dead
_DCN_MERGE_TIMEOUT_S = float(os.environ.get("DCN_MERGE_TIMEOUT_S", "3600"))


def _dcn_rank_path(cfg: CampaignConfig, rank: int) -> str:
    return os.path.join(cfg.checkpoint_dir, f"dcn_rank{rank}.trials.json")


def merge_dcn_rank_results(cfg: CampaignConfig, payloads: list[dict],
                           wall_s: float | None = None) -> CampaignResult:
    """Fold per-rank DCN payloads into one CampaignResult, trials in the
    single-process order (cfg.fractions, then cfg.seeds). The rank set
    must be contiguous from 0 and every seed of cfg.seeds claimed by
    exactly one rank: a stale or overlapping rank file would double- or
    drop-count trials."""
    ranks = sorted(int(p["rank"]) for p in payloads)
    if ranks != list(range(len(payloads))):
        raise ValueError(f"rank set {ranks} is not contiguous from 0")
    by_rank = {int(p["rank"]): p for p in payloads}
    claimed: dict[int, int] = {}
    for p in payloads:
        for s in p["seeds"]:
            if int(s) in claimed:
                raise ValueError(
                    f"seed {s} claimed by ranks {claimed[int(s)]} "
                    f"and {p['rank']} — stale or overlapping rank files")
            claimed[int(s)] = int(p["rank"])
    missing = [int(s) for s in cfg.seeds if int(s) not in claimed]
    if missing:
        raise ValueError(f"seeds {missing} claimed by no rank")
    by_cell: dict[tuple[float, int], dict] = {}
    for p in payloads:
        for t in p["trials"]:
            by_cell[(float(t["fraction"]), int(t["seed"]))] = t
    trials = [TrialResult(**by_cell[(float(f), int(s))])
              for f in cfg.fractions for s in cfg.seeds
              if (float(f), int(s)) in by_cell]
    r0 = by_rank[0]
    hb = r0["hb_budget"]
    return CampaignResult(
        scenario=r0["scenario"],
        network_size=int(r0["network_size"]),
        trials=trials,
        # the writer nulled an infinite budget; restore it
        hb_budget=math.inf if hb is None else float(hb),
        wall_s=float(wall_s) if wall_s is not None
        else max(float(p["wall_s"]) for p in payloads),
        degraded=any(p["degraded"] for p in payloads),
        quarantined_trials=[q for p in payloads
                            for q in p["quarantined_trials"]],
        retries_total=sum(int(p["retries_total"]) for p in payloads),
        conformance=r0.get("conformance"),
    )


def _run_campaign_dcn(cfg: CampaignConfig, dcn_mesh,
                      device) -> CampaignResult:
    """One process's share of a multi-process campaign: the seed column
    round-robin (seeds[rank::nproc]) through run_campaign on this
    process's trial grid (supervision, checkpoints and quarantine stay
    process-local), its result written as a strict-JSON rank file, then
    one dcn_allreduce of the counts and the wall, which is also the
    barrier before every rank reads every file. All ranks return the
    merged result; rank 0 also writes it beside the rank files. The
    conformance certificate runs on rank 0 only and rides its file.
    Needs cfg.checkpoint_dir on a file system every process sees."""
    from ..parallel.sharding import (
        DCN_AXIS, dcn_allreduce, local_trial_submesh, make_dcn_mesh,
        process_count, process_index)

    if dcn_mesh is True:
        dcn_mesh = make_dcn_mesh()
    if DCN_AXIS not in getattr(dcn_mesh, "axis_names", ()):
        raise ValueError(
            "dcn expects a 3-level make_dcn_mesh grid (leading 'dcn' axis)")
    if not cfg.checkpoint_dir:
        raise ValueError(
            "DCN campaigns need cfg.checkpoint_dir: the rank-0 merge rides "
            "per-process rank files (and trial resume is the whole point "
            "of process-local supervision)")
    nproc = int(dcn_mesh.shape[DCN_AXIS])
    if nproc != process_count():
        raise ValueError(
            f"dcn axis size {nproc} != process_count {process_count()} "
            "— one DCN block per process is the placement contract")
    rank = process_index()
    if len(cfg.seeds) < nproc:
        raise ValueError(
            f"{len(cfg.seeds)} seeds over {nproc} processes leaves a rank "
            "idle; give every process at least one seed")
    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    # start fence: each rank clears its own stale file, then all meet
    try:
        os.remove(_dcn_rank_path(cfg, rank))
    except FileNotFoundError:
        pass
    dcn_allreduce(np.zeros(1, dtype=np.float32), op="sum")
    t0 = time.time()
    local_seeds = tuple(cfg.seeds)[rank::nproc]
    local_cfg = replace(cfg, seeds=local_seeds,
                        conformance=cfg.conformance and rank == 0)
    local = run_campaign(local_cfg, trial_mesh=local_trial_submesh(dcn_mesh),
                         device=device)
    payload = {
        "format_version": DCN_RANK_FORMAT,
        "rank": int(rank),
        "nproc": int(nproc),
        "seeds": [int(s) for s in local_seeds],
        "scenario": local.scenario,
        "network_size": int(local.network_size),
        "hb_budget": local.hb_budget,
        "wall_s": local.wall_s,
        "degraded": bool(local.degraded),
        "retries_total": int(local.retries_total),
        "quarantined_trials": list(local.quarantined_trials),
        "conformance": local.conformance,
        "trials": [t.to_dict() for t in local.trials],
    }
    path = _dcn_rank_path(cfg, rank)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(sanitize_nonfinite(payload), f, allow_nan=False,
                  sort_keys=True)
    os.replace(tmp, path)
    # poll for every sibling's file before the collective (a gloo
    # all-reduce spin-waits on stragglers); the start fence removed every
    # stale file, so existence is completion
    deadline = time.time() + _DCN_MERGE_TIMEOUT_S
    while not all(os.path.exists(_dcn_rank_path(cfg, r))
                  for r in range(nproc)):
        if time.time() > deadline:
            missing = [r for r in range(nproc)
                       if not os.path.exists(_dcn_rank_path(cfg, r))]
            raise RuntimeError(
                f"rank {rank}: ranks {missing} produced no result within "
                f"{_DCN_MERGE_TIMEOUT_S:.0f}s — sibling process dead?")
        time.sleep(0.05)
    agg = dcn_allreduce(
        np.array([len(local.trials), local.retries_total], dtype=np.float32),
        op="sum")
    wall = float(dcn_allreduce(
        np.array([time.time() - t0], dtype=np.float32), op="max")[0])
    payloads = []
    for r in range(nproc):
        with open(_dcn_rank_path(cfg, r)) as f:
            payloads.append(json.load(f))
    merged = merge_dcn_rank_results(cfg, payloads, wall_s=wall)
    # the file merge against the collective's counts: a mismatch means a
    # rank file of another run leaked in
    if (len(merged.trials), merged.retries_total) != (int(agg[0]),
                                                      int(agg[1])):
        raise RuntimeError(
            f"merge saw {len(merged.trials)} trials / "
            f"{merged.retries_total} retries but the DCN all-reduce "
            f"counted {int(agg[0])} / {int(agg[1])} — stale rank files?")
    if rank == 0:
        out = os.path.join(cfg.checkpoint_dir, DCN_MERGED_BASENAME)
        tmp = f"{out}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(merged.to_dict(), f, allow_nan=False, sort_keys=True,
                      indent=2)
        os.replace(tmp, out)
    return merged


def _campaign_conformance(cfg: CampaignConfig, adv: AdversaryParams,
                          device) -> dict:
    """Small-N conformance certificate for the campaign's scenario
    (CampaignConfig.conformance), its sim side on the campaign's device:
    the scenario differential, plus the adaptive-controller and
    fault-family differentials when the campaign arms them. Cost is one
    N=48 instance per entry, and the result rides the summary artifact via
    to_dict()."""
    from ..analysis.conformance import (certificate_entry, load_waivers,
                                        run_adaptive_differential,
                                        run_faults_differential,
                                        run_scenario_differential)

    waivers = load_waivers()
    meta = dict(seeds=[0], n=48, steps=8)
    entries = [certificate_entry(
        cfg.scenario, run_scenario_differential(cfg.scenario, device=device),
        waivers, **meta)]
    if adv.adaptive.enabled:
        entries.append(certificate_entry(
            "adaptive", run_adaptive_differential(cfg.scenario,
                                                  device=device),
            waivers, **meta))
    if cfg.faults.enabled:
        entries.append(certificate_entry(
            "faults", run_faults_differential(device=device), waivers,
            **meta))
    sim_bugs = sum(e["sim_bugs"] for e in entries)
    return {"entries": entries, "sim_bugs": sim_bugs,
            "clean": sim_bugs == 0}


# ------------------------------------------------------------ defense sweep


DEFENSE_OBJECTIVES = {
    "coverage": "max",
    "bandwidth_bytes": "min",
    "recovery_time_ms": "min",
}


def pareto_front(values, directions) -> np.ndarray:
    """Boolean non-domination mask over the rows of a (P, K) objective
    matrix, one "max"/"min" per column: row j is dominated when some row
    is at least as good on every objective and better on one."""
    v = np.asarray(values, dtype=np.float64)
    if v.ndim != 2 or v.shape[1] != len(directions):
        raise ValueError(
            f"values must be (P, {len(directions)}), got {v.shape}")
    v = v.copy()
    for k, d in enumerate(directions):
        if d == "min":
            v[:, k] = -v[:, k]
        elif d != "max":
            raise ValueError(f"direction {d!r} not in ('max', 'min')")
    ge = (v[:, None, :] >= v[None, :, :]).all(-1)
    gt = (v[:, None, :] > v[None, :, :]).any(-1)
    return ~(ge & gt).any(axis=0)


def _sweep_knobs(gs: GossipSubParams) -> tuple:
    return (gs.d_low, gs.d, gs.d_high, gs.slow_peer_penalty_weight)


def run_defense_sweep(cfg: CampaignConfig,
                      degree_grid: tuple = ((4, 6, 8), (6, 8, 12),
                                            (8, 12, 16)),
                      weight_grid: tuple = (-5.0, -10.0, -20.0),
                      trial_mesh=None, device=None) -> dict:
    """Race a grid of defense configurations (the mesh-degree band and the
    slow-peer penalty weight, the base config's own knobs always included)
    against the adaptive attacker: each point is a full run_campaign on
    `device`, aggregated over its attacked trials into coverage (mean
    honest delivery), bandwidth_bytes (mean bytes sent per trial) and
    recovery_time_ms (unrecovered trials charged the whole window).
    Returns the reference's strict-JSON artifact: the rows, the Pareto
    front, the default's index and the points that dominate it.
    `trial_mesh`: every point's campaign deals its attacked cells over
    this grid (one set of rank processes serves the whole sweep)."""
    adv = cfg.adversary_params()
    if not adv.adaptive.enabled:
        raise ValueError(
            "run_defense_sweep races the ADAPTIVE attacker: arm "
            "cfg.adversary.adaptive (a static-cohort Pareto sweep would "
            "understate every defense)")
    if cfg.recovery_heartbeats < 1:
        raise ValueError(
            "run_defense_sweep needs recovery_heartbeats >= 1: "
            "recovery_time_ms is a sweep objective")
    if not any(f > 0 for f in cfg.fractions):
        raise ValueError("run_defense_sweep needs an attacked fraction")
    base_gs = cfg.experiment.gossipsub
    points = [(dl, d, dh, w)
              for (dl, d, dh) in degree_grid for w in weight_grid]
    default_knobs = _sweep_knobs(base_gs)
    if default_knobs not in points:
        points.insert(0, default_knobs)
    default_index = points.index(default_knobs)
    t0 = time.time()
    rows = []
    with _grid_pool(trial_mesh) as pool:
        for dl, d, dh, w in points:
            gs = replace(base_gs, d_low=dl, d=d, d_high=dh,
                         slow_peer_penalty_weight=w,
                         d_score=None, d_out=None, d_lazy=None)
            # per-point checkpoints would collide on the same trial keys
            cfg_p = replace(cfg, experiment=replace(cfg.experiment,
                                                    gossipsub=gs),
                            checkpoint_dir=None)
            res = run_campaign(cfg_p, trial_mesh=pool, device=device)
            atk = [t for t in res.trials if t.fraction > 0.0]
            cap_ms = float((cfg.recovery_heartbeats + 1) * gs.heartbeat_ms)
            rec = [t.recovery_time_ms if t.recovery_time_ms >= 0.0
                   else cap_ms for t in atk]
            rows.append({
                "d_low": dl, "d": d, "d_high": dh,
                "slow_peer_penalty_weight": w,
                "is_default": (dl, d, dh, w) == default_knobs,
                "coverage": float(np.mean([t.honest_coverage for t in atk])),
                "bandwidth_bytes": float(np.mean(
                    [t.bytes_tx_total for t in atk])),
                "recovery_time_ms": float(np.mean(rec)),
                "recovered_frac": float(np.mean(
                    [t.recovery_time_ms >= 0.0 for t in atk])),
                "trials": len(atk),
                "degraded": res.degraded,
            })
    dirs = tuple(DEFENSE_OBJECTIVES.values())
    vals = np.array([[r[k] for k in DEFENSE_OBJECTIVES] for r in rows])
    front = pareto_front(vals, dirs)
    sign = np.array([-1.0 if d == "min" else 1.0 for d in dirs])
    sv = vals * sign
    dv = sv[default_index]
    beats = [i for i in range(len(rows))
             if i != default_index
             and bool((sv[i] >= dv).all() and (sv[i] > dv).any())]
    return sanitize_nonfinite({
        "scenario": cfg.scenario,
        "network_size": cfg.experiment.topo.network_size,
        "fractions": [f for f in cfg.fractions if f > 0.0],
        "seeds": list(cfg.seeds),
        "recovery_heartbeats": cfg.recovery_heartbeats,
        "objectives": dict(DEFENSE_OBJECTIVES),
        "configs": rows,
        "pareto": [i for i in range(len(rows)) if bool(front[i])],
        "default_index": default_index,
        "beats_default": beats,
        "wall_s": time.time() - t0,
    })


# ------------------------------------------------------------ protocol arena

# objective -> direction, in artifact column order: what a dissemination
# protocol exists to deliver (coverage, the two latency quantiles), what
# GossipSub's mesh redundancy spends on it (bandwidth, the axis a
# Topiary-style tree shrinks, arXiv:2312.06800) and how fast the protocol
# sheds the adaptive cohort. The win matrix scores each one per scenario.
ARENA_OBJECTIVES = {
    "coverage": "max",
    "bandwidth_bytes": "min",
    "latency_p50_ms": "min",
    "latency_p99_ms": "min",
    "recovery_time_ms": "min",
}

# relative gap under which an objective cell scores a tie
ARENA_REL_TOL = 1e-3


def _episub_windows(sim: Simulator, ep, attackers, states, ctrls, adv,
                    steps: int, faults=None, fmasks=None, telemetry=None):
    """The episub attack window for each trial, one after another (the
    reference's vmapped window over the stacked trials gives the same
    bytes): (states, ctrls, host obs dicts) in input order. An armed
    adaptive policy adds the attacker's controller to the carry, which
    the arena drops: it reads protocol state only and has no recovery
    legs. `faults` / `fmasks`: an armed FaultParams and each trial's
    cohorts as tensors."""
    from ..ops.episub import run_episub_faulted_heartbeats

    a = sim.arrays
    if faults is None:
        faults = FaultParams()
    out_s, out_c, out_o = [], [], []
    for j, (st, ct, att) in enumerate(zip(states, ctrls, attackers)):
        # with no fault armed this is the adaptive (or attacked) window
        m = (fmasks[j] if faults.enabled
             else dict.fromkeys(("crash", "side", "spike")))
        out, obs = run_episub_faulted_heartbeats(
            st, ct, a["conns"], a["rev"], a["out_mask"], att, sim.params,
            ep, adv, faults, m["crash"], m["side"], m["spike"], steps,
            telemetry=telemetry)
        out_s.append(out[0])
        out_c.append(out[1])
        out_o.append(_obs_to_host(obs))
    return out_s, out_c, out_o


def _episub_publish(sim: Simulator, ctrl, ep, censor=None, attacker=None,
                    adv=None, cross=None, partition_ms=None):
    """_publish_schedule with episub heartbeats between messages
    (Simulator.advance would re-form GossipSub's mesh mid-trial). The
    fractional-heartbeat carry is local, as in the reference, so the
    Simulator's own carry stays 0 and each publish starts at state.t_ms.
    Returns (records, ctrl)."""
    from ..ops.episub import run_episub_heartbeats
    from .simulator import drain_heartbeat_carry

    a = sim.arrays
    carry_ms = 0.0

    def advance(ms: float) -> None:
        nonlocal carry_ms, ctrl
        steps, carry_ms = drain_heartbeat_carry(carry_ms, ms,
                                                sim.params.heartbeat_ms)
        if steps > 0:
            sim.state, ctrl = run_episub_heartbeats(
                sim.state, ctrl, a["conns"], a["rev"], a["out_mask"],
                sim.params, ep, steps)

    records = _publish_schedule(sim, censor=censor, attacker=attacker,
                                adv=adv, cross=cross,
                                partition_ms=partition_ms, advance=advance)
    return records, ctrl


def _cohort_sha(att: np.ndarray) -> str:
    """sha256 of the packed attacker-cohort bitmask: the per-cell identity
    that shows both protocols faced the same node ids."""
    import hashlib

    return hashlib.sha256(
        np.packbits(np.asarray(att, dtype=bool)).tobytes()).hexdigest()


def _arena_recovery_ms(obs: dict, floor: float, hb_ms: float,
                       cap_ms: float) -> float:
    """Recovery read off the attack window's attacker_mesh_share curve: 0.0
    when the share never exceeds the floor, else the first return below
    it after the peak, an unrecovered window charged `cap_ms`."""
    share = np.asarray(obs["attacker_mesh_share"], dtype=np.float64)
    if share.size == 0 or share.max() <= floor:
        return 0.0
    peak = int(np.argmax(share))
    rel = _first_round(share[peak:], lambda c: c <= floor)
    return float((peak + rel) * hb_ms) if rel > 0 else cap_ms


def _arena_obs_extras(spec_observables, obs_j) -> dict:
    """Final-round values of the shared attack channels and of the
    protocol's own observables (ProtocolSpec.observables)."""
    out: dict = {}
    if obs_j is None:
        return out
    for k in ("graylisted_frac", "attacker_mesh_share") + tuple(
            spec_observables):
        if k in obs_j:
            v = np.asarray(obs_j[k], dtype=np.float64)
            if v.size:
                out[k + "_final"] = float(v[-1])
    return out


def _arena_rows(sim: Simulator, cfg: CampaignConfig, sc: str,
                seeds: list[int], fraction: float, ep, tel):
    """One scenario's arena cells for `seeds` on `sim`: (GossipSub rows,
    episub rows, {seed: cohort sha}), each row list in seed order."""
    from ..ops.episub import init_episub_ctrl, run_episub_heartbeats
    from ..ops.protocol import get_protocol

    adv0 = cfg.adversary_params()
    protos = ("gossipsub", "episub")
    gspec, espec = get_protocol(protos[0]), get_protocol(protos[1])
    dev = sim.device
    n = sim.params.n
    hb_ms = sim.params.heartbeat_ms
    pub = cfg.experiment.publisher_id % n
    conns_np = np.asarray(sim.graph.conns)
    warm_steps = int(cfg.experiment.warmup_s * 1000.0 // hb_ms)
    steps = cfg.attack_heartbeats
    cap_ms = float((steps + 1) * hb_ms)
    faulted = cfg.faults.enabled
    a = sim.arrays
    benign = sc == "benign"
    adv = (adv0 if benign or sc == cfg.scenario
           else replace(adv0, scenario=sc))
    cohorts, shas = {}, {}
    for s in seeds:
        att = (np.zeros(n, dtype=bool) if benign else attacker_cohort(
            n, fraction, seed=s, conns=conns_np, publisher=pub,
            eclipse=adv.eclipse))
        cohorts[s] = (att, torch.as_tensor(att, device=dev))
        shas[str(s)] = _cohort_sha(att)
    fmasks = None
    if faulted and not benign:
        fmasks = {s: {k: torch.as_tensor(v, device=dev)
                      for k, v in fault_masks(n, cfg.faults, seed=s,
                                              publisher=pub).items()}
                  for s in seeds}

    def _finish(s, obs_j, spec_obs, records):
        att, _ = cohorts[s]
        cov, p50, p99 = _delivery_metrics(records, ~att)
        rec_ms = (0.0 if obs_j is None else _arena_recovery_ms(
            obs_j, cfg.mesh_recovery_share, hb_ms, cap_ms))
        return {
            "seed": s, "attackers": int(att.sum()),
            "coverage": cov,
            "bandwidth_bytes": float(_host(sim.state.bytes_tx).sum()),
            "latency_p50_ms": p50, "latency_p99_ms": p99,
            "recovery_time_ms": rec_ms,
            "cohort_sha256": shas[str(s)],
            **_arena_obs_extras(spec_obs, obs_j),
        }

    def _part_ctx(s):
        # a partition still open folds into the publish masks, anchored
        # as in _attacked_trials
        if not (faulted and not benign and cfg.faults.partition):
            return None, None
        t_win0 = float(sim.state.t_ms) - steps * hb_ms
        pws, pwe = cfg.faults.partition_window
        part_ms = (t_win0 + pws * hb_ms, t_win0 + pwe * hb_ms)
        return partition_edge_mask(fmasks[s]["side"],
                                   a["conns"]), part_ms

    def _censor(s):
        return None if benign else censor_mask(cohorts[s][1], a["conns"])

    # ---- GossipSub: the registry's runners
    g_out, g_obs = [], []
    for s in seeds:
        _reset_trial(sim, s)
        sim.warmup()
        if not benign and adv.eclipse:
            sim.state = eclipse_setup(sim.state, a["conns"],
                                      cohorts[s][1], pub)
        if benign:
            g_out.append(gspec.run_heartbeats(
                sim.state, a["conns"], a["rev"], a["out_mask"],
                sim.params, steps))
            g_obs.append(None)
        else:
            st, obs, _ = _attack_window(
                sim, cfg, adv, cohorts[s][1],
                fmasks[s] if fmasks else None, steps, tel)
            g_out.append(st)
            g_obs.append(_obs_to_host(obs))
    g_rows = []
    for j, s in enumerate(seeds):
        _reset_trial(sim, s)
        sim.state = g_out[j]
        cross, part_ms = _part_ctx(s)
        records = _publish_schedule(
            sim, censor=_censor(s),
            attacker=None if benign else cohorts[s][1],
            adv=None if benign else adv, cross=cross,
            partition_ms=part_ms)
        g_rows.append({"scenario": sc, "protocol": protos[0],
                       **_finish(s, g_obs[j], gspec.observables, records)})

    # ---- episub: the same cells, cohorts and fault masks
    e_states, e_ctrls = [], []
    for s in seeds:
        _reset_trial(sim, s)
        ctrl = init_episub_ctrl(n, dev)
        if warm_steps > 0:
            sim.state, ctrl = run_episub_heartbeats(
                sim.state, ctrl, a["conns"], a["rev"], a["out_mask"],
                sim.params, ep, warm_steps)
        if not benign and adv.eclipse:
            sim.state = eclipse_setup(sim.state, a["conns"],
                                      cohorts[s][1], pub)
        e_states.append(sim.state)
        e_ctrls.append(ctrl)
    if benign:
        e_out, e_cout, e_obs = [], [], [None] * len(seeds)
        for st, ct in zip(e_states, e_ctrls):
            st2, ct2 = run_episub_heartbeats(
                st, ct, a["conns"], a["rev"], a["out_mask"], sim.params,
                ep, steps)
            e_out.append(st2)
            e_cout.append(ct2)
    else:
        e_out, e_cout, e_obs = _episub_windows(
            sim, ep, [cohorts[s][1] for s in seeds], e_states, e_ctrls,
            adv, steps, faults=cfg.faults if faulted else None,
            fmasks=[fmasks[s] for s in seeds] if faulted else None,
            telemetry=tel)
    e_rows = []
    for j, s in enumerate(seeds):
        _reset_trial(sim, s)
        sim.state = e_out[j]
        cross, part_ms = _part_ctx(s)
        records, _ = _episub_publish(
            sim, e_cout[j], ep, censor=_censor(s),
            attacker=None if benign else cohorts[s][1],
            adv=None if benign else adv, cross=cross,
            partition_ms=part_ms)
        e_rows.append({"scenario": sc, "protocol": protos[1],
                       **_finish(s, e_obs[j], espec.observables, records)})
    return g_rows, e_rows, shas


def _rank_arena_rows(payload, device):
    """One rank's block of an arena scenario on its own Simulator."""
    cfg, sc, seeds, fraction, ep, tel = payload
    sim = Simulator(cfg.experiment, device=device)
    return _arena_rows(sim, cfg, sc, seeds, fraction, ep, tel)


def run_arena_campaign(cfg: CampaignConfig, scenarios=None, ep=None,
                       trial_mesh=None, device=None) -> dict:
    """The protocol arena, on `device` (CUDA unless the caller passes
    another): GossipSub and episub race on the same inputs, and the
    artifact scores who wins each objective per scenario.

    Per (scenario, seed) cell both protocols get one Simulator's graph,
    the same attacker cohort (its sha256 recorded per cell), the same
    fault cohorts and the experiment's traffic schedule, with
    flood_publish off: every publish rides mesh_mask, GossipSub's mesh or
    episub's tree. The episub side warms up and advances between messages
    with episub heartbeats. "benign" is the reserved no-attacker row; an
    attack scenario needs the adaptive attacker armed. No repair and no
    recovery window: recovery_time_ms is read off the attack window's
    attacker_mesh_share curve. `trial_mesh`: an attack scenario's seeds
    (more than one) are dealt over the grid's rank processes, each
    running its block's cells of both protocols; the benign row stays in
    the caller, as in the reference. Returns the reference's strict-JSON
    dict: per-trial rows, per-(scenario, protocol) rows, the win matrix
    and the identity block."""
    from ..ops.episub import EpisubParams
    from .checkpoint import _graph_hash

    cfg.validate()
    adv0 = cfg.adversary_params()
    if cfg.experiment.gossipsub.flood_publish:
        raise ValueError(
            "the arena requires flood_publish=False: flood publish routes "
            "traffic around mesh_mask, the one surface the two protocols "
            "differ on — the race would measure nothing")
    fracs = [f for f in cfg.fractions if f > 0.0]
    if not fracs:
        raise ValueError(
            "the arena needs an attacked fraction (> 0); the benign row "
            "is the reserved 'benign' scenario, not a 0.0 fraction")
    fraction = fracs[0]
    if scenarios is None:
        scenarios = ("benign", cfg.scenario)
    scenarios = tuple(scenarios)
    if any(s != "benign" for s in scenarios) and not adv0.adaptive.enabled:
        raise ValueError(
            "arena attack scenarios require cfg.adversary.adaptive armed: "
            "the adaptive attacker is the referee both protocols face")
    protos = ("gossipsub", "episub")
    sim = Simulator(cfg.experiment, device=device)
    n = sim.params.n
    pub = cfg.experiment.publisher_id % n
    steps = cfg.attack_heartbeats
    if ep is None:
        # the tree roots at the publisher, the way the traffic flows
        ep = EpisubParams(root=pub)
    tel = cfg.telemetry if cfg.telemetry.enabled else None
    seeds = list(cfg.seeds)
    t0 = time.time()
    trials: list[dict] = []
    cohort_shas: dict = {}

    with _grid_pool(trial_mesh) as pool:
        for sc in scenarios:
            if (sc != "benign" and pool is not None and pool.size > 1
                    and len(seeds) > 1):
                blocks = _deal(seeds, pool.size)
                outs = [o for o in pool.run(_rank_arena_rows, [
                    (cfg, sc, b, fraction, ep, tel) if b else None
                    for b in blocks]) if o is not None]
                g_rows = [r for o in outs for r in o[0]]
                e_rows = [r for o in outs for r in o[1]]
                shas = {k: v for o in outs for k, v in o[2].items()}
            else:
                g_rows, e_rows, shas = _arena_rows(sim, cfg, sc, seeds,
                                                   fraction, ep, tel)
            cohort_shas[sc] = shas
            trials.extend(g_rows + e_rows)

    # ---- aggregates and the win matrix
    rows = []
    for sc in scenarios:
        for p in protos:
            cell = [t for t in trials
                    if t["scenario"] == sc and t["protocol"] == p]
            rows.append({
                "scenario": sc, "protocol": p, "trials": len(cell),
                **{k: float(np.mean([t[k] for t in cell]))
                   for k in ARENA_OBJECTIVES},
            })
    wins: dict = {}
    win_counts = {p: 0 for p in protos}
    ties = 0
    for sc in scenarios:
        by_p = {r["protocol"]: r for r in rows if r["scenario"] == sc}
        wsc = {}
        for k, d in ARENA_OBJECTIVES.items():
            va, vb = by_p[protos[0]][k], by_p[protos[1]][k]
            if ((math.isinf(va) and math.isinf(vb))
                    or bool(np.isclose(va, vb, rtol=ARENA_REL_TOL,
                                       atol=0.0))):
                wsc[k] = "tie"
                ties += 1
                continue
            w = protos[0] if ((va > vb) if d == "max" else (va < vb)) \
                else protos[1]
            wsc[k] = w
            win_counts[w] += 1
        wins[sc] = wsc

    return sanitize_nonfinite({
        "protocols": list(protos),
        "scenarios": list(scenarios),
        "network_size": n,
        "fraction": fraction,
        "seeds": seeds,
        "attack_heartbeats": steps,
        "objectives": dict(ARENA_OBJECTIVES),
        "identity": {
            "graph_sha256": _graph_hash(sim.graph),
            "publisher": pub,
            "cohort_sha256": cohort_shas,
            "flood_publish": False,
            "episub_root": ep.root,
        },
        "trials": trials,
        "rows": rows,
        "wins": wins,
        "win_counts": win_counts,
        "ties": ties,
        "wall_s": time.time() - t0,
    })
