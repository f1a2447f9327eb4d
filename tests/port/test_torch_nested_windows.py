"""The nested windows (runtime/campaign.sharded_attack_window,
sharded_faulted_window, sharded_recovery_window,
sharded_dht_recovery_window, sharded_episub_window) and run_fused_rounds
on a 2 x 2 CPU grid (tests/port/conftest.py's cpu_grid: two trial groups
of two gloo ranks, each trial's peer rows split over its group) against
the reference's vmapped single-device windows, bitwise on every state
leaf, carry, graph, pool and observable (no tolerance: the port sums
floats over all rows in one place, so the split cannot reassociate them):

  - four stacked trials at attacker fractions 0 and 0.2, the flight
    recorder armed, scores at inexact weights: the adaptive attack
    window (tests/test_adaptive.py:204, tests/test_telemetry.py:207),
    the fault-armed window, the recovery window (evict + px + redial),
    both legs of the DHT window (the second from the first's stacked
    dialed graphs and pools) and the adaptive episub window
    (tests/test_episub.py:131); the attack and recovery windows with
    nested=True and nested=False (each trial whole on its group's first
    rank, the reference's replicated submesh, tests/test_trial_sharding.
    py:275) both equal;
  - run_fused_rounds over the grid against the reference's vmapped fused
    chain (tests/test_fused_rounds.py:212);
  - the nested placers: a stacked batch's blocks per rank, and the
    padding of a batch to the group count.

The reference's own nested windows need GSPMD's peer-sharded programs,
which fail on the pinned jax; its vmapped single-device windows are what
it pins them to. The ranks' jobs live in tests/port/peer_jobs.py and
runtime/campaign.py (no JAX import in a rank)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import Topology, TopoParams
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import disseminate as jd
from dst_libp2p_test_node_tpu.ops import episub as jep
from dst_libp2p_test_node_tpu.ops import faults as jf
from dst_libp2p_test_node_tpu.ops import heartbeat as jhb
from dst_libp2p_test_node_tpu.ops import repair as jrep
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops import telemetry as jtel
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import dht_adversary as tdht
from dst_libp2p_test_node_tpu_torch.ops import episub as tep
from dst_libp2p_test_node_tpu_torch.ops import faults as tf
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.ops import telemetry as ttel
from dst_libp2p_test_node_tpu_torch.parallel import sharding as tsh
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc

import peer_jobs

torch.set_num_threads(1)

N = 64
TRIALS = 4
LOCAL = TRIALS // 2
STEPS = 4
PUB = 4
# inexact weights, so the observables' score contraction shows
WEIGHTS = dict(fmd_weight=0.7, slow_weight=-3.3, slow_decay=0.93,
               graylist_threshold=-50.0, gossip_threshold=-10.0,
               publish_threshold=-20.0)
REPAIR = dict(evict=True, px=True, redial=True)
FAULTS = dict(crash_frac=0.1, crash_window=(1, 3), partition_frac=0.5,
              partition_window=(1, 3), spike_frac=0.1, spike_window=(0, 2),
              spike_ms=30.0)
FRACTIONS = (0.0, 0.2)
DHT = dict(lookup_eclipse=True, rtable_poison=True, heal_hb=2,
           warmup_waves=1, lookup_rounds=2)
# vmapped reference programs, built once per (window, nested) so both
# fractions reuse the compile
_JIT: dict = {}


def _flat(tree, prefix="") -> dict:
    """{path: numpy array} of a tree of either package, PRNG and node keys
    as uint32 words; None leaves dropped."""
    if tree is None:
        return {}
    if isinstance(tree, (torch.Tensor, np.ndarray, jax.Array)):
        a = (tree.numpy() if isinstance(tree, torch.Tensor)
             else np.asarray(tree))
        if prefix.rsplit("/", 1)[-1] in ("key", "keys"):
            a = a.astype(np.uint32)
        return {prefix: a}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        items = ((f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _assert_same(want, got):
    fw, fg = _flat(want), _flat(got)
    assert sorted(fw) == sorted(fg)
    assert interop.leaf_mismatches(fw, fg) == []


def _stack_j(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def _unstack_j(tree, j):
    return jax.tree_util.tree_map(lambda x: x[j], tree)


def _stack_t(trees):
    return tsh.tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


@pytest.fixture(scope="module")
def world():
    g = build_connection_graph(N, 8, seed=1, max_degree=40)
    out = {}
    for name, extra in (("attack", {}), ("repair", REPAIR)):
        out[name] = (jst.SimParams(n=N, capacity=g.capacity, **WEIGHTS,
                                   **extra),
                     tst.SimParams(n=N, capacity=g.capacity, **WEIGHTS,
                                   **extra))
    pj = out["attack"][0]
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    states = [jhb.run_heartbeats(jst.init_state(pj, s), aj["conns"],
                                 aj["rev"], aj["out_mask"], pj, 6)
              for s in range(TRIALS)]
    rng = np.random.default_rng(7)
    states = [s.replace(slow_penalty=jnp.asarray(
        rng.uniform(0, 2, s.slow_penalty.shape).astype(np.float32)))
        for s in states]
    topo = Topology.build(TopoParams(
        network_size=N, anchor_stages=3, min_bandwidth=50,
        max_bandwidth=150, min_latency=40, max_latency=130))
    out.update(
        aj=aj, at=at, sj=_stack_j(states),
        st=_stack_t([interop.state_from_numpy(
            {k: np.asarray(v) for k, v in
             ((f.name, getattr(s, f.name)) for f in dataclasses.fields(s))},
            "cpu") for s in states]),
        topo=topo)
    return out


def _cohorts(fraction):
    att = np.stack([jadv.attacker_cohort(N, fraction, seed=s, publisher=PUB)
                    for s in range(TRIALS)])
    return jnp.asarray(att), torch.from_numpy(att)


def _vmapped(name, fn):
    if name not in _JIT:
        _JIT[name] = jax.jit(jax.vmap(fn))
    return _JIT[name]


def _adv(mod):
    return mod.AdversaryParams(scenario="sybil_graft_flood",
                               adaptive=mod.AdaptivePolicy(enabled=True))


def test_attack_window_nested_and_replicated(world, cpu_grid):
    pj, pt = world["attack"]
    aj, at = world["aj"], world["at"]
    tel_j = jtel.TelemetryParams(record=True)

    def one(s, a):
        return jadv.run_adaptive_heartbeats(
            s, aj["conns"], aj["rev"], aj["out_mask"], a, pj, _adv(jadv),
            STEPS, batch_factor=TRIALS, telemetry=tel_j)

    for fraction in FRACTIONS:
        att_j, att_t = _cohorts(fraction)
        want = _vmapped("attack", one)(world["sj"], att_j)
        for nested in (True, False):
            got = tc.sharded_attack_window(
                world["st"], at, att_t, pt, _adv(tadv), STEPS, cpu_grid,
                LOCAL, nested=nested,
                telemetry=ttel.TelemetryParams(record=True))
            _assert_same(want, got)
        (_, ctrl), obs = got
        assert tuple(ctrl.regrafts.shape) == (TRIALS, N)
        assert "tel_score_q" in obs and "adv_regraft_attempts" in obs
        assert bool(ctrl.regrafts.any()) == (fraction > 0)


def test_faulted_window(world, cpu_grid):
    pj, pt = world["repair"]
    aj, at = world["aj"], world["at"]
    fm = [jf.fault_masks(N, jf.FaultParams(**FAULTS), seed=s, publisher=PUB)
          for s in range(TRIALS)]
    masks = [np.stack([m[k] for m in fm]) for k in ("crash", "side",
                                                     "spike")]

    def one(s, a, cr, sd, sp):
        return jf.run_faulted_heartbeats(
            s, aj["conns"], aj["rev"], aj["out_mask"], a, pj, _adv(jadv),
            jf.FaultParams(**FAULTS), cr, sd, sp, STEPS,
            batch_factor=TRIALS)

    for fraction in FRACTIONS:
        att_j, att_t = _cohorts(fraction)
        want = _vmapped("faulted", one)(
            world["sj"], att_j, *(jnp.asarray(m) for m in masks))
        got = tc.sharded_faulted_window(
            world["st"], at, att_t, *(torch.from_numpy(m) for m in masks),
            pt, _adv(tadv), tf.FaultParams(**FAULTS), STEPS, cpu_grid,
            LOCAL)
        _assert_same(want, got)
        assert {"cross_mesh_edges", "restarted_mean_degree"} <= set(got[1])


def test_recovery_window_nested_and_replicated(world, cpu_grid):
    pj, pt = world["repair"]
    aj, at = world["aj"], world["at"]

    def one(s, a):
        return jrep.run_recovery_heartbeats(
            s, aj["conns"], aj["rev"], aj["out_mask"], a, pj, STEPS,
            publisher=PUB, batch_factor=TRIALS,
            telemetry=jtel.TelemetryParams(record=True))

    for fraction in FRACTIONS:
        att_j, att_t = _cohorts(fraction)
        want = _vmapped("recovery", one)(world["sj"], att_j)
        for nested in (True, False):
            got = tc.sharded_recovery_window(
                world["st"], at, att_t, pt, STEPS, PUB, cpu_grid, LOCAL,
                nested=nested, telemetry=ttel.TelemetryParams(record=True))
            _assert_same(want, got)
        (state, conns, _, _), obs = got
        # dials committed across the row blocks: the graph grew
        assert int(state.redials.sum()) > 0
        assert (int((conns >= 0).sum())
                > int((at["conns"] >= 0).sum()) * TRIALS)
        assert "pub_honest_degree" in obs


def test_dht_recovery_window_both_legs(world, cpu_grid):
    pj, pt = world["repair"]
    aj, at = world["aj"], world["at"]
    topo = world["topo"]
    # the shortlists from the port's DHT build (held against the
    # reference's in tests/port/test_torch_dht_adversary.py)
    stage = torch.as_tensor(topo.stage_of_peer)
    lat = torch.as_tensor(topo.latency_ms)
    dht = tdht.DhtAdversaryParams(**DHT)

    def leg1(s, a, p):
        return jrep.run_dht_recovery_heartbeats(
            s, aj["conns"], aj["rev"], aj["out_mask"], a, pj, 2, dht_pool=p,
            publisher=PUB, batch_factor=TRIALS,
            telemetry=jtel.TelemetryParams(record=True))

    def leg2(s, a, p, cn, rv, om):
        return jrep.run_dht_recovery_heartbeats(
            s, cn, rv, om, a, pj, 2, dht_pool=p, publisher=PUB,
            batch_factor=TRIALS)

    for fraction in FRACTIONS:
        att_j, att_t = _cohorts(fraction)
        pools = []
        for s in range(TRIALS):
            ks, d = tdht.build_attacked_dht(
                N, seed=s, dht=dht, attacker=att_t[s].numpy(), victim=PUB,
                stage=stage, lat_ms=lat)
            pools.append(tdht.dht_repair_pool(
                ks, dht, stage, lat, attacker=att_t[s], directory=d)[0])
        pools = torch.stack(pools)
        want1 = _vmapped("dht1", leg1)(world["sj"], att_j,
                                       jnp.asarray(pools.numpy()))
        got1 = tc.sharded_dht_recovery_window(
            world["st"], at, None, att_t, pools, pt, 2, PUB, cpu_grid,
            LOCAL, telemetry=ttel.TelemetryParams(record=True))
        _assert_same(want1, got1)
        (sj, cj, rj, oj, pj2), _ = want1
        want2 = _vmapped("dht2", leg2)(sj, att_j, pj2, cj, rj, oj)
        (st, ct, rt, ot, pt2), _ = got1
        got2 = tc.sharded_dht_recovery_window(
            st, None, (ct, rt, ot), att_t, pt2, pt, 2, PUB, cpu_grid, LOCAL)
        _assert_same(want2, got2)
        # trial j of the stacked output is trial j's own window
        j = TRIALS - 1
        _assert_same(_unstack_j(want2, j), tc._unstack_trial(got2, j))
        assert {"dht_pool_left", "starve_max"} <= set(got2[1])


def test_episub_window(world, cpu_grid):
    pj, pt = world["attack"]
    aj, at = world["aj"], world["at"]
    cj = _stack_j([jep.init_episub_ctrl(N) for _ in range(TRIALS)])
    ct = _stack_t([tep.init_episub_ctrl(N, "cpu") for _ in range(TRIALS)])

    def one(s, c, a):
        return jep.run_episub_adaptive_heartbeats(
            s, c, aj["conns"], aj["rev"], aj["out_mask"], a, pj,
            jep.EpisubParams(root=PUB), _adv(jadv), STEPS,
            batch_factor=TRIALS, telemetry=jtel.TelemetryParams(record=True))

    for fraction in FRACTIONS:
        att_j, att_t = _cohorts(fraction)
        want = _vmapped("episub", one)(world["sj"], cj, att_j)
        got = tc.sharded_episub_window(
            world["st"], ct, at, att_t, pt, tep.EpisubParams(root=PUB),
            _adv(tadv), STEPS, cpu_grid, LOCAL,
            telemetry=ttel.TelemetryParams(record=True))
        _assert_same(want, got)
        assert {"tree_reach_frac", "tree_depth_mean"} <= set(got[1])


def test_fused_rounds_over_the_grid(world, cpu_grid):
    pj, pt = world["attack"]
    aj, at = world["aj"], world["at"]
    topo = world["topo"]
    pubs = [3, 9, 17]
    host = (topo.stage_of_peer, topo.latency_ms, topo.bw_up_mbit)
    tj = tuple(jnp.asarray(x) for x in host)
    fused_j = dataclasses.replace(pj, fused_rounds=True)
    fused_t = dataclasses.replace(pt, fused_rounds=True)

    def go(s):
        head, res, _ = jd.run_fused_rounds(
            s, aj["conns"], aj["rev"], tj[0], tj[1], tj[2], aj["out_mask"],
            pubs, fused_j, 15_000, 2)
        return head, res

    want = jax.jit(jax.vmap(go))(world["sj"])
    shared = dict(at, stage=torch.as_tensor(host[0]),
                  lat=torch.as_tensor(host[1]), bw=torch.as_tensor(host[2]))
    body = partial(peer_jobs.fused_chain, fused_t, 15_000, 2, pubs)
    head, (res, obs) = tc._run_nested_window(
        body, cpu_grid, N, (world["st"],), shared)
    assert obs == {}
    # a rank's exact engine is the receiver-side serial one (the mesh's
    # fixpoint), whose pass count is its own: every output is bitwise,
    # refine_passes is the route's counter
    want = (want[0], dataclasses.replace(want[1], refine_passes=None))
    _assert_same(want, (head, dataclasses.replace(res, refine_passes=None)))
    assert bool(res.received.any()) and bool(res.converged.all())


def test_nested_placers_and_padding(cpu_grid):
    grid = tsh.make_trial_mesh(2, devices=["cpu"] * 4)
    assert tsh.grid_shape(grid) == tsh.grid_shape(cpu_grid) == (2, 2)
    batch = {"rows": np.arange(4 * 8).reshape(4, 8), "clock": np.arange(4)}
    placed = tsh.place_trial_batch(batch, {"conns": np.arange(8),
                                           "lat": np.ones((3, 3))},
                                   grid, n_rows=8)
    # rank g*2 + p: trial block g, row block p
    assert [p[0]["rows"].tolist() for p in placed] == [
        [[0, 1, 2, 3], [8, 9, 10, 11]], [[4, 5, 6, 7], [12, 13, 14, 15]],
        [[16, 17, 18, 19], [24, 25, 26, 27]],
        [[20, 21, 22, 23], [28, 29, 30, 31]]]
    assert [p[0]["clock"].tolist() for p in placed] == [[0, 1], [0, 1],
                                                        [2, 3], [2, 3]]
    assert [p[1]["conns"].tolist() for p in placed] == [
        [0, 1, 2, 3], [4, 5, 6, 7]] * 2
    assert all(p[1]["lat"].shape == (3, 3) for p in placed)
    # the trial-only layout: every row of the block, the shared whole
    flat = tsh.place_trial_batch(batch, {"conns": np.arange(8)}, grid)
    assert [p[0]["rows"].shape for p in flat] == [(2, 8)] * 4
    assert all(p[1]["conns"].shape == (8,) for p in flat)
    assert tsh.nested_batch_shardings(batch, grid, 8) == {
        "rows": tsh.nested_sharding(grid),
        "clock": tsh.trial_sharding(grid)}
    assert [x.tolist() for x in tsh.peer_submesh_sharding(grid).split(
        np.arange(4))] == [[0, 1], [2, 3]] * 2
    states, atts, extras, local = tc._pad_to_groups(
        [1, 2, 3], ["a", "b", "c"], grid, extras=[7, 8, 9])
    assert (states, atts, extras, local) == ([1, 2, 3, 3],
                                             ["a", "b", "c", "c"],
                                             [7, 8, 9, 9], 2)
    assert tc._nested_batch_factor(grid, 3) == 2
    with pytest.raises(ValueError, match="divide evenly"):
        tsh.nested_sharding(grid).split(np.zeros((3, 8)))
