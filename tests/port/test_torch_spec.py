"""The port's executable GossipSub v1.1 model (ops/spec.py) against the
reference's, on seeded numpy states, bitwise: every transition (the
heartbeat with churn, eviction, PX and opportunistic grafting armed, so
the selection oracle's threefry draws run; the eight attack rounds; the
adaptive controller; censorship; the eclipse; the fault transforms), the
score law, the og tie policy both ways, and host_state of a state held by
each engine."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import spec as jspec
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.ops.heartbeat import run_heartbeats
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import spec as tspec
from dst_libp2p_test_node_tpu_torch.ops import state as tst

torch.set_num_threads(1)

N = 48
ARMED = dict(slow_weight=-10.0, slow_decay=0.9, gossip_threshold=-10.0,
             publish_threshold=-20.0, graylist_threshold=-50.0)


def _graph(seed=0):
    g = build_connection_graph(N, 8, seed=seed)
    return g, np.asarray(g.conns), np.asarray(g.rev), np.asarray(g.out_mask)


def _random_state(seed, conns):
    """A seeded state dict: dense meshes (the prune branch fires), live
    backoffs, fractional counters across the decay cut, some dead and
    unsubscribed peers, a part-filled PX pool, and the key words."""
    rng = np.random.default_rng(seed)
    n, c = conns.shape
    real = conns >= 0
    f32, i32 = np.float32, np.int32
    st = {
        "mesh_mask": real & (rng.random((n, c)) < 0.7),
        "fanout_mask": real & (rng.random((n, c)) < 0.2),
        "fanout_expire": (rng.random(n) * 3000.0).astype(f32),
        "backoff_until": np.where(rng.random((n, c)) < 0.3,
                                  rng.random((n, c)) * 4000.0,
                                  0.0).astype(f32),
        "fmd": np.where(rng.random((n, c)) < 0.6,
                        rng.random((n, c)) * 40.0, 0.0).astype(f32),
        "slow_penalty": np.where(rng.random((n, c)) < 0.4,
                                 rng.random((n, c)) * 7.0,
                                 0.0).astype(f32),
        "alive": rng.random(n) < 0.9,
        "subscribed": rng.random(n) < 0.95,
        "hb_phase": (rng.random(n) * 1000.0).astype(f32),
        "uplink_free_ms": (rng.random(n) * 3000.0).astype(f32),
        "rx_free_ms": (rng.random(n) * 3000.0).astype(f32),
        "warm_offset_ms": (rng.random(n) * 500.0).astype(f32),
        "t_ms": f32(2000.0),
        "px_pool": np.where(rng.random((n, tst.PX_POOL_WIDTH)) < 0.5,
                            rng.integers(0, n, (n, tst.PX_POOL_WIDTH)),
                            -1).astype(i32),
        "starve_hb": rng.integers(0, 4, n).astype(i32),
    }
    for f in tspec.SPEC_FIELDS:
        if f not in st:
            st[f] = rng.integers(0, 50, n).astype(i32) if f not in (
                "bytes_tx", "bytes_rx") else (rng.random(n) * 1e5).astype(f32)
    words = np.array([0, 1000 + seed], np.uint32)
    js = dict(st, key=jnp.asarray(words))
    ts = dict(st, key=torch.from_numpy(words.astype(np.int64)))
    return js, ts


def _same(js: dict, ts: dict):
    assert set(js) == set(ts)
    for k in js:
        a, b = np.asarray(js[k]), ts[k]
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        if k == "key":
            b = b.astype(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _params(pkg, conns, **kw):
    mod = jst if pkg == "jax" else tst
    return mod.SimParams(n=N, capacity=conns.shape[1], **{**ARMED, **kw})


HEARTBEATS = {
    "armed": {},
    "churn": dict(churn_down_per_hb=0.1, churn_up_per_hb=0.3),
    "repair": dict(evict=True, px=True, eviction_threshold=-5.0),
    "og": dict(opportunistic_graft_threshold=5.0),
    "sparse": dict(d_low=6, d=8, d_high=12),
}


@pytest.mark.parametrize("case", sorted(HEARTBEATS))
@pytest.mark.parametrize("seed", [0, 1])
def test_spec_heartbeat_bitwise(case, seed):
    g, conns, rev, out = _graph(seed)
    js, ts = _random_state(seed, conns)
    pj, pt = (_params(p, conns, **HEARTBEATS[case]) for p in ("jax", "torch"))
    rng = np.random.default_rng(seed + 7)
    edge_ok = (rng.random(conns.shape) < 0.9) if case == "churn" else None
    for _ in range(3):
        js = jspec.spec_heartbeat(js, conns, rev, out, pj, edge_ok=edge_ok)
        ts = tspec.spec_heartbeat(ts, conns, rev, out, pt, edge_ok=edge_ok)
        _same(js, ts)
    if case == "churn":
        # the churn draws ran: liveness moved
        assert (np.asarray(js["alive"])
                != _random_state(seed, conns)[0]["alive"]).any()


@pytest.mark.parametrize("tie_highest", [False, True])
def test_og_candidates_and_score(tie_highest):
    g, conns, rev, out = _graph(3)
    js, ts = _random_state(3, conns)
    pj, pt = (_params(p, conns, opportunistic_graft_threshold=5.0)
              for p in ("jax", "torch"))
    valid = jspec._validity(js, conns, rev, js["alive"], None)
    assert (tspec._validity(ts, conns, rev, ts["alive"], None)
            == valid).all()
    sj, st_ = jspec.spec_score(js, pj), tspec.spec_score(ts, pt)
    assert sj.tobytes() == st_.tobytes()
    # quantized scores: equal-score ties are common
    sq = np.round(sj)
    mesh = js["mesh_mask"] & valid
    a = jspec.opportunistic_graft_candidates(
        mesh, valid, js["backoff_until"], js["t_ms"], sq, pj,
        highest_slot_ties=tie_highest)
    b = tspec.opportunistic_graft_candidates(
        mesh, valid, ts["backoff_until"], ts["t_ms"], sq, pt,
        highest_slot_ties=tie_highest)
    for x, y in zip(a, b):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    assert np.asarray(a[0]).any()


@pytest.mark.parametrize("scenario", tadv.SCENARIOS)
def test_spec_adversary_round_bitwise(scenario):
    g, conns, rev, out = _graph(4)
    js, ts = _random_state(4, conns)
    pj, pt = (_params(p, conns) for p in ("jax", "torch"))
    att = np.random.default_rng(9).random(N) < 0.25
    aj = jadv.AdversaryParams(scenario=scenario, rotation_period_hb=2)
    at = tadv.AdversaryParams(scenario=scenario, rotation_period_hb=2)
    edge_ok = np.random.default_rng(10).random(conns.shape) < 0.85
    for hb in range(3):
        ok = edge_ok if hb == 1 else None
        js = jspec.spec_heartbeat(js, conns, rev, out, pj, edge_ok=ok)
        ts = tspec.spec_heartbeat(ts, conns, rev, out, pt, edge_ok=ok)
        js = jspec.spec_adversary_round(js, conns, rev, att, pj, aj, hb,
                                        edge_ok=ok)
        ts = tspec.spec_adversary_round(ts, conns, rev, att, pt, at, hb,
                                        edge_ok=ok)
        _same(js, ts)
    received = np.random.default_rng(11).random(N) < 0.7
    _same(jspec.spec_censorship_penalty(js, conns, rev, att, received, pj,
                                        aj),
          tspec.spec_censorship_penalty(ts, conns, rev, att, received, pt,
                                        at))
    _same(jspec.spec_eclipse_setup(js, conns, att, 3),
          tspec.spec_eclipse_setup(ts, conns, att, 3))


@pytest.mark.parametrize("repair", [True, False])
def test_spec_adaptive_round_bitwise(repair):
    g, conns, rev, out = _graph(5)
    js, ts = _random_state(5, conns)
    kw = dict(evict=True, px=True) if repair else {}
    pj, pt = (_params(p, conns, **kw) for p in ("jax", "torch"))
    att = np.random.default_rng(12).random(N) < 0.25
    aj = jadv.AdversaryParams(adaptive=jadv.AdaptivePolicy(enabled=True))
    at = tadv.AdversaryParams(adaptive=tadv.AdaptivePolicy(enabled=True))
    rng = np.random.default_rng(13)
    ctrl = dict(viol_est=(rng.random(N) * 12.0).astype(np.float32),
                regrafts=np.zeros(N, np.int32),
                px_injected=np.zeros(N, np.int32),
                throttled_hb=np.zeros(N, np.int32))
    cj, ct = dict(ctrl), dict(ctrl)
    for hb in range(4):
        js = jspec.spec_heartbeat(js, conns, rev, out, pj)
        ts = tspec.spec_heartbeat(ts, conns, rev, out, pt)
        js, cj = jspec.spec_adaptive_round(js, cj, conns, rev, att, pj, aj,
                                           hb)
        ts, ct = tspec.spec_adaptive_round(ts, ct, conns, rev, att, pt, at,
                                           hb)
        _same(js, ts)
        for k in ctrl:
            assert np.asarray(cj[k]).tobytes() == np.asarray(ct[k]).tobytes()
    assert int(cj["throttled_hb"].sum()) > 0


def test_fault_transforms_bitwise():
    g, conns, rev, out = _graph(6)
    js, ts = _random_state(6, conns)
    pj, pt = (_params(p, conns, px=True) for p in ("jax", "torch"))
    rng = np.random.default_rng(14)
    crash, side, spike = (rng.random(N) < f for f in (0.2, 0.5, 0.2))
    cj = jspec.spec_partition_edge_mask(side, conns)
    ct = tspec.spec_partition_edge_mask(side, conns)
    assert (cj == ct).all() and cj.any()
    _same(jspec.spec_go_dark(js, crash), tspec.spec_go_dark(ts, crash))
    _same(jspec.spec_restart(js, crash, conns, rev, pj),
          tspec.spec_restart(ts, crash, conns, rev, pt))
    (fj, frj), (ft, frt) = (jspec.spec_freeze(js, cj),
                            tspec.spec_freeze(ts, ct))
    _same(fj, ft)
    assert (frj == frt).all()
    (hj, zj), (ht, zt) = (jspec.spec_thaw(fj, frj, conns),
                          tspec.spec_thaw(ft, frt, conns))
    _same(hj, ht)
    assert (zj == zt).all() and not zt.any()
    _same(jspec.spec_spike(js, spike, 250.0), tspec.spec_spike(ts, spike,
                                                               250.0))


def test_host_state_of_each_engine():
    """host_state reads a state on any device into the same host dict; the
    key rides as a CPU tensor holding the reference key's words."""
    g = build_connection_graph(N, 8, seed=2)
    pj = jst.SimParams(n=N, capacity=g.capacity, **ARMED)
    a = jst.graph_arrays(g)
    sj = run_heartbeats(jst.init_state(pj, seed=2), a["conns"], a["rev"],
                        a["out_mask"], pj, 3)
    leaves = {f.name: np.asarray(getattr(sj, f.name))
              for f in dataclasses.fields(sj)}
    stt = interop.state_from_numpy(leaves, "cpu")
    hj, ht = jspec.host_state(sj), tspec.host_state(stt)
    assert ht["key"].device.type == "cpu"
    hj["key"] = np.asarray(jax.random.key_data(hj["key"])
                           if jnp.issubdtype(hj["key"].dtype,
                                             jax.dtypes.prng_key)
                           else hj["key"])
    _same(hj, ht)
