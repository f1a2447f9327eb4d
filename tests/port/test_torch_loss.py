"""Loss models and binding score thresholds of the port against the
reference, bitwise: XLA's float32 log (ops/xlamath.py) against jnp.log,
the tcp retry count and stall at the p^k boundaries, the per-fragment loss
draws against the reference's returned plan, the score gates (graylist,
publish, gossip) with the slow-peer accrual, lossy and lossless publishes
at fractional latencies (XLA's FMA contraction of the mesh base), the
heartbeat with live slow-peer counters, and the Simulator
and `run` CLI text for lossy runs (tcp, message, a lossy GML). The routes
of the lossy exact mode are in test_torch_loss_routes.py."""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dst_libp2p_test_node_tpu.ops.pull as jpull
import dst_libp2p_test_node_tpu_torch.ops.pull as tpull
from dst_libp2p_test_node_tpu import cli as jcli
from dst_libp2p_test_node_tpu.config.env import GossipSubParams as JGossip
from dst_libp2p_test_node_tpu.config.topology import Topology, TopoParams
from dst_libp2p_test_node_tpu.ops import disseminate as jd
from dst_libp2p_test_node_tpu.ops import heartbeat as jhb
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.runtime import bandwidth as jbw
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import cli as tcli
from dst_libp2p_test_node_tpu_torch import interop, prng
from dst_libp2p_test_node_tpu_torch.config.env import (
    GossipSubParams as TGossip)
from dst_libp2p_test_node_tpu_torch.ops import disseminate as td
from dst_libp2p_test_node_tpu_torch.ops import heartbeat as thb
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.ops.xlamath import exp2_int, log_f32
from dst_libp2p_test_node_tpu_torch.runtime import bandwidth as tbw
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

from test_torch_loss_routes import (N, _leaves, _torch_leaves, _world,
                                    publish_twice)

torch.set_num_threads(1)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


# ------------------------------------------------------------ XLA's log


def test_log_f32_matches_jnp_log_bitwise():
    rng = np.random.default_rng(0)
    tiny = np.finfo(np.float32).tiny
    sqrthf = np.float32(0.70710677)
    edge = np.array([
        1e-12, tiny, np.nextafter(tiny, np.float32(1)), sqrthf,
        np.nextafter(sqrthf, np.float32(0)),
        np.nextafter(sqrthf, np.float32(1)), 0.5, 1.0,
        np.nextafter(np.float32(1), np.float32(0)), 0.0, 1e-45, 3e-39,
        2.0, 1e30, np.inf], np.float32)
    x = np.concatenate([
        rng.uniform(1e-12, 1.0, 1_000_000).astype(np.float32),
        np.exp(rng.uniform(-28.0, 0.0, 200_000)).astype(np.float32),
        rng.uniform(0.5, 1.5, 100_000).astype(np.float32), edge])
    want = np.asarray(jax.jit(jnp.log)(x))
    got = log_f32(torch.from_numpy(x)).numpy()
    assert _bits_equal(got, want), np.nonzero(got.view(np.int32)
                                              != want.view(np.int32))[0][:5]
    # torch's own log is another function: it is why log_f32 exists
    assert not np.array_equal(torch.log(torch.from_numpy(x)).numpy(), want)


def test_exp2_int_exact():
    j = torch.tensor([0.0, 1.0, 2.0, 5.0, 7.0, -np.inf])
    assert exp2_int(j).tolist() == [1.0, 2.0, 4.0, 32.0, 128.0, 1.0]


def _ref_tcp(u, loss_edge, lat_edge):
    """The reference's tcp expression (ops/disseminate.py, loss_mode
    "tcp"), on chosen draws u: (j, survive, retx_ms)."""
    u = jnp.clip(u, 1e-12)
    safe_p = jnp.clip(loss_edge, 1e-9, 1.0 - 1e-9)
    j = jnp.where(loss_edge > 0.0,
                  jnp.floor(jnp.log(u) / jnp.log(safe_p)), 0.0)
    j = jnp.minimum(j, float(jd.MAX_RETRIES + 1))
    survive = j <= float(jd.MAX_RETRIES)
    rto = jnp.maximum(jd.RTO_MIN_MS, 1.5 * 2.0 * lat_edge)
    retx = jnp.where(survive & (j > 0.0), rto * (jnp.exp2(j) - 1.0), 0.0)
    return j, survive, retx


def test_retry_count_and_stall_at_pk_boundaries():
    # u one and two ulps either side of p^k, k = 1..7, for the loss rates
    # a topogen -l run uses; plus a loss of exactly 1.0, where the float32
    # clip leaves log p = +0 and the copy survives with no stall
    us, ps, lats = [], [], []
    for p in (0.001, 0.01, 0.05, 0.1, 0.3, 0.5, 0.9, 1.0):
        p32 = np.float32(p)
        for k in range(1, 8):
            c = np.float32(np.float64(p32) ** k)
            near = [c]
            for _ in range(2):
                near = ([np.nextafter(near[0], np.float32(0))] + near
                        + [np.nextafter(near[-1], np.float32(1))])
            us += near
            ps += [p32] * len(near)
            lats += [40.0, 66.5, 130.0, 0.0, 101.25][:len(near)]
    u = np.asarray(us, np.float32)[None]
    loss = np.asarray(ps, np.float32)[None]
    lat = np.asarray(lats, np.float32)[None]
    j, sv, retx = (np.asarray(x) for x in jax.jit(_ref_tcp)(u, loss, lat))
    lt = torch.from_numpy(loss)
    got_sv, got_retx = td.tcp_retries(torch.from_numpy(u), lt,
                                      torch.from_numpy(lat))
    got_j = torch.floor(
        log_f32(torch.clamp_min(torch.from_numpy(u), 1e-12))
        / log_f32(torch.clamp(lt, 1e-9, 1.0))).numpy()
    live = loss < 1.0
    assert _bits_equal(np.minimum(got_j, 7.0)[live], j[live])
    assert _bits_equal(got_sv.numpy(), sv)
    assert _bits_equal(got_retx.numpy(), retx)
    assert len(set(j[live].tolist())) == 8          # j = 0..7 all occur
    quirk = ~live & (u < 1.0)          # the real draws lie in [0, 1)
    assert sv[quirk].all() and (retx[quirk] == 0.0).all()


@pytest.mark.parametrize("loss_mode", ["tcp", "message"])
def test_loss_draws_match_reference_plan_per_fragment(loss_mode):
    # each fragment is its own GossipSub message upstream: one draw per
    # (fragment, edge), and the port's draws are the reference's bits
    topo, g, pj, _, aj, sj = _world(seed=9)
    loss = np.full(topo.packet_loss.shape, 0.3, np.float32)
    args = [jnp.asarray(x) for x in (topo.stage_of_peer, topo.latency_ms,
                                     topo.bw_up_mbit)]
    _, _, plan = jd.disseminate(
        sj, aj["conns"], aj["rev"], *args, publisher=0,
        t0_ms=float(sj.t_ms), params=pj, payload_bytes=15000, fragments=3,
        loss_stage=jnp.asarray(loss), loss_mode=loss_mode, return_plan=True)
    at = tst.graph_arrays(g, "cpu")
    stage = torch.from_numpy(topo.stage_of_peer)
    lat_edge, loss_edge = td.edge_tables(
        stage, torch.from_numpy(topo.latency_ms), at["conns"], at["rev"],
        torch.from_numpy(loss))
    k_loss = prng.split(interop.state_from_numpy(_leaves(sj), "cpu").key,
                        4)[3]
    survive, retx = td.loss_draws(k_loss, loss_edge, lat_edge, 3, loss_mode)
    assert _bits_equal(survive.numpy(), np.asarray(plan["survive"]))
    real = at["conns"].numpy() >= 0
    s = survive.numpy()
    assert s.shape[0] == 3
    assert (s[0][real] != s[1][real]).any() and (s[1][real]
                                                 != s[2][real]).any()
    if loss_mode == "tcp":
        assert _bits_equal(retx.numpy(), np.asarray(plan["retx_ms"]))
        r = retx.numpy()
        assert ((r[0] > 0) != (r[1] > 0)).any()
    else:
        assert retx is None and plan["retx_ms"] is None


# ---------------------------------------------------------- score gates


def _gated_world(**overrides):
    """slow_weight -1 with a planted slow-peer counter: a third of the
    peers score the publisher (peer 0) at -100, and the publisher scores a
    third of its neighbours at -100."""
    world = _world(seed=11, slow_weight=-1.0, **overrides)
    topo, g, pj, pt, aj, sj = world
    rng = np.random.default_rng(7)
    conns = np.asarray(aj["conns"])
    slow = np.zeros(sj.slow_penalty.shape, np.float32)
    for r in rng.choice(N, size=N // 3, replace=False):
        slow[r, conns[r] == 0] = 100.0
    pub_slots = np.nonzero(conns[0] >= 0)[0]
    slow[0, pub_slots[::3]] = 100.0
    return topo, g, pj, pt, aj, sj.replace(slow_penalty=jnp.asarray(slow))


def _port_publish(world, loss_stage=None, loss_mode="tcp"):
    """The port alone: (result, new state) of one publish from peer 0."""
    topo, g, _, pt, _, sj = world
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    at = tst.graph_arrays(g, "cpu")
    consts = [torch.from_numpy(x) for x in (topo.stage_of_peer,
                                            topo.latency_ms,
                                            topo.bw_up_mbit)]
    return td.disseminate(
        st, at["conns"], at["rev"], *consts, publisher=0,
        t0_ms=float(sj.t_ms) + 250.5, params=pt, payload_bytes=15000,
        loss_stage=loss_stage, loss_mode=loss_mode)


def _both_publish(world, loss=None, loss_mode="message"):
    """One publish from peer 0 in both packages, every leaf bitwise."""
    topo, g, pj, pt, aj, sj = world
    kw = dict(publisher=0, t0_ms=float(sj.t_ms) + 250.5,
              payload_bytes=15000, loss_mode=loss_mode)
    ls = (None if loss is None
          else np.full(topo.packet_loss.shape, loss, np.float32))
    args = (topo.stage_of_peer, topo.latency_ms, topo.bw_up_mbit)
    rj, sj2 = jd.disseminate(
        sj, aj["conns"], aj["rev"], *[jnp.asarray(x) for x in args],
        params=pj, loss_stage=None if ls is None else jnp.asarray(ls), **kw)
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    at = tst.graph_arrays(g, "cpu")
    rt, st2 = td.disseminate(
        st, at["conns"], at["rev"], *[torch.from_numpy(x) for x in args],
        params=pt, loss_stage=None if ls is None else torch.from_numpy(ls),
        **kw)
    assert interop.leaf_mismatches(_leaves(rj), _torch_leaves(rt)) == []
    assert interop.leaf_mismatches(_leaves(sj2),
                                   interop.state_to_numpy(st2)) == []
    return rt, st2


def test_graylist_gates_delivery_and_lost_tx_stays_network_only():
    world = _gated_world(graylist_threshold=-50.0)
    res, _ = _both_publish(world)
    # the graylist fired: against the same state with the default
    # threshold (-10000), the publisher sends the same copies, but most
    # peers that graylist it now get the message later, from someone else
    open_, _ = _port_publish(_gated_world())
    assert int(res.sends[0]) == int(open_.sends[0])
    conns = np.asarray(world[4]["conns"])
    gray = (np.asarray(world[5].slow_penalty)[:, :] > 0) & (conns == 0)
    rows = np.nonzero(gray.any(axis=1))[0]
    later = res.t_rx_ms.numpy()[rows] > open_.t_rx_ms.numpy()[rows]
    assert later.mean() > 0.5, later
    # and no copy counts as network-lost
    assert int(res.lost_tx.sum()) == 0
    # with message loss on top, lost_tx tracks the loss rate alone
    lossy, _ = _both_publish(world, loss=0.3)
    lost, sent = int(lossy.lost_tx.sum()), int(lossy.sends.sum())
    assert 0.2 <= lost / sent <= 0.4, (lost, sent)


def test_publish_and_gossip_gates_and_slow_accrual():
    # the publisher floods only neighbours it scores >= publishThreshold
    # and nobody IHAVEs a peer it scores below gossipThreshold; a small
    # slow-peer threshold makes the accrual fire
    world = _gated_world(publish_threshold=-50.0, gossip_threshold=-50.0,
                         slow_threshold_ms=1.0)
    res, st = _both_publish(world, loss=0.1, loss_mode="tcp")
    open_, st_open = _port_publish(_gated_world(slow_threshold_ms=1.0),
                                   torch.full((6, 6), 0.1), "tcp")
    assert int(res.sends[0]) < int(open_.sends[0])
    # a third of the peers score the publisher below gossipThreshold and
    # send it no IHAVE
    assert int(st.ihave_rx[0]) < int(st_open.ihave_rx[0])
    planted = torch.from_numpy(np.asarray(world[5].slow_penalty))
    assert float((st.slow_penalty - planted).sum()) > 0.0


def test_lossy_tcp_publish_at_fractional_latencies():
    # non-integer stage latencies, where a contracted a*b+c in the new
    # loss arithmetic (lat * flights + stall) would show
    topo, g, pj, pt, aj, sj = _world(seed=2)
    rng = np.random.default_rng(3)
    lat = topo.latency_ms + rng.uniform(0.0, 1.0, topo.latency_ms.shape)
    lat = (np.triu(lat) + np.triu(lat, 1).T).astype(np.float32)
    frac = dataclasses.replace(topo, latency_ms=lat)
    res, _ = publish_twice((frac, g, pj, pt, aj, sj), 1, "tcp")
    assert all(bool(r.received.all()) for r in res)


@pytest.mark.parametrize("mode,fragments,budget,engine", [
    ("exact", 1, "default", "prefix"),
    ("exact", 3, "default", "prefix"),
    ("bounded", 1, "default", None),
    ("bounded", 1, "lowered", None),
])
def test_lossless_publish_at_fractional_latencies(mode, fragments, budget,
                                                  engine, monkeypatch):
    # without loss the mesh base `queue + lat_edge * flights` feeds an add
    # directly, and XLA's CPU backend contracts it into one FMA: at
    # fractional latencies the product is inexact and a two-rounding port
    # drifts by an ulp (the sender-side base and the receiver-side
    # constant alike, the latter with the budget lowered)
    if budget == "lowered":
        monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
        monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
        jd.disseminate.clear_cache()
    try:
        topo, g, pj, pt, aj, sj = _world(
            seed=2, serialize_answers=(mode == "exact"))
        rng = np.random.default_rng(3)
        lat = topo.latency_ms + rng.uniform(0.0, 1.0, topo.latency_ms.shape)
        lat = (np.triu(lat) + np.triu(lat, 1).T).astype(np.float32)
        st = interop.state_from_numpy(_leaves(sj), "cpu")
        at = tst.graph_arrays(g, "cpu")
        arrays = (topo.stage_of_peer, lat, topo.bw_up_mbit)
        consts_j = [jnp.asarray(x) for x in arrays]
        consts_t = [torch.from_numpy(x) for x in arrays]
        td.reset_engine_counts()
        t_base = float(sj.t_ms)
        for publisher, dt in ((7, 250.5), (40, 900.25)):
            kw = dict(publisher=publisher, t0_ms=t_base + dt,
                      payload_bytes=15000, fragments=fragments)
            rj, sj = jd.disseminate(sj, aj["conns"], aj["rev"], *consts_j,
                                    params=pj, **kw)
            rt, st = td.disseminate(st, at["conns"], at["rev"], *consts_t,
                                    params=pt, **kw)
            assert interop.leaf_mismatches(_leaves(rj),
                                           _torch_leaves(rt)) == []
            assert interop.leaf_mismatches(
                _leaves(sj), interop.state_to_numpy(st)) == []
            assert bool(rt.converged) and bool(rt.received.all())
    finally:
        monkeypatch.undo()
        jd.disseminate.clear_cache()
    if engine is not None:
        assert td.engine_counts[engine] > 0, td.engine_counts
    assert lat[0, 1] != np.round(lat[0, 1])


# ------------------------------------------------------------ heartbeat


@pytest.mark.parametrize("og", [-10000.0, 0.5])
def test_heartbeats_with_live_slow_penalty_bitwise(og):
    n = 200
    g = build_connection_graph(n, 10, seed=1, max_degree=40)
    kw = dict(slow_weight=-1.0, opportunistic_graft_threshold=og)
    pj = jst.SimParams(n=n, capacity=g.capacity, **kw)
    pt = tst.SimParams(n=n, capacity=g.capacity, **kw)
    rng = np.random.default_rng(4)
    shape = (n, g.capacity)
    sj = jst.init_state(pj, 7).replace(
        fmd=jnp.asarray(rng.integers(0, 4, shape).astype(np.float32)),
        slow_penalty=jnp.asarray(rng.integers(0, 3, shape)
                                 .astype(np.float32)))
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    want = jhb.run_heartbeats(sj, aj["conns"], aj["rev"], aj["out_mask"],
                              pj, 30)
    got = thb.run_heartbeats(st, at["conns"], at["rev"], at["out_mask"],
                             pt, 30)
    assert interop.leaf_mismatches(_leaves(want),
                                   interop.state_to_numpy(got)) == []
    assert int(got.prunes.sum()) > 0


# --------------------------------------------------- Simulator and CLI


def _outputs(sim, bw):
    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return {"latencies1": buf.getvalue(),
            "shadowlog1": "\n".join(bw.shadowlog_lines(sim.traffic())),
            "summary": sim.summary_report() + sim.bandwidth_report()}


@pytest.mark.parametrize("loss_mode", ["tcp", "message"])
def test_simulator_lossy_byte_identical(loss_mode):
    topo = TopoParams(network_size=N, anchor_stages=5, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      packet_loss=0.05, msg_size_bytes=15000, num_frags=2,
                      messages=3, delay_seconds=2.0)
    # tcp: the slow-peer penalty armed (weight -1, a 5 ms threshold), so
    # the score gates and the accrual ride every publish and heartbeat
    gs = (dict(slow_peer_penalty_weight=-1.0,
               slow_peer_penalty_threshold=0.005)
          if loss_mode == "tcp" else {})
    kw = dict(topo=topo, seed=5, warmup_s=20.0, publisher_rotation=True,
              loss_mode=loss_mode, churn_down_per_hb=0.01,
              churn_up_per_hb=0.005)
    sj = jsim.Simulator(jsim.ExperimentConfig(gossipsub=JGossip(**gs), **kw))
    st = tsim.Simulator(tsim.ExperimentConfig(gossipsub=TGossip(**gs), **kw),
                        device="cpu")
    sj.run()
    st.run()
    want, got = _outputs(sj, jbw), _outputs(st, tbw)
    for name in want:
        assert got[name] == want[name], name
    assert interop.leaf_mismatches(interop.state_to_numpy(st.state),
                                   _leaves(sj.state)) == []
    assert all(r.converged for r in st.records)
    if gs:
        assert float(st.state.slow_penalty.sum()) > 0.0


def _cli_pair(tmp_path, monkeypatch, args):
    outs = {}
    for name, mod, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert mod.main(["run", *args, *extra,
                         "--out-prefix", str(d) + "/"]) == 0
        outs[name] = {f: (d / f).read_text()
                      for f in ("latencies1", "shadowlog1")}
    assert outs["torch"] == outs["jax"]


def test_run_cli_lossy_byte_identical(tmp_path, monkeypatch):
    _cli_pair(tmp_path, monkeypatch,
              ["1", "120", "15000", "1", "3", "50", "150", "40", "130", "5",
               "0.05", "4", "1", "3000", "--warmup-s", "15", "--seed", "2",
               "--loss-mode", "message"])


def test_run_cli_lossy_gml_byte_identical(tmp_path, monkeypatch):
    pytest.importorskip("networkx")
    gml = tmp_path / "lossy.gml"
    Topology.build(TopoParams(network_size=120, anchor_stages=3,
                              packet_loss=0.02)).write_gml(str(gml))
    _cli_pair(tmp_path, monkeypatch,
              ["1", "120", "15000", "1", "2", "50", "150", "40", "130", "3",
               "0.0", "4", "0", "3000", "--warmup-s", "15", "--seed", "1",
               "--gml", str(gml)])
