"""Exact delivery mode (serialize_answers=True, the model of record) of the
port's disseminate against the reference, bitwise on every
DisseminationResult leaf and every leaf of the new state over two publishes
in a row, through each route: the fast pipeline kept, the prefix engine
(Jacobi on the lat-sorted answer fold) below the pull budget, the serial
engine (global
sort, from-INF passes) sender-side and, with the budget lowered in both
packages, receiver-side through converge_recv, the prefix->serial fallback
of a capped loop, and the closed-form answer star. Then the Simulator and
the `run` CLI in exact mode, byte-identical to the reference's outputs."""

import dataclasses

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
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.ops.heartbeat import run_heartbeats
from dst_libp2p_test_node_tpu.runtime import bandwidth as jbw
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import cli as tcli
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.env import (
    GossipSubParams as TGossip)
from dst_libp2p_test_node_tpu_torch.ops import disseminate as td
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.runtime import bandwidth as tbw
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 100
# the gossip-heavy setting that makes queued answers first deliveries
# (tests/test_exact_prefix.py): no flood publish, a raised D_lazy
GOSSIP_HEAVY = dict(flood_publish=False, d_lazy=12)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _torch_leaves(obj):
    return {f.name: getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)}


@pytest.fixture
def lowered_budget(monkeypatch):
    monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
    monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
    jd.disseminate.clear_cache()
    yield
    monkeypatch.undo()
    jd.disseminate.clear_cache()


def _mesh_world(seed=2, **overrides):
    topo = Topology.build(TopoParams(
        network_size=N, anchor_stages=5, min_bandwidth=50,
        max_bandwidth=150, min_latency=40, max_latency=130))
    g = build_connection_graph(N, 10, seed=seed, max_degree=40)
    kw = dict(proc_delay_ms=0.8, **overrides)
    pj = jst.SimParams(n=N, capacity=g.capacity, **kw)
    pt = tst.SimParams(n=N, capacity=g.capacity, **kw)
    aj = jst.graph_arrays(g)
    sj = run_heartbeats(jst.init_state(pj, seed), aj["conns"], aj["rev"],
                        aj["out_mask"], pj, 12)
    return topo, g, pj, pt, aj, sj, ((7, 250.5), (40, 900.25))


def _star_world(**overrides):
    """Publisher 0 joined to 1..8, empty mesh, no flood: the only path is
    gossip round 0, and the 8 answers serialize back-to-back on 0's uplink
    (tests/test_disseminate.py, closed-form delays)."""
    n = 9
    g = build_connection_graph(
        n, 1, seed=0,
        dials=np.vstack([np.full((1, 1), 1),
                         np.zeros((n - 1, 1), dtype=np.int64)]),
        max_degree=n)
    topo = Topology.build(TopoParams(network_size=n, anchor_stages=1))
    kw = dict(d_lazy=16, flood_publish=False, max_relax_iters=16,
              **overrides)
    pj = jst.SimParams(n=n, capacity=g.capacity, **kw)
    pt = tst.SimParams(n=n, capacity=g.capacity, **kw)
    sj = jst.init_state(pj, seed=3).replace(
        mesh_mask=jnp.zeros((n, g.capacity), bool),
        hb_phase=jnp.full((n,), 250.0, jnp.float32))
    return topo, g, pj, pt, jst.graph_arrays(g), sj, ((0, 0.0), (0, 2000.0))


def _publish_twice(world, fragments=1):
    """Both packages, two publishes in a row, every leaf bitwise. Returns
    the port's results and the engine counts the port's dispatch took."""
    topo, g, pj, pt, aj, sj, pubs = world
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    at = tst.graph_arrays(g, "cpu")
    consts_j = [jnp.asarray(x) for x in (topo.stage_of_peer, topo.latency_ms,
                                         topo.bw_up_mbit)]
    consts_t = [torch.from_numpy(x) for x in (topo.stage_of_peer,
                                              topo.latency_ms,
                                              topo.bw_up_mbit)]
    td.reset_engine_counts()
    results = []
    t_base = float(sj.t_ms)
    for publisher, dt in pubs:
        kw = dict(publisher=publisher, t0_ms=t_base + dt,
                  payload_bytes=15000, fragments=fragments)
        rj, sj = jd.disseminate(sj, aj["conns"], aj["rev"], *consts_j,
                                params=pj, **kw)
        rt, st = td.disseminate(st, at["conns"], at["rev"], *consts_t,
                                params=pt, **kw)
        assert interop.leaf_mismatches(_leaves(rj), _torch_leaves(rt)) == []
        assert interop.leaf_mismatches(
            _leaves(sj), interop.state_to_numpy(st)) == []
        results.append(rt)
    return results, dict(td.engine_counts)


def _assert_refined(results, counts, engine):
    """The case really ran the refinement (not the fast pipeline against
    itself): passes > 0 (equal on both sides, the leaves are bitwise) and
    the port's counter for `engine` moved."""
    assert max(int(r.refine_passes) for r in results) > 0
    assert counts[engine] > 0, counts
    assert all(bool(r.converged) for r in results)


@pytest.mark.parametrize("fragments", [1, 3])
def test_prefix_engine_bitwise(fragments):
    res, counts = _publish_twice(_mesh_world(**GOSSIP_HEAVY), fragments)
    _assert_refined(res, counts, "prefix")
    assert counts["serial"] == 0


def test_serial_engine_bitwise_sender_side():
    res, counts = _publish_twice(
        _mesh_world(answer_queue_mode="serial", **GOSSIP_HEAVY))
    _assert_refined(res, counts, "serial")
    assert counts["prefix"] == 0


@pytest.mark.parametrize("fragments", [1, 4])
def test_serial_engine_bitwise_receiver_side(fragments, lowered_budget):
    from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg

    before = vg.launches
    res, counts = _publish_twice(_mesh_world(**GOSSIP_HEAVY), fragments)
    # above the budget the default mode takes the serial engine
    _assert_refined(res, counts, "serial")
    assert counts["prefix"] == 0
    assert vg.launches == before     # CPU tensors: the plain gather runs


@pytest.mark.parametrize("mode", ["parallel_prefix", "serial"])
def test_answer_star_closed_form(mode):
    res, counts = _publish_twice(_star_world(answer_queue_mode=mode))
    _assert_refined(res, counts,
                    "prefix" if mode == "parallel_prefix" else "serial")
    first = res[0]
    assert bool(first.received.all())
    delays = np.sort(first.delay_ms.numpy()[1:])
    lat, tx = 100.0, 2.4
    want = 250.0 + 2.0 * lat + tx * np.arange(1, 9) + 3.0 * lat
    np.testing.assert_allclose(delays, want, rtol=1e-5)
    assert int(first.iwant_sent.sum()) == 8


def test_fast_pipeline_kept_bitwise():
    # default GossipSub settings (flood publish): the first publish's
    # queued answers are never a first delivery, so the fast pipeline's
    # times stand (0 passes); the second one is refined
    res, counts = _publish_twice(_mesh_world(seed=0))
    assert counts["fast"] == 1 and counts["prefix"] == 1, counts
    assert int(res[0].refine_passes) == 0 and int(res[0].iwant_sent.sum())
    assert int(res[1].refine_passes) > 0
    assert all(bool(r.converged) for r in res)


@pytest.mark.parametrize("mode", ["parallel_prefix", "serial"])
def test_first_sender_kept_bitwise(mode):
    res, counts = _publish_twice(_mesh_world(
        exclude_first_sender=False, answer_queue_mode=mode, **GOSSIP_HEAVY))
    _assert_refined(res, counts,
                    "prefix" if mode == "parallel_prefix" else "serial")


def test_capped_prefix_falls_back_to_serial():
    # a loop cap below the Jacobi iteration count: the prefix certificate
    # fails, every fragment reruns through the serial engine, and
    # converged / refine_passes must come out as the reference's
    res, counts = _publish_twice(
        _mesh_world(max_relax_iters=3, **GOSSIP_HEAVY), fragments=2)
    assert counts["prefix_fallback"] > 0, counts
    assert counts["prefix"] >= counts["prefix_fallback"]
    assert max(int(r.refine_passes) for r in res) > 3


# ------------------------------------------------ Simulator and CLI, exact


def _outputs(sim, bw):
    import io

    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return {"latencies1": buf.getvalue(),
            "shadowlog1": "\n".join(bw.shadowlog_lines(sim.traffic())),
            "summary": sim.summary_report() + sim.bandwidth_report()}


def test_simulator_exact_mode_byte_identical(lowered_budget):
    topo = TopoParams(network_size=150, anchor_stages=5, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=15000, num_frags=4, messages=3,
                      delay_seconds=2.0)
    kw = dict(topo=topo, seed=5, warmup_s=20.0, publisher_rotation=True,
              churn_down_per_hb=0.01, churn_up_per_hb=0.005)
    sj = jsim.Simulator(jsim.ExperimentConfig(
        gossipsub=JGossip(**GOSSIP_HEAVY), **kw))
    st = tsim.Simulator(tsim.ExperimentConfig(
        gossipsub=TGossip(**GOSSIP_HEAVY), **kw), device="cpu")
    assert st.params.serialize_answers
    td.reset_engine_counts()
    sj.run()
    st.run()
    for name, want in _outputs(sj, jbw).items():
        assert _outputs(st, tbw)[name] == want, name
    assert sum(td.engine_counts.values()) == 3
    assert td.engine_counts["serial"] > 0, td.engine_counts
    assert all(r.converged for r in st.records)


def test_run_cli_defaults_to_exact_byte_identical(tmp_path, monkeypatch):
    args = ["1", "120", "15000", "1", "3", "50", "150", "40", "130", "5",
            "0.0", "4", "1", "3000", "--warmup-s", "15", "--seed", "2",
            "--stats-json"]
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
    assert '"delivery_mode": "exact"' in (tmp_path / "torch"
                                          / "stats1.json").read_text()
