"""The port's flight recorder (ops/telemetry.py, Simulator.record_telemetry)
against the reference, on the CPU, bitwise (no tolerance):

  - run_recorded_heartbeats, churn off (hoisted validity, carried degree,
    deferred decay) and on: the tel_* curves, and the final state equal to
    the reference's and to the port's unrecorded run_heartbeats;
  - float32 sums in XLA's CPU order (xlamath.sum_f32), and the window
    observables at fractional scores and inexact weights, where XLA's CPU
    backend contracts the score and the quantile's interpolation per
    program (telemetry.contracted_score);
  - Simulator.record_telemetry / advance: last_telemetry as host numpy,
    disarmed by None or record=False, cleared by reset."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops import telemetry as jtel
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import heartbeat as thb
from dst_libp2p_test_node_tpu_torch.ops import state as tst
from dst_libp2p_test_node_tpu_torch.ops import telemetry as ttel
from dst_libp2p_test_node_tpu_torch.ops.xlamath import sum_f32
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 96


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _curves_equal(want: dict, got: dict) -> list:
    return interop.leaf_mismatches(
        {k: np.asarray(v) for k, v in want.items()},
        interop.obs_to_numpy(got)) + sorted(set(want) ^ set(got))


@pytest.mark.parametrize("churn", [0.0, 0.03])
def test_recorded_heartbeats_bitwise(churn):
    g = build_connection_graph(N, 10, seed=4, max_degree=40)
    kw = dict(churn_down_per_hb=churn, churn_up_per_hb=churn / 2,
              slow_weight=-1.0)
    pj = jst.SimParams(n=N, capacity=g.capacity, **kw)
    pt = tst.SimParams(n=N, capacity=g.capacity, **kw)
    rng = np.random.default_rng(2)
    shape = (N, g.capacity)
    sj = jst.init_state(pj, 5).replace(
        fmd=jnp.asarray(rng.integers(0, 4, shape).astype(np.float32)),
        slow_penalty=jnp.asarray(rng.integers(0, 3, shape)
                                 .astype(np.float32)),
        uplink_free_ms=jnp.asarray(rng.uniform(0, 900, N)
                                   .astype(np.float32)),
        bytes_tx=jnp.asarray(rng.uniform(0, 1e6, N).astype(np.float32)))
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    tel_j = jtel.TelemetryParams(record=True, degree_bins=9,
                                 quantiles=(0.0, 0.25, 0.5, 0.9, 1.0))
    tel_t = ttel.TelemetryParams(record=True, degree_bins=9,
                                 quantiles=(0.0, 0.25, 0.5, 0.9, 1.0))
    want, trace_j = jtel.run_recorded_heartbeats(
        sj, aj["conns"], aj["rev"], aj["out_mask"], pj, 14, telemetry=tel_j)
    got, trace_t = ttel.run_recorded_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], pt, 14, telemetry=tel_t)
    assert interop.leaf_mismatches(_leaves(want),
                                   interop.state_to_numpy(got)) == []
    assert _curves_equal(trace_j, trace_t) == []
    assert trace_t["tel_degree_hist"].shape == (14, 9)
    assert trace_t["tel_score_q"].shape == (14, 5)
    # the recorder writes nothing: the unrecorded run ends on the same bytes
    plain = thb.run_heartbeats(st, at["conns"], at["rev"], at["out_mask"],
                               pt, 14)
    assert interop.leaf_mismatches(interop.state_to_numpy(plain),
                                   interop.state_to_numpy(got)) == []
    # disarmed, it is run_heartbeats with an empty trace
    off, tr = ttel.run_recorded_heartbeats(
        st, at["conns"], at["rev"], at["out_mask"], pt, 14,
        telemetry=ttel.TelemetryParams())
    assert tr == {} and interop.leaf_mismatches(
        interop.state_to_numpy(plain), interop.state_to_numpy(off)) == []


def test_sums_and_quantiles_in_xla_order():
    rng = np.random.default_rng(7)
    jsum = jax.jit(lambda a, m: jnp.where(m, a, 0.0).sum())
    for shape in ((7,), (33,), (1000,), (5120,), (100_000,), (48, 40),
                  (128, 40), (200, 40), (1024, 40), (96, 32), (128, 16)):
        for _ in range(3):
            x = (rng.random(shape) * 100 - 30).astype(np.float32)
            m = rng.random(shape) < 0.4
            want = np.float32(jsum(jnp.asarray(x), jnp.asarray(m)))
            got = sum_f32(torch.where(torch.from_numpy(m),
                                      torch.from_numpy(x), 0.0))
            assert got.dtype == torch.float32
            assert want.tobytes() == got.numpy().tobytes(), shape
    # the quantile's own interpolation, which the window programs contract
    x = torch.tensor([1.0, np.nan, 3.0, 2.0, 7.5])
    got = ttel.nanquantile_f32(x, (0.0, 0.5, 1.0, 0.3)).numpy()
    assert np.array_equal(got[:3], np.float32([1.0, 2.5, 7.5]))
    # 1 * 0.1 + 2 * 0.9 with the second product unrounded
    w = np.float32(0.3) * np.float32(3.0)
    want = np.float32(np.float64(2.0) * np.float64(w - np.float32(0.0))
                      + np.float64(np.float32(1.0) - w))
    assert got[3] == want
    allnan = np.full((5,), np.nan, np.float32)
    assert np.isnan(ttel.nanquantile_f32(torch.from_numpy(allnan),
                                         (0.5,)).numpy()).all()


@pytest.mark.parametrize("runner", ["recorded", "attack", "recovery"])
@pytest.mark.parametrize("weights", [(1.0, -10.0), (0.7, -3.3)])
def test_observables_at_fractional_scores(runner, weights):
    # fractional fmd and slow-peer counters at inexact weights: XLA's CPU
    # backend contracts one product of the score, and the quantile's
    # interpolation, per program (telemetry.contracted_score)
    from dst_libp2p_test_node_tpu.ops import adversary as jadv
    from dst_libp2p_test_node_tpu.ops import repair as jrep
    from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
    from dst_libp2p_test_node_tpu_torch.ops import repair as trep

    fw, sw = weights
    g = build_connection_graph(N, 10, seed=4, max_degree=40)
    kw = dict(fmd_weight=fw, slow_weight=sw)
    pj = jst.SimParams(n=N, capacity=g.capacity, **kw)
    pt = tst.SimParams(n=N, capacity=g.capacity, **kw)
    rng = np.random.default_rng(2)
    sj = jst.init_state(pj, 5).replace(
        fmd=jnp.asarray(rng.uniform(0, 4, (N, 40)).astype(np.float32)),
        slow_penalty=jnp.asarray(rng.uniform(0, 3, (N, 40))
                                 .astype(np.float32)))
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    tel_j = jtel.TelemetryParams(record=True)
    tel_t = ttel.TelemetryParams(record=True)
    att = jadv.attacker_cohort(N, 0.2, seed=0)
    if runner == "recorded":
        want, obs_j = jtel.run_recorded_heartbeats(
            sj, aj["conns"], aj["rev"], aj["out_mask"], pj, 6,
            telemetry=tel_j)
        got, obs_t = ttel.run_recorded_heartbeats(
            st, at["conns"], at["rev"], at["out_mask"], pt, 6,
            telemetry=tel_t)
    elif runner == "attack":
        want, obs_j = jadv.run_attacked_heartbeats(
            sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att),
            pj, jadv.AdversaryParams(), 6, telemetry=tel_j)
        got, obs_t = tadv.run_attacked_heartbeats(
            st, at["conns"], at["rev"], at["out_mask"],
            torch.from_numpy(att), pt, tadv.AdversaryParams(), 6,
            telemetry=tel_t)
    else:
        rj = jrep.RepairParams(evict=True, px=True, redial=True)
        rt = trep.RepairParams(evict=True, px=True, redial=True)
        (want, *_), obs_j = jrep.run_recovery_heartbeats(
            sj, aj["conns"], aj["rev"], aj["out_mask"], jnp.asarray(att),
            rj.apply(pj), 6, telemetry=tel_j)
        (got, *_), obs_t = trep.run_recovery_heartbeats(
            st, at["conns"], at["rev"], at["out_mask"],
            torch.from_numpy(att), rt.apply(pt), 6, telemetry=tel_t)
    assert interop.leaf_mismatches(_leaves(want),
                                   interop.state_to_numpy(got)) == []
    assert _curves_equal(obs_j, obs_t) == []
    # the contraction shows at these weights: the two roundings differ
    assert not torch.equal(st.score(pt), ttel.contracted_score(st, pt))


def _cfg(mod, topo):
    return mod.ExperimentConfig(
        topo=topo(network_size=N, msg_size_bytes=1500, messages=1),
        connect_to=8, warmup_s=6.0, seed=1)


def test_simulator_record_telemetry():
    js = jsim.Simulator(_cfg(jsim, TopoParams))
    ts = tsim.Simulator(_cfg(tsim, TTopo), device="cpu")
    js.record_telemetry(jtel.TelemetryParams(record=True))
    ts.record_telemetry(ttel.TelemetryParams(record=True))
    for s in (js, ts):
        s.warmup()
    assert ts.last_telemetry["tel_mesh_coverage"].shape == (6,)
    assert all(isinstance(v, np.ndarray) for v in ts.last_telemetry.values())
    assert _curves_equal(js.last_telemetry, ts.last_telemetry) == []
    for s in (js, ts):
        s.publish(4)
        s.advance(2500.0)     # two heartbeats, 500 ms carried
    assert ts.last_telemetry["tel_bytes_tx"].shape == (2,)
    assert _curves_equal(js.last_telemetry, ts.last_telemetry) == []
    # disarmed: the window keeps the last curves; the state stays in step
    js.record_telemetry(jtel.TelemetryParams(record=False))
    ts.record_telemetry(ttel.TelemetryParams(record=False))
    assert ts._telemetry is None
    for s in (js, ts):
        s.advance(3000.0)
    assert _curves_equal(js.last_telemetry, ts.last_telemetry) == []
    assert interop.leaf_mismatches(_leaves(js.state),
                                   interop.state_to_numpy(ts.state)) == []
    ts.record_telemetry(ttel.TelemetryParams(record=True))
    ts.reset()
    assert ts.last_telemetry == {} and ts._telemetry is not None
    with pytest.raises(ValueError, match="degree_bins"):
        ts.record_telemetry(ttel.TelemetryParams(record=True, degree_bins=1))
