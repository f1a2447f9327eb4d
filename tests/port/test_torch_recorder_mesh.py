"""The flight recorder on a peer mesh (runtime/sharded.ShardedSimulator.
record_telemetry on tests/port/conftest.py's two gloo CPU ranks) against
the reference's one-device Simulator.record_telemetry, bitwise:

  - every tel_* curve of the warm-up, of the heartbeats after fractional
    byte counters and uplink backlogs are planted in every row (a
    fractional carry: the float sums and the queue depth over values a
    split would reassociate) and, disarmed, the curves kept and the state
    in step; re-armed, a reset clears them (tests/port/
    test_torch_telemetry.py's sequence, on the mesh);
  - with churn (the recorded heartbeats without the hoisted validity:
    each rank draws its rows of the churn, the curves count every peer).

Each rank records on its rows; the channels' counts are summed over the
ranks and their float sums and score quantiles read the gathered rows in
one place, so `last_telemetry` is the one-device layout and bytes."""

import dataclasses

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams
from dst_libp2p_test_node_tpu.ops import telemetry as jtel
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import telemetry as ttel
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 64


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _curves_bad(want: dict, got: dict) -> list:
    return interop.leaf_mismatches(
        {k: np.asarray(v) for k, v in want.items()}, got) + sorted(
        set(want) ^ set(got))


def _cfg(mod, topo, churn):
    kw = (dict(churn_down_per_hb=0.02, churn_up_per_hb=0.01) if churn
          else {})
    return mod.ExperimentConfig(
        topo=topo(network_size=N, msg_size_bytes=1500, messages=1),
        connect_to=8, warmup_s=6.0, seed=1, **kw)


@pytest.mark.parametrize("churn", [False, True])
def test_recorder_on_a_mesh(cpu_mesh, churn):
    js = jsim.Simulator(_cfg(jsim, TopoParams, churn))
    ts = tsim.Simulator(_cfg(tsim, TTopo, churn), mesh=cpu_mesh)
    try:
        js.record_telemetry(jtel.TelemetryParams(record=True))
        ts.record_telemetry(ttel.TelemetryParams(record=True))
        for s in (js, ts):
            s.warmup()
        assert ts.last_telemetry["tel_score_q"].shape == (6, 3)
        assert _curves_bad(js.last_telemetry, ts.last_telemetry) == []
        rng = np.random.default_rng(3)
        planted = {k: rng.uniform(0, 3e5, N).astype(np.float32)
                   for k in ("bytes_tx", "bytes_rx")}
        planted["uplink_free_ms"] = (float(js.state.t_ms) + rng.uniform(
            0, 5000, N)).astype(np.float32)
        js.state = js.state.replace(**planted)
        leaves = interop.state_to_numpy(ts.state)
        ts.state = interop.state_from_numpy(dict(leaves, **planted), "cpu")
        for s in (js, ts):
            s.advance(2500.0)     # two heartbeats, 500 ms carried
        assert ts.last_telemetry["tel_bytes_tx"].shape == (2,)
        assert float(ts.last_telemetry["tel_queue_depth_ms"][0]) > 0.0
        assert _curves_bad(js.last_telemetry, ts.last_telemetry) == []
        # disarmed: the curves stay; the state stays in step
        js.record_telemetry(jtel.TelemetryParams(record=False))
        ts.record_telemetry(ttel.TelemetryParams(record=False))
        assert ts._telemetry is None
        for s in (js, ts):
            s.advance(3000.0)
        assert _curves_bad(js.last_telemetry, ts.last_telemetry) == []
        assert interop.leaf_mismatches(
            _leaves(js.state), interop.state_to_numpy(ts.state)) == []
        ts.record_telemetry(ttel.TelemetryParams(record=True))
        ts.reset()
        assert ts.last_telemetry == {} and ts._telemetry is not None
        with pytest.raises(ValueError, match="degree_bins"):
            ts.record_telemetry(ttel.TelemetryParams(record=True,
                                                     degree_bins=1))
    finally:
        ts.close()
