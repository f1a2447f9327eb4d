"""The port's heartbeat (ops/heartbeat.py) against the reference, bitwise on
every SimState leaf: 30 heartbeats at n=200 with churn on and off and with
opportunistic grafting on and off, from a state carrying score counters so
the deferred decay (materialized by score_update) is live."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.ops import heartbeat as jhb
from dst_libp2p_test_node_tpu.ops import state as jst
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import heartbeat as thb
from dst_libp2p_test_node_tpu_torch.ops import state as tst

torch.set_num_threads(1)

N = 200


def _leaves(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _setup(churn, og, seed=1):
    g = build_connection_graph(N, 10, seed=seed, max_degree=40)
    kw = dict(churn_down_per_hb=churn, churn_up_per_hb=churn / 2,
              opportunistic_graft_threshold=og)
    pj = jst.SimParams(n=N, capacity=g.capacity, **kw)
    pt = tst.SimParams(n=N, capacity=g.capacity, **kw)
    sj = jst.init_state(pj, 7)
    rng = np.random.default_rng(seed)
    credit = rng.integers(0, 4, size=(N, g.capacity)).astype(np.float32)
    sj = sj.replace(fmd=jnp.asarray(credit))
    return g, pj, pt, sj


@pytest.mark.parametrize("churn", [0.0, 0.05])
@pytest.mark.parametrize("og", [-10000.0, 0.5])
def test_run_heartbeats_bitwise(churn, og):
    g, pj, pt, sj = _setup(churn, og)
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    want = jhb.run_heartbeats(sj, aj["conns"], aj["rev"], aj["out_mask"],
                              pj, 30)
    got = thb.run_heartbeats(st, at["conns"], at["rev"], at["out_mask"],
                             pt, 30)
    assert interop.leaf_mismatches(_leaves(want),
                                   interop.state_to_numpy(got)) == []
    # the scan did real work: meshes formed and counters decayed
    assert int(got.mesh_mask.sum()) > 0 and int(got.grafts.sum()) > 0


def test_heartbeat_step_plain_decay_bitwise():
    # one step without the deferred protocol: the gated per-step decay
    g, pj, pt, sj = _setup(0.0, -10000.0)
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    want = jhb.heartbeat_step(sj, aj["conns"], aj["rev"], aj["out_mask"],
                              pj)
    got = thb.heartbeat_step(st, at["conns"], at["rev"], at["out_mask"], pt)
    assert interop.leaf_mismatches(_leaves(want),
                                   interop.state_to_numpy(got)) == []


def test_mesh_repair_is_refused_not_approximated():
    # mesh repair is ported now (the campaign slice): the evict and px
    # branches run, bitwise against the reference, instead of raising
    g, pj, pt, sj = _setup(0.0, -10000.0)
    kw = dict(evict=True, px=True, eviction_threshold=-0.5, slow_weight=-1.0)
    pj, pt = dataclasses.replace(pj, **kw), dataclasses.replace(pt, **kw)
    aj, at = jst.graph_arrays(g), tst.graph_arrays(g, "cpu")
    rng = np.random.default_rng(3)
    sj = jhb.run_heartbeats(sj, aj["conns"], aj["rev"], aj["out_mask"], pj,
                            5)
    sj = sj.replace(slow_penalty=jnp.asarray(
        rng.integers(0, 3, (N, g.capacity)).astype(np.float32)))
    st = interop.state_from_numpy(_leaves(sj), "cpu")
    want = jhb.run_heartbeats(sj, aj["conns"], aj["rev"], aj["out_mask"],
                              pj, 3)
    got = thb.run_heartbeats(st, at["conns"], at["rev"], at["out_mask"],
                             pt, 3)
    assert interop.leaf_mismatches(_leaves(want),
                                   interop.state_to_numpy(got)) == []
    assert int(got.evictions.sum()) > 0
