"""The port's connection-manager workload
(dst_libp2p_test_node_tpu_torch/ops/connmanager.py) against the
reference's, bitwise on the CPU: conn_step tick by tick for each reconnect
strategy with and without the hard cap, protected peers and a grace
period, and whole run_connmanager experiments (state, per-tick trace,
summary)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.ops import connmanager as jcm
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import connmanager as tcm

torch.set_num_threads(1)


def same(want, got):
    assert interop.leaf_mismatches(interop.leaves_to_numpy(want),
                                   interop.leaves_to_numpy(got)) == []


@pytest.mark.parametrize("strategy", [jcm.RECONNECT_NONE,
                                      jcm.RECONNECT_AGGRESSIVE,
                                      jcm.RECONNECT_BEFORE_GRACE, "mixed"])
@pytest.mark.parametrize("cap", [0, 9])
def test_conn_step_matches_reference(strategy, cap):
    kw = dict(n_hubs=3, n_peers=30, low_water=5, high_water=8,
              grace_period_s=2, silence_period_s=3, max_connections=cap,
              reconnect_interval_s=4)
    jp, tp = jcm.ConnManagerParams(**kw), tcm.ConnManagerParams(**kw)
    if strategy == "mixed":
        mode = np.arange(30, dtype=np.int32) % 3
    else:
        mode = np.full(30, strategy, np.int32)
    dial_out = np.ones(30, bool)
    dial_out[[3, 17]] = False
    protected = np.zeros(30, bool)
    protected[[0, 1, 12]] = True
    js = jcm.init_conn_state(jp, seed=5)
    ts = tcm.init_conn_state(tp, seed=5, device="cpu")
    args_j = tuple(jnp.asarray(x) for x in (mode, dial_out, protected))
    args_t = tuple(torch.from_numpy(x) for x in (mode, dial_out, protected))
    for _ in range(13):
        js = jcm.conn_step(js, *args_j, jp)
        ts = tcm.conn_step(ts, *args_t, tp)
        same(js, ts)
    if cap:
        assert int(js.rejected) > 0


@pytest.mark.parametrize("kw,pkw", [
    (dict(), dict()),
    (dict(n_none=24, n_aggressive=16, n_before_grace=8, n_protected=3,
          duration_s=90, seed=2),
     dict(n_hubs=4, n_peers=48, low_water=6, high_water=12,
          grace_period_s=3, silence_period_s=2, max_connections=14,
          reconnect_interval_s=7)),
])
def test_run_connmanager_matches_reference(kw, pkw):
    jsum, jst = jcm.run_connmanager(
        jcm.ConnManagerConfig(params=jcm.ConnManagerParams(**pkw), **kw))
    tsum, tst = tcm.run_connmanager(
        tcm.ConnManagerConfig(params=tcm.ConnManagerParams(**pkw), **kw),
        device="cpu")
    same(jst, tst)
    assert (jsum.trace.dtype == tsum.trace.dtype
            and jsum.trace.tobytes() == tsum.trace.tobytes())
    assert jsum.report() == tsum.report()


def test_config_from_env(monkeypatch):
    for k, v in (("NUM_HUBS", "2"), ("WATERMARK_LOW", "4"),
                 ("WATERMARK_HIGH", "9"), ("MAX_CONNECTIONS", "11"),
                 ("CONNMGR_PEERS_NONE", "7"), ("PROTECTED_PEERS", "a,b"),
                 ("CONNMGR_DURATION_S", "33")):
        monkeypatch.setenv(k, v)
    assert (dataclasses.asdict(tcm.config_from_env())
            == dataclasses.asdict(jcm.config_from_env()))
    with pytest.raises(ValueError):
        tcm.ConnManagerParams(low_water=5, high_water=4).validate()
