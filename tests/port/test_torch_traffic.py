"""The port's ETH2 load generator (runtime/traffic.py) against the
reference on the CPU: the topic mix and the request schedule; the
kill-and-restart chaos leg of run_service_load (an injected dispatch
failure, a cold kill, a warm restart from the periodic checkpoint) with
`bit_identical` true, the same records sha, counters and admission codes
as the reference, and the service checkpoint equal to the reference's
array by array; the HTTP overload run; batched = sequential dispatch; and
CUDA as the default device."""

import json

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.runtime import traffic as jt
from dst_libp2p_test_node_tpu_torch.runtime import traffic as tt

torch.set_num_threads(1)

# the reference's own chaos pin (tests/test_service_runtime.py)
_CHAOS = dict(n_peers=32, subnets=2, connect_to=5, warmup_s=5.0, seed=7,
              ticks=8, per_tick=3, tick_ms=200.0, max_queue_depth=8,
              max_batch=2, inject_failures=1, max_retries=1,
              retry_backoff_s=0.0, kill_at_tick=4, checkpoint_every=2,
              via_http=False)
_OVERLOAD = dict(n_peers=32, subnets=2, connect_to=5, warmup_s=5.0, seed=1,
                 ticks=8, per_tick=4, tick_ms=200.0, max_queue_depth=3,
                 max_batch=2, via_http=True)
# the report's keys that come from the simulation and the admission
# sequence (p50/p99 are host-wall sojourns, requests_per_s a host rate)
_SIM_KEYS = ("config", "offered", "admitted", "rejected", "shed_deadline",
             "dispatched", "quarantined", "retries", "batch_splits",
             "device_dispatches", "degraded", "shed_rate", "max_depth_seen",
             "queue_bound_held", "records_sha", "scrape", "kill")


@pytest.mark.parametrize("subnets,scale", [(1, 1.0), (4, 0.5), (64, 1.0)])
def test_mix_and_schedule(subnets, scale):
    tm, jm = tt.eth2_mix(subnets, scale), jt.eth2_mix(subnets, scale)
    assert [vars(x) for x in tm] == [vars(x) for x in jm]
    assert tt.topics_of(tm) == jt.topics_of(jm)
    assert len(tm) == 3 + subnets
    assert tt.build_schedule(tm, 5, 7, 3) == jt.build_schedule(jm, 5, 7, 3)
    with pytest.raises(ValueError):
        tt.eth2_mix(0)


def test_mainnet_mix_shape():
    mix = tt.eth2_mix(64)
    sizes = {t.topic: t.msg_size for t in mix}
    assert (sizes["blocks"], sizes["aggregates"], sizes["sync"]) == (
        18000, 3000, 1200)
    assert {sizes[f"att_{i}"] for i in range(64)} == {600}
    assert {t.tenant for t in mix} == {"blocks", "aggregates", "sync", "att"}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_kill_and_restart_matches_reference(tmp_path):
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    got = tt.run_service_load(**_CHAOS, checkpoint_path=tp, device="cpu")
    want = jt.run_service_load(**_CHAOS, checkpoint_path=jp)
    json.dumps(got, allow_nan=False)
    k = got["kill"]
    assert k["bit_identical"] is True and k["ref_codes_match"] is True
    assert k["resume_tick"] == 4 and k["messages"] == k["ref_messages"] > 0
    assert got["scrape"]["restarts_total"] == 1.0
    assert (got["scrape"]["retries_total"]
            + got["scrape"]["batch_splits_total"]) >= 1.0
    for key in _SIM_KEYS:
        assert got[key] == want[key], key
    # the last periodic checkpoint of the surviving lineage
    ta, ja = _npz(tp), _npz(jp)
    assert sorted(ta) == sorted(ja)
    for name in ta:
        if name != "service_json":
            assert ta[name].dtype == ja[name].dtype, name
            assert ta[name].tobytes() == ja[name].tobytes(), name
    tm, jm = (json.loads(bytes(x["service_json"]).decode()) for x in (ta, ja))
    tm.pop("ewma_ms")
    jm.pop("ewma_ms")
    assert tm == jm
    walls = got["walls"]
    assert set(walls["lineages"]) == {"reference", "victim", "restored"}
    assert walls["checkpoint_bytes"] > 0 and walls["checkpoint_save_s"]
    assert sum(c["messages"] for c in got["classes"].values()) == \
        k["messages"]


def test_http_overload_matches_reference():
    got = tt.run_service_load(**_OVERLOAD, device="cpu")
    want = jt.run_service_load(**_OVERLOAD)
    for key in _SIM_KEYS:
        assert got[key] == want[key], key
    assert got["rejected"] > 0 and got["queue_bound_held"]
    assert 0.0 < got["shed_rate"] < 1.0
    assert got["scrape_serves_service_family"] is True
    assert got["requests_per_s"] > 0


def test_batched_equals_sequential():
    kw = dict(_OVERLOAD, via_http=False, subnets=4, max_queue_depth=8)
    b = tt.run_service_load(**kw, dispatch_mode="batched", device="cpu")
    s = tt.run_service_load(**kw, dispatch_mode="sequential", device="cpu")
    assert b["records_sha"] == s["records_sha"]
    assert b["dispatched"] == s["dispatched"] > 0
    assert b["device_dispatches"] < s["device_dispatches"]


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.run_service_load(**_OVERLOAD)
