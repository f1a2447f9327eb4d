"""The port's service discovery (dst_libp2p_test_node_tpu_torch/ops/
servicedisco.py, runtime/sd_runtime.py) against the reference's, bitwise
on the CPU: advertise at a non-zero ipSimCoefficient with colliding store
events, refreshes and a full store; the grouped store-event application
against a literal one-event-at-a-time version; lookup with dead nodes and
past its deadline; expire_sweep; whole SDSimulator runs with their log
lines, records and summaries."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.ops import kad as jkad
from dst_libp2p_test_node_tpu.ops import servicedisco as jsd
from dst_libp2p_test_node_tpu.runtime import sd_runtime as jrt
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import kad as tkad
from dst_libp2p_test_node_tpu_torch.ops import servicedisco as tsd
from dst_libp2p_test_node_tpu_torch.runtime import sd_runtime as trt

torch.set_num_threads(1)

N = 64
SERVICES = ["svc-a", "svc-b", "svc-c"]


def same(want, got):
    assert interop.leaf_mismatches(interop.leaves_to_numpy(want),
                                   interop.leaves_to_numpy(got)) == []


def port(cls, obj):
    return interop.dataclass_from_numpy(cls, interop.leaves_to_numpy(obj),
                                        "cpu")


def t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def world(capacity=64, dead=()):
    """A reference kad state after bootstrap and one lookup wave, its
    stage map and latencies, the service keys and an empty store."""
    st = jkad.seed_bootstraps(jkad.init_kad_state(N, seed=4),
                              jnp.arange(2, dtype=jnp.int32))
    origins = jnp.arange(2, N, dtype=jnp.int32)
    stage = jnp.asarray(np.arange(N, dtype=np.int32) % 4)
    lat = jnp.asarray(np.random.default_rng(1).uniform(
        10, 60, (4, 4)).astype(np.float32))
    _, st = jkad.find_node(st, origins,
                           jkad.random_targets(jax.random.PRNGKey(2), N - 2),
                           stage, lat)
    if dead:
        alive = np.ones(N, bool)
        alive[list(dead)] = False
        st = st.replace(alive=jnp.asarray(alive))
    keys = jnp.asarray(np.stack([jsd.service_key(s) for s in SERVICES]))
    return st, stage, lat, keys, jsd.init_advert_store(N, capacity)


def test_service_key_copy():
    for s in SERVICES + ["", "x" * 100]:
        assert np.array_equal(tsd.service_key(s), jsd.service_key(s))


@pytest.mark.parametrize("coeff,capacity", [(0.0, 64), (0.37, 64),
                                            (2.5, 5)])
def test_advertise_matches_reference(coeff, capacity):
    st, stage, lat, keys, store = world(capacity)
    params_j = jsd.SDParams(k_store=6, safety_param=0.4,
                            ip_sim_coefficient=coeff,
                            advert_expiry_ms=3000.0)
    params_t = tsd.SDParams(**dataclasses.asdict(params_j))
    pst, pstore = port(tkad.KadState, st), port(tsd.AdvertStore, store)
    advs = np.arange(2, 40, dtype=np.int32)
    for tick, now in enumerate((1000.0, 2500.0, 5000.0)):
        # every advertiser on one service, then a mix: the records of all
        # of them collide on the few nodes closest to each key
        svc = (np.zeros(len(advs), np.int32) if tick == 0
               else (advs % 3).astype(np.int32))
        seq = np.full(len(advs), tick, np.int32)
        store, st, wj = jsd.advertise(
            store, st, jnp.asarray(advs), jnp.asarray(svc), keys,
            jnp.asarray(seq), stage, lat, jnp.float32(now), params_j)
        pstore, pst, wt = tsd.advertise(
            pstore, pst, t(advs), t(svc), t(np.asarray(keys)),
            torch.from_numpy(seq), t(np.asarray(stage)),
            torch.from_numpy(np.array(lat)),
            torch.tensor(now, dtype=torch.float32), params_t)
        same(store, pstore)
        same(st, pst)
        assert np.asarray(wj).tobytes() == wt.numpy().tobytes()


def _sequential_store(store, nodes, provider, service, seq_no, now, expiry):
    """The reference's store events one at a time (plain numpy)."""
    prov, svc = store["provider"].copy(), store["service"].copy()
    seq, exp = store["seq_no"].copy(), store["expires_ms"].copy()
    new_exp = np.float32(now) + np.float32(expiry)
    for i, node in enumerate(nodes):
        if node < 0:
            continue
        match = (prov[node] == provider[i]) & (svc[node] == service[i])
        free = (prov[node] < 0) | (exp[node] <= np.float32(now))
        if match.any():
            slot = int(np.argmax(match))
        elif free.any():
            slot = int(np.argmax(free))
        else:
            continue
        prov[node, slot], svc[node, slot] = provider[i], service[i]
        seq[node, slot], exp[node, slot] = seq_no[i], new_exp
    return dict(provider=prov, service=svc, seq_no=seq, expires_ms=exp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_store_events_equal_sequential(seed):
    rng = np.random.default_rng(seed)
    n, cap, e = 12, 6, 400
    store = tsd.init_advert_store(n, cap, device="cpu")
    leaves = interop.leaves_to_numpy(store)
    leaves["provider"][:] = rng.integers(-1, 20, (n, cap))
    leaves["service"][:] = rng.integers(0, 3, (n, cap))
    leaves["expires_ms"][:] = rng.choice([500.0, 900.0, 2000.0], (n, cap))
    store = interop.dataclass_from_numpy(tsd.AdvertStore, leaves, "cpu")
    nodes = rng.integers(-1, n, e)
    provider = rng.integers(0, 20, e).astype(np.int32)
    service = rng.integers(0, 3, e).astype(np.int32)
    seq_no = rng.integers(0, 9, e).astype(np.int32)
    got = tsd._store_events(store, torch.from_numpy(nodes),
                            torch.from_numpy(provider),
                            torch.from_numpy(service),
                            torch.from_numpy(seq_no),
                            torch.tensor(900.0), 750.5)
    want = _sequential_store(leaves, nodes, provider, service, seq_no,
                             900.0, 750.5)
    assert interop.leaf_mismatches(want, interop.leaves_to_numpy(got)) == []


@pytest.mark.parametrize("deadline", [30_000.0, 700.0, 1.0])
def test_lookup_matches_reference(deadline):
    st, stage, lat, keys, store = world(dead=(3, 9, 20, 21, 40, 41, 50))
    params_j = jsd.SDParams(k_store=6, query_timeout_ms=400.0,
                            lookup_deadline_ms=deadline,
                            advert_expiry_ms=4000.0)
    params_t = tsd.SDParams(**dataclasses.asdict(params_j))
    advs = np.arange(10, 34, dtype=np.int32)
    store, st, _ = jsd.advertise(
        store, st, jnp.asarray(advs), jnp.asarray(advs % 2), keys,
        jnp.zeros(len(advs), jnp.int32), stage, lat, jnp.float32(100.0),
        params_j)
    pst, pstore = port(tkad.KadState, st), port(tsd.AdvertStore, store)
    dis = np.arange(34, 60, dtype=np.int32)
    for now in (2000.0, 4500.0):           # the second lookup sees expiry
        store = jsd.expire_sweep(store, jnp.float32(now))
        pstore = tsd.expire_sweep(pstore, torch.tensor(now))
        same(store, pstore)
        rj, st = jsd.lookup(store, st, jnp.asarray(dis),
                            jnp.asarray(dis % 3), keys, stage, lat,
                            jnp.float32(now), params_j)
        rt, pst = tsd.lookup(pstore, pst, t(dis), t(dis % 3),
                             t(np.asarray(keys)), t(np.asarray(stage)),
                             torch.from_numpy(np.array(lat)),
                             torch.tensor(now, dtype=torch.float32),
                             params_t)
        same(rj, rt)
        same(st, pst)
    if deadline < 1000.0:
        assert not np.asarray(rj.ok).all()
    else:
        assert np.asarray(rj.timeouts).sum() > 0


@pytest.mark.parametrize("sdkw", [
    dict(), dict(ip_sim_coefficient=0.3, safety_param=0.5,
                 advert_expiry_ms=20_000.0)])
def test_sd_simulator_matches_reference(sdkw):
    kw = dict(network_size=N, n_bootstrap=2, n_advertisers=14,
              n_discoverers=12, n_hybrid=3, services=SERVICES[:2],
              discover_services=SERVICES, duration_s=45, seed=5)
    js = jrt.SDSimulator(jrt.SDConfig(sd=jsd.SDParams(**sdkw), **kw))
    ts = trt.SDSimulator(trt.SDConfig(sd=tsd.SDParams(**sdkw), **kw),
                         device="cpu")
    jsum, tsum = js.run(), ts.run()
    same(js.kstate, ts.kstate)
    same(js.store, ts.store)
    assert js.lines == ts.lines
    assert js.lookup_records == ts.lookup_records
    assert js.adv_latencies == ts.adv_latencies
    assert jsum.report() == tsum.report()


def test_config_from_env(monkeypatch):
    for k, v in (("PEERS", "50"), ("SD_ADVERTISERS", "5"),
                 ("SD_IP_SIM_COEFF", "0.25"), ("SD_SAFETY_PARAM", "0.5"),
                 ("ADVERTISE_SERVICES", "x,y"), ("DISCOVER_SERVICES", "y"),
                 ("LOOKUP_INTERVAL_SECONDS", "10")):
        monkeypatch.setenv(k, v)
    assert (dataclasses.asdict(trt.config_from_env())
            == dataclasses.asdict(jrt.config_from_env()))
    monkeypatch.setenv("SD_SAFETY_PARAM", "-1")
    with pytest.raises(ValueError):
        trt.config_from_env()
