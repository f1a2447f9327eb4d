"""The port's Kademlia substrate and kad-dht runtime
(dst_libp2p_test_node_tpu_torch/ops/kad.py, runtime/kad_runtime.py)
against the reference's, bitwise on the CPU: the key and distance
primitives, rtable_insert with repeats and full buckets, find_node (dead
peers, self lookups, the attacker hook), evict_failed with and without a
retry budget, connect_found, seed_bootstraps, random_targets, and whole
KadSimulator runs in both DISCOVERY modes with their log lines, lookup
records and summaries."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.ops import kad as jkad
from dst_libp2p_test_node_tpu.runtime import kad_runtime as jrt
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import kad as tkad
from dst_libp2p_test_node_tpu_torch.runtime import kad_runtime as trt

torch.set_num_threads(1)


def same(want, got):
    assert interop.leaf_mismatches(interop.leaves_to_numpy(want),
                                   interop.leaves_to_numpy(got)) == []


def to_port(jstate):
    return interop.dataclass_from_numpy(
        tkad.KadState, interop.leaves_to_numpy(jstate), "cpu")


def t(x, dtype=torch.int64):
    return torch.as_tensor(np.asarray(x).astype(np.int64)).to(dtype)


def warm_state(n, seed, waves=2, dead=()):
    """A reference state with bootstrapped and partly learned tables."""
    st = jkad.init_kad_state(n, seed=seed)
    st = jkad.seed_bootstraps(st, jnp.arange(2, dtype=jnp.int32))
    key = jax.random.PRNGKey(seed)
    origins = jnp.arange(2, n, dtype=jnp.int32)
    for _ in range(waves):
        key, k = jax.random.split(key)
        _, st = jkad.find_node(st, origins,
                               jkad.random_targets(k, n - 2),
                               jnp.zeros(n, jnp.int32),
                               jnp.full((1, 1), 10.0, jnp.float32))
    if dead:
        alive = np.ones(n, bool)
        alive[list(dead)] = False
        st = st.replace(alive=jnp.asarray(alive))
    return st


def test_make_keys_and_bit_primitives():
    assert np.array_equal(tkad.make_keys(50, 4), jkad.make_keys(50, 4))
    rng = np.random.default_rng(0)
    d = rng.integers(0, 1 << 32, size=(300, 4), dtype=np.uint32)
    d[:40] >>= rng.integers(0, 32, size=(40, 4)).astype(np.uint32)
    d[40:60, :3] = 0
    d[60:70] = 0
    d[70:90] = d[90:110]                  # ties: position breaks them
    jd = jnp.asarray(d)
    assert np.array_equal(tkad.xor_bitlen(t(d)).numpy(),
                          np.asarray(jkad.xor_bitlen(jd)))
    for b in (8, 24):
        assert np.array_equal(tkad.bucket_slot(t(d), b).numpy(),
                              np.asarray(jkad.bucket_slot(jd, b)))
    rows = d.reshape(3, 100, 4)
    assert np.array_equal(tkad.lex_argsort(t(rows)).numpy(),
                          np.asarray(jkad.lex_argsort(jnp.asarray(rows))))


@pytest.mark.parametrize("q", [1, 7, 64])
def test_random_targets_are_jax_random_bits(q):
    key = jax.random.split(jax.random.PRNGKey(9), 3)[1]
    want = np.asarray(jkad.random_targets(key, q))
    got = tkad.random_targets(t(np.asarray(key)), q).numpy()
    assert got.shape == (q, 4) and np.array_equal(got.astype(np.uint32),
                                                  want)


def test_rtable_insert_repeats_and_full_buckets():
    n = 40
    st = jkad.init_kad_state(n, n_buckets=6, k_bucket=3, seed=2)
    rng = np.random.default_rng(1)
    pst = to_port(st)
    for _ in range(4):
        owners = rng.permutation(n)[:12].astype(np.int32)
        cands = rng.integers(-1, n, size=(12, 9)).astype(np.int32)
        cands[:, 4] = cands[:, 1]                       # repeats
        cands[:, 5] = owners                            # self
        st = jkad.rtable_insert(st, jnp.asarray(owners), jnp.asarray(cands))
        pst = tkad.rtable_insert(pst, t(owners), t(cands))
        same(st, pst)
    assert (np.asarray(st.rtable) >= 0).all(axis=-1).any()   # a full bucket


@pytest.mark.parametrize("case", ["plain", "dead-and-self", "attacker"])
def test_find_node_matches_reference(case):
    n = 96
    dead = (5, 17, 40, 41) if case != "plain" else ()
    st = warm_state(n, 3, dead=dead)
    topo_stage = np.random.default_rng(2).integers(0, 5, n).astype(np.int32)
    lat = np.random.default_rng(3).uniform(20, 80, (5, 5)).astype(np.float32)
    origins = np.arange(3, 60, dtype=np.int32)
    targets = np.array(jkad.random_targets(jax.random.PRNGKey(4),
                                           len(origins)))
    if case == "dead-and-self":
        targets[::3] = np.asarray(st.keys)[origins[::3]]
    args_j = (jnp.asarray(origins), jnp.asarray(targets),
              jnp.asarray(topo_stage), jnp.asarray(lat))
    args_t = (t(origins), t(targets), t(topo_stage), torch.from_numpy(lat))
    if case == "attacker":
        attacker = np.zeros(n, bool)
        attacker[[7, 8, 30, 31, 70]] = True
        poison = np.random.default_rng(5).integers(
            60, n, (len(origins), jkad.K_RESP)).astype(np.int32)
        rj, sj = jkad._find_node_impl(st, *args_j, 6, 32,
                                      jnp.asarray(attacker),
                                      jnp.asarray(poison))
        rt, stt = tkad._find_node_impl(to_port(st), *args_t, 6, 32,
                                       torch.from_numpy(attacker),
                                       t(poison))
    else:
        rj, sj = jkad.find_node(st, *args_j, rounds=5, shortlist=24)
        rt, stt = tkad.find_node(to_port(st), *args_t, rounds=5,
                                 shortlist=24)
    same(rj, rt)
    same(sj, stt)
    assert int(np.asarray(rj.n_queries).sum()) > 0


@pytest.mark.parametrize("max_fails,backoff", [(1, 0.0), (3, 250.5)])
def test_evict_failed_and_connect_found(max_fails, backoff):
    n = 64
    st = warm_state(n, 6, dead=(9, 10, 11, 33))
    origins = np.arange(2, 40, dtype=np.int32)
    res, st = jkad.find_node(st, jnp.asarray(origins),
                             st.keys[jnp.asarray(origins)],
                             jnp.zeros(n, jnp.int32),
                             jnp.full((1, 1), 10.0, jnp.float32))
    found = np.asarray(res.closest).copy()
    found[:, -3:] = [9, 10, 33]                  # dials that fail
    pst = to_port(st)
    for step in range(4):
        st = st.replace(t_ms=st.t_ms + 100.0 * step)
        pst = pst.replace(t_ms=pst.t_ms + 100.0 * step)
        st = jkad.evict_failed(st, jnp.asarray(origins), jnp.asarray(found),
                               max_fails=max_fails, backoff_base_ms=backoff)
        pst = tkad.evict_failed(pst, t(origins), t(found),
                                max_fails=max_fails, backoff_base_ms=backoff)
        same(st, pst)
        if step == 1:
            # a revived peer's next dial succeeds and resets its counters
            alive = np.asarray(st.alive).copy()
            alive[10] = True
            st = st.replace(alive=jnp.asarray(alive))
            pst = pst.replace(alive=torch.from_numpy(alive))
    if max_fails > 1:
        assert (np.asarray(st.rt_fails) > 0).any()
    st = jkad.connect_found(st, jnp.asarray(origins), jnp.asarray(found))
    pst = tkad.connect_found(pst, t(origins), t(found))
    same(st, pst)


def test_seed_bootstraps_and_census():
    st = jkad.seed_bootstraps(jkad.init_kad_state(70, seed=8),
                              jnp.asarray([0, 1, 2], jnp.int32))
    pst = tkad.seed_bootstraps(tkad.init_kad_state(70, seed=8, device="cpu"),
                               torch.tensor([0, 1, 2]))
    same(st, pst)
    assert np.array_equal(tkad.rtable_census(pst).numpy(),
                          np.asarray(jkad.rtable_census(st)))


def test_true_closest_copy():
    keys = jkad.make_keys(30, 1)
    target = keys[7] ^ np.uint32(5)
    assert np.array_equal(tkad.true_closest(keys, target, 4),
                          jkad.true_closest(keys, target, 4))


def _records(sim):
    return [dataclasses.astuple(r) for r in sim.lookups]


@pytest.mark.parametrize("discovery,evict", [
    ("kad-dht", (1, 0.0)), ("extended", (1, 0.0)), ("extended", (3, 500.0))])
def test_kad_simulator_matches_reference(discovery, evict):
    kw = dict(network_size=80, n_bootstrap=2, n_probe=6, discovery=discovery,
              probe_duration_s=15.0, seed=4, evict_max_fails=evict[0],
              evict_backoff_ms=evict[1])
    js = jrt.KadSimulator(jrt.KadConfig(**kw))
    ts = trt.KadSimulator(trt.KadConfig(**kw), device="cpu")
    js.boot()
    ts.boot()
    js.warmup()
    ts.warmup()
    # churn between warm-up and probes: dead entries to evict (extended)
    alive = np.ones(80, bool)
    alive[[5, 6, 20, 21, 50]] = False
    js.state = js.state.replace(alive=jnp.asarray(alive))
    ts.state = ts.state.replace(alive=torch.from_numpy(alive))
    js.probe()
    ts.probe()
    same(js.state, ts.state)
    assert js.lines == ts.lines and _records(js) == _records(ts)
    assert js.summary().report() == ts.summary().report()


def test_config_from_env(monkeypatch):
    for k, v in (("PEERS", "40"), ("KAD_BOOTSTRAPS", "2"),
                 ("KAD_PROBES", "4"), ("DISCOVERY", "extended"),
                 ("SEED", "3")):
        monkeypatch.setenv(k, v)
    assert (dataclasses.asdict(trt.config_from_env())
            == dataclasses.asdict(jrt.config_from_env()))
    with pytest.raises(ValueError):
        trt.KadConfig(discovery="nope").validate()
