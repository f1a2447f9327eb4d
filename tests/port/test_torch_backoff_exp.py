"""XLA-CPU's float32 `exp` in the port (ops/xlamath.exp_f32, exp2_f32) and
the backoff of ops/kad.evict_failed that rides it, against the reference
on the CPU:

  - exp_f32 / exp2_f32 against jnp.exp / jnp.exp2 bit for bit on 2M
    seeded float32 inputs (uniform over the whole range, near zero, and
    raw bit patterns, subnormals and NaNs included) and the edge values
    (0, -0, +-inf, NaN, subnormals, the overflow and underflow
    thresholds, the integers 0..40);
  - evict_failed at max_fails 1, 14, 15, 20 and 31 bit for bit on every
    leaf, with the fail counters preset across the whole range so every
    backoff exponent is taken (its `t + base * exp2(fails - 1)` is one
    FMA in the reference), and for max_fails <= 14 the bytes of the
    power-of-two backoff the port used before;
  - `attack --dht-evict-max-fails 20`: the JSON artifact equal to the JAX
    CLI's outside the wall fields.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu import cli as jcli
from dst_libp2p_test_node_tpu.ops import kad as jkad
from dst_libp2p_test_node_tpu_torch import cli as tcli
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.ops import kad as tkad
from dst_libp2p_test_node_tpu_torch.ops import xlamath

torch.set_num_threads(1)

EDGES = np.array(
    [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-40, -1e-40,
     1.1754942e-38, 88.72, 88.7228, 88.73, 88.8, 88.81, 89.0, 127.0, 127.99,
     128.0, 129.0, -87.33, -87.34, -87.8, -88.0, -103.0, -103.28, -104.0,
     -126.0, -127.0, -149.0, -150.0, 3.4e38, -3.4e38]
    + list(range(41)), dtype=np.float32)


def _inputs():
    rng = np.random.default_rng(20261017)
    bits = rng.integers(0, 2 ** 32, 500_000, dtype=np.uint64)
    return np.concatenate([
        rng.uniform(-160.0, 160.0, 1_000_000).astype(np.float32),
        rng.uniform(-2.0, 2.0, 500_000).astype(np.float32),
        bits.astype(np.uint32).view(np.float32),
        EDGES])


def _same_bits(want: np.ndarray, got: np.ndarray) -> np.ndarray:
    return ((want.view(np.uint32) == got.view(np.uint32))
            | (np.isnan(want) & np.isnan(got)))


@pytest.mark.parametrize("name", ["exp", "exp2"])
def test_exp_matches_xla_bit_for_bit(name):
    x = _inputs()
    assert x.size >= 2_000_000
    ref = np.asarray(jax.jit(getattr(jnp, name))(x))
    port = getattr(xlamath, f"{name}_f32")(torch.from_numpy(x)).numpy()
    ok = _same_bits(ref, port)
    assert ok.all(), (x[~ok][:8], ref[~ok][:8], port[~ok][:8])
    if name == "exp2":
        # the reference's exp2 is exp(x ln 2): inexact from 2^13 on
        assert port[x.size - 41 + 13] == np.float32(8192.00390625)
    with pytest.raises(TypeError):
        xlamath.exp_f32(torch.zeros(2, dtype=torch.float64))


def _kad_fixture(n=64):
    st = jkad.init_kad_state(n, seed=6)
    st = jkad.seed_bootstraps(st, jnp.arange(2, dtype=jnp.int32))
    key = jax.random.PRNGKey(6)
    origins = jnp.arange(2, n, dtype=jnp.int32)
    for _ in range(2):
        key, k = jax.random.split(key)
        _, st = jkad.find_node(st, origins, jkad.random_targets(k, n - 2),
                               jnp.zeros(n, jnp.int32),
                               jnp.full((1, 1), 10.0, jnp.float32))
    alive = np.ones(n, bool)
    alive[[9, 10, 11, 33]] = False
    st = st.replace(alive=jnp.asarray(alive))
    q = np.arange(2, 40, dtype=np.int32)
    res, st = jkad.find_node(st, jnp.asarray(q), st.keys[jnp.asarray(q)],
                             jnp.zeros(n, jnp.int32),
                             jnp.full((1, 1), 10.0, jnp.float32))
    found = np.asarray(res.closest).copy()
    found[:, -3:] = [9, 10, 33]                  # dials that fail
    return st, q, found


class _PowerOfTwoBackoff:
    """The backoff arithmetic of the port's evict_failed before exp2_f32:
    an exact power of two (ldexp) and two roundings."""

    @staticmethod
    def exp2_f32(x):
        return torch.ldexp(torch.ones_like(x),
                           x.clamp_min(0).to(torch.int32))

    @staticmethod
    def fma_f32(a, b, c):
        return c + a * b


@pytest.mark.parametrize("max_fails", [1, 14, 15, 20, 31])
def test_evict_failed_backoff_matches_reference(max_fails, monkeypatch):
    st0, q, found = _kad_fixture()
    rng = np.random.default_rng(max_fails)
    shape = np.asarray(st0.rt_fails).shape
    dtype = np.asarray(st0.rt_fails).dtype
    taken = set()
    for base in (37.3, 250.5, 1.1):
        for t_ms in (0.7, 1234.567, 98765.43, 3.3e6 + 0.3):
            fails = rng.integers(0, max_fails, shape).astype(dtype)
            st = st0.replace(rt_fails=jnp.asarray(fails),
                             t_ms=jnp.asarray(np.float32(t_ms)))
            pst = interop.dataclass_from_numpy(
                tkad.KadState, interop.leaves_to_numpy(st), "cpu")
            want = jkad.evict_failed(st, jnp.asarray(q), jnp.asarray(found),
                                     max_fails=max_fails,
                                     backoff_base_ms=base)
            got = tkad.evict_failed(pst, torch.from_numpy(q).long(),
                                    torch.from_numpy(found).long(),
                                    max_fails=max_fails,
                                    backoff_base_ms=base)
            assert interop.leaf_mismatches(
                interop.leaves_to_numpy(want),
                interop.leaves_to_numpy(got)) == [], (base, t_ms)
            retry = np.asarray(want.rt_retry_ms)
            taken |= set(np.unique(np.asarray(want.rt_fails)[retry > 0]))
            if max_fails <= 14:
                with monkeypatch.context() as m:
                    m.setattr(tkad, "xlamath", _PowerOfTwoBackoff)
                    old = tkad.evict_failed(
                        pst, torch.from_numpy(q).long(),
                        torch.from_numpy(found).long(),
                        max_fails=max_fails, backoff_base_ms=base)
                assert interop.leaf_mismatches(
                    interop.leaves_to_numpy(old),
                    interop.leaves_to_numpy(got)) == []
    # every backoff exponent below the eviction count was exercised
    assert taken >= set(range(1, max_fails)), sorted(taken)


def test_attack_cli_with_a_deep_retry_budget(tmp_path, capsys):
    argv = ["-n", "48", "--connect-to", "4", "--fractions", "0.25",
            "--seeds", "0", "--messages", "1", "--attack-heartbeats", "4",
            "--warmup-s", "2", "--recovery-heartbeats", "4", "--evict",
            "--redial", "--dht-eclipse", "--dht-poison", "--dht-heal-hb",
            "2", "--dht-evict-max-fails", "20", "--dht-evict-backoff-ms",
            "37.5"]
    outs = []
    for name, mod, extra in (("j", jcli, []),
                             ("t", tcli, ["--device", "cpu"])):
        js = tmp_path / f"{name}.json"
        assert mod.cmd_attack(argv + extra + ["--json", str(js)]) == 0
        d = json.loads(js.read_text())
        d.pop("wall_s")
        d.pop("trials_per_s")
        d["trials"] = [{k: v for k, v in t.items() if k != "wall_s"}
                       for t in d["trials"]]
        outs.append(d)
    capsys.readouterr()
    assert outs[0] == outs[1]
    assert any(t["rtable_poison_frac"] >= 0.0 for t in outs[1]["trials"])
