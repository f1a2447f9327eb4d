"""The port's receiver-side fixpoint (parallel/exchange.py) against the
reference's converge_recv on the tests/test_exchange.py scenario shape:
t, inc and converged bitwise, with and without gossip, with a frozen
gossip floor, and when the iteration cap cuts the loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.parallel import exchange as jex
from dst_libp2p_test_node_tpu_torch.parallel import exchange as tex

torch.set_num_threads(1)

N = 64
PROC = 2.0
HB = 1000.0
INF = np.float32(3.4e38)


def _scenario(seed, with_gossip):
    """numpy inputs of build_recv_constants (test_exchange._scenario's
    distributions: random send sets, ranks, gossip targets, round offsets,
    uplink and downlink occupancy on half of the peers)."""
    rng = np.random.default_rng(seed)
    g = build_connection_graph(N, 6, seed=seed)
    c = g.capacity
    has = g.conns >= 0
    send = has & (rng.random((N, c)) < 0.7)
    gt = (has & ~send & (rng.random((N, c)) < 0.3)) if with_gossip \
        else np.zeros((N, c), bool)
    return dict(
        conns=g.conns, rev=g.rev,
        lat_edge=rng.uniform(40.0, 130.0, size=(N, c)).astype(np.float32),
        tx_ms=rng.uniform(0.5, 2.0, size=N).astype(np.float32),
        rank=np.argsort(np.argsort(rng.random((N, c)), axis=-1), axis=-1)
        .astype(np.float32),
        k_p=send.sum(axis=-1).astype(np.float32),
        send_mask=send,
        can_send=np.ones(N, bool),
        g_tgt=gt,
        g_off=(rng.integers(0, 3, size=(N, c)) * HB).astype(np.float32),
        hb_phase=rng.uniform(0, HB, size=N).astype(np.float32),
        uplink=(rng.uniform(0, 400, size=N) * (rng.random(N) < 0.5))
        .astype(np.float32),
        rx_const=(rng.uniform(0, 500, size=N) * (rng.random(N) < 0.5))
        .astype(np.float32),
    )


_ORDER = ("conns", "rev", "lat_edge", "tx_ms", "rank", "k_p", None,
          "send_mask", "can_send", "g_tgt", "g_off", "hb_phase", "uplink",
          "rx_const")


def _consts(mod, conv, sc, with_gossip, frag_idx):
    args = [frag_idx if k is None else conv(sc[k]) for k in _ORDER]
    return mod.build_recv_constants(*args, PROC, HB, with_gossip)


@pytest.mark.parametrize("with_gossip", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("max_iters,floor", [(64, False), (64, True),
                                             (3, False)])
def test_converge_recv_bitwise(with_gossip, seed, max_iters, floor):
    sc = _scenario(seed, with_gossip)
    frag_idx = np.float32(1.0) if seed == 2 else np.float32(0.0)
    cj = _consts(jex, jnp.asarray, sc, with_gossip, frag_idx)
    ct = _consts(tex, torch.from_numpy, sc, with_gossip,
                 torch.tensor(frag_idx))
    t0 = np.full(N, INF, np.float32)
    t0[seed] = np.float32(123.0)
    g_floor = None
    if floor:
        g_floor = np.random.default_rng(seed).uniform(
            300, 900, size=N).astype(np.float32)
    tj, incj, okj = jex.converge_recv(
        jnp.asarray(t0), cj, max_iters,
        g_floor=None if g_floor is None else jnp.asarray(g_floor))
    tt, inct, okt = tex.converge_recv(
        torch.from_numpy(t0), ct, max_iters,
        g_floor=None if g_floor is None else torch.from_numpy(g_floor))
    assert tt.numpy().tobytes() == np.asarray(tj).tobytes()
    assert inct.numpy().tobytes() == np.asarray(incj).tobytes()
    assert okt == bool(okj)
    if max_iters == 3:
        assert not okt        # the cap cut the loop
    else:
        assert okt and (tt.numpy() < 1e37).sum() > N // 2


def test_recv_constants_bitwise():
    sc = _scenario(3, True)
    cj = _consts(jex, jnp.asarray, sc, True, np.float32(0.0))
    ct = _consts(tex, torch.from_numpy, sc, True, torch.tensor(0.0))
    for name in ("src", "a_ms", "g_ms", "g_off", "phase", "u_ms", "flags",
                 "rx_c", "proc_ms", "hb_ms"):
        want = np.asarray(getattr(cj, name))
        got = getattr(ct, name).numpy()
        assert got.dtype == want.dtype, name
        assert got.tobytes() == want.tobytes(), name
