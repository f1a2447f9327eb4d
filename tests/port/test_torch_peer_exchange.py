"""The peer mesh's fixpoint (parallel/exchange.converge_sharded, with
build_recv_constants on a rank) on 2 and 4 gloo CPU ranks against the
reference's single-device converge_recv on the same constants
(tests/test_exchange.py's scenario shape): t, inc and converged bitwise,
with and without a frozen gossip floor, packed (bf16 cost tables) and
not, and when the iteration cap cuts the loop; one all-gather of t and
one all-reduce of the changed bit per sweep. Uneven rows are refused,
and a rank that dies inside a collective makes the caller raise
RankError (parallel/ranks.py), after which the pool starts again."""

import jax.numpy as jnp
import numpy as np
import peer_jobs
import pytest
import torch

from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.parallel import exchange as jex
from dst_libp2p_test_node_tpu_torch.parallel import exchange as tex
from dst_libp2p_test_node_tpu_torch.parallel import peer
from dst_libp2p_test_node_tpu_torch.parallel.ranks import RankError, RankPool

torch.set_num_threads(1)

N = 64
PROC = 2.0
HB = 1000.0
INF = np.float32(3.4e38)


@pytest.fixture(scope="module")
def pools(cpu_mesh):
    with RankPool(["cpu"] * 4, threads=1) as p4:
        yield {2: cpu_mesh.pool, 4: p4}


def _scenario(seed, with_gossip):
    """numpy inputs of build_recv_constants (tests/port/
    test_torch_exchange.py's distributions)."""
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


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_converge_sharded_equals_reference(pools, ranks, floor, packed):
    seed = 2 if packed else 1
    sc = _scenario(seed, with_gossip=True)
    frag_idx = np.float32(1.0) if floor else np.float32(0.0)
    args = [frag_idx if k is None else jnp.asarray(sc[k])
            for k in peer_jobs._ORDER]
    cj = jex.build_recv_constants(*args, PROC, HB, True, packed=packed)
    t0 = np.full(N, INF, np.float32)
    t0[seed] = np.float32(123.0)
    g_floor = (np.random.default_rng(seed).uniform(300, 900, size=N)
               .astype(np.float32) if floor else None)
    for max_iters in (64, 3):
        tj, incj, okj = jex.converge_recv(
            jnp.asarray(t0), cj, max_iters,
            g_floor=None if g_floor is None else jnp.asarray(g_floor))
        outs = pools[ranks].run(
            peer_jobs.converge_rows,
            [(sc, float(frag_idx), True, packed, max_iters, t0, g_floor,
              PROC, HB)] * ranks)
        t = np.concatenate([o[0] for o in outs])
        inc = np.concatenate([o[1] for o in outs])
        assert np.array_equal(t.view(np.int32),
                              np.asarray(tj).view(np.int32))
        assert np.array_equal(inc.view(np.int32),
                              np.asarray(incj).view(np.int32))
        assert all(o[2] == bool(okj) for o in outs)
        assert bool(okj) == (max_iters == 64)
        # per sweep one all-gather of t and one all-reduce of the bit,
        # plus the one-time gathers of the sender tables
        stats = outs[0][3]
        assert stats["all_gather"] - stats["all_reduce"] == 7
        assert all(o[3] == stats for o in outs)


def test_uneven_rows_and_no_group_are_refused():
    with pytest.raises(ValueError, match="divide evenly"):
        peer.PeerGroup(0, 2, 63, "cpu", backend="gloo")
    with pytest.raises(ValueError, match="divide evenly"):
        peer.PeerGroup(1, 4, 30, "cpu", backend="gloo")
    sc = _scenario(1, with_gossip=False)
    args = [torch.tensor(0.0) if k is None else torch.from_numpy(sc[k])
            for k in peer_jobs._ORDER]
    cst = tex.build_recv_constants(*args, PROC, HB, False)
    with pytest.raises(ValueError, match="PeerGroup"):
        tex.converge_sharded(torch.full((N,), float(INF)), cst, 8)


def test_a_rank_dying_in_a_collective_raises(pools):
    pool = pools[2]
    with pytest.raises(RankError, match="rank 1"):
        pool.run(peer_jobs.die_in_a_collective, [1, 1], deadline_s=120)
    # the pool starts again on its next job
    rows = pool.run(peer_jobs.rows_of, [64, 64])
    assert [r.tolist() for r in rows] == [list(range(32)),
                                          list(range(32, 64))]
