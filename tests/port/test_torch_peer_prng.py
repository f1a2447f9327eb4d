"""Row-block draws of the port's threefry (prng.py `rows=`, and
parallel/peer.uniform on a rank): rows [r0, r1) of a draw are the draw of
their own counters, so a rank of the peer mesh draws its rows without the
others. Each block equals the matching slice of the port's full draw and
of jax.random's (partitionable threefry), bitwise, for uniform,
random_bits and randint over (N,) and (N, C), and on the middle axis of
the loss model's (F, N, C) draw."""

import jax
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu_torch import prng
from dst_libp2p_test_node_tpu_torch.parallel import peer

torch.set_num_threads(1)

N = 48


def _key_np(key):
    return np.asarray(key).astype(np.int64)


def _jax_draw(kind, key, shape):
    if kind == "uniform":
        return np.asarray(jax.random.uniform(key, shape)).view(np.int32)
    if kind == "random_bits":
        return np.asarray(jax.random.bits(key, shape)).astype(np.int64)
    return np.asarray(jax.random.randint(key, shape, 3, 1000)).astype(
        np.int32)


def _port_draw(kind, key, shape, rows=None, axis=0):
    if kind == "uniform":
        return prng.uniform(key, shape, rows, axis).numpy().view(np.int32)
    if kind == "random_bits":
        return prng.random_bits(key, shape, rows, axis).numpy()
    return prng.randint(key, shape, 3, 1000, rows, axis).numpy()


@pytest.mark.parametrize("kind", ["uniform", "random_bits", "randint"])
@pytest.mark.parametrize("shape", [(N,), (N, 40)])
@pytest.mark.parametrize("ranks", [2, 4, 3])
def test_row_blocks_are_slices_of_the_whole_draw(kind, shape, ranks):
    jkey = jax.random.split(jax.random.PRNGKey(17), 3)[1]
    key = torch.from_numpy(_key_np(jkey))
    whole = _port_draw(kind, key, shape)
    want = _jax_draw(kind, jkey, shape)
    assert np.array_equal(whole, want)
    per = N // ranks
    for r in range(ranks):
        block = _port_draw(kind, key, shape, rows=(r * per, (r + 1) * per))
        assert block.shape == (per,) + shape[1:]
        assert np.array_equal(block, want[r * per:(r + 1) * per])


def test_middle_axis_block_of_the_loss_draw():
    jkey = jax.random.PRNGKey(3)
    key = torch.from_numpy(_key_np(jkey))
    shape = (4, N, 12)
    want = np.asarray(jax.random.uniform(jkey, shape)).view(np.int32)
    got = prng.uniform(key, shape, rows=(16, 40), axis=1).numpy()
    assert np.array_equal(got.view(np.int32), want[:, 16:40])
    with pytest.raises(ValueError):
        prng.uniform(key, shape, rows=(40, 60), axis=1)


def test_peer_uniform_on_a_rank_is_its_rows():
    # no process group is needed to draw: the group only names the rows
    jkey = jax.random.PRNGKey(9)
    key = torch.from_numpy(_key_np(jkey))
    want = np.asarray(jax.random.uniform(jkey, (N, 7))).view(np.int32)
    assert np.array_equal(peer.uniform(key, (N, 7)).numpy().view(np.int32),
                          want)
    for r in range(4):
        grp = peer.PeerGroup(r, 4, N, "cpu", backend="gloo")
        with peer.using(grp):
            got = peer.uniform(key, (N // 4, 7)).numpy().view(np.int32)
            assert np.array_equal(got, want[grp.r0:grp.r1])
            assert peer.row_ids(N // 4, "cpu").tolist() == list(
                range(grp.r0, grp.r1))
            with pytest.raises(ValueError):
                peer.uniform(key, (N, 7))
    assert peer.active() is None
