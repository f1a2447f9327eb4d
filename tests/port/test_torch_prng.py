"""The port's threefry draws (dst_libp2p_test_node_tpu_torch/prng.py) are
bit-for-bit jax.random's: PRNGKey, split and uniform, in the partitionable
mode the reference runs under."""

import jax
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu_torch import prng

torch.set_num_threads(1)


def _key_np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2**31 - 1, -3])
def test_prng_key_matches_jax(seed):
    assert np.array_equal(prng.PRNGKey(seed).numpy(),
                          _key_np(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 5, 17])
def test_split_matches_jax(num):
    key = jax.random.PRNGKey(11)
    got = prng.split(prng.PRNGKey(11), num).numpy()
    assert np.array_equal(got, _key_np(jax.random.split(key, num)))


@pytest.mark.parametrize("shape", [(2,), (1,), (13,), (200,), (7, 5),
                                   (64, 40), (3, 4, 5)])
def test_uniform_matches_jax_bitwise(shape):
    key = jax.random.split(jax.random.PRNGKey(5), 3)[2]
    want = np.asarray(jax.random.uniform(key, shape))
    got = prng.uniform(torch.from_numpy(_key_np(key)), shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert (got >= 0.0).all() and (got < 1.0).all()


def test_nested_splits_follow_the_reference_schedule():
    # the heartbeat/disseminate key schedule: split, take a row, split again
    kj, kt = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for width in (5, 3, 4, 5, 2):
        kj = jax.random.split(kj, width)[width - 1]
        kt = prng.split(kt, width)[width - 1]
        assert np.array_equal(kt.numpy(), _key_np(kj))
    want = np.asarray(jax.random.uniform(kj, (33, 9)))
    got = prng.uniform(kt, (33, 9)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("q", [1, 3, 100, 9897])
def test_random_bits_matches_jax_at_q_by_4(q):
    # the kad lookup targets: jax.random.bits(key, (q, 4), uint32)
    key = jax.random.split(jax.random.PRNGKey(21), 2)[1]
    want = np.asarray(jax.random.bits(key, (q, 4), dtype=jax.numpy.uint32))
    got = prng.random_bits(torch.from_numpy(_key_np(key)), (q, 4)).numpy()
    assert got.shape == (q, 4) and got.min() >= 0 and got.max() < 2**32
    assert np.array_equal(got.astype(np.uint32), want)
