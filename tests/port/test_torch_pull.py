"""The port's reverse-slot pulls (ops/pull.py) against the reference's, on
both dispatch branches: the (N, C, C) row gather below the memory budget
and the two-index gather above it (the budget lowered in both packages)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dst_libp2p_test_node_tpu.ops.pull as jpull
import dst_libp2p_test_node_tpu_torch.ops.pull as tpull
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph

torch.set_num_threads(1)

N = 96


@pytest.fixture(params=["row_gather", "two_index"])
def branch(request, monkeypatch):
    if request.param == "two_index":
        monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
        monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
    return request.param


def _inputs(seed=0):
    g = build_connection_graph(N, 6, seed=seed)
    rng = np.random.default_rng(seed)
    c = g.capacity
    vals = rng.uniform(0, 1e4, size=(N, c)).astype(np.float32)
    vals[rng.random((N, c)) < 0.2] = np.float32(3.4e38)
    mask = rng.random((N, c)) < 0.4
    per_f = rng.uniform(0, 500, size=N).astype(np.float32)
    per_b = rng.random(N) < 0.7
    return g, vals, mask, per_f, per_b


def test_budget_decision_matches_the_reference(branch):
    for dtype_j, dtype_t in ((jnp.bool_, torch.bool),
                             (jnp.float32, torch.float32)):
        for shape in ((100_000, 40), (1_000_000, 40), (N, 24)):
            for bf in (1, 2, 9):
                assert (tpull.exceeds_budget(dtype_t, shape, bf)
                        == jpull.exceeds_budget(dtype_j, shape, bf))


@pytest.mark.parametrize("seed", [0, 1])
def test_pulls_bitwise(branch, seed):
    g, vals, mask, per_f, per_b = _inputs(seed)
    cj, rj = jnp.asarray(g.conns), jnp.asarray(g.rev)
    ct, rt = torch.from_numpy(g.conns), torch.from_numpy(g.rev)
    pairs = [
        (jpull.reciprocal_pull_bool(jnp.asarray(mask), cj, rj),
         tpull.reciprocal_pull_bool(torch.from_numpy(mask), ct, rt)),
        (jpull.reciprocal_pull_min(jnp.asarray(vals), cj, rj),
         tpull.reciprocal_pull_min(torch.from_numpy(vals), ct, rt)),
        (jpull.neighbor_pull_bool(jnp.asarray(per_b), cj, rj),
         tpull.neighbor_pull_bool(torch.from_numpy(per_b), ct, rt)),
        (jpull.neighbor_pull_min(jnp.asarray(per_f), cj, rj),
         tpull.neighbor_pull_min(torch.from_numpy(per_f), ct, rt)),
        (jpull.reciprocal_pull_min(jnp.asarray(vals), cj, rj,
                                   batch_factor=3),
         tpull.reciprocal_pull_min(torch.from_numpy(vals), ct, rt,
                                   batch_factor=3)),
    ]
    for i, (want, got) in enumerate(pairs):
        want, got = np.asarray(want), got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, i
        assert got.tobytes() == want.tobytes(), i
