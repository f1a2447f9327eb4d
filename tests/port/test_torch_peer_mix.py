"""The mix relay under a peer mesh (ops/mix.py on a rank's rows,
runtime/sharded.py's mix_relay op) on 2 gloo CPU ranks (tests/port/
conftest.py's cpu_mesh) against the port's one-device Simulator and the
reference's single-device Simulator, bitwise:

  - NUMMIX 40 over 64 peers, so the mix nodes span both ranks' rows (32
    each), the publisher rotating from 36 (a mix node on rank 1) through
    37 and 38, in config 5's bounded delivery;
  - byte counters planted with fractional float32 values before the
    messages, so each owner's single add of the Sphinx wire bytes must
    round as the one-device index_add does;
  - records, latencies text, bytes_tx / bytes_rx, uplink_free_ms,
    rx_free_ms and the PRNG key after every message, and every state
    leaf at the end; then the mix nodes killed until fewer than MIXD are
    eligible: MixDegradedError on every side at the same publish, the
    state untouched;
  - the two helpers the relay adds to parallel/peer.py: prefix_rows for
    prefixes inside one rank, across both and of zero rows, and add_rows
    with fractional operands, against x[:m] and index_add."""

import copy
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

import peer_jobs

torch.set_num_threads(1)

N = 64
NUM_MIX = 40
LEAVES = ("bytes_tx", "bytes_rx", "uplink_free_ms", "rx_free_ms", "key")
_TOPO = dict(network_size=N, anchor_stages=3, min_bandwidth=50,
             max_bandwidth=150, min_latency=40, max_latency=130,
             msg_size_bytes=5000, messages=3, delay_seconds=1.5)


def _cfgs():
    kw = dict(connect_to=6, warmup_s=4.0, seed=7, uses_mix=True,
              num_mix=NUM_MIX, mix_d=4, publisher_id=36,
              publisher_rotation=True, serialize_answers=False)
    return (tsim.ExperimentConfig(topo=TTopo(**_TOPO), **kw),
            jsim.ExperimentConfig(topo=JTopo(**_TOPO), **kw))


def _jleaves(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def _text(sim):
    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return buf.getvalue()


def _plant(rng):
    """Fractional float32 byte counters (the same on every side)."""
    return {k: (rng.random(N) * 3e6).astype(np.float32)
            for k in ("bytes_tx", "bytes_rx")}


def _same_record(a, b):
    assert a.publisher == b.publisher and a.msg_id == b.msg_id
    assert a.delays_ms.tobytes() == b.delays_ms.tobytes()
    for k in ("received", "sends", "copies_rx"):
        assert np.asarray(getattr(a, k)).tobytes() == \
            np.asarray(getattr(b, k)).tobytes(), k


def test_mix_relay_on_a_mesh_equals_one_device_and_the_reference(cpu_mesh):
    tcfg, jcfg = _cfgs()
    one = tsim.Simulator(copy.deepcopy(tcfg), device="cpu")
    mesh = tsim.Simulator(tcfg, mesh=cpu_mesh)
    ref = jsim.Simulator(jcfg)
    try:
        for s in (one, mesh, ref):
            s.warmup()
        planted = _plant(np.random.default_rng(3))
        one.state = one.state.replace(
            **{k: torch.from_numpy(v) for k, v in planted.items()})
        mesh.state = mesh.state.replace(
            **{k: torch.from_numpy(v) for k, v in planted.items()})
        ref.state = ref.state.replace(
            **{k: jnp.asarray(v) for k, v in planted.items()})
        pub = tcfg.publisher_id
        for i in range(3):
            if i:
                for s in (one, mesh, ref):
                    s.advance(1500.0)
            recs = [s.publish(pub + i) for s in (one, mesh, ref)]
            _same_record(recs[0], recs[1])
            _same_record(recs[0], recs[2])
            want = _jleaves(ref.state)
            for got in (interop.state_to_numpy(one.state),
                        interop.state_to_numpy(mesh.state)):
                assert interop.leaf_mismatches(
                    {k: want[k] for k in LEAVES},
                    {k: got[k] for k in LEAVES}) == []
        # the relay wrote every hop's counters: the planted values moved
        moved = interop.state_to_numpy(mesh.state)["bytes_tx"]
        assert (moved[:NUM_MIX] != planted["bytes_tx"][:NUM_MIX]).sum() >= 4
        assert _text(mesh) == _text(one) == _text(ref)
        assert interop.leaf_mismatches(
            _jleaves(ref.state), interop.state_to_numpy(mesh.state)) == []
        assert interop.leaf_mismatches(
            interop.state_to_numpy(one.state),
            interop.state_to_numpy(mesh.state)) == []

        # all but 3 mix nodes dead: degraded at the same publish
        alive = np.arange(N) >= NUM_MIX - 3
        one.state = one.state.replace(alive=torch.from_numpy(alive))
        mesh.state = mesh.state.replace(alive=torch.from_numpy(alive))
        ref.state = ref.state.replace(alive=jnp.asarray(alive))
        before = interop.state_to_numpy(mesh.state)
        for s, err in ((one, tsim.MixDegradedError),
                       (mesh, tsim.MixDegradedError),
                       (ref, jsim.MixDegradedError)):
            with pytest.raises(err, match="3 eligible mix nodes"):
                s.publish(5)
        assert interop.leaf_mismatches(
            before, interop.state_to_numpy(mesh.state)) == []
        assert len(mesh.records) == 3
        stats = mesh.collectives()
        assert all(s["broadcast"] > 0 and s["broadcast_bytes"] > 0
                   for s in stats)
    finally:
        mesh.close()


def test_prefix_rows_and_add_rows_on_two_ranks(cpu_mesh):
    rng = np.random.default_rng(11)
    x = (rng.random(N) * 1e7).astype(np.float32) + np.float32(0.37)
    idx = rng.choice(N, 9, replace=False).astype(np.int64)
    val = (rng.random(9) * 7.3).astype(np.float32)
    prefixes = (5, 32, NUM_MIX, N, 0)
    outs = cpu_mesh.pool.run(peer_jobs.rows_helpers,
                             [(x, idx, val, prefixes)] * 2)
    want = torch.from_numpy(x).index_add(
        0, torch.from_numpy(idx), torch.from_numpy(val)).numpy()
    assert np.concatenate([o[1] for o in outs]).tobytes() == want.tobytes()
    for got, _, stats in outs:
        for m, g in zip(prefixes, got):
            assert g.tobytes() == x[:m].tobytes(), m
        assert stats["all_gather"] == len(prefixes)
        assert stats["all_reduce"] == 0 and stats["broadcast"] == 0
