"""The port's packed dissemination constants (SimParams.packed_state,
parallel/exchange.build_recv_constants(packed=True)) against the
reference's: the packed layout's dtypes; port-packed bitwise against
JAX-packed for build_recv_constants, converge_recv and a receiver-side
Simulator run (the pull budget lowered, as tests/test_exact_prefix.py
does); packed against unpacked within the reference's own tolerance
(rtol 1e-2, atol 25 ms)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dst_libp2p_test_node_tpu.ops.pull as jpull
import dst_libp2p_test_node_tpu_torch.ops.pull as tpull
from dst_libp2p_test_node_tpu.config.topology import TopoParams
from dst_libp2p_test_node_tpu.ops.disseminate import disseminate as jdis
from dst_libp2p_test_node_tpu.ops.graph import build_connection_graph
from dst_libp2p_test_node_tpu.parallel import exchange as jex
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.parallel import exchange as tex
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

TABLES = ("a_ms", "g_ms", "g_off", "phase")


def _bits(x):
    """Raw bytes and dtype name of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        return name, x.view(torch.int16).numpy().tobytes() \
            if x.dtype == torch.bfloat16 else x.numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.tobytes()


def _scenario(seed=0, n=64):
    """The inputs of one receiver-side fixpoint, as numpy arrays."""
    rng = np.random.default_rng(seed)
    g = build_connection_graph(n, 6, seed=seed)
    c = g.capacity
    has = g.conns >= 0
    send = has & (rng.random((n, c)) < 0.7)
    return dict(
        conns=g.conns, rev=g.rev,
        lat_edge=rng.uniform(40.0, 130.0, (n, c)).astype(np.float32),
        tx_ms=rng.uniform(0.5, 2.0, n).astype(np.float32),
        rank=np.argsort(np.argsort(rng.random((n, c)), -1), -1)
        .astype(np.float32),
        k_p=send.sum(-1).astype(np.float32),
        send_mask=send,
        can_send=np.ones(n, bool),
        g_tgt=has & ~send & (rng.random((n, c)) < 0.3),
        g_off_s=(rng.integers(0, 3, (n, c)) * 1000.0).astype(np.float32),
        hb_phase=rng.uniform(0, 1000.0, n).astype(np.float32),
        uplink_free=rng.uniform(0, 50.0, n).astype(np.float32),
        rx_const=np.zeros(n, np.float32))


ORDER = ("conns", "rev", "lat_edge", "tx_ms", "rank", "k_p", None,
         "send_mask", "can_send", "g_tgt", "g_off_s", "hb_phase",
         "uplink_free", "rx_const")


def _build(mod, arrays, packed):
    conv = jnp.asarray if mod is jex else torch.from_numpy
    args = [0.0 if k is None else conv(arrays[k]) for k in ORDER]
    return mod.build_recv_constants(*args, 2.0, 1000.0, True, packed=packed)


def test_packed_layout_dtypes():
    c = _build(tex, _scenario(), True)
    u = _build(tex, _scenario(), False)
    for f in TABLES:
        assert getattr(c, f).dtype == torch.bfloat16, f
        assert getattr(u, f).dtype == torch.float32, f
    for x in (c, u):
        assert x.flags.dtype == torch.int8
        assert x.u_ms.dtype == torch.float32 and x.rx_c.dtype == torch.float32
        assert x.src.dtype == torch.int32
    # INF pads round up to bf16 inf; _inc_from clamps them back to INF
    assert torch.isinf(c.a_ms).any()
    t = torch.full((64,), 3.4e38)
    t[0] = 0.0
    inc = tex._inc_from(t, c)
    assert inc.dtype == torch.float32 and not torch.isinf(inc).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_constants_and_fixpoint_bitwise(seed):
    arrays = _scenario(seed)
    n = arrays["conns"].shape[0]
    for packed in (True, False):
        cj, ct = _build(jex, arrays, packed), _build(tex, arrays, packed)
        for f in (*TABLES, "u_ms", "flags", "src", "rx_c"):
            assert _bits(getattr(cj, f)) == _bits(getattr(ct, f)), f
        t0 = np.full(n, 3.4e38, np.float32)
        t0[seed] = 0.0
        tj, incj, okj = jex.converge_recv(jnp.asarray(t0), cj, 64)
        tt, inct, okt = tex.converge_recv(torch.from_numpy(t0), ct, 64)
        assert bool(okj) and okt
        assert _bits(tj) == _bits(tt) and _bits(incj) == _bits(inct)
        if packed:
            t_pk = tt.numpy()
        else:
            t_ref = tt.numpy()
    ok = t_ref < 1e30
    np.testing.assert_array_equal(ok, t_pk < 1e30)
    np.testing.assert_allclose(t_pk[ok], t_ref[ok], rtol=1e-2, atol=25.0)
    assert not np.array_equal(t_pk, t_ref)      # the tables did quantize


@pytest.mark.parametrize("mode", ["bounded", "exact"])
def test_packed_simulator_on_the_receiver_side_path(mode, monkeypatch):
    monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
    monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
    jdis.clear_cache()
    topo = TopoParams(network_size=103, anchor_stages=5, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=15000, num_frags=2, messages=2,
                      delay_seconds=2.0)
    kw = dict(topo=topo, seed=4, warmup_s=10.0,
              serialize_answers=(mode == "exact"))
    try:
        j = jsim.Simulator(jsim.ExperimentConfig(packed_state=True, **kw))
        t = tsim.Simulator(tsim.ExperimentConfig(packed_state=True, **kw),
                           device="cpu")
        ref = tsim.Simulator(tsim.ExperimentConfig(**kw), device="cpu")
        for sim in (j, t, ref):
            sim.run()
    finally:
        monkeypatch.undo()
        jdis.clear_cache()
    assert t.params.packed_state and not ref.params.packed_state
    for a, b in zip(j.records, t.records):
        assert a.delays_ms.tobytes() == b.delays_ms.tobytes()
        assert a.received.tobytes() == b.received.tobytes()
    assert interop.leaf_mismatches(
        {f.name: np.asarray(getattr(j.state, f.name))
         for f in dataclasses.fields(j.state)},
        interop.state_to_numpy(t.state)) == []
    for a, b in zip(ref.records, t.records):
        np.testing.assert_array_equal(a.received, b.received)
        ok = a.received
        np.testing.assert_allclose(b.delays_ms[ok], a.delays_ms[ok],
                                   rtol=1e-2, atol=25.0)

