"""The mix relay (ops/mix.py and the Simulator's mix branch) of the port
against the reference, bitwise: mix_route on every output, plain and
occupancy-coupled, with dead mix nodes, a publisher inside the mix range
and payloads over one Sphinx body, at fractional latencies; the plain
path's four-hop sum in the reference's order; eligible_mix_count and
MixDegradedError; the Simulator text and the byte counters with mix on;
and `run --use-mix` with its NUMMIX check."""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu import cli as jcli
from dst_libp2p_test_node_tpu.config.topology import Topology, TopoParams
from dst_libp2p_test_node_tpu.ops import mix as jm
from dst_libp2p_test_node_tpu.runtime import bandwidth as jbw
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import cli as tcli
from dst_libp2p_test_node_tpu_torch import interop, prng
from dst_libp2p_test_node_tpu_torch.ops import mix as tm
from dst_libp2p_test_node_tpu_torch.runtime import bandwidth as tbw
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 240
NUM_MIX = 24


@pytest.fixture(scope="module")
def world():
    topo = Topology.build(TopoParams(network_size=N, anchor_stages=5,
                                     min_bandwidth=50, max_bandwidth=150,
                                     min_latency=40, max_latency=130))
    rng = np.random.default_rng(2)
    lat = (topo.latency_ms
           + rng.uniform(0.0, 1.0, topo.latency_ms.shape)).astype(np.float32)
    arrays = (topo.stage_of_peer, lat, topo.bw_up_mbit)
    return ([jnp.asarray(x) for x in arrays],
            [torch.from_numpy(x) for x in arrays], topo)


def _bitwise(want, got):
    want, got = np.asarray(want), got.numpy()
    return want.dtype == got.dtype and want.tobytes() == got.tobytes()


def _both_routes(world, trial, alive, publisher, payload, occupancy):
    cj, ct, _ = world
    jp = jm.MixParams(num_mix=NUM_MIX, mix_d=4)
    tp = tm.MixParams(num_mix=NUM_MIX, mix_d=4)
    kw_j = kw_t = {}
    if occupancy:
        rng = np.random.default_rng(trial)
        up = (rng.random(N) * 3000.0).astype(np.float32)
        rx = (rng.random(N) * 3000.0).astype(np.float32)
        t0 = float(rng.uniform(0.0, 4000.0))
        kw_j = dict(uplink_free_ms=jnp.asarray(up), rx_free_ms=jnp.asarray(rx),
                    t0_ms=t0)
        kw_t = dict(uplink_free_ms=torch.from_numpy(up),
                    rx_free_ms=torch.from_numpy(rx), t0_ms=t0)
    want = jm.mix_route(jax.random.PRNGKey(trial), publisher,
                        jnp.asarray(alive), *cj, params=jp, n=N,
                        payload_bytes=payload, **kw_j)
    got = tm.mix_route(prng.PRNGKey(trial), publisher,
                       torch.from_numpy(alive), *ct, params=tp, n=N,
                       payload_bytes=payload, **kw_t)
    return want, got


@pytest.mark.parametrize("occupancy", [False, True])
def test_mix_route_every_output_bitwise(world, occupancy):
    rng = np.random.default_rng(5)
    for trial in range(40):
        alive = rng.random(N) > 0.25            # dead mix nodes
        publisher = int(rng.integers(0, 2 * NUM_MIX))   # half in mix range
        payload = int(rng.choice([100, 2048, 2049, 5000, 15000]))
        want, got = _both_routes(world, trial, alive, publisher, payload,
                                 occupancy)
        assert len(want) == len(got) == (5 if occupancy else 3)
        for i, (a, b) in enumerate(zip(want, got)):
            assert _bitwise(a, b), (trial, i)
        path = got[0].numpy()
        assert len(set(path)) == 4 and (path < NUM_MIX).all()
        assert alive[path].all() and publisher not in path


def test_plain_delay_sums_hops_in_order(world):
    # the plain path's jnp.sum over 4 hops: the reference adds them in
    # order; a pairwise tree would differ on some of these draws
    _, _, topo = world
    lat = world[1][1].numpy()
    st = topo.stage_of_peer
    wire = np.float32(np.ceil(np.float32(15000) / np.float32(2048))
                      * np.float32(2413))
    alive = np.ones(N, dtype=bool)
    pairwise_differs = 0
    for trial in range(64):
        want, got = _both_routes(world, 100 + trial, alive, 70, 15000, False)
        assert _bitwise(want[2], got[2]), trial
        path = got[0].numpy()
        src = np.concatenate([[70], path[:-1]])
        tx = (wire * np.float32(8.0)) / (
            topo.bw_up_mbit[st[src]] * np.float32(1e6)) * np.float32(1e3)
        hop = (lat[st[src], st[path]] + tx).astype(np.float32)
        seq = ((hop[0] + hop[1]) + hop[2]) + hop[3] + np.float32(20.0)
        tree = ((hop[0] + hop[1]) + (hop[2] + hop[3])) + np.float32(20.0)
        assert seq == got[2].item()
        pairwise_differs += int(tree != seq)
    assert pairwise_differs > 0


def test_eligible_count_and_degraded_error():
    alive = np.ones(N, dtype=bool)
    alive[:NUM_MIX - 3] = False
    for pub in (0, NUM_MIX - 1, NUM_MIX, N - 1):
        assert tm.eligible_mix_count(alive, pub, N, NUM_MIX) \
            == jm.eligible_mix_count(alive, pub, N, NUM_MIX)
    assert tm.eligible_mix_count(alive, NUM_MIX - 1, N, NUM_MIX) == 2
    assert tm.mix_wire_bytes(tm.MixParams(8), 15000) == 8 * 2413
    with pytest.raises(ValueError):
        tm.MixParams(num_mix=3, mix_d=4).validate()
    topo = TopoParams(network_size=60, anchor_stages=5, msg_size_bytes=2000,
                      messages=1)
    sim = tsim.Simulator(tsim.ExperimentConfig(
        topo=topo, warmup_s=5.0, uses_mix=True, num_mix=6, mix_d=4,
        publisher_id=10), device="cpu")
    sim.warmup()
    sim.state = sim.state.replace(alive=torch.arange(60) >= 3)
    with pytest.raises(tsim.MixDegradedError, match="3 eligible"):
        sim.publish(10)


def _text(sim, bw):
    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return (buf.getvalue(), "\n".join(bw.shadowlog_lines(sim.traffic())),
            sim.summary_report() + sim.bandwidth_report())


@pytest.mark.parametrize("mode", ["bounded", "exact"])
def test_simulator_with_mix_text_and_bytes(mode):
    topo = TopoParams(network_size=150, anchor_stages=5, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=15000, messages=3, delay_seconds=2.0)
    kw = dict(topo=topo, seed=5, warmup_s=20.0,
              serialize_answers=(mode == "exact"), publisher_rotation=True,
              uses_mix=True, num_mix=16, mix_d=4, publisher_id=14)
    sj = jsim.Simulator(jsim.ExperimentConfig(**kw))
    st = tsim.Simulator(tsim.ExperimentConfig(**kw), device="cpu")
    sj.run()
    st.run()
    assert _text(st, tbw) == _text(sj, jbw)
    leaves = {f.name: np.asarray(getattr(sj.state, f.name))
              for f in dataclasses.fields(sj.state)}
    assert interop.leaf_mismatches(leaves,
                                   interop.state_to_numpy(st.state)) == []
    # the Sphinx bytes are on the books at both ends of every hop: 3
    # messages x 4 hops x 8 padded packets beyond GossipSub's own copies
    mix_bytes = 3 * 4 * 8 * 2413
    gossip_tx = sum(int(r.sends.sum()) for r in st.records) * 15000
    assert st.state.bytes_tx.double().sum().item() == gossip_tx + mix_bytes
    assert st.state.bytes_rx[:16].double().sum().item() >= mix_bytes
    # publishers 14 and 15 are mix nodes: left out of their own paths
    assert [r.publisher for r in st.records] == [14, 15, 16]


def test_run_cli_use_mix(tmp_path, monkeypatch, capsys):
    args = ["1", "120", "15000", "1", "2", "50", "150", "40", "130", "5",
            "0.0", "20", "0", "2000", "--delivery-mode", "bounded",
            "--warmup-s", "10", "--seed", "1", "--use-mix", "--num-mix",
            "12", "--mix-d", "4"]
    outs = {}
    for name, mod, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert mod.main(["run", *args, *extra,
                         "--out-prefix", str(d) + "/"]) == 0
        outs[name] = {f: (d / f).read_text()
                      for f in ("latencies1", "shadowlog1")}
    assert outs["torch"] == outs["jax"]
    assert outs["torch"]["latencies1"].count("\n") == 2 * 120
    # a publisher inside the mix range needs a spare mix node
    bad = list(args)
    bad[11] = "3"
    bad[bad.index("--num-mix") + 1] = "4"
    with pytest.raises(SystemExit) as exc:
        tcli.main(["run", *bad, "--device", "cpu"])
    assert exc.value.code == 2
    assert "--num-mix >= 5" in capsys.readouterr().err
