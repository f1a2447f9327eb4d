"""The port's checkpoint/resume (runtime/checkpoint.py, Simulator.run's
checkpoint arguments, `run --checkpoint/--resume`) against the reference's,
on the CPU: a port checkpoint resumes to the uninterrupted run's bytes; a
checkpoint crosses between the packages in both directions (the files
themselves are byte-identical array for array) and each resume reproduces
the other's text; a v6 file loads with the defaults of its absent leaves;
a graph mismatch raises; the DHT's kad/* leaves are written as the
reference writes them; the multi-topic kind round-trips; the CLI's
refusals; and the topology artifacts `run` writes beside the latencies
(network_topology.gml, shadow.yaml) match the reference CLI's byte for
byte."""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu import cli as jcli
from dst_libp2p_test_node_tpu.config.topology import TopoParams
from dst_libp2p_test_node_tpu.runtime import checkpoint as jck
from dst_libp2p_test_node_tpu.runtime import multitopic as jmt
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import cli as tcli
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import (
    TopoParams as TTopoParams)
from dst_libp2p_test_node_tpu_torch.runtime import checkpoint as tck
from dst_libp2p_test_node_tpu_torch.runtime import multitopic as tmt
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

N = 80


def _kw(topo_cls=TTopoParams, **overrides):
    topo = topo_cls(network_size=N, anchor_stages=5, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=15000, num_frags=2, messages=3,
                      delay_seconds=2.0)
    kw = dict(topo=topo, seed=3, warmup_s=10.0, publisher_rotation=True,
              churn_down_per_hb=0.01, churn_up_per_hb=0.005)
    kw.update(overrides)
    return kw


def _text(sim):
    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return buf.getvalue() + sim.summary_report() + sim.bandwidth_report()


def _first_message(sim):
    sim.warmup()
    sim.publish(sim.cfg.publisher_id % N)
    return sim


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_port_checkpoint_resumes_to_the_uninterrupted_bytes(tmp_path):
    full = tsim.Simulator(tsim.ExperimentConfig(**_kw()), device="cpu")
    full.run()
    ck = str(tmp_path / "mid.npz")
    part = _first_message(
        tsim.Simulator(tsim.ExperimentConfig(**_kw()), device="cpu"))
    tck.save_checkpoint(part, ck)
    resumed = tck.load_checkpoint(ck, device="cpu")
    assert resumed.cfg == full.cfg and len(resumed.records) == 1
    resumed.run()
    assert _text(resumed) == _text(full)
    assert [r.publisher for r in resumed.records] == [4, 5, 6]
    # run(checkpoint_path=) saves after every k-th message and the last
    every = str(tmp_path / "every.npz")
    again = tsim.Simulator(tsim.ExperimentConfig(**_kw()), device="cpu")
    again.run(checkpoint_path=every, checkpoint_every=2)
    last = tck.load_checkpoint(every, device="cpu")
    assert len(last.records) == 3 and _text(last) == _text(full)
    assert last.run() == last.records      # nothing left to publish
    assert interop.leaf_mismatches(interop.state_to_numpy(full.state),
                                   interop.state_to_numpy(last.state)) == []


def test_checkpoints_cross_between_the_packages(tmp_path):
    j = _first_message(jsim.Simulator(jsim.ExperimentConfig(
        **_kw(TopoParams))))
    t = _first_message(
        tsim.Simulator(tsim.ExperimentConfig(**_kw()), device="cpu"))
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save_checkpoint(j, jpath)
    tck.save_checkpoint(t, tpath)
    # the same experiment state gives the same file, array for array
    want, got = _npz(jpath), _npz(tpath)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got["state/key"].dtype == np.uint32 and got["state/key"].shape \
        == (2,)
    assert got["state/t_ms"].dtype == np.float32 and got["state/t_ms"].ndim \
        == 0
    # a JAX checkpoint resumes in the port to the JAX resume's bytes, and
    # a port checkpoint loads in the reference to the same bytes
    jres = jck.load_checkpoint(tpath)
    jres.run()
    tres = tck.load_checkpoint(jpath, device="cpu")
    tres.run()
    assert _text(tres) == _text(jres)
    assert interop.leaf_mismatches(
        {f.name: np.asarray(getattr(jres.state, f.name))
         for f in dataclasses.fields(jres.state)},
        interop.state_to_numpy(tres.state)) == []


def test_v6_file_loads_with_the_defaults(tmp_path):
    t = _first_message(tsim.Simulator(
        tsim.ExperimentConfig(**_kw(warm_start=True)), device="cpu"))
    path = str(tmp_path / "v10.npz")
    tck.save_checkpoint(t, path)
    z = _npz(path)
    meta = json.loads(bytes(z["meta_json"]).decode())
    meta["version"] = 6
    dropped = ("state/warm_offset_ms", "state/px_pool", "state/starve_hb",
               "state/evictions", "state/px_grafts", "state/redials",
               "records/answer_wait_max_ms")
    old = {k: v for k, v in z.items() if k not in dropped}
    old["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    v6 = str(tmp_path / "v6.npz")
    np.savez_compressed(v6, **old)
    tres = tck.load_checkpoint(v6, device="cpu")
    st = tres.state
    assert float(st.warm_offset_ms.min()) > 1e30
    assert (st.px_pool == -1).all() and st.px_pool.dtype == torch.int32
    for k in ("starve_hb", "evictions", "px_grafts", "redials"):
        assert not getattr(st, k).any()
    assert tres.records[0].answer_wait_max_ms == 0.0
    # the reference reads the stripped file the same way
    jres = jck.load_checkpoint(v6)
    tres.run()
    jres.run()
    assert _text(tres) == _text(jres)
    meta["version"] = 4
    old["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(v6, **old)
    with pytest.raises(ValueError, match="format 4"):
        tck.load_checkpoint(v6, device="cpu")


def test_graph_mismatch_and_later_slices_raise(tmp_path):
    t = _first_message(
        tsim.Simulator(tsim.ExperimentConfig(**_kw()), device="cpu"))
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(t, path, service_meta={"pending": [1, 2]})
    assert tck.load_service_meta(path) == {"pending": [1, 2]}
    z = _npz(path)
    meta = json.loads(bytes(z["meta_json"]).decode())
    meta["graph_sha256"] = "0" * 64
    z["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **z)
    with pytest.raises(ValueError, match="graph mismatch"):
        tck.load_checkpoint(path, device="cpu")
    tck.save_checkpoint(t, path)
    assert tck.load_service_meta(path) == {}
    # a mesh must be a make_peer_mesh PeerMesh (the peer mesh is ported:
    # tests/port/test_torch_peer_checkpoint.py)
    with pytest.raises(TypeError, match="PeerMesh"):
        tck.load_checkpoint(path, mesh=object(), device="cpu")


def test_kad_leaves_cross_between_the_packages(tmp_path):
    # save_checkpoint(kad_state=): the DHT's leaves ride along as kad/*,
    # array for array the reference's; loading ignores them
    import jax.numpy as jnp

    from dst_libp2p_test_node_tpu.ops import kad as jkad
    from dst_libp2p_test_node_tpu_torch.ops import kad as tkad

    j = _first_message(jsim.Simulator(jsim.ExperimentConfig(
        **_kw(TopoParams))))
    t = _first_message(
        tsim.Simulator(tsim.ExperimentConfig(**_kw()), device="cpu"))
    jks = jkad.seed_bootstraps(jkad.init_kad_state(N, seed=3),
                               jnp.arange(2, dtype=jnp.int32))
    tks = tkad.seed_bootstraps(tkad.init_kad_state(N, seed=3, device="cpu"),
                               torch.arange(2))
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save_checkpoint(j, jpath, kad_state=jks)
    tck.save_checkpoint(t, tpath, kad_state=tks)
    want, got = _npz(jpath), _npz(tpath)
    assert list(got) == list(want)
    assert any(k.startswith("kad/") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    tres = tck.load_checkpoint(tpath, device="cpu")
    tres.run()
    jres = jck.load_checkpoint(jpath)
    jres.run()
    assert _text(tres) == _text(jres)


def test_multitopic_kind_round_trips(tmp_path):
    kw = dict(topo=TopoParams(network_size=60, anchor_stages=5,
                              msg_size_bytes=2000),
              topics=("blocks", "att"), subscribe_fraction=0.75,
              warmup_s=10.0, seed=5)
    t = tmt.MultiTopicSimulator(tmt.MultiTopicConfig(**kw), device="cpu")
    j = jmt.MultiTopicSimulator(jmt.MultiTopicConfig(**kw))
    for sim in (t, j):
        sim.warmup()
        sim.publish("att", int(np.nonzero(sim.subscribed_np[1])[0][2]))
    tpath, jpath = str(tmp_path / "mt.npz"), str(tmp_path / "mtj.npz")
    tck.save_checkpoint(t, tpath)
    jck.save_checkpoint(j, jpath)
    want, got = _npz(jpath), _npz(tpath)
    assert list(got) == list(want)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    back = tck.load_checkpoint(tpath, device="cpu")
    jback = jck.load_checkpoint(tpath)
    assert isinstance(back, tmt.MultiTopicSimulator)
    assert [x for x, _ in back.records] == ["att"]
    assert (back.subscribed_np == t.subscribed_np).all()
    pub = int(np.nonzero(t.subscribed_np[0])[0][1])
    a, b, c = (s.publish("blocks", pub) for s in (t, back, jback))
    for x in (a, b):
        assert x.msg_id == c.msg_id
        assert x.delays_ms.tobytes() == c.delays_ms.tobytes()


RUN_ARGS = ["1", "60", "15000", "1", "2", "50", "150", "40", "130", "5",
            "0.0", "4", "0", "2000", "--warmup-s", "10", "--seed", "2"]


def test_cli_checkpoint_resume_and_refusals(tmp_path, capsys):
    base = ["run", *RUN_ARGS, "--device", "cpu"]
    full = tmp_path / "full"
    full.mkdir()
    assert tcli.main(base + ["--out-prefix", f"{full}/", "--checkpoint",
                             str(tmp_path / "end.npz")]) == 0
    # a checkpoint after message 1 (the run's own Simulator), resumed by
    # the CLI: the same latencies
    topo = tcli._topo_from_fields(dict(zip(tcli.RUN_SH_PARAMS, RUN_ARGS)))
    sim = tsim.Simulator(tsim.ExperimentConfig(
        topo=topo, gossipsub=tcli.gossipsub_params_from_env(),
        warmup_s=10.0, seed=2), device="cpu")
    _first_message(sim)
    ck = str(tmp_path / "mid.npz")
    tck.save_checkpoint(sim, ck)
    res = tmp_path / "res"
    res.mkdir()
    assert tcli.main(base + ["--out-prefix", f"{res}/", "--resume", ck]) == 0
    assert (res / "latencies1").read_bytes() == \
        (full / "latencies1").read_bytes()
    # a resumed run leaves the experiment dir's artifacts alone
    assert not (res / "network_topology.gml").exists()
    assert (full / "network_topology.gml").exists()
    capsys.readouterr()
    refused = (
        (["run", "2", *RUN_ARGS[1:], "--checkpoint", ck], "runs == 1"),
        (base + ["--resume", ck, "--gml", "x.gml"], "drop --gml"),
        (base + ["--resume", ck, "--connect-to", "8"],
         "different configuration"),
    )
    for argv, why in refused:
        with pytest.raises(SystemExit) as exc:
            tcli.main(argv + ["--out-prefix", f"{res}/"])
        assert exc.value.code == 2
        assert why in capsys.readouterr().err


@pytest.mark.parametrize("args", [
    RUN_ARGS,
    ["1", "103", "1500", "1", "3", "20", "900", "10", "250", "4", "0.01",
     "0", "1", "1250", "--warmup-s", "5", "--muxer", "quic",
     "--delivery-mode", "bounded"],
])
def test_topology_artifacts_match_the_reference_cli(tmp_path, monkeypatch,
                                                    args):
    outs = {}
    for name, mod, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        assert mod.main(["run", *args, *extra,
                         "--out-prefix", f"{d}/"]) == 0
        outs[name] = {f: (d / f).read_bytes()
                      for f in ("network_topology.gml", "shadow.yaml",
                                "latencies1")}
    assert outs["torch"] == outs["jax"]


@pytest.mark.parametrize("n,stages,size,messages,delay,muxer,loss", [
    (2, 1, 1500, 1, 0.1, "yamux", 0.0),
    (7, 3, 1500, 10, 0.1, "quic", 0.01),
    (100, 5, 15000, 3, 2.0, "mplex", 1e-05),
    (100003, 5, 1234567, 1000, 123456.75, "yamux", 0.5),
    (100000, 5, 15000, 3, 2.0, "yamux", 0.0),
    (40, 12, 150, 1, 12.25, "quic", 0.0),
])
def test_topology_writers_match_the_libraries(tmp_path, n, stages, size,
                                              messages, delay, muxer, loss):
    # the port's writers against networkx.write_gml and yaml.dump (via
    # the reference's Topology), folding of long plain scalars included
    from dst_libp2p_test_node_tpu.config.topology import Topology
    from dst_libp2p_test_node_tpu_torch.config.topology import (
        Topology as TTopology)

    kw = dict(network_size=n, anchor_stages=stages, min_bandwidth=1,
              max_bandwidth=1000, min_latency=1, max_latency=10000,
              msg_size_bytes=size, messages=messages, delay_seconds=delay,
              muxer=muxer, packet_loss=loss)
    j, t = Topology.build(TopoParams(**kw)), TTopology.build(TTopoParams(**kw))
    for name, write in (("gml", "write_gml"), ("yaml", "write_shadow_yaml")):
        getattr(j, write)(str(tmp_path / f"j.{name}"))
        getattr(t, write)(str(tmp_path / f"t.{name}"))
        assert (tmp_path / f"t.{name}").read_bytes() == \
            (tmp_path / f"j.{name}").read_bytes(), name
