"""Checkpoints of a run on a peer mesh (runtime/checkpoint.py with a
runtime/sharded.py handle, 2 gloo CPU ranks):

  - a save gathers the rows, so its file is byte-identical to the
    reference's save at the same point (answer_queue_mode "serial", the
    engine a mesh takes), and to the port's one-device save;
  - load_checkpoint(mesh=) scatters the leaves to the ranks, and the
    resumed run equals the uninterrupted one (text, records, state); a
    one-device file resumes on a mesh and a mesh file on one device;
  - the multi-topic kind round-trips through a mesh the same way;
  - NodeService.restore(mesh=) replays the rest of a schedule to the
    uninterrupted service's records, lines, counters (outside the device
    dispatch count: a mesh publishes one message at a time) and state.
"""

import io

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.runtime import checkpoint as jck
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.runtime import checkpoint as tck
from dst_libp2p_test_node_tpu_torch.runtime import multitopic as tmt
from dst_libp2p_test_node_tpu_torch.runtime import node_service as tns
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim
from dst_libp2p_test_node_tpu_torch.runtime.sharded import (
    ShardedMultiTopicSimulator,
    ShardedSimulator,
)

torch.set_num_threads(1)

N = 80


@pytest.fixture(scope="module")
def mesh(cpu_mesh):
    return cpu_mesh


def _kw(topo_cls=TTopo):
    topo = topo_cls(network_size=N, anchor_stages=5, min_bandwidth=50,
                    max_bandwidth=150, min_latency=40, max_latency=130,
                    msg_size_bytes=15000, num_frags=2, messages=3,
                    delay_seconds=2.0)
    return dict(topo=topo, seed=3, warmup_s=10.0, publisher_rotation=True,
                churn_down_per_hb=0.01, churn_up_per_hb=0.005,
                answer_queue_mode="serial")


def _first_message(sim):
    sim.warmup()
    sim.publish(sim.cfg.publisher_id % N)
    return sim


def _text(sim):
    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return buf.getvalue() + sim.summary_report() + sim.bandwidth_report()


def _same_state(a, b):
    assert interop.leaf_mismatches(interop.state_to_numpy(a),
                                   interop.state_to_numpy(b)) == []


def test_sharded_save_is_the_reference_file(mesh, tmp_path):
    j = _first_message(jsim.Simulator(jsim.ExperimentConfig(**_kw(JTopo))))
    t = _first_message(tsim.Simulator(tsim.ExperimentConfig(**_kw()),
                                      mesh=mesh))
    one = _first_message(tsim.Simulator(tsim.ExperimentConfig(**_kw()),
                                        device="cpu"))
    paths = {k: str(tmp_path / f"{k}.npz") for k in ("jax", "mesh", "one")}
    jck.save_checkpoint(j, paths["jax"])
    tck.save_checkpoint(t, paths["mesh"])
    tck.save_checkpoint(one, paths["one"])
    with open(paths["jax"], "rb") as f:
        want = f.read()
    for k in ("mesh", "one"):
        with open(paths[k], "rb") as f:
            assert f.read() == want, k
    t.close()


def test_resume_on_a_mesh_equals_the_uninterrupted_run(mesh, tmp_path):
    full = tsim.Simulator(tsim.ExperimentConfig(**_kw()), device="cpu")
    full.run()
    ck = str(tmp_path / "mid.npz")
    part = _first_message(tsim.Simulator(tsim.ExperimentConfig(**_kw()),
                                         mesh=mesh))
    tck.save_checkpoint(part, ck)
    part.close()
    resumed = tck.load_checkpoint(ck, mesh=mesh)
    assert isinstance(resumed, ShardedSimulator)
    assert resumed.cfg == full.cfg and len(resumed.records) == 1
    resumed.run()
    assert _text(resumed) == _text(full)
    _same_state(full.state, resumed.state)
    # a mesh's file on one device, and run(checkpoint_path=) on a mesh
    every = str(tmp_path / "every.npz")
    again = tsim.Simulator(tsim.ExperimentConfig(**_kw()), mesh=mesh)
    again.run(checkpoint_path=every, checkpoint_every=2)
    last = tck.load_checkpoint(every, device="cpu")
    assert len(last.records) == 3 and _text(last) == _text(full)
    _same_state(full.state, last.state)
    for sim in (resumed, again):
        sim.close()
    with pytest.raises(TypeError, match="PeerMesh"):
        tck.load_checkpoint(ck, mesh=object())


def test_multitopic_kind_round_trips_through_a_mesh(mesh, tmp_path):
    def cfg():
        return tmt.MultiTopicConfig(
            topo=TTopo(network_size=40, anchor_stages=5,
                       msg_size_bytes=2000),
            topics=("a", "b"), subscribe_fraction=0.8, warmup_s=4.0,
            seed=5)

    full = tmt.MultiTopicSimulator(cfg(), mesh=mesh)
    full.warmup()
    full.publish("a", 1)
    ck = str(tmp_path / "mt.npz")
    tck.save_checkpoint(full, ck)
    one = tmt.MultiTopicSimulator(cfg(), device="cpu")
    one.warmup()
    one.publish("a", 1)
    ck1 = str(tmp_path / "mt1.npz")
    tck.save_checkpoint(one, ck1)
    with open(ck, "rb") as f, open(ck1, "rb") as g:
        assert f.read() == g.read()
    back = tck.load_checkpoint(ck, mesh=mesh)
    assert isinstance(back, ShardedMultiTopicSimulator)
    recs = [s.publish("b", 2) for s in (full, back)]
    assert recs[0].delays_ms.tobytes() == recs[1].delays_ms.tobytes()
    assert recs[0].msg_id == recs[1].msg_id
    _same_state(full.state, back.state)
    for sim in (full, back):
        sim.close()


def _service(sim, **svc_kw):
    return tns.NodeService(
        sim, tns.NodeConfig(my_id=2, network_size=N, connect_to=4,
                            topic="test"),
        control_port=0, metrics_port=0,
        service=tns.ServiceConfig(**svc_kw))


_SCHEDULE = [[(100, "a"), (300, "b"), (100, "c"), (300, "a")],
             [(500, "b")], [], [(100, "c"), (100, "c")]]


def _drive(svc, schedule):
    for tick in schedule:
        for size, tenant in tick:
            code, _, _ = svc.submit(tns.PublishRequest(
                "test", size, tenant=tenant, deadline_ms=float("inf")))
            assert code == 200
        svc.pump(advance_ms=700.0)


def _records(sim):
    return [(int(r.msg_id), float(r.t0_ms), r.delays_ms.tobytes(),
             r.received.tobytes(), r.sends.tobytes()) for r in sim.records]


def test_node_service_restore_on_a_mesh(mesh, tmp_path):
    svc_kw = dict(max_batch=2, max_queue_depth=8)

    def sim():
        s = tsim.Simulator(tsim.ExperimentConfig(**_kw()), device="cpu")
        s.warmup()
        return s

    full = _service(sim(), **svc_kw)
    _drive(full, _SCHEDULE)
    part = _service(sim(), **svc_kw)
    _drive(part, _SCHEDULE[:2])
    ck = str(tmp_path / "svc.npz")
    part.flush_checkpoint(ck)
    back = tns.NodeService.restore(
        ck, tns.NodeConfig(my_id=2, network_size=N, connect_to=4,
                           topic="test"),
        control_port=0, metrics_port=0,
        service=tns.ServiceConfig(**svc_kw), mesh=mesh)
    assert isinstance(back.sim, ShardedSimulator)
    assert back.counters["restarts"] == 1
    _drive(back, _SCHEDULE[2:])
    assert _records(back.sim) == _records(full.sim)
    # the restarted service logs the messages it dispatched since
    assert back.lines_out and \
        back.lines_out == full.lines_out[-len(back.lines_out):]
    # a mesh dispatches one publish at a time (the reference's mesh path),
    # so only its dispatch count may differ from the batched service's
    skip = ("restarts", "device_dispatches")
    assert {k: v for k, v in back.counters.items() if k not in skip} \
        == {k: v for k, v in full.counters.items() if k not in skip}
    _same_state(full.sim.state, back.sim.state)
    back.sim.close()
