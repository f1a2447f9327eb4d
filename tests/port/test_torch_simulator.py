"""The port's Simulator and `run` CLI against the reference's, end to end
on the CPU: latencies, shadowlog and summary text byte-identical for the
same configuration and seed (bounded delivery mode), at the default pull
budget and with the budget lowered so the receiver-side fixpoint runs."""

import dataclasses
import io

import numpy as np
import pytest
import torch

import dst_libp2p_test_node_tpu.ops.pull as jpull
import dst_libp2p_test_node_tpu_torch.ops.pull as tpull
from dst_libp2p_test_node_tpu import cli as jcli
from dst_libp2p_test_node_tpu.config.topology import TopoParams
from dst_libp2p_test_node_tpu.ops.disseminate import disseminate as jdis
from dst_libp2p_test_node_tpu.runtime import bandwidth as jbw
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import cli as tcli
from dst_libp2p_test_node_tpu_torch.runtime import bandwidth as tbw
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)


def _outputs(sim, bw):
    buf = io.StringIO()
    sim.latencies_writer().write_to(buf)
    return {"latencies1": buf.getvalue(),
            "shadowlog1": "\n".join(bw.shadowlog_lines(sim.traffic())),
            "summary": sim.summary_report() + sim.bandwidth_report()}


def _configs(n, fragments, churn):
    topo = TopoParams(network_size=n, anchor_stages=5, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=15000, num_frags=fragments, messages=3,
                      delay_seconds=2.0)
    kw = dict(topo=topo, seed=5, warmup_s=20.0, serialize_answers=False,
              publisher_rotation=True, churn_down_per_hb=churn,
              churn_up_per_hb=churn / 2)
    return jsim.ExperimentConfig(**kw), tsim.ExperimentConfig(**kw)


@pytest.mark.parametrize("budget", ["default", "lowered"])
@pytest.mark.parametrize("fragments,churn", [(1, 0.0), (2, 0.01)])
def test_simulator_outputs_byte_identical(budget, fragments, churn,
                                          monkeypatch):
    if budget == "lowered":
        monkeypatch.setattr(jpull, "_MAX_INTERMEDIATE_BYTES", 1)
        monkeypatch.setattr(tpull, "_MAX_INTERMEDIATE_BYTES", 1)
        jdis.clear_cache()
    try:
        cj, ct = _configs(150, fragments, churn)
        sj, st = jsim.Simulator(cj), tsim.Simulator(ct, device="cpu")
        sj.run()
        st.run()
        want, got = _outputs(sj, jbw), _outputs(st, tbw)
    finally:
        monkeypatch.undo()
        jdis.clear_cache()
    for name in want:
        assert got[name] == want[name], name
    assert want["latencies1"].count("\n") > 3 * 100
    assert all(r.converged for r in st.records)


def test_run_cli_files_byte_identical(tmp_path, monkeypatch):
    args = ["1", "120", "15000", "1", "3", "50", "150", "40", "130", "5",
            "0.0", "4", "1", "3000", "--delivery-mode", "bounded",
            "--warmup-s", "15", "--seed", "2"]
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


def test_cli_refuses_what_is_not_ported(capsys, tmp_path, monkeypatch):
    # checkpoints are ported: what `run` still refuses are the
    # reference's own refusals; a lossy topology and mix routing run
    base = ["run", "1", "50", "15000", "1", "1", "50", "150", "40", "130",
            "5", "0.0", "4", "0", "1000", "--device", "cpu"]
    runs2 = list(base)
    runs2[1] = "2"
    for argv in (runs2 + ["--checkpoint", "x"],
                 base + ["--resume", "x", "--gml", "y"]):
        with pytest.raises(SystemExit) as exc:
            tcli.main(argv)
        assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "runs == 1" in err and "drop --gml" in err
    monkeypatch.chdir(tmp_path)
    lossy = list(base)
    lossy[11] = "0.1"
    assert tcli.main(lossy + ["--delivery-mode", "bounded", "--warmup-s",
                              "5", "--loss-mode", "message"]) == 0
    assert (tmp_path / "latencies1").read_text().count("\n") > 0
    assert tcli.main(base + ["--delivery-mode", "bounded", "--warmup-s", "5",
                             "--use-mix", "--num-mix", "5"]) == 0
    assert (tmp_path / "latencies1").read_text().count("\n") == 50


def test_what_is_not_ported_raises(tmp_path):
    # the multi-topic Simulator, its batched publish and the DHT leaves of
    # a checkpoint are ported; checkpoints of a sharded run are a later
    # slice
    from dst_libp2p_test_node_tpu_torch.ops.kad import init_kad_state
    from dst_libp2p_test_node_tpu_torch.runtime.checkpoint import (
        load_checkpoint, save_checkpoint)
    from dst_libp2p_test_node_tpu_torch.runtime.multitopic import (
        MultiTopicConfig, MultiTopicSimulator)

    sim = MultiTopicSimulator(MultiTopicConfig(
        topo=TopoParams(network_size=40, anchor_stages=5),
        topics=("a", "b")), device="cpu")
    recs = sim.publish_batch([("a", 1), ("b", 2)])
    assert len(recs) == 2 and recs[0].received.sum() > 0
    rec = sim.publish("b", 1)
    assert rec.received.sum() > 0
    with pytest.raises(NotImplementedError, match="A13"):
        load_checkpoint("unused.npz", mesh=object())
    path = str(tmp_path / "ck.npz")
    save_checkpoint(sim, path, kad_state=init_kad_state(40, device="cpu"))
    with np.load(path) as z:
        assert z["kad/rtable"].shape == (40, 24, 16)


def test_experiment_config_fields_match_the_reference():
    want = [f.name for f in dataclasses.fields(jsim.ExperimentConfig)]
    assert [f.name for f in dataclasses.fields(tsim.ExperimentConfig)] \
        == want
