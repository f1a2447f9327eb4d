"""The port's service commands against the reference on the CPU: `inject`
by id and by rotation against in-process port services (the CLI and the
injector function); `serve --device cpu` as a subprocess, single-topic and
TOPICS= multi-topic, answering /health, /ready, /publish and /metrics,
drained by SIGTERM to exit 0 with its final checkpoint, then `--resume`
from it; `serve` without --device on a machine with no card refused;
`topogen` (flags and run.sh positionals) writing files byte-identical to
the JAX command's; and `summarize` printing the JAX command's report."""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from dst_libp2p_test_node_tpu import cli as jcli
from dst_libp2p_test_node_tpu.runtime import publisher as jpub
from dst_libp2p_test_node_tpu_torch import cli as tcli
from dst_libp2p_test_node_tpu_torch.config.env import NodeConfig
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams
from dst_libp2p_test_node_tpu_torch.runtime import node_service as tns
from dst_libp2p_test_node_tpu_torch.runtime import publisher as tpub
from dst_libp2p_test_node_tpu_torch.runtime.simulator import (
    ExperimentConfig,
    Simulator,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture
def services():
    svcs = []
    for seed in (3, 4):
        sim = Simulator(ExperimentConfig(
            topo=TopoParams(network_size=16, msg_size_bytes=500, messages=1),
            connect_to=4, warmup_s=5.0, seed=seed), device="cpu")
        sim.warmup()
        svc = tns.NodeService(sim, NodeConfig(my_id=1, network_size=16,
                                              connect_to=4),
                              control_port=0, metrics_port=0)
        svc.start()
        svcs.append(svc)
    yield svcs
    for svc in svcs:
        svc.stop()


@pytest.mark.parametrize("selection,want", [("id", [0, 5]),
                                            ("rotation", [2, 3])])
def test_inject_by_id_and_rotation(services, selection, want):
    targets = [f"127.0.0.1:{s.control_port}" for s in services]
    slept = []
    res = tpub.inject(targets, 200, 5, 0.5, topic="test",
                      peer_selection=selection, publisher_id=1, burst=2,
                      sleep=slept.append)
    assert (res.ok, res.failed) == (5, 0)
    assert slept == [0.5, 0.5]                   # after messages 2 and 4
    assert [s.counters["admitted"] for s in services] == want
    assert all(r["status"] == "success" for r in res.replies)
    # the reference's injector against the same services answers the same
    res_j = jpub.inject(targets, 200, 2, 0.0, peer_selection=selection,
                        publisher_id=1)
    assert res_j.replies == tpub.inject(
        targets, 200, 2, 0.0, peer_selection=selection,
        publisher_id=1).replies
    rc, out = _run(tcli.main, ["inject", *targets, "-s", "300", "-m", "3",
                               "-d", "0", "--burst", "3",
                               "--peer-selection", selection])
    assert rc == 0 and out.splitlines()[-1] == "published ok=3 failed=0"
    assert len(out.splitlines()) == 4
    for svc in services:                # every admitted request lands
        assert svc.pump() == svc.counters["admitted"] > 0
    with pytest.raises(ValueError):
        tpub.inject(targets, 1, 1, 0.0, peer_selection="random")
    rc, out = _run(tcli.main, ["inject", "127.0.0.1:1", "-m", "1"])
    assert rc == 1 and "failed=1" in out


def _http(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


def _serve(args, env, log):
    proc = subprocess.Popen(
        [sys.executable, "-m", "dst_libp2p_test_node_tpu_torch", "serve",
         "--device", "cpu", "--control-port", "0", "--metrics-port", "0",
         *args], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.time()
    while time.time() - t0 < 120:
        log.flush()
        with open(log.name) as f:
            m = re.search(r"serving control :(\d+) metrics :(\d+)", f.read())
        if m:
            return proc, int(m.group(1)), int(m.group(2))
        assert proc.poll() is None, open(log.name).read()
        time.sleep(0.1)
    proc.kill()
    raise AssertionError("serve did not come up")


def _drained(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("topics", ["", "blocks,att_0"])
def test_serve_subprocess_sigterm_and_resume(tmp_path, topics):
    env = dict(os.environ, PEERS="32", CONNECTTO="4", TOPICS=topics,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    ck = str(tmp_path / "svc.npz")
    topic = topics.split(",")[0] if topics else "test"
    with open(tmp_path / "serve1.log", "w") as log:
        proc, cport, mport = _serve(
            ["--warmup-s", "5", "--checkpoint", ck], env, log)
        try:
            assert _http(cport, "/health") == (200, "ok")
            assert _http(cport, "/ready") == (200, "ok")
            rc, out = _run(tcli.main, ["inject", f"127.0.0.1:{cport}",
                                       "--topic", topic, "-s", "400", "-m",
                                       "2", "-d", "0", "--burst", "2"])
            assert rc == 0, out
            t0 = time.time()
            while json.loads(_http(cport, "/service")[1])["counters"][
                    "dispatched"] < 2:
                assert time.time() - t0 < 60
                time.sleep(0.05)
            text = _http(mport, "/metrics")[1]
            for fam in ("dst_testnode_", "libp2p_", "dst_service_"):
                assert f"\n{fam}" in text
        finally:
            rc = _drained(proc)
    assert rc == 0 and os.path.exists(ck)
    out = open(tmp_path / "serve1.log").read()
    assert "node service up: 32 peers simulated" in out
    assert len(re.findall(r"^\d+ milliseconds: \d+$", out, re.M)) >= 2 * 32
    with open(tmp_path / "serve2.log", "w") as log:
        proc, cport, _ = _serve(["--checkpoint", ck, "--resume"], env, log)
        try:
            assert _http(cport, "/health") == (200, "ok")
            status = json.loads(_http(cport, "/service")[1])
            assert status["counters"]["restarts"] == 1
            assert status["counters"]["dispatched"] == 2
        finally:
            rc = _drained(proc)
    assert rc == 0
    assert "warm-restarting from" in open(tmp_path / "serve2.log").read()


def test_serve_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main(["serve", "--warmup-s", "1"])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


_TOPOGEN = [
    ["-n", "60", "-st", "5", "-bl", "50", "-bh", "150", "-ll", "40", "-lh",
     "130", "-l", "0.01", "-s", "15000", "-f", "4", "-m", "3", "-d", "2"],
    ["50", "10", "100", "30", "90", "3", "0.0", "1500", "1", "5", "4", "1",
     "4000"],
    [],
]


@pytest.mark.parametrize("argv", _TOPOGEN, ids=["flags", "positional",
                                                "defaults"])
def test_topogen_files_match_reference(tmp_path, monkeypatch, argv):
    outs = {}
    for name, main in (("port", tcli.main), ("jax", jcli.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        rc, out = _run(main, ["topogen", *argv])
        assert rc == 0
        outs[name] = (out, (d / "network_topology.gml").read_bytes(),
                      (d / "shadow.yaml").read_bytes())
    assert outs["port"] == outs["jax"]
    rc = tcli.main(["topogen", "1", "2"])
    assert rc == 2


def test_summarize_matches_reference(tmp_path):
    sim = Simulator(ExperimentConfig(
        topo=TopoParams(network_size=40, msg_size_bytes=1500, messages=3,
                        delay_seconds=1.0),
        connect_to=4, warmup_s=5.0, seed=1), device="cpu")
    sim.run()
    path = str(tmp_path / "latencies1")
    sim.write_latencies(path)
    for extra in ([], ["--large"]):
        got = _run(tcli.main, ["summarize", path, *extra])
        want = _run(jcli.main, ["summarize", path, *extra])
        assert got == want and got[0] == 0 and got[1].strip()
