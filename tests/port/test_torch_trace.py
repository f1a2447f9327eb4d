"""The port's `trace` command and runtime/profiling.py against the
reference, on the CPU: trace.perfetto.json and rounds.csv byte-identical
to the JAX CLI's at 64 peers, rounds.npz member for member, the summary's
fields; chrome_trace on vector and scalar channels; the torch.profiler
capture's files."""

import json
import os

import numpy as np
import torch

from dst_libp2p_test_node_tpu import cli as jcli
from dst_libp2p_test_node_tpu.runtime import profiling as jprof
from dst_libp2p_test_node_tpu_torch import cli as tcli
from dst_libp2p_test_node_tpu_torch.runtime import profiling as tprof

torch.set_num_threads(1)


def _run(main, out, capsys, *extra):
    rc = main(["trace", "-n", "64", "--heartbeats", "12", "--warmup-hb",
               "6", "--out", str(out), *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out)


def test_trace_files_equal_the_reference_cli(tmp_path, capsys):
    sj = _run(jcli.main, tmp_path / "j", capsys)
    st = _run(tcli.main, tmp_path / "t", capsys, "--device", "cpu",
              "--profile-dir", str(tmp_path / "prof"))
    for name in ("trace.perfetto.json", "rounds.csv"):
        a = (tmp_path / "j" / name).read_bytes()
        b = (tmp_path / "t" / name).read_bytes()
        assert a == b, name
    with np.load(tmp_path / "j" / "rounds.npz") as zj, \
            np.load(tmp_path / "t" / "rounds.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
            assert zj[k].tobytes() == zt[k].tobytes(), k
    for k in ("network_size", "heartbeats", "heartbeat_ms", "channels",
              "coverage90_hb", "final_mean_degree"):
        assert st[k] == sj[k], k
    assert st["heartbeats"] == 12
    rows = (tmp_path / "t" / "rounds.csv").read_text().splitlines()
    assert len(rows) == 13
    ct = json.loads((tmp_path / "t" / "trace.perfetto.json").read_text())
    assert sum(e["ph"] == "X" for e in ct["traceEvents"]) == 12
    # the profiler capture: its Chrome trace and the (empty on the CPU)
    # device kernel counts
    prof = tmp_path / "prof"
    assert json.loads((prof / tprof.KERNEL_COUNTS).read_text()) == {}
    assert json.loads((prof / tprof.PROFILE_TRACE).read_text())[
        "traceEvents"]


def test_chrome_trace_equals_reference():
    rng = np.random.default_rng(0)
    curves = {"a": rng.random(5).astype(np.float32),
              "q": rng.random((5, 3)).astype(np.float32),
              "n": np.arange(5, dtype=np.int32)}
    want = jprof.chrome_trace(curves, 1000.0, t0_ms=250.0, pid=2, name="x")
    got = tprof.chrome_trace(curves, 1000.0, t0_ms=250.0, pid=2, name="x")
    assert json.dumps(got) == json.dumps(want)


def test_profiler_trace_passthrough_and_cpu_capture(tmp_path):
    with tprof.profiler_trace(None):
        pass
    assert not os.listdir(tmp_path)
    with tprof.profiler_trace(str(tmp_path / "p"), device="cpu"):
        torch.ones(8).sum()
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        [tprof.KERNEL_COUNTS, tprof.PROFILE_TRACE])
