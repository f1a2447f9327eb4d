"""The port's twin of the reference's experiment driver: scripts/run_gpu.sh
(run.sh's 14 positionals through `python -m dst_libp2p_test_node_tpu_torch
run`) with --device cpu at 64 peers writes the latency and shadowlog
files, the topology files and the report of scripts/run_tpu.sh byte for
byte (the backend's wall line apart)."""

import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARGS = ["1", "64", "2000", "1", "3", "50", "150", "40", "130", "5", "0.0",
        "4", "0", "1000", "--warmup-s", "5"]


def test_run_gpu_sh_matches_run_tpu_sh(tmp_path):
    outs = {}
    for name, script, extra in (("tpu", "run_tpu.sh", []),
                                ("gpu", "run_gpu.sh", ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        proc = subprocess.run(
            ["sh", os.path.join(ROOT, "scripts", script)] + ARGS + extra,
            cwd=d, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        files = {f: (d / f).read_bytes() for f in sorted(os.listdir(d))
                 if not f.startswith("stats")}
        outs[name] = (files, proc.stdout.splitlines())
    (ft, rt), (fg, rg) = outs["tpu"], outs["gpu"]
    assert sorted(ft) == sorted(fg) == ["latencies1", "network_topology.gml",
                                        "shadow.yaml", "shadowlog1"]
    assert fg == ft
    assert fg["latencies1"].count(b" milliseconds: ") == 192
    assert rg[:-1] == rt[:-1]
    assert rg[-1].startswith("[torch backend device=cpu] wall=")
