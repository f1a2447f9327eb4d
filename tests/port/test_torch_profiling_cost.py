"""The port's cost and retrace accounting (runtime/profiling.py), on the
CPU: entrypoint_cost's fields, roofline per registered contract strict-JSON
safe (as tests/test_profiling.py checks the reference's), and the retrace
counter: a fresh kernel build and library load count, a warm second call
counts 0."""

import json
import os

import pytest
import torch

from dst_libp2p_test_node_tpu_torch.analysis.registry import (
    default_contracts)
from dst_libp2p_test_node_tpu_torch.native import build
from dst_libp2p_test_node_tpu_torch.runtime.profiling import (
    check_retrace_budgets, count_retraces, entrypoint_cost, host_syncs,
    measure_retraces, roofline)
from dst_libp2p_test_node_tpu_torch.runtime.summarize import (
    sanitize_nonfinite)

torch.set_num_threads(1)

CONTRACTS = {c.name: c for c in default_contracts("cpu")}


def test_entrypoint_cost_fields():
    cost = entrypoint_cost(CONTRACTS["heartbeat_step"])
    assert set(cost) == {"flops", "hbm_bytes", "peak_memory_bytes"}
    # no matmul-class work: no flop count rather than a false 0; no device
    # memory on the CPU
    assert cost["flops"] is None and cost["peak_memory_bytes"] is None
    assert isinstance(cost["hbm_bytes"], float) and cost["hbm_bytes"] > 0


def test_hbm_bytes_is_each_input_read_once_and_each_output_written_once():
    c = CONTRACTS["native/score_update"]
    fmd = c.build().args[0]
    # fmd, slow and the (2,) scales in; f, s and the score out
    assert entrypoint_cost(c)["hbm_bytes"] == 5 * fmd.numel() * 4 + 2 * 4


def test_outputs_that_are_inputs_are_not_counted_twice():
    from dst_libp2p_test_node_tpu_torch.analysis.contracts import (
        tensor_bytes)

    x = torch.zeros(10, dtype=torch.float32)
    y = torch.zeros(3, dtype=torch.int32)
    assert tensor_bytes((x, y), (x, x[2:])) == 40 + 12
    assert tensor_bytes((x,), torch.ones(5)) == 40 + 20


@pytest.mark.parametrize("name", sorted(CONTRACTS))
def test_roofline_entry_is_strict_json_safe(name):
    c = CONTRACTS[name]
    block = roofline(contracts=[c])
    assert set(block) == {name}
    entry = block[name]
    assert "error" not in entry, entry
    assert set(entry) == {"flops", "hbm_bytes", "peak_memory_bytes",
                          "retraces", "new_segments", "retrace_budget",
                          "host_syncs"}
    assert entry["retraces"] <= entry["retrace_budget"] == 0
    assert isinstance(entry["host_syncs"], int) and entry["host_syncs"] >= 0
    json.dumps(sanitize_nonfinite(block), allow_nan=False)


def test_roofline_honours_the_prefix_and_degrades_per_entry():
    import dataclasses

    cs = [CONTRACTS["native/score_update"], CONTRACTS["heartbeat_step"]]
    assert set(roofline(cs, name_prefix="native/")) == {"native/score_update"}
    assert set(roofline(cs, name_prefix="heartbeat")) == {"heartbeat_step"}
    assert set(roofline(cs)) == set(c.name for c in cs)

    def broken():
        raise RuntimeError("no spec")

    block = roofline([dataclasses.replace(cs[0], build=broken)])
    assert "no spec" in block["native/score_update"]["error"]


def test_host_syncs_count_device_reads():
    from torch.profiler import ProfilerActivity, profile

    from dst_libp2p_test_node_tpu_torch.analysis.jaxpr_audit import run_spec

    # the exact publish branches on device values (the refinement's
    # certificate); the kernel alone reads none
    assert host_syncs(CONTRACTS["native/score_update"]) == 0
    for name in ("disseminate/cold", "publisher/batch_scan"):
        spec = CONTRACTS[name].build()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run_spec(spec)
        want = sum(1 for e in prof.events()
                   if e.name == "aten::_local_scalar_dense")
        assert host_syncs(CONTRACTS[name]) == want > 0


def test_retrace_budgets_hold_for_every_contract():
    assert check_retrace_budgets(list(CONTRACTS.values())) == []


def test_a_fresh_kernel_build_counts_and_a_warm_call_does_not(
        tmp_path, monkeypatch):
    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = cmd[cmd.index("-o") + 1]
            with open(out, "w") as f:
                f.write("built")

        def communicate(self):
            return "ptxas info: 0 bytes spill", None

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(build, "_loaded", {})
    with count_retraces() as first:
        lib = build.load("score_update")
    assert (first.builds, first.loads, first.count) == (1, 1, 2)
    assert lib[1].startswith(str(tmp_path))
    with count_retraces() as warm:
        assert build.load("score_update") is lib
    assert warm.count == 0
    # a library already on disk is loaded, not rebuilt
    monkeypatch.setattr(build, "_loaded", {})
    with count_retraces() as reload:
        build.load("score_update")
    assert (reload.builds, reload.loads) == (0, 1)
    assert os.listdir(tmp_path) == [os.path.basename(lib[1])]


def test_measure_retraces_is_zero_on_a_warm_second_call():
    assert measure_retraces(CONTRACTS["run_heartbeats"]) == 0
    count, segments = measure_retraces(CONTRACTS["run_heartbeats"],
                                       with_segments=True)
    assert (count, segments) == (0, None)
