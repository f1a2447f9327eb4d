"""The port's microbench harness (runtime/microbench.py) on the CPU: the
sweep at a small size, as the reference's test_microbench_sweep_smoke runs
its own (a functional sweep of the plain versions: `interpret` true), the
tuned table and its install, the packed_state A/B against the reference's
at the same width, and the strict-JSON artifact of `run`."""

import json

import pytest
import torch

from dst_libp2p_test_node_tpu.runtime import microbench as jmb
from dst_libp2p_test_node_tpu_torch.native import score_update as su
from dst_libp2p_test_node_tpu_torch.native import tuned
from dst_libp2p_test_node_tpu_torch.native import vmem_gather as vg
from dst_libp2p_test_node_tpu_torch.runtime import microbench as mb

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sweep():
    return mb.sweep_kernels(n_rows=64, cap=8, reps=1, iters=2,
                            device="cpu")


def test_sweep_smoke(sweep):
    assert {"n_rows", "cap", "interpret", "kernels"} <= set(sweep)
    assert sweep["interpret"] is True          # the plain versions ran
    assert (sweep["n_rows"], sweep["cap"]) == (64, 8)
    assert list(sweep["kernels"]) == ["vmem_gather", "score_update",
                                      "score_update_decay_only"]
    for kernel, param in (("vmem_gather", "blocks_per_sm"),
                          ("score_update", "threads"),
                          ("score_update_decay_only", "threads")):
        entry = sweep["kernels"][kernel]
        assert {"candidates", "best_wall_s", f"best_{param}"} <= set(entry)
        assert entry["param"] == param
        assert str(entry[f"best_{param}"]) in entry["candidates"]
        assert entry["best_wall_s"] > 0.0
        assert str(entry["default"]) in entry["candidates"]
        assert "bound_s" not in entry       # no device number off the card
    assert list(sweep["kernels"]["vmem_gather"]["candidates"]) == [
        str(b) for b in range(1, vg.MAX_BLOCKS_PER_SM + 1)]
    assert list(sweep["kernels"]["score_update"]["candidates"]) == [
        "32", "64", "128", "256", "512", "1024"]


def test_flush_l2_refuses_the_cpu_and_a_cpu_sweep_never_calls_it(
        monkeypatch):
    with pytest.raises(ValueError, match="CUDA device"):
        mb.flush_l2("cpu")
    calls = []
    monkeypatch.setattr(mb, "flush_l2", calls.append)
    out = mb.sweep_kernels(n_rows=16, cap=4, reps=1, iters=2, device="cpu")
    assert calls == []
    assert all(w > 0.0 for k in out["kernels"].values()
               for w in k["candidates"].values())
    ran = []
    assert mb.mean_launch_s(lambda: ran.append(1), 3,
                            torch.device("cpu")) >= 0.0
    assert ran == [1, 1, 1] and calls == []


def test_a_candidate_that_differs_raises(monkeypatch):
    real = vg.vmem_gather

    def off_by_one(t, src, *, blocks_per_sm=None):
        out = real(t, src, blocks_per_sm=blocks_per_sm)
        return out + 1.0 if blocks_per_sm == 3 else out

    monkeypatch.setattr(vg, "vmem_gather", off_by_one)
    with pytest.raises(RuntimeError, match="blocks_per_sm=3 differs"):
        mb.sweep_kernels(n_rows=32, cap=4, reps=1, iters=1, device="cpu")


def test_a_score_candidate_outside_the_tolerance_raises(monkeypatch):
    real = su.score_update

    def drift(fmd, slow, scales, params, *, threads=None):
        f, s, score = real(fmd, slow, scales, params, threads=threads)
        return f, s, (score * 1.001 if threads == 64 else score)

    monkeypatch.setattr(su, "score_update", drift)
    with pytest.raises(RuntimeError, match="threads=64: score outside"):
        mb.sweep_kernels(n_rows=32, cap=4, reps=1, iters=1, device="cpu")


def test_tuned_table_weighs_every_shape():
    def sweep_of(walls):
        return {"kernels": {"score_update": {
            "param": "threads", "candidates": walls,
            "best_wall_s": min(walls.values())}}}

    # 64 wins the small shape by a little, 256 the large one by a lot
    sweeps = [sweep_of({"64": 1.0, "256": 1.1}),
              sweep_of({"64": 3.0, "256": 1.0})]
    assert mb.tuned_table(sweeps) == {"score_update": {"threads": 256}}


def test_tuned_table_takes_score_update_from_the_decay_only_form():
    def sweep_of(three, decay):
        return {"kernels": {
            "score_update": {"param": "threads", "candidates": three,
                             "best_wall_s": min(three.values())},
            "score_update_decay_only": {
                "param": "threads", "candidates": decay,
                "best_wall_s": min(decay.values())}}}

    # the three-output form prefers 1024, the form the main path runs 128
    sweeps = [sweep_of({"128": 1.1, "1024": 1.0}, {"128": 0.8, "1024": 0.9})
              for _ in range(2)]
    assert mb.tuned_table(sweeps) == {"score_update": {"threads": 128}}


def test_run_writes_a_strict_json_artifact_and_installs(tmp_path,
                                                         monkeypatch):
    table = tmp_path / "tuned.json"
    monkeypatch.setenv("DST_TUNED_JSON", str(table))
    tuned.invalidate_cache()
    out_path = tmp_path / "mb.json"
    try:
        out = mb.run(["--device", "cpu", "--only", "native/",
                      "--sweep-rows", "32,48", "--sweep-cap", "4",
                      "--packed-n", "48", "--reps", "1", "--install",
                      "--out", str(out_path)])

        def refuse(tok):
            raise ValueError(tok)

        art = json.loads(out_path.read_text(), parse_constant=refuse)
        assert art == json.loads(json.dumps(out))
        # the reference's sections, with "device" for "backend"
        assert set(art) == {"metric", "device", "rooflines", "kernel_sweep",
                            "tuned", "tuned_installed", "packed_state_ab"}
        assert art["metric"] == "microbench" and art["device"] == "cpu"
        assert set(art["rooflines"]) == {"native/score_update"}
        entry = art["rooflines"]["native/score_update"]
        assert {"flops", "hbm_bytes", "peak_memory_bytes", "retraces",
                "retrace_budget", "wall_s", "host_syncs"} <= set(entry)
        assert "share" not in entry          # a CPU wall is no device share
        assert [s["n_rows"] for s in art["kernel_sweep"]] == [32, 48]
        assert art["tuned_installed"] == str(table)
        installed = json.loads(table.read_text())
        assert installed == art["tuned"]
        assert su.launch_threads() == installed["score_update"]["threads"]
        assert vg.launch_blocks_per_sm("cpu") == (
            installed["vmem_gather"]["blocks_per_sm"])
    finally:
        tuned.invalidate_cache()


def test_run_without_a_card_refuses_the_default_device(capsys,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        mb.run(["--no-rooflines", "--no-sweep", "--no-packed"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("n", [48])
def test_packed_state_ab_agrees_with_the_reference(n):
    got = mb.packed_state_ab(n=n, reps=1, device="cpu")
    want = jmb.packed_state_ab(n=n, reps=1)
    assert set(want) <= set(got)
    assert got["program_identical"] == want["program_identical"] is True
    assert got["verdict"] == want["verdict"]
    assert (got["n_peers"], got["delivery_mode"]) == (n, "exact")
    assert got["receiver_side"] is False
    assert got["delays_identical"] is True
    assert got["op_log_identical"] is True
    assert got["launch_log_identical"] is None       # no card, no log
    assert got["launch_log_repeatable"] is None
    json.dumps(got, allow_nan=False)


def test_op_log_counts_dispatched_ops_and_kernel_launches():
    x = torch.arange(6, dtype=torch.float32)
    from dst_libp2p_test_node_tpu_torch.runtime.profiling import op_log

    log = op_log(lambda: (x + 1) * 2, torch.device("cpu"))
    assert log["aten.add.Tensor"] == 1 and log["aten.mul.Tensor"] == 1
    assert log["kernel vmem_gather"] == log["kernel score_update"] == 0
    # the same program logs the same; another program does not
    assert op_log(lambda: (x + 1) * 2, torch.device("cpu")) == log
    assert op_log(lambda: x * 2, torch.device("cpu")) != log
