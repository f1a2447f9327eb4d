"""The port's contract registry (analysis/registry.py) against the
reference's, on the CPU: for every shared contract name the two specs are
built from the same seeds, run, and their outputs compared leaf by leaf,
bitwise (integer, bool, gather and min leaves and every float leaf) apart
from native/score_update's score, which the reference pins to rtol 1e-5 /
atol 1e-6 (tests/test_score_kernel.py: an FMA the kernel may contract).
The port's names are the reference's: its 20 single-device contracts
without rank pools, all 26 with them (the six mesh contracts,
tests/port/test_torch_sharding_audit.py)."""

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.analysis import registry as jreg
from dst_libp2p_test_node_tpu_torch.analysis import registry as treg
from dst_libp2p_test_node_tpu_torch.analysis.contracts import (leaves,
                                                               numpy_leaves)
from dst_libp2p_test_node_tpu_torch.analysis.jaxpr_audit import (
    audit_contract, run_checkify)

torch.set_num_threads(1)

# the reference's contracts that run on rank pools
MESH_CONTRACTS = {
    "campaign/faulted_window_nested", "campaign/attack_window_sharded",
    "campaign/attack_window_nested", "campaign/attack_window_dcn",
    "campaign/dht_attack_window", "protocol/arena_window",
}
# leaves the reference pins to a tolerance, with it
TOLERANCES = {("native/score_update", "[2]"): dict(rtol=1e-5, atol=1e-6)}

PORT = {c.name: c for c in treg.default_contracts("cpu")}
NAMES = sorted(PORT)


@pytest.fixture(scope="module")
def reference():
    return {c.name: c for c in jreg.default_contracts()}


def test_port_names_are_the_references_single_device_names(reference,
                                                           cpu_mesh,
                                                           cpu_grid):
    assert MESH_CONTRACTS <= set(reference)
    assert set(PORT) == set(reference) - MESH_CONTRACTS
    assert len(PORT) == 20
    assert [c.name for c in treg.default_contracts("cpu")] == [
        c.name for c in jreg.default_contracts()
        if c.name not in MESH_CONTRACTS]
    every = [c.name for c in treg.default_contracts(
        "cpu", pool=cpu_mesh, grid=cpu_grid)]
    assert len(every) == 26
    assert every == [c.name for c in jreg.default_contracts()]


@pytest.mark.parametrize("name", NAMES)
def test_contract_outputs_equal_the_references(reference, name):
    want = numpy_leaves(reference[name].build().thunk()())
    got = numpy_leaves(PORT[name].build().thunk()())
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        b = got[k]
        assert (b.dtype, b.shape) == (a.dtype, a.shape), k
        tol = TOLERANCES.get((name, k))
        if tol is None:
            assert b.tobytes() == a.tobytes(), k
        else:
            np.testing.assert_allclose(b, a, **tol)


@pytest.mark.parametrize("name", NAMES)
def test_contract_runs_clean_and_builds_equal_inputs(name):
    c = PORT[name]
    assert audit_contract(c) == []
    a = numpy_leaves((c.build().args, c.build().kwargs))
    b = numpy_leaves((c.build().args, c.build().kwargs))
    assert a.keys() == b.keys()
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


def test_runtime_checks_hold_on_the_cpu():
    checked = [c for c in PORT.values() if c.runtime_check is not None]
    assert {c.name for c in checked} == {
        "disseminate/cold", "run_heartbeats", "repair/recovery_window"}
    assert run_checkify(checked) == []


def test_feedback_drift_is_a_finding():
    import dataclasses

    c = PORT["run_heartbeats"]

    def drifting(*args, **kwargs):
        s = c.build().fn(*args, **kwargs)
        return s.replace(grafts=s.grafts.long())

    spec = c.build()
    bad = dataclasses.replace(
        c, build=lambda: dataclasses.replace(spec, fn=drifting))
    found = audit_contract(bad)
    assert [v.rule for v in found] == ["GA-J005"]
    assert "grafts" in found[0].message and "int64" in found[0].message


def test_a_failing_entry_point_is_a_finding():
    import dataclasses

    c = PORT["heartbeat_step"]

    def broken(*args, **kwargs):
        raise RuntimeError("boom")

    spec = c.build()
    bad = dataclasses.replace(
        c, build=lambda: dataclasses.replace(spec, fn=broken))
    found = audit_contract(bad)
    assert [v.rule for v in found] == ["GA-J001"]
    assert "boom" in found[0].message


def test_leaves_name_the_same_paths_on_both_sides(reference):
    res_j = reference["disseminate/bounded"].build().thunk()()
    res_t = PORT["disseminate/bounded"].build().thunk()()
    assert set(leaves(res_j)) == set(leaves(res_t))
    assert "[1].key" in leaves(res_t) and "[0].delay_ms" in leaves(res_t)


def test_publish_batch_scan_padding_equals_the_references():
    from dst_libp2p_test_node_tpu.runtime.publisher import (
        publish_batch_scan as jscan)
    from dst_libp2p_test_node_tpu_torch.runtime.publisher import (
        publish_batch_scan as tscan)

    rows = np.array([3, 5, 7, 3], dtype=np.int32)
    active = np.array([True, False, True, False])
    out = {}
    for side, contracts, fn in (("jax", jreg.default_contracts(), jscan),
                                ("port", PORT.values(), tscan)):
        spec = next(c for c in contracts
                    if c.name == "publisher/batch_scan").build()
        args = spec.args[:6] + (rows, active)
        out[side] = numpy_leaves(fn(*args, **spec.kwargs))
    assert sorted(out["port"]) == sorted(out["jax"])
    for k, a in out["jax"].items():
        assert out["port"][k].tobytes() == a.tobytes(), k
    assert not out["port"]["[0].received"][1].any()
