"""The rung predictor (analysis/sharding_audit.predict_rung_certificate)
on the 2 x 2 CPU grid (tests/port/conftest.py's cpu_grid):

  - (c) fit_power_law, _eval_fit and _rung_partitions equal the
    reference's functions exactly on the same series and leaves, the
    constant and all-zero series and the dcn factor included;
  - (d) a certificate at 64 / 128 / 256 peers is strict JSON, its
    held-out point within 10% and its verdict the comparison of its
    total with the modeled HBM; rerun at each committed
    RUNG_*_torch.json's own fit points, dcn and scenario (2 steps: an
    argument's bytes depend on neither the device nor the step count),
    every leaf's argument fit equals the file's (each scenario's points
    measured once, shared by its rungs); each committed
    certificate is consistent, as the reference's are
    (tests/test_sharding_audit.py:291-343), on the modeled node of 8
    H100 80GB HBM3 GPUs, measured on an H100."""

import json
from pathlib import Path

import pytest
import torch

from dst_libp2p_test_node_tpu.analysis import sharding_audit as jsa
from dst_libp2p_test_node_tpu_torch.analysis import sharding_audit as sa
from dst_libp2p_test_node_tpu_torch.analysis.registry import (
    arena_rung_spec, attack_rung_spec)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
CERTS = ("RUNG_1M_torch.json", "RUNG_4M_torch.json", "RUNG_ARENA_torch.json")
NODE = {"name": "8x H100 80GB HBM3", "chips": 8,
        "hbm_bytes_per_chip": sa.H100_HBM_BYTES}

SERIES = [
    ([64, 128, 256, 512], [640 * n for n in (64, 128, 256, 512)]),
    ([64, 128, 256], [7, 7, 7]),
    ([64, 128, 256], [0, 0, 0]),
    ([64, 128, 256, 512], [0, 100, 0, 900]),
    ([64], [12345]),
    ([32, 96, 200, 700], [3.5 * n ** 1.5 + 11 for n in (32, 96, 200, 700)]),
    ([64, 128, 256, 512], [213968, 425200, 848176, 1694192]),
]


@pytest.mark.parametrize("ns,ys", SERIES)
def test_fit_and_eval_equal_the_references(ns, ys):
    fit = sa.fit_power_law(ns, ys)
    assert fit == jsa.fit_power_law(ns, ys)
    for n in (1, 300, 1_048_576, 4_194_304):
        assert sa._eval_fit(fit, n) == jsa._eval_fit(fit, n)


LEAVES = [
    {"shape": [4, 256, 40], "partitions_per_dim": [2, 2, 1]},
    {"shape": [4, 256], "partitions_per_dim": [2, 2]},
    {"shape": [4, 2], "partitions_per_dim": [2, 1]},
    {"shape": [256, 40], "partitions_per_dim": [2, 1]},
    {"shape": [4], "partitions_per_dim": [1]},
    {"shape": [4, 256, 8], "partitions_per_dim": [1, 2, 1]},
]


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("dcn", [1, 4])
def test_rung_partitions_equal_the_references(leaf, dcn):
    for trials, shape in ((4, {"trials": 2, "peers": 2}),
                          (4, {"trials": 2, "peers": 4}),
                          (8, {"trials": 4, "peers": 2})):
        assert sa._rung_partitions(leaf, trials, shape, dcn=dcn) == \
            jsa._rung_partitions(leaf, trials, shape, dcn=dcn)


def test_a_cpu_certificate_is_strict_within_10pct_and_consistent(cpu_grid):
    cert = sa.predict_rung_certificate(
        (64, 128, 256), steps=2, grid=cpu_grid, device="cpu")
    text = json.dumps(cert, allow_nan=False, sort_keys=True)
    assert json.loads(text) == cert
    assert cert["validation"]["within_10pct"]
    assert cert["measured_on"] == "cpu" and cert["temp_measured"] is False
    assert cert["modeled_device"] == NODE
    assert cert["audit_grid"] == {"trials": 2, "peers": 2}
    total = cert["predicted_per_device"]["total"]
    assert total == sum(cert["predicted_per_device"][k]
                        for k in ("arguments", "outputs", "temp"))
    assert (cert["verdict"] == "fits") == (total <= sa.H100_HBM_BYTES)
    assert cert["predicted_per_device"]["temp"] == 0
    assert [p["peers"] for p in cert["fit_points"]] == [64, 128, 256]


def _load(name):
    return json.loads((REPO / name).read_text())


def _arg_fits(cert):
    return {x["name"]: (x["coeff"], x["exponent"], x["rung_partitions"],
                        x["predicted_global_bytes"],
                        x["predicted_per_device_bytes"])
            for x in cert["leaves"]}


@pytest.fixture(scope="module")
def fit_points(cpu_grid):
    """Each committed scenario's fit points measured once on the CPU (2
    steps), shared by the rungs of that scenario."""
    cache = {}

    def get(kept):
        rung = kept["rung"]
        peers = [p["peers"] for p in kept["fit_points"]]
        key = (rung["scenario"], tuple(peers))
        if key not in cache:
            builder = (arena_rung_spec if rung["scenario"]
                       == "protocol_arena/episub" else attack_rung_spec)
            cache[key] = sa.rung_fit_points(peers, lambda n: builder(
                n, steps=2, grid=cpu_grid, device="cpu"))
        return cache[key]

    return get


@pytest.mark.parametrize("name", CERTS)
def test_committed_argument_fits_rerun_on_the_cpu(cpu_grid, fit_points,
                                                  name):
    kept = _load(name)
    rung = kept["rung"]
    cert = sa.rung_certificate(
        fit_points(kept), rung_peers=rung["peers"], steps=2,
        dcn=rung["dcn"], scenario=rung["scenario"], grid=cpu_grid,
        device="cpu")
    assert _arg_fits(cert) == _arg_fits(kept)
    assert cert["predicted_per_device"]["arguments"] == \
        kept["predicted_per_device"]["arguments"]
    assert [p["arguments"] for p in cert["fit_points"]] == [
        p["arguments"] for p in kept["fit_points"]]


@pytest.mark.parametrize("name", CERTS)
def test_committed_certificate_is_consistent(name):
    cert = _load(name)
    dcn = cert["rung"]["dcn"]
    node = dict(NODE, chips=8 * dcn,
                name=NODE["name"] if dcn == 1
                else f"{dcn} x {NODE['name']}")
    assert cert["modeled_device"] == node
    assert "H100" in cert["measured_on"] and "W" in cert["measured_on"]
    assert cert["temp_measured"] is True
    assert cert["validation"]["within_10pct"]
    total = cert["predicted_per_device"]["total"]
    assert total == sum(cert["predicted_per_device"][k]
                        for k in ("arguments", "outputs", "temp"))
    assert (cert["verdict"] == "fits") == (total <= sa.H100_HBM_BYTES)
    assert len(cert["leaves"]) >= 10
    assert sum(x["predicted_per_device_bytes"] for x in cert["leaves"]) == \
        pytest.approx(cert["predicted_per_device"]["arguments"], rel=0.01)
    if name == "RUNG_1M_torch.json":
        assert cert["rung"]["peers"] == 1048576 and dcn == 1
        assert cert["rung"]["scenario"] == "sybil_graft_flood"
    elif name == "RUNG_4M_torch.json":
        assert cert["rung"]["peers"] == 4194304 and dcn == 4
        assert cert["rung"]["trials"] == 16
    else:
        assert cert["rung"]["peers"] == 1048576
        assert cert["rung"]["scenario"] == "protocol_arena/episub"
        names = {x["name"] for x in cert["leaves"]}
        assert any("hops" in n for n in names), sorted(names)
        assert any("parent" in n for n in names), sorted(names)
