"""The port's twins of the repo's validity and calibration scripts
(scripts/*_torch.py) against the reference scripts on the CPU.

Each reference script is loaded from scripts/ by importlib beside its
twin, the same reduced module constants are set on both, and each
module's `Simulator` name is wrapped to keep the simulators it builds, so
neither script changes: the returned summaries must be equal exactly and
every run's concatenated delays bitwise equal. The reduced shapes: the
two Ethereum anchors at 512 peers and 2 slots, the seven loss-mode runs
at 128 peers, the four muxer runs at 64 peers (the 8-crossing override
too). The muxer twin also runs at its full 100-peer shape against the
committed table in docs/event_loop_calibration.json; the other full-shape
runs against the committed artifacts are marked slow (the card runs them
all in chip_smoke.py's phase 18). The service-load twin runs as a
subprocess beside the reference script at the chaos shape, and the port's
event-loop constants are pinned to the reference's and to the committed
host measurement."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DOCS = os.path.join(ROOT, "docs")

# reference script -> its twin
TWINS = {
    "attestation_anchor.py": "attestation_anchor_torch.py",
    "eth_anchor.py": "eth_anchor_torch.py",
    "loss_modes_ab.py": "loss_modes_ab_torch.py",
    "muxer_sensitivity.py": "muxer_sensitivity_torch.py",
    "service_load.py": "service_load_torch.py",
}
# the report's keys that come from the simulation and the admission
# sequence (tests/port/test_torch_traffic.py)
_SIM_KEYS = ("config", "offered", "admitted", "rejected", "shed_deadline",
             "dispatched", "quarantined", "retries", "batch_splits",
             "device_dispatches", "degraded", "shed_rate", "max_depth_seen",
             "queue_bound_held", "records_sha", "scrape", "kill")
# the service-load scripts' chaos example (their docstrings), in process
_CHAOS_ARGS = ("--peers", "48", "--subnets", "2", "--ticks", "12",
               "--per-tick", "4", "--max-batch", "2", "--queue-depth", "4",
               "--inject-failures", "1", "--retry-backoff-s", "0",
               "--kill-at-tick", "6", "--checkpoint-every", "2", "--no-http")


def _load(name, **constants):
    """scripts/`name` as a fresh module, its module constants replaced by
    `constants`, and the list the simulators it builds are kept in (none
    for a script without a `Simulator` name)."""
    spec = importlib.util.spec_from_file_location(
        "validity_" + name[:-3], os.path.join(ROOT, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key, value in constants.items():
        assert hasattr(mod, key), (name, key)
        setattr(mod, key, value)
    sims = []
    build = getattr(mod, "Simulator", None)
    if build is None:
        return mod, sims

    def kept(*args, **kw):
        sim = build(*args, **kw)
        sims.append(sim)
        return sim

    mod.Simulator = kept
    return mod, sims


def _delays(sim):
    return np.concatenate([r.delays_ms for r in sim.records])


def _same_delays(ref_sims, twin_sims):
    assert len(ref_sims) == len(twin_sims) > 0
    for r, t in zip(ref_sims, twin_sims):
        want, got = _delays(r), _delays(t)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("script", ["attestation_anchor.py", "eth_anchor.py"])
def test_anchor_twin_matches_reference(script):
    ref, ref_sims = _load(script, N=512, SLOTS=2)
    twin, twin_sims = _load(TWINS[script], N=512, SLOTS=2)
    want = ref.run()
    got = twin.run(device="cpu")
    assert got == want
    _same_delays(ref_sims, twin_sims)
    assert got["coverage"] == 1.0


# scripts/loss_modes_ab.py's seven (loss, loss_mode, with_gossip) runs
_LOSS_RUNS = ((0.0, "tcp", True), (0.01, "tcp", True),
              (0.01, "message", True), (0.20, "tcp", True),
              (0.20, "message", True), (0.50, "tcp", False),
              (0.50, "message", False))


@pytest.mark.parametrize("loss,mode,gossip", _LOSS_RUNS)
def test_loss_modes_twin_matches_reference(loss, mode, gossip):
    ref, ref_sims = _load("loss_modes_ab.py", N=128)
    twin, twin_sims = _load("loss_modes_ab_torch.py", N=128)
    want = ref._run(loss, mode, with_gossip=gossip)
    got = twin._run(loss, mode, with_gossip=gossip, device="cpu")
    assert got == want
    _same_delays(ref_sims, twin_sims)


def test_loss_modes_twin_runs_the_reference_tuples():
    # the seven tuples, in the order of scripts/loss_modes_ab.py's rows
    ref, _ = _load("loss_modes_ab.py")
    twin, _ = _load("loss_modes_ab_torch.py")
    assert (ref.LOSS, ref.STRESS, ref.SPLIT) == (0.01, 0.20, 0.50)
    assert twin.RUNS == _LOSS_RUNS


@pytest.mark.parametrize("muxer,crossings", [
    ("quic", None), ("yamux", None), ("mplex", None), ("yamux", 8.0)])
def test_muxer_twin_matches_reference(muxer, crossings):
    ref, ref_sims = _load("muxer_sensitivity.py", N=64)
    twin, twin_sims = _load("muxer_sensitivity_torch.py", N=64)
    override = None if crossings is None else crossings * twin.EVENT_LOOP_MS
    want = ref._run(muxer, override)
    got = twin._run(muxer, override, device="cpu")
    assert got == want
    _same_delays(ref_sims, twin_sims)
    if override is not None:
        # the override replaced the params the port's publish reads: the
        # same run without it gives other delays
        twin._run(muxer, device="cpu")
        assert _delays(twin_sims[-1]).tobytes() != \
            _delays(twin_sims[0]).tobytes()


def test_muxer_twin_full_shape_matches_committed_table():
    twin, _ = _load("muxer_sensitivity_torch.py")
    with open(os.path.join(DOCS, "event_loop_calibration.json")) as f:
        committed = json.load(f)["muxer_sensitivity"]
    assert twin.table(device="cpu") == committed


@pytest.mark.slow
@pytest.mark.parametrize("script,artifact", [
    ("attestation_anchor_torch.py", "VALIDITY_ANCHOR2.json"),
    ("eth_anchor_torch.py", "VALIDITY_ANCHOR.json")])
def test_anchor_twin_full_shape_matches_committed(script, artifact):
    twin, _ = _load(script)
    with open(os.path.join(DOCS, artifact)) as f:
        committed = json.load(f)["ours"]
    assert twin.run(device="cpu") == committed


@pytest.mark.slow
def test_loss_modes_twin_full_shape_matches_committed():
    twin, _ = _load("loss_modes_ab_torch.py")
    with open(os.path.join(DOCS, "LOSS_MODES.json")) as f:
        committed = json.load(f)["runs"]
    rows = [twin._run(loss, mode, gossip, device="cpu")
            for loss, mode, gossip in twin.RUNS]
    assert rows == committed


def test_event_loop_constants_match_reference_and_measurement():
    assert tsim.EVENT_LOOP_MS == jsim.EVENT_LOOP_MS
    assert tsim._MUXER_CROSSINGS == jsim._MUXER_CROSSINGS
    assert tsim.MUXER_PROC_MS == jsim.MUXER_PROC_MS
    for m, v in tsim.MUXER_PROC_MS.items():
        assert v == tsim.EVENT_LOOP_MS * tsim._MUXER_CROSSINGS[m]
    with open(os.path.join(DOCS, "event_loop_calibration.json")) as f:
        cal = json.load(f)
    assert cal["payload_bytes"] == 15000 and cal["n_conns"] == 10
    assert tsim.EVENT_LOOP_MS == pytest.approx(cal["event_loop_ms_median"],
                                               rel=0.01)


def _script(name, *args, cwd):
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", name), *args],
        cwd=cwd, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc


def test_service_load_twin_matches_reference_script(tmp_path):
    outs = {}
    for name, extra in (("service_load_torch.py", ("--device", "cpu")),
                        ("service_load.py", ())):
        out = tmp_path / f"{name}.json"
        _script(name, *_CHAOS_ARGS, *extra, "--checkpoint",
                str(tmp_path / f"{name}.npz"), "--json", str(out),
                cwd=tmp_path)
        with open(out) as f:
            outs[name] = json.load(f)
    got, want = outs["service_load_torch.py"], outs["service_load.py"]
    assert got["kill"]["bit_identical"] is True
    for key in _SIM_KEYS:
        assert got[key] == want[key], key


@pytest.mark.parametrize("twin", sorted(TWINS.values()))
def test_twin_raises_without_a_card(twin, monkeypatch):
    mod, _ = _load(twin)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [twin])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()


@pytest.mark.parametrize("twin,artifact", [
    ("attestation_anchor_torch.py", "VALIDITY_ANCHOR2.json"),
    ("eth_anchor_torch.py", "VALIDITY_ANCHOR.json"),
    ("loss_modes_ab_torch.py", "LOSS_MODES.json"),
    ("muxer_sensitivity_torch.py", "event_loop_calibration.json")])
def test_twin_never_writes_the_reference_artifact(twin, artifact,
                                                  monkeypatch):
    mod, _ = _load(twin)
    path = os.path.join(DOCS, artifact)
    monkeypatch.setattr(sys, "argv",
                        [twin, "--device", "cpu", "--write", path])
    mtime = os.stat(path).st_mtime_ns
    with pytest.raises(SystemExit):
        mod.main()
    assert os.stat(path).st_mtime_ns == mtime
