"""The campaign on the peer mesh, on the CPU: run_campaign with a trial
grid two devices wide per group (tests/port/conftest.py's cpu_grid: two
trial groups of two gloo ranks, each trial's rows split over its group)
and run_campaign(mesh=) on two gloo ranks (cpu_mesh: every cell on the
mesh, trials one after another), against the reference's single-device
run_campaign(cfg) (its vmapped seed stack):

  - the reference's trial-sharding configurations (tests/
    test_trial_sharding.py: _cfg(), the faulted one and _dht_cfg(), four
    seeds at 64 peers): every TrialResult field outside the walls equal,
    no tolerance (the reference's own nested campaign needs GSPMD's
    peer-sharded programs, which fail on the pinned jax; its single-
    device run is what it pins them to);
  - the trial checkpoints and .obs.npz sidecars: the grid's and the
    mesh's files byte for byte the port's one-process files, and array
    for array the reference's;
  - resume across grids: the mesh resumes one process's files, one
    process and the grid resume the mesh's, every attacked trial resumed,
    no file rewritten, the same result."""

import filecmp
import os

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.ops import dht_adversary as jdht
from dst_libp2p_test_node_tpu.ops import faults as jf
from dst_libp2p_test_node_tpu.ops.repair import RepairParams as JRepair
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import dht_adversary as tdht
from dst_libp2p_test_node_tpu_torch.ops import faults as tf
from dst_libp2p_test_node_tpu_torch.ops.repair import RepairParams as TRepair
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

_PKG = {"jax": (jc, jsim, JTopo, JRepair, jf, jdht),
        "torch": (tc, tsim, TTopo, TRepair, tf, tdht)}
CASES = ("static", "faulted", "dht")


def _cfg(pkg, case, ckpt):
    """The reference's _exp / _cfg, its faulted config and _dht_cfg
    (tests/test_trial_sharding.py)."""
    camp, sim, topo, repair, flt, dht = _PKG[pkg]
    kw = dict(
        fractions=(0.0, 0.2), seeds=(0, 1, 2, 3), attack_heartbeats=6,
        checkpoint_dir=ckpt,
        experiment=sim.ExperimentConfig(
            topo=topo(network_size=64, anchor_stages=2, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=2000, messages=2, delay_seconds=1.0),
            connect_to=8, gossipsub=camp.attack_gossipsub(), warmup_s=8.0,
            seed=0))
    if case == "faulted":
        kw.update(faults=flt.FaultParams(
            partition_frac=0.5, partition_window=(1, 4), crash_frac=0.1,
            crash_window=(1, 3)))
    elif case == "dht":
        kw.update(attack_heartbeats=4, recovery_heartbeats=4,
                  repair=repair(evict=True, redial=True),
                  dht=dht.DhtAdversaryParams(
                      lookup_eclipse=True, rtable_poison=True, heal_hb=2,
                      warmup_waves=1, lookup_rounds=2))
    return camp.CampaignConfig(**kw)


def _fields(res):
    return interop.result_fields(res, walls=False)


def _same_files(a, b) -> list:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    return [n for n in names
            if not filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                               shallow=False)]


def _array_mismatches(a, b) -> list:
    bad = []
    for name in sorted(os.listdir(a)):
        with np.load(os.path.join(a, name)) as za, \
                np.load(os.path.join(b, name)) as zb:
            if za.files != zb.files:
                bad.append(name)
                continue
            bad += [f"{name}:{k}" for k in za.files
                    if za[k].dtype != zb[k].dtype
                    or za[k].tobytes() != zb[k].tobytes()]
    return bad


@pytest.mark.parametrize("case", CASES)
def test_grid_and_mesh_campaigns_equal_the_reference(case, cpu_grid,
                                                     cpu_mesh, tmp_path):
    d = {k: str(tmp_path / k) for k in ("ref", "one", "grid", "mesh")}
    ref = jc.run_campaign(_cfg("jax", case, d["ref"]))
    one = tc.run_campaign(_cfg("torch", case, d["one"]), device="cpu")
    grid = tc.run_campaign(_cfg("torch", case, d["grid"]),
                           trial_mesh=cpu_grid, device="cpu")
    mesh = tc.run_campaign(_cfg("torch", case, d["mesh"]), mesh=cpu_mesh,
                           device="cpu")
    want = interop.result_fields(ref, walls=False)
    for res in (one, grid, mesh):
        assert _fields(res) == want
    # every attacked trial ran on the ranks, in seed order
    for res in (grid, mesh):
        att = [w for w in res.phase_walls if w["fraction"] > 0]
        assert [w["seed"] for w in att] == [0, 1, 2, 3]
        assert not any(w["resumed"] for w in att)
    assert _same_files(d["one"], d["grid"]) == []
    assert _same_files(d["one"], d["mesh"]) == []
    assert _array_mismatches(d["ref"], d["mesh"]) == []
    trials = [t for t in mesh.trials if t.fraction > 0]
    if case == "dht":
        assert all(t.rtable_poison_frac >= 0.0 for t in trials)
        assert any(t.redials_total > 0 for t in trials)
    if case == "faulted":
        assert any(t.coverage_under_partition >= 0.0 for t in trials)


def _resumed(res) -> bool:
    att = [w for w in res.phase_walls if w["fraction"] > 0]
    return bool(att) and all(w["resumed"] for w in att)


def test_resume_across_grids(cpu_grid, cpu_mesh, tmp_path):
    runs = {"one": dict(device="cpu"),
            "grid": dict(trial_mesh=cpu_grid, device="cpu"),
            "mesh": dict(mesh=cpu_mesh, device="cpu")}
    # files written in one process resume on the mesh; files written on
    # the mesh resume in one process and on the grid
    for writer, readers in (("one", ("mesh",)), ("mesh", ("one", "grid"))):
        d = str(tmp_path / writer)
        first = tc.run_campaign(_cfg("torch", "static", d), **runs[writer])
        names = sorted(os.listdir(d))
        mtimes = {n: os.path.getmtime(os.path.join(d, n)) for n in names}
        for reader in readers:
            again = tc.run_campaign(_cfg("torch", "static", d),
                                    **runs[reader])
            assert _fields(again) == _fields(first), (writer, reader)
            assert _resumed(again), (writer, reader)
        # no file rewritten
        assert {n: os.path.getmtime(os.path.join(d, n))
                for n in names} == mtimes
