"""The port's trial grid (parallel/sharding.make_trial_mesh, the rank
launcher parallel/ranks.RankPool, run_campaign / run_defense_sweep /
run_arena_campaign with trial_mesh) on the CPU, against the port's own
sequential runs and the reference's trial-mesh campaigns:

  - the mesh rules of the reference (tests/test_trial_sharding.py:
    shape and divisibility, the full grid and its edge cases) over
    `devices=` lists, and a grid wider than one device per group refused
    naming the peer mesh's next slice, as are the nested placers (the row
    placers are the peer mesh's and take its PeerMesh);
  - run_campaign on a 2- and a 4-rank grid (3 seeds: the 4-rank grid
    leaves one rank idle) for the reference's static, recovery, faulted
    and DHT configurations (tests/test_trial_sharding.py:55-70, 121-129,
    319-383) and an adaptive one: every TrialResult field outside the
    walls equal to the port's sequential run, and (the reference's four)
    against jc.run_campaign(trial_mesh=make_trial_mesh(2, n_devices=2))
    exact on the reference's _EXACT fields and within its own rtol 1e-5
    on _COMPARE (tests/test_trial_sharding.py:73-89), zero-attacker
    trials exactly equal;
  - trial checkpoints written under 4 groups resumed under 2 (no file
    rewritten), then a truncated snapshot, a truncated sidecar, metadata
    that is no JSON and a foreign epoch hash, one per trial, each
    recomputed, not trusted;
  - the supervisor's injected failures: the same retries and result as
    sequentially;
  - run_defense_sweep and run_arena_campaign on the 2- and 4-rank grids
    equal to their sequential runs, and to the reference's trial-mesh
    runs (exact on counts, identities and shas, within rtol 1e-5 on the
    other numbers);
  - the launcher: a rank that raises makes the call raise with its
    number and traceback, a missed deadline or a dead rank too, and the
    pool starts again after.

Each rank is limited to one CPU thread; the equalities show the bytes do
not change with the split or the thread count.
"""

import dataclasses
import json
import operator
import os
import signal

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu.config.topology import TopoParams as JTopo
from dst_libp2p_test_node_tpu.ops import adversary as jadv
from dst_libp2p_test_node_tpu.ops import dht_adversary as jdht
from dst_libp2p_test_node_tpu.ops import faults as jf
from dst_libp2p_test_node_tpu.ops.repair import RepairParams as JRepair
from dst_libp2p_test_node_tpu.parallel import sharding as jsh
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu.runtime import simulator as jsim
from dst_libp2p_test_node_tpu_torch import interop
from dst_libp2p_test_node_tpu_torch.config.topology import TopoParams as TTopo
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops import dht_adversary as tdht
from dst_libp2p_test_node_tpu_torch.ops import faults as tf
from dst_libp2p_test_node_tpu_torch.ops.repair import RepairParams as TRepair
from dst_libp2p_test_node_tpu_torch.parallel import sharding as tsh
from dst_libp2p_test_node_tpu_torch.parallel.ranks import RankError, RankPool
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc
from dst_libp2p_test_node_tpu_torch.runtime import simulator as tsim

torch.set_num_threads(1)

_PKG = {"jax": (jc, jsim, JTopo, JRepair, jf, jdht, jadv),
        "torch": (tc, tsim, TTopo, TRepair, tf, tdht, tadv)}
SEEDS = (0, 1, 2)

# the reference's comparison fields (tests/test_trial_sharding.py:73-89)
_COMPARE = ("honest_coverage", "benign_coverage", "latency_p50_ms",
            "latency_p99_ms", "latency_inflation", "graylisted_frac_final",
            "attacker_mesh_share_final", "attacker_score_final",
            "recovery_time_ms")
_EXACT = ("attackers", "hb_to_graylist", "mesh_recovery_hb",
          "mesh_evictions_total", "px_grafts_total", "redials_total")


def _cfg(pkg, case="static", seeds=SEEDS, **over):
    """The reference's trial-sharding configurations (_exp / _cfg and the
    recovery, faulted and DHT cases) at 64 peers, plus an adaptive one."""
    camp, sim, topo, repair, flt, dht, adv = _PKG[pkg]
    kw = dict(
        scenario="sybil_graft_flood", fractions=(0.0, 0.2), seeds=seeds,
        experiment=sim.ExperimentConfig(
            topo=topo(network_size=64, anchor_stages=2, min_bandwidth=50,
                      max_bandwidth=150, min_latency=40, max_latency=130,
                      msg_size_bytes=2000, messages=2, delay_seconds=1.0),
            connect_to=8, gossipsub=camp.attack_gossipsub(), warmup_s=8.0,
            seed=0),
        attack_heartbeats=6)
    if case == "recovery":
        kw.update(fractions=(0.2,), recovery_heartbeats=4,
                  repair=repair(evict=True, px=True, redial=True))
    elif case == "faulted":
        kw.update(faults=flt.FaultParams(
            partition_frac=0.5, partition_window=(1, 4), crash_frac=0.1,
            crash_window=(1, 3)))
    elif case == "dht":
        kw.update(attack_heartbeats=4, recovery_heartbeats=4,
                  repair=repair(evict=True, redial=True),
                  dht=dht.DhtAdversaryParams(
                      lookup_eclipse=True, rtable_poison=True, heal_hb=2,
                      warmup_waves=1, lookup_rounds=2))
    elif case == "adaptive":
        kw.update(scenario="eclipse_publisher", recovery_heartbeats=4,
                  repair=repair(evict=True, px=True, redial=True),
                  adversary=adv.AdversaryParams(
                      scenario="eclipse_publisher",
                      adaptive=adv.AdaptivePolicy(enabled=True)))
        kw["experiment"] = dataclasses.replace(
            kw["experiment"],
            gossipsub=camp.attack_gossipsub(flood_publish=False))
    kw.update(over)
    return camp.CampaignConfig(**kw)


def _fields(res):
    return interop.result_fields(res, walls=False)


def _close_to_reference(port, ref):
    assert len(port.trials) == len(ref.trials)
    for tp, tj in zip(port.trials, ref.trials):
        assert (tp.fraction, tp.seed) == (tj.fraction, tj.seed)
        for k in _EXACT:
            assert getattr(tp, k) == getattr(tj, k), (k, tp.seed)
        for k in _COMPARE:
            np.testing.assert_allclose(
                getattr(tp, k), getattr(tj, k), rtol=1e-5,
                err_msg=f"{k} diverged at seed {tp.seed}")
        if tp.fraction == 0.0:
            assert _fields(tp) == interop.result_fields(tj, walls=False)


@pytest.fixture(scope="module")
def pools():
    """A 2- and a 4-rank CPU grid for the module; each starts its ranks at
    its first campaign."""
    with RankPool(["cpu"] * 2, threads=1) as p2, \
            RankPool(["cpu"] * 4, threads=1) as p4:
        yield {2: p2, 4: p4}


# ------------------------------------------------------------ the mesh rules


def test_trial_mesh_shape_and_divisibility():
    m = tsh.make_trial_mesh(2, devices=["cpu"] * 4)
    assert m.shape == {tsh.TRIAL_AXIS: 2, "peers": 2}
    assert tsh.make_trial_mesh(devices=["cpu"] * 4).shape[
        tsh.TRIAL_AXIS] == 4
    assert tsh.make_trial_mesh(platform="cpu", n_devices=4).shape == {
        tsh.TRIAL_AXIS: 4, "peers": 1}
    with pytest.raises(ValueError) as te:
        tsh.make_trial_mesh(3, devices=["cpu"] * 4)
    with pytest.raises(ValueError) as je:
        jsh.make_trial_mesh(3, n_devices=4)
    assert str(te.value) == str(je.value)
    # one card shared by two ranks: a device may repeat
    m = tsh.make_trial_mesh(devices=["cuda:0", "cuda:0"])
    assert m.group_devices == [torch.device("cuda", 0)] * 2


def test_trial_mesh_full_grid_and_edge_cases():
    eight = ["cpu"] * 8
    m = tsh.make_trial_mesh(2, devices=eight)
    assert m.shape == {tsh.TRIAL_AXIS: 2, "peers": 4}
    assert tsh.peers_per_group(m) == 4
    m1 = tsh.make_trial_mesh(1, devices=eight, n_devices=1)
    assert m1.shape == {tsh.TRIAL_AXIS: 1, "peers": 1}
    assert tsh.peers_per_group(m1) == 1
    for groups, n in ((0, 4), (3, 8), (5, 8)):
        with pytest.raises(ValueError):
            tsh.make_trial_mesh(groups, devices=eight, n_devices=n)
    # the DCN grid: one block per process, each this process's groups
    d = tsh.make_dcn_mesh(devices=["cpu"] * 4)
    assert d.shape == {tsh.DCN_AXIS: 1, tsh.TRIAL_AXIS: 2, "peers": 2}
    assert tsh.local_trial_submesh(d).shape == {tsh.TRIAL_AXIS: 2,
                                                "peers": 2}
    # groups wider than one device are the peer mesh's: refused by name
    with pytest.raises(NotImplementedError, match="A13, second half"):
        tc.run_campaign(_cfg("torch"), trial_mesh=m, device="cpu")
    # the nested shardings are the peer mesh's next slice; the row placers
    # are ported and take a PeerMesh, not a trial grid
    for fn, args in ((tsh.place_trial_batch, (None, {}, m)),
                     (tsh.nested_sharding, (m,))):
        with pytest.raises(NotImplementedError, match="peer mesh"):
            fn(*args)
    for fn, args in ((tsh.peer_sharding, (m,)),
                     (tsh.reshard_rows, (np.zeros(4), m))):
        with pytest.raises(TypeError, match="PeerMesh"):
            fn(*args)
    with pytest.raises(NotImplementedError, match="peer mesh"):
        tc.run_campaign(_cfg("torch"), mesh=object(), device="cpu")


# ---------------------------------------------------- campaigns on the grid


# the grids each case runs on; the adaptive case is no case of the
# reference's trial-sharding tests, and its sequential run is held against
# the reference's in tests/port/test_torch_adaptive.py
GRIDS = {"static": (2, 4), "recovery": (2,), "faulted": (4,), "dht": (2, 4),
         "adaptive": (2,)}


@pytest.mark.parametrize("case", list(GRIDS))
def test_grid_campaign_equals_sequential_and_reference(pools, case):
    seq = tc.run_campaign(_cfg("torch", case), device="cpu")
    for groups in GRIDS[case]:
        res = tc.run_campaign(_cfg("torch", case), trial_mesh=pools[groups],
                              device="cpu")
        assert _fields(res) == _fields(seq), groups
        # every attacked trial ran on a rank, in seed order
        att = [w for w in res.phase_walls if w["fraction"] > 0]
        assert [w["seed"] for w in att] == list(SEEDS)
    if case != "adaptive":
        _close_to_reference(seq, jc.run_campaign(
            _cfg("jax", case), trial_mesh=jsh.make_trial_mesh(2, n_devices=2)))
    att = [t for t in seq.trials if t.fraction > 0]
    if case in ("recovery", "dht", "adaptive"):
        assert any(t.redials_total > 0 for t in att)
    if case == "dht":
        assert all(t.rtable_poison_frac >= 0.0 for t in att)
    if case == "faulted":
        assert any(t.coverage_under_partition >= 0.0 for t in att)


def test_grid_resume_and_recompute(pools, tmp_path):
    d = str(tmp_path / "ck")
    cfg = _cfg("torch", "static", seeds=(0, 1, 2, 3), fractions=(0.2,),
               checkpoint_dir=d)
    r1 = tc.run_campaign(cfg, trial_mesh=pools[4], device="cpu")
    written = sorted(os.listdir(d))
    assert len(written) == 8          # 4 trial checkpoints + 4 sidecars
    mtimes = {f: os.path.getmtime(os.path.join(d, f)) for f in written}
    # resumed under 2 groups: no snapshot rewritten, the same result
    r2 = tc.run_campaign(cfg, trial_mesh=pools[2], device="cpu")
    assert {f: os.path.getmtime(os.path.join(d, f)) for f in written} \
        == mtimes
    assert _fields(r2) == _fields(r1)
    assert all(w["resumed"] for w in r2.phase_walls)
    # one failure class per trial; each trial is recomputed, not trusted
    snaps = sorted(f for f in written if not f.endswith(".obs.npz"))
    with open(os.path.join(d, snaps[0]), "wb") as fh:
        fh.write(b"\x00" * 16)
    side = os.path.join(d, snaps[1][:-len(".npz")] + ".obs.npz")
    raw = open(side, "rb").read()
    with open(side, "wb") as fh:
        fh.write(raw[: len(raw) // 3])
    for snap, mutate in (
            (snaps[2], lambda meta: b'{"version": not json'),
            (snaps[3], lambda meta: json.dumps(
                dict(meta, graph_sha256="0" * 64)).encode())):
        path = os.path.join(d, snap)
        with np.load(path) as z:
            arrs = {k: z[k] for k in z.files}
        meta = json.loads(bytes(arrs["meta_json"]).decode())
        arrs["meta_json"] = np.frombuffer(mutate(meta), dtype=np.uint8)
        np.savez(path, **arrs)
    r3 = tc.run_campaign(cfg, trial_mesh=pools[2], device="cpu")
    assert _fields(r3) == _fields(r1)
    assert not any(w["resumed"] for w in r3.phase_walls)


def test_grid_supervisor_retries_as_sequentially(pools):
    cfg = _cfg("torch", "static", fractions=(0.2,),
               supervisor=tc.SupervisorConfig(inject_failures=1,
                                              retry_backoff_s=0.0))
    seq = tc.run_campaign(cfg, device="cpu")
    grid = tc.run_campaign(cfg, trial_mesh=pools[2], device="cpu")
    assert _fields(grid) == _fields(seq)
    assert grid.retries_total == 1 and grid.degraded
    assert not grid.quarantined_trials


def _close_floats(port, ref, exact_keys):
    """Artifact rows of the port against the reference's: `exact_keys`
    equal, every other number within the reference's rtol 1e-5."""
    assert port.keys() == ref.keys()
    for k, v in port.items():
        if k in exact_keys or not isinstance(v, float):
            assert v == ref[k], k
        else:
            np.testing.assert_allclose(v, ref[k], rtol=1e-5, err_msg=k)


def _arena_cfg(pkg):
    camp, sim, _, _, _, _, adv = _PKG[pkg]
    cfg = _cfg(pkg, "static", seeds=(0, 1), fractions=(0.25,),
               adversary=adv.AdversaryParams(
                   scenario="sybil_graft_flood",
                   adaptive=adv.AdaptivePolicy(enabled=True)))
    cfg.experiment = dataclasses.replace(
        cfg.experiment, gossipsub=camp.attack_gossipsub(flood_publish=False))
    return cfg


def test_grid_defense_sweep_and_arena(pools):
    grid = dict(degree_grid=((4, 6, 8),), weight_grid=(-10.0,))
    sweeps = {}
    for pkg in ("torch", "jax"):
        adv = _PKG[pkg][6]
        sweeps[pkg] = _cfg(pkg, "adaptive", seeds=(0, 1), fractions=(0.2,),
                           adversary=adv.AdversaryParams(
                               scenario="eclipse_publisher",
                               adaptive=adv.AdaptivePolicy(enabled=True)))
    seq = tc.run_defense_sweep(sweeps["torch"], device="cpu", **grid)
    ref = jc.run_defense_sweep(
        sweeps["jax"], trial_mesh=jsh.make_trial_mesh(2, n_devices=2),
        **grid)
    for d in (seq, ref):
        assert d.pop("wall_s") >= 0.0
    for g in (2, 4):
        on = tc.run_defense_sweep(sweeps["torch"], trial_mesh=pools[g],
                                  device="cpu", **grid)
        assert on.pop("wall_s") >= 0.0
        assert on == seq and len(on["configs"]) == 1
    rows = seq.pop("configs")
    assert seq == {k: v for k, v in ref.items() if k != "configs"}
    for r, rj in zip(rows, ref["configs"]):
        _close_floats(r, rj, ("trials", "degraded", "is_default"))

    seq = tc.run_arena_campaign(_arena_cfg("torch"), device="cpu")
    ref = jc.run_arena_campaign(
        _arena_cfg("jax"), trial_mesh=jsh.make_trial_mesh(2, n_devices=2))
    for d in (seq, ref):
        assert d.pop("wall_s") >= 0.0
    for g in (2, 4):
        on = tc.run_arena_campaign(_arena_cfg("torch"), trial_mesh=pools[g],
                                   device="cpu")
        assert on.pop("wall_s") >= 0.0
        assert on == seq
    assert [(t["protocol"], t["seed"]) for t in seq["trials"]
            if t["scenario"] == "sybil_graft_flood"] == [
        ("gossipsub", 0), ("gossipsub", 1), ("episub", 0), ("episub", 1)]
    assert len(seq["trials"]) == len(ref["trials"])
    for t, tj in zip(seq["trials"], ref["trials"]):
        _close_floats(t, tj, ("scenario", "protocol", "seed", "attackers",
                              "cohort_sha256"))
    assert seq["identity"] == ref["identity"]


# --------------------------------------------------------------- the launcher


def test_rank_errors_name_the_rank():
    cpu = torch.device("cpu")
    with RankPool(["cpu"] * 2, threads=1) as pool:
        # fn(payload, device): payload[device]; rank 1's lookup fails
        assert pool.run(operator.getitem, [{cpu: "a"}, {cpu: "b"}]) == [
            "a", "b"]
        assert pool.size == 2 and len(pool.startup_s) == 2
        assert [r[0] for r in pool.roll] == [0, 1]
        with pytest.raises(RankError, match=r"rank 1 \(cpu\) raised") as e:
            pool.run(operator.getitem, [{cpu: "a"}, {}])
        assert "KeyError" in str(e.value) and "Traceback" in str(e.value)
        # the pool survives a job that raised
        assert pool.run(operator.getitem, [None, {cpu: "c"}]) == [None, "c"]
        with pytest.raises(RankError, match="missed the"):
            pool.run(operator.getitem, [{cpu: 1}, {cpu: 2}], deadline_s=1e-9)
        # a missed deadline closes the pool; the next run starts it again
        assert pool.run(operator.getitem, [{cpu: 3}, {cpu: 4}]) == [3, 4]
        os.kill(pool._procs[0].pid, signal.SIGKILL)
        pool._procs[0].join(10)
        with pytest.raises(RankError, match="rank 0 .* exited with code"):
            pool.run(operator.getitem, [{cpu: 5}, {cpu: 6}])
    with pytest.raises(ValueError):
        RankPool([])
