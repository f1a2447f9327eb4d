"""The port's defense Pareto sweep (runtime/campaign.run_defense_sweep and
the `pareto` command) against the reference, on the CPU:

  - pareto_front on random objective matrices with ties, and its errors;
  - `pareto --json` with its default grid (two degree bands, one weight,
    the adaptive eclipse attacker) at a small depth: the artifact equal
    outside wall_s,
    bit for bit in every float, the report's lines equal but for the
    wall, and the port's wall line last;
  - the sweep's refusals: a static attacker, no recovery window, no
    attacked fraction, a trial mesh."""

import json

import numpy as np
import pytest
import torch

from dst_libp2p_test_node_tpu import cli as jcli
from dst_libp2p_test_node_tpu.runtime import campaign as jc
from dst_libp2p_test_node_tpu_torch import cli as tcli
from dst_libp2p_test_node_tpu_torch.ops import adversary as tadv
from dst_libp2p_test_node_tpu_torch.ops.repair import RepairParams
from dst_libp2p_test_node_tpu_torch.runtime import campaign as tc

torch.set_num_threads(1)

# the default grid (two degree bands, one weight) at a small depth: one
# message, one seed, short windows
ARGS = ["-n", "48", "--seeds", "0", "--messages", "1", "--warmup-s", "4",
        "--attack-heartbeats", "4", "--recovery-heartbeats", "4"]


def test_pareto_front_matches_reference():
    rng = np.random.default_rng(0)
    dirs = ("max", "min", "min")
    for p in (1, 2, 7, 40):
        vals = rng.integers(0, 4, (p, 3)).astype(np.float64)  # many ties
        assert np.array_equal(tc.pareto_front(vals, dirs),
                              jc.pareto_front(vals, dirs))
        front = tc.pareto_front(vals, dirs)
        assert front.any()
    for bad_vals, bad_dirs in ((np.zeros((3, 2)), dirs),
                               (np.zeros((3, 3)), ("max", "up", "min"))):
        with pytest.raises(ValueError) as te:
            tc.pareto_front(bad_vals, bad_dirs)
        with pytest.raises(ValueError) as je:
            jc.pareto_front(bad_vals, bad_dirs)
        assert str(te.value) == str(je.value)


def test_pareto_cli_json_matches_reference(tmp_path, capsys):
    outs = {}
    for name, mod, extra in (("j", jcli, []),
                             ("t", tcli, ["--device", "cpu"])):
        js = tmp_path / f"{name}.json"
        assert mod.cmd_pareto(ARGS + ["--json", str(js)] + extra) == 0
        outs[name] = (capsys.readouterr().out.splitlines(),
                      json.loads(js.read_text()))
    (rep_j, d_j), (rep_t, d_t) = outs["j"], outs["t"]
    assert d_t.pop("wall_s") >= 0.0 and d_j.pop("wall_s") >= 0.0
    assert d_t == d_j
    assert len(d_t["configs"]) == 2 and d_t["pareto"]
    assert rep_t[:-2] == rep_j[:-1]
    assert rep_t[-2].split(" wall :")[0] == rep_j[-1].split(" wall :")[0]
    assert rep_t[-1].startswith("[torch backend device=cpu] wall=")


def test_sweep_refusals():
    base = tc.CampaignConfig(
        scenario="eclipse_publisher", fractions=(0.2,), recovery_heartbeats=4,
        repair=RepairParams(evict=True, px=True, redial=True))
    with pytest.raises(ValueError, match="ADAPTIVE"):
        tc.run_defense_sweep(base, device="cpu")
    armed = tadv.AdversaryParams(scenario="eclipse_publisher",
                                 adaptive=tadv.AdaptivePolicy(enabled=True))
    for over, msg in ((dict(recovery_heartbeats=0), "recovery_heartbeats"),
                      (dict(fractions=(0.0,)), "attacked fraction")):
        cfg = tc.CampaignConfig(**{**base.__dict__, "adversary": armed,
                                   **over})
        with pytest.raises(ValueError, match=msg):
            tc.run_defense_sweep(cfg, device="cpu")
    cfg = tc.CampaignConfig(**{**base.__dict__, "adversary": armed})
    with pytest.raises(TypeError, match="make_trial_mesh"):
        tc.run_defense_sweep(cfg, trial_mesh=object(), device="cpu")
