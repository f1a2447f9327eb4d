"""The port's `attack` command against the reference CLI, on the CPU: the
report text (wall clocks aside), --json (strict JSON, equal outside the
wall fields) and --metrics-out (byte for byte) of the eclipse / recovery
campaign of the verify recipe; the reference's flag checks with their
messages; the adaptive, fault and DHT flags, once refused as later
slices, now running to the reference's JSON (or its error), with
--trial-groups among them; and --mesh (the port's campaign on two CPU
ranks of the peer mesh) giving the JSON of the reference's run without
it: the reference's own --mesh path needs GSPMD's peer-sharded programs,
which fail on the pinned jax."""

import json

import pytest
import torch

from dst_libp2p_test_node_tpu import cli as jcli
from dst_libp2p_test_node_tpu_torch import cli as tcli

torch.set_num_threads(1)

ARGS = ["--scenario", "eclipse_publisher", "-n", "64", "--connect-to", "4",
        "--fractions", "0,0.2", "--seeds", "0,1", "--attack-heartbeats", "6",
        "--warmup-s", "5", "--recovery-heartbeats", "6", "--evict", "--px",
        "--redial", "--messages", "2"]


def _strip_walls(d: dict) -> dict:
    d = dict(d)
    d.pop("wall_s")
    d.pop("trials_per_s")
    d["trials"] = [{k: v for k, v in t.items() if k != "wall_s"}
                   for t in d["trials"]]
    return d


def test_attack_json_metrics_and_report(tmp_path, capsys):
    outs = {}
    for name, mod, extra in (("j", jcli, []), ("t", tcli, ["--device",
                                                          "cpu"])):
        js, prom = tmp_path / f"{name}.json", tmp_path / f"{name}.prom"
        assert mod.cmd_attack(ARGS + extra + ["--json", str(js),
                                              "--metrics-out",
                                              str(prom)]) == 0
        outs[name] = (capsys.readouterr().out.splitlines(),
                      json.loads(js.read_text()), prom.read_text())
    (rep_j, d_j, p_j), (rep_t, d_t, p_t) = outs["j"], outs["t"]
    # the report's walls line and the CLI's last line carry wall clocks
    assert ([ln for ln in rep_t[:-1] if not ln.startswith("Trials :")]
            == [ln for ln in rep_j[:-1] if not ln.startswith("Trials :")])
    assert sum(ln.startswith("Trials :  4 ") for ln in rep_t) == 1
    assert rep_t[-1].startswith("[torch backend device=cpu] wall=")
    assert _strip_walls(d_t) == _strip_walls(d_j)
    assert p_t == p_j
    assert "dst_testnode_attack_redials_total" in p_t
    assert any(t["redials_total"] > 0 for t in d_t["trials"])
    # strict JSON: the infinite budget fields are nulled, never NaN/inf
    json.loads(json.dumps(d_t, allow_nan=False))


@pytest.mark.parametrize("flags", [
    ["--mimic-margin", "0.5"], ["--rotation-period-hb", "5"],
    ["--dht-heal-hb", "3"],
    ["--scenario", "ihave_spam", "--adaptive"],
    ["--throttle-margin", "0.5"]])
def test_flag_checks_match_reference(flags, capsys):
    errs = []
    for mod in (jcli, tcli):
        with pytest.raises(SystemExit) as e:
            mod.cmd_attack(["-n", "16"] + flags)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1]


# a tiny grid: the flags' parity, not the campaign's, is under test
TINY = ["-n", "16", "--connect-to", "4", "--fractions", "0.25", "--seeds",
        "0", "--messages", "1", "--attack-heartbeats", "4", "--warmup-s",
        "2"]


@pytest.mark.parametrize("flags,slice_name", [
    (["--adaptive"], "next campaign"),
    (["--px-poison-per-hb", "2", "--adaptive"], "next campaign"),
    (["--crash-frac", "0.1", "--crash-window", "1:3"], "faults"),
    (["--partition-frac", "0.5"], "faults"),
    (["--spike-ms", "5"], "faults"),
    (["--dht-poison"], "DHT adversary"),
    (["--dht-eclipse", "--dht-heal-hb", "2"], "DHT adversary"),
    (["--mesh"], "peer mesh"),
    (["--trial-groups", "2"], "trial grid")])
def test_later_slice_flags_refused(flags, slice_name, tmp_path, capsys):
    # the adaptive, fault and DHT flags, the trial grid and the peer mesh
    # are ported: the port's `attack --json` and --metrics-out equal the
    # reference's for the same flags, or both refuse the config with the
    # same error (a DHT attack needs a recovery window with re-dial); one
    # seed never leaves the caller, on either grid. --mesh runs the port's
    # campaign on two CPU ranks, held against the reference's run without
    # it
    outs = []
    for name, mod, extra in (("j", jcli, []), ("t", tcli, ["--device",
                                                          "cpu"])):
        js, prom = tmp_path / f"{name}.json", tmp_path / f"{name}.prom"
        mine = [] if (name, slice_name) == ("j", "peer mesh") else flags
        try:
            assert mod.cmd_attack(TINY + mine + extra
                                  + ["--json", str(js), "--metrics-out",
                                     str(prom)]) == 0
            outs.append((_strip_walls(json.loads(js.read_text())),
                         prom.read_text()))
        except ValueError as e:
            outs.append(f"ValueError: {e}")
    if slice_name == "peer mesh":
        assert "peer mesh: 2 ranks" in capsys.readouterr().err
    capsys.readouterr()
    assert outs[0] == outs[1]
    assert isinstance(outs[1], str) == (slice_name == "DHT adversary")
