"""The port's role commands (`kad`, `connmanager`, `regression`,
`servicedisco`, dst_libp2p_test_node_tpu_torch/cli.py) against the
reference CLI's: the same flags and env give the same summary text and
the same --log / --trace / --latencies files, byte for byte; only the
last line, the wall line, is the port's own."""

import pytest
import torch

from dst_libp2p_test_node_tpu import cli as jcli
from dst_libp2p_test_node_tpu_torch import cli as tcli

torch.set_num_threads(1)

CASES = {
    "kad": (["-n", "48", "--bootstraps", "2", "--probes", "4",
             "--duration-s", "10", "--discovery", "extended", "--seed", "2",
             "--log", "kad.log"], {}, ["kad.log"]),
    "connmanager": (["--duration-s", "40", "--trace", "trace.csv"],
                    {"NUM_HUBS": "2", "MAX_CONNECTIONS": "15",
                     "WATERMARK_GRACE_PERIOD_S": "3"}, ["trace.csv"]),
    "regression": (["-n", "40", "--messages", "2", "--msg-size", "800",
                    "--log", "reg.log", "--latencies", "latencies1"],
                   {"STARTSLEEP": "20", "CONNECTTO": "6"},
                   ["reg.log", "latencies1"]),
    "servicedisco": (["-n", "40", "--duration-s", "30", "--services",
                      "svc-a,svc-b", "--log", "sd.log"],
                     {"SD_ADVERTISERS": "6", "SD_DISCOVERERS": "6",
                      "SD_IP_SIM_COEFF": "0.5"}, ["sd.log"]),
}


def _run(main, argv, where, monkeypatch, capsys):
    where.mkdir()
    monkeypatch.chdir(where)
    assert main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    files = {}
    for p in where.iterdir():
        files[p.name] = p.read_bytes()
    return out, files


@pytest.mark.parametrize("cmd", list(CASES))
def test_role_command_matches_reference_cli(cmd, tmp_path, monkeypatch,
                                            capsys):
    argv, env, outputs = CASES[cmd]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want, want_files = _run(jcli.main, [cmd] + argv, tmp_path / "jax",
                            monkeypatch, capsys)
    got, got_files = _run(tcli.main, [cmd] + argv + ["--device", "cpu"],
                          tmp_path / "torch", monkeypatch, capsys)
    assert want[:-1] == got[:-1]
    assert want[-1].startswith("[tpu backend] wall=")
    assert got[-1].startswith("[torch backend device=cpu] wall=")
    assert sorted(got_files) == sorted(want_files) == sorted(outputs)
    for name in outputs:
        assert got_files[name] == want_files[name], name
    # the count the wall line carries is the reference's
    assert want[-1].split()[3:] == got[-1].split()[4:]


def test_role_commands_need_a_card_or_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tcli.main(["connmanager", "--duration-s", "5"])
    assert "no CUDA device" in capsys.readouterr().err
