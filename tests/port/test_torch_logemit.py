"""The port's native log emitter (native/logemit.cpp through
runtime/native_logemit.py) against its plain version, logemit.grep_lines,
byte for byte: message ids near 2^63 and at 2^64 - 1, delay 0, large
delays, many lines per peer, an empty block; the LatenciesWriter's text
(line numbers per peer across messages) against the reference's; a failed
build raises with the compiler's output."""

import io

import numpy as np
import pytest

from dst_libp2p_test_node_tpu.runtime.logemit import (
    LatenciesWriter as JWriter)
from dst_libp2p_test_node_tpu_torch.runtime import native_logemit as nl
from dst_libp2p_test_node_tpu_torch.runtime.logemit import (
    LatenciesWriter, grep_lines)


def _plain(msg_id, peers, linenos, delays):
    return "".join(ln + "\n" for ln in grep_lines(peers, msg_id, delays,
                                                  linenos))


@pytest.mark.parametrize("msg_id", [0, 7, 2**63 - 1, 2**63, 2**63 + 12345,
                                    2**64 - 1])
def test_format_block_matches_grep_lines(msg_id):
    rng = np.random.default_rng(msg_id % 1000)
    n = 5000
    peers = np.sort(rng.choice(10**6, n, replace=False)).astype(np.int64)
    linenos = rng.integers(1, 50, n).astype(np.int64)
    delays = rng.integers(0, 2**40, n).astype(np.int64)
    delays[:3] = [0, 1, 2**62]
    got = nl.format_block(msg_id, peers, linenos, delays)
    assert got == _plain(msg_id, peers, linenos, delays)
    assert got.count("\n") == n


def test_many_lines_per_peer_and_an_empty_block():
    peers = np.repeat(np.arange(3, dtype=np.int64), 400)
    linenos = np.tile(np.arange(1, 401, dtype=np.int64), 3)
    delays = np.arange(1200, dtype=np.int64) * 997
    assert nl.format_block(42, peers, linenos, delays) == _plain(
        42, peers, linenos, delays)
    empty = np.zeros(0, dtype=np.int64)
    assert nl.format_block(42, empty, empty, empty) == "" == _plain(
        42, empty, empty, empty)


def test_writer_text_matches_the_reference():
    rng = np.random.default_rng(3)
    want, got = JWriter(), LatenciesWriter()
    for k in range(6):
        peers = rng.choice(300, rng.integers(0, 300), replace=False)
        if k == 4:                   # a peer listed twice in one message
            peers = np.concatenate([peers, peers[:5]])
        delays = rng.uniform(0, 5000, peers.size)
        msg_id = int(rng.integers(0, 2**63))
        for w in (want, got):
            w.add_message(msg_id, peers, delays)
    a, b = io.StringIO(), io.StringIO()
    assert want.write_to(a) == got.write_to(b)
    assert b.getvalue() == a.getvalue()
    assert ":6:" in b.getvalue()


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "logemit.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nl, "_SRC", str(bad))
    monkeypatch.setattr(nl, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(nl, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ exit"):
        nl.load()

