"""Latency-line emission: the reference's primary experiment output, verbatim.

The contract (SURVEY.md §5, BASELINE.md):
  - every receiver prints `<msgId> milliseconds: <delayMs>` to its stdout
    (gossipsub-queues/main.nim:150, go-test-node/main.go:49,
    rust-test-node/src/main.rs:93);
  - shadow/run.sh:61 greps those lines out of shadow.data/ with
    `grep -rne 'milliseconds\\|BW'`, producing `latencies<i>` files whose lines
    look like `<path>:<lineno>:<msgId> milliseconds: <ms>`;
  - summary_latency{,_large}.awk split the first token on the regex
    `peer|/main|:.*:` and expect arr[2] = peer ordinal, arr[4] = msgId —
    which requires the per-host stdout path to contain `peer<id>/main`.

Note the reference is internally out of sync here: its topogen names hosts
`pod-<i>`, under which the awk split yields garbage — the awk scripts were
written for `peer<i>` naming (SURVEY.md §7 quirks). We emit `peer<id>` so the
*reference awk scripts run unchanged* on our latencies files; our own parser
(runtime/summarize.py) accepts both spellings.

`LatenciesWriter` formats each message's block with the native emitter
(runtime/native_logemit.py, native/logemit.cpp); `grep_lines` is its plain
Python version.
"""

from __future__ import annotations

import io
import os

import numpy as np

_STDOUT_TEMPLATE = "shadow.data/hosts/peer{pid}/main.1000.stdout"


def stdout_line(msg_id: int, delay_ms: int) -> str:
    """The node's own stdout line (main.nim:150: `echo msgId, " milliseconds: ", delay`)."""
    return f"{msg_id} milliseconds: {delay_ms}"


def grep_lines(
    peer_ids: np.ndarray,
    msg_id: int,
    delays_ms: np.ndarray,
    linenos: np.ndarray | None = None,
) -> list[str]:
    """latencies-file lines for one message: grep-style `path:lineno:content`."""
    d = delays_ms.astype(np.int64)
    if linenos is None:
        linenos = np.ones(len(peer_ids), dtype=np.int64)
    return [
        f"{_STDOUT_TEMPLATE.format(pid=int(p))}:{int(ln)}:{msg_id} milliseconds: {int(dd)}"
        for p, ln, dd in zip(peer_ids, linenos, d)
    ]


class LatenciesWriter:
    """Accumulates per-message receive records and writes a `latencies<run>`
    file consumable by the reference awk summaries.

    Line numbers within each peer's virtual stdout increase per message, as
    grep -n would report them."""

    def __init__(self) -> None:
        self._chunks: list[tuple[int, np.ndarray, np.ndarray]] = []
        # lines written so far to each peer's stdout, indexed by peer id
        self._lines = np.zeros(0, dtype=np.int64)

    def add_message(
        self, msg_id: int, peer_ids: np.ndarray, delays_ms: np.ndarray
    ) -> None:
        peer_ids = np.asarray(peer_ids, dtype=np.int64)
        if peer_ids.size and peer_ids.min() < 0:
            raise ValueError("peer ids must be non-negative")
        order = np.argsort(peer_ids)
        peer_ids = peer_ids[order]
        delays = np.asarray(delays_ms)[order].astype(np.int64)
        if peer_ids.size and peer_ids[-1] >= self._lines.size:
            self._lines = np.concatenate([self._lines, np.zeros(
                int(peer_ids[-1]) + 1 - self._lines.size, dtype=np.int64)])
        # a peer listed k times gets k consecutive line numbers
        rank = (np.arange(peer_ids.size)
                - np.searchsorted(peer_ids, peer_ids, side="left"))
        linenos = self._lines[peer_ids] + 1 + rank
        np.add.at(self._lines, peer_ids, 1)
        self._chunks.append((int(msg_id), peer_ids, np.stack([linenos, delays])))

    def blocks(self):
        """(msg_id, peer ids, delays ms) of each message, in file order."""
        return [(msg_id, peers, ld[1]) for msg_id, peers, ld in self._chunks]

    def write(self, path: str) -> int:
        """Returns the number of lines written."""
        total = 0
        with open(path, "w") as f:
            total = self.write_to(f)
        return total

    def write_to(self, f: io.TextIOBase) -> int:
        from .native_logemit import format_block

        total = 0
        for msg_id, peers, ld in self._chunks:
            f.write(format_block(msg_id, peers, ld[0], ld[1]))
            total += len(peers)
        return total


def write_per_host_stdout(
    root: str,
    records,
    network_size: int,
) -> None:
    """Optionally materialize real per-host stdout files (small N only) so
    even `grep -rne` itself can be run exactly as shadow/run.sh does."""
    lines: dict[int, list[str]] = {}
    for rec in records:
        for p, d in zip(rec.receivers, rec.delays_ms_int):
            lines.setdefault(int(p), []).append(stdout_line(rec.msg_id, int(d)))
    for pid in range(network_size):
        d = os.path.join(root, "shadow.data", "hosts", f"peer{pid}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "main.1000.stdout"), "w") as f:
            f.write("\n".join(lines.get(pid, [])) + ("\n" if lines.get(pid) else ""))
