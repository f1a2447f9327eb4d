"""Bandwidth-utilization channel: Shadow heartbeat-counter parity.

The reference's third experiment output (besides latency lines and
Prometheus) is Shadow's own per-node traffic counters, aggregated by
shadow/summary_shadowlog.awk:12-66 into total/min/max/avg/stddev rx-tx
bytes and a local/remote x in/out packet + ctrl/data header-byte
breakdown (run.sh:70-74 runs it on every shadowlog).

The engine already accounts every byte on the device (ops/disseminate.py
accumulates bytes_tx/bytes_rx/dup_rx per peer; IHAVE/IWANT counts per
message). This module renders those counters in the exact line shape the
awk script parses — field $9 == "[node]", peer name in $5, and a $10
payload whose ",|;"-split layout matches summary_shadowlog.awk:3-8
(rx=arr[2], tx=arr[3], four 12-field flag blocks from arr[7]) — so the
reference's awk runs UNCHANGED on our output, and a Python summarizer that
reproduces the awk math for in-process use.

Packetization model: data bytes ride TCP segments of MSS=1448 (Shadow's
default 1500 MTU minus IP+TCP headers); every segment pays 66 B of
Ethernet+IP+TCP header. Control messages (IHAVE/IWANT) are small single
packets. All simulated traffic is inter-host, so the localhost blocks are
zero (the awk's Details section prints only the remote blocks,
summary_shadowlog.awk:133-140).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

MSS_BYTES = 1448
HDR_BYTES = 66          # Ethernet 14 + IPv4 20 + TCP 32 (w/ options)
CTRL_PKT_BYTES = 120    # one IHAVE/IWANT rpc frame

_FLAG_BLOCK = 12        # summary_shadowlog.awk:4
_FG_INDEX = 7           # summary_shadowlog.awk:3


@dataclass
class PeerTraffic:
    """Cumulative per-peer traffic, the engine-side source of truth."""

    rx_bytes: np.ndarray        # (N,) data bytes received
    tx_bytes: np.ndarray        # (N,) data bytes sent
    ctrl_rx: np.ndarray         # (N,) control packets received
    ctrl_tx: np.ndarray         # (N,) control packets sent

    @classmethod
    def from_state(cls, state):
        """Build from a SimState. Control packets are real per-peer counters:
        a peer's ctrl_tx is the IHAVEs + IWANTs it sent, ctrl_rx the ones
        addressed to it (SimState.ihave_tx/iwant_tx/ihave_rx/iwant_rx) — the
        shadowlog's per-node ctrl fields are per-node in the reference too
        (summary_shadowlog.awk:3-8)."""
        def host(leaf):
            return leaf.detach().cpu().numpy().astype(np.float64)

        rx = host(state.bytes_rx)
        tx = host(state.bytes_tx)
        ctrl_tx = (host(state.ihave_tx) + host(state.iwant_tx)
                   + host(state.idontwant_tx))
        ctrl_rx = (host(state.ihave_rx) + host(state.iwant_rx)
                   + host(state.idontwant_rx))
        return cls(rx_bytes=rx, tx_bytes=tx, ctrl_rx=ctrl_rx, ctrl_tx=ctrl_tx)


def _data_pkts(data_bytes: np.ndarray) -> np.ndarray:
    return np.ceil(data_bytes / MSS_BYTES)


def shadowlog_lines(traffic: PeerTraffic, sim_time: str = "00:15:00") -> list[str]:
    """One cumulative '[node]' heartbeat line per peer, field-compatible with
    summary_shadowlog.awk ($5 peer, $9 '[node]', $10 counters)."""
    out = []
    n = traffic.rx_bytes.shape[0]
    for i in range(n):
        rx = traffic.rx_bytes[i]
        tx = traffic.tx_bytes[i]
        crx, ctx = traffic.ctrl_rx[i], traffic.ctrl_tx[i]
        d_in_pkt = _data_pkts(rx)
        d_out_pkt = _data_pkts(tx)
        blocks = []
        blocks.append([0] * _FLAG_BLOCK)  # inbound-localhost
        blocks.append([0] * _FLAG_BLOCK)  # outbound-localhost
        for pkt, byt, ctrl in ((d_in_pkt, rx, crx), (d_out_pkt, tx, ctx)):
            b = [0] * _FLAG_BLOCK
            b[0] = int(pkt + ctrl)                      # pkt
            b[1] = int(byt + ctrl * CTRL_PKT_BYTES)     # bytes
            b[2] = int(ctrl)                            # ctrl_pkt
            b[3] = int(ctrl * HDR_BYTES)                # ctrl_hdr_bytes
            b[6] = int(pkt)                             # data_pkt
            b[7] = int(pkt * HDR_BYTES)                 # data_hdr_bytes
            b[8] = int(byt)                             # data_bytes
            blocks.append(b)
        flags = ",".join(str(v) for b in blocks for v in b)
        rx_tot = int(rx + crx * CTRL_PKT_BYTES)
        tx_tot = int(tx + ctx * CTRL_PKT_BYTES)
        # $10 split on ",|;": arr[1]=tag, arr[2]=rx, arr[3]=tx,
        # arr[4..6] pad, arr[7..54] the four flag blocks
        stats = f"heartbeat;{rx_tot},{tx_tot},0,0,0;{flags}"
        out.append(
            f"{sim_time} [shadow] {sim_time} [INFO] pod-{i} n/a shadow "
            f"heartbeat [node] {stats}"
        )
    return out


@dataclass
class BandwidthSummary:
    """The numbers summary_shadowlog.awk:70-140 prints."""

    network_size: int
    total_rx: float
    total_tx: float
    min_rx: float
    max_rx: float
    avg_rx: float
    std_rx: float
    min_tx: float
    max_tx: float
    avg_tx: float
    std_tx: float
    remote_in_pkt: int
    remote_in_bytes: int
    remote_in_ctrl_pkt: int
    remote_in_ctrl_hdr_bytes: int
    remote_in_data_pkt: int
    remote_in_data_hdr_bytes: int
    remote_in_data_bytes: int
    remote_out_pkt: int
    remote_out_bytes: int
    remote_out_ctrl_pkt: int
    remote_out_ctrl_hdr_bytes: int
    remote_out_data_pkt: int
    remote_out_data_hdr_bytes: int
    remote_out_data_bytes: int


def summarize_bandwidth(traffic: PeerTraffic) -> BandwidthSummary:
    """Reproduce the awk aggregation (population stddev, awk:128-129)."""
    rx = traffic.rx_bytes + traffic.ctrl_rx * CTRL_PKT_BYTES
    tx = traffic.tx_bytes + traffic.ctrl_tx * CTRL_PKT_BYTES
    rx_i = np.floor(rx)
    tx_i = np.floor(tx)
    n = rx.shape[0]
    d_in = _data_pkts(traffic.rx_bytes)
    d_out = _data_pkts(traffic.tx_bytes)
    return BandwidthSummary(
        network_size=n,
        total_rx=float(rx_i.sum()),
        total_tx=float(tx_i.sum()),
        min_rx=float(rx_i.min()),
        max_rx=float(rx_i.max()),
        avg_rx=float(rx_i.mean()),
        std_rx=float(rx_i.std()),
        min_tx=float(tx_i.min()),
        max_tx=float(tx_i.max()),
        avg_tx=float(tx_i.mean()),
        std_tx=float(tx_i.std()),
        remote_in_pkt=int((d_in + traffic.ctrl_rx).sum()),
        remote_in_bytes=int(rx_i.sum()),
        remote_in_ctrl_pkt=int(traffic.ctrl_rx.sum()),
        remote_in_ctrl_hdr_bytes=int(traffic.ctrl_rx.sum() * HDR_BYTES),
        remote_in_data_pkt=int(d_in.sum()),
        remote_in_data_hdr_bytes=int(d_in.sum() * HDR_BYTES),
        remote_in_data_bytes=int(np.floor(traffic.rx_bytes).sum()),
        remote_out_pkt=int((d_out + traffic.ctrl_tx).sum()),
        remote_out_bytes=int(tx_i.sum()),
        remote_out_ctrl_pkt=int(traffic.ctrl_tx.sum()),
        remote_out_ctrl_hdr_bytes=int(traffic.ctrl_tx.sum() * HDR_BYTES),
        remote_out_data_pkt=int(d_out.sum()),
        remote_out_data_hdr_bytes=int(d_out.sum() * HDR_BYTES),
        remote_out_data_bytes=int(np.floor(traffic.tx_bytes).sum()),
    )


def report(s: BandwidthSummary) -> str:
    """Textual report in the awk's print shape (summary_shadowlog.awk:127-140)."""
    f = io.StringIO()
    f.write(
        f"\nTotal Bytes Received :  {_num(s.total_rx)} "
        f"Total Bytes Transferred :  {_num(s.total_tx)}\n"
    )
    f.write(
        "Per Node Pkt Receives : min, max, avg, stddev =  "
        f"{_num(s.min_rx)} {_num(s.max_rx)} {_num(s.avg_rx)} {_num(s.std_rx)}\n"
    )
    f.write(
        "Per Node Pkt Transfers: min, max, avg, stddev =  "
        f"{_num(s.min_tx)} {_num(s.max_tx)} {_num(s.avg_tx)} {_num(s.std_tx)}\n"
    )
    f.write("Details...\n")
    f.write(
        f"Remote IN pkt:  {s.remote_in_pkt} Bytes :  {s.remote_in_bytes} "
        f"ctrlPkt:  {s.remote_in_ctrl_pkt} ctrlHdrBytes:  "
        f"{s.remote_in_ctrl_hdr_bytes} DataPkt:  {s.remote_in_data_pkt} "
        f"DataHdrBytes:  {s.remote_in_data_hdr_bytes} DataBytes "
        f"{s.remote_in_data_bytes}\n"
    )
    f.write(
        f"Remote OUT pkt:  {s.remote_out_pkt} Bytes :  {s.remote_out_bytes} "
        f"ctrlPkt:  {s.remote_out_ctrl_pkt} ctrlHdrBytes:  "
        f"{s.remote_out_ctrl_hdr_bytes} DataPkt:  {s.remote_out_data_pkt} "
        f"DataHdrBytes:  {s.remote_out_data_hdr_bytes} DataBytes "
        f"{s.remote_out_data_bytes}\n"
    )
    return f.getvalue()


def _num(x: float) -> str:
    """awk's default OFMT: integers print bare, floats with %.6g."""
    if float(x) == int(x):
        return str(int(x))
    return f"{x:.6g}"
