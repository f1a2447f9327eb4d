"""Topology substrate: the reference topogen contract as dense stage matrices.

The reference (shadow/topogen.py) builds a complete networkx graph over
`anchor_stages` *network nodes* (not peers): stage s gets host bandwidth
`ceil(s*bw_jump + min_bw)` Mbit (bw_jump = int((max_bw-min_bw)/stages)), the
edge between stages i<j gets latency `min(ceil((stages-j)*lat_jump + min_lat),
max_lat)` ms, each stage's self-loop gets `max((stages-i)*lat_jump, min_lat)`
ms, and an extra "fast node" (stage index = stages) for the message injector
gets 100 Mbit and 1 ms edges (topogen.py:39-71). Peers pod-0..pod-(n-1) are
assigned round-robin to stages: peer p -> stage p % stages (topogen.py:121-122).

TPU-first consequence: per-edge link properties collapse to a tiny
(stages+1)x(stages+1) latency matrix plus per-stage bandwidth vectors, and a
length-N int8/int32 stage vector — peer-pair latency is `LAT[stage[p],
stage[q]]`, a 2-gather, no N x N materialization at any scale.

We both *emit* network_topology.gml + shadow.yaml (same schema, so existing
Shadow tooling can consume our configs) and *ingest* a GML produced by the
reference topogen (so `SIMBACKEND=tpu` can run an existing experiment dir).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, replace

import numpy as np

GML_FILE = "network_topology.gml"
YAML_FILE = "shadow.yaml"

# Fixed by the reference for every generated experiment (topogen.py:7-8).
SHADOW_ENV_FLAG = 1
CONNECTIONS = 10


@dataclass(frozen=True)
class TopoParams:
    """CLI surface of topogen.py:13-36 (flag names in comments)."""

    network_size: int = 100      # -n/--network-size
    min_bandwidth: int = 50      # -bl, Mbps
    max_bandwidth: int = 50      # -bh, Mbps
    min_latency: int = 100       # -ll, ms
    max_latency: int = 100       # -lh, ms
    anchor_stages: int = 1       # -st
    packet_loss: float = 0.0     # -l, rate 0-1
    msg_size_bytes: int = 1500   # -s
    num_frags: int = 1           # -f, choices 1..9
    messages: int = 10           # -m (a.k.a. num_publishers in shadow.yaml env)
    delay_seconds: float = 0.1   # -d, inter-message delay
    muxer: str = "yamux"         # -mx, choices mplex|yamux|quic

    def validate(self) -> None:
        if self.min_bandwidth > self.max_bandwidth:
            raise ValueError("min_bandwidth cannot exceed max_bandwidth")
        if self.min_latency > self.max_latency:
            raise ValueError("min_latency cannot exceed max_latency")
        if not (1 <= self.num_frags <= 9):
            raise ValueError("num_frags must be in 1..9")
        if self.muxer not in ("mplex", "yamux", "quic"):
            raise ValueError(f"invalid muxer {self.muxer}")
        if self.anchor_stages < 1:
            raise ValueError("anchor_stages must be >= 1")


def _stage_bandwidth_mbit(s: int, p: TopoParams) -> int:
    jump = int((p.max_bandwidth - p.min_bandwidth) / p.anchor_stages)
    return math.ceil(s * jump + p.min_bandwidth)


def _edge_latency_ms(i: int, j: int, p: TopoParams) -> int:
    """Latency of the (unordered) stage pair; i == j is the self-loop rule."""
    jump = int((p.max_latency - p.min_latency) / p.anchor_stages)
    lo, hi = min(i, j), max(i, j)
    if lo == hi:
        return max((p.anchor_stages - lo) * jump, p.min_latency)
    return min(math.ceil((p.anchor_stages - hi) * jump + p.min_latency), p.max_latency)


@dataclass
class Topology:
    """Dense-matrix form of a staged experiment topology.

    latency_ms:    (S+1, S+1) float32 — symmetric stage-pair latency; row/col S
                   is the injector's fast node (1 ms everywhere).
    bw_up_mbit:    (S+1,) float32 per-stage host uplink (== downlink).
    packet_loss:   (S+1, S+1) float32 per stage pair.
    stage_of_peer: (N,) int32 — peer p sits on network node p % S.
    """

    params: TopoParams
    latency_ms: np.ndarray
    bw_up_mbit: np.ndarray
    packet_loss: np.ndarray
    stage_of_peer: np.ndarray

    @property
    def n_peers(self) -> int:
        return int(self.stage_of_peer.shape[0])

    @property
    def n_stages(self) -> int:
        return int(self.bw_up_mbit.shape[0]) - 1

    @property
    def injector_stage(self) -> int:
        return self.n_stages

    def tx_ms_per_peer(self, payload_bytes: int) -> np.ndarray:
        """Serialization (transmit) time of one payload on each peer's uplink,
        in ms: bytes*8 / (Mbit/s * 1e6) * 1e3."""
        bw = self.bw_up_mbit[self.stage_of_peer]  # (N,)
        return (payload_bytes * 8.0) / (bw * 1e6) * 1e3

    def peer_latency_ms(self, p: int, q: int) -> float:
        return float(self.latency_ms[self.stage_of_peer[p], self.stage_of_peer[q]])

    # ------------------------------------------------------------------ build

    @classmethod
    def build(cls, params: TopoParams) -> "Topology":
        params.validate()
        s = params.anchor_stages
        lat = np.ones((s + 1, s + 1), dtype=np.float32)  # injector row/col = 1 ms
        loss = np.zeros((s + 1, s + 1), dtype=np.float32)
        bw = np.empty(s + 1, dtype=np.float32)
        for i in range(s):
            bw[i] = _stage_bandwidth_mbit(i, params)
            for j in range(i, s):
                lat[i, j] = lat[j, i] = _edge_latency_ms(i, j, params)
                loss[i, j] = loss[j, i] = params.packet_loss
        bw[s] = 100.0  # injector fast node: 100 Mbit, 1 ms (topogen.py:65-69)
        stage = (np.arange(params.network_size) % s).astype(np.int32)
        return cls(params, lat, bw, loss, stage)

    # ------------------------------------------------------------------- emit

    def write_gml(self, path: str = GML_FILE) -> None:
        """network_topology.gml byte for byte as the reference writes it
        (networkx.write_gml of topogen's complete stage graph with
        self-loops and the injector node), without networkx."""
        s = self.n_stages
        lines = ["graph ["]
        for i in range(s + 1):
            bw_str = (f"{int(self.bw_up_mbit[i])} Mbit" if i < s
                      else "100 Mbit")
            lines += ["  node [", f"    id {i}", f'    label "{i}"',
                      f'    host_bandwidth_up "{bw_str}"',
                      f'    host_bandwidth_down "{bw_str}"', "  ]"]
        # networkx's edge order: each node's neighbours in insertion order
        # (the complete graph, then its self-loop, then the injector),
        # skipping nodes already visited
        for i in range(s + 1):
            for j in [*range(i + 1, s), i, s] if i < s else [s]:
                if j < s:
                    lat = f"{int(self.latency_ms[i, j])} ms"
                    loss = float(self.packet_loss[i, j])
                else:
                    lat, loss = "1 ms", 0.0
                lines += ["  edge [", f"    source {i}", f"    target {j}",
                          f'    latency "{lat}"',
                          f"    packet_loss {_gml_float(loss)}", "  ]"]
        lines.append("]")
        with open(path, "w", encoding="ascii", newline="\n") as f:
            f.write("".join(ln + "\n" for ln in lines))

    def shadow_config(self) -> dict:
        """shadow.yaml dict in the reference schema (topogen.py:74-136)."""
        p = self.params
        node_env = {
            "PEERS": str(p.network_size),
            "SHADOWENV": str(SHADOW_ENV_FLAG),
            "CONNECTTO": str(CONNECTIONS),
            "PUBLISHERS": str(p.messages),
            "FRAGMENTS": str(p.num_frags),
            "MUXER": p.muxer,
        }
        hosts: dict = {}
        stage_host = {}
        for i in range(self.n_stages):
            stage_host[i] = {
                "network_node_id": i,
                "processes": [
                    {"path": "./main", "start_time": "5s", "environment": dict(node_env)}
                ],
            }
        for i in range(p.network_size):
            hosts[f"pod-{i}"] = stage_host[i % self.n_stages]
        controller_args = (
            f"../../../traffic_sync.py -s {p.msg_size_bytes} -m {p.messages} "
            f"-d {p.delay_seconds} -n {p.network_size} --peer-selection id"
        )
        hosts[f"pod-{p.network_size}"] = {
            "network_node_id": self.injector_stage,
            "processes": [
                {
                    "path": "/usr/bin/python",
                    "args": controller_args,
                    "start_time": "500s",
                    "environment": {"SHADOWENV": str(SHADOW_ENV_FLAG)},
                }
            ],
        }
        return {
            "general": {
                "bootstrap_end_time": "10s",
                "heartbeat_interval": "12s",
                "stop_time": "15m",
                "progress": True,
            },
            "experimental": {"use_memory_manager": False},
            "network": {"graph": {"type": "gml", "file": {"path": GML_FILE}}},
            "hosts": hosts,
        }

    def write_shadow_yaml(self, path: str = YAML_FILE) -> None:
        """shadow.yaml byte for byte as the reference writes it
        (yaml.dump(..., default_flow_style=False, sort_keys=False)),
        without PyYAML: hosts sharing a stage share one anchored mapping."""
        doc = self.shadow_config()
        lines: list[str] = []
        _yaml_block(doc, 0, _yaml_anchors(doc), set(), lines)
        with open(path, "w", encoding="ascii", newline="\n") as f:
            f.write("".join(ln + "\n" for ln in lines))

    # ----------------------------------------------------------------- ingest

    @classmethod
    def from_gml(cls, path: str, network_size: int, params: TopoParams | None = None) -> "Topology":
        """Load a topology emitted by the reference topogen (or by us)."""
        import networkx as nx

        g = nx.read_gml(path, label="id")
        n_nodes = g.number_of_nodes()
        s = n_nodes - 1  # last node is the injector fast node
        lat = np.ones((n_nodes, n_nodes), dtype=np.float32)
        loss = np.zeros((n_nodes, n_nodes), dtype=np.float32)
        bw = np.full(n_nodes, 100.0, dtype=np.float32)
        for i, data in g.nodes(data=True):
            b = data.get("host_bandwidth_up", "100 Mbit")
            bw[i] = float(str(b).split()[0])
        for i, j, data in g.edges(data=True):
            l_ms = float(str(data.get("latency", "1 ms")).split()[0])
            lat[i, j] = lat[j, i] = l_ms
            pl = float(data.get("packet_loss", 0.0))
            loss[i, j] = loss[j, i] = pl
        stage = (np.arange(network_size) % s).astype(np.int32)
        if params is None:
            params = TopoParams(network_size=network_size, anchor_stages=s)
        else:
            params = replace(params, network_size=network_size, anchor_stages=s)
        return cls(params, lat, bw, loss, stage)


# ------------------------------------------------------- artifact writers
#
# The two files are written without networkx or PyYAML, byte-identical to
# what those libraries write for the reference (networkx.write_gml;
# yaml.dump with default_flow_style=False, sort_keys=False).

def _gml_float(x: float) -> str:
    """A real literal as networkx writes it: repr, upper case, a decimal
    point before any exponent, +INF."""
    text = repr(float(x)).upper()
    if text == "INF":
        return "+INF"
    epos = text.rfind("E")
    if epos != -1 and text.find(".", 0, epos) == -1:
        text = text[:epos] + "." + text[epos:]
    return text


_YAML_WIDTH = 80
# PyYAML's implicit resolvers (YAML 1.1: bool, null, int, float, timestamp,
# merge, value): a string that reads back as another type is single-quoted
_YAML_IMPLICIT = re.compile(r"""^(?:
    yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
    |~|null|Null|NULL|
    |[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
    |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)
    |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*
    |<<|=)$""", re.X)
# strings PyYAML leaves plain: no indicator first, single spaces, no ': '
# or ' #'
_YAML_PLAIN = re.compile(r"^[A-Za-z0-9./_][A-Za-z0-9./_-]*"
                         r"(?: [A-Za-z0-9./_-]+)*$")


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, str) and _YAML_IMPLICIT.match(v):
        return f"'{v}'"
    if isinstance(v, str) and _YAML_PLAIN.match(v):
        return v
    raise ValueError(f"no plain YAML form for {v!r}")


def _yaml_anchors(doc) -> dict:
    """id() of each mapping the document holds more than once -> its
    anchor, numbered in the order of the second encounter, as PyYAML's
    serializer numbers them."""
    seen: set = set()
    anchors: dict = {}

    def walk(x):
        if not isinstance(x, (dict, list)):
            return
        if id(x) in seen:
            anchors.setdefault(id(x), f"id{len(anchors) + 1:03d}")
            return
        seen.add(id(x))
        for v in (x.values() if isinstance(x, dict) else x):
            walk(v)

    walk(doc)
    return anchors


def _yaml_block(mapping: dict, indent: int, anchors: dict, done: set,
                lines: list) -> None:
    """Append the block-style lines of `mapping` at `indent`: nested
    mappings indented by 2, lists of mappings as indentless sequences, a
    plain scalar folded at a space once its line passes 80 columns."""
    pad = " " * indent
    for k, v in mapping.items():
        head = f"{pad}{k}:"
        if isinstance(v, dict):
            anchor = anchors.get(id(v))
            if anchor and id(v) in done:
                lines.append(f"{head} *{anchor}")
                continue
            if anchor:
                done.add(id(v))
                head += f" &{anchor}"
            lines.append(head)
            _yaml_block(v, indent + 2, anchors, done, lines)
        elif isinstance(v, list):
            lines.append(head)
            for item in v:
                sub: list = []
                _yaml_block(item, indent + 2, anchors, done, sub)
                sub[0] = f"{pad}- {sub[0][indent + 2:]}"
                lines += sub
        else:
            words = _yaml_scalar(v).split(" ")
            line = f"{head} {words[0]}"
            for w in words[1:]:
                if len(line) > _YAML_WIDTH:
                    lines.append(line)
                    line = " " * (indent + 2) + w
                else:
                    line += " " + w
            lines.append(line)
