"""Observability layer (reference L5): the Prometheus metric families.

The port of the reference's runtime/metrics.py. A minimal hand-written
text-exposition registry (/metrics is a host-side view over device
counters, so no client library is needed). Three families, names kept
verbatim so existing dashboards work:

  - `dst_testnode_*`: the Nim flagship node's 9 custom series with
    muxer/peer_id labels and the 12-bucket delay histogram
    (nim-test-node/gossipsub-queues/main.nim:25-78);
  - `libp2p_*`: the Go tracer / Rust registry family, whose names are
    identical across languages (rust-test-node/src/metrics.rs:12;
    go-test-node/metrics.go:38-287);
  - `dst_service_*`: the resident service's admission, dispatch and
    restart series (runtime/node_service.py).

The text rendered for the same series operations is the reference's byte
for byte. `NodeMetrics.fill_from_sim` projects the simulator's device-side
counters onto these series; it reads only the viewed node's rows of the
state, with one device-to-host copy, never the whole (N, C) state.
`CampaignMetrics` projects a campaign's result dict (runtime/campaign.py)
onto the `dst_testnode_attack_*` series.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

# nim histogram buckets (main.nim:55-60)
DELAY_BUCKETS_MS = (
    1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)


# the per-peer counters fill_from_sim reads, each (N,) int32 or float32
_COUNTER_LEAVES = (
    "bytes_tx", "bytes_rx", "dup_rx", "grafts", "grafts_rx", "prunes",
    "prunes_rx", "ihave_tx", "iwant_tx", "ihave_rx", "iwant_rx",
    "idontwant_tx", "idontwant_rx",
)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _rows_to_host(st, rows: list[int]):
    """The mesh rows (R, C) bool and each counter leaf's rows (R,) of one
    node, in one device-to-host copy: every piece is reinterpreted as
    int32 words (float32 bit patterns included), concatenated, copied,
    and viewed back in its own dtype. Nothing else of the state moves."""
    idx = torch.as_tensor(rows, dtype=torch.long, device=st.mesh_mask.device)
    mesh = st.mesh_mask[idx]
    leaves = [getattr(st, k)[idx] for k in _COUNTER_LEAVES]
    words = torch.cat([mesh.to(torch.int32).reshape(-1)]
                      + [x.view(torch.int32) for x in leaves])
    host = words.cpu().numpy()
    r, c = mesh.shape
    mesh_np = host[: r * c].reshape(r, c).astype(bool)
    out = {}
    for i, (k, x) in enumerate(zip(_COUNTER_LEAVES, leaves)):
        seg = host[r * c + i * r: r * c + (i + 1) * r]
        out[k] = seg.view(np.float32) if x.dtype == torch.float32 else seg
    return mesh_np, out


def _fmt_value(v: float) -> str:
    # non-finite first: int(inf) raises, and the exposition format spells
    # these three tokens exactly (prometheus text format 0.0.4)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return f"{int(f)}.0"
    return repr(f)


def _escape_label_value(v: str) -> str:
    # exposition escapes inside quoted label values: backslash first (the
    # other two introduce backslashes), then quote and newline
    return (str(v).replace("\\", "\\\\")
            .replace('"', '\\"').replace("\n", "\\n"))


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


@dataclass
class _Series:
    name: str
    help: str
    kind: str  # counter | gauge | histogram
    label_names: tuple[str, ...] = ()
    values: dict[tuple[str, ...], float] = field(default_factory=dict)
    # histogram state keyed by label values
    hist_counts: dict[tuple[str, ...], list[int]] = field(default_factory=dict)
    hist_sum: dict[tuple[str, ...], float] = field(default_factory=dict)
    buckets: tuple[float, ...] = DELAY_BUCKETS_MS
    # shared with the owning Registry: HTTP handler threads mutate series
    # while the pump thread renders (node_service.py), so every read-modify-
    # write and render() serializes on one lock
    lock: threading.Lock = field(default_factory=threading.Lock)

    def _key(self, labels: dict[str, str] | None) -> tuple[str, ...]:
        labels = labels or {}
        return tuple(str(labels.get(k, "")) for k in self.label_names)

    def inc(self, amount: float = 1.0, labels: dict[str, str] | None = None):
        k = self._key(labels)
        with self.lock:
            self.values[k] = self.values.get(k, 0.0) + amount

    def set(self, value: float, labels: dict[str, str] | None = None):
        k = self._key(labels)
        with self.lock:
            self.values[k] = float(value)

    def observe(self, value: float, labels: dict[str, str] | None = None):
        assert self.kind == "histogram"
        k = self._key(labels)
        with self.lock:
            counts = self.hist_counts.setdefault(k, [0] * (len(self.buckets) + 1))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            counts[-1] += 1  # +Inf
            self.hist_sum[k] = self.hist_sum.get(k, 0.0) + value

    def get(self, labels: dict[str, str] | None = None) -> float:
        with self.lock:
            return self.values.get(self._key(labels), 0.0)

    def render(self) -> list[str]:
        with self.lock:
            return self._render_locked()

    def _render_locked(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        if self.kind == "histogram":
            keys = self.hist_counts.keys() or ([()] if not self.label_names else [])
            for k in keys:
                base = dict(zip(self.label_names, k))
                counts = self.hist_counts.get(k, [0] * (len(self.buckets) + 1))
                for i, b in enumerate(self.buckets):
                    out.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels({**base, 'le': _fmt_value(b)})}"
                        f" {counts[i]}"
                    )
                out.append(
                    f'{self.name}_bucket{_fmt_labels({**base, "le": "+Inf"})} '
                    f"{counts[-1]}"
                )
                out.append(
                    f"{self.name}_sum{_fmt_labels(base)} "
                    f"{_fmt_value(self.hist_sum.get(k, 0.0))}"
                )
                out.append(f"{self.name}_count{_fmt_labels(base)} {counts[-1]}")
            return out
        if not self.values and not self.label_names:
            out.append(f"{self.name} 0.0")
            return out
        for k, v in sorted(self.values.items()):
            out.append(
                f"{self.name}{_fmt_labels(dict(zip(self.label_names, k)))} "
                f"{_fmt_value(v)}"
            )
        return out


class Registry:
    def __init__(self) -> None:
        self._series: dict[str, _Series] = {}
        self._lock = threading.Lock()          # guards registration
        self._data_lock = threading.Lock()     # shared by all series' data

    def counter(self, name: str, help: str, labels: tuple[str, ...] = ()) -> _Series:
        return self._add(name, help, "counter", labels)

    def gauge(self, name: str, help: str, labels: tuple[str, ...] = ()) -> _Series:
        return self._add(name, help, "gauge", labels)

    def histogram(
        self, name: str, help: str, labels: tuple[str, ...] = (),
        buckets: tuple[float, ...] = DELAY_BUCKETS_MS,
    ) -> _Series:
        s = self._add(name, help, "histogram", labels)
        s.buckets = buckets
        return s

    def _add(self, name, help, kind, labels) -> _Series:
        with self._lock:
            if name in self._series:
                return self._series[name]
            s = _Series(
                name=name, help=help, kind=kind, label_names=tuple(labels),
                lock=self._data_lock,
            )
            self._series[name] = s
            return s

    def render(self) -> str:
        with self._lock:
            series = list(self._series.values())
        lines: list[str] = []
        for s in series:
            lines.extend(s.render())
        return "\n".join(lines) + "\n"

    def __getitem__(self, name: str) -> _Series:
        return self._series[name]

    def __contains__(self, name: str) -> bool:
        return name in self._series


class NodeMetrics:
    """The full per-node metric surface of the reference nodes."""

    def __init__(self, muxer: str = "yamux", peer_id: str = "0", topic: str = "test"):
        self.registry = Registry()
        self.labels = {"muxer": muxer, "peer_id": peer_id}
        self.topic = topic
        r = self.registry
        lab = ("muxer", "peer_id")

        # --- dst_testnode_* family (main.nim:25-78) -------------------------
        self.publish_requests = r.counter(
            "dst_testnode_publish_requests_total",
            "number of /publish requests accepted by the test node", lab)
        self.publish_failures = r.counter(
            "dst_testnode_publish_failures_total",
            "number of failed local publish attempts", lab)
        self.received_chunks = r.counter(
            "dst_testnode_received_chunks_total",
            "number of application-level message chunks received", lab)
        self.completed_messages = r.counter(
            "dst_testnode_completed_messages_total",
            "number of application-level messages fully received", lab)
        # a counter deliberately named *_sum for rate() use (main.nim:49-52;
        # SURVEY.md §7 quirks: keep the name/semantics)
        self.delay_sum = r.counter(
            "dst_testnode_message_delay_ms_sum",
            "sum of message delays in milliseconds (use with rate)", lab)
        self.delay_hist = r.histogram(
            "dst_testnode_message_delay_ms",
            "message delay histogram for percentile analysis", lab)
        self.last_delay = r.gauge(
            "dst_testnode_last_message_delay_ms",
            "last observed message delay in milliseconds (real-time)", lab)
        self.mesh_size = r.gauge(
            "dst_testnode_mesh_size",
            "current GossipSub mesh size for the test topic", lab)
        self.topic_peers = r.gauge(
            "dst_testnode_topic_peers",
            "current number of GossipSub peers for the test topic", lab)

        # --- libp2p_* family (metrics.go:38-287, metrics.rs:13-200) ---------
        self.network_bytes = r.counter(
            "libp2p_network_bytes_total", "Total bytes sent and received",
            ("direction",))
        self.open_streams = r.gauge("libp2p_open_streams", "Number of open streams")
        self.peers = r.gauge("libp2p_peers", "Number of connected peers")
        self.pubsub_peers = r.gauge("libp2p_pubsub_peers", "Number of pubsub peers")
        self.pubsub_topics = r.gauge(
            "libp2p_pubsub_topics", "Number of subscribed topics")
        self.messages_published = r.counter(
            "libp2p_pubsub_messages_published_total",
            "Number of messages published", ("topic",))
        self.broadcast_messages = r.counter(
            "libp2p_pubsub_broadcast_messages_total",
            "Number of messages broadcast", ("topic",))
        self.received_messages = r.counter(
            "libp2p_pubsub_received_messages_total",
            "Number of messages received", ("topic",))
        for ctrl in ("subscriptions", "unsubscriptions",
                     "ihave", "iwant", "graft", "prune", "idontwant"):
            setattr(self, f"broadcast_{ctrl}", r.counter(
                f"libp2p_pubsub_broadcast_{ctrl}_total",
                f"Number of {ctrl} messages broadcast"))
            setattr(self, f"received_{ctrl}", r.counter(
                f"libp2p_pubsub_received_{ctrl}_total",
                f"Number of {ctrl} messages received"))
        self.duplicates = r.counter(
            "libp2p_gossipsub_duplicate_total",
            "Number of duplicate messages received")
        self.gossipsub_received = r.counter(
            "libp2p_gossipsub_received_total", "Number of gossipsub messages received")
        self.mesh_per_topic = r.gauge(
            "libp2p_gossipsub_peers_per_topic_mesh",
            "Number of mesh peers per topic", ("topic",))
        self.gossipsub_per_topic = r.gauge(
            "libp2p_gossipsub_peers_per_topic_gossipsub",
            "Number of gossipsub peers per topic", ("topic",))
        self.no_peers_topics = r.gauge(
            "libp2p_gossipsub_no_peers_topics", "Number of topics with no peers")
        self.low_peers_topics = r.gauge(
            "libp2p_gossipsub_low_peers_topics",
            "Number of topics with fewer than d_low peers")
        self.healthy_peers_topics = r.gauge(
            "libp2p_gossipsub_healthy_peers_topics",
            "Number of topics with healthy peer counts")
        self.validation_success = r.counter(
            "libp2p_pubsub_validation_success_total",
            "Number of successful message validations")
        self.validation_failure = r.counter(
            "libp2p_pubsub_validation_failure_total",
            "Number of failed message validations")
        self.reject_reason = r.counter(
            "libp2p_pubsub_reject_reason_total",
            "Number of rejected messages by reason", ("reason",))
        self.rpc_drop = r.counter(
            "libp2p_pubsub_rpc_drop_total", "Number of dropped RPCs")

        # --- dst_service_* family (resident service runtime, ARCH §16) ------
        # admission / backpressure / supervision / restart counters of the
        # long-running NodeService; per-tenant series are the tenant-facing
        # stream of the multi-tenant dispatcher
        self.service_queue_depth = r.gauge(
            "dst_service_queue_depth",
            "current depth of the bounded admission queue")
        self.service_admitted = r.counter(
            "dst_service_admitted_total",
            "requests admitted past admission control", ("tenant",))
        self.service_dropped = r.counter(
            "dst_service_dropped_requests_total",
            "requests dropped by reason: backpressure (429), "
            "deadline (shed expired), draining (503)", ("reason",))
        self.service_batches = r.counter(
            "dst_service_batches_total",
            "non-empty dispatch batches pumped")
        self.service_latency = r.histogram(
            "dst_service_request_latency_ms",
            "admission-to-dispatch sojourn of served requests (host wall)",
            ("tenant",))
        self.service_failures = r.counter(
            "dst_service_dispatch_failures_total",
            "supervised dispatch attempts that raised")
        self.service_retries = r.counter(
            "dst_service_dispatch_retries_total",
            "dispatch retries after a failed attempt")
        self.service_quarantined = r.counter(
            "dst_service_quarantined_total",
            "poison requests dropped after exhausting the retry budget")
        self.service_degraded = r.gauge(
            "dst_service_degraded",
            "1 once any dispatch needed a retry or was quarantined")
        self.service_draining = r.gauge(
            "dst_service_draining",
            "1 while the service refuses new admissions for shutdown")
        self.service_checkpoints = r.counter(
            "dst_service_checkpoint_flushes_total",
            "service checkpoints flushed (periodic + final)")
        self.service_restarts = r.gauge(
            "dst_service_restarts_total",
            "warm restarts this service lineage has survived")
        self.service_est_dispatch = r.gauge(
            "dst_service_est_dispatch_ms",
            "EWMA of one dispatch's wall ms (admission budget estimator)")
        # batched device dispatch: one publish_batch serves a whole
        # same-shape group of the pump round's fair batch (the help texts
        # are the reference's, verbatim: the exposition is compared bytewise)
        self.service_dispatches = r.counter(
            "dst_service_device_dispatches_total",
            "compiled device dispatches executed (a batched dispatch "
            "serves many requests; sequential mode serves one each)")
        self.service_splits = r.counter(
            "dst_service_batch_splits_total",
            "failed batch dispatches bisected to isolate a poison request "
            "(the PR-6 per-seed split fallback at batch granularity)")
        self.service_batch_factor = r.gauge(
            "dst_service_batch_factor",
            "requests served per device dispatch, last non-empty pump round")

    # ------------------------------------------------------------ observers

    def on_publish_request(self, ok: bool = True) -> None:
        self.publish_requests.inc(labels=self.labels)
        if ok:
            self.messages_published.inc(labels={"topic": self.topic})
            self.broadcast_messages.inc(labels={"topic": self.topic})
        else:
            self.publish_failures.inc(labels=self.labels)

    def on_delivery(self, delay_ms: float, chunks: int = 1) -> None:
        """One full message delivered at this node (createMessageHandler,
        main.nim:126-154)."""
        self.received_chunks.inc(chunks, labels=self.labels)
        self.completed_messages.inc(labels=self.labels)
        self.delay_sum.inc(delay_ms, labels=self.labels)
        self.delay_hist.observe(delay_ms, labels=self.labels)
        self.last_delay.set(delay_ms, labels=self.labels)
        self.received_messages.inc(labels={"topic": self.topic})
        self.gossipsub_received.inc()
        self.validation_success.inc()

    def update_topic_health(self, mesh_count: int, d_low: int) -> None:
        """Topic-health classifier (metrics.go:348-380, metrics.rs:158-176)."""
        no = 1 if mesh_count == 0 else 0
        low = 1 if 0 < mesh_count < d_low else 0
        self.no_peers_topics.set(no)
        self.low_peers_topics.set(low)
        self.healthy_peers_topics.set(1 - no - low)

    def fill_from_sim(self, sim, peer_id: int) -> None:
        """Project the device-side counters into this node's series: the
        whole-network process exposes the view of simulated peer `peer_id`.

        Multi-topic sims (runtime/multitopic.py) stack topics as virtual
        peers: this node's rows are peer_id + t*n_peers, one per topic.
        Per-peer series aggregate over them (a real host's counters sum its
        topics too), and per-topic gauges get their real topic labels."""
        multitopic = hasattr(sim, "topic_index")
        if multitopic:
            rows = [peer_id + t * sim.n_peers
                    for t in range(len(sim.cfg.topics))]
        else:
            rows = [peer_id]
        mesh_np, leaf = _rows_to_host(sim.state, rows)
        r_idx = range(len(rows))
        mesh_deg = int(sum(mesh_np[i].sum() for i in r_idx))
        conns = int(np.asarray((sim.graph.conns[peer_id] >= 0).sum()))
        self.mesh_size.set(mesh_deg, labels=self.labels)
        self.topic_peers.set(conns, labels=self.labels)
        self.peers.set(conns)
        self.pubsub_peers.set(conns)
        self.pubsub_topics.set(len(rows))
        self.open_streams.set(2 * conns)  # one stream per direction, per conn
        if multitopic:  # one labeled series per topic
            for name, sz in sim.mesh_sizes().items():
                self.mesh_per_topic.set(sz, labels={"topic": name})
                self.gossipsub_per_topic.set(conns, labels={"topic": name})
            # health judged from this node's worst joined topic mesh: the
            # Go tracer classifies only topics the node subscribed to
            # (metrics.go:348-380). A node joined to nothing has no topics
            # to classify: all three health gauges stay 0.
            sub_rows = [i for i in r_idx if sim.subscribed_np[i][peer_id]]
            if sub_rows:
                worst = min(int(mesh_np[i].sum()) for i in sub_rows)
                self.update_topic_health(worst, sim.params.d_low)
            else:
                self.no_peers_topics.set(0)
                self.low_peers_topics.set(0)
                self.healthy_peers_topics.set(0)
        else:
            self.mesh_per_topic.set(mesh_deg, labels={"topic": self.topic})
            self.gossipsub_per_topic.set(conns, labels={"topic": self.topic})
            self.update_topic_health(mesh_deg, sim.params.d_low)

        def total(name):
            # the rows' values summed in numpy's dtype, in row order, as
            # the reference sums them
            col = leaf[name]
            return float(sum(col[i] for i in r_idx))

        self.network_bytes.set(total("bytes_tx"), labels={"direction": "out"})
        self.network_bytes.set(total("bytes_rx"), labels={"direction": "in"})
        self.broadcast_graft.set(total("grafts"))
        self.received_graft.set(total("grafts_rx"))
        self.broadcast_prune.set(total("prunes"))
        self.received_prune.set(total("prunes_rx"))
        self.broadcast_ihave.set(total("ihave_tx"))
        self.broadcast_iwant.set(total("iwant_tx"))
        self.received_ihave.set(total("ihave_rx"))
        self.received_iwant.set(total("iwant_rx"))
        self.broadcast_idontwant.set(total("idontwant_tx"))
        self.received_idontwant.set(total("idontwant_rx"))
        # SUBSCRIBE/UNSUBSCRIBE control messages fire once per (peer, topic)
        # state change and are broadcast to every connected peer (the Go
        # tracer counts them cumulatively, metrics.go RecvRPC). The
        # Simulator accumulates the events host-side in set_subscribed; the
        # multi-topic membership is fixed at boot, so its event count is
        # the subscription matrix.
        if multitopic:
            sub_ev = np.asarray(sim.subscribed_np, dtype=np.int64)
            unsub_ev = np.zeros_like(sub_ev)
        else:
            sub_ev = np.asarray(sim._sub_events_np)[None, :]
            unsub_ev = np.asarray(sim._unsub_events_np)[None, :]
        nbrs = sim.graph.conns[peer_id]
        nbrs = nbrs[nbrs >= 0]
        self.broadcast_subscriptions.set(
            float(int(sub_ev[:, peer_id].sum()) * len(nbrs)))
        self.received_subscriptions.set(float(sub_ev[:, nbrs].sum()))
        self.broadcast_unsubscriptions.set(
            float(int(unsub_ev[:, peer_id].sum()) * len(nbrs)))
        self.received_unsubscriptions.set(float(unsub_ev[:, nbrs].sum()))
        self.duplicates.set(total("dup_rx"))

    def fill_from_telemetry(self, tel: dict) -> None:
        """Export the latest flight-recorder window (the Simulator's
        `last_telemetry`, ROADMAP A9) as the dst_sim_round_* family: one
        gauge per tel_* channel, labeled per recorded heartbeat (`hb`);
        vector channels get an extra `idx` label. Re-filling with a new
        window overwrites same-hb samples; a longer window extends the
        series."""
        for key in sorted(tel):
            if not key.startswith("tel_"):
                continue
            arr = _to_numpy(tel[key])
            name = "dst_sim_round_" + key[len("tel_"):]
            help_ = (f"flight-recorder channel {key} from the latest "
                     "recorded heartbeat window")
            if arr.ndim == 1:
                g = self.registry.gauge(name, help_, ("hb",))
                for i, v in enumerate(arr):
                    g.set(float(v), labels={"hb": str(i)})
            elif arr.ndim == 2:
                g = self.registry.gauge(name, help_, ("hb", "idx"))
                for i in range(arr.shape[0]):
                    for j in range(arr.shape[1]):
                        g.set(float(arr[i, j]),
                              labels={"hb": str(i), "idx": str(j)})

    def render(self) -> str:
        return self.registry.render()


class CampaignMetrics:
    """Prometheus series for adversarial campaigns (runtime/campaign.py).

    One labeled sample per (scenario, fraction, seed) trial cell, named in
    the dst_testnode_* family so the existing scrape/dashboard plumbing
    picks the attack sweeps up unchanged. Gauges carry the resilience
    metrics; non-finite values (no honest delivery -> inf latency) are
    SKIPPED rather than exported — Prometheus text exposition has no null
    and an +Inf gauge poisons every aggregation over the series."""

    _LABELS = ("scenario", "fraction", "seed")

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or Registry()
        r = self.registry
        lab = self._LABELS
        self.trials = r.counter(
            "dst_testnode_attack_trials_total",
            "number of completed adversarial campaign trials", ("scenario",))
        self.coverage = r.gauge(
            "dst_testnode_attack_honest_coverage",
            "honest-peer delivery coverage under attack", lab)
        self.inflation = r.gauge(
            "dst_testnode_attack_latency_inflation",
            "honest p50 delay over the same-seed benign baseline", lab)
        self.hb_to_graylist = r.gauge(
            "dst_testnode_attack_heartbeats_to_graylist",
            "heartbeats until the graylist defense engaged (-1 = never)", lab)
        self.mesh_recovery = r.gauge(
            "dst_testnode_attack_mesh_recovery_heartbeats",
            "heartbeats until attacker mesh share fell back under the "
            "recovery floor (-1 = not inside the window)", lab)
        self.attacker_score = r.gauge(
            "dst_testnode_attack_attacker_score",
            "mean honest-side score of attacker edges after the schedule",
            lab)
        self.mesh_share = r.gauge(
            "dst_testnode_attack_attacker_mesh_share",
            "attacker share of honest mesh edges after the attack window",
            lab)
        # mesh-repair subsystem (ops/repair.py; populated when the campaign
        # ran a recovery window — all-zero/-1 otherwise)
        self.evictions = r.gauge(
            "dst_testnode_attack_mesh_evictions_total",
            "score-eviction PRUNEs issued across the trial", lab)
        self.px_grafts = r.gauge(
            "dst_testnode_attack_px_grafts_total",
            "mesh edges gained through PX candidates across the trial", lab)
        self.redials = r.gauge(
            "dst_testnode_attack_redials_total",
            "new connections dialed by the repair controller", lab)
        self.recovery_time = r.gauge(
            "dst_testnode_attack_recovery_time_ms",
            "sim ms from attack-window end until the publisher regained an "
            "honest mesh edge and attacker mesh share fell under the floor "
            "(-1 = not recovered)", lab)
        # fault-injection subsystem (ops/faults.py; populated when the
        # campaign scheduled a fault window — all -1 otherwise, and -1
        # sentinels are skipped like non-finite values below)
        self.heal_time = r.gauge(
            "dst_testnode_attack_heal_time_ms",
            "sim ms from partition-window end until no cross-cut mesh edge "
            "remained severed (-1 = never healed inside the schedule)", lab)
        self.reconvergence = r.gauge(
            "dst_testnode_attack_post_churn_reconvergence_hb",
            "heartbeats after the crash window until restarted peers "
            "regained mean mesh degree >= D_low (-1 = not reconverged)", lab)
        self.coverage_partition = r.gauge(
            "dst_testnode_attack_coverage_under_partition",
            "fraction of honest peers on the publisher's side of the cut "
            "(the reachable ceiling while partitioned)", lab)
        # cross-protocol DHT adversary (ops/dht_adversary.py; populated
        # when the campaign armed a DHT attack — -1 sentinel otherwise)
        self.rtable_poison = r.gauge(
            "dst_testnode_attack_rtable_poison_frac",
            "attacker share of occupied honest routing-table slots after "
            "the poisoning waves (-1 = DHT adversary not armed)", lab)
        self.degraded = r.gauge(
            "dst_testnode_attack_campaign_degraded",
            "1 if the supervisor retried or quarantined any trial cell",
            ("scenario",))
        self.retries = r.counter(
            "dst_testnode_attack_trial_retries_total",
            "supervisor retries consumed across the campaign", ("scenario",))
        self.quarantined = r.counter(
            "dst_testnode_attack_trials_quarantined_total",
            "trial cells abandoned after exhausting the retry budget",
            ("scenario",))

    def fill_from_campaign(self, campaign: dict) -> None:
        """Project a CampaignResult.to_dict onto the series (duck-typed on
        the dict, like summarize.report_campaign)."""

        for t in campaign["trials"]:
            self.trials.inc(labels={"scenario": t["scenario"]})
            labels = {"scenario": t["scenario"],
                      "fraction": f"{t['fraction']:g}",
                      "seed": str(t["seed"])}
            for series, key in (
                (self.coverage, "honest_coverage"),
                (self.inflation, "latency_inflation"),
                (self.hb_to_graylist, "hb_to_graylist"),
                (self.mesh_recovery, "mesh_recovery_hb"),
                (self.attacker_score, "attacker_score_final"),
                (self.mesh_share, "attacker_mesh_share_final"),
                (self.evictions, "mesh_evictions_total"),
                (self.px_grafts, "px_grafts_total"),
                (self.redials, "redials_total"),
                (self.recovery_time, "recovery_time_ms"),
            ):
                v = t.get(key)
                if v is not None and math.isfinite(float(v)):
                    series.set(float(v), labels=labels)
            # fault gauges: -1 means "fault family not scheduled / never
            # happened" — a sentinel, not a measurement, so don't export it
            for series, key in (
                (self.heal_time, "heal_time_ms"),
                (self.reconvergence, "post_churn_reconvergence_hb"),
                (self.coverage_partition, "coverage_under_partition"),
                (self.rtable_poison, "rtable_poison_frac"),
            ):
                v = t.get(key)
                if v is not None and math.isfinite(float(v)) and float(v) >= 0:
                    series.set(float(v), labels=labels)
        scen = {"scenario": campaign["scenario"]}
        self.degraded.set(1.0 if campaign.get("degraded") else 0.0,
                          labels=scen)
        retries = int(campaign.get("retries_total", 0) or 0)
        if retries:
            self.retries.inc(retries, labels=scen)
        quarantined = len(campaign.get("quarantined_trials") or ())
        if quarantined:
            self.quarantined.inc(quarantined, labels=scen)

    def render(self) -> str:
        return self.registry.render()
