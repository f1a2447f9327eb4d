"""Resident node service: the reference's per-node control and metrics
surface over one simulated network.

The port of the reference's runtime/node_service.py. The reference exposes,
per node process:
  - HTTP POST /publish on :8645 accepting {"topic","msgSize","version"}
    (gossipsub-queues/main.nim:192-240; go-test-node/main.go:84-151;
    rust-test-node/src/main.rs:146-221);
  - GET /health and /ready returning "ok" (kad-dht/helpers.nim:94-117,
    service-discovery/helpers.nim:138-161);
  - Prometheus GET /metrics on :8008 (env.nim:39-55);
  - in-Shadow metric persistence: append the node's own /metrics scrape to
    metrics_pod-<id>.txt every 5 min, start staggered by myId*60 ms
    (env.nim:58-73, env.go:118-146, env.rs:114-152).

Here one process hosts the whole simulated network on one device, so the
service wraps a Simulator (or MultiTopicSimulator). /publish lands
mid-simulation and is buffered into a queue the simulation loop drains at
round granularity, as the reference's injector itself quantizes at
inter_message_delay granularity (shadow/topogen.py:129). HTTP handler
threads never touch a tensor: they enqueue requests, read a host mirror of
the sim clock that pump() refreshes, and read a metrics snapshot the pump
loop renders under a lock.

On top of that shim:
  - admission control: the publish queue is bounded (a depth cap plus an
    estimated device-time budget fed by an EWMA of measured dispatch
    walls). Overflow is HTTP 429 with a Retry-After header and a
    strict-JSON body, never unbounded growth;
  - deadlines: each request carries an absolute sim-time deadline (wall
    deadlines would make replay nondeterministic); expired work is shed at
    pop time, before it reaches the device;
  - fair batching: pump() pops a bounded batch round-robin across tenants
    (FIFO within a tenant) and dispatches it, one `publish_batch` per
    same-shape group (or one publish per request in sequential mode).
    Per-tenant admission and latency series stream on the dst_service_*
    family;
  - supervision: a device dispatch runs under a watchdog timeout with
    bounded exponential-backoff retries; a request that exhausts its
    budget is quarantined (counted, reported degraded) instead of
    crashing the service. Request-level errors (bad params, degraded mix)
    are not retried;
  - warm restart: periodic checkpoints embed a service sidecar (pending
    queue, fairness cursor, counters) next to the simulator snapshot
    (runtime/checkpoint.py), so a kill and NodeService.restore resume
    bit-identically for replayed requests;
  - graceful shutdown: serve_forever installs SIGTERM/SIGINT handlers that
    stop admitting (503 while draining), drain queued work under a
    deadline, flush a final checkpoint, and return.

The Rust node routes /publish through an mpsc channel into its single swarm
event loop (main.rs:466-516): the same design, channel = PublishQueue.
"""

from __future__ import annotations

import json
import math
import signal
import threading
import time
from collections import deque
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..config.env import HTTP_CONTROL_PORT, PROMETHEUS_PORT, NodeConfig
from .metrics import NodeMetrics, _to_numpy
from .simulator import MixDegradedError
from .summarize import sanitize_nonfinite
from .supervise import _call_with_timeout, _FailureInjector

_INF = float("inf")
DEFAULT_TENANT = "default"


@dataclass
class PublishRequest:
    topic: str
    msg_size: int
    version: int = 1
    tenant: str = DEFAULT_TENANT
    # absolute SIM-TIME deadline (ms); +inf = none. Sim time, not wall
    # time, so shed decisions replay deterministically after a restart.
    deadline_ms: float = _INF
    t_enq_ms: float = 0.0     # sim time at admission
    t_enq_wall: float = 0.0   # host wall at admission (latency observation)


def _req_to_json(r: PublishRequest) -> dict:
    return {
        "topic": r.topic, "msg_size": int(r.msg_size),
        "version": int(r.version), "tenant": r.tenant,
        # strict JSON: +inf deadline is encoded as null
        "deadline_ms": (None if math.isinf(r.deadline_ms)
                        else float(r.deadline_ms)),
        "t_enq_ms": float(r.t_enq_ms),
    }


def _req_from_json(d: dict) -> PublishRequest:
    return PublishRequest(
        topic=d["topic"], msg_size=int(d["msg_size"]),
        version=int(d.get("version", 1)),
        tenant=d.get("tenant", DEFAULT_TENANT),
        deadline_ms=(_INF if d.get("deadline_ms") is None
                     else float(d["deadline_ms"])),
        t_enq_ms=float(d.get("t_enq_ms", 0.0)),
    )


class PublishQueue:
    """Bounded admission-controlled publish buffer between HTTP handlers and
    the sim loop (replaces the unbounded queue.Queue buffer, whose put/drain
    pair also raced: a put landing mid-drain could be returned by BOTH the
    in-flight drain and the next one under get_nowait retries).

    Every operation holds one lock, so drain/take_batch are atomic snapshots.
    Structure: one FIFO deque per tenant + a stable tenant ring for
    round-robin fairness. `offer` rejects (returns False) once the depth cap
    or the estimated device-time budget is exceeded — the caller turns that
    into HTTP 429 + Retry-After."""

    def __init__(self, max_depth: int = 1024,
                 device_ms_budget: float = 0.0) -> None:
        self.max_depth = int(max_depth)
        self.device_ms_budget = float(device_ms_budget)
        self._lock = threading.Lock()
        self._tenants: dict[str, deque[PublishRequest]] = {}
        self._ring: list[str] = []   # tenant names in first-seen order
        self._cursor = 0             # next ring position round-robin serves
        self.dropped = 0             # admission rejections (backpressure)

    def offer(self, req: PublishRequest, est_ms: float = 0.0) -> bool:
        """Admit or reject atomically. est_ms: the dispatcher's EWMA of one
        request's device wall — depth * est_ms above device_ms_budget (> 0)
        rejects even below the depth cap."""
        with self._lock:
            depth = sum(len(q) for q in self._tenants.values())
            over_depth = depth >= self.max_depth
            over_budget = (
                self.device_ms_budget > 0.0 and est_ms > 0.0
                and (depth + 1) * est_ms > self.device_ms_budget)
            if over_depth or over_budget:
                self.dropped += 1
                return False
            q = self._tenants.get(req.tenant)
            if q is None:
                q = self._tenants[req.tenant] = deque()
                self._ring.append(req.tenant)
            q.append(req)
            return True

    def put(self, req: PublishRequest) -> bool:
        """Legacy surface of the unbounded queue; now an admission check."""
        return self.offer(req)

    def depth(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._tenants.values())

    def take_batch(
        self, max_batch: int | None, now_ms: float,
    ) -> tuple[list[PublishRequest], list[PublishRequest]]:
        """Atomically pop up to max_batch requests, round-robin one per
        tenant per lap (FIFO within a tenant), shedding any popped request
        whose sim-time deadline has passed. Returns (batch, shed); the
        fairness cursor persists across calls (and across restarts — it is
        checkpointed)."""
        batch: list[PublishRequest] = []
        shed: list[PublishRequest] = []
        with self._lock:
            if not self._ring:
                return batch, shed
            n_t = len(self._ring)
            idle_laps = 0
            while (max_batch is None or len(batch) < max_batch) \
                    and idle_laps < n_t:
                name = self._ring[self._cursor % n_t]
                self._cursor = (self._cursor + 1) % n_t
                q = self._tenants.get(name)
                if not q:
                    idle_laps += 1
                    continue
                idle_laps = 0
                req = q.popleft()
                if req.deadline_ms < now_ms:
                    shed.append(req)
                else:
                    batch.append(req)
            return batch, shed

    def drain(self) -> list[PublishRequest]:
        """Atomic take-everything (fair order, no shedding)."""
        batch, _ = self.take_batch(None, -_INF)
        return batch

    # --------------------------------------------------- checkpoint surface

    def snapshot(self) -> dict:
        """JSON-safe pending-queue state for the service checkpoint sidecar:
        re-admitted verbatim on restore, so a kill between flush and dispatch
        loses nothing that was already accepted."""
        with self._lock:
            return {
                "ring": list(self._ring),
                "cursor": self._cursor,
                "dropped": self.dropped,
                "pending": {t: [_req_to_json(r) for r in q]
                            for t, q in self._tenants.items()},
            }

    def restore(self, snap: dict | None) -> None:
        if not snap:
            return
        with self._lock:
            self._ring = list(snap.get("ring", []))
            self._cursor = int(snap.get("cursor", 0))
            self.dropped = int(snap.get("dropped", 0))
            self._tenants = {
                t: deque(_req_from_json(d) for d in reqs)
                for t, reqs in snap.get("pending", {}).items()}
            # wall clocks don't survive the process (t_enq_wall is not
            # serialized); re-stamp admission wall time so the restored
            # requests' sojourn measures time-in-system since restore
            # instead of the raw monotonic epoch
            now_wall = time.monotonic()
            for q in self._tenants.values():
                for r in q:
                    r.t_enq_wall = now_wall
            for t in self._tenants:
                if t not in self._ring:
                    self._ring.append(t)


@dataclass
class ServiceConfig:
    """Resident-runtime knobs (admission, batching, supervision, restart).
    The defaults keep the thin-shim behavior of the pre-resident service:
    a large bound, no deadlines, no checkpointing — existing callers see
    the same contract, just with the unbounded-growth bug closed."""

    max_queue_depth: int = 1024
    device_ms_budget: float = 0.0     # est. queued device ms cap; 0 = off
    default_deadline_ms: float = 0.0  # relative sim ms per request; 0 = none
    max_batch: int = 64               # requests per pump round
    # "batched": each same-shape group of the fair batch goes to the
    # simulator's publish_batch as one dispatch; "sequential": one
    # dispatch per request, the bit-equality reference. Both modes produce
    # bit-identical record streams (tests/port/test_torch_service.py).
    dispatch_mode: str = "batched"
    dispatch_timeout_s: float = 0.0   # watchdog per attempt; 0 = off
    max_retries: int = 1
    retry_backoff_s: float = 0.05     # doubles per retry (campaign pattern)
    inject_failures: int = 0          # first K dispatch attempts raise (CI)
    checkpoint_path: str | None = None
    checkpoint_every: int = 0         # pump rounds between flushes; 0 = off
    drain_deadline_s: float = 5.0     # graceful-shutdown drain budget
    retry_after_s: float = 1.0        # advertised 429/503 Retry-After

    def validate(self) -> None:
        if self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.dispatch_mode not in ("batched", "sequential"):
            raise ValueError(
                f"dispatch_mode must be 'batched' or 'sequential', "
                f"got {self.dispatch_mode!r}")
        for k in ("device_ms_budget", "default_deadline_ms",
                  "dispatch_timeout_s", "retry_backoff_s",
                  "drain_deadline_s", "retry_after_s"):
            if getattr(self, k) < 0.0:
                raise ValueError(f"{k} must be >= 0")
        if self.max_retries < 0 or self.inject_failures < 0:
            raise ValueError("max_retries/inject_failures must be >= 0")
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")


def _json_response(handler, code: int, payload: dict,
                   headers: dict | None = None) -> None:
    body = json.dumps(payload, allow_nan=False).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for k, v in (headers or {}).items():
        handler.send_header(k, v)
    handler.end_headers()
    handler.wfile.write(body)


def _text_response(handler, code: int, text: str, ctype="text/plain") -> None:
    body = text.encode()
    handler.send_response(code)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class NodeService:
    """Host-side control plane over the device-side simulation."""

    def __init__(
        self,
        simulator,
        cfg: NodeConfig | None = None,
        control_port: int = HTTP_CONTROL_PORT,
        metrics_port: int = PROMETHEUS_PORT,
        service: ServiceConfig | None = None,
    ) -> None:
        self.sim = simulator
        self.cfg = cfg or NodeConfig()
        self.topic = self.cfg.topic
        self.svc_cfg = service or ServiceConfig()
        self.svc_cfg.validate()
        # multi-topic backing sim (runtime/multitopic.py): /publish routes by
        # the request's topic name; single-topic sims accept only cfg.topic.
        # ONE flag drives every multi-topic branch (pump dispatch, topic
        # whitelist, metric labels/aggregation).
        self._multitopic = hasattr(simulator, "topic_index")
        self._topics = (tuple(simulator.cfg.topics) if self._multitopic
                        else (self.topic,))
        self.publishes = PublishQueue(
            max_depth=self.svc_cfg.max_queue_depth,
            device_ms_budget=self.svc_cfg.device_ms_budget)
        # counters carry one topic label; with several topics the honest
        # label is the joined list (per-topic mesh gauges are emitted with
        # their real names separately)
        self.metrics = NodeMetrics(
            muxer=self.cfg.muxer, peer_id=str(self.cfg.my_id),
            topic=",".join(self._topics))
        self._metrics_text = self.metrics.render()
        self._lock = threading.Lock()
        self._control_port = control_port
        self._metrics_port = metrics_port
        self._servers: list[ThreadingHTTPServer] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self.lines_out: list[str] = []  # latency lines emitted by pump()
        # ------- resident-runtime state -------
        self.counters: dict[str, int] = {
            "admitted": 0, "rejected": 0, "shed_deadline": 0,
            "dispatched": 0, "dispatch_failures": 0, "retries": 0,
            "quarantined": 0, "checkpoint_flushes": 0, "restarts": 0,
            "batch_splits": 0, "device_dispatches": 0,
        }
        self.degraded = False
        self.draining = False
        self.last_error: str | None = None
        self.pump_rounds = 0
        self.max_depth_seen = 0
        self._ewma_ms = 0.0  # EWMA of one request's DEVICE wall (ms)
        # per-pump-round accumulators feeding the EWMA: device-call wall
        # only (no retry-backoff sleeps — those over-shed healthy tenants),
        # amortized over the requests the round processed
        self._round_device_ms = 0.0
        self._round_reqs = 0
        self._round_dispatches = 0
        self._injector = _FailureInjector(self.svc_cfg.inject_failures)
        # (tenant, sojourn_ms) of recent dispatches — the load generator's
        # latency source; bounded so a long-lived service cannot grow it
        self.latencies: deque[tuple[str, float]] = deque(maxlen=4096)
        # host copies the HTTP threads read: the sim clock (refreshed by
        # pump after each advance; a publish does not move it) and the
        # flight-recorder curves of the latest telemetry window
        self._now_ms = 0.0
        self._sync_clock()
        self._tel_curves: dict = {}
        self.flush_walls: list[float] = []  # host wall s of each flush
        self.device_ms_total = 0.0   # summed dispatch walls (publish time)

    # ------------------------------------------------------------- servers

    @property
    def control_port(self) -> int:
        return self._control_port

    @property
    def metrics_port(self) -> int:
        return self._metrics_port

    def start(self) -> None:
        svc = self

        class ControlHandler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/health", "/ready"):
                    _text_response(self, 200, "ok")
                elif self.path == "/service":
                    _json_response(self, 200, svc.service_status())
                elif self.path == "/telemetry":
                    _json_response(self, 200, svc.telemetry_status())
                else:
                    _text_response(self, 404, "Not Found")

            def do_POST(self):
                if self.path != "/publish":
                    _text_response(self, 404, "Not Found")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n))
                    req = PublishRequest(
                        topic=body["topic"],
                        msg_size=int(body["msgSize"]),
                        version=int(body.get("version", 1)),
                        tenant=str(body.get("tenant", DEFAULT_TENANT)),
                        deadline_ms=(
                            float(body["deadlineMs"]) if "deadlineMs" in body
                            else _INF),
                    )
                except Exception as e:  # malformed request -> 400 (main.nim:227-230)
                    _json_response(
                        self, 400, {"status": "error", "message": str(e)})
                    return
                if req.topic not in svc._topics:
                    # "Topic not joined" (main.go:107-110)
                    _text_response(self, 500, "Topic not joined")
                    return
                code, payload, headers = svc.submit(req)
                _json_response(self, code, payload, headers)

            def do_PUT(self):
                _text_response(self, 405, "Method Not Supported")

        class MetricsHandler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    _text_response(
                        self, 200, svc.metrics_text(),
                        ctype="text/plain; version=0.0.4")
                else:
                    _text_response(self, 404, "Not Found")

        for port_attr, handler in (
            ("_control_port", ControlHandler), ("_metrics_port", MetricsHandler)
        ):
            server = ThreadingHTTPServer(("0.0.0.0", getattr(self, port_attr)), handler)
            setattr(self, port_attr, server.server_address[1])  # resolve port 0
            t = threading.Thread(target=server.serve_forever, daemon=True)
            t.start()
            self._servers.append(server)
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for s in self._servers:
            s.shutdown()
            s.server_close()
        self._servers.clear()

    # --------------------------------------------------------------- admission

    def _sync_clock(self) -> None:
        """Refresh the host mirror of the sim clock (pump thread only)."""
        self._now_ms = float(self.sim.state.t_ms) + self.sim._hb_carry_ms

    def _sim_now(self) -> float:
        return self._now_ms

    def submit(
        self, req: PublishRequest,
    ) -> tuple[int, dict, dict]:
        """Admission control for one request: (http_code, strict-JSON body,
        extra headers). 200 = queued for the next pump round; 429 = shed by
        backpressure (depth or device-time budget) with Retry-After; 503 =
        the service is draining for shutdown and admits nothing."""
        retry_hdr = {"Retry-After":
                     str(int(math.ceil(self.svc_cfg.retry_after_s)))}
        if self.draining:
            self.counters["rejected"] += 1
            self.metrics.service_dropped.inc(labels={"reason": "draining"})
            return 503, {"status": "draining",
                         "retry_after_s": self.svc_cfg.retry_after_s}, retry_hdr
        now = self._sim_now()
        req.t_enq_ms = now
        req.t_enq_wall = time.monotonic()
        if math.isinf(req.deadline_ms):
            if self.svc_cfg.default_deadline_ms > 0.0:
                req.deadline_ms = now + self.svc_cfg.default_deadline_ms
        else:
            # deadlines arrive RELATIVE sim-ms (a client can't know the
            # sim clock); stored absolute so shedding replays exactly
            req.deadline_ms = now + req.deadline_ms
        if not self.publishes.offer(req, est_ms=self._ewma_ms):
            self.counters["rejected"] += 1
            self.metrics.service_dropped.inc(
                labels={"reason": "backpressure"})
            return 429, {
                "status": "rejected", "reason": "backpressure",
                "queue_depth": self.publishes.depth(),
                "retry_after_s": self.svc_cfg.retry_after_s,
            }, retry_hdr
        self.counters["admitted"] += 1
        self.metrics.service_admitted.inc(labels={"tenant": req.tenant})
        return 200, {
            "status": "success",
            "message": f"Message published at time {int(now * 1e6)}",
        }, {}

    def enqueue_publish(self, req: PublishRequest) -> int:
        """Accept a /publish; returns the quantized injection time (ns scale
        matches the reference's 'published at time <ns>' reply). Metrics are
        counted at pump() time, when the publish actually succeeds or fails —
        counting here too would double-book failed requests. Raises on
        backpressure (the HTTP surface maps that to 429 via submit)."""
        code, payload, _ = self.submit(req)
        if code != 200:
            raise RuntimeError(f"publish not admitted: {payload['status']}")
        return int(req.t_enq_ms * 1e6)  # ns

    def metrics_text(self) -> str:
        with self._lock:
            return self._metrics_text

    def service_status(self) -> dict:
        """Strict-JSON runtime status (GET /service)."""
        return {
            "status": "draining" if self.draining else "serving",
            "degraded": self.degraded,
            "queue_depth": self.publishes.depth(),
            "max_queue_depth": self.svc_cfg.max_queue_depth,
            "max_depth_seen": self.max_depth_seen,
            "est_dispatch_ms": round(self._ewma_ms, 3),
            "dispatch_mode": self.svc_cfg.dispatch_mode,
            "pump_rounds": self.pump_rounds,
            "counters": dict(self.counters),
            "last_error": self.last_error,
            "topics": list(self._topics),
        }

    def telemetry_status(self) -> dict:
        """Strict-JSON flight-recorder window (GET /telemetry): the latest
        armed advance()'s per-heartbeat tel_* curves — the same series the
        scrape exports as dst_sim_round_* gauges, but as whole curves per
        channel so a tenant can stream the live per-heartbeat trajectory
        instead of polling one point per scrape. Empty curves until
        record_telemetry arms the recorder and an advance runs. The
        curves are the host copy the pump thread made."""
        with self._lock:
            curves = dict(self._tel_curves)
        return {
            "armed": getattr(self.sim, "_telemetry", None) is not None,
            "sim_t_ms": self._sim_now(),
            "pump_rounds": self.pump_rounds,
            "heartbeats": (len(next(iter(curves.values())))
                           if curves else 0),
            "curves": curves,
        }

    # --------------------------------------------------------------- dispatch

    def _note_device_ms(self, wall_ms: float, n_requests: int) -> None:
        """Account one device call's wall toward this round's admission
        estimate. Only device work is counted — retry-backoff sleeps are
        deliberately excluded, so a retry storm no longer inflates the
        queued-device-ms budget and over-sheds healthy tenants."""
        self._round_device_ms += wall_ms
        self.device_ms_total += wall_ms
        self._round_reqs += n_requests
        self._round_dispatches += 1
        self.counters["device_dispatches"] += 1
        self.metrics.service_dispatches.inc()

    def _commit_publish(self, req: PublishRequest, rec, view: int) -> None:
        """Success bookkeeping for one served request (shared by the
        sequential and batched paths): per-tenant sojourn, delivery
        metrics, and the stdout latency-line contract."""
        self.metrics.on_publish_request(ok=True)
        self.counters["dispatched"] += 1
        sojourn_ms = (time.monotonic() - req.t_enq_wall) * 1000.0
        self.latencies.append((req.tenant, sojourn_ms))
        self.metrics.service_latency.observe(
            sojourn_ms, labels={"tenant": req.tenant})
        # the stdout contract (main.nim:150): one line per receiver
        for peer, d in zip(rec.receivers, rec.delays_ms_int):
            self.lines_out.append(f"{rec.msg_id} milliseconds: {d}")
            if peer == view:
                self.metrics.on_delivery(
                    float(d), chunks=self.sim.cfg.topo.num_frags)

    def _dispatch(self, req: PublishRequest, view: int) -> int:
        """One supervised device dispatch: watchdog timeout + bounded
        exponential-backoff retries + quarantine (the campaign
        supervisor's pattern). Returns 1 on a successful publish.
        Request-level errors (bad params, degraded mix) are terminal —
        retrying a deterministic rejection wastes device time."""
        sup = self.svc_cfg

        def run():
            if self._multitopic:
                return self.sim.publish(req.topic, view,
                                        msg_size=req.msg_size)
            return self.sim.publish(view, msg_size=req.msg_size)

        last_err = None
        for attempt in range(sup.max_retries + 1):
            if attempt > 0:
                time.sleep(sup.retry_backoff_s * (2 ** (attempt - 1)))
                self.counters["retries"] += 1
                self.metrics.service_retries.inc()
                self.degraded = True
            try:
                self._injector.maybe_fail()
                t0 = time.monotonic()
                # the record's host copies synchronize with the device, so
                # this wall includes the device work
                rec = _call_with_timeout(run, sup.dispatch_timeout_s,
                                         getattr(self.sim, "device", None))
            except (ValueError, MixDegradedError):
                # bad request parameters or a degraded mix network. (A view
                # peer not subscribed to the topic is NOT an error: it
                # publishes through the gossipsub v1.1 fanout path.)
                self.metrics.on_publish_request(ok=False)
                return 0
            except Exception as e:  # noqa: BLE001 — the supervisor IS the handler
                last_err = e
                self.counters["dispatch_failures"] += 1
                self.metrics.service_failures.inc()
                continue
            self._note_device_ms((time.monotonic() - t0) * 1000.0, 1)
            self._commit_publish(req, rec, view)
            return 1
        # retry budget exhausted: quarantine the poison request; the service
        # stays up and reports itself degraded instead of crashing
        self.counters["quarantined"] += 1
        self.metrics.service_quarantined.inc()
        self.degraded = True
        self.last_error = repr(last_err)
        self.metrics.on_publish_request(ok=False)
        return 0

    def _group_key(self, req: PublishRequest, view: int):
        """Static-shape bucket of one request: msg_size + the fanout flag
        (an unsubscribed view publishes through the gossipsub v1.1 fanout
        path, another program). The topic is NOT part of the key: a
        multi-topic batch names each request's topic, so the eth2
        att-subnet lane batches across its subnets."""
        if self._multitopic:
            ti = self.sim.topic_index(req.topic)
            fanout = not bool(self.sim.subscribed_np[ti][view])
        else:
            fanout = not bool(self.sim._subscribed_np[view])
        return (req.msg_size, fanout)

    def _group_batch(self, batch, view: int):
        """MODE-INVARIANT grouping of the fair batch: groups keyed by
        static shape bucket in first-appearance order, FIFO within a
        group. Both dispatch modes iterate these same groups in the same
        order — dispatch_mode only changes how one group executes (a
        request loop vs one publish_batch) — which is what makes
        batched == sequential bit-identity hold for ALL traffic, not just
        single-bucket rounds."""
        groups: list[list[PublishRequest]] = []
        index: dict = {}
        for req in batch:
            k = self._group_key(req, view)
            i = index.get(k)
            if i is None:
                index[k] = len(groups)
                groups.append([req])
            else:
                groups[i].append(req)
        return groups

    def _dispatch_batch(self, reqs: list, view: int) -> int:
        """One same-bucket group as ONE supervised device dispatch.
        Failure handling lifts the campaign supervisor's per-seed split to
        batch granularity: a failed batch is bisected and each half
        re-dispatched, so only the poison request is ever quarantined —
        never the batch. Single-request groups take the per-request
        retry/quarantine path directly (keeps sequential-mode counter
        semantics for the B=1 degenerate case)."""
        if len(reqs) == 1:
            return self._dispatch(reqs[0], view)
        sim = self.sim
        if (getattr(sim, "mix_params", None) is not None
                or getattr(sim, "mesh", None) is not None
                or not hasattr(sim, "publish_batch")):
            # mix routing and peer-sharded grids keep the per-publish path
            # (Simulator.publish_batch documents why); so do foreign sims
            return sum(self._dispatch(r, view) for r in reqs)
        sup = self.svc_cfg

        def run():
            if self._multitopic:
                return sim.publish_batch(
                    [(r.topic, view) for r in reqs],
                    msg_size=reqs[0].msg_size, pad_to=sup.max_batch)
            return sim.publish_batch(
                [view] * len(reqs), msg_size=reqs[0].msg_size,
                pad_to=sup.max_batch)

        try:
            self._injector.maybe_fail()
            t0 = time.monotonic()
            recs = _call_with_timeout(run, sup.dispatch_timeout_s,
                                      getattr(sim, "device", None))
        except (ValueError, MixDegradedError):
            # request-level rejection at batch granularity can't name the
            # culprit: re-dispatch each request alone (terminal per
            # request — _dispatch never retries these)
            return sum(self._dispatch(r, view) for r in reqs)
        except Exception as e:  # noqa: BLE001 — the supervisor IS the handler
            self.counters["dispatch_failures"] += 1
            self.metrics.service_failures.inc()
            self.counters["batch_splits"] += 1
            self.metrics.service_splits.inc()
            self.degraded = True
            self.last_error = repr(e)
            mid = len(reqs) // 2
            return (self._dispatch_batch(reqs[:mid], view)
                    + self._dispatch_batch(reqs[mid:], view))
        self._note_device_ms((time.monotonic() - t0) * 1000.0, len(reqs))
        for r, rec in zip(reqs, recs):
            self._commit_publish(r, rec, view)
        return len(reqs)

    def pump(self, advance_ms: float = 0.0) -> int:
        """One service round: advance sim time, pop a fair bounded batch
        (shedding expired requests), group it by static-shape bucket, and
        dispatch each group under the supervisor — one stacked device
        dispatch per group in batched mode, one per request in sequential
        mode — then emit latency lines, refresh the metrics snapshot, and
        flush the periodic checkpoint. Returns #published."""
        if advance_ms > 0:
            self.sim.advance(advance_ms)
            self._sync_clock()
        depth_before = self.publishes.depth()
        self.max_depth_seen = max(self.max_depth_seen, depth_before)
        now = self._sim_now()
        batch, shed = self.publishes.take_batch(self.svc_cfg.max_batch, now)
        for req in shed:
            self.counters["shed_deadline"] += 1
            self.metrics.service_dropped.inc(labels={"reason": "deadline"})
        n_pub = 0
        n_real = (self.sim.n_peers if self._multitopic else self.sim.params.n)
        view = self.cfg.my_id % n_real  # the simulated peer this node's
        # metrics report for (my_id can exceed n via PEER_ID_OFFSET)
        self._round_device_ms = 0.0
        self._round_reqs = 0
        self._round_dispatches = 0
        for group in self._group_batch(batch, view):
            if self.svc_cfg.dispatch_mode == "batched":
                n_pub += self._dispatch_batch(group, view)
            else:
                for req in group:
                    n_pub += self._dispatch(req, view)
        if batch:
            self.metrics.service_batches.inc()
            if self._round_reqs:
                # admission budget estimator: device wall per REQUEST —
                # amortized over the round's requests, sleeps excluded
                per_ms = self._round_device_ms / self._round_reqs
                self._ewma_ms = (per_ms if self._ewma_ms == 0.0
                                 else 0.8 * self._ewma_ms + 0.2 * per_ms)
            if self._round_dispatches:
                self.metrics.service_batch_factor.set(
                    self._round_reqs / self._round_dispatches)
        self.metrics.fill_from_sim(self.sim, view)
        # flight-recorder window (Simulator.record_telemetry): export the
        # latest per-heartbeat curves as the dst_sim_round_* family
        tel = getattr(self.sim, "last_telemetry", None)
        curves = {}
        if tel:
            self.metrics.fill_from_telemetry(tel)
            curves = {
                k: sanitize_nonfinite(
                    np.asarray(_to_numpy(v), dtype=np.float64).tolist())
                for k, v in tel.items() if k.startswith("tel_")
            }
        self._fill_service_gauges()
        with self._lock:
            self._metrics_text = self.metrics.render()
            self._tel_curves = curves
        self.pump_rounds += 1
        every = self.svc_cfg.checkpoint_every
        if self.svc_cfg.checkpoint_path and every > 0 \
                and self.pump_rounds % every == 0:
            self.flush_checkpoint()
        return n_pub

    def _fill_service_gauges(self) -> None:
        m = self.metrics
        m.service_queue_depth.set(self.publishes.depth())
        m.service_degraded.set(1.0 if self.degraded else 0.0)
        m.service_draining.set(1.0 if self.draining else 0.0)
        m.service_restarts.set(float(self.counters["restarts"]))
        m.service_est_dispatch.set(self._ewma_ms)

    # ----------------------------------------------------- warm restart

    def _service_meta(self) -> dict:
        """The checkpoint sidecar: everything the resident runtime needs to
        resume exactly — pending queue + fairness cursor (lost work would
        break replay bit-identity), counters, and the dispatch EWMA."""
        return {
            "pump_rounds": self.pump_rounds,
            "counters": dict(self.counters),
            "degraded": self.degraded,
            "last_error": self.last_error,
            "ewma_ms": self._ewma_ms,
            "queue": self.publishes.snapshot(),
        }

    def flush_checkpoint(self, path: str | None = None) -> str | None:
        """Atomic snapshot of sim + service state (checkpoint.py writes
        tmp -> os.replace, so SIGKILL mid-flush keeps the previous good
        snapshot)."""
        from .checkpoint import save_checkpoint

        path = path or self.svc_cfg.checkpoint_path
        if not path:
            return None
        t0 = time.monotonic()
        save_checkpoint(self.sim, path, service_meta=self._service_meta())
        self.flush_walls.append(time.monotonic() - t0)
        self.counters["checkpoint_flushes"] += 1
        self.metrics.service_checkpoints.inc()
        return path

    @classmethod
    def restore(
        cls,
        path: str,
        cfg: NodeConfig | None = None,
        control_port: int = HTTP_CONTROL_PORT,
        metrics_port: int = PROMETHEUS_PORT,
        service: ServiceConfig | None = None,
        mesh=None,
        device=None,
    ) -> "NodeService":
        """Warm restart from a service checkpoint: rebuild the simulator
        bit-exactly on `device` (CUDA unless the caller passes another;
        runtime/checkpoint.py) and re-admit the pending queue, counters,
        and fairness cursor from the sidecar. Replayed requests then
        produce results identical to an uninterrupted run. A peer-sharded
        `mesh` comes with the multi-GPU slice (ROADMAP A13) and raises."""
        from .checkpoint import load_checkpoint, load_service_meta

        sim = load_checkpoint(path, mesh=mesh, device=device)
        meta = load_service_meta(path)
        svc = cls(sim, cfg, control_port=control_port,
                  metrics_port=metrics_port, service=service)
        svc.pump_rounds = int(meta.get("pump_rounds", 0))
        saved = meta.get("counters", {})
        for k in svc.counters:
            if k in saved:
                svc.counters[k] = int(saved[k])
        svc.counters["restarts"] = int(saved.get("restarts", 0)) + 1
        svc.degraded = bool(meta.get("degraded", False))
        svc.last_error = meta.get("last_error")
        svc._ewma_ms = float(meta.get("ewma_ms", 0.0))
        svc.publishes.restore(meta.get("queue"))
        # the scrape survives the restart too: re-base the service counters
        # so rate() over a kill sees a monotone series, not a reset to zero
        m = svc.metrics
        for series, key, lab in (
            (m.service_dropped, "rejected", {"reason": "backpressure"}),
            (m.service_dropped, "shed_deadline", {"reason": "deadline"}),
            (m.service_failures, "dispatch_failures", None),
            (m.service_retries, "retries", None),
            (m.service_quarantined, "quarantined", None),
            (m.service_checkpoints, "checkpoint_flushes", None),
            (m.service_splits, "batch_splits", None),
            (m.service_dispatches, "device_dispatches", None),
        ):
            v = svc.counters.get(key, 0)
            if v:
                series.inc(v, labels=lab)
        if svc.counters["admitted"]:
            m.service_admitted.inc(svc.counters["admitted"],
                                   labels={"tenant": DEFAULT_TENANT})
        svc._fill_service_gauges()
        with svc._lock:
            svc._metrics_text = m.render()
        return svc

    # ----------------------------------------------------- graceful shutdown

    def begin_drain(self) -> None:
        """Stop admitting (submit answers 503); in-flight work keeps
        draining via pump() until shutdown's deadline."""
        self.draining = True
        self.metrics.service_draining.set(1.0)

    def shutdown(self) -> None:
        """Drain the queue under drain_deadline_s, flush a final checkpoint,
        stop the HTTP servers. Idempotent; serve_forever's signal path."""
        self.begin_drain()
        deadline = time.monotonic() + self.svc_cfg.drain_deadline_s
        while self.publishes.depth() > 0 and time.monotonic() < deadline:
            self.pump()
        self.flush_checkpoint()
        self.stop()

    # ----------------------------------------------------- metric persistence

    def store_metrics_loop(
        self, out_dir: str = ".", interval_s: float = 300.0,
        stagger: bool = True, max_iters: int | None = None,
    ) -> threading.Thread:
        """Background metrics_pod-<id>.txt appender (env.nim:58-73). Like the
        Rust node we snapshot the registry directly instead of scraping
        localhost (env.rs:114-152 — the Shadow-friendly variant)."""
        my_id = self.cfg.my_id

        def loop():
            time.sleep(my_id * 0.060 if stagger else 0.0)  # myId*60ms stagger
            i = 0
            while not self._stop.is_set():
                with open(f"{out_dir}/metrics_pod-{my_id}.txt", "a") as f:
                    f.write(self.metrics_text())
                i += 1
                if max_iters is not None and i >= max_iters:
                    return
                if self._stop.wait(interval_s):
                    return

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._threads.append(t)
        return t


def serve_forever(
    simulator, cfg: NodeConfig, *,
    control_port: int = HTTP_CONTROL_PORT,
    metrics_port: int = PROMETHEUS_PORT,
    time_scale: float = 1.0,
    tick_s: float = 1.0,
    duration_s: float | None = None,
    store_metrics_dir: str | None = None,
    out=None,
    service: ServiceConfig | None = None,
    resume_from: str | None = None,
    install_signal_handlers: bool = True,
    device=None,
) -> NodeService:
    """Run the node service loop: each wall tick advances the simulation by
    tick_s * time_scale seconds of simulated time and drains the publish
    queue. `duration_s` bounds the loop (None = until SIGTERM/SIGINT).

    SIGTERM/SIGINT (installed only on the main thread) switch the service
    into draining — no new admissions (503), queued work dispatched under
    ServiceConfig.drain_deadline_s, one final checkpoint flushed — then the
    loop returns normally, so the process exits 0 instead of dying mid-
    request. `resume_from`: warm-restart from this service checkpoint onto
    `device` instead of using `simulator` (crash-recovery path; the file
    must exist). With `out`, the bound ports (port 0 resolves to a free
    one) are printed there first."""
    import os

    if resume_from is not None:
        if not os.path.exists(resume_from):
            raise FileNotFoundError(
                f"resume checkpoint not found: {resume_from}")
        svc = NodeService.restore(
            resume_from, cfg, control_port=control_port,
            metrics_port=metrics_port, service=service, device=device)
    else:
        svc = NodeService(
            simulator, cfg, control_port=control_port,
            metrics_port=metrics_port, service=service)
    svc.start()
    if out is not None:
        print(f"serving control :{svc.control_port} metrics "
              f":{svc.metrics_port}", file=out, flush=True)
    if store_metrics_dir is not None:
        svc.store_metrics_loop(store_metrics_dir)
    # the handler only appends to a list: it runs on the main thread
    # between bytecodes, possibly while that thread holds a lock, so it
    # must take none (an Event.set() there can deadlock against the
    # Event's own wait(), as the reference's handler can)
    signalled: list[int] = []

    def _on_signal(signum, frame):
        signalled.append(signum)

    old_handlers = {}
    if install_signal_handlers \
            and threading.current_thread() is threading.main_thread():
        for s in (signal.SIGTERM, signal.SIGINT):
            old_handlers[s] = signal.signal(s, _on_signal)
    t_end = None if duration_s is None else time.monotonic() + duration_s
    try:
        while not signalled \
                and (t_end is None or time.monotonic() < t_end):
            t0 = time.monotonic()
            svc.pump(advance_ms=tick_s * time_scale * 1000.0)
            if out is not None:
                for line in svc.lines_out:
                    print(line, file=out)
            svc.lines_out.clear()  # always drain — a long-lived service must
            # not accumulate one string per receiver per message forever
            leftover = tick_s - (time.monotonic() - t0)
            if leftover > 0:
                time.sleep(min(leftover, 0.05))
                if signalled or svc._stop.is_set():
                    break
    except KeyboardInterrupt:
        pass
    finally:
        # graceful teardown on ANY exit (signal, duration elapsed, error):
        # stop admitting, drain with a deadline, flush the final checkpoint
        svc.shutdown()
        if out is not None:
            for line in svc.lines_out:
                print(line, file=out)
        svc.lines_out.clear()
        for s, h in old_handlers.items():
            signal.signal(s, h)
    return svc
